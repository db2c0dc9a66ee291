"""Plotting of the port (host-side matplotlib, imported only when a figure
is drawn): the JAX package's ``plotting`` names, taking torch tensors on
any device as well as numpy arrays."""
from forest_benchmarking_tpu_torch.plotting.hinton import hinton, hinton_real  # noqa: F401
from forest_benchmarking_tpu_torch.plotting.state_process import (  # noqa: F401
    plot_pauli_bar_rep_of_state, plot_pauli_rep_of_state,
    plot_pauli_transfer_matrix)
from forest_benchmarking_tpu_torch.analysis.fitting import plot_figure_for_fit  # noqa: F401

__all__ = ["hinton", "hinton_real", "plot_pauli_rep_of_state",
           "plot_pauli_bar_rep_of_state", "plot_pauli_transfer_matrix",
           "plot_figure_for_fit"]
