"""In-process simulator on torch tensors: statevector and density-matrix
evolution plus shot sampling, on an explicit device.

Port of ``forest_benchmarking_tpu/sim/``, with the same re-exports.
"""
from forest_benchmarking_tpu_torch.sim.statevector import (  # noqa: F401
    run_statevector, statevector_probabilities, all_bitstrings)
from forest_benchmarking_tpu_torch.sim.density import (  # noqa: F401
    run_density_matrix, density_probabilities, apply_confusion)
from forest_benchmarking_tpu_torch.sim.qvm import QVM  # noqa: F401
