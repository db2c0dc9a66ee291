"""Channel approximations.

Port of ``forest_benchmarking_tpu/ops/channel_approximation.py``.
"""
from __future__ import annotations

import torch

__all__ = ["pauli_twirl_chi_matrix"]


def pauli_twirl_chi_matrix(chi_matrix: torch.Tensor) -> torch.Tensor:
    """Pauli twirl of a (batched) chi matrix: keep only the diagonal
    [SPICC]."""
    return torch.diag_embed(torch.diagonal(chi_matrix, dim1=-2, dim2=-1))
