"""Applying superoperators (Kraus sets or Choi matrices) to states, batched.

Port of ``forest_benchmarking_tpu/ops/apply_superoperator.py``. Float32
products run in full float32, not TF32.
"""
from __future__ import annotations

import math

import torch

from forest_benchmarking_tpu_torch.ops.calculational import kron, partial_trace
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    _stack_kraus)

__all__ = ["apply_kraus_ops_2_state", "apply_choi_matrix_2_state"]


def apply_kraus_ops_2_state(kraus_ops, state: torch.Tensor) -> torch.Tensor:
    r"""Apply a channel in Kraus form to a (batched) density matrix:
    ``rho_out = sum_i K_i rho K_i^dag``. Kraus operators may be non-square:
    (..., K, rows, dim) applied to (..., dim, dim) gives (..., rows, rows).
    """
    k = _stack_kraus(kraus_ops)
    if state.shape[-1] != k.shape[-1]:
        raise ValueError("Dimensions of state and Kraus operator are "
                         "incompatible")
    with full_f32_matmul():
        return torch.einsum("...nij,...jk,...nlk->...il", k, state, k.conj())


def apply_choi_matrix_2_state(choi: torch.Tensor,
                              state: torch.Tensor) -> torch.Tensor:
    r"""Apply a channel in Choi form (column stacking) to a (batched)
    density matrix: ``rho_out = Tr_in[(rho^T (x) I) choi]``."""
    dim = math.isqrt(choi.shape[-1])
    eye = torch.eye(dim, dtype=choi.dtype, device=choi.device)
    with full_f32_matmul():
        tot = kron(state.transpose(-1, -2), eye) @ choi
    return partial_trace(tot, keep=[1], dims=[dim, dim])
