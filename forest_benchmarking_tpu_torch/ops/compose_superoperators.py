"""Tensoring and composing channels given as Kraus sets, batched.

Port of ``forest_benchmarking_tpu/ops/compose_superoperators.py``. Kraus
sets are stacked tensors (..., K, r, c); the output's Kraus index runs over
all pairs in the reference's order, the k1 index varying slowest.
"""
from __future__ import annotations

import torch

from forest_benchmarking_tpu_torch.ops.calculational import kron
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    _stack_kraus)

__all__ = ["tensor_channel_kraus", "compose_channel_kraus"]


def tensor_channel_kraus(k2, k1) -> torch.Tensor:
    r"""Kraus set of the tensor channel ``E2 (x) E1`` on ``H_2 (x) H_1``:
    ``[kron(k2l, k1j) for k1j in k1 for k2l in k2]``."""
    a2 = _stack_kraus(k2)
    a1 = _stack_kraus(k1)
    # (..., K1, K2, r, c)
    out = kron(a2[..., None, :, :, :], a1[..., :, None, :, :])
    return out.reshape(*out.shape[:-4], -1, *out.shape[-2:])


def compose_channel_kraus(k2, k1) -> torch.Tensor:
    """Kraus set of the composition (k1 applied first, then k2)."""
    a2 = _stack_kraus(k2)
    a1 = _stack_kraus(k1)
    with full_f32_matmul():
        out = a2[..., None, :, :, :] @ a1[..., :, None, :, :]
    return out.reshape(*out.shape[:-4], -1, *out.shape[-2:])
