"""Pure-state gate application by tensor contraction.

Port of ``apply_gate_matrix`` from ``forest_benchmarking_tpu/sim/
statevector.py``. The state is a (2,)*n complex tensor; axis i is qubit i,
the first qubit the most significant bit of the flattened index.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["apply_gate_matrix"]


def apply_gate_matrix(psi: torch.Tensor, mat: torch.Tensor,
                      axes: Sequence[int]) -> torch.Tensor:
    """Apply a k-qubit gate matrix to tensor axes ``axes`` of the state
    tensor ``psi`` of shape (2,)*n; ``mat`` is (2**k, 2**k) with the first
    listed axis the most significant. Batch with ``torch.func.vmap``."""
    k = len(axes)
    mat_t = mat.reshape((2,) * (2 * k))
    out = torch.tensordot(mat_t, psi, dims=(list(range(k, 2 * k)), list(axes)))
    return torch.movedim(out, list(range(k)), list(axes))
