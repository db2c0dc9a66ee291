"""Column-stacking vectorization (port of the JAX module's ``vec``/``unvec``)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["vec", "unvec"]


def vec(matrix: torch.Tensor) -> torch.Tensor:
    """Vectorize a (..., N, M) matrix by column stacking -> (..., N*M, 1)."""
    t = matrix.transpose(-1, -2)
    return t.reshape(*t.shape[:-2], -1, 1)


def unvec(vector: torch.Tensor,
          shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Invert :func:`vec`: (..., N*M, 1) or (..., N*M) -> (..., N, M)."""
    if vector.shape[-1] == 1 and vector.dim() >= 2:
        vector = vector[..., 0]
    size = vector.shape[-1]
    if shape is None:
        dim = math.isqrt(size)
        if dim * dim != size:
            raise ValueError(f"{size} is not a perfect square; pass `shape`.")
        shape = (dim, dim)
    n, m = shape
    return vector.reshape(*vector.shape[:-1], m, n).transpose(-1, -2)
