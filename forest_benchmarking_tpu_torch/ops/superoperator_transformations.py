"""Column-stacking vectorization and the host-side Pauli-to-computational
basis matrix (port of the JAX module's ``vec``, ``unvec`` and ``_p2c_np``)."""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.utils import pauli_basis_matrices

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


@functools.lru_cache(maxsize=None)
def _p2c_np(dim: int) -> np.ndarray:
    """Host-side cached Pauli -> computational basis transform (dim**2 x
    dim**2): column k is vec(P_k), column stacking."""
    n_qubits = int(np.log2(dim))
    paulis = pauli_basis_matrices(n_qubits)
    return np.swapaxes(paulis, -1, -2).reshape(dim * dim, dim * dim).T.copy()
