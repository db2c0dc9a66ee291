"""Predicates checking properties of single matrices.

Port of ``forest_benchmarking_tpu/ops/validate_operator.py``. As there,
they are host-side numpy tolerance predicates with ``np.allclose``'s
defaults, returning Python bools; a tensor from any device is compared on
the host.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "is_square_matrix", "is_symmetric_matrix", "is_identity_matrix",
    "is_idempotent_matrix", "is_normal_matrix", "is_hermitian_matrix",
    "is_unitary_matrix", "is_positive_definite_matrix",
    "is_positive_semidefinite_matrix",
]


def _np(matrix) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or an array-like."""
    if isinstance(matrix, torch.Tensor):
        return matrix.detach().cpu().resolve_conj().numpy()
    return np.asarray(matrix)


def is_square_matrix(matrix) -> bool:
    """True iff the matrix is square."""
    matrix = _np(matrix)
    if matrix.ndim != 2:
        raise ValueError("The object is not a matrix.")
    rows, cols = matrix.shape
    return rows == cols


def _square(matrix) -> np.ndarray:
    matrix = _np(matrix)
    if not is_square_matrix(matrix):
        raise ValueError("The matrix is not square.")
    return matrix


def is_symmetric_matrix(matrix, rtol: float = 1e-05,
                        atol: float = 1e-08) -> bool:
    """True iff A == A^T within tolerance."""
    matrix = _square(matrix)
    return bool(np.allclose(matrix, matrix.T, rtol=rtol, atol=atol))


def is_identity_matrix(matrix, rtol: float = 1e-05,
                       atol: float = 1e-08) -> bool:
    """True iff A == I within tolerance."""
    matrix = _square(matrix)
    return bool(np.allclose(matrix, np.eye(len(matrix)), rtol=rtol,
                            atol=atol))


def is_idempotent_matrix(matrix, rtol: float = 1e-05,
                         atol: float = 1e-08) -> bool:
    """True iff A @ A == A within tolerance."""
    matrix = _square(matrix)
    return bool(np.allclose(matrix, matrix @ matrix, rtol=rtol, atol=atol))


def is_normal_matrix(matrix, rtol: float = 1e-05, atol: float = 1e-08) -> bool:
    """True iff A^dag A == A A^dag within tolerance."""
    matrix = _square(matrix)
    ab = matrix.T.conj() @ matrix
    ba = matrix @ matrix.T.conj()
    return bool(np.allclose(ab, ba, rtol=rtol, atol=atol))


def is_hermitian_matrix(matrix, rtol: float = 1e-05,
                        atol: float = 1e-08) -> bool:
    """True iff A == A^dag within tolerance."""
    matrix = _square(matrix)
    return bool(np.allclose(matrix, matrix.T.conj(), rtol=rtol, atol=atol))


def is_unitary_matrix(matrix, rtol: float = 1e-05,
                      atol: float = 1e-08) -> bool:
    """True iff A^dag A == A A^dag == I within tolerance."""
    matrix = _square(matrix)
    eye = np.eye(len(matrix))
    return bool(np.allclose(matrix.T.conj() @ matrix, eye, rtol=rtol,
                            atol=atol)
                and np.allclose(matrix @ matrix.T.conj(), eye, rtol=rtol,
                                atol=atol))


def is_positive_definite_matrix(matrix, rtol: float = 1e-05,
                                atol: float = 1e-08) -> bool:
    """True iff Hermitian A has all eigenvalues > -|atol|."""
    matrix = _np(matrix)
    if not is_hermitian_matrix(matrix, rtol, atol):
        raise ValueError("The matrix is not Hermitian.")
    return bool(np.all(np.linalg.eigvalsh(matrix) > -abs(atol)))


def is_positive_semidefinite_matrix(matrix, rtol: float = 1e-05,
                                    atol: float = 1e-08) -> bool:
    """True iff Hermitian A has all eigenvalues >= -|atol|."""
    matrix = _np(matrix)
    if not is_hermitian_matrix(matrix, rtol, atol):
        raise ValueError("The matrix is not Hermitian.")
    return bool(np.all(np.linalg.eigvalsh(matrix) >= -abs(atol)))
