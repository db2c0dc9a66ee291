"""Predicates checking the physicality of channels given as Kraus sets or
Choi matrices.

Port of ``forest_benchmarking_tpu/ops/validate_superoperator.py``: host-side
numpy end to end, with the same ``rtol``/``atol`` defaults; a tensor from
any device is compared on the host.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    choi2kraus)
from forest_benchmarking_tpu_torch.ops.validate_operator import (
    _np, is_hermitian_matrix, is_identity_matrix,
    is_positive_semidefinite_matrix)

__all__ = [
    "kraus_operators_are_valid", "choi_is_hermitian_preserving",
    "choi_is_trace_preserving", "choi_is_completely_positive", "choi_is_cptp",
    "choi_is_unital", "choi_is_unitary",
]


def kraus_operators_are_valid(kraus_ops, rtol: float = 1e-05,
                              atol: float = 1e-08) -> bool:
    """True iff the POVM elements K_i^dag K_i are PSD and sum to the
    identity."""
    if isinstance(kraus_ops, (list, tuple)):
        kraus_ops = np.stack([_np(k) for k in kraus_ops])
    k = _np(kraus_ops)
    k = k[None] if k.ndim == 2 else k
    povm = np.einsum("nji,njk->nik", k.conj(), k)
    all_psd = all(is_positive_semidefinite_matrix(elem, rtol, atol)
                  for elem in povm)
    return all_psd and is_identity_matrix(povm.sum(axis=0), rtol, atol)


def choi_is_hermitian_preserving(choi, rtol: float = 1e-05,
                                 atol: float = 1e-08) -> bool:
    """True iff the channel preserves Hermiticity (its Choi matrix is
    Hermitian)."""
    return is_hermitian_matrix(_np(choi), rtol, atol)


def choi_is_trace_preserving(choi, rtol: float = 1e-05,
                             atol: float = 1e-08) -> bool:
    """True iff Tr_out(choi) == I (eq. 3.33 of [GRAPTN])."""
    choi = _np(choi)
    dim = math.isqrt(choi.shape[-1])
    pt = np.einsum("ikjk->ij", choi.reshape(dim, dim, dim, dim))
    return is_identity_matrix(pt, rtol, atol)


def choi_is_completely_positive(choi, rtol: float = 1e-05,
                                atol: float = 1e-08) -> bool:
    """True iff the Choi matrix is PSD (eq. 3.35 of [GRAPTN])."""
    return is_positive_semidefinite_matrix(_np(choi), rtol, atol)


def choi_is_cptp(choi, rtol: float = 1e-05, atol: float = 1e-08) -> bool:
    """True iff the channel is completely positive and trace-preserving."""
    return (choi_is_completely_positive(choi, rtol, atol)
            and choi_is_trace_preserving(choi, rtol, atol))


def choi_is_unital(choi, rtol: float = 1e-05, atol: float = 1e-08) -> bool:
    """True iff the channel maps the identity to itself."""
    choi = _np(choi)
    dim = math.isqrt(choi.shape[-1])
    out = np.einsum("ikil->kl", choi.reshape(dim, dim, dim, dim))
    return is_identity_matrix(out, rtol, atol)


def choi_is_unitary(choi, limit: Optional[float] = None) -> bool:
    """True iff the channel has exactly one non-negligible Kraus operator.
    ``limit`` defaults to :func:`choi2kraus`'s dtype-aware eigenvalue floor
    (the reference's fixed 1e-9 misclassifies every unitary channel in
    float32, where eigh noise on the rank-1 Choi matrix is ~1e-6)."""
    return len(choi2kraus(_np(choi), tol=limit)) == 1
