"""Batched calculational helpers: conjugate transpose, hermitian part, kron,
partial trace, and the pseudo-inverse with the JAX package's cutoff.

Port of ``forest_benchmarking_tpu/ops/calculational.py`` (subset). Every
function takes arbitrary leading batch dimensions.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["dag", "hermitianize", "kron", "partial_trace", "pinv"]


def dag(a: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose over the trailing two axes."""
    return a.transpose(-1, -2).conj()


def hermitianize(a: torch.Tensor) -> torch.Tensor:
    """(A + A^dagger) / 2 over the trailing two axes."""
    return (a + dag(a)) / 2


def pinv(a: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse over the trailing two axes with ``jnp.linalg.pinv``'s
    default cutoff: singular values below 10 max(m, n) eps of the largest
    are dropped (``torch.linalg.pinv``'s default is max(m, n) eps)."""
    rtol = 10 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rtol)


def kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kronecker product over the trailing two axes, broadcasting batch dims.

    ``kron(A, B)[..., i*p + k, j*q + l] = A[..., i, j] * B[..., k, l]``
    """
    r1, c1 = a.shape[-2:]
    r2, c2 = b.shape[-2:]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(*out.shape[:-4], r1 * r2, c1 * c2)


def partial_trace(rho: torch.Tensor, keep: Sequence[int],
                  dims: Sequence[int]) -> torch.Tensor:
    """Partial trace of a (batched) matrix over the factors not in ``keep``.

    :param rho: (..., D, D) matrix on the product space with D = prod(dims).
    :param keep: indices of the tensor factors to keep.
    :param dims: dimensions of each tensor factor.
    :return: (..., Dk, Dk) with Dk = prod(dims[i] for i in keep).
    """
    keep = tuple(keep)
    dims = tuple(dims)
    n = len(dims)
    batch_shape = rho.shape[:-2]
    nb = len(batch_shape)
    rho = rho.reshape(*batch_shape, *dims, *dims)
    traced = [i for i in range(n) if i not in keep]
    for count, i in enumerate(sorted(traced)):
        # after `count` traces, factor i sits at axis nb + (i - count); its
        # column partner sits n - count factors later
        ax = nb + i - count
        rho = torch.diagonal(rho, dim1=ax, dim2=ax + (n - count)).sum(-1)
    dk = 1
    for i in keep:
        dk *= dims[i]
    return rho.reshape(*batch_shape, dk, dk)
