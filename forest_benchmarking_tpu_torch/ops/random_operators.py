"""Random quantum processes drawn with an explicit ``torch.Generator``.

Port of ``forest_benchmarking_tpu/ops/random_operators.py`` (subset:
``ginibre_matrix_complex``, ``haar_rand_unitary`` and
``rand_map_with_BCSZ_dist``). Samples are
drawn on the generator's device. torch and ``jax.random`` streams differ,
so the two packages agree in distribution, not draw for draw; the
deterministic BCSZ transform (:func:`bcsz_choi_from_ginibre`) agrees
exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from forest_benchmarking_tpu_torch.ops.calculational import (
    dag, kron, partial_trace)

__all__ = ["ginibre_matrix_complex", "haar_rand_unitary",
           "rand_map_with_BCSZ_dist", "bcsz_choi_from_ginibre"]


def ginibre_matrix_complex(generator: torch.Generator, dim: int, k: int,
                           batch: Tuple[int, ...] = (),
                           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    r"""Draw a (batched) dim-by-k matrix from the complex Ginibre ensemble.

    Each element is ``N(0,1) + 1j N(0,1)``; ``dtype`` is the real dtype.
    """
    shape = (*batch, dim, k)
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    re = torch.randn(shape, **kw)
    im = torch.randn(shape, **kw)
    return torch.complex(re, im)


def haar_rand_unitary(generator: torch.Generator, dim: int,
                      batch: Tuple[int, ...] = (),
                      dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Draw a (batched) Haar-random unitary [MEZ]: the Q factor of the QR
    decomposition of a Ginibre matrix, phase-fixed so that R has a positive
    real diagonal. That Q is unique, and modified Gram-Schmidt over the
    columns, run twice for orthogonality in f32, computes it directly, in a
    few dozen batched operations: ``torch.linalg.qr`` on the card launches
    kernels per matrix of the batch."""
    z = ginibre_matrix_complex(generator, dim, dim, batch, dtype)
    cols = []
    for k in range(dim):
        v = z[..., :, k]
        for _ in range(2):
            for q in cols:
                v = v - (q.conj() * v).sum(-1, keepdim=True) * q
        cols.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
    return torch.stack(cols, dim=-1)


def bcsz_choi_from_ginibre(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The BCSZ normalization of a (..., dim^2, rank) Ginibre draw ``x``.

    Column-stacking convention: ``rho = x x^dag`` is normalized by
    ``kron(W, I)`` on both sides with ``W = (Tr_out rho)^{-1/2}``. The 4x4
    inverse square root uses ``torch.linalg.eigh``.
    """
    rho = x @ dag(x)
    rho_red = partial_trace(rho, keep=[0], dims=[dim, dim])
    w, v = torch.linalg.eigh(rho_red)
    inv_sqrt = (v * (1.0 / torch.sqrt(w))[..., None, :].to(v.dtype)) @ dag(v)
    q = kron(inv_sqrt, torch.eye(dim, dtype=rho.dtype, device=rho.device))
    return q @ rho @ q


def rand_map_with_BCSZ_dist(generator: torch.Generator, dim: int,
                            kraus_rank: int, batch: Tuple[int, ...] = (),
                            dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Draw a (batched) CPTP Choi matrix from the BCSZ distribution [RQO]."""
    x = ginibre_matrix_complex(generator, dim ** 2, kraus_rank, batch, dtype)
    return bcsz_choi_from_ginibre(x, dim)
