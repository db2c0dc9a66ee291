"""Random quantum processes drawn with an explicit ``torch.Generator``.

Port of ``forest_benchmarking_tpu/ops/random_operators.py``. Samples are
drawn on the generator's device. torch and ``jax.random`` streams differ,
so the two packages agree in distribution, not draw for draw; the
deterministic BCSZ transform (:func:`bcsz_choi_from_ginibre`) agrees
exactly. Where the JAX sampler splits its key, the port draws one part
after the other from the one generator. :func:`permute_tensor_factors` is a
host-side numpy constant, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from forest_benchmarking_tpu_torch.ops.calculational import (
    dag, kron, partial_trace)
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul

__all__ = ["ginibre_matrix_complex", "haar_rand_unitary", "haar_rand_state",
           "ginibre_state_matrix", "bures_measure_state_matrix",
           "rand_map_with_BCSZ_dist", "bcsz_choi_from_ginibre",
           "permute_tensor_factors"]


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


def haar_rand_state(generator: torch.Generator, dim: int,
                    batch: Tuple[int, ...] = (),
                    dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Draw a (batched) Haar-random pure state as a (..., dim, 1) column."""
    return haar_rand_unitary(generator, dim, batch, dtype)[..., :, :1]


def ginibre_state_matrix(generator: torch.Generator, dim: int, rank: int,
                         batch: Tuple[int, ...] = (),
                         dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Draw a (batched) rank-``rank`` density matrix from the induced
    Ginibre measure; for rank == dim the Hilbert-Schmidt measure [IM]."""
    if rank > dim:
        raise ValueError("The rank of the state matrix cannot exceed the "
                         "dimension.")
    a = ginibre_matrix_complex(generator, dim, rank, batch, dtype)
    with full_f32_matmul():
        m = a @ dag(a)
    tr = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return m / tr


def bures_measure_state_matrix(generator: torch.Generator, dim: int,
                               batch: Tuple[int, ...] = (),
                               dtype: torch.dtype = torch.float64
                               ) -> torch.Tensor:
    """Draw a (batched) density matrix from the Bures measure [OSZ]:
    (I + U) A A^dag (I + U)^dag, normalized, with A Ginibre and U Haar."""
    a = ginibre_matrix_complex(generator, dim, dim, batch, dtype)
    u = haar_rand_unitary(generator, dim, batch, dtype)
    eye = torch.eye(dim, dtype=a.dtype, device=a.device)
    with full_f32_matmul():
        p = (eye + u) @ (a @ dag(a)) @ (eye + dag(u))
    tr = torch.diagonal(p, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return p / tr


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


def permute_tensor_factors(dims: Union[int, List[int]],
                           perm: Sequence[int]) -> np.ndarray:
    r"""Permutation matrix that reorders tensor factors (host-side constant):
    ``P (v_0 x v_1 x ...) = v_{perm[0]} x v_{perm[1]} x ...`` on spaces of
    the given dimension(s); eq. 5.11-5.13 of [SCOTT]."""
    perm = list(perm)
    if isinstance(dims, int):
        dim_list = [dims] * len(perm)
    else:
        if len(dims) != len(perm):
            raise ValueError("Specify the dimension of each factor.")
        dim_list = list(dims)
    total_dim = int(np.prod(dim_list))
    eye = np.eye(total_dim).reshape(dim_list + dim_list)
    eye = np.moveaxis(eye, perm, list(range(len(perm))))
    return eye.reshape(total_dim, total_dim)
