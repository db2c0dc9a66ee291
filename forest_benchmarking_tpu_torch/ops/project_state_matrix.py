"""Projection of a Hermitian matrix onto the set of physical density matrices.

Port of ``forest_benchmarking_tpu/ops/project_state_matrix.py``: the
"wizard" waterfilling of Smolin et al. (https://arxiv.org/abs/1106.5458),
written branchless over one batched ``torch.linalg.eigh``.
"""
from __future__ import annotations

import torch

from forest_benchmarking_tpu_torch.ops.calculational import dag
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul

__all__ = ["project_state_matrix_to_physical"]


def project_state_matrix_to_physical(rho: torch.Tensor) -> torch.Tensor:
    """Project (batched) ``rho`` to the closest trace-1 PSD matrix in 2-norm.

    Rescale to trace 1, eigendecompose, then zero the most negative
    eigenvalues while spreading their mass uniformly over the rest, keeping
    the largest support on which every kept eigenvalue stays non-negative:
    with the eigenvalues sorted descending, keep the first i* where i* is the
    largest count i with ``lam_i + (S - C_i) / i >= 0`` (C_i the prefix sum,
    S the total). Runs where ``rho`` lies; the reconstruction is a full
    float32 product on the card (no TF32).

    :param rho: (..., d, d) Hermitian matrix (need not be PSD or trace 1).
    :return: (..., d, d) closest density matrix.
    """
    d = rho.shape[-1]
    tr = torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    rho = rho / tr
    eigvals, eigvecs = torch.linalg.eigh(rho)  # ascending
    lam = eigvals.flip(-1)  # descending
    csum = torch.cumsum(lam, dim=-1)
    total = csum[..., -1:]
    counts = torch.arange(1, d + 1, dtype=lam.dtype, device=lam.device)
    # the correction if the first i eigenvalues are kept: the removed mass
    # spread over them
    corr = (total - csum) / counts
    keep_ok = lam + corr >= 0
    # keep_ok is a prefix of trues in exact arithmetic; take the last true
    idx = (keep_ok.to(torch.int64).sum(-1) - 1).clamp(0, d - 1)
    corr_star = torch.gather(corr, -1, idx[..., None])
    mask = counts <= (idx[..., None] + 1)
    lam_new = torch.where(mask, lam + corr_star, 0.0).flip(-1)
    with full_f32_matmul():
        return (eigvecs * lam_new[..., None, :].to(eigvecs.dtype)) \
            @ dag(eigvecs)
