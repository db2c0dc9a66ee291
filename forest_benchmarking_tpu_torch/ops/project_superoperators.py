"""Projections of Choi matrices onto the CP, TNI, TP and physical (CPTP) sets.

Port of ``forest_benchmarking_tpu/ops/project_superoperators.py``: every
projection takes arbitrary leading batch dimensions.

Dykstra's alternating projection (:func:`proj_choi_to_physical`) is a
batch-first loop with the per-problem Birgin-Raydan stop: a problem whose
criterion falls below ``tol`` keeps its state from then on, and the loop runs
while any problem is still going and fewer than ``max_iters`` iterations have
run. Each iteration computes only the problems still going; it reads the
number of them back to the host, one synchronization per iteration on the
card. Float32 products run in full float32, not TF32.
"""
from __future__ import annotations

import functools
import math

import torch

from forest_benchmarking_tpu_torch.ops.calculational import (
    dag, hermitianize, kron, partial_trace)
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    kraus2choi, unvec)

__all__ = [
    "proj_choi_to_completely_positive",
    "proj_choi_to_completely_positive_ns",
    "proj_choi_to_trace_non_increasing",
    "proj_choi_to_trace_preserving",
    "proj_choi_to_physical",
    "proj_choi_to_unitary",
]


def proj_choi_to_completely_positive(choi: torch.Tensor) -> torch.Tensor:
    """Project onto the nearest completely positive map (eq. 8 of [PGD]):
    hermitianize, then clip negative eigenvalues to zero."""
    evals, v = torch.linalg.eigh(hermitianize(choi))
    evals = evals.clamp(min=0)
    with full_f32_matmul():
        return (v * evals[..., None, :].to(v.dtype)) @ dag(v)


def _matrix_sign_ns(m: torch.Tensor, iters: int) -> torch.Tensor:
    """Matrix sign of a Hermitian matrix by Newton-Schulz iteration,
    X_{k+1} = 1.5 X_k - 0.5 X_k^3 from X_0 = M / ||M||_F."""
    s = torch.sqrt((m.abs() ** 2).sum(dim=(-2, -1), keepdim=True))
    x = m / s.clamp(min=torch.finfo(s.dtype).tiny)
    with full_f32_matmul():
        for _ in range(iters):
            x = 1.5 * x - 0.5 * (x @ x @ x)
    return x


def proj_choi_to_completely_positive_ns(choi: torch.Tensor,
                                        ns_iters: int = 24) -> torch.Tensor:
    """CP projection via the positive part pos(M) = (M + M sign(M)) / 2 with
    sign(M) from Newton-Schulz: matrix products only, no eigendecomposition.
    Approximate for eigenvalues within ~1.5^-ns_iters of zero."""
    h = hermitianize(choi)
    sign = _matrix_sign_ns(h, ns_iters)
    with full_f32_matmul():
        return hermitianize((h + h @ sign) / 2)


def proj_choi_to_trace_non_increasing(choi: torch.Tensor) -> torch.Tensor:
    """Project onto the set of trace non-increasing maps (eq. 33 of [PGD])."""
    dim = math.isqrt(choi.shape[-1])
    pt = partial_trace(choi, keep=[0], dims=[dim, dim])
    d_, v = torch.linalg.eigh(hermitianize(pt))
    d_ = d_.clamp(max=1)
    with full_f32_matmul():
        projection = (v * d_[..., None, :].to(v.dtype)) @ dag(v)
    eye = torch.eye(dim, dtype=choi.dtype, device=choi.device)
    return choi - kron((pt - projection) / dim, eye)


def proj_choi_to_trace_preserving(choi: torch.Tensor) -> torch.Tensor:
    """Project onto the closest trace-preserving map (eq. 12 of [PGD]):
    subtract the lift of the partial-trace violation Tr_out(choi) - I."""
    dim = math.isqrt(choi.shape[-1])
    pt = partial_trace(choi, keep=[0], dims=[dim, dim])
    eye = torch.eye(dim, dtype=choi.dtype, device=choi.device)
    return choi - kron((pt - eye) / dim, eye)


def _fro2(x: torch.Tensor) -> torch.Tensor:
    """Squared Frobenius norm over the trailing two axes."""
    return (x.abs() ** 2).sum(dim=(-2, -1))


def _absdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|<<a|b>>| = |sum conj(a) * b| over the trailing two axes."""
    return (a.conj() * b).sum(dim=(-2, -1)).abs()


def proj_choi_to_physical(choi: torch.Tensor,
                          make_trace_preserving: bool = True,
                          tol: float = 1e-4, max_iters: int = 1000,
                          cp_method: str = "eigh",
                          ns_iters: int = 24) -> torch.Tensor:
    """Dykstra's alternating projection onto CP intersect {TP or TNI}.

    Per problem, stop after the first iteration whose Birgin-Raydan
    criterion

        ||dCP_k - dCP_{k-1}||_F^2 + ||dTP_k - dTP_{k-1}||_F^2
        + 2 |<dTP_{k-1}, state_k - state_{k-1}>|
        + 2 |<dCP_{k-1}, CP_k - CP_{k-1}>|

    is below ``tol``, or after ``max_iters`` iterations. Ends on the TP (or
    TNI) half-step, so the output is CP only to the convergence level.
    ``cp_method`` is ``"eigh"`` (exact) or ``"ns"`` (Newton-Schulz sign).
    """
    proj_tp = (proj_choi_to_trace_preserving if make_trace_preserving
               else proj_choi_to_trace_non_increasing)
    if cp_method == "eigh":
        proj_cp = proj_choi_to_completely_positive
    elif cp_method == "ns":
        proj_cp = functools.partial(proj_choi_to_completely_positive_ns,
                                    ns_iters=ns_iters)
    else:
        raise ValueError(f"Unknown cp_method '{cp_method}'")

    shape = choi.shape
    state = choi.reshape(-1, *shape[-2:]).clone()
    cp_change = torch.zeros_like(state)
    tp_change = torch.zeros_like(state)
    cp_last = torch.zeros_like(state)
    active = torch.arange(state.shape[0], device=state.device)
    for _ in range(max_iters):
        if active.numel() == 0:
            break
        last = state[active]
        old_cp, old_tp = cp_change[active], tp_change[active]
        pre_cp = last - old_cp
        cp_proj = proj_cp(pre_cp)
        new_cp = cp_proj - pre_cp
        pre_tp = cp_proj - old_tp
        new_state = proj_tp(pre_tp)
        new_tp = new_state - pre_tp
        crit = (_fro2(new_cp - old_cp) + _fro2(new_tp - old_tp)
                + 2 * _absdot(old_tp, new_state - last)
                + 2 * _absdot(old_cp, cp_proj - cp_last[active]))
        state[active], cp_change[active] = new_state, new_cp
        tp_change[active], cp_last[active] = new_tp, cp_proj
        active = active[~(crit < tol)]
    return state.reshape(shape)


def proj_choi_to_unitary(choi: torch.Tensor) -> torch.Tensor:
    """Closest unitary channel to the given (batched) Choi matrix [IntQC]:
    the dominant eigenvector as the largest-norm Kraus operator, its polar
    part U = u v^dag from the SVD, and the Choi matrix of U (invariant
    under a global phase of U, so none is fixed)."""
    _, vs = torch.linalg.eigh(hermitianize(choi))
    kraus = unvec(vs[..., :, -1])  # eigh sorts ascending: the last column
    u, _, vh = torch.linalg.svd(kraus)
    with full_f32_matmul():
        return kraus2choi((u @ vh)[..., None, :, :])
