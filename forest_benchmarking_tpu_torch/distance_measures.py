"""Distances and other properties of quantum states and processes, batched.

Port of ``forest_benchmarking_tpu/distance_measures.py``. Every measure
takes arbitrary leading batch dimensions, runs where its tensors lie and
returns a real tensor, with the JAX package's choices:

- ``trace_distance`` is the Schatten-1 norm 0.5 sum |eig(rho - sigma)|, the
  textbook definition (the reference's ``np.linalg.norm(rho - sigma, 1)``
  is the induced 1-norm, 0.5 for orthogonal pure states);
- ``quantum_chernoff_bound`` minimizes over s in [0, 1] by a fixed
  100-step golden-section search over an eigen-overlap matrix;
- ``diamond_norm_distance`` solves the Watrous SDP [CBN] by Adam ascent
  over a square-root factor of rho, the inner maximum being the positive
  part of a congruence of the Choi difference. The dense route
  differentiates ``torch.linalg.eigvalsh`` with ``torch.autograd``; the
  fused route is :mod:`.ops.lanes_dnorm`.

Float32 products run in full float32, not TF32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.ops.calculational import (
    dag, hermitianize, kron, partial_trace, sqrtm_psd)
from forest_benchmarking_tpu_torch.ops import lanes_dnorm
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul

__all__ = [
    "purity", "impurity", "fidelity", "infidelity", "trace_distance",
    "bures_distance", "bures_angle", "quantum_chernoff_bound",
    "hilbert_schmidt_ip", "smith_fidelity", "total_variation_distance",
    "entanglement_fidelity", "process_fidelity", "process_infidelity",
    "diamond_norm_distance", "watrous_bounds",
]


def _tr_sq(rho: torch.Tensor) -> torch.Tensor:
    """Re tr[rho^2] over the trailing two axes."""
    return torch.einsum("...ij,...ji->...", rho, rho).real


def purity(rho: torch.Tensor, dim_renorm: bool = False) -> torch.Tensor:
    """Purity tr[rho^2]; optionally renormalized from [1/dim, 1] to
    [0, 1]."""
    p = _tr_sq(rho)
    if dim_renorm:
        dim = rho.shape[-1]
        p = (dim / (dim - 1.0)) * (p - 1.0 / dim)
    return p


def impurity(rho: torch.Tensor, dim_renorm: bool = False) -> torch.Tensor:
    """Impurity (linear entropy) 1 - tr[rho^2]."""
    imp = 1 - _tr_sq(rho)
    if dim_renorm:
        dim = rho.shape[-1]
        imp = (dim / (dim - 1.0)) * imp
    return imp


def fidelity(rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Uhlmann fidelity F = (tr sqrt(sqrt(rho) sigma sqrt(rho)))^2."""
    sqrt_rho = sqrtm_psd(rho)
    with full_f32_matmul():
        inner = sqrtm_psd(sqrt_rho @ sigma @ sqrt_rho)
    return torch.diagonal(inner, dim1=-2, dim2=-1).sum(-1).real ** 2


def infidelity(rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """1 - F(rho, sigma)."""
    return 1 - fidelity(rho, sigma)


def trace_distance(rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """T(rho, sigma) = 0.5 ||rho - sigma||_1 (Schatten-1 norm; see the
    module docstring)."""
    evals = torch.linalg.eigvalsh(hermitianize(rho - sigma))
    return 0.5 * evals.abs().sum(-1)


def bures_distance(rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """D_B with D_B^2 = 2 (1 - sqrt(F))."""
    return torch.sqrt(2 * (1 - torch.sqrt(fidelity(rho, sigma))))


def bures_angle(rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """D_A = arccos(sqrt(F))."""
    return torch.arccos(torch.sqrt(fidelity(rho, sigma)))


def quantum_chernoff_bound(rho: torch.Tensor, sigma: torch.Tensor,
                           num_iters: int = 100
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Non-logarithmic quantum Chernoff bound min_s tr(rho^s sigma^(1-s))
    [QCB].

    With rho = U diag(a) U^dag and sigma = V diag(b) V^dag the objective is
    ``sum_ij a_i^s b_j^(1-s) |U^dag V|^2_ij``, minimized on s in [0, 1] by a
    golden-section search of ``num_iters`` steps.

    :return: (qcb, s_opt) per batch element.
    """
    a, u = torch.linalg.eigh(rho)
    b, v = torch.linalg.eigh(sigma)
    with full_f32_matmul():
        overlap = (dag(u) @ v).abs() ** 2  # (..., d, d)
    tiny = torch.finfo(overlap.dtype).tiny
    a = a.clamp(min=tiny)
    b = b.clamp(min=tiny)

    def f(s):
        term = (a[..., :, None] ** s[..., None, None]) * \
               (b[..., None, :] ** (1 - s[..., None, None]))
        return (term * overlap).sum((-2, -1))

    invphi = (np.sqrt(5) - 1) / 2
    lo = torch.zeros(overlap.shape[:-2], dtype=overlap.dtype,
                     device=overlap.device)
    hi = torch.ones_like(lo)
    for _ in range(num_iters):
        x1 = hi - invphi * (hi - lo)
        x2 = lo + invphi * (hi - lo)
        go_left = f(x1) < f(x2)
        lo, hi = torch.where(go_left, lo, x1), torch.where(go_left, x2, hi)
    s_opt = (lo + hi) / 2
    return f(s_opt), s_opt


def hilbert_schmidt_ip(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hilbert-Schmidt inner product Tr[A^dag B] (real part returned)."""
    return torch.einsum("...ij,...ij->...", a.conj(), b).real


def smith_fidelity(rho: torch.Tensor, sigma: torch.Tensor,
                   power: float) -> torch.Tensor:
    """Smith fidelity sqrt(F)^power, for 0 <= power < 2."""
    if power < 0:
        raise ValueError("Power must be positive")
    if power >= 2:
        raise ValueError("Power must be less than 2")
    return torch.sqrt(fidelity(rho, sigma)) ** power


def total_variation_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """TVD between two (batched) probability vectors over the last axis;
    the reference's (d, 1) columns are accepted."""
    if p.shape[-1] == 1 and p.dim() >= 2:
        p, q = p[..., 0], q[..., 0]
    return 0.5 * (p - q).abs().sum(-1)


# ============================================================================
# Processes
# ============================================================================

def entanglement_fidelity(pauli_lio0: torch.Tensor,
                          pauli_lio1: torch.Tensor) -> torch.Tensor:
    """F_e(E, F) = Tr[E^dag F] / dim^2 for Pauli-Liouville matrices
    [H**3][GFID]."""
    return hilbert_schmidt_ip(pauli_lio0, pauli_lio1) / pauli_lio0.shape[-1]


def process_fidelity(pauli_lio0: torch.Tensor,
                     pauli_lio1: torch.Tensor) -> torch.Tensor:
    """F_process = (dim F_e + 1) / (dim + 1) (the average gate fidelity)."""
    dim = math.isqrt(pauli_lio0.shape[-1])
    fe = entanglement_fidelity(pauli_lio0, pauli_lio1)
    return (dim * fe + 1) / (dim + 1)


def process_infidelity(pauli_lio0: torch.Tensor,
                       pauli_lio1: torch.Tensor) -> torch.Tensor:
    """1 - F_process."""
    return 1 - process_fidelity(pauli_lio0, pauli_lio1)


def _dnorm_objective(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """f(rho(A)) = sum of positive eigenvalues of (S (x) I)^dag J (S (x) I).

    S = A / ||A||_F, so rho = S S^dag is PSD with unit trace; S lifts onto
    the first Choi factor, the input system of the H_in (x) H_out
    convention. ||A||^2 is floored inside the square root: the warm start
    gives A = 0 when J = 0 (identical channels), where the value and the
    norm's derivative would otherwise be 0/0. Gradients flow through the
    eigenvalues only.
    """
    d = a.shape[-1]
    nu2 = (a.real ** 2 + a.imag ** 2).sum((-2, -1), keepdim=True)
    s = a / torch.sqrt(nu2.clamp(min=1e-30))
    lift = kron(s, torch.eye(d, dtype=a.dtype, device=a.device))
    with full_f32_matmul():
        m = dag(lift) @ j @ lift
    return torch.relu(torch.linalg.eigvalsh(hermitianize(m))).sum(-1)


def _dnorm_dense(j: torch.Tensor, num_iters: int, num_restarts: int,
                 seed: int, warm_start: bool, stop_tol: float,
                 min_iters: int, decay_iters: float
                 ) -> Tuple[torch.Tensor, int]:
    """The dense route of :func:`diamond_norm_distance` on the Hermitian
    Choi difference ``j``: (values, Adam steps run)."""
    d = math.isqrt(j.shape[-1])
    batch = j.shape[:-2]
    rdtype = j.real.dtype
    if warm_start:
        # the input marginal of |J|, regularized: it can be near-singular
        # for low-rank J
        evals, vecs = torch.linalg.eigh(j)
        with full_f32_matmul():
            jabs = (vecs * evals.abs()[..., None, :].to(j.dtype)) @ dag(vecs)
        marg = partial_trace(jabs, keep=[0], dims=[d, d])
        tr = torch.diagonal(marg, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        marg = marg + 0.05 * tr / d * torch.eye(d, dtype=j.dtype,
                                                device=j.device)
        s0 = sqrtm_psd(marg)
        first = torch.stack([s0.real, s0.imag], dim=0)[None]
    else:
        eye = torch.eye(d, dtype=rdtype, device=j.device).expand(
            *batch, d, d)
        first = torch.stack([eye, torch.zeros_like(eye)], dim=0)[None]
    gen = torch.Generator(device=j.device).manual_seed(seed)
    rand = torch.randn((num_restarts - 1, 2, *batch, d, d), generator=gen,
                       dtype=rdtype, device=j.device)
    x = torch.cat([first.to(rdtype), rand], dim=0)  # (R, 2, ..., d, d)
    jb = j.expand(num_restarts, *j.shape)

    lr0, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    prev = torch.zeros((num_restarts, *batch), dtype=rdtype, device=j.device)
    delta, it = 1.0, 0
    while it < num_iters:
        # the early exit: the batch-wide max relative change of the last
        # step, read on the host once a step after min_iters
        if stop_tol != 0 and it >= min_iters and not bool(delta > stop_tol):
            break
        xg = x.detach().requires_grad_(True)
        vals = _dnorm_objective(torch.complex(xg[:, 0], xg[:, 1]), jb)
        g, = torch.autograd.grad(vals.sum(), xg)
        vals = vals.detach()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g ** 2
        it += 1
        mhat = m / (1 - b1 ** it)
        vhat = v / (1 - b2 ** it)
        lr = lr0 * 0.5 ** ((it - 1) / decay_iters)
        x = x + lr * mhat / (torch.sqrt(vhat) + eps)  # ascent
        delta = ((vals - prev).abs() / vals.abs().clamp(min=1e-3)).max()
        prev = vals
    with torch.no_grad():
        vals = _dnorm_objective(torch.complex(x[:, 0], x[:, 1]), jb)
    return 2 * vals.amax(0), it


def diamond_norm_distance(choi0: torch.Tensor, choi1: torch.Tensor,
                          num_iters: Optional[int] = None,
                          num_restarts: Optional[int] = None,
                          seed: Optional[int] = None,
                          warm_start: Optional[bool] = None,
                          stop_tol: Optional[float] = None,
                          min_iters: Optional[int] = None,
                          method: str = "auto",
                          fused_iters: int = 96,
                          decay_iters: Optional[float] = None
                          ) -> torch.Tensor:
    r"""Diamond-norm distance between two CPTP maps given as Choi matrices.

    Solves the Watrous SDP [CBN]

        max 2 Re tr(J^dag W)  s.t.  0 <= W <= I (x) rho,  rho a density matrix

    For fixed rho the inner maximum is the positive part of
    ``(sqrt(rho) (x) I)^dag J (sqrt(rho) (x) I)``; the outer objective is
    concave in rho and is ascended with Adam on a square-root factor.

    The dense route (``method="dense"``): the factor starts from the input
    marginal of |J| (``warm_start``, default) or the identity, then
    ``num_restarts - 1`` normal draws from a ``torch.Generator`` seeded with
    ``seed`` (JAX draws them with ``jax.random``, so with restarts the two
    packages agree by value, not bitwise); at most ``num_iters`` (200) Adam
    steps, the learning rate halving every ``decay_iters`` (50) steps,
    stopping once the batch-wide max relative change of the objective is at
    most ``stop_tol`` (3e-7) after ``min_iters`` (24) steps, which reads
    one scalar on the host a step; ``stop_tol=0`` runs the fixed schedule
    with no synchronization. The value is the best restart's.

    :param method: ``"fused"`` runs :func:`.ops.lanes_dnorm.dnorm_planes`
        (a fixed ``fused_iters``-step schedule, warm-carried Jacobi
        eigenbases, a hand-derived gradient). ``"auto"`` (default) takes
        the fused route for dim <= 4 when the tensors lie on the card, and
        the dense route on the CPU; as in JAX, it also takes the dense
        route whenever one of ``num_iters``/``num_restarts``/``seed``/
        ``warm_start``/``stop_tol``/``min_iters``/``decay_iters`` is passed
        (their ``None`` means the solver's choice): an explicit budget is
        always honored.
    :return: per-batch-element diamond-norm distance (real tensor).
    """
    j = hermitianize(choi0 - choi1)
    d = math.isqrt(j.shape[-1])
    explicit_dense_budget = any(
        v is not None for v in (num_iters, num_restarts, seed, warm_start,
                                stop_tol, min_iters, decay_iters))
    if method == "auto":
        method = ("fused" if d <= 4 and j.is_cuda
                  and not explicit_dense_budget else "dense")
    if method == "fused":
        n = d * d
        jp = j.reshape(-1, n, n)
        vals = lanes_dnorm.dnorm_planes(jp.real.contiguous(),
                                        jp.imag.contiguous(), dim=d,
                                        num_iters=fused_iters)
        return vals.reshape(j.shape[:-2])
    if method != "dense":
        raise ValueError(f"unknown method {method!r}")
    return _dnorm_dense(
        j, 200 if num_iters is None else num_iters,
        1 if num_restarts is None else num_restarts,
        7 if seed is None else seed,
        True if warm_start is None else warm_start,
        3e-7 if stop_tol is None else stop_tol,
        24 if min_iters is None else min_iters,
        50.0 if decay_iters is None else float(decay_iters))[0]


def watrous_bounds(choi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lower, upper) Watrous bounds on the diamond norm from the nuclear
    norm: ``nuclear <= dnorm <= dim**2 * nuclear``, with the reference's
    factor, the full Choi dimension ``choi.shape[-2]``."""
    nuclear = torch.linalg.svdvals(choi).sum(-1)
    return nuclear, choi.shape[-2] * nuclear
