"""Fused APG process-MLE solver: plain PyTorch version and CUDA kernel wrapper.

Port of ``forest_benchmarking_tpu/ops/lanes_apg.py``. It solves the PGDB
maximum-likelihood problem, min -sum n log(Re(A vec E)) over CPTP Choi
matrices E, for a batch of independent problems that share one A-matrix:

- start from the linear-inversion estimate, Dykstra-projected;
- run a static schedule of Nesterov phases with O'Donoghue-Candes function
  restart; each proximal step is a Dykstra alternating projection (CP then
  TP) whose CP step is a cyclic-Jacobi eigensolve in the eigenbasis V
  carried over from the previous projection;
- end on a trace-preserving Dykstra half-step.

:func:`apg_fused_reference` is the JAX ``apg_fused_lanes`` written
batch-first on (B, d^2, d^2) real and imaginary planes, with the same
operations in the same order (the 16x16 and A-matrix products go through
``torch.matmul``, so only summation order differs). :func:`apg_fused` is the
wrapper: it builds the warm start, then runs the plain version for CPU
tensors and the hand-written CUDA kernel ``csrc/apg_fused.cu`` for CUDA
tensors (dim=2 or dim=4, float32). :func:`apg_fused_lanes` takes the JAX
package's lanes layout (batch last) and runs the same two.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading
import weakref
from typing import Optional, Sequence, Tuple

import torch

from forest_benchmarking_tpu_torch import kernels, tracing
from forest_benchmarking_tpu_torch.tracing import span

__all__ = [
    "raster_a_matrix", "linear_inversion_start", "apg_fused_reference",
    "apg_fused_kernel", "apg_fused_lanes", "apg_fused", "apg_fused_sharded",
    "apg_fused_flops_per_solve",
    "apg_fused_l2_bytes_per_solve", "full_f32_matmul",
    "PARITY_PHASES", "PARITY_TUNED_2Q", "HEADLINE_TUNED_2Q",
]

# (outer_iters, dykstra_iters, jacobi_sweeps) phases; equal to the JAX
# package's constants (tuned there against the f64 converged optimum).
PARITY_PHASES: Tuple[Tuple[int, int, int], ...] = (
    (12, 1, 1), (10, 2, 1), (28, 6, 1))

PARITY_TUNED_2Q = dict(
    phases=((10, 1, 1), (10, 2, 1), (20, 6, 1), (4, 8, 1)),
    init_iters=6, init_sweeps=3, final_iters=12, final_sweeps=1,
    mu=1.5 / 32)

HEADLINE_TUNED_2Q = dict(
    phases=((5, 1, 1),), init_iters=2, init_sweeps=3,
    final_iters=2, final_sweeps=1, mu=1.5 / 32)



@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32, not TF32 (the port's
    counterpart of the JAX package's ``Precision.HIGHEST`` pins)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _round_robin_pairs(n: int):
    """n-1 rounds of n/2 disjoint index pairs covering every pair exactly once."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = []
        for i in range(n // 2):
            a, b = players[i], players[n - 1 - i]
            pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _pair_index(n: int, device: torch.device):
    """(P, Q): (n-1, n/2) long tensors of the round-robin pairs, p < q."""
    rounds = torch.tensor(_round_robin_pairs(n), dtype=torch.long,
                          device=device)
    return rounds[..., 0], rounds[..., 1]


def _phase(phase) -> Tuple[int, int, int, int]:
    """(outer_iters, dykstra_iters, sweeps, sweeps_rest) of a schedule
    phase given as (outer_iters, dykstra_iters, sweeps[, sweeps_rest]), as
    the JAX package takes it: the optional fourth entry sets the Jacobi
    sweeps of every Dykstra iteration after the first (default ``sweeps``).
    """
    if len(phase) not in (3, 4):
        raise ValueError(f"phase {phase!r} must be (outer_iters, "
                         "dykstra_iters, jacobi_sweeps[, sweeps_rest])")
    outer, ld, sweeps = phase[:3]
    return outer, ld, sweeps, phase[3] if len(phase) == 4 else sweeps


# ----------------------------------------------------------------------
# Plain PyTorch building blocks on (B, n, n) real/imag planes
# ----------------------------------------------------------------------

def _cmul(xr, xi, yr, yi):
    return xr * yr - xi * yi, xr * yi + xi * yr


def _rotation_coeffs(apq_r, apq_i, app, aqq, eps: float):
    """Jacobi rotation coefficients (c, s, e_r, e_i), elementwise."""
    m2 = apq_r * apq_r + apq_i * apq_i
    m = torch.sqrt(m2)
    small = m < eps
    msafe = torch.where(small, 1.0, m)
    e_r = torch.where(small, 1.0, apq_r / msafe)
    e_i = torch.where(small, 0.0, apq_i / msafe)
    tau = (aqq - app) / (2 * msafe)
    sign_tau = torch.where(tau < 0, -1.0, 1.0)
    t = torch.where(tau == 0.0, 1.0,
                    sign_tau / (torch.abs(tau) + torch.sqrt(1 + tau * tau)))
    c = torch.rsqrt(1 + t * t)
    s = t * c
    c = torch.where(small, 1.0, c)
    s = torch.where(small, 0.0, s)
    return c, s, e_r, e_i


def _rotate_pair(pr, pi, qr, qi, c, s, fq, fp):
    """(p, q) <- (c p - s fq*q, s fp*p + c q) with unit phases fq, fp."""
    tq = _cmul(fq[0], fq[1], qr, qi)
    new_p = (c * pr - s * tq[0], c * pi - s * tq[1])
    tp = _cmul(fp[0], fp[1], pr, pi)
    new_q = (s * tp[0] + c * qr, s * tp[1] + c * qi)
    return new_p, new_q


def _multi_sweep(a_r, a_i, v_r, v_i, eps: float, sweeps: int):
    """``sweeps`` cyclic-Jacobi sweeps on (B, n, n) planes, rotating A
    (columns then rows) and the columns of V jointly, in the round order of
    :func:`_round_robin_pairs`."""
    n = a_r.shape[-1]
    P, Q = _pair_index(n, a_r.device)
    for _ in range(sweeps):
        for r in range(n - 1):
            p, q = P[r], Q[r]
            c, s, e_r, e_i = _rotation_coeffs(a_r[:, p, q], a_i[:, p, q],
                                              a_r[:, p, p], a_r[:, q, q], eps)
            e, ebar = (e_r, e_i), (e_r, -e_i)

            def rotate_cols(x_r, x_i):
                cc, ss = c[:, None, :], s[:, None, :]
                fq = (ebar[0][:, None, :], ebar[1][:, None, :])
                fp = (e[0][:, None, :], e[1][:, None, :])
                new_p, new_q = _rotate_pair(x_r[..., p], x_i[..., p],
                                            x_r[..., q], x_i[..., q],
                                            cc, ss, fq, fp)
                out_r, out_i = torch.empty_like(x_r), torch.empty_like(x_i)
                out_r[..., p], out_i[..., p] = new_p
                out_r[..., q], out_i[..., q] = new_q
                return out_r, out_i

            a_r, a_i = rotate_cols(a_r, a_i)
            cc, ss = c[:, :, None], s[:, :, None]
            fq = (e[0][:, :, None], e[1][:, :, None])
            fp = (ebar[0][:, :, None], ebar[1][:, :, None])
            new_p, new_q = _rotate_pair(a_r[:, p], a_i[:, p], a_r[:, q],
                                        a_i[:, q], cc, ss, fq, fp)
            out_r, out_i = torch.empty_like(a_r), torch.empty_like(a_i)
            out_r[:, p], out_i[:, p] = new_p
            out_r[:, q], out_i[:, q] = new_q
            a_r, a_i = out_r, out_i
            v_r, v_i = rotate_cols(v_r, v_i)
    return a_r, a_i, v_r, v_i


def _cmm(ar, ai, br, bi):
    """C = A @ B on (B, n, n) planes."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _cmm_hconj_left(vr, vi, br, bi):
    """C = V^dag @ B on (B, n, n) planes."""
    vrt, vit = vr.transpose(-1, -2), vi.transpose(-1, -2)
    return vrt @ br + vit @ bi, vrt @ bi - vit @ br


def _hermitianize(xr, xi):
    return (xr + xr.transpose(-1, -2)) / 2, (xi - xi.transpose(-1, -2)) / 2


def _warm_cp(hr, hi, vr, vi, sweeps: int, eps: float):
    """CP projection with a carried eigenbasis: rotate H into V, run
    ``sweeps`` Jacobi sweeps, clip negative eigenvalues, reconstruct.
    Returns (pos_r, pos_i, V'_r, V'_i)."""
    hr, hi = _hermitianize(hr, hi)
    tr, ti = _cmm(hr, hi, vr, vi)
    mr, mi = _cmm_hconj_left(vr, vi, tr, ti)
    ar, _, wr, wi = _multi_sweep(mr, mi, vr, vi, eps, sweeps)
    w = torch.diagonal(ar, dim1=-2, dim2=-1).clamp(min=0.0)[:, None, :]
    wrt, wit = wr.transpose(-1, -2), wi.transpose(-1, -2)
    pos_r = (wr * w) @ wrt + (wi * w) @ wit
    pos_i = (wi * w) @ wrt - (wr * w) @ wit
    return pos_r, pos_i, wr, wi


def _proj_tp(xr, xi, dim: int):
    """Trace-preserving projection on (B, d2, d2) planes (eq. 12 of [PGD]):
    X - kron(Tr_out(X) - I, I) / dim."""
    b, n = xr.shape[0], dim * dim
    x5r = xr.reshape(b, dim, dim, dim, dim)
    x5i = xi.reshape(b, dim, dim, dim, dim)
    pt_r = torch.diagonal(x5r, dim1=2, dim2=4).sum(-1)      # (B, dim, dim)
    pt_i = torch.diagonal(x5i, dim1=2, dim2=4).sum(-1)
    eye = torch.eye(dim, dtype=xr.dtype, device=xr.device)
    dr = (pt_r - eye) / dim
    di = pt_i / dim
    eye5 = eye.reshape(1, 1, dim, 1, dim)
    cr = dr[:, :, None, :, None] * eye5
    ci = di[:, :, None, :, None] * eye5
    return (x5r - cr).reshape(b, n, n), (x5i - ci).reshape(b, n, n)


def _restart(t_next, new_cost, old_cost):
    """O'Donoghue-Candes function restart: the momentum parameter goes back
    to 1 for every problem whose cost rose."""
    return torch.where(new_cost > old_cost, 1.0, t_next)


def _dykstra(zr, zi, vr, vi, iters: int, sweeps: int, dim: int, eps: float,
             sweeps_rest: Optional[int] = None):
    """``iters`` Dykstra iterations (warm-V CP, then TP); ends on TP. The
    first runs ``sweeps`` Jacobi sweeps, the others ``sweeps_rest``
    (default ``sweeps``; 0 reuses the eigenbasis as it is)."""
    if sweeps_rest is None:
        sweeps_rest = sweeps
    cp_ch_r = cp_ch_i = tp_ch_r = tp_ch_i = torch.zeros_like(zr)
    st_r, st_i = zr, zi
    for it in range(iters):
        pre_r, pre_i = st_r - cp_ch_r, st_i - cp_ch_i
        cp_r, cp_i, vr, vi = _warm_cp(pre_r, pre_i, vr, vi,
                                      sweeps if it == 0 else sweeps_rest, eps)
        cp_ch_r, cp_ch_i = cp_r - pre_r, cp_i - pre_i
        pre_r, pre_i = cp_r - tp_ch_r, cp_i - tp_ch_i
        st_r, st_i = _proj_tp(pre_r, pre_i, dim)
        tp_ch_r, tp_ch_i = st_r - pre_r, st_i - pre_i
    return st_r, st_i, vr, vi


# ----------------------------------------------------------------------
# Host-side preparation
# ----------------------------------------------------------------------

def raster_a_matrix(a: torch.Tensor, d2: int) -> torch.Tensor:
    """Permute the PGDB A-matrix columns from vec (column-stacking) order to
    raster (row-major) order, so that
    ``raster_a_matrix(A) @ X.reshape(-1) == A @ vec(X)``."""
    a = torch.as_tensor(a)
    return a.reshape(-1, d2, d2).transpose(1, 2).reshape(a.shape[0], d2 * d2)


# rows of each block of the warm start's product on the card
WARM_START_ROWS = 4096


def linear_inversion_start(a_pinv: torch.Tensor, n_counts: torch.Tensor,
                           dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hermitian, trace-``dim`` linear-inversion estimates ``unvec(pinv(A) n)``
    as (B, d2, d2) real/imag planes of ``a_pinv``'s real dtype.

    On the card the product runs in blocks of ``WARM_START_ROWS`` rows, the
    last one zero-padded: cuBLAS picks its kernel, and so its order of
    summation, by the shape of the product (8192 rows summed otherwise than
    4096 or 16384 on the H100), and a problem's warm start must not depend
    on the size of the batch it comes in, or a sharded solve would part
    from the unsharded one."""
    d2 = dim * dim
    n = n_counts.to(a_pinv.dtype)
    with full_f32_matmul():
        if n.is_cuda:
            b = n.shape[0]
            n = torch.cat([n, n.new_zeros((-b % WARM_START_ROWS,
                                           n.shape[1]))])
            x0 = torch.cat([blk @ a_pinv.T
                            for blk in n.split(WARM_START_ROWS)])[:b]
        else:
            x0 = n @ a_pinv.T                                # (B, d4), vec order
    rho0 = x0.reshape(-1, d2, d2).transpose(1, 2)            # unvec
    rho0 = (rho0 + rho0.transpose(1, 2).conj()) / 2
    tr = torch.diagonal(rho0, dim1=1, dim2=2).sum(-1).real
    scale = dim / torch.where(tr.abs() < 1e-12, 1.0, tr)
    rho0 = rho0 * scale[:, None, None]
    return rho0.real.contiguous(), rho0.imag.contiguous()


# ----------------------------------------------------------------------
# The plain version of the fused solve
# ----------------------------------------------------------------------

def apg_fused_reference(ar, ai, n, rho0_r, rho0_i, *, dim: int,
                        phases: Sequence[Tuple[int, int, int]] = PARITY_PHASES,
                        init_iters: int = 8, init_sweeps: int = 3,
                        final_iters: int = 20, final_sweeps: int = 1,
                        final_sweeps_rest: Optional[int] = None,
                        mu: Optional[float] = None):
    """The fused APG solve in plain PyTorch, batch-first.

    :param ar, ai: (R, d4) real/imag planes of the raster-ordered A-matrix.
    :param n: (B, R) normalized counts, one row per problem.
    :param rho0_r, rho0_i: (B, d2, d2) starting matrices; they are
        Dykstra-projected before the first gradient step.
    :param phases: static schedule of (outer_iters, dykstra_iters, sweeps[,
        sweeps_rest]) (see :func:`_phase`).
    :param init_iters/init_sweeps: Dykstra schedule projecting rho0.
    :param final_iters/final_sweeps/final_sweeps_rest: the projection
        applied to the returned estimate (ends on the TP half-step; exactly
        TP); its iterations after the first run ``final_sweeps_rest`` sweeps
        (default ``final_sweeps``).
    :return: (est_r, est_i) planes of shape (B, d2, d2).
    """
    phases = [_phase(p) for p in phases]
    rdtype = ar.dtype
    eps_rot = 1e-30 if rdtype == torch.float64 else 1e-18
    eps_p = 1e-6
    if mu is None:
        mu = 3.0 / (2 * dim ** 2)
    inv_mu = 1.0 / mu
    b, nd = rho0_r.shape[0], dim * dim

    def prob(xr, xi):
        p = xr.reshape(b, -1) @ ar.T - xi.reshape(b, -1) @ ai.T   # (B, R)
        return p.clamp(min=eps_p)

    def cost(xr, xi):
        return -(n * torch.log(prob(xr, xi))).sum(-1)              # (B,)

    def grad(xr, xi):
        eta = n / prob(xr, xi)
        return (-(eta @ ar)).reshape(b, nd, nd), (eta @ ai).reshape(b, nd, nd)

    with full_f32_matmul():
        v_r = torch.eye(nd, dtype=rdtype, device=ar.device).expand(b, nd, nd)
        v_i = torch.zeros_like(v_r)
        est_r, est_i, v_r, v_i = _dykstra(rho0_r, rho0_i, v_r, v_i, init_iters,
                                          init_sweeps, dim, eps_rot)
        prev_r, prev_i = est_r, est_i
        t = torch.ones(b, dtype=rdtype, device=ar.device)
        old_cost = cost(est_r, est_i)
        for iters, ld, sweeps, srest in phases:
            for _ in range(iters):
                t_next = (1 + torch.sqrt(1 + 4 * t * t)) / 2
                beta = ((t - 1) / t_next)[:, None, None]
                y_r = est_r + beta * (est_r - prev_r)
                y_i = est_i + beta * (est_i - prev_i)
                g_r, g_i = grad(y_r, y_i)
                z_r = y_r - inv_mu * g_r
                z_i = y_i - inv_mu * g_i
                cand_r, cand_i, v_r, v_i = _dykstra(z_r, z_i, v_r, v_i, ld,
                                                    sweeps, dim, eps_rot,
                                                    srest)
                new_cost = cost(cand_r, cand_i)
                t = _restart(t_next, new_cost, old_cost)
                prev_r, prev_i, est_r, est_i = est_r, est_i, cand_r, cand_i
                old_cost = new_cost
        est_r, est_i, _, _ = _dykstra(est_r, est_i, v_r, v_i, final_iters,
                                      final_sweeps, dim, eps_rot,
                                      final_sweeps_rest)
    return est_r, est_i


# ----------------------------------------------------------------------
# The CUDA kernel and the wrapper
# ----------------------------------------------------------------------

def apg_fused_kernel(ar, ai, n, rho0_r, rho0_i, *, dim: int,
                     phases: Sequence[Tuple[int, int, int]] = PARITY_PHASES,
                     init_iters: int = 8, init_sweeps: int = 3,
                     final_iters: int = 20, final_sweeps: int = 1,
                     final_sweeps_rest: Optional[int] = None,
                     mu: Optional[float] = None):
    """Launch ``csrc/apg_fused.cu`` on PyTorch's current stream.

    Takes what :func:`apg_fused_reference` takes, as contiguous float32
    CUDA tensors, and returns the same (est_r, est_i) planes. ``dim`` is 4
    (four problems per thread block; the kernel also reads A^T, which is
    formed here) or 2 (64 per block). Adds one to
    ``apg_fused.launches`` per launch."""
    if dim not in (2, 4):
        raise NotImplementedError(
            f"the CUDA fused solver is built for dim=2 (1Q) and dim=4 (2Q), "
            f"got dim={dim}")
    if len(phases) > kernels.MAX_PHASES:
        raise ValueError(f"the CUDA kernel takes at most {kernels.MAX_PHASES} "
                         f"phases, got {len(phases)}")
    rows, d4 = ar.shape
    b, d2 = n.shape[0], dim * dim
    for name, x, shape in (("ar", ar, (rows, d4)), ("ai", ai, (rows, d4)),
                           ("n", n, (b, rows)), ("rho0_r", rho0_r, (b, d2, d2)),
                           ("rho0_i", rho0_i, (b, d2, d2))):
        kernels.check_operand(name, x, ar.device, torch.float32, shape)
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d4 != d2 * d2:
        raise ValueError(f"A must have {d2 * d2} columns for dim={dim}, "
                         f"got {d4}")
    if mu is None:
        mu = 3.0 / (2 * dim ** 2)
    sched = kernels.ApgSchedule(
        n_phases=len(phases), init_iters=init_iters, init_sweeps=init_sweeps,
        final_iters=final_iters, final_sweeps=final_sweeps,
        final_sweeps_rest=(final_sweeps if final_sweeps_rest is None
                           else final_sweeps_rest), inv_mu=1.0 / mu)
    for k, phase in enumerate(phases):
        (sched.outer[k], sched.dykstra[k], sched.sweeps[k],
         sched.sweeps_rest[k]) = _phase(phase)
    out_r = torch.empty_like(rho0_r)
    out_i = torch.empty_like(rho0_i)
    # the dim = 4 p pass reads A^T, coalesced over the rows; the dim = 2
    # kernel reads only A and gets null pointers
    at_ptrs = (None, None)
    if dim == 4:
        at = (ar.T.contiguous(), ai.T.contiguous())   # alive to the launch
        at_ptrs = tuple(x.data_ptr() for x in at)
    kernels.launch("apg_fused_launch", ar.device, ar.data_ptr(), ai.data_ptr(),
                   *at_ptrs, n.data_ptr(), rho0_r.data_ptr(),
                   rho0_i.data_ptr(), out_r.data_ptr(), out_i.data_ptr(), b,
                   rows, dim, ctypes.byref(sched))
    apg_fused.launches += 1
    return out_r, out_i


def apg_fused_lanes(ar, ai, n_mat, rho0_r, rho0_i, *, dim: int,
                    phases: Sequence[Tuple[int, int, int]] = PARITY_PHASES,
                    init_iters: int = 8, init_sweeps: int = 3,
                    final_iters: int = 20, final_sweeps: int = 1,
                    final_sweeps_rest: Optional[int] = None,
                    mu: Optional[float] = None):
    """The fused solve on the JAX package's lanes layout (batch last).

    :param ar, ai: (R, d4) real/imag planes of the raster-ordered A-matrix.
    :param n_mat: (R, *batch) normalized counts, one column per problem;
        ``batch`` may have any rank.
    :param rho0_r, rho0_i: (d2, d2, *batch) starting matrices.
    :return: (est_r, est_i) planes of shape (d2, d2, *batch).

    The batch is moved to the front and solved as :func:`apg_fused` solves
    it: by ``apg_fused_kernel`` for CUDA tensors (dim=2 or 4, float32), by
    :func:`apg_fused_reference` for CPU tensors.
    """
    d2 = dim * dim
    batch = tuple(n_mat.shape[1:])

    def front(x):
        return x.reshape(d2, d2, -1).permute(2, 0, 1).contiguous()

    n = n_mat.reshape(n_mat.shape[0], -1).T.contiguous()
    if ar.is_cuda:
        solve = apg_fused_kernel
    elif ar.device.type == "cpu":
        solve = apg_fused_reference
    else:
        raise ValueError(f"unsupported device {ar.device}")
    est_r, est_i = solve(
        ar.contiguous(), ai.contiguous(), n, front(rho0_r), front(rho0_i),
        dim=dim, phases=phases, init_iters=init_iters,
        init_sweeps=init_sweeps, final_iters=final_iters,
        final_sweeps=final_sweeps, final_sweeps_rest=final_sweeps_rest, mu=mu)
    return tuple(x.permute(1, 2, 0).reshape(d2, d2, *batch)
                 for x in (est_r, est_i))


def apg_fused_flops_per_solve(rows: int, dim: int = 4,
                              phases: Sequence[Tuple[int, int, int]] = PARITY_PHASES,
                              init_iters: int = 8, init_sweeps: int = 3,
                              final_iters: int = 20, final_sweeps: int = 1,
                              final_sweeps_rest: Optional[int] = None,
                              mu: Optional[float] = None) -> float:
    """Floating-point operations of one fused solve as the CUDA kernel
    computes it (n = dim^2, R = ``rows``):

    - passes over A: 1 for the first cost plus 3 per outer step (p = Re(A x)
      and A^T eta at y, p for the candidate's cost), 4 R n^2 each (two real
      multiply-adds per complex entry);
    - per Dykstra iteration: hermitianize (2 n^2), the basis rotation
      M = V^dag H V (two complex n x n products, 8 n^3 each), s Jacobi
      sweeps (n - 1 rounds of rotations of M's columns and rows and V's
      columns, ~36 n^2 per round), the reconstruction (8 n^3) and the TP
      projection (~4 n^2). The first iteration of a projection runs its
      ``sweeps``, the others its ``sweeps_rest`` (:func:`_phase`).

    ``mu`` (the step) does not change the count; it is accepted so that a
    schedule dict can be passed whole.
    """
    n = dim * dim
    per_pass = 4.0 * rows * n * n

    def per_dykstra(sweeps):
        return 2 * n * n + 16.0 * n ** 3 + sweeps * 36.0 * n * n * (n - 1) \
            + 8.0 * n ** 3 + 4 * n * n

    def projection(iters, sweeps, sweeps_rest):
        if iters == 0:
            return 0.0
        return per_dykstra(sweeps) + (iters - 1) * per_dykstra(sweeps_rest)

    total = _a_passes(phases) * per_pass
    total += projection(init_iters, init_sweeps, init_sweeps)
    total += projection(final_iters, final_sweeps,
                        final_sweeps if final_sweeps_rest is None
                        else final_sweeps_rest)
    for iters, ld, sweeps, srest in map(_phase, phases):
        total += iters * projection(ld, sweeps, srest)
    return total


def apg_fused_l2_bytes_per_solve(rows: int, dim: int = 4,
                                 problems_per_block: int = 1,
                                 phases: Sequence[Tuple[int, int, int]] = PARITY_PHASES,
                                 **schedule) -> float:
    """Bytes the CUDA kernel reads from L2 for A per solve: every pass reads
    one f32 copy of the two planes of A (A or A^T, 2 x R x dim^4 x 4 bytes),
    once for all ``problems_per_block`` problems of a block. The passes are
    those :func:`apg_fused_flops_per_solve` counts; the other schedule
    arguments do not change the count and are accepted so that a schedule
    dict can be passed whole."""
    n = dim * dim
    return _a_passes(phases) * 2.0 * rows * n * n * 4 / problems_per_block


def _a_passes(phases) -> int:
    """Passes over A of one solve: 1 for the first cost plus 3 per outer
    step (p and A^T eta at y, p for the candidate's cost)."""
    return 1 + 3 * sum(p[0] for p in phases)


PINV_CACHE_SIZE = 4   # A-matrices whose pinv apg_fused keeps

# id(A) -> (weak reference to A, _pinv_key(A), pinv(A)), least recently
# used first
_pinv_cache: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()
# reentrant: a weak reference's callback may run on the thread that holds it
_pinv_lock = threading.RLock()


def _pinv_key(a: torch.Tensor) -> tuple:
    """What a cached pinv(A) must find unchanged besides the tensor object,
    all of it read on the host: A's version counter, where and how its
    elements lie, and what else decides the result of
    ``torch.linalg.pinv``'s products (the stream it is ordered on, TF32)."""
    stream = (torch.cuda.current_stream(a.device).cuda_stream if a.is_cuda
              else None)
    return (a._version, a.device, a.dtype, a.shape, a.stride(),
            a.storage_offset(), a.data_ptr(), stream,
            torch.backends.cuda.matmul.allow_tf32)


def _drop_pinv(key: int, ref: weakref.ref) -> None:
    """Drop the entry of an A-matrix that has died."""
    with _pinv_lock:
        entry = _pinv_cache.get(key)
        if entry is not None and entry[0] is ref:
            del _pinv_cache[key]


def _cached_pinv(a: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.pinv(a)``, computed once for an unchanged ``a`` (see
    :func:`apg_fused`)."""
    # an inference tensor has no version counter to check; a tensor that
    # requires grad would share one graph between calls
    cacheable = not (a.is_inference()
                     or (a.requires_grad and torch.is_grad_enabled()))
    if cacheable:
        key = _pinv_key(a)
        with _pinv_lock:
            entry = _pinv_cache.get(id(a))
            if entry is not None and entry[0]() is a and entry[1] == key:
                _pinv_cache.move_to_end(id(a))
                apg_fused.pinv_reused += 1
                return entry[2]
    a_pinv = torch.linalg.pinv(a)
    if cacheable:
        entry = (weakref.ref(a, functools.partial(_drop_pinv, id(a))), key,
                 a_pinv)
    with _pinv_lock:
        if cacheable:
            _pinv_cache[id(a)] = entry
            _pinv_cache.move_to_end(id(a))
            while len(_pinv_cache) > PINV_CACHE_SIZE:
                _pinv_cache.popitem(last=False)
        apg_fused.pinv_computed += 1
    return a_pinv


def apg_fused(a: torch.Tensor, n_counts: torch.Tensor, dim: int,
              phases: Sequence[Tuple[int, int, int]] = PARITY_PHASES,
              init_iters: int = 8, init_sweeps: int = 3,
              final_iters: int = 20, final_sweeps: int = 1,
              final_sweeps_rest: Optional[int] = None,
              block: int = 128, use_pallas: bool = True,
              mu: Optional[float] = None,
              a_pinv: Optional[torch.Tensor] = None,
              sublanes: Optional[int] = None) -> torch.Tensor:
    """Fused-APG batched PGDB MLE: (R, d4) complex A-matrix (vec order),
    (B, R) counts -> (B, d2, d2) complex Choi estimates.

    Warm-starts from the linear-inversion estimate (``pinv(A) n``, computed
    with torch outside the solve, as the JAX package does outside its
    kernel), then runs the static-schedule solve: the CUDA kernel when the
    inputs are CUDA tensors (dim=2 or 4, complex64 A), the plain PyTorch
    version when they are CPU tensors. With ``use_pallas=False`` (the JAX
    package's switch) the plain version runs wherever the tensors lie, the
    card included, at any dtype and dim; with the default, CUDA inputs the
    kernel does not take raise. ``block`` and ``sublanes`` (the JAX
    package's TPU tile sizes) are taken at the JAX package's positions and
    change nothing: the CUDA kernel's layout is fixed.

    ``pinv(A)`` is cached: the last ``PINV_CACHE_SIZE`` A-matrices keep the
    tensor ``torch.linalg.pinv`` returned for them, least recently used
    dropped first. A call reuses it when it passes the same tensor object,
    at the same ``a._version``, device, dtype, shape, strides, offset and
    data pointer, on the same CUDA stream and TF32 setting; the check reads
    no element of A and does not synchronize. Anything else computes
    ``torch.linalg.pinv(a)`` as an uncached call would: a new tensor, even
    with equal contents, an in-place edit of A (it bumps ``_version``), an
    inference tensor (it has no version counter), an A that requires grad
    with grad enabled. The cache holds A by a weak reference, so it keeps
    no A-matrix alive, and drops an entry when its A dies. Like torch's own
    checks on tensors saved for backward, it cannot see a write that
    bypasses the version counter, through ``.data`` or a raw pointer: a
    caller who writes A so passes ``a_pinv`` or a fresh tensor. ``a_pinv``
    ((d4, R), optional) is a given ``pinv(A)``, used as it is; the cache is
    then neither read nor written.

    ``apg_fused.launches`` counts the kernel launches,
    ``apg_fused.pinv_computed`` the pinvs computed (cache misses) and
    ``apg_fused.pinv_reused`` the pinvs taken from the cache.
    """
    phases = tuple(map(_phase, phases))
    if n_counts.device != a.device:
        raise ValueError(f"counts on {n_counts.device} but A on {a.device}")
    d2 = dim * dim
    kw = dict(dim=dim, phases=phases, init_iters=init_iters,
              init_sweeps=init_sweeps, final_iters=final_iters,
              final_sweeps=final_sweeps, final_sweeps_rest=final_sweeps_rest,
              mu=mu)
    with span(tracing.APG_FUSED):
        with span(tracing.APG_RASTER):
            a_rast = raster_a_matrix(a, d2)
            ar = a_rast.real.contiguous()
            ai = a_rast.imag.contiguous()
        with span(tracing.APG_PINV):
            if a_pinv is None:
                a_pinv = _cached_pinv(a)
        with span(tracing.APG_WARM_START):
            rho0_r, rho0_i = linear_inversion_start(a_pinv, n_counts, dim)
        with span(tracing.APG_KERNEL):
            n_mat = n_counts.to(ar.dtype).contiguous()
            if a.is_cuda and use_pallas:
                est_r, est_i = apg_fused_kernel(ar, ai, n_mat, rho0_r, rho0_i,
                                                **kw)
            elif a.is_cuda or a.device.type == "cpu":
                est_r, est_i = apg_fused_reference(ar, ai, n_mat, rho0_r,
                                                   rho0_i, **kw)
            else:
                raise ValueError(f"unsupported device {a.device}")
        with span(tracing.APG_ASSEMBLE):
            return torch.complex(est_r, est_i).to(a.dtype)


apg_fused.launches = 0
apg_fused.pinv_computed = 0
apg_fused.pinv_reused = 0


def apg_fused_sharded(a: torch.Tensor, n_counts: torch.Tensor, mesh,
                      axis_name: str = "batch", **kw) -> torch.Tensor:
    """Run :func:`apg_fused` with the problem batch sharded across a mesh.

    Each device of the mesh runs the whole fused solve (on the card: the
    CUDA kernel, one launch a shard) on its shard of the counts, with the
    A-matrix (and any tensor in ``kw``, such as ``a_pinv``) copied to it;
    the estimates are concatenated on the mesh's first device. The solve is
    elementwise in the batch, so the result is bitwise that of the
    unsharded call.

    :param a: (R, d4) complex A-matrix (copied to every device).
    :param n_counts: (B, R) normalized counts; B must divide evenly by the
        mesh size.
    :param mesh: a :class:`~..parallel.Mesh` with ``axis_name`` as its
        batch axis, e.g. from ``parallel.make_mesh()``.
    :param kw: forwarded to :func:`apg_fused` (``dim`` is required).
    """
    from forest_benchmarking_tpu_torch.parallel import shard_map_batched

    if n_counts.shape[0] % mesh.shape[axis_name] != 0:
        raise ValueError(
            f"batch {n_counts.shape[0]} must be divisible by the mesh axis "
            f"{axis_name!r} size {mesh.shape[axis_name]}")
    mapped = shard_map_batched(lambda a_, n_, kw_: apg_fused(a_, n_, **kw_),
                               mesh, batched_argnums=(1,),
                               axis_name=axis_name)
    return mapped(a, n_counts, kw)
