"""Plain reference of the ``ptomo2q`` configuration: the fused APG solve of
batched two-qubit process-tomography MLE, in plain PyTorch.

A frozen copy of the algorithm that ``forest_benchmarking_tpu_torch``'s
fused solver runs (``ops/lanes_apg``: the linear-inversion warm start from
``pinv(A)``, then a static schedule of Nesterov steps with function
restart, each proximal step a Dykstra CP/TP projection whose CP step is a
cyclic-Jacobi eigensolve in the carried eigenbasis), written batch-first on
real and imaginary planes. The schedule is not run to convergence, so the
reference runs the same steps, not just the same problem. It imports
nothing of the program and takes nothing the program made: it works out
``pinv(A)``, the warm start and the raster order of A again from the
A-matrix and the counts.

``precision="f64"`` is the reference: float64 throughout. ``"tf32"`` is the
control: float32 data with every matrix product's operands rounded to TF32
(10 mantissa bits, as the tensor cores take them) and float32 accumulation,
the step below the configuration's full-float32 products.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

# HEADLINE_TUNED_2Q of the configuration (``"fused_schedule": "headline"``)
HEADLINE = dict(phases=((5, 1, 1),), init_iters=2, init_sweeps=3,
                final_iters=2, final_sweeps=1, mu=1.5 / 32)
SCHEDULES = {"headline": HEADLINE}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest, ties to
    even); the result is a float32 tensor."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def _mm_full(a, b):
    return a @ b


def _mm_tf32(a, b):
    return tf32_round(a) @ tf32_round(b)


@functools.lru_cache(maxsize=None)
def _rounds(n: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """n-1 rounds of n/2 disjoint pairs (p < q), the round-robin order."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append(tuple((min(players[i], players[n - 1 - i]),
                             max(players[i], players[n - 1 - i]))
                            for i in range(n // 2)))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _pairs(n: int, device):
    r = torch.tensor(_rounds(n), dtype=torch.long, device=device)
    return r[..., 0], r[..., 1]


def _cmul(xr, xi, yr, yi):
    return xr * yr - xi * yi, xr * yi + xi * yr


def _coeffs(apq_r, apq_i, app, aqq, eps):
    m = torch.sqrt(apq_r * apq_r + apq_i * apq_i)
    small = m < eps
    msafe = torch.where(small, 1.0, m)
    e_r = torch.where(small, 1.0, apq_r / msafe)
    e_i = torch.where(small, 0.0, apq_i / msafe)
    tau = (aqq - app) / (2 * msafe)
    t = torch.where(tau == 0.0, 1.0, torch.where(tau < 0, -1.0, 1.0)
                    / (torch.abs(tau) + torch.sqrt(1 + tau * tau)))
    c = torch.rsqrt(1 + t * t)
    s = t * c
    return (torch.where(small, 1.0, c), torch.where(small, 0.0, s), e_r, e_i)


def _rotate(pr, pi, qr, qi, c, s, fq, fp):
    tq = _cmul(fq[0], fq[1], qr, qi)
    tp = _cmul(fp[0], fp[1], pr, pi)
    return ((c * pr - s * tq[0], c * pi - s * tq[1]),
            (s * tp[0] + c * qr, s * tp[1] + c * qi))


def _sweeps(a_r, a_i, v_r, v_i, eps, sweeps):
    """Cyclic-Jacobi sweeps rotating A (columns, then rows) and V's columns."""
    n = a_r.shape[-1]
    P, Q = _pairs(n, a_r.device)
    for _ in range(sweeps):
        for r in range(n - 1):
            p, q = P[r], Q[r]
            c, s, e_r, e_i = _coeffs(a_r[:, p, q], a_i[:, p, q],
                                     a_r[:, p, p], a_r[:, q, q], eps)
            e, ebar = (e_r, e_i), (e_r, -e_i)

            def cols(x_r, x_i):
                new_p, new_q = _rotate(
                    x_r[..., p], x_i[..., p], x_r[..., q], x_i[..., q],
                    c[:, None, :], s[:, None, :],
                    (ebar[0][:, None, :], ebar[1][:, None, :]),
                    (e[0][:, None, :], e[1][:, None, :]))
                o_r, o_i = torch.empty_like(x_r), torch.empty_like(x_i)
                o_r[..., p], o_i[..., p] = new_p
                o_r[..., q], o_i[..., q] = new_q
                return o_r, o_i

            a_r, a_i = cols(a_r, a_i)
            new_p, new_q = _rotate(
                a_r[:, p], a_i[:, p], a_r[:, q], a_i[:, q],
                c[:, :, None], s[:, :, None],
                (e[0][:, :, None], e[1][:, :, None]),
                (ebar[0][:, :, None], ebar[1][:, :, None]))
            o_r, o_i = torch.empty_like(a_r), torch.empty_like(a_i)
            o_r[:, p], o_i[:, p] = new_p
            o_r[:, q], o_i[:, q] = new_q
            a_r, a_i = o_r, o_i
            v_r, v_i = cols(v_r, v_i)
    return a_r, a_i, v_r, v_i


def _cp(hr, hi, vr, vi, sweeps, eps, mm):
    """Positive part of the hermitian part of H, rotated into the carried
    basis V first; returns it and the new basis."""
    hr = (hr + hr.transpose(-1, -2)) / 2
    hi = (hi - hi.transpose(-1, -2)) / 2
    tr, ti = mm(hr, vr) - mm(hi, vi), mm(hr, vi) + mm(hi, vr)
    vrt, vit = vr.transpose(-1, -2), vi.transpose(-1, -2)
    mr, mi = mm(vrt, tr) + mm(vit, ti), mm(vrt, ti) - mm(vit, tr)
    ar, _, wr, wi = _sweeps(mr, mi, vr, vi, eps, sweeps)
    w = torch.diagonal(ar, dim1=-2, dim2=-1).clamp(min=0.0)[:, None, :]
    wrt, wit = wr.transpose(-1, -2), wi.transpose(-1, -2)
    return (mm(wr * w, wrt) + mm(wi * w, wit),
            mm(wi * w, wrt) - mm(wr * w, wit), wr, wi)


def _tp(xr, xi, dim):
    """X - kron(Tr_out(X) - I, I) / dim (the trace-preserving projection)."""
    b, n = xr.shape[0], dim * dim
    x5r = xr.reshape(b, dim, dim, dim, dim)
    x5i = xi.reshape(b, dim, dim, dim, dim)
    eye = torch.eye(dim, dtype=xr.dtype, device=xr.device)
    dr = (torch.diagonal(x5r, dim1=2, dim2=4).sum(-1) - eye) / dim
    di = torch.diagonal(x5i, dim1=2, dim2=4).sum(-1) / dim
    eye5 = eye.reshape(1, 1, dim, 1, dim)
    return ((x5r - dr[:, :, None, :, None] * eye5).reshape(b, n, n),
            (x5i - di[:, :, None, :, None] * eye5).reshape(b, n, n))


def _dykstra(zr, zi, vr, vi, iters, sweeps, dim, eps, mm, sweeps_rest=None):
    sweeps_rest = sweeps if sweeps_rest is None else sweeps_rest
    cp_r = cp_i = tp_r = tp_i = torch.zeros_like(zr)
    st_r, st_i = zr, zi
    for it in range(iters):
        pre_r, pre_i = st_r - cp_r, st_i - cp_i
        c_r, c_i, vr, vi = _cp(pre_r, pre_i, vr, vi,
                               sweeps if it == 0 else sweeps_rest, eps, mm)
        cp_r, cp_i = c_r - pre_r, c_i - pre_i
        pre_r, pre_i = c_r - tp_r, c_i - tp_i
        st_r, st_i = _tp(pre_r, pre_i, dim)
        tp_r, tp_i = st_r - pre_r, st_i - pre_i
    return st_r, st_i, vr, vi


def warm_start(a: torch.Tensor, n: torch.Tensor, dim: int, mm):
    """Hermitian, trace-``dim`` linear-inversion estimates unvec(pinv(A) n)
    as real and imaginary (B, d2, d2) planes."""
    d2 = dim * dim
    a_pinv = torch.linalg.pinv(a)                      # (d4, R)
    pr, pi = a_pinv.real.T.contiguous(), a_pinv.imag.T.contiguous()
    x_r, x_i = mm(n, pr), mm(n, pi)                    # (B, d4), vec order
    rr = x_r.reshape(-1, d2, d2).transpose(1, 2)       # unvec
    ri = x_i.reshape(-1, d2, d2).transpose(1, 2)
    rr, ri = (rr + rr.transpose(1, 2)) / 2, (ri - ri.transpose(1, 2)) / 2
    tr = torch.diagonal(rr, dim1=1, dim2=2).sum(-1)
    scale = (dim / torch.where(tr.abs() < 1e-12, 1.0, tr))[:, None, None]
    return (rr * scale).contiguous(), (ri * scale).contiguous()


def fused_apg(a: torch.Tensor, n: torch.Tensor, dim: int, *,
              phases: Sequence[Tuple[int, int, int]], init_iters: int,
              init_sweeps: int, final_iters: int, final_sweeps: int,
              mu: float, precision: str = "f64"):
    """(B, d2, d2) complex estimates of the fused APG solve.

    :param a: (R, d^4) complex A-matrix, column-stacking vec order.
    :param n: (B, R) normalized counts.
    """
    if precision == "f64":
        rdtype, mm, eps_rot = torch.float64, _mm_full, 1e-30
    elif precision == "tf32":
        rdtype, mm, eps_rot = torch.float32, _mm_tf32, 1e-18
    else:
        raise ValueError(f"unknown precision {precision!r}")
    cdtype = torch.complex128 if rdtype == torch.float64 else torch.complex64
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _solve(a.to(cdtype), n.to(rdtype), dim, phases, init_iters,
                      init_sweeps, final_iters, final_sweeps, mu, mm, eps_rot)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _solve(a, n, dim, phases, init_iters, init_sweeps, final_iters,
           final_sweeps, mu, mm, eps_rot):
    d2, b = dim * dim, n.shape[0]
    rho_r, rho_i = warm_start(a, n, dim, mm)
    rast = a.reshape(-1, d2, d2).transpose(1, 2).reshape(a.shape[0], d2 * d2)
    ar, ai = rast.real.contiguous(), rast.imag.contiguous()
    art, ait = ar.T.contiguous(), ai.T.contiguous()
    inv_mu = 1.0 / mu

    def prob(xr, xi):
        return (mm(xr.reshape(b, -1), art)
                - mm(xi.reshape(b, -1), ait)).clamp(min=1e-6)

    def cost(xr, xi):
        return -(n * torch.log(prob(xr, xi))).sum(-1)

    def grad(xr, xi):
        eta = n / prob(xr, xi)
        return -mm(eta, ar).reshape(b, d2, d2), mm(eta, ai).reshape(b, d2, d2)

    v_r = torch.eye(d2, dtype=ar.dtype, device=ar.device).expand(b, d2, d2)
    v_i = torch.zeros_like(v_r)
    est_r, est_i, v_r, v_i = _dykstra(rho_r, rho_i, v_r, v_i, init_iters,
                                      init_sweeps, dim, eps_rot, mm)
    prev_r, prev_i = est_r, est_i
    t = torch.ones(b, dtype=ar.dtype, device=ar.device)
    old = cost(est_r, est_i)
    for phase in phases:
        outer, ld, sweeps = phase[:3]
        rest = phase[3] if len(phase) == 4 else sweeps
        for _ in range(outer):
            t_next = (1 + torch.sqrt(1 + 4 * t * t)) / 2
            beta = ((t - 1) / t_next)[:, None, None]
            y_r = est_r + beta * (est_r - prev_r)
            y_i = est_i + beta * (est_i - prev_i)
            g_r, g_i = grad(y_r, y_i)
            c_r, c_i, v_r, v_i = _dykstra(y_r - inv_mu * g_r,
                                          y_i - inv_mu * g_i, v_r, v_i, ld,
                                          sweeps, dim, eps_rot, mm, rest)
            new = cost(c_r, c_i)
            t = torch.where(new > old, 1.0, t_next)
            prev_r, prev_i, est_r, est_i = est_r, est_i, c_r, c_i
            old = new
    est_r, est_i, _, _ = _dykstra(est_r, est_i, v_r, v_i, final_iters,
                                  final_sweeps, dim, eps_rot, mm)
    return torch.complex(est_r, est_i)


def rel_frobenius_gap(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B,) ||est - ref||_F / ||ref||_F per problem, in float64."""
    est, ref = est.to(torch.complex128), ref.to(torch.complex128)
    return (torch.linalg.vector_norm(est - ref, dim=(-2, -1))
            / torch.linalg.vector_norm(ref, dim=(-2, -1)))
