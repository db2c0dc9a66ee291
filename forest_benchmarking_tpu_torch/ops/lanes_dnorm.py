"""Fused diamond-norm solver on batch-first real/imaginary planes.

Port of ``forest_benchmarking_tpu/ops/lanes_dnorm.py``. It solves the
Watrous SDP

    dnorm(J) = 2 max_rho  sum of positive eigenvalues of
               (sqrt(rho) (x) I)^dag J (sqrt(rho) (x) I)

by Adam ascent over an unconstrained square-root factor A (rho = S S^dag,
S = A / ||A||_F), the outer problem of
:func:`forest_benchmarking_tpu_torch.distance_measures.diamond_norm_distance`,
on (B, n, n) planes (n = dim^2, 16 for 2Q channels):

- the eigendecomposition of M = (S (x) I)^dag J (S (x) I) that each step
  needs is one cyclic-Jacobi sweep from the previous step's eigenbasis
  (the fused APG solver's :func:`~.lanes_apg._multi_sweep`, in the JAX
  package's round order);
- the gradient is derived by hand: with P the projector onto M's positive
  eigenspace, df = tr(P dM) gives g = 2 (G_S - c S) / nu, nu = ||A||_F,
  G_S[u, v] = sum_a (J L V H V^dag)[(u, a), (v, a)], c = Re <S, G_S>
  (L = S (x) I, H = diag(1[w > 0]));
- a fixed schedule (``num_iters`` Adam steps of ``sweeps`` sweeps each)
  and one accurate final evaluation from the identity basis
  (``final_sweeps``), since the value's error is second order in rho's.

The JAX package writes the lift and the gradient's partial trace as loops
over a TPU lane layout; here they are the products they are
(``kron(S, I) @ V`` and a partial trace of ``X V^dag``), in full float32
(not TF32) on the card. The loop has no data-dependent control flow and
makes no host synchronization. Plain PyTorch: the JAX package runs this
solver under XLA, with no Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from forest_benchmarking_tpu_torch.ops.lanes_apg import (
    _cmm, _cmm_hconj_left, _hermitianize, _multi_sweep, full_f32_matmul)

__all__ = ["dnorm_fused", "dnorm_fused_sharded", "dnorm_planes",
           "dnorm_flops_per_problem"]

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _eye_planes(n: int, b: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Identity planes (b, n, n)."""
    return torch.eye(n, dtype=dtype, device=device).expand(b, n, n)


def _lift_apply(sr, si, vr, vi, dim: int):
    """W = (S (x) I) @ V on planes: W[(l, b), w] = sum_j S[l, j] V[(j, b), w].

    S planes are (B, dim, dim), V planes (B, n, n), n = dim^2: V's rows
    regrouped as (dim, dim * n) make this one complex product.
    """
    lead, n = vr.shape[:-2], vr.shape[-1]
    v_r = vr.reshape(*lead, dim, dim * n)
    v_i = vi.reshape(*lead, dim, dim * n)
    wr, wi = sr @ v_r - si @ v_i, sr @ v_i + si @ v_r
    return wr.reshape(*lead, n, n), wi.reshape(*lead, n, n)


def _grad_s(xr, xi, vr, vi, dim: int):
    """G_S[u, v] = sum_{a, w} X[(u, a), w] conj(V[(v, a), w]): the partial
    trace over the output factor of X V^dag, as one product of the rows
    regrouped as (dim, dim * n). X = (J L V) H comes pre-masked. Returns
    (B, dim, dim) planes."""
    lead, n = xr.shape[:-2], xr.shape[-1]
    x_r = xr.reshape(*lead, dim, dim * n)
    x_i = xi.reshape(*lead, dim, dim * n)
    v_rt = vr.reshape(*lead, dim, dim * n).transpose(-1, -2)
    v_it = vi.reshape(*lead, dim, dim * n).transpose(-1, -2)
    return x_r @ v_rt + x_i @ v_it, x_i @ v_rt - x_r @ v_it


def _abs_marginal(ar, vr, vi, dim: int, reg: float):
    """Input marginal of |J| from J's (approximately) diagonalized planes:
    marg[k, l] = sum_w |w_w| sum_a V[(k, a), w] conj(V[(l, a), w]), then
    Tikhonov-regularized by ``reg * tr(marg) / dim * I`` (the marginal can
    be near-singular for low-rank J). Returns (B, dim, dim) planes."""
    wabs = torch.diagonal(ar, dim1=-2, dim2=-1).abs()[..., None, :]
    mr, mi = _grad_s(vr * wabs, vi * wabs, vr, vi, dim)
    tr = torch.diagonal(mr, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(dim, dtype=mr.dtype, device=mr.device)
    return mr + (reg / dim) * tr * eye, mi


def _sqrtm_planes(mr, mi, dim: int, eps: float, sweeps: int):
    """sqrtm of Hermitian PSD (B, dim, dim) planes by a cold Jacobi eigh:
    W diag(sqrt(max(w, 0))) W^dag."""
    vr0 = _eye_planes(dim, mr.shape[0], mr.dtype, mr.device)
    ar, _, wr, wi = _multi_sweep(mr, mi, vr0, torch.zeros_like(vr0), eps,
                                 sweeps)
    ws = torch.sqrt(torch.diagonal(ar, dim1=-2, dim2=-1).clamp(min=0.0))
    xr, xi = wr * ws[..., None, :], wi * ws[..., None, :]
    wrt, wit = wr.transpose(-1, -2), wi.transpose(-1, -2)
    return xr @ wrt + xi @ wit, xi @ wrt - xr @ wit


def _norm(a_r, a_i):
    """||A||_F per problem, (B, 1, 1), floored: J = 0 (identical channels)
    gives A = 0, and S = 0 is then the right (zero-value) iterate, not
    0/0."""
    nu2 = (a_r * a_r + a_i * a_i).sum((-2, -1), keepdim=True)
    return torch.sqrt(nu2.clamp(min=1e-30))


def _m_planes(sr, si, vr, vi, jr, ji, dim: int):
    """M' = (L V)^dag J (L V), hermitianized."""
    w_r, w_i = _lift_apply(sr, si, vr, vi, dim)
    jw_r, jw_i = _cmm(jr, ji, w_r, w_i)
    return _hermitianize(*_cmm_hconj_left(w_r, w_i, jw_r, jw_i))


def _gradient(a_r, a_i, jr, ji, vr, vi, dim: int, eps: float, sweeps: int):
    """One step's gradient: refresh the eigenbasis of M' by ``sweeps``
    sweeps from (vr, vi), then g = 2 (G_S - c S) / nu with c = Re <S, G_S>,
    factored through the floored S = A / nu (the form 2 c A / nu^3
    underflows nu^3 to 0 in f32 at A = 0 and gives 0/0). Returns
    (g_r, g_i, vr', vi')."""
    nu = _norm(a_r, a_i)
    sr, si = a_r / nu, a_i / nu
    mp_r, mp_i = _m_planes(sr, si, vr, vi, jr, ji, dim)
    ar_, _, vr, vi = _multi_sweep(mp_r, mp_i, vr, vi, eps, sweeps)
    # X = (J L V') H, H the mask of M's positive eigenvalues
    w2_r, w2_i = _lift_apply(sr, si, vr, vi, dim)
    x_r, x_i = _cmm(jr, ji, w2_r, w2_i)
    h = (torch.diagonal(ar_, dim1=-2, dim2=-1) > 0).to(x_r.dtype)
    gs_r, gs_i = _grad_s(x_r * h[..., None, :], x_i * h[..., None, :],
                         vr, vi, dim)
    c = (sr * gs_r + si * gs_i).sum((-2, -1), keepdim=True)
    return 2 * (gs_r - c * sr) / nu, 2 * (gs_i - c * si) / nu, vr, vi


def dnorm_planes(jr: torch.Tensor, ji: torch.Tensor, *, dim: int,
                 num_iters: int = 96, sweeps: int = 1, init_sweeps: int = 5,
                 final_sweeps: int = 8, lr0: float = 0.1,
                 decay_iters: float = 50.0, reg: float = 0.05,
                 eps: float = 1e-30) -> torch.Tensor:
    """Diamond norm of Hermitian (B, n, n) Choi-difference planes.

    :param jr, ji: real/imaginary planes of J = hermitianize(choi0 - choi1),
        n = dim^2.
    :param num_iters: the fixed Adam schedule's length.
    :param sweeps: Jacobi sweeps per Adam step from the carried basis.
    :param init_sweeps: cold sweeps of the one-time eigh of J (warm start
        and first eigenbasis).
    :param final_sweeps: sweeps of the accurate final evaluation.
    :return: (B,) diamond-norm values (2x the SDP optimum).
    """
    n, b = dim * dim, jr.shape[0]
    with full_f32_matmul():
        # one cold eigh of J: the warm-start factor and the first basis
        vr0 = _eye_planes(n, b, jr.dtype, jr.device)
        vi0 = torch.zeros_like(vr0)
        jar, _, vr, vi = _multi_sweep(jr, ji, vr0, vi0, eps, init_sweeps)
        a_r, a_i = _sqrtm_planes(*_abs_marginal(jar, vr, vi, dim, reg), dim,
                                 eps, sweeps=3)
        m_r, m_i = torch.zeros_like(a_r), torch.zeros_like(a_i)
        v2_r, v2_i = torch.zeros_like(a_r), torch.zeros_like(a_i)
        for i in range(num_iters):
            g_r, g_i, vr, vi = _gradient(a_r, a_i, jr, ji, vr, vi, dim, eps,
                                         sweeps)
            # Adam ascent with the dense route's decay schedule
            it = i + 1
            m_r = _B1 * m_r + (1 - _B1) * g_r
            m_i = _B1 * m_i + (1 - _B1) * g_i
            v2_r = _B2 * v2_r + (1 - _B2) * g_r * g_r
            v2_i = _B2 * v2_i + (1 - _B2) * g_i * g_i
            bc1, bc2 = 1 - _B1 ** it, 1 - _B2 ** it
            lr = lr0 * 0.5 ** ((it - 1) / decay_iters)
            a_r = a_r + lr * (m_r / bc1) / (torch.sqrt(v2_r / bc2) + _ADAM_EPS)
            a_i = a_i + lr * (m_i / bc1) / (torch.sqrt(v2_i / bc2) + _ADAM_EPS)

        # the final evaluation, cold from the identity basis: the carried V
        # loses unitarity in f32 over ~100 one-sweep refreshes, and M' in a
        # non-unitary basis has a biased spectrum
        nu = _norm(a_r, a_i)
        mp_r, mp_i = _m_planes(a_r / nu, a_i / nu, vr0, vi0, jr, ji, dim)
        ar_, _, _, _ = _multi_sweep(mp_r, mp_i, vr0, vi0, eps, final_sweeps)
    return 2 * torch.diagonal(ar_, dim1=-2, dim2=-1).clamp(min=0.0).sum(-1)


def dnorm_fused(choi0: torch.Tensor, choi1: torch.Tensor, *,
                dim: int = None, num_iters: int = 96, sweeps: int = 1,
                init_sweeps: int = 5, final_sweeps: int = 8) -> torch.Tensor:
    """Batched diamond-norm distance between Choi matrices (dense complex
    in, planes solver inside). Takes (..., n, n) with any leading batch
    shape, none included, and returns the matching batch-shaped real
    tensor, computed where the inputs lie."""
    j = choi0 - choi1
    j = (j + j.transpose(-1, -2).conj()) / 2
    n = j.shape[-1]
    if dim is None:
        dim = math.isqrt(n)
    batch = j.shape[:-2]
    jp = j.reshape(-1, n, n)
    vals = dnorm_planes(jp.real.contiguous(), jp.imag.contiguous(), dim=dim,
                        num_iters=num_iters, sweeps=sweeps,
                        init_sweeps=init_sweeps, final_sweeps=final_sweeps)
    return vals.reshape(batch)


def dnorm_fused_sharded(choi0: torch.Tensor, choi1: torch.Tensor, mesh,
                        axis_name: str = "batch", **kw) -> torch.Tensor:
    """Run :func:`dnorm_fused` with the channel-pair batch sharded across a
    device mesh (the idiom of ``lanes_apg.apg_fused_sharded``: the solve is
    elementwise in the batch, so each device runs the whole planes solver
    on its shard, and the values are concatenated on the mesh's first
    device).

    :param choi0, choi1: (B, n, n) Choi batches; B must divide evenly by the
        mesh size.
    :param mesh: a :class:`~..parallel.Mesh` with ``axis_name`` as its
        batch axis, e.g. from ``parallel.make_mesh()``.
    :param kw: forwarded to :func:`dnorm_fused` (e.g. ``dim``,
        ``num_iters``).
    """
    from forest_benchmarking_tpu_torch.parallel import shard_map_batched

    if choi0.shape[0] % mesh.shape[axis_name] != 0:
        raise ValueError(
            f"batch {choi0.shape[0]} must be divisible by the mesh axis "
            f"{axis_name!r} size {mesh.shape[axis_name]}")
    mapped = shard_map_batched(lambda c0, c1: dnorm_fused(c0, c1, **kw),
                               mesh, batched_argnums=(0, 1),
                               axis_name=axis_name)
    return mapped(choi0, choi1)


def dnorm_flops_per_problem(dim: int, num_iters: int = 96, sweeps: int = 1,
                            init_sweeps: int = 5,
                            final_sweeps: int = 8) -> float:
    """Floating-point operations of one problem of :func:`dnorm_planes`
    (n = dim^2; a complex multiply-add is 8, a product of complex
    (p, q) and (q, r) matrices 8 p q r):

    - a Jacobi sweep of n x n planes: n - 1 rounds rotating M's columns
      and rows and V's columns, ~36 n^2 a round (as
      :func:`~.lanes_apg.apg_fused_flops_per_solve` counts it);
    - the lift (S (x) I) V and the partial trace G_S: 8 dim^3 n each;
      J W and W^dag (J W): 8 n^3 each; hermitianizing 4 n^2, the mask
      2 n^2; the factor's norm, c, g and Adam ~40 dim^2;
    - a step: two lifts, two J W, one W^dag (J W), the sweeps, G_S;
    - once: the cold eigh of J (``init_sweeps``), the marginal (8 dim^3 n
      + 2 n), its 3-sweep square root (36 dim^2 (dim - 1) a sweep, 8 dim^3
      + 2 dim^2 for the product); the final M' (lift, J W, W^dag (J W),
      hermitianizing) and its ``final_sweeps`` sweeps, n for the sum.
    """
    n = dim * dim

    def sweep(size):
        return 36.0 * size * size * (size - 1)

    lift = 8.0 * dim ** 3 * n
    step = (2 * lift + 3 * 8.0 * n ** 3 + 4 * n * n + sweeps * sweep(n)
            + 2 * n * n + lift + 40 * dim * dim)
    once = (init_sweeps * sweep(n) + lift + 2 * n + 3 * sweep(dim)
            + 8.0 * dim ** 3 + 2 * dim * dim)
    final = lift + 2 * 8.0 * n ** 3 + 4 * n * n + final_sweeps * sweep(n) + n
    return num_iters * step + once + final
