"""The port's fused diamond-norm solver (``ops/lanes_dnorm.py``) against the
JAX package and against the port's own dense solver, in float64.

The JAX fused solver unrolls its planes code in n = dim^2 and takes minutes
to compile at dim = 4 on the CPU, so at dim = 4 its four building blocks
are held one by one (called eagerly on the same planes, moved to the JAX
package's (n, n, B) layout) and the port's whole solve is held against the
port's converged dense gold, the bar of the JAX suite's own 2Q test.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu.ops import lanes_apg as jax_apg
from forest_benchmarking_tpu.ops import lanes_dnorm as jax_dnorm
from forest_benchmarking_tpu.ops.random_operators import (
    rand_map_with_BCSZ_dist as jax_bcsz)
from forest_benchmarking_tpu_torch import distance_measures as tdm
from forest_benchmarking_tpu_torch.ops import lanes_apg, lanes_dnorm
from forest_benchmarking_tpu_torch.ops.random_operators import (
    rand_map_with_BCSZ_dist)
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    kraus2choi)

torch.set_num_threads(1)

BAR = 1e-9          # the dim = 2 solve against JAX's
BLOCK_BAR = 1e-10   # the building blocks, and the gradient against autograd
GOLD_BAR = 1e-6     # the dim = 4 solve against the converged dense gold
EPS = 1e-30


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _planes(x):
    """(real, imag) torch planes of a complex numpy array."""
    return torch.tensor(x.real.copy()), torch.tensor(x.imag.copy())


def _lanes(t):
    """A (B, r, c) torch plane as a JAX (r, c, B) plane."""
    return jnp.asarray(np.moveaxis(t.numpy(), 0, -1))


def _unlanes(x):
    return np.moveaxis(np.asarray(x), -1, 0)


def test_dnorm_fused_matches_jax_1q():
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    c0 = np.asarray(jax_bcsz(k1, 2, 4, batch=(6,)))
    c1 = np.asarray(jax_bcsz(k2, 2, 4, batch=(6,)))
    want = np.asarray(jax_dnorm.dnorm_fused(jnp.asarray(c0), jnp.asarray(c1)))
    got = lanes_dnorm.dnorm_fused(torch.tensor(c0), torch.tensor(c1))
    assert got.shape == (6,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=BAR)
    # the public entry point's fused route is the same solve
    np.testing.assert_array_equal(
        tdm.diamond_norm_distance(torch.tensor(c0), torch.tensor(c1),
                                  method="fused").numpy(), got.numpy())


@pytest.fixture(scope="module")
def planes_2q():
    """Random planes at dim = 4 (B = 3): S, V, a Hermitian PSD marginal."""
    rng = np.random.default_rng(7)
    dim, n, b = 4, 16, 3
    m = _crandn(rng, b, dim, dim)
    return {"s": _planes(_crandn(rng, b, dim, dim)),
            "v": _planes(_crandn(rng, b, n, n)),
            "x": _planes(_crandn(rng, b, n, n)),
            "a": _planes(_crandn(rng, b, n, n)),
            "psd": _planes(m @ np.conj(np.swapaxes(m, -1, -2)))}


def test_lift_apply_matches_jax(planes_2q):
    sr, si = planes_2q["s"]
    vr, vi = planes_2q["v"]
    want = jax_dnorm._lift_apply(*map(_lanes, (sr, si, vr, vi)), 4)
    got = lanes_dnorm._lift_apply(sr, si, vr, vi, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), atol=BLOCK_BAR)


def test_grad_s_matches_jax(planes_2q):
    xr, xi = planes_2q["x"]
    vr, vi = planes_2q["v"]
    want = jax_dnorm._grad_s(*map(_lanes, (xr, xi, vr, vi)), 4)
    got = lanes_dnorm._grad_s(xr, xi, vr, vi, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), atol=BLOCK_BAR)


def test_abs_marginal_matches_jax(planes_2q):
    ar, _ = planes_2q["a"]
    vr, vi = planes_2q["v"]
    want = jax_dnorm._abs_marginal(*map(_lanes, (ar, vr, vi)), 4, 0.05)
    got = lanes_dnorm._abs_marginal(ar, vr, vi, 4, 0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), atol=BLOCK_BAR)


def test_sqrtm_planes_matches_jax(planes_2q):
    mr, mi = planes_2q["psd"]
    want = jax_dnorm._sqrtm_planes(_lanes(mr), _lanes(mi), 4, EPS, 3)
    got = lanes_dnorm._sqrtm_planes(mr, mi, 4, EPS, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), atol=BLOCK_BAR)
    eye = jax_apg._eye_planes(16, (3,), jnp.float64)
    np.testing.assert_array_equal(
        lanes_dnorm._eye_planes(16, 3, torch.float64, torch.device("cpu"))
        .numpy(), _unlanes(eye))


def test_dnorm_fused_matches_dense_gold_2q():
    """2Q BCSZ pairs: the fused f64 solve within 1e-6 of an 800-step,
    two-restart dense gold (the JAX suite's 2Q bar)."""
    g = torch.Generator().manual_seed(0)
    c0 = rand_map_with_BCSZ_dist(g, 4, 6, batch=(4,))
    c1 = rand_map_with_BCSZ_dist(g, 4, 6, batch=(4,))
    gold = tdm.diamond_norm_distance(c0, c1, method="dense", num_iters=800,
                                     num_restarts=2, stop_tol=0.0)
    fused = lanes_dnorm.dnorm_fused(c0, c1)
    assert (fused - gold).abs().max().item() < GOLD_BAR


def _choi_depol(p, d=2):
    """Choi matrix of the depolarizing channel (H_in (x) H_out)."""
    omega = np.zeros((d * d, d * d), complex)
    for i in range(d):
        for j in range(d):
            omega[i * d + i, j * d + j] = 1.0
    return torch.tensor((1 - p) * omega + p * np.eye(d * d) / d)


def test_dnorm_fused_analytic_cases():
    """Depolarizing against the identity is 3p/2; I against X is 2; a
    channel against itself is 0, not NaN (the ||A|| floor), at dim 2 and
    4."""
    ps = (0.1, 0.3, 0.7)
    c_id = _choi_depol(0.0).expand(len(ps), 4, 4)
    got = lanes_dnorm.dnorm_fused(torch.stack([_choi_depol(p) for p in ps]),
                                  c_id, dim=2)
    np.testing.assert_allclose(got.numpy(), [1.5 * p for p in ps], atol=1e-5)
    eye = kraus2choi(torch.eye(2, dtype=torch.complex128)[None])
    x = kraus2choi(torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128)[None])
    assert abs(lanes_dnorm.dnorm_fused(eye, x).item() - 2.0) < 1e-6
    for dim in (2, 4):
        c = rand_map_with_BCSZ_dist(torch.Generator().manual_seed(2), dim, 4,
                                    batch=(3,))
        v = lanes_dnorm.dnorm_fused(c, c)
        assert torch.isfinite(v).all() and v.abs().max().item() < 1e-10


@pytest.mark.parametrize("dim", [2, 4])
def test_hand_gradient_matches_autograd(dim):
    """One fused step's gradient, in a converged eigenbasis, equals
    torch.autograd of the dense objective at the same factor."""
    n = dim * dim
    rng = np.random.default_rng(3 + dim)
    jm = _crandn(rng, 2, n, n)
    jm = (jm + np.conj(np.swapaxes(jm, -1, -2))) / 2
    a = _crandn(rng, 2, dim, dim)
    jr, ji = _planes(jm)
    a_r, a_i = _planes(a)

    x = torch.stack([a_r, a_i]).requires_grad_(True)
    f = tdm._dnorm_objective(torch.complex(x[0], x[1]), torch.tensor(jm))
    g_auto, = torch.autograd.grad(f.sum(), x)

    # a converged eigenbasis of M' at this factor: 12 cold sweeps
    nu = lanes_dnorm._norm(a_r, a_i)
    eye = lanes_dnorm._eye_planes(n, 2, torch.float64, torch.device("cpu"))
    mp_r, mp_i = lanes_dnorm._m_planes(a_r / nu, a_i / nu, eye,
                                       torch.zeros_like(eye), jr, ji, dim)
    _, _, vr, vi = lanes_apg._multi_sweep(mp_r, mp_i, eye,
                                          torch.zeros_like(eye), EPS, 12)
    g_r, g_i, _, _ = lanes_dnorm._gradient(a_r, a_i, jr, ji, vr, vi, dim,
                                           EPS, 1)
    np.testing.assert_allclose(g_r.numpy(), g_auto[0].numpy(),
                               atol=BLOCK_BAR)
    np.testing.assert_allclose(g_i.numpy(), g_auto[1].numpy(),
                               atol=BLOCK_BAR)


def test_dnorm_flops_count():
    """The count the bound uses: one Jacobi sweep of a 16 x 16 problem is
    36 n^2 (n - 1) = 138240, and a default solve ~27 MFLOP."""
    one_step = (lanes_dnorm.dnorm_flops_per_problem(4, num_iters=1)
                - lanes_dnorm.dnorm_flops_per_problem(4, num_iters=0))
    assert (lanes_dnorm.dnorm_flops_per_problem(4, num_iters=1, sweeps=2)
            - lanes_dnorm.dnorm_flops_per_problem(4, num_iters=1)) == 138240
    assert 2.0e5 < one_step < 3.0e5
    assert 2.5e7 < lanes_dnorm.dnorm_flops_per_problem(4) < 3.0e7
