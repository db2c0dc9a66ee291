"""Port ops (calculational, vec/unvec, random operators) against the JAX
package on the same numpy inputs, in float64."""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu.ops import (
    choi_is_completely_positive, choi_is_trace_preserving)
from forest_benchmarking_tpu.ops import calculational as jcalc
from forest_benchmarking_tpu.ops import superoperator_transformations as jsup
from forest_benchmarking_tpu_torch.ops import calculational as tcalc
from forest_benchmarking_tpu_torch.ops import superoperator_transformations as tsup
from forest_benchmarking_tpu.ops import random_operators as jrand
from forest_benchmarking_tpu_torch.ops.random_operators import (
    bcsz_choi_from_ginibre, bures_measure_state_matrix,
    ginibre_matrix_complex, ginibre_state_matrix, haar_rand_state,
    haar_rand_unitary, permute_tensor_factors, rand_map_with_BCSZ_dist)

torch.set_num_threads(1)

# Same operations on the same f64 inputs; only summation order may differ.
ATOL = 1e-13


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_dag_matches_jax():
    x = _crandn(np.random.default_rng(0), 3, 4, 5)
    np.testing.assert_allclose(tcalc.dag(torch.tensor(x)).resolve_conj().numpy(),
                               np.asarray(jcalc.dag(jnp.asarray(x))), atol=ATOL)


def test_kron_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _crandn(rng, 3, 2, 3), _crandn(rng, 3, 4, 2)
    np.testing.assert_allclose(
        tcalc.kron(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jcalc.kron(jnp.asarray(a), jnp.asarray(b))), atol=ATOL)


@pytest.mark.parametrize("keep, dims", [([0], [2, 2]), ([1], [2, 2]),
                                        ([0], [4, 4]), ([1], [2, 3]),
                                        ([0, 2], [2, 3, 2])])
def test_partial_trace_matches_jax(keep, dims):
    d = int(np.prod(dims))
    x = _crandn(np.random.default_rng(2), 3, d, d)
    np.testing.assert_allclose(
        tcalc.partial_trace(torch.tensor(x), keep, dims).numpy(),
        np.asarray(jcalc.partial_trace(jnp.asarray(x), keep, dims)),
        atol=ATOL)


def test_vec_unvec_match_jax():
    x = _crandn(np.random.default_rng(3), 2, 4, 3)
    v = tsup.vec(torch.tensor(x)).numpy()
    np.testing.assert_allclose(v, np.asarray(jsup.vec(jnp.asarray(x))),
                               atol=ATOL)
    np.testing.assert_allclose(
        tsup.unvec(torch.tensor(v), shape=(4, 3)).numpy(),
        np.asarray(jsup.unvec(jnp.asarray(v), shape=(4, 3))), atol=ATOL)
    sq = _crandn(np.random.default_rng(4), 5, 16)
    np.testing.assert_allclose(tsup.unvec(torch.tensor(sq)).numpy(),
                               np.asarray(jsup.unvec(jnp.asarray(sq))),
                               atol=ATOL)


def test_bcsz_transform_matches_jax_formula():
    """One numpy Ginibre draw through the port's BCSZ normalization and
    through the same formula built from the JAX package's functions."""
    import jax
    dim, rank = 4, 16
    x = _crandn(np.random.default_rng(5), 3, dim * dim, rank)
    got = bcsz_choi_from_ginibre(torch.tensor(x), dim).numpy()

    hi = jax.lax.Precision.HIGHEST
    xj = jnp.asarray(x)
    rho = jnp.matmul(xj, jcalc.dag(xj), precision=hi)
    w, v = jnp.linalg.eigh(jcalc.partial_trace(rho, [0], [dim, dim]))
    inv_sqrt = jnp.matmul(v * (1.0 / jnp.sqrt(w))[..., None, :],
                          jcalc.dag(v), precision=hi)
    q = jcalc.kron(inv_sqrt, jnp.eye(dim, dtype=rho.dtype))
    want = np.asarray(jnp.matmul(jnp.matmul(q, rho, precision=hi), q,
                                 precision=hi))
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("dim, rank", [(2, 1), (2, 4), (4, 4)])
def test_bcsz_is_cptp(dim, rank):
    choi = rand_map_with_BCSZ_dist(torch.Generator().manual_seed(7), dim,
                                   rank).numpy()
    assert choi_is_completely_positive(choi, atol=1e-9)
    assert choi_is_trace_preserving(choi, atol=1e-9)


def test_ginibre_moments():
    g = ginibre_matrix_complex(torch.Generator().manual_seed(0), 64, 64,
                               batch=(16,)).numpy()
    assert g.shape == (16, 64, 64)
    assert abs(g.mean()) < 0.02
    assert abs(np.var(g.real) - 1.0) < 0.05
    assert abs(np.var(g.imag) - 1.0) < 0.05


def test_haar_unitary_is_jax_phase_fixed_qr():
    """The Gram-Schmidt Q equals the JAX package's QR with the phase fix on
    the same Ginibre draw (the generator is reseeded to replay it); the
    bar is round-off amplified by the draws' condition numbers."""
    u = haar_rand_unitary(torch.Generator().manual_seed(3), 4, batch=(256,))
    z = ginibre_matrix_complex(torch.Generator().manual_seed(3), 4, 4, (256,))
    q, r = jnp.linalg.qr(jnp.asarray(z.numpy()))
    diag = jnp.diagonal(r, axis1=-2, axis2=-1)
    want = np.asarray(q * (diag / jnp.abs(diag))[..., None, :])
    np.testing.assert_allclose(u.numpy(), want, atol=1e-11)
    eye = np.eye(4)
    np.testing.assert_allclose((u.mH @ u).numpy(), np.broadcast_to(
        eye, (256, 4, 4)), atol=1e-14)


def test_haar_unitary_moments_f32():
    """Haar moments on U(4): E|u_ij|^2 = 1/4, E|u_ij|^4 = 2/(4*5); unitary
    to f32 round-off."""
    u = haar_rand_unitary(torch.Generator().manual_seed(4), 4, batch=(20000,),
                          dtype=torch.float32)
    assert u.dtype == torch.complex64
    a2 = (u.abs() ** 2).double()
    assert abs(a2.mean().item() - 0.25) < 2e-3
    assert abs((a2 ** 2).mean().item() - 0.1) < 2e-3
    err = (u.mH @ u - torch.eye(4, dtype=u.dtype)).abs().max().item()
    assert err < 2e-6


@pytest.mark.parametrize("rank", [1, 2])
def test_outer_inner_sqrtm_match_jax(rank):
    """The products, and the PSD square root with its relative floor on a
    rank-deficient input, on the same f64 inputs as JAX."""
    rng = np.random.default_rng(6 + rank)
    v1, v2 = _crandn(rng, 3, 4, 1), _crandn(rng, 3, 4, 1)
    for name in ("outer_product", "inner_product"):
        np.testing.assert_allclose(
            getattr(tcalc, name)(torch.tensor(v1), torch.tensor(v2)).numpy(),
            np.asarray(getattr(jcalc, name)(jnp.asarray(v1),
                                            jnp.asarray(v2))), atol=ATOL)
    x = _crandn(rng, 3, 4, rank)
    m = x @ np.conj(np.swapaxes(x, -1, -2))
    got = tcalc.sqrtm_psd(torch.tensor(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcalc.sqrtm_psd(jnp.asarray(m))),
                               atol=1e-12)
    np.testing.assert_allclose(got @ got, m, atol=1e-10)


def test_sqrtm_psd_floor_keeps_f32_pure_state_fidelity():
    """Without the floor the f32 square root of a pure state carries
    ~sqrt(eps) of eigh noise; with it, sqrtm(|psi><psi|) = |psi><psi|."""
    psi = haar_rand_state(torch.Generator().manual_seed(8), 4, batch=(64,),
                          dtype=torch.float32)
    rho = psi @ psi.mH
    err = (tcalc.sqrtm_psd(rho) - rho).abs().amax().item()
    assert err < 1e-5


def test_haar_state_normalized():
    psi = haar_rand_state(torch.Generator().manual_seed(4), 8, batch=(100,))
    assert psi.shape == (100, 8, 1)
    norms = (psi.abs() ** 2).sum((1, 2)).numpy()
    np.testing.assert_allclose(norms, 1.0, atol=1e-12)


def test_haar_state_first_moment():
    """E |psi><psi| = I/d for Haar-random states."""
    psi = haar_rand_state(torch.Generator().manual_seed(2), 2,
                          batch=(20000,))
    avg = (psi @ psi.mH).mean(0).numpy()
    assert np.abs(avg - np.eye(2) / 2).max() < 0.02


@pytest.mark.parametrize("rank", [1, 2])
def test_ginibre_state_matrix_valid(rank):
    rho = ginibre_state_matrix(torch.Generator().manual_seed(5), 2, rank,
                               batch=(50,)).numpy()
    np.testing.assert_allclose(np.trace(rho, axis1=1, axis2=2), 1.0,
                               atol=1e-12)
    evals = np.linalg.eigvalsh(rho)
    assert evals.min() > -1e-12
    if rank == 1:
        np.testing.assert_allclose(np.sort(evals, axis=1)[:, :-1], 0.0,
                                   atol=1e-10)


def test_ginibre_state_matrix_hilbert_schmidt_moment():
    """Hilbert-Schmidt states on C^2: E tr(rho^2) = 2d / (d^2 + 1) = 0.8,
    the JAX sampler's mean on its own draws within the same bar."""
    rho = ginibre_state_matrix(torch.Generator().manual_seed(9), 2, 2,
                               batch=(20000,))
    want = np.asarray(jrand.ginibre_state_matrix(
        jax.random.PRNGKey(9), 2, 2, batch=(20000,)))
    pur = (rho @ rho).diagonal(dim1=-2, dim2=-1).sum(-1).real.mean().item()
    pur_jax = np.trace(want @ want, axis1=1, axis2=2).real.mean()
    assert abs(pur - 0.8) < 0.005 and abs(pur_jax - 0.8) < 0.005


def test_ginibre_rank_exceeds_dim_raises():
    with pytest.raises(ValueError):
        ginibre_state_matrix(torch.Generator().manual_seed(0), 2, 3)


def test_bures_state_valid_and_moment():
    """Valid density matrices; the mean purity of the Bures measure is
    E tr rho^2 = (5 d^2 + 1) / (2 d (d^2 + 2)), 7 / 8 on C^2."""
    rho = bures_measure_state_matrix(torch.Generator().manual_seed(6), 2,
                                     batch=(20000,))
    r = rho.numpy()
    np.testing.assert_allclose(np.trace(r, axis1=1, axis2=2), 1.0,
                               atol=1e-12)
    assert np.linalg.eigvalsh(r).min() > -1e-12
    pur = np.trace(r @ r, axis1=1, axis2=2).real.mean()
    assert abs(pur - 0.875) < 0.005


@pytest.mark.parametrize("dims, perm", [(2, [1, 0]), (2, [2, 0, 1]),
                                        ([2, 4], [1, 0]),
                                        ([2, 3, 2], [1, 2, 0])])
def test_permute_tensor_factors_matches_jax(dims, perm):
    got = permute_tensor_factors(dims, perm)
    np.testing.assert_array_equal(got, jrand.permute_tensor_factors(dims,
                                                                    perm))
    sizes = [dims] * len(perm) if isinstance(dims, int) else dims
    rng = np.random.default_rng(0)
    vs = [rng.standard_normal(k) for k in sizes]
    lhs = functools.reduce(np.kron, vs)
    rhs = functools.reduce(np.kron, [vs[p] for p in perm])
    np.testing.assert_allclose(got @ lhs, rhs, atol=1e-14)
    with pytest.raises(ValueError):
        permute_tensor_factors([2, 2], [0, 1, 2])
