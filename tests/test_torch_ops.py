"""Port ops (calculational, vec/unvec, random operators) against the JAX
package on the same numpy inputs, in float64."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu.ops import (
    choi_is_completely_positive, choi_is_trace_preserving)
from forest_benchmarking_tpu.ops import calculational as jcalc
from forest_benchmarking_tpu.ops import superoperator_transformations as jsup
from forest_benchmarking_tpu_torch.ops import calculational as tcalc
from forest_benchmarking_tpu_torch.ops import superoperator_transformations as tsup
from forest_benchmarking_tpu_torch.ops.random_operators import (
    bcsz_choi_from_ginibre, ginibre_matrix_complex, rand_map_with_BCSZ_dist)

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
