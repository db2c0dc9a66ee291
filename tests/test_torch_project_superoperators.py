"""The port's Choi-matrix projections against the JAX package's
``ops/project_superoperators.py`` on the same numpy inputs, in float64."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu.ops import calculational as jcalc
from forest_benchmarking_tpu.ops import project_superoperators as jproj
from forest_benchmarking_tpu_torch.ops import calculational as tcalc
from forest_benchmarking_tpu_torch.ops import project_superoperators as tproj
from oracles import np_proj_physical

torch.set_num_threads(1)

# Same operations on the same f64 inputs; eigh bases and summation orders
# differ, so the bar is f64 round-off.
ATOL = 1e-12


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _choi_like(seed, b, dim):
    """Non-physical, non-Hermitian (B, d^2, d^2) matrices near trace d."""
    x = _crandn(np.random.default_rng(seed), b, dim * dim, dim * dim)
    return x / np.trace(x, axis1=1, axis2=2).real[:, None, None] * dim


def test_hermitianize_matches_jax():
    x = _crandn(np.random.default_rng(0), 3, 4, 4)
    np.testing.assert_allclose(
        tcalc.hermitianize(torch.tensor(x)).numpy(),
        np.asarray(jcalc.hermitianize(jnp.asarray(x))), atol=1e-15)


@pytest.mark.parametrize("dim", [2, 4])
@pytest.mark.parametrize("name", [
    "proj_choi_to_completely_positive", "proj_choi_to_completely_positive_ns",
    "proj_choi_to_trace_non_increasing", "proj_choi_to_trace_preserving"])
def test_projection_matches_jax(name, dim):
    x = _choi_like(1 + dim, 5, dim)
    got = getattr(tproj, name)(torch.tensor(x)).numpy()
    want = np.asarray(getattr(jproj, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fro2_absdot_and_matrix_sign_match_jax():
    rng = np.random.default_rng(9)
    x, y = _crandn(rng, 3, 4, 4), _crandn(rng, 3, 4, 4)
    np.testing.assert_allclose(tproj._fro2(torch.tensor(x)).numpy(),
                               np.asarray(jproj._fro2(jnp.asarray(x))),
                               rtol=1e-14)
    np.testing.assert_allclose(
        tproj._absdot(torch.tensor(x), torch.tensor(y)).numpy(),
        np.asarray(jproj._absdot(jnp.asarray(x), jnp.asarray(y))), rtol=1e-14)
    h = np.asarray(jcalc.hermitianize(jnp.asarray(x)))
    np.testing.assert_allclose(
        tproj._matrix_sign_ns(torch.tensor(h), 12).numpy(),
        np.asarray(jproj._matrix_sign_ns(jnp.asarray(h), 12)), atol=ATOL)


def _mixed_batch(dim):
    """Problems that stop at different Dykstra iterations: a CPTP Choi
    matrix (the maximally depolarizing channel, done after one iteration),
    one near it, and two far from the physical set."""
    d2 = dim * dim
    x = _choi_like(20 + dim, 4, dim)
    x[0] = np.eye(d2) / dim
    x[1] = np.eye(d2) / dim + 0.05 * (x[1] + x[1].conj().T)
    return x


@pytest.mark.parametrize("make_tp", [True, False])
@pytest.mark.parametrize("cp_method", ["eigh", "ns"])
def test_proj_choi_to_physical_matches_jax(make_tp, cp_method):
    """Bar 1e-10 against JAX (per-problem Birgin-Raydan stop under vmap) on a
    batch whose problems stop at different iterations; each problem equals
    its own solve alone."""
    x = _mixed_batch(2)
    kw = dict(make_trace_preserving=make_tp, cp_method=cp_method)
    got = tproj.proj_choi_to_physical(torch.tensor(x), **kw).numpy()
    want = np.asarray(jproj.proj_choi_to_physical(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, want, atol=1e-10)
    for b in range(len(x)):
        alone = tproj.proj_choi_to_physical(torch.tensor(x[b:b + 1]), **kw)
        np.testing.assert_allclose(alone.numpy()[0], got[b], atol=1e-14)
    # problem 0 stops after its first iteration, problems 2 and 3 do not
    one = tproj.proj_choi_to_physical(torch.tensor(x), max_iters=1,
                                      **kw).numpy()
    np.testing.assert_allclose(one[0], got[0], atol=1e-15)
    assert all(np.abs(one[b] - got[b]).max() > 1e-6 for b in (2, 3))


def test_proj_choi_to_physical_2q_and_oracle():
    """dim=4 against JAX, and both against the numpy Dykstra oracle."""
    x = _mixed_batch(4)
    got = tproj.proj_choi_to_physical(torch.tensor(x)).numpy()
    want = np.asarray(jproj.proj_choi_to_physical(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-10)
    oracle = np.stack([np_proj_physical(x[b]) for b in range(len(x))])
    np.testing.assert_allclose(got, oracle, atol=1e-10)


def test_proj_choi_to_physical_keeps_batch_shape_and_rejects_unknown():
    x = _choi_like(30, 6, 2).reshape(2, 3, 4, 4)
    got = tproj.proj_choi_to_physical(torch.tensor(x))
    assert got.shape == (2, 3, 4, 4)
    flat = tproj.proj_choi_to_physical(torch.tensor(x.reshape(6, 4, 4)))
    np.testing.assert_array_equal(got.reshape(6, 4, 4).numpy(), flat.numpy())
    with pytest.raises(ValueError, match="cp_method"):
        tproj.proj_choi_to_physical(torch.tensor(x), cp_method="qr")
