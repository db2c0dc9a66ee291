"""The port's distance measures and its dense diamond-norm route against
the JAX package on the same numpy inputs, in float64."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import forest_benchmarking_tpu.distance_measures as jdm
from forest_benchmarking_tpu.ops import superoperator_transformations as jsup
from forest_benchmarking_tpu.utils import I_MAT, X_MAT, Y_MAT, Z_MAT
from forest_benchmarking_tpu_torch import distance_measures as tdm
from forest_benchmarking_tpu_torch.ops import lanes_dnorm
from forest_benchmarking_tpu_torch.ops import superoperator_transformations as tsup
from forest_benchmarking_tpu_torch.ops.calculational import hermitianize

torch.set_num_threads(1)

BAR = 1e-10          # measures: eigh-based, the same operations
DNORM_BAR = 1e-9     # the dense diamond norm with equal step counts
RESTART_BAR = 1e-6   # restarts drawn from different generators
DIMS = (2, 4)
B = 5


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _states(seed, dim, rank):
    """(B, dim, dim) density matrices of the given rank (1: pure, the
    rank-deficient case the sqrtm_psd floor exists for)."""
    x = _crandn(np.random.default_rng(seed), B, dim, rank)
    rho = x @ np.conj(np.swapaxes(x, -1, -2))
    return rho / np.trace(rho, axis1=-2, axis2=-1)[..., None, None]


def _bcsz_np(seed, dim, rank, batch):
    """Numpy BCSZ Choi matrices: the JAX package's sampler."""
    from forest_benchmarking_tpu.ops.random_operators import (
        rand_map_with_BCSZ_dist)
    return np.asarray(rand_map_with_BCSZ_dist(jax.random.PRNGKey(seed), dim,
                                              rank, batch=(batch,)))


STATE_MEASURES = {
    "purity": lambda m, r, s: m.purity(r),
    "purity_renorm": lambda m, r, s: m.purity(r, dim_renorm=True),
    "impurity": lambda m, r, s: m.impurity(r),
    "impurity_renorm": lambda m, r, s: m.impurity(r, dim_renorm=True),
    "fidelity": lambda m, r, s: m.fidelity(r, s),
    "infidelity": lambda m, r, s: m.infidelity(r, s),
    "trace_distance": lambda m, r, s: m.trace_distance(r, s),
    "bures_distance": lambda m, r, s: m.bures_distance(r, s),
    "bures_angle": lambda m, r, s: m.bures_angle(r, s),
    "hilbert_schmidt_ip": lambda m, r, s: m.hilbert_schmidt_ip(r, s),
    "smith_fidelity": lambda m, r, s: m.smith_fidelity(r, s, 1.3),
    "quantum_chernoff_bound": lambda m, r, s: m.quantum_chernoff_bound(r, s),
}
PROCESS_MEASURES = ("entanglement_fidelity", "process_fidelity",
                    "process_infidelity")
KINDS = {"mixed": (None, None), "pure": (1, 1), "pure_mixed": (1, None)}


def _pair(kind, dim):
    r0, r1 = KINDS[kind]
    return (_states(dim, dim, r0 or dim), _states(dim + 7, dim, r1 or dim))


# The Chernoff bound raises each eigenvalue to the power s: a state's zero
# eigenvalues come out of eigh as noise of either sign (~1e-17, or the
# floor `tiny` where negative), and noise^s moves the minimum by up to 1e-2
# in either package, so it is held on full-rank states only (ROADMAP queue
# 3).
STATE_CASES = [(name, kind, dim) for name in sorted(STATE_MEASURES)
               for kind in sorted(KINDS) for dim in DIMS
               if name != "quantum_chernoff_bound" or kind == "mixed"]


@pytest.fixture(scope="module")
def jax_measures():
    want = {}
    for name, kind, dim in STATE_CASES:
        r, s = (jnp.asarray(x) for x in _pair(kind, dim))
        want[name, kind, dim] = np.asarray(STATE_MEASURES[name](jdm, r, s))
    for dim in DIMS:
        c0, c1 = _bcsz_np(dim, dim, dim, B), _bcsz_np(dim + 1, dim, 2, B)
        p0, p1 = (jsup.choi2pauli_liouville(jnp.asarray(c)) for c in (c0, c1))
        for name in PROCESS_MEASURES:
            want[name, dim] = np.asarray(getattr(jdm, name)(p0, p1))
        want["watrous", dim] = np.asarray(jdm.watrous_bounds(
            jnp.asarray(c0 - c1)))
    return want


@pytest.mark.parametrize("name, kind, dim", STATE_CASES)
def test_state_measure_matches_jax(jax_measures, name, kind, dim):
    r, s = (torch.tensor(x) for x in _pair(kind, dim))
    got = STATE_MEASURES[name](tdm, r, s)
    want = jax_measures[name, kind, dim]
    got = (np.stack([x.numpy() for x in got]) if isinstance(got, tuple)
           else got.numpy())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BAR)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("name", PROCESS_MEASURES + ("watrous",))
def test_process_measure_matches_jax(jax_measures, name, dim):
    c0, c1 = _bcsz_np(dim, dim, dim, B), _bcsz_np(dim + 1, dim, 2, B)
    if name == "watrous":
        got = np.stack([x.numpy() for x in tdm.watrous_bounds(
            torch.tensor(c0 - c1))])
    else:
        p0, p1 = (tsup.choi2pauli_liouville(torch.tensor(c)) for c in (c0, c1))
        got = getattr(tdm, name)(p0, p1).numpy()
    np.testing.assert_allclose(got, jax_measures[name, dim], atol=BAR)


def test_state_measures_on_known_states():
    zero = torch.tensor([[1, 0], [0, 0]], dtype=torch.complex128)
    one = torch.tensor([[0, 0], [0, 1]], dtype=torch.complex128)
    plus = torch.full((2, 2), 0.5, dtype=torch.complex128)
    assert abs(tdm.trace_distance(zero, one).item() - 1.0) < 1e-12
    assert abs(tdm.trace_distance(zero, plus).item() - 2 ** -0.5) < 1e-12
    assert abs(tdm.fidelity(zero, plus).item() - 0.5) < 1e-12
    assert abs(tdm.fidelity(zero, one).item()) < 1e-12
    rho = torch.tensor(np.diag([0.9, 0.1]).astype(complex))
    sigma = torch.tensor(np.diag([0.4, 0.6]).astype(complex))
    qcb, _ = tdm.quantum_chernoff_bound(rho, sigma)
    ss = np.linspace(0, 1, 100001)
    vals = 0.9 ** ss * 0.4 ** (1 - ss) + 0.1 ** ss * 0.6 ** (1 - ss)
    assert abs(qcb.item() - vals.min()) < 1e-6
    p, q = torch.tensor([0.5, 0.5]), torch.tensor([1.0, 0.0])
    assert tdm.total_variation_distance(p, q).item() == 0.5
    assert tdm.total_variation_distance(p[:, None], q[:, None]).item() == 0.5
    with pytest.raises(ValueError):
        tdm.smith_fidelity(zero, plus, 2.5)
    with pytest.raises(ValueError):
        tdm.smith_fidelity(zero, plus, -0.5)


def test_total_variation_distance_matches_jax():
    rng = np.random.default_rng(11)
    p, q = rng.dirichlet(np.ones(8), size=B), rng.dirichlet(np.ones(8), size=B)
    np.testing.assert_allclose(
        tdm.total_variation_distance(torch.tensor(p), torch.tensor(q)).numpy(),
        np.asarray(jdm.total_variation_distance(jnp.asarray(p),
                                                jnp.asarray(q))), atol=BAR)


# ------------------------------------------------------------ diamond norm

class _CountingLax:
    """``jax.lax`` whose ``while_loop`` also hands its final carry to
    ``out``: traced in place of the JAX module's ``lax``, it exposes the
    Adam step counter of ``diamond_norm_distance``'s loop."""

    def __init__(self, out):
        self.out = out

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def while_loop(self, cond, body, init):
        carry = jax.lax.while_loop(cond, body, init)
        self.out.append(carry)
        return carry


def _jax_dnorm_steps(monkeypatch, c0, c1, **kw):
    """(values, Adam steps) of the JAX dense route on these inputs."""
    carries = []
    monkeypatch.setattr(jdm, "lax", _CountingLax(carries))

    def run(a, b):
        vals = jdm.diamond_norm_distance.__wrapped__(a, b, method="dense",
                                                     **kw)
        return vals, carries[0][3]

    vals, steps = jax.jit(run)(jnp.asarray(c0), jnp.asarray(c1))
    monkeypatch.setattr(jdm, "lax", jax.lax)
    return np.asarray(vals), int(steps)


DNORM_PAIRS = {2: (6, 4), 4: (4, 16)}  # dim: (pairs, Kraus rank)


@pytest.fixture(scope="module")
def dnorm_inputs():
    return {dim: (_bcsz_np(20 + dim, dim, rank, b),
                  _bcsz_np(30 + dim, dim, rank, b))
            for dim, (b, rank) in DNORM_PAIRS.items()}


@pytest.mark.parametrize("dim", DIMS)
def test_dense_diamond_norm_matches_jax(monkeypatch, dnorm_inputs, dim):
    """Default knobs: the same values and the same number of Adam steps
    (the early exit reads the same batch-wide change)."""
    c0, c1 = dnorm_inputs[dim]
    want, want_steps = _jax_dnorm_steps(monkeypatch, c0, c1)
    np.testing.assert_allclose(
        want, np.asarray(jdm.diamond_norm_distance(jnp.asarray(c0),
                                                   jnp.asarray(c1))),
        atol=1e-14)
    j = hermitianize(torch.tensor(c0) - torch.tensor(c1))
    got, steps = tdm._dnorm_dense(j, 200, 1, 7, True, 3e-7, 24, 50.0)
    assert steps == want_steps and 24 < steps < 200
    np.testing.assert_allclose(got.numpy(), want, atol=DNORM_BAR)
    np.testing.assert_allclose(
        tdm.diamond_norm_distance(torch.tensor(c0), torch.tensor(c1)).numpy(),
        got.numpy(), atol=0)


def test_dense_diamond_norm_with_restarts_matches_jax_by_value(dnorm_inputs):
    """Three restarts: the random factors come from different generators,
    so the two packages agree on the converged value only."""
    c0, c1 = dnorm_inputs[2]
    kw = dict(method="dense", num_restarts=3)
    want = np.asarray(jdm.diamond_norm_distance(jnp.asarray(c0),
                                                jnp.asarray(c1), **kw))
    got = tdm.diamond_norm_distance(torch.tensor(c0), torch.tensor(c1), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=RESTART_BAR)


def test_dense_diamond_norm_fixed_schedule_and_cold_start(monkeypatch,
                                                          dnorm_inputs):
    """``stop_tol=0`` runs every step (JAX's fori_loop); ``warm_start=False``
    starts from the identity."""
    c0, c1 = (x[:2] for x in dnorm_inputs[2])
    j = hermitianize(torch.tensor(c0) - torch.tensor(c1))
    _, steps = tdm._dnorm_dense(j, 40, 1, 7, True, 0.0, 24, 50.0)
    assert steps == 40
    for kw in (dict(num_iters=40, stop_tol=0.0),
               dict(warm_start=False, num_iters=60)):
        want = np.asarray(jdm.diamond_norm_distance(
            jnp.asarray(c0), jnp.asarray(c1), method="dense", **kw))
        got = tdm.diamond_norm_distance(torch.tensor(c0), torch.tensor(c1),
                                        method="dense", **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=DNORM_BAR)


def test_auto_takes_the_dense_route_on_the_cpu(monkeypatch, dnorm_inputs):
    c0, c1 = (torch.tensor(x[:2]) for x in dnorm_inputs[2])

    def refuse(*args, **kwargs):
        raise AssertionError("the fused route ran on the CPU")

    monkeypatch.setattr(lanes_dnorm, "dnorm_planes", refuse)
    auto = tdm.diamond_norm_distance(c0, c1)
    np.testing.assert_array_equal(
        auto.numpy(), tdm.diamond_norm_distance(c0, c1, method="dense").numpy())
    with pytest.raises(AssertionError):
        tdm.diamond_norm_distance(c0, c1, method="fused")
    with pytest.raises(ValueError):
        tdm.diamond_norm_distance(c0, c1, method="sdp")


def _depolarizing_kraus(p):
    return [np.sqrt(1 - 3 * p / 4) * I_MAT] + \
           [np.sqrt(p / 4) * P for P in (X_MAT, Y_MAT, Z_MAT)]


def test_dense_diamond_norm_known_channels():
    """Depolarizing against the identity is 3p/2, I against X is 2, and a
    channel against itself is 0, not NaN (the ||A|| floor); batched as one
    call."""
    eye = tsup.kraus2choi(torch.tensor(I_MAT)[None])
    c0 = torch.stack([eye, eye, eye])
    c1 = torch.stack([tsup.kraus2choi([torch.tensor(k) for k in
                                       _depolarizing_kraus(0.3)]),
                      tsup.kraus2choi(torch.tensor(X_MAT)[None]), eye])
    got = tdm.diamond_norm_distance(c0, c1).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, [0.45, 2.0, 0.0], atol=5e-3)
    assert got[2] == 0.0
