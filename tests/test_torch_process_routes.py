"""The port's per-problem process-MLE routes of
``tomography.pgdb_process_estimate_batched`` (PGDB and APG, eigh and
Newton-Schulz CP steps) against the JAX package's on the same counts, in
float64, and PGDB against the numpy oracle."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu import tomography as jax_tomo
from forest_benchmarking_tpu.benchmarks import synth_process_datasets
from forest_benchmarking_tpu_torch import tomography
from forest_benchmarking_tpu_torch.benchmarks import process_tomo_A_matrix
from oracles import np_pgdb

torch.set_num_threads(1)

# f64 round-off grown through the solve; measured ~1e-15 at dim=2 and
# ~2e-14 at dim=4 with equal per-problem iteration counts.
BAR = 1e-10

ROUTES_1Q = {
    "pgdb-eigh": dict(),
    "pgdb-eigh-warm": dict(warm_start=True),
    "pgdb-eigh-tni": dict(trace_preserving=False),
    "apg-eigh": dict(method="apg", return_iters=True),
    "apg-ns": dict(method="apg", cp_method="ns", ns_iters=20,
                   return_iters=True),
    "apg-eigh-tni": dict(method="apg", trace_preserving=False,
                         return_iters=True),
    "apg-eigh-warm-loop1": dict(method="apg", warm_start=True,
                                loop_dyk_iters=1, return_iters=True),
    "apg-eigh-loop2-capped": dict(method="apg", loop_dyk_iters=2, maxiter=6,
                                  stop_tol=0.0, return_iters=True),
}


def _counts(dim, seed, batch, shots):
    a = process_tomo_A_matrix(dim.bit_length() - 1)
    n, _ = synth_process_datasets(jax.random.PRNGKey(seed), jnp.asarray(a),
                                  dim, batch, shots, dtype=jnp.float64)
    return a, np.asarray(n)


def _both(a, n, dim, kw):
    want = jax_tomo.pgdb_process_estimate_batched(jnp.asarray(a),
                                                  jnp.asarray(n), dim=dim,
                                                  **kw)
    got = tomography.pgdb_process_estimate_batched(torch.tensor(a),
                                                   torch.tensor(n), dim=dim,
                                                   **kw)
    if kw.get("return_iters"):
        (want, want_it), (got, got_it) = want, got
        assert got_it.tolist() == np.asarray(want_it).tolist()
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("route", sorted(ROUTES_1Q))
def test_1q_route_matches_jax(route):
    """B = 4 one-qubit problems at 2000 shots: the estimates within 1e-10
    and, where the route returns them, equal iteration counts."""
    a, n = _counts(2, 11, 4, 2000)
    got, want = _both(a, n, 2, ROUTES_1Q[route])
    assert got.shape == (4, 4, 4)
    assert np.abs(got - want).max() <= BAR


@pytest.mark.parametrize("trace_preserving", [True, False])
def test_pgdb_backtracking_matches_jax(trace_preserving):
    """100 shots per setting: PGDB's line search halves the step on some
    problems (counted here), and the estimates still agree within 1e-10."""
    a, n = _counts(2, 1, 4, 100)
    halved = []
    backtrack = tomography._backtrack

    def counting(*args):
        alpha, new_cost = backtrack(*args)
        halved.append(int((alpha < 1).sum()))
        return alpha, new_cost

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tomography, "_backtrack", counting)
        got, want = _both(a, n, 2, dict(trace_preserving=trace_preserving))
    assert sum(halved) > 0
    assert np.abs(got - want).max() <= BAR


@pytest.mark.parametrize("kw", [
    dict(method="apg", warm_start=True, loop_dyk_iters=1, return_iters=True),
    dict(method="apg", warm_start=True, loop_dyk_iters=1, stop_tol=1e-4,
         maxiter=25, dyk_iters=20, return_iters=True),
    dict(maxiter=4)], ids=["apg-warm-loop1", "apg-warm-production", "pgdb-4"])
def test_2q_route_matches_jax(kw):
    """dim=4 through the warm-start APG route (the JAX package's production
    configuration and its defaults) and a few PGDB steps (the converged dim=4
    PGDB solve is a slow test in the JAX suite)."""
    a, n = _counts(4, 12, 2, 2000)
    got, want = _both(a, n, 4, kw)
    assert np.abs(got - want).max() <= BAR


def test_pgdb_matches_numpy_oracle():
    """The JAX package's bar for PGDB against the independent numpy
    re-derivation: 1e-6 (tests/test_process_tomography.py)."""
    a, n = _counts(2, 13, 2, 1500)
    got = tomography.pgdb_process_estimate_batched(torch.tensor(a),
                                                   torch.tensor(n), dim=2)
    for b in range(2):
        assert np.abs(got[b].numpy() - np_pgdb(a, n[b], dim=2)).max() < 1e-6


def test_apg_reaches_the_pgdb_optimum():
    """APG and PGDB land on the same optimum within the JAX package's
    1e-3 (tests/test_process_tomography.py::test_host_api_apg_method)."""
    a = torch.tensor(process_tomo_A_matrix(1))
    n, _ = (torch.tensor(np.asarray(x)) for x in synth_process_datasets(
        jax.random.PRNGKey(14), jnp.asarray(a.numpy()), 2, 3, 4000,
        dtype=jnp.float64))
    pgdb = tomography.pgdb_process_estimate_batched(a, n, dim=2)
    apg = tomography.pgdb_process_estimate_batched(a, n, dim=2, method="apg",
                                                   maxiter=60)
    assert (pgdb - apg).abs().max().item() < 1e-3


def test_zero_maxiter_returns_the_start():
    a, n = _counts(2, 15, 2, 500)
    kw = dict(method="apg", maxiter=0, return_iters=True)
    got, want = _both(a, n, 2, kw)
    np.testing.assert_allclose(got, np.broadcast_to(np.eye(4) / 2, got.shape),
                               atol=0)
    np.testing.assert_allclose(got, want, atol=0)


@pytest.mark.parametrize("kw", [
    dict(method="pgdb", loop_dyk_iters=2), dict(method="apg", loop_dyk_iters=0),
    dict(method="pgdb", return_iters=True), dict(method="banana"),
    dict(cp_method="qr")])
def test_value_errors_match_jax(kw):
    a, n = _counts(2, 16, 1, 100)
    with pytest.raises(ValueError):
        jax_tomo.pgdb_process_estimate_batched(jnp.asarray(a), jnp.asarray(n),
                                               dim=2, **kw)
    with pytest.raises(ValueError):
        tomography.pgdb_process_estimate_batched(torch.tensor(a),
                                                 torch.tensor(n), dim=2, **kw)
