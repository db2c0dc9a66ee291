"""The f64 parity half of the port's measurement entry points against the
JAX package's, on the same counts, on the CPU in float64.

- ``bench._np_pgdb`` (the port's private copy of the numpy PGD oracle) is
  bitwise ``tests/oracles.np_pgdb``;
- each of the seven figures of ``bench.parity_figures`` equals the
  expression of root ``bench.py``'s ``PARITY_SNIPPET`` (``bench.py:350-425``)
  built from the JAX functions it calls, on the snippet's own counts
  (``synth_process_datasets`` at ``PRNGKey(7)``, B = 4, 1000 shots);
- ``tools.parity_sweep.dataset_deviation(a, n)`` equals the body of root
  ``tools/parity_sweep.py`` (the tight PGDB gold and the fused
  ``PARITY_TUNED_2Q`` schedule, ``:60-67``) on that tool's draws.

The bar is 1e-10 absolute on every figure: the two packages' estimates
agree to ~1e-13 on the fused schedules and to ~1e-14 on PGDB and APG here,
the figures are maxima of differences of those estimates (or the
likelihood-ratio statistic, a difference of costs times 2 N = 1.08e6), and
1e-10 is far below every figure's own bar (1e-6 on the fused parity
deviation, 4 on the statistics). The JAX fused solver compiles once a
schedule in this module (~35-50 s each on one core), so the module lives on
its own.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu.benchmarks import (
    process_tomo_A_matrix as jax_a_matrix, synth_process_datasets)
from forest_benchmarking_tpu.ops import lanes_apg as jax_lanes
from forest_benchmarking_tpu.ops.superoperator_transformations import (
    vec as jax_vec)
from forest_benchmarking_tpu.tomography import (
    pgdb_process_estimate_batched as jax_pgdb)
from forest_benchmarking_tpu_torch import bench
from forest_benchmarking_tpu_torch.tools import parity_sweep
from oracles import np_pgdb

torch.set_num_threads(1)

BAR = 1e-10
SNIPPET_SHOTS = 1000
FIGURES = ["max_deviation_vs_oracle", "apg_vs_converged_pgdb",
           "warm_apg_vs_converged_pgdb", "warm_apg_llr_statistic",
           "headline_vs_converged_pgdb", "headline_llr_statistic",
           "fused_parity_dev"]


@pytest.fixture(scope="module")
def snippet_counts():
    """The JAX snippet's inputs: A and its (4, R) f64 counts at PRNGKey(7)."""
    a = jax_a_matrix(2)
    n, _ = synth_process_datasets(jax.random.PRNGKey(7), jnp.asarray(a), 4, 4,
                                  SNIPPET_SHOTS, dtype=jnp.float64)
    return a, np.asarray(n)


def jax_snippet_figures(a, n):
    """``PARITY_SNIPPET``'s seven figures (root ``bench.py:350-425``), line
    for line, on the counts ``n``."""
    aj, nj = jnp.asarray(a), jnp.asarray(n)

    def pgdb(**kw):
        return np.asarray(jax_pgdb(aj, nj, dim=4, **kw))

    ours = pgdb()
    dev = max(np.max(np.abs(ours[i] - np_pgdb(a, n[i], 4)))
              for i in range(n.shape[0]))
    apg = pgdb(stop_tol=0.0, maxiter=40, method="apg")
    conv = pgdb(stop_tol=1e-12, maxiter=3000, dyk_iters=200)
    warm = pgdb(stop_tol=1e-4, maxiter=25, dyk_tol=1e-4, dyk_iters=20,
                method="apg", warm_start=True, loop_dyk_iters=1)

    def cost(est_b):
        v = np.stack([np.asarray(jax_vec(jnp.asarray(est_b[i])))[:, 0]
                      for i in range(est_b.shape[0])])
        p = np.maximum((v @ a.T).real, 1e-12)
        return -(n * np.log(p)).sum(axis=1)

    grand_total = SNIPPET_SHOTS * (a.shape[0] // 2)
    head = np.asarray(jax_lanes.apg_fused(aj, nj, dim=4, use_pallas=False,
                                          **jax_lanes.HEADLINE_TUNED_2Q))
    tight = pgdb(stop_tol=1e-14, maxiter=3000, dyk_tol=1e-10, dyk_iters=500)
    fused = np.asarray(jax_lanes.apg_fused(aj, nj, dim=4, use_pallas=False,
                                           **jax_lanes.PARITY_TUNED_2Q))
    return {"max_deviation_vs_oracle": float(dev),
            "apg_vs_converged_pgdb": float(np.max(np.abs(apg - conv))),
            "warm_apg_vs_converged_pgdb": float(np.max(np.abs(warm - conv))),
            "warm_apg_llr_statistic": float(
                np.max(cost(warm) - cost(conv)) * 2 * grand_total),
            "headline_vs_converged_pgdb": float(np.max(np.abs(head - conv))),
            "headline_llr_statistic": float(
                np.max(cost(head) - cost(conv)) * 2 * grand_total),
            "fused_parity_dev": float(np.max(np.abs(fused - tight)))}


@pytest.fixture(scope="module")
def both_figures(snippet_counts):
    a, n = snippet_counts
    return (bench.parity_figures(a, n, SNIPPET_SHOTS),
            jax_snippet_figures(a, n))


@pytest.mark.parametrize("i", range(4))
def test_np_pgdb_copy_is_the_test_oracle(snippet_counts, i):
    a, n = snippet_counts
    np.testing.assert_array_equal(bench._np_pgdb(a, n[i], 4),
                                  np_pgdb(a, n[i], 4))


@pytest.mark.parametrize("name", FIGURES)
def test_parity_figure_equals_jax(both_figures, name):
    ours, want = both_figures
    assert set(ours) == set(want) == set(FIGURES)
    assert abs(ours[name] - want[name]) <= BAR, (ours[name], want[name])


def test_parity_figures_hold_the_jax_bars(both_figures):
    """The snippet's bars, on its own counts, in both packages."""
    for figs in both_figures:
        assert figs["fused_parity_dev"] < 1e-6
        assert figs["headline_llr_statistic"] < 4
        assert figs["max_deviation_vs_oracle"] < 2.2e-14


def jax_sweep_deviation(a, n):
    """The body of root ``tools/parity_sweep.py`` for one dataset family."""
    aj, nj = jnp.asarray(a), jnp.asarray(n)
    gold = np.asarray(jax_pgdb(aj, nj, dim=4, stop_tol=1e-14, maxiter=3000,
                               dyk_tol=1e-10, dyk_iters=500))
    est = np.asarray(jax_lanes.apg_fused(aj, nj, dim=4, use_pallas=False,
                                         **jax_lanes.PARITY_TUNED_2Q))
    return float(np.max(np.abs(est - gold)))


@pytest.mark.parametrize("seed,shots", [(0, 750), (1, 8000)])
def test_dataset_deviation_equals_jax_sweep(seed, shots):
    """The JAX tool's draw for one (seed, shots) family (B = 4, its default
    batch), fed to both bodies."""
    a = jax_a_matrix(2)
    n, _ = synth_process_datasets(jax.random.PRNGKey(seed * 100_003 + shots),
                                  jnp.asarray(a), 4, 4, shots,
                                  dtype=jnp.float64)
    n = np.asarray(n)
    ours = parity_sweep.dataset_deviation(
        torch.tensor(a, dtype=torch.complex128), torch.tensor(n))
    want = jax_sweep_deviation(a, n)
    assert abs(ours - want) <= BAR, (ours, want)
    assert want < 1e-6
