"""The port's measurement entry points on the CPU, at tiny sizes:
``forest_benchmarking_tpu_torch.bench`` (the JAX package's ``bench.py``),
``bench_all`` (``bench_all.py``) and ``tools.parity_sweep``
(``tools/parity_sweep.py``).

- The analytic FLOP counts equal the JAX harness's (root ``bench.py``,
  imported as ``tests/test_bench_harness.py`` imports it; its counts are
  pure arithmetic).
- ``throughput`` at B = 16 and every ``bench_all`` section at a tiny size
  give the JAX lines' keys, under the renaming of TPU names listed below.
- A stage that raises is recorded under ``errors`` with its figures
  ``null`` and nothing in their place, and ``main`` still prints one line
  (``tests/test_bench_harness.py:37-119``); a ``bench_all`` section that
  raises gives ``{"metric", "value": null, "error"}`` and the rest run.
- The f64 parity half, on its own draw, holds the JAX bars: fused parity
  < 1e-6 from the tight optimum, headline likelihood-ratio statistic < 4,
  PGDB at round-off from the numpy oracle. Its figures, the oracle copy and
  the sweep's body are held equal to the JAX package's on the same counts
  in ``tests/test_torch_bench_parity.py``.
- ``parity_sweep`` writes JAX's rows and summary, and the worst deviation
  is under 1e-6.

The timed loops run one warm-up and one timed run here (``REPS``); the
timings on the CPU are host clocks and say nothing of the card.
"""
import contextlib
import functools
import importlib.util
import io
import json
import pathlib

import pytest
import torch

from forest_benchmarking_tpu.ops.lanes_apg import (
    HEADLINE_TUNED_2Q as JAX_HEADLINE, PARITY_TUNED_2Q as JAX_PARITY)
from forest_benchmarking_tpu_torch import bench, bench_all
from forest_benchmarking_tpu_torch.tools import parity_sweep

# the JAX harness, loaded from its file (no change to sys.path here)
_SPEC = importlib.util.spec_from_file_location(
    "jax_harness_bench", pathlib.Path(__file__).resolve().parents[1]
    / "bench.py")
jax_bench = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_bench)

torch.set_num_threads(1)

CPU = "cpu"

# the JAX lines' keys (bench.py:487-529, bench.py:325-346, bench_all.py)
JAX_BENCH_LINE = {  # bench.py:487-529 (parity_error and errors optional)
    "metric", "value", "unit", "vs_baseline", "sustained_solves_per_sec",
    "headline_llr_statistic_f64", "headline_vs_converged_pgdb_f64",
    "headline_flops_per_solve", "headline_achieved_gflops",
    "xla_warm_apg_solves_per_sec", "xla_warm_apg_mean_iters",
    "xla_warm_apg_flops_per_solve", "parity_solves_per_sec",
    "parity_vs_baseline", "parity_flops_per_solve",
    "parity_achieved_gflops", "parity_fraction_vpu_peak",
    "fused_parity_dev_f64", "mean_rel_frob_err_parity_f32", "batch",
    "apg_cold_solves_per_sec", "pgdb_solves_per_sec",
    "mean_rel_frob_err_f32", "mean_rel_frob_err_xla_warm_f32",
    "mean_rel_frob_err_cold_f32", "mean_rel_frob_err_pgdb_f32",
    "max_deviation_vs_oracle_f64", "apg_vs_converged_pgdb_f64",
    "warm_apg_vs_converged_pgdb_f64", "warm_apg_llr_statistic_f64"}
JAX_PERF = {  # bench.py:325-346, tpu_throughput's dict
    "solves_per_sec", "sustained_solves_per_sec", "headline_flops_per_solve",
    "headline_achieved_gflops", "xla_warm_apg_solves_per_sec",
    "xla_warm_apg_mean_iters", "xla_warm_apg_flops_per_solve",
    "parity_solves_per_sec", "parity_flops_per_solve",
    "parity_achieved_gflops", "parity_fraction_vpu_peak",
    "mean_rel_frob_err_parity", "apg_cold_solves_per_sec",
    "pgdb_solves_per_sec", "batch", "sec_per_batch", "mean_rel_frob_err",
    "mean_rel_frob_err_xla_warm", "mean_rel_frob_err_cold",
    "mean_rel_frob_err_pgdb", "errors"}
JAX_SECTIONS = {
    # bench_all.py:120-129
    "config1": {"metric", "value", "unit", "vs_baseline", "batch",
                "mle_flops_per_solve", "achieved_gflops",
                "mean_fidelity_lin", "mean_fidelity_mle"},
    # bench_all.py:327-337 (errors optional)
    "config2": {"metric", "value", "unit", "vs_baseline", "batch",
                "sustained_solves_per_sec", "parity_solves_per_sec",
                "parity_achieved_gflops", "full_receipt"},
    # bench_all.py:166-173
    "config3": {"metric", "value", "unit", "vs_baseline", "batch",
                "lm_flops_per_fit", "achieved_gflops", "mean_decay_error",
                "max_decay_error"},
    # bench_all.py:232-239
    "config4": {"metric", "value", "unit", "vs_baseline", "batch",
                "incl_generation_pairs_per_sec", "diamond_norms_per_sec",
                "dnorm_batch", "dnorm_method", "mean_diamond_norm"},
    # bench_all.py:255-261
    "config5_ideal": {"metric", "value", "unit", "vs_baseline",
                      "num_circuits", "heavy_output_prob",
                      "ideal_asymptote"},
    # bench_all.py:288-300 (auto: no noisy_method key)
    "config5_noisy_d4": {"metric", "value", "unit", "vs_baseline",
                         "num_circuits", "depolarizing_p",
                         "heavy_output_prob"},
    # bench_all.py:288-317, trajectory at T = 1000 (default: shots)
    "config5_noisy_d8": {"metric", "value", "unit", "vs_baseline",
                         "num_circuits", "depolarizing_p",
                         "heavy_output_prob", "noisy_method",
                         "traj_flops_per_circuit", "traj_achieved_gflops"},
    # bench_all.py:288-317, trajectory at T = 500
    "config5_noisy_d8_t500": {"metric", "value", "unit", "vs_baseline",
                              "num_circuits", "depolarizing_p",
                              "heavy_output_prob", "noisy_method",
                              "num_trajectories", "traj_flops_per_circuit",
                              "traj_achieved_gflops"},
}
# TPU names the port renames, and the keys it adds to the bench line
RENAMED = {"xla_warm_apg_solves_per_sec": "warm_apg_solves_per_sec",
           "xla_warm_apg_mean_iters": "warm_apg_mean_iters",
           "xla_warm_apg_flops_per_solve": "warm_apg_flops_per_solve",
           "mean_rel_frob_err_xla_warm_f32": "mean_rel_frob_err_warm_f32",
           "mean_rel_frob_err_xla_warm": "mean_rel_frob_err_warm",
           "parity_fraction_vpu_peak": "parity_fraction_f32_peak"}
ADDED = {"device", "statistic"}


def renamed(keys):
    return {RENAMED.get(k, k) for k in keys}


@pytest.fixture
def one_run(monkeypatch):
    """One warm-up and one timed run a figure, one solve in the stream."""
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "SUSTAINED_REPS", 1)
    monkeypatch.setattr(bench, "SUSTAINED_SOLVES", 1)
    monkeypatch.setattr(bench_all, "REPS", 1)


@pytest.mark.parametrize("schedule", ["HEADLINE_TUNED_2Q", "PARITY_TUNED_2Q"])
def test_fused_flops_equal_jax(schedule):
    cfg = {k: v for k, v in getattr(jax_bench, schedule).items() if k != "mu"}
    assert bench.fused_apg_flops_per_solve(**cfg) \
        == jax_bench.fused_apg_flops_per_solve(**cfg)
    assert bench.fused_apg_flops_per_solve(**cfg, dim=2, a_rows=72) \
        == jax_bench.fused_apg_flops_per_solve(**cfg, dim=2, a_rows=72)


@pytest.mark.parametrize("mean_iters", [0.0, 1.0, 3.25, 25.0])
def test_headline_flops_equal_jax(mean_iters):
    assert bench.headline_flops_per_solve(mean_iters) \
        == jax_bench.headline_flops_per_solve(mean_iters)


def test_constants_equal_jax():
    assert (bench.BATCH, bench.SHOTS, bench.TARGET_SOLVES_PER_SEC) \
        == (jax_bench.BATCH, jax_bench.SHOTS, jax_bench.TARGET_SOLVES_PER_SEC)
    assert bench.HEADLINE_TUNED_2Q == JAX_HEADLINE
    assert bench.PARITY_TUNED_2Q == JAX_PARITY


def test_throughput_on_the_cpu(one_run):
    errors = {}
    perf = bench.throughput(errors, batch=16, device=CPU)
    assert errors == {} and perf["errors"] is errors
    assert set(perf) == renamed(JAX_PERF)
    assert all(v is not None for v in perf.values())
    assert perf["batch"] == 16
    # shot-noise limited at 2000 shots a setting (~0.10 in f64)
    for key in ("mean_rel_frob_err", "mean_rel_frob_err_parity",
                "mean_rel_frob_err_warm", "mean_rel_frob_err_cold",
                "mean_rel_frob_err_pgdb"):
        assert 0.05 < perf[key] < 0.12, key
    assert perf["warm_apg_mean_iters"] >= 1
    assert perf["warm_apg_flops_per_solve"] == \
        bench.headline_flops_per_solve(perf["warm_apg_mean_iters"])
    assert perf["parity_fraction_f32_peak"] == pytest.approx(
        perf["parity_achieved_gflops"] * 1e9 / bench.PEAK_FLOPS)


def _main_line():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        returned = bench.main()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out == returned
    return out


PARITY_STUB = {"max_deviation_vs_oracle": 3e-15, "apg_vs_converged_pgdb": 1e-5,
               "warm_apg_vs_converged_pgdb": 3e-3,
               "warm_apg_llr_statistic": 3.7,
               "headline_vs_converged_pgdb": 2.6e-3,
               "headline_llr_statistic": 2.8, "fused_parity_dev": 8e-7}


def test_main_records_a_failed_stage_and_substitutes_nothing(monkeypatch,
                                                            one_run):
    """The parity solve raises: its figures are null, the headline's stand,
    the failure is under ``errors``; one parseable line."""
    real = bench.apg_fused

    def parity_fails(a, n, dim, **cfg):
        if cfg.get("phases") == bench.PARITY_TUNED_2Q["phases"]:
            raise RuntimeError("injected parity-kernel failure")
        return real(a, n, dim, **cfg)

    monkeypatch.setattr(bench, "apg_fused", parity_fails)
    monkeypatch.setattr(bench, "throughput", functools.partial(
        bench.throughput, comparisons=False, batch=16, device=CPU))
    monkeypatch.setattr(bench, "cpu_parity", lambda: dict(PARITY_STUB))
    monkeypatch.setattr(bench, "card", lambda: "cpu")
    out = _main_line()
    assert set(out) == renamed(JAX_BENCH_LINE) | ADDED | {"errors"}
    assert set(out["errors"]) == {"parity_fused"}
    assert "injected" in out["errors"]["parity_fused"]
    for key in ("parity_solves_per_sec", "parity_vs_baseline",
                "parity_achieved_gflops", "parity_fraction_f32_peak",
                "mean_rel_frob_err_parity_f32"):
        assert out[key] is None, key
    assert out["value"] > 0 and out["sustained_solves_per_sec"] > 0
    assert out["vs_baseline"] == round(out["value"] / 1e4, 4)
    assert out["mean_rel_frob_err_f32"] < 0.12
    # the comparisons were not asked for: null, not filled from elsewhere
    assert out["warm_apg_solves_per_sec"] is None
    assert out["fused_parity_dev_f64"] == PARITY_STUB["fused_parity_dev"]
    assert out["device"] == "cpu" and out["batch"] == 16


def test_main_prints_its_line_when_everything_fails(monkeypatch):
    def boom(errors=None):
        raise RuntimeError("injected: no card")

    def parity_boom():
        raise RuntimeError("injected parity failure")

    def no_card():
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(bench, "throughput", boom)
    monkeypatch.setattr(bench, "cpu_parity", parity_boom)
    monkeypatch.setattr(bench, "card", no_card)
    out = _main_line()
    assert out["metric"] == "2q_process_tomography_mle_throughput"
    assert out["value"] is None and out["parity_solves_per_sec"] is None
    assert out["fused_parity_dev_f64"] is None and out["device"] is None
    assert out["batch"] == bench.BATCH
    assert set(out["errors"]) == {"throughput", "parity", "device"}
    assert set(out) == renamed(JAX_BENCH_LINE) | ADDED | {"errors"}


def test_main_without_a_card_records_it(monkeypatch):
    """The default device is the card: without one, the line says so under
    ``errors`` and falls back to nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setattr(bench, "cpu_parity", lambda: dict(PARITY_STUB))
    monkeypatch.setattr(bench, "card", lambda: None)
    out = _main_line()
    assert "throughput" in out["errors"]
    assert out["value"] is None and out["pgdb_solves_per_sec"] is None


def test_cpu_parity_holds_the_jax_bars():
    p = bench.cpu_parity()
    assert set(p) == set(PARITY_STUB)
    assert p["fused_parity_dev"] < 1e-6
    assert p["headline_llr_statistic"] < 4
    # PGDB and the numpy oracle sum in different orders: round-off only
    assert p["max_deviation_vs_oracle"] < 2.2e-14
    assert p["apg_vs_converged_pgdb"] < 1e-3
    assert p["warm_apg_vs_converged_pgdb"] < 1e-2
    assert 0 <= p["warm_apg_llr_statistic"] < 10


TINY = {
    "config1": lambda: bench_all.config1_state_tomo(256, 200, device=CPU),
    "config2": lambda: bench_all.config2_process_tomo(batch=8, device=CPU),
    "config3": lambda: bench_all.config3_rb_fits(64, 4, 100, device=CPU),
    "config4": lambda: bench_all.config4_dfe_distances(4, 4, device=CPU),
    "config5_ideal": lambda: bench_all.config5_quantum_volume(
        4, 8, 100, device=CPU),
    "config5_noisy_d4": lambda: bench_all.config5_noisy_quantum_volume(
        4, 8, 100, device=CPU),
    "config5_noisy_d8": lambda: bench_all.config5_noisy_quantum_volume(
        5, 4, 50, noisy_method="trajectory", device=CPU),
    "config5_noisy_d8_t500": lambda: bench_all.config5_noisy_quantum_volume(
        5, 4, 40, noisy_method="trajectory", num_trajectories=20,
        device=CPU),
}


@pytest.mark.parametrize("name", list(JAX_SECTIONS))
def test_bench_all_section_on_the_cpu(name, one_run):
    line = TINY[name]()
    assert set(line) == JAX_SECTIONS[name], name
    assert line["value"] > 0 and "error" not in line
    if name == "config4":
        assert line["dnorm_method"] == "dense"   # "auto" on the CPU
    if name.startswith("config5"):
        assert 0.5 < line["heavy_output_prob"] < 1
    if name == "config5_noisy_d8":
        assert line["traj_flops_per_circuit"] == round(
            bench_all.traj_flops_per_circuit(5, 16, 50)
            + bench_all.traj_flops_per_circuit(5, num_trajectories=1,
                                               noiseless=True))


def test_bench_all_main_prints_each_line_and_keeps_going(monkeypatch,
                                                         tmp_path):
    names = list(JAX_SECTIONS)
    calls = []

    def fake(name):
        def run():
            calls.append(name)
            if name == "config4":
                raise RuntimeError("injected section failure")
            return {"metric": name, "value": 1.0}
        return run

    monkeypatch.setattr(bench_all, "sections",
                        lambda: [(n, fake(n)) for n in names])
    buf = io.StringIO()
    out = tmp_path / "sub" / "all.jsonl"
    with contextlib.redirect_stdout(buf):
        results = bench_all.main([str(out)])
    printed = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    written = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert calls == names and printed == written == results
    assert [r["metric"] for r in results] == names
    failed = results[names.index("config4")]
    assert failed["value"] is None and "injected" in failed["error"]
    assert set(failed) == {"metric", "value", "error"}


def test_bench_all_sections_are_the_jax_eight_in_order():
    assert [name for name, _ in bench_all.sections()] == list(JAX_SECTIONS)


def test_parity_sweep_rows_and_summary(tmp_path):
    out = tmp_path / "sweep.json"
    summary = parity_sweep.main([str(out), "--seeds", "1", "--shots", "2000",
                                 "--batch", "2"])
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(lines) == 2 and lines[-1] == summary
    row = lines[0]
    assert set(row) == {"seed", "shots", "dev", "gold_secs"}
    assert (row["seed"], row["shots"]) == (0, 2000)
    assert set(summary) == {"schedule", "n_datasets", "worst_dev",
                            "worst_row"}
    assert summary["n_datasets"] == 1 and summary["worst_row"] == row
    assert summary["worst_dev"] == row["dev"] < 1e-6
    assert summary["schedule"] == {
        k: (list(map(list, v)) if k == "phases" else v)
        for k, v in JAX_PARITY.items()}
