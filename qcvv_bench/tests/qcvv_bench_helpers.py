"""Helpers of the harness's CPU tests: a copy of the benchmark with small
cells, the plain routes counted as the kernels' launches, and one run of
the harness in this process."""
from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

from qcvv_bench import harness

BENCH = Path(harness.__file__).resolve().parent
ROOT = BENCH.parent

# small traffic for the CPU: the cells' shapes, fewer problems and circuits
SMALL = {
    "ptomo2q.fused_b16384": dict(batch=8, pool=2, warmup_calls=1,
                                 check_calls=2, trace_calls=2),
    "ptomo2q.fused_b41": dict(batch=5, pool=3, warmup_calls=1,
                              check_calls=3, trace_calls=2),
    "qv8.traj_c1600": dict(circuits=2, warmup_calls=1, check_calls=1,
                           trace_calls=1),
    "qv8.ideal_c1600": dict(circuits=8, warmup_calls=1, check_calls=2,
                            trace_calls=2),
}


def copy_benchmark(dest: Path, small: bool = True) -> Path:
    """A copy of ``BENCHMARK.json`` and ``qcvv_bench/`` (without its tests)
    under ``dest``, its cells cut to ``SMALL`` if ``small``; returns dest."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "qcvv_bench", ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    if small:
        for name, params in SMALL.items():
            path = dest / "qcvv_bench" / "workloads" / f"{name}.json"
            w = json.loads(path.read_text())
            w["traffic_params"].update(params)
            path.write_text(json.dumps(w, indent=2))
    return dest


def count_plain_routes(monkeypatch) -> None:
    """On the CPU the program runs the kernels' plain versions, which count
    no launch: count each call of them as its kernel's launch, so that the
    harness's route check holds as on the card."""
    from forest_benchmarking_tpu_torch.ops import lanes_apg, pallas_traj

    def counted(module, name, counter):
        plain = getattr(module, name)

        def wrapper(*args, **kw):
            counter.launches += 1
            return plain(*args, **kw)
        monkeypatch.setattr(module, name, wrapper)

    counted(lanes_apg, "apg_fused_reference", lanes_apg.apg_fused)
    counted(pallas_traj, "ideal_probs_reference", pallas_traj.ideal_probs)
    counted(pallas_traj, "traj_probs_reference", pallas_traj.traj_probs)


def run(root: Path, workload: str, seed: int = 12345678901,
        seconds: float = 0.3, trace: int = 0):
    """(exit code, the result's dict or None, standard error) of one run of
    the harness on the CPU, the look for a card skipped."""
    out, err = io.StringIO(), io.StringIO()
    options = harness.Options(root=root, device="cpu", require_cuda=False)
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(argv, options=options)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), err.getvalue()
