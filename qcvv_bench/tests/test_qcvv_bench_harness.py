"""CPU tests of the harness: the result's shape, cells and metrics found by
name, the contract's names and units, the import check, and each cell run
small on the CPU (the program's plain versions in the kernels' place)."""
from __future__ import annotations

import ast
import hashlib
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

from qcvv_bench import harness, tracing

import qcvv_bench_helpers as helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = list(helpers.SMALL)

STUB_CONFIG = '''
import torch

class Echo:
    work_per_call = 3
    warm_seconds = 0.01
    launches_per_call = (1,)

    def __init__(self, config, traffic, seed, device, reference):
        self.config, self.reference = config, reference
        self.calls = 0
        self.x = torch.arange(3, dtype=torch.float64) + seed % 7

    def launches(self):
        return (self.calls,)

    def before(self, i):
        return i

    def entry(self, i):
        self.calls += 1
        return self.x * 2

    def fetch(self, out):
        return out.cpu()

    def release(self):
        pass

    def check(self, kept):
        return {"echo_gap": max(float((out - self.reference.echo(self.x)).abs().max())
                                for _, _, out in kept)}


def setup(config, traffic, seed, device, reference):
    return Echo(config, traffic, seed, device, reference)
'''


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _add_stub(root: Path) -> None:
    """A configuration, a cell, an end-to-end and a per-layer metric, each
    as new files, and their entries in BENCHMARK.json."""
    b = root / "qcvv_bench"
    (b / "configs" / "stub.json").write_text(json.dumps({"name": "stub"}))
    (b / "configs" / "stub.py").write_text(STUB_CONFIG)
    (b / "reference" / "stub.py").write_text("def echo(x):\n    return 2 * x\n")
    (b / "workloads" / "stub.echo.json").write_text(json.dumps({
        "name": "stub.echo", "config": "stub", "traffic": "echo", "chips": 1,
        "why": "a stub", "limits": {"echo_gap": 0.0},
        "traffic_params": {"check_calls": 2, "trace_calls": 2}}))
    (b / "end_to_end" / "echoes_per_s.py").write_text(
        "def read(run, sut):\n    return run.window.work / run.window.elapsed\n")
    (b / "metrics" / "echo_calls.py").write_text(
        "def read(trace, sut):\n    return trace.calls or None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "stub", "source": "none", "why": "a stub",
                            "file": "qcvv_bench/configs/stub.json", "reduced": []})
    spec["workloads"].append({"name": "stub.echo", "config": "stub",
                              "traffic": "echo", "chips": 1, "why": "a stub"})
    spec["end_to_end"].append({"name": "echoes_per_s", "unit": "echoes/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["stub.echo"]})
    spec["per_layer"].append({"name": "echo_calls", "unit": "calls",
                              "better": "higher", "source": "program_counter",
                              "layer": "echo", "moves": "echoes_per_s",
                              "workloads": ["stub.echo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def stub_root(tmp_path):
    root = helpers.copy_benchmark(tmp_path, small=False)
    before = _digest(root)
    _add_stub(root)
    after = _digest(root)
    # nothing that was there changed, but the list of cells and metrics
    assert {k: v for k, v in after.items() if k in before} == dict(
        before, **{"BENCHMARK.json": after["BENCHMARK.json"]})
    return root


def _plant_a_device_operation(monkeypatch):
    """The CPU has no device timeline: put one operation on it, inside the
    traced stretch's first call, so that the rest of a traced run reads."""
    real = tracing.events_from_profile

    def events(prof):
        out = real(prof)
        calls = [e for e in out if e.name == tracing.CALL_SPAN]
        if not calls:
            return out
        call = min(calls, key=lambda e: e.start)
        return out + [tracing.Event("stub_kernel", call.start,
                                    (call.start + call.end) / 2, True)]
    monkeypatch.setattr(tracing, "events_from_profile", events)


@pytest.mark.parametrize("trace", [0, 1])
def test_added_cell_config_and_metrics_are_found_by_name(stub_root, trace,
                                                         monkeypatch):
    _plant_a_device_operation(monkeypatch)
    rc, result, err = helpers.run(stub_root, "stub.echo", trace=trace)
    assert rc == 0, err
    assert list(result)[:5] == RESULT_KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert result["checks"] == {"echo_gap": {"value": 0.0, "limit": 0.0}}
    names = set(result["metrics"])
    if trace:
        assert names == {"echo_calls"}
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["breakdown"]["device_ops"][0][0] == "stub_kernel"
        assert result["device"]["busy_s"] > 0
    else:
        assert names == {"setup_s", "call_p95_ms", "echoes_per_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert err.strip().splitlines()[-1] == "check echo_gap 0.0 limit 0.0"


def test_a_traced_run_without_device_operations_is_refused(stub_root):
    rc, result, err = helpers.run(stub_root, "stub.echo", trace=1)
    assert rc == 4 and result is None
    assert "refused" in err and "no operation on the device" in err


def test_a_loaded_jax_module_ends_the_run_without_a_result(stub_root,
                                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    rc, result, err = helpers.run(stub_root, "stub.echo")
    assert rc == 3 and result is None and "jaxlib" in err


def test_the_import_check_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "forest_benchmarking_tpu", "forest_benchmarking_tpu.ops",
             "forest_benchmarking_tpu_torch", "forest_benchmarking_tpu_torch.ops",
             "jaxtyping", "flaxen", "qcvv_bench"]
    assert harness.forbidden_modules(names) == sorted(names[:6])


def _run_py(cwd, home):
    return subprocess.run(
        [sys.executable, "qcvv_bench/run.py", "--workload", "qv8.ideal_c1600",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(home), "TMPDIR": str(home)})


def test_without_a_card_the_run_exits_2_and_prints_no_result(tmp_path):
    out = _run_py(helpers.ROOT, tmp_path)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_with_only_the_benchmarks_files_the_run_exits_nonzero(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    helpers.copy_benchmark(root, small=False)
    out = _run_py(root, tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program():
    bench = helpers.BENCH
    for path in sorted((bench / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        tops = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        tops |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert tops <= {"__future__", "functools", "typing", "numpy", "torch",
                        "math"}, (path.name, tops)
    code = ("import sys, importlib.util\n"
            "for name in sys.argv[1:]:\n"
            "    spec = importlib.util.spec_from_file_location('r', name)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "      ('jax', 'jaxlib', 'forest_benchmarking_tpu',\n"
            "       'forest_benchmarking_tpu_torch', 'qcvv_bench')))\n")
    out = subprocess.run([sys.executable, "-c", code]
                         + [str(p) for p in (bench / "reference").glob("*.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd="/")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((helpers.ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "qcvv_bench/run.py"]
    assert spec["paths"] == ["qcvv_bench"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    for name in names:
        assert NAME.match(name), name
    assert len(set(x["name"] for x in spec["configs"])) == len(spec["configs"])
    assert len(set(x["name"] for x in spec["workloads"])) == len(spec["workloads"])
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    configs = {c["name"]: c for c in spec["configs"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert PATH.match(c["file"]) and c["file"].startswith("qcvv_bench/")
        assert (helpers.ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(set(pairs)) == len(pairs)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
        assert (helpers.BENCH / "workloads" / f"{w['name']}.json").is_file()
        assert (helpers.BENCH / "reference" / f"{w['config']}.py").is_file()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert (helpers.BENCH / "end_to_end" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        assert (helpers.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        reported = [m for m in spec["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in spec["per_layer"])
    assert len(json.dumps(spec)) <= 64 * 1024
    for path in helpers.BENCH.rglob("*"):
        rel = path.relative_to(helpers.ROOT).as_posix()
        if "__pycache__" not in rel:
            assert PATH.match(rel), rel


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_cpu(tmp_path, monkeypatch, cell):
    root = helpers.copy_benchmark(tmp_path)
    helpers.count_plain_routes(monkeypatch)
    rc, result, err = helpers.run(root, cell, seconds=0.2)
    assert rc == 0, err
    assert result["correct"] is True, err
    assert result["failed"] == 0 and result["attempted"] >= 1
    spec = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in harness.metrics_for(spec, "end_to_end", cell)}
    assert set(result["metrics"]) == want


@pytest.mark.parametrize("cell", ["ptomo2q.fused_b41", "qv8.ideal_c1600"])
def test_a_traced_run_on_the_cpu_reads_the_stretch(tmp_path, monkeypatch,
                                                   cell):
    root = helpers.copy_benchmark(tmp_path)
    helpers.count_plain_routes(monkeypatch)
    # no device on the CPU: the traced run is refused, with no result
    rc, result, err = helpers.run(root, cell, seconds=0.2, trace=1)
    assert rc == 4 and result is None and "refused" in err
    # with one operation put on the device's timeline the stretch is read
    # (a window long enough for the stretch's calls)
    _plant_a_device_operation(monkeypatch)
    rc, result, err = helpers.run(root, cell, seconds=2.0, trace=1)
    assert rc == 0 and result["correct"] is True, err
    assert not any(k.endswith("roofline_pct") for k in result["metrics"])
    idle = [v["value"] for k, v in result["metrics"].items()
            if k.startswith("device_idle_pct")]
    launches = [v["value"] for k, v in result["metrics"].items()
                if k.startswith("launches_per_call")]
    assert len(idle) == 1 and 0 < idle[0] < 100
    assert len(launches) == 1 and 0 < launches[0] <= 1
    assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
