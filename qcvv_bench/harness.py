"""One run of one benchmark cell: set-up, a closed-loop window, the check.

``python qcvv_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout that holds ``BENCHMARK.json``,
``qcvv_bench/`` and the program, ``forest_benchmarking_tpu_torch``.

- The cell's file ``qcvv_bench/workloads/<cell>.json`` names its
  configuration and holds its traffic parameters and the limits of its
  check. ``configs/<config>.py`` (with its sizes in ``configs/<config>.json``
  and its plain reference in ``reference/<config>.py``) sets the cell up
  from the seed and makes one call of the program's public entry point.
- Set-up (``setup_s``) runs from the start of ``run.py`` to the first timed
  call: imports, the CUDA context, the kernels' build or load, the inputs
  made on the card, the warm-up calls.
- The window is a closed loop with one caller: a call starts when the
  harness calls the entry point and ends when its outputs are tensors on the
  host; the next starts at once. It runs until ``--seconds`` have passed.
  Every call counts: a throughput is all the work completed over the whole
  window, a percentile is over all calls, each as long as the caller
  waited for it; both by the host's clock. A call that raises, or whose
  kernel launch counters did not move as the cell's route requires, is
  failed.
- With ``--trace 1`` the first ``trace_calls`` calls of the window (after
  one warm-up call of the profiler) run under ``torch.profiler``, each
  inside the harness's spans ``qcvv.call``, ``qcvv.entry`` and
  ``qcvv.fetch``; the run reports the per-layer metrics read from that
  stretch (``metrics/<name>.py``), and the end-to-end ones otherwise
  (``end_to_end/<name>.py``), as ``BENCHMARK.json`` lists them for the cell.
  A traced run whose stretch shows no operation on the device is refused:
  it exits with 4 and prints no result.
- After the window, the peak device memory is read, the program's state is
  released, and the outputs of calls chosen from the seed are compared with
  the plain reference; each number and its limit are printed as the last
  lines of standard error and under ``checks`` in the result.
- The last line of standard output is the result, a JSON object. The run
  exits with 2 and prints none without enough cards, with 3 if a module
  of JAX or of the JAX package is loaded once the window has closed, and
  with 4 if a traced stretch shows no device operation.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import random
import re
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

import torch

from qcvv_bench import tracing

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "forest_benchmarking_tpu")


def forbidden_modules(names: Sequence[str]) -> List[str]:
    """The module names whose top-level name (before the first dot) is, as
    a whole, one of ``FORBIDDEN``."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


@dataclass
class Options:
    """Where the benchmark's files are and what a run may use: ``root``
    holds ``BENCHMARK.json`` and ``qcvv_bench/``; tests of the harness run
    it with ``device="cpu"`` and ``require_cuda=False``."""
    root: Path = ROOT
    device: str = "cuda"
    require_cuda: bool = True

    @property
    def bench(self) -> Path:
        return self.root / "qcvv_bench"


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def _module_name(kind: str, name: str) -> str:
    return f"qcvv_bench_{kind}_" + re.sub(r"[.-]", "_", name)


@dataclass
class Cell:
    """What the harness finds by a cell's name."""
    name: str
    workload: dict              # workloads/<cell>.json
    config: dict                # configs/<config>.json
    program: ModuleType         # configs/<config>.py
    reference: ModuleType       # reference/<config>.py


def find_cell(options: Options, benchmark: dict, name: str) -> Cell:
    specs = [w for w in benchmark["workloads"] if w["name"] == name]
    if not specs:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    bench = options.bench
    workload = read_json(bench / "workloads" / f"{name}.json")
    cfg = workload["config"]
    if cfg != specs[0]["config"] or workload["chips"] != specs[0]["chips"]:
        raise ValueError(f"workloads/{name}.json disagrees with "
                         "BENCHMARK.json")
    return Cell(name, workload,
                read_json(bench / "configs" / f"{cfg}.json"),
                load_module(bench / "configs" / f"{cfg}.py",
                            _module_name("config", cfg)),
                load_module(bench / "reference" / f"{cfg}.py",
                            _module_name("reference", cfg)))


def metrics_for(benchmark: dict, kind: str, cell: str) -> List[dict]:
    """The entries of ``benchmark[kind]`` that the cell reports."""
    return [m for m in benchmark[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(options: Options, kind: str, name: str) -> ModuleType:
    folder = "end_to_end" if kind == "end_to_end" else "metrics"
    return load_module(options.bench / folder / f"{name}.py",
                       _module_name(folder, name))


def keep_plan(seed: int, expected_calls: int, count: int) -> set:
    """Indices of the window's calls whose outputs are checked: the first,
    and ``count - 1`` more drawn from the seed among the first four fifths
    of the calls the warm-up predicts."""
    hi = max(1, int(0.8 * expected_calls))
    rng = random.Random(seed)
    return {0} | set(rng.sample(range(hi), min(count - 1, hi)))


@dataclass
class Window:
    """What a window did: every call's host seconds, its length, the calls
    that failed and the kept ``(index, context, outputs)``."""
    seconds: List[float] = field(default_factory=list)
    elapsed: float = 0.0
    failed: int = 0
    work: int = 0
    kept: list = field(default_factory=list)
    trace: Optional[tracing.Summary] = None
    errors: List[str] = field(default_factory=list)


def _span(name: str, on: bool):
    if on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def run_window(sut, device: torch.device, seconds: float, keep: set,
               trace_calls: int = 0) -> Window:
    """The closed loop. ``sut`` is the set-up cell (``entry``, ``fetch``,
    ``before``, ``launches``, ``launches_per_call``, ``work_per_call``)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    win = Window()
    prof = None
    if trace_calls:
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities, schedule=schedule(
            wait=0, warmup=1, active=trace_calls, repeat=1))
        prof.__enter__()
    want = list(sut.launches_per_call)
    i = 0
    w0 = time.perf_counter()
    while True:
        traced = prof is not None
        ctx = sut.before(i) if i in keep else None
        before = sut.launches()
        t0 = time.perf_counter()
        out = None
        try:
            with _span(tracing.CALL_SPAN, traced):
                with _span("qcvv.entry", traced):
                    dev_out = sut.entry(i)
                with _span("qcvv.fetch", traced):
                    out = sut.fetch(dev_out)
                del dev_out
        # a failed call is counted, and the window goes on
        except Exception:  # noqa: BLE001
            if len(win.errors) < 3:
                win.errors.append(traceback.format_exc(limit=4))
        t1 = time.perf_counter()
        win.seconds.append(t1 - t0)
        moved = [a - b for a, b in zip(sut.launches(), before)]
        if out is None or moved != want:
            win.failed += 1
            if out is not None and len(win.errors) < 3:
                win.errors.append(f"call {i}: launches {moved}, want {want}")
        else:
            win.work += sut.work_per_call
            if i in keep:
                win.kept.append((i, ctx, out))
        i += 1
        if prof is not None:
            prof.step()
            if i == trace_calls + 1:
                win.trace = _stop(prof)
                prof = None
        if t1 - w0 >= seconds:
            break
    win.elapsed = time.perf_counter() - w0
    if prof is not None:            # the window ended before the stretch did
        win.trace = _stop(prof)
    return win


def _stop(prof) -> tracing.Summary:
    prof.__exit__(None, None, None)
    return tracing.summarize(tracing.events_from_profile(prof))


def set_up_and_run(cell: Cell, seed: int, device: torch.device,
                   seconds: float, trace_calls: int = 0):
    """Set the cell up from the seed and run its window: (the set-up cell,
    the ``time.perf_counter()`` at which set-up ended, the window)."""
    traffic = cell.workload["traffic_params"]
    sut = cell.program.setup(cell.config, traffic, seed, device,
                             cell.reference)
    ready = time.perf_counter()
    expected = max(1, int(seconds / max(sut.warm_seconds, 1e-6)))
    keep = keep_plan(seed, expected, int(traffic["check_calls"]))
    return sut, ready, run_window(sut, device, seconds, keep, trace_calls)


def trace_fault(trace: Optional[tracing.Summary]) -> Optional[str]:
    """Why a traced stretch cannot be read, or None: it has to hold calls
    and operations on the device."""
    if trace is None or not trace.calls:
        return "the profiler recorded no call of the window"
    if not trace.launches or trace.busy_s <= 0:
        return (f"the profiler recorded no operation on the device in "
                f"{trace.calls} calls")
    return None


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device)}


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def _parse(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="qcvv_bench/run.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _value(x) -> float:
    return float(x.item()) if isinstance(x, torch.Tensor) else float(x)


def main(argv: Sequence[str], t0: Optional[float] = None,
         options: Optional[Options] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    options = options or Options()
    args = _parse(argv)
    parts = {"imports": time.perf_counter() - t0}
    benchmark = read_json(options.root / "BENCHMARK.json")
    cell = find_cell(options, benchmark, args.workload)
    parts["program"] = time.perf_counter() - t0
    chips = cell.workload["chips"]
    if options.require_cuda and (not torch.cuda.is_available()
                                 or torch.cuda.device_count() < chips):
        print(f"qcvv_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device(options.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    torch.empty(1, device=device)           # the CUDA context
    parts["context"] = time.perf_counter() - t0

    trace_calls = cell.workload["traffic_params"]["trace_calls"]
    sut, ready, win = set_up_and_run(cell, args.seed, device, args.seconds,
                                     int(trace_calls) if args.trace else 0)
    setup_s = ready - t0
    if args.trace and trace_fault(win.trace):
        print(f"qcvv_bench: the traced run is refused: "
              f"{trace_fault(win.trace)}", file=sys.stderr)
        return 4
    card = _card(device)
    card["count"] = chips
    card["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)
    if args.trace:
        card["busy_s"] = win.trace.busy_s
        card["window_s"] = win.trace.window_s

    sut.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = {k: _value(v) for k, v in sut.check(win.kept).items()} \
        if win.kept else {}
    check_s = time.perf_counter() - t_check
    limits = cell.workload["limits"]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in limits}
    correct = (bool(win.kept) and win.failed == 0
               and set(numbers) == set(limits)
               and all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                       for k in limits))

    run = RunRecord(setup_s, win)
    metrics: Dict[str, dict] = {}
    if args.trace:
        kind, source = "per_layer", win.trace
    else:
        kind, source = "end_to_end", run
    for m in metrics_for(benchmark, kind, cell.name):
        value = reader(options, kind, m["name"]).read(source, sut)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(win.seconds),
              "failed": win.failed, "metrics": metrics, "device": card}
    if args.trace:
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = checks

    loaded = forbidden_modules(list(sys.modules))
    if loaded:
        print("qcvv_bench: modules of JAX or of the JAX package are loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 3
    for err in win.errors:
        print(err, file=sys.stderr)
    if device.type == "cuda":
        print(f"card: {_power_limit()}", file=sys.stderr)
    print(f"calls {len(win.seconds)} failed {win.failed} kept "
          f"{[k[0] for k in win.kept]} check_s {check_s}", file=sys.stderr)
    print("setup_s " + " ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f" cell {setup_s:.3f}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


@dataclass
class RunRecord:
    """What the end-to-end readers read."""
    setup_s: float
    window: Window

    def rate(self) -> float:
        """The work of every completed call over the whole window, per
        second."""
        return self.window.work / self.window.elapsed
