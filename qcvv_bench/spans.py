"""Where a cell's calls spend their time, by the program's spans.

``python3 qcvv_bench/spans.py --workload <cell> --seed <n>``, from the root
of a checkout, on the card: sets the cell up from the seed as a run does,
then traces one warm-up call and the cell's ``trace_calls`` calls as a
traced run's stretch (each in the harness's spans ``qcvv.call`` >
``qcvv.entry``, ``qcvv.fetch``) and prints one JSON line: the card, the
stretch's calls, their mean host milliseconds, the device operations a call
and those with no launching host event, and for each program span
(``fbt.*``) and ``outside``: its count, and a call's host, device and idle
milliseconds, launches and synchronizations
(:mod:`qcvv_bench.program_spans`). Nothing is checked against the
reference, and no metric of the benchmark is read.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from qcvv_bench import harness, program_spans, tracing  # noqa: E402


def trace_cell(cell: harness.Cell, seed: int,
               device: torch.device) -> program_spans.SpanSummary:
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    traffic = cell.workload["traffic_params"]
    sut = cell.program.setup(cell.config, traffic, seed, device,
                             cell.reference)
    calls = int(traffic["trace_calls"])
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, schedule=schedule(
            wait=0, warmup=1, active=calls, repeat=1)) as prof:
        for i in range(calls + 1):
            with record_function(tracing.CALL_SPAN):
                with record_function("qcvv.entry"):
                    out = sut.entry(i)
                with record_function("qcvv.fetch"):
                    sut.fetch(out)
            del out
            prof.step()
    return program_spans.summarize(program_spans.events_from_profile(prof))


def per_call(summary: program_spans.SpanSummary) -> dict:
    n = summary.trace.calls
    return {name: {"count": s.count, "host_ms": 1e3 * s.host_s / n,
                   "device_ms": 1e3 * s.device_s / n,
                   "idle_ms": 1e3 * s.idle_s / n, "launches": s.launches / n,
                   "syncs": s.syncs / n}
            for name, s in sorted(summary.spans.items())}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    options = harness.Options()
    cell = harness.find_cell(options,
                             harness.read_json(options.root / "BENCHMARK.json"),
                             args.workload)
    device = torch.device("cuda", 0)
    summary = trace_cell(cell, args.seed, device)
    trace = summary.trace
    if harness.trace_fault(trace):
        print(f"spans: {harness.trace_fault(trace)}", file=sys.stderr)
        return 4
    print(json.dumps({
        "card": torch.cuda.get_device_name(device), "workload": args.workload,
        "seed": args.seed, "calls": trace.calls,
        "call_ms": 1e3 * summary.call_s / trace.calls,
        "window_ms": 1e3 * trace.window_s,
        "idle_pct": trace.idle_pct(),
        "launches_per_call": trace.launches_per_call(),
        "unlinked": summary.unlinked, "spans": per_call(summary)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
