"""Readings that the limits of a cell's check are set from, on the card.

For each seed, in one process: the cell's set-up and a short window of its
own traffic, then the numbers of its check (the program against the plain
reference) and, for the control seeds, the same numbers with the control
(the reference in the precision below the configuration's) in the
program's place, on the same kept calls. One JSON line a seed::

    python3 qcvv_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 3

The benchmark's own runs do not run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from qcvv_bench import harness  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    options = harness.Options()
    benchmark = harness.read_json(options.root / "BENCHMARK.json")
    cell = harness.find_cell(options, benchmark, args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        sut, _, win = harness.set_up_and_run(cell, seed, device,
                                             args.seconds)
        t1 = time.perf_counter()
        line = {"seed": seed, "calls": len(win.seconds),
                "failed": win.failed, "kept": [k[0] for k in win.kept],
                "program": sut.check(win.kept),
                "check_s": time.perf_counter() - t1}
        if seed in args.control_seeds:
            t2 = time.perf_counter()
            line["control"] = sut.control(win.kept)
            line["control_s"] = time.perf_counter() - t2
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del sut, win
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
