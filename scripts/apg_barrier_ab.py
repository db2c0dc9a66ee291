#!/usr/bin/env python3
"""Block-wide against per-group barriers in the Dykstra steps of the dim = 4
fused APG kernel, timed alternately on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 scripts/apg_barrier_ab.py [--pairs 4]

``forest_benchmarking_tpu_torch/csrc/`` is built twice, each copy into its
own directory under ``build/barrier_ab/``: as it is ("group": the Dykstra
steps wait on the named barrier of their problem's 256 threads) and with
those steps on the block's ``__syncthreads`` ("block"). The passes over A
are block-wide in both. On config-2 data (A from ``process_tomo_A_matrix(2)``,
B = 16384 datasets of 2000 shots, seed 2024, linear-inversion warm start)
the kernel is timed on the headline and parity schedules and on one of 20
Dykstra iterations of one sweep and one pass over A, with CUDA events (one
warm-up, median of 3), through ``ops.lanes_apg.apg_fused_kernel``, in
``--pairs`` pairs of alternating order: group, block, then block, group,
and so on. Both variants must give bitwise the same estimates, since a
barrier does not change the arithmetic.

It prints the card and its power limit, each build's registers and spills,
every run, and per schedule each variant's median and range and the
group barriers' gain. The last line is that summary as JSON, with
``clears``: every group run faster than every block run. Exits non-zero
without CUDA or if the estimates differ.
"""
import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEED = 2024
BATCH = 16384
SHOTS = 2000
GROUP_LINE = "const GroupSync gsync{1 + g};"
BLOCK_LINE = "const BlockSync gsync{};"


def variant_sources(src: str) -> dict:
    """{variant: source of apg_fused.cu}: ``src`` as it is, and with the
    Dykstra steps of the dim = 4 kernel on block-wide barriers."""
    if src.count(GROUP_LINE) != 1:
        raise ValueError(f"apg_fused.cu must hold {GROUP_LINE!r} once")
    return {"group": src, "block": src.replace(GROUP_LINE, BLOCK_LINE)}


def cuda_ms(fn, reps: int = 3):
    """(median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    the last run's result)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs", type=int, default=4,
                        help="pairs of runs, each pair one group and one "
                             "block run, in alternating order")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("apg_barrier_ab: CUDA is not available", file=sys.stderr)
        return 1
    from forest_benchmarking_tpu_torch import kernels
    from forest_benchmarking_tpu_torch.benchmarks import (
        inputs_from_numpy, process_tomo_A_matrix, synth_process_datasets)
    from forest_benchmarking_tpu_torch.ops import lanes_apg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {}
    sources = variant_sources((kernels.CSRC / "apg_fused.cu").read_text())
    for name, text in sources.items():
        root = kernels.BUILD_DIR.parent / "barrier_ab" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(kernels.CSRC, root / "csrc")
        (root / "csrc" / "apg_fused.cu").write_text(text)
        libs[name] = kernels.load(root / "csrc", root / "kernels")
        log = kernels.build_log(root / "csrc", root / "kernels")
        apg_log = log.split("== qv_traj.cu")[0]
        for line in apg_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")

    dev = torch.device("cuda", 0)
    a_np = process_tomo_A_matrix(2)
    inp = inputs_from_numpy(a_np, np.zeros((1, a_np.shape[0])), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, _ = synth_process_datasets(gen, inp.a, 4, BATCH, SHOTS)
    rho0 = lanes_apg.linear_inversion_start(inp.a_pinv, n, 4)
    schedules = {
        "headline": lanes_apg.HEADLINE_TUNED_2Q,
        "parity": lanes_apg.PARITY_TUNED_2Q,
        "dykstra": dict(phases=(), init_iters=0, final_iters=20,
                        final_sweeps=1, mu=lanes_apg.HEADLINE_TUNED_2Q["mu"]),
    }
    times = {v: {s: [] for s in schedules} for v in libs}
    first = {}
    load = kernels.load
    try:
        for pair in range(args.pairs):
            for variant in (("group", "block") if pair % 2 == 0
                            else ("block", "group")):
                # the wrapper launches through kernels.load()
                kernels.load = lambda lib=libs[variant]: lib
                for sched, cfg in schedules.items():
                    ms, out = cuda_ms(lambda: lanes_apg.apg_fused_kernel(
                        inp.ar, inp.ai, n, *rho0, dim=4, **cfg))
                    times[variant][sched].append(ms)
                    first.setdefault((variant, sched), torch.complex(*out))
                    print(f"pair {pair} {variant} {sched}: B={BATCH} "
                          f"{ms:.3f} ms")
    finally:
        kernels.load = load

    summary = {}
    for sched in schedules:
        same = torch.equal(first["group", sched], first["block", sched])
        g, b = times["group"][sched], times["block"][sched]
        mg, mb = statistics.median(g), statistics.median(b)
        summary[sched] = {
            "group_ms": g, "block_ms": b, "group_median_ms": mg,
            "block_median_ms": mb, "group_range_ms": max(g) - min(g),
            "block_range_ms": max(b) - min(b),
            "gain": (mb - mg) / mb, "clears": max(g) < min(b),
            "bitwise_equal": same}
        print(f"{sched}: group median {mg:.3f} ms (range "
              f"{max(g) - min(g):.3f}), block median {mb:.3f} ms (range "
              f"{max(b) - min(b):.3f}), gain {100 * (mb - mg) / mb:.2f}%, "
              f"every group run faster than every block run: "
              f"{max(g) < min(b)}; estimates bitwise equal: {same}")
    print(json.dumps(summary))
    return 0 if all(s["bitwise_equal"] for s in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
