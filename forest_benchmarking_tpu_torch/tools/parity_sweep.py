"""f64 parity-margin sweep of the fused ``PARITY_TUNED_2Q`` schedule (CPU).

The port's counterpart of the JAX package's ``tools/parity_sweep.py``. For
each (seed, shots) dataset family it computes the tight-projection
converged reference optimum (PGDB with stop_tol=1e-14, maxiter=3000,
dyk_tol=1e-10, dyk_iters=500) and the fused parity schedule's estimate
(its plain version), both in float64 on the CPU, and reports the max
deviation of the second from the first. This is the robustness sweep
behind the < 1e-6 parity contract; run it after any change to
``PARITY_TUNED_2Q``.

Usage:
    python -m forest_benchmarking_tpu_torch.tools.parity_sweep [out.json]
        [--shots 750,1000,...] [--seeds 8] [--batch 4]

The counts of a family come from a ``torch.Generator`` seeded
``seed * 100_003 + shots``. Prints and writes one JSON line per dataset
family (``seed``, ``shots``, ``dev``, ``gold_secs``) and a summary
(``schedule``, ``n_datasets``, ``worst_dev``, ``worst_row``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Optional, Sequence

import torch

from forest_benchmarking_tpu_torch.benchmarks import (
    process_tomo_A_matrix, synth_process_datasets)
from forest_benchmarking_tpu_torch.ops.lanes_apg import (
    PARITY_TUNED_2Q, apg_fused)
from forest_benchmarking_tpu_torch.tomography import (
    pgdb_process_estimate_batched)

__all__ = ["main", "dataset_deviation", "DEFAULT_OUT"]

DEFAULT_OUT = "chiprun_out/parity_sweep.json"


def dataset_deviation(a: torch.Tensor, n: torch.Tensor) -> float:
    """Max |fused parity estimate - tight converged PGDB| over a batch of
    2Q counts ``n`` (B, R) of the complex128 A-matrix ``a``, on the CPU."""
    gold = pgdb_process_estimate_batched(
        a, n, dim=4, stop_tol=1e-14, maxiter=3000, dyk_tol=1e-10,
        dyk_iters=500)
    est = apg_fused(a, n, 4, use_pallas=False, **PARITY_TUNED_2Q)
    return float((est - gold).abs().max())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the sweep; return the summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--shots", default="750,1000,1500,2000,4000,8000")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    shot_counts = [int(s) for s in args.shots.split(",")]

    a = torch.tensor(process_tomo_A_matrix(2), dtype=torch.complex128)
    rows = []
    worst = (0.0, None)
    for seed in range(args.seeds):
        for shots in shot_counts:
            g = torch.Generator().manual_seed(seed * 100_003 + shots)
            n, _ = synth_process_datasets(g, a, 4, args.batch, shots,
                                          dtype=torch.float64)
            t0 = time.time()
            dev = dataset_deviation(a, n)
            row = {"seed": seed, "shots": shots, "dev": dev,
                   "gold_secs": round(time.time() - t0, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if dev > worst[0]:
                worst = (dev, row)
    summary = {"schedule": {k: (list(map(list, v)) if k == "phases" else v)
                            for k, v in PARITY_TUNED_2Q.items()},
               "n_datasets": len(rows), "worst_dev": worst[0],
               "worst_row": worst[1]}
    print(json.dumps(summary), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
        f.write(json.dumps(summary) + "\n")
    return summary


if __name__ == "__main__":
    main()
