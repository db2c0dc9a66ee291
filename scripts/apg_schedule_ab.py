#!/usr/bin/env python3
"""The dim = 4 fused APG kernel of ``csrc/apg_fused.cu`` beside an earlier
source of it whose schedule had one Jacobi sweep count per projection:
bitwise equality of the estimates on the shipped schedules, and their
times in alternating pairs on one card.

The earlier source takes ``struct ApgSchedule {n_phases, outer[8],
dykstra[8], sweeps[8], init_iters, init_sweeps, final_iters,
final_sweeps, inv_mu}``. Put it in a git-ignored directory and pass it:

    mkdir -p build/apg_old
    git show 291f212:forest_benchmarking_tpu_torch/csrc/apg_fused.cu \\
        > build/apg_old/apg_fused.cu
    python3 scripts/apg_schedule_ab.py --old build/apg_old/apg_fused.cu

On config-2 data (A from ``process_tomo_A_matrix(2)``, B = 16384 datasets
of 2000 shots, seed 2024, linear-inversion warm start), both builds are
launched through their C entry points with the same A, Aᵀ (formed once,
outside the timed window), counts and start, on ``HEADLINE_TUNED_2Q`` and
``PARITY_TUNED_2Q``. Prints the card and power limit, whether the
estimates are bitwise equal, every time (CUDA events, one launch each, in
the order old, new, new, old per pair) and the medians. Exits non-zero
without a card or if the estimates differ.
"""
import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED, BATCH, SHOTS = 2024, 16384, 2000


def old_schedule_type(max_phases: int):
    class OldSchedule(ctypes.Structure):
        _fields_ = [("n_phases", ctypes.c_int),
                    ("outer", ctypes.c_int * max_phases),
                    ("dykstra", ctypes.c_int * max_phases),
                    ("sweeps", ctypes.c_int * max_phases),
                    ("init_iters", ctypes.c_int),
                    ("init_sweeps", ctypes.c_int),
                    ("final_iters", ctypes.c_int),
                    ("final_sweeps", ctypes.c_int),
                    ("inv_mu", ctypes.c_float)]
    return OldSchedule


def fill(sched_type, cfg, split_fields: bool):
    sch = sched_type(n_phases=len(cfg["phases"]), init_iters=cfg["init_iters"],
                     init_sweeps=cfg["init_sweeps"],
                     final_iters=cfg["final_iters"],
                     final_sweeps=cfg["final_sweeps"], inv_mu=1.0 / cfg["mu"])
    for k, (outer, ld, sweeps) in enumerate(cfg["phases"]):
        sch.outer[k], sch.dykstra[k], sch.sweeps[k] = outer, ld, sweeps
        if split_fields:
            sch.sweeps_rest[k] = sweeps
    if split_fields:
        sch.final_sweeps_rest = cfg["final_sweeps"]
    return sch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="source of the earlier apg_fused.cu")
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("apg_schedule_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from forest_benchmarking_tpu_torch import kernels
    from forest_benchmarking_tpu_torch.benchmarks import (
        inputs_from_numpy, process_tomo_A_matrix, synth_process_datasets)
    from forest_benchmarking_tpu_torch.ops import lanes_apg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out_dir = ROOT / "build" / "apg_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_old = out_dir / "libapg_old.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib_old), str(args.old)], check=True,
                   capture_output=True)
    old_type = old_schedule_type(kernels.MAX_PHASES)
    libs = {"old": (ctypes.CDLL(str(lib_old)), old_type),
            "new": (kernels.load(), kernels.ApgSchedule)}
    for lib, sched_type in libs.values():
        lib.apg_fused_launch.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 3 + [ctypes.POINTER(sched_type), ctypes.c_void_p]
        lib.apg_fused_launch.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    a_np = process_tomo_A_matrix(2)
    inp = inputs_from_numpy(a_np, np.zeros((1, a_np.shape[0])), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, _ = synth_process_datasets(gen, inp.a, 4, BATCH, SHOTS)
    rho0 = lanes_apg.linear_inversion_start(inp.a_pinv, n, 4)
    at = (inp.ar.T.contiguous(), inp.ai.T.contiguous())
    schedules = {"headline": lanes_apg.HEADLINE_TUNED_2Q,
                 "parity": lanes_apg.PARITY_TUNED_2Q}

    def launch(which, cfg):
        lib, sched_type = libs[which]
        sch = fill(sched_type, cfg, split_fields=which == "new")
        out_r, out_i = torch.empty_like(rho0[0]), torch.empty_like(rho0[1])
        err = lib.apg_fused_launch(
            inp.ar.data_ptr(), inp.ai.data_ptr(), at[0].data_ptr(),
            at[1].data_ptr(), n.data_ptr(), rho0[0].data_ptr(),
            rho0[1].data_ptr(), out_r.data_ptr(), out_i.data_ptr(), BATCH,
            a_np.shape[0], 4, ctypes.byref(sch),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{which} kernel: CUDA error {err}")
        return torch.complex(out_r, out_i)

    same = True
    for name, cfg in schedules.items():
        eq = torch.equal(launch("old", cfg), launch("new", cfg))
        same &= eq
        print(f"{name}: estimates bitwise equal: {eq}")

    times = {(w, s): [] for w in libs for s in schedules}
    for which in ["old", "new", "new", "old"] * args.pairs:
        for name, cfg in schedules.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(which, cfg)
            end.record()
            torch.cuda.synchronize()
            times[which, name].append(start.elapsed_time(end))
    for (which, name), ts in times.items():
        print(f"{which} {name}: " + " ".join(f"{t:.3f}" for t in ts)
              + f" ms; median {statistics.median(ts):.3f} ms")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
