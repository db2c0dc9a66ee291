#!/usr/bin/env python3
"""The 1Q fused APG kernel and the CP projection kernel of
``csrc/apg_fused.cu`` beside an earlier source of the same file, timed in
alternating pairs on one card; and the 2Q kernel's estimates, which must be
bitwise those of the earlier source, with its times.

The earlier source must take the same ``ApgSchedule`` (phases, then the
split sweep counts) and ``cp_project_launch(h, out, batch, sweeps,
stream)``. Put it in a git-ignored directory and pass it:

    mkdir -p build/apg_old
    git show 897de34:forest_benchmarking_tpu_torch/csrc/apg_fused.cu \\
        > build/apg_old/apg_fused.cu
    python3 scripts/small_jacobi_ab.py --old build/apg_old/apg_fused.cu

Data, all on the card from seed 2024: 1Q, A from ``process_tomo_A_matrix(1)``
and B = 16384 datasets of 2000 shots with the linear-inversion warm start,
default schedule; CP, the linear-inversion estimates of B = 16384 config-2
datasets (A from ``process_tomo_A_matrix(2)``, 2000 shots), 6 sweeps; 2Q,
the same config-2 datasets on ``HEADLINE_TUNED_2Q`` and ``PARITY_TUNED_2Q``.
Both builds are launched through their C entry points on the same inputs
(Aᵀ formed once, outside the timed window). Each kernel is run once on
each build first (the 1Q and CP results' largest difference between the
builds is printed; the 2Q estimates must be bitwise equal), then timed with
CUDA events, one launch a run, in the order old, new, new, old per pair.

Prints the card and power limit, both builds' registers and spills for the
three kernels (ptxas), every time and the medians; the last line is a JSON
summary with ``new_faster``: every new run faster than every old run. Exits
non-zero without a card or if the 2Q estimates differ.
"""
import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED, BATCH, SHOTS, CP_SWEEPS = 2024, 16384, 2000, 6
KERNELS = ("apg_fused_1q_kernel", "cp_project_kernel", "apg_fused_kernel")


def ptxas(log: str) -> dict:
    """{mangled kernel name: (registers, spill stores, spill loads)} of
    the entry functions in a ``-Xptxas -v`` build log."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = re.search(r"'(\w+)'", line).group(1)
        elif name and "spill stores" in line:
            spills = tuple(int(x) for x in re.findall(r"(\d+) bytes", line)[1:3])
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[name] = (regs, *spills)
            name = None
    return out


def describe(regs: dict) -> str:
    return "; ".join(f"{kernel}{'<SPLIT>' if 'ILb1E' in name else ''}: {r} "
                     f"registers, {st}/{ld} B spill stores/loads"
                     for name, (r, st, ld) in sorted(regs.items())
                     for kernel in KERNELS if kernel in name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="source of the earlier apg_fused.cu")
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("small_jacobi_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from forest_benchmarking_tpu_torch import kernels
    from forest_benchmarking_tpu_torch.benchmarks import (
        inputs_from_numpy, process_tomo_A_matrix, synth_process_datasets)
    from forest_benchmarking_tpu_torch.ops import lanes_apg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out_dir = ROOT / "build" / "small_jacobi_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_old = out_dir / "libapg_old.so"
    built = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                            "-o", str(lib_old), str(args.old)],
                           capture_output=True, text=True, check=True)
    libs = {"old": ctypes.CDLL(str(lib_old)), "new": kernels.load()}
    print("ptxas old: " + describe(ptxas(built.stdout + built.stderr)))
    print("ptxas new: " + describe(ptxas(kernels.build_log())))
    for lib in libs.values():
        lib.apg_fused_launch.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 3 + [ctypes.POINTER(kernels.ApgSchedule),
                                 ctypes.c_void_p]
        lib.apg_fused_launch.restype = ctypes.c_int
        lib.cp_project_launch.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.cp_project_launch.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = {}
    for dim in (2, 4):
        a_np = process_tomo_A_matrix(dim // 2)
        inp = inputs_from_numpy(a_np, np.zeros((1, a_np.shape[0])),
                                device=dev)
        n, _ = synth_process_datasets(gen, inp.a, dim, BATCH, SHOTS)
        rho0 = lanes_apg.linear_inversion_start(inp.a_pinv, n, dim)
        at = (inp.ar.T.contiguous(), inp.ai.T.contiguous())
        cases[dim] = (inp, n, rho0, at)
    h_li = torch.complex(*cases[4][2]).contiguous()

    def schedule(cfg):
        cfg = dict(dict(phases=lanes_apg.PARITY_PHASES, init_iters=8,
                        init_sweeps=3, final_iters=20, final_sweeps=1,
                        mu=None), **cfg)
        dim_mu = cfg["mu"] if cfg["mu"] is not None else 3.0 / 8
        sch = kernels.ApgSchedule(
            n_phases=len(cfg["phases"]), init_iters=cfg["init_iters"],
            init_sweeps=cfg["init_sweeps"], final_iters=cfg["final_iters"],
            final_sweeps=cfg["final_sweeps"],
            final_sweeps_rest=cfg["final_sweeps"], inv_mu=1.0 / dim_mu)
        for k, (outer, ld, sweeps) in enumerate(cfg["phases"]):
            sch.outer[k], sch.dykstra[k], sch.sweeps[k] = outer, ld, sweeps
            sch.sweeps_rest[k] = sweeps
        return sch

    runs = {"apg_fused_1q": (2, schedule({})),
            "apg_fused headline": (4, schedule(lanes_apg.HEADLINE_TUNED_2Q)),
            "apg_fused parity": (4, schedule(lanes_apg.PARITY_TUNED_2Q))}

    def launch(which, name):
        lib = libs[which]
        stream = torch.cuda.current_stream().cuda_stream
        if name == "cp_project":
            out = torch.empty_like(h_li)
            err = lib.cp_project_launch(h_li.data_ptr(), out.data_ptr(),
                                        BATCH, CP_SWEEPS, stream)
        else:
            dim, sch = runs[name]
            inp, n, rho0, at = cases[dim]
            out_r, out_i = torch.empty_like(rho0[0]), torch.empty_like(rho0[1])
            at_ptrs = (at[0].data_ptr(), at[1].data_ptr()) if dim == 4 else (
                None, None)
            err = lib.apg_fused_launch(
                inp.ar.data_ptr(), inp.ai.data_ptr(), *at_ptrs,
                n.data_ptr(), rho0[0].data_ptr(), rho0[1].data_ptr(),
                out_r.data_ptr(), out_i.data_ptr(), BATCH,
                inp.ar.shape[0], dim, ctypes.byref(sch), stream)
            out = torch.complex(out_r, out_i)
        if err != 0:
            raise RuntimeError(f"{which} {name}: CUDA error {err}")
        return out

    names = ("apg_fused_1q", "cp_project", "apg_fused headline",
             "apg_fused parity")
    same = True
    for name in names:
        old, new = launch("old", name), launch("new", name)
        torch.cuda.synchronize()
        if name.startswith("apg_fused "):
            eq = torch.equal(old, new)
            same &= eq
            print(f"{name}: estimates bitwise equal between the builds: {eq}")
        else:
            print(f"{name}: max |new - old| = "
                  f"{(new - old).abs().max().item():.3e}, finite: "
                  f"{bool(torch.isfinite(new).all())}")

    times = {(w, s): [] for s in names for w in libs}
    for which in ["old", "new", "new", "old"] * args.pairs:
        for name in names:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(which, name)
            end.record()
            torch.cuda.synchronize()
            times[which, name].append(start.elapsed_time(end))
    summary = {}
    for name in names:
        old, new = times["old", name], times["new", name]
        for which, ts in (("old", old), ("new", new)):
            print(f"{which} {name}: " + " ".join(f"{t:.3f}" for t in ts)
                  + f" ms; median {statistics.median(ts):.3f} ms")
        summary[name] = {
            "old_ms": statistics.median(old), "new_ms": statistics.median(new),
            "ratio": statistics.median(new) / statistics.median(old),
            "new_faster": max(new) < min(old)}
    print(json.dumps({"batch": BATCH, "pairs": args.pairs,
                      "bitwise_2q": same, **summary}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
