#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port's main path (BASELINE config 2).

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each of which must pass:

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build: compile the CUDA kernels from the sources in the checkout;
3. kernel against plain version, both fused schedules, at B = 256 and at
   the main path's B = 16384: the kernel's f32 result, the plain PyTorch
   version's f32 result and its f64 result, all on the card, from the same
   counts and warm start. Bar: the kernel's max elementwise deviation from
   f64 is at most 2 x the plain f32 deviation + 1e-5, and its
   trace-preserving (TP) violation is under 1e-5;
4. the main path at full size: A from ``process_tomo_A_matrix(2)``,
   B = 16384 problems, 2000 shots per setting, through
   ``tomography.pgdb_process_estimate_batched(method="apg",
   cp_method="pallas")`` with the headline and parity schedules; the kernel's
   launch counter, zeroed just before, must move for each, outputs must be
   finite, the mean relative Frobenius error against the true Choi matrices
   under 0.12 and the TP violation under 1e-5;
5. timing with CUDA events (one warm-up, median of 3) at B = 16384 of the
   warm start, of the kernel and of the plain version of the solve (both
   from the same warm start); the B = 16384 check of phase 3 uses the
   outputs of these timed runs.

The second-to-last line is the per-kernel JSON record (``max_abs_err``: the
largest |kernel - plain f64| of the B = 16384 check; ``ms``/``plain_ms``:
the headline schedule's solve times), the last line ``{"ok": true, ...}``.
Exits non-zero, printing no result, if CUDA is unavailable or any phase fails.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 2024
BATCH = 16384
SHOTS = 2000
CHECK_BATCH = 256
SCHEDULES = ("headline", "parity")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def tp_violation(est: torch.Tensor) -> float:
    """max |Tr_out(E) - I| over a (B, 16, 16) batch of Choi matrices."""
    pt = torch.diagonal(est.reshape(-1, 4, 4, 4, 4), dim1=2, dim2=4).sum(-1)
    return (pt - torch.eye(4, device=est.device)).abs().max().item()


def rel_frobenius(est: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    return (torch.linalg.norm(est - truth, dim=(1, 2))
            / torch.linalg.norm(truth, dim=(1, 2)))


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


def against_plain(lanes_apg, name, kern, in32, in64, n, cfg, plain32=None):
    """Hold the kernel's (B, 16, 16) result on counts ``n`` against the plain
    version's f32 and f64 solves from the same warm start; returns
    max |kernel - plain f64|."""
    if plain32 is None:
        rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, n, 4)
        plain32 = torch.complex(*lanes_apg.apg_fused_reference(
            in32.ar, in32.ai, n, *rho0, dim=4, **cfg))
    n64 = n.double()
    rho0 = lanes_apg.linear_inversion_start(in64.a_pinv, n64, 4)
    plain64 = torch.complex(*lanes_apg.apg_fused_reference(
        in64.ar, in64.ai, n64, *rho0, dim=4, **cfg))
    torch.cuda.synchronize()
    dev_k = (kern.to(plain64.dtype) - plain64).abs().max().item()
    dev_p = (plain32.to(plain64.dtype) - plain64).abs().max().item()
    err = (kern - plain32).abs().max().item()
    tp = tp_violation(kern)
    print(f"check {name}: B={n.shape[0]} max|kernel-f64|={dev_k:.3e} "
          f"max|plain32-f64|={dev_p:.3e} (bar {2 * dev_p + 1e-5:.3e}) "
          f"max|kernel-plain32|={err:.3e} TP violation={tp:.3e}")
    check(bool(torch.isfinite(kern).all()), f"{name}: non-finite output")
    check(dev_k <= 2 * dev_p + 1e-5,
          f"{name}: kernel deviates from f64 by {dev_k:.3e} > "
          f"2 x {dev_p:.3e} + 1e-5")
    check(tp < 1e-5, f"{name}: kernel TP violation {tp:.3e}")
    return dev_k


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from forest_benchmarking_tpu_torch import kernels, tomography
    from forest_benchmarking_tpu_torch.benchmarks import (
        inputs_from_numpy, process_tomo_A_matrix, synth_process_datasets)
    from forest_benchmarking_tpu_torch.ops import lanes_apg

    dev = torch.device("cuda", 0)
    configs = {"headline": lanes_apg.HEADLINE_TUNED_2Q,
               "parity": lanes_apg.PARITY_TUNED_2Q}

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch device: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    a_np = process_tomo_A_matrix(2)
    in32 = inputs_from_numpy(a_np, np.zeros((1, a_np.shape[0])), device=dev)
    in64 = inputs_from_numpy(a_np, np.zeros((1, a_np.shape[0])), device=dev,
                             dtype=torch.float64)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # 3. kernel against plain version at B = 256 (B = 16384 in phase 5)
    n_chk, _ = synth_process_datasets(gen, in32.a, 4, CHECK_BATCH, SHOTS)
    for name in SCHEDULES:
        cfg = configs[name]
        kern = lanes_apg.apg_fused(in32.a, n_chk, 4, a_pinv=in32.a_pinv, **cfg)
        against_plain(lanes_apg, name, kern, in32, in64, n_chk, cfg)

    # 4. the main path at full size
    a = torch.tensor(a_np, dtype=torch.complex64, device=dev)
    n, chois = synth_process_datasets(gen, a, 4, BATCH, SHOTS)
    torch.cuda.synchronize()
    lanes_apg.apg_fused.launches = 0
    results = {}
    for name in SCHEDULES:
        before = lanes_apg.apg_fused.launches
        est = tomography.pgdb_process_estimate_batched(
            a, n, dim=4, method="apg", cp_method="pallas",
            fused_schedule=name)
        torch.cuda.synchronize()
        results[name] = (lanes_apg.apg_fused.launches - before, est)
    launches = lanes_apg.apg_fused.launches
    for name in SCHEDULES:
        moved, est = results[name]
        err = rel_frobenius(est, chois)
        tp = tp_violation(est)
        print(f"main path {name}: B={BATCH} shots={SHOTS} launches={moved} "
              f"mean rel Frobenius err={err.mean().item():.5f} "
              f"TP violation={tp:.3e}")
        check(moved > 0, f"{name}: the kernel was not launched")
        check(est.shape == (BATCH, 16, 16), f"{name}: shape {est.shape}")
        check(bool(torch.isfinite(est).all()), f"{name}: non-finite output")
        check(err.mean().item() < 0.12,
              f"{name}: mean relative Frobenius error {err.mean().item()}")
        check(tp < 1e-5, f"{name}: TP violation {tp:.3e}")

    # 5. timing at full size, and the kernel against plain version there
    ms_w, rho0 = cuda_ms(
        lambda: lanes_apg.linear_inversion_start(in32.a_pinv, n, 4))
    print(f"timing warm start: B={BATCH} {ms_w:.3f} ms on {card}")
    timing, max_abs_err = {}, 0.0
    for name in SCHEDULES:
        cfg = configs[name]
        ms_k, kern = cuda_ms(lambda: lanes_apg.apg_fused_kernel(
            in32.ar, in32.ai, n, *rho0, dim=4, **cfg))
        ms_p, plain32 = cuda_ms(lambda: lanes_apg.apg_fused_reference(
            in32.ar, in32.ai, n, *rho0, dim=4, **cfg))
        timing[name] = (ms_k, ms_p)
        print(f"timing {name}: B={BATCH} kernel {ms_k:.3f} ms "
              f"({BATCH / ms_k * 1e3:.0f} solves/s), plain {ms_p:.3f} ms "
              f"({BATCH / ms_p * 1e3:.0f} solves/s) on {card}")
        max_abs_err = max(max_abs_err, against_plain(
            lanes_apg, name, torch.complex(*kern), in32, in64, n, cfg,
            plain32=torch.complex(*plain32)))

    print(json.dumps({"kernels": [{
        "name": "apg_fused",
        "route": "cuda",
        "source": "forest_benchmarking_tpu_torch/csrc/apg_fused.cu",
        "replaces": "forest_benchmarking_tpu/ops/lanes_apg.py:674",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": timing["headline"][0],
        "plain_ms": timing["headline"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
