#!/usr/bin/env python3
"""Time the trajectory kernel of ``csrc/qv_traj.cu`` beside an earlier
version of it, in alternating pairs on one card.

The earlier version is the one that took, per layer, the W_k = K_k U and
M'_k = U^dag K_k^dag K_k U planes its wrapper formed with batched matrix
products (``traj_probs_launch(hmaps, planes, uniforms, out, circuits,
depth, n_kraus, trajectories, stream)``). Put its source in a git-ignored
directory and pass it:

    mkdir -p build/qv_old
    git show 291f212:forest_benchmarking_tpu_torch/csrc/qv_traj.cu \\
        > build/qv_old/qv_traj.cu
    python3 scripts/qv_traj_ab.py --old build/qv_old/qv_traj.cu --pairs 2

At depth 8, C = 1600 circuits, T = 1000 trajectories and 2% two-qubit
depolarizing noise, each pair times old, new, new, old (one launch each
after a warm-up, CUDA events), the kernel alone and its wrapper (the old
wrapper with its plane layout, the new one with the index maps alone).
Prints every time, the medians, and the share of trajectories on which the
two kernels agree within 1e-4. Exits non-zero without a card.
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

DEPTH, CIRCUITS, TRAJ, DEPOL, SEED = 8, 1600, 1000, 0.02, 2024


def old_planes(pallas_traj, gates, kraus):
    """The earlier wrapper's layout: (C, d, 4, d//2 * K * 16) float32 planes
    (W real and imaginary as [slot][k][ab], M' real and imaginary as
    [slot][ab][k]), formed with batched matrix products."""
    c, depth, slots = gates.shape[:3]
    w, mp = pallas_traj._fused_channel_ops(gates, kraus)
    w = w.reshape(c, depth, -1)
    mt = mp.reshape(c, depth, slots, kraus.shape[0], 16).transpose(
        -1, -2).reshape(c, depth, -1)
    return torch.stack([w.real, w.imag, mt.real, mt.imag], dim=2).contiguous()


def build_old(source: Path, kernels) -> ctypes.CDLL:
    out = ROOT / "build" / "qv_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libqv_old.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(source)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.traj_probs_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    dll.traj_probs_launch.restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="source of the earlier qv_traj.cu")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qv_traj_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from forest_benchmarking_tpu_torch import kernels, quantum_volume
    from forest_benchmarking_tpu_torch.ops import pallas_traj
    from forest_benchmarking_tpu_torch.ops.random_operators import (
        haar_rand_unitary)
    from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    old = build_old(args.old, kernels)
    kernels.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    perms = quantum_volume._sample_perms(gen, CIRCUITS, DEPTH)
    gates = haar_rand_unitary(gen, 4, batch=(CIRCUITS, DEPTH, DEPTH // 2),
                              dtype=torch.float32)
    ks = depolarizing_kraus_map(DEPOL)
    kraus = torch.tensor(np.stack([np.kron(x, y) for x in ks for y in ks]),
                         dtype=torch.complex64, device=dev)
    uni = torch.rand((CIRCUITS, DEPTH, DEPTH // 2, TRAJ), generator=gen,
                     device=dev)
    new_in = pallas_traj._traj_kernel_inputs(perms, gates, kraus, uni, DEPTH)

    def old_launch(hmaps, planes):
        out = torch.empty((CIRCUITS, 2 ** DEPTH, TRAJ), device=dev)
        err = old.traj_probs_launch(
            hmaps.data_ptr(), planes.data_ptr(), uni.data_ptr(),
            out.data_ptr(), CIRCUITS, DEPTH, kraus.shape[0], TRAJ,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old kernel: CUDA error {err}")
        return out

    hmaps = new_in[0]
    planes = old_planes(pallas_traj, gates, kraus)
    runs = {
        "old kernel": lambda: old_launch(hmaps, planes),
        "old wrapper": lambda: old_launch(
            pallas_traj._boundary_maps(perms, DEPTH).to(torch.int32)
            .contiguous(), old_planes(pallas_traj, gates, kraus)),
        "new kernel": lambda: pallas_traj._traj_launch(*new_in, DEPTH),
        "new wrapper": lambda: pallas_traj.traj_probs_kernel(
            perms, gates, kraus, uni, DEPTH),
    }

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    ref, new = runs["old kernel"](), runs["new kernel"]()
    col = (new - ref).abs().amax(dim=1)
    print(f"trajectories within 1e-4 of the old kernel: "
          f"{(col < 1e-4).float().mean().item():.6f}")
    del ref, new, col
    for fn in runs.values():
        fn()
    times = {name: [] for name in runs}
    order = ["old", "new", "new", "old"] * args.pairs
    for which in order:
        for part in ("kernel", "wrapper"):
            name = f"{which} {part}"
            ms, out = timed(runs[name])
            del out
            times[name].append(ms)
    for name, ts in times.items():
        print(f"{name}: " + " ".join(f"{t:.3f}" for t in ts)
              + f" ms; median {statistics.median(ts):.3f} ms")
    print(f"depth {DEPTH}, C = {CIRCUITS}, T = {TRAJ}, K = {kraus.shape[0]}; "
          f"new kernel / old kernel = "
          f"{statistics.median(times['new kernel']) / statistics.median(times['old kernel']):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
