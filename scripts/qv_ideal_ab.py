#!/usr/bin/env python3
"""Time the ideal kernel of ``csrc/qv_traj.cu`` beside an earlier version
of it, in alternating pairs on one card.

The earlier version is the one that took (C, d+1, 2^d) int32 index maps and
(C, d, d//2, 2, 16) float32 gate planes, both formed by its wrapper
(``ideal_probs_launch(hmaps, planes, out, circuits, depth, stream)``). Put
its source in a git-ignored directory and pass it:

    mkdir -p build/qv_old
    git show 78ca825:forest_benchmarking_tpu_torch/csrc/qv_traj.cu \\
        > build/qv_old/qv_traj.cu
    python3 scripts/qv_ideal_ab.py --old build/qv_old/qv_traj.cu

At C = 1600 circuits, at depth 8 and at depth 4, each pair times old, new,
new, old: the kernel alone and its wrapper (the old wrapper forms the maps
and planes, the new one passes the permutations and gates as they are),
each as the mean of calls enqueued behind a device sleep
(``chip_smoke.queued_ms``: ``QUEUED`` kernel launches, ``WRAPPER_CALLS``
wrapper calls), beside the host's time per call.
Prints every time, the medians and the largest |old - new|, and whether
the trajectory kernel's SASS (``cuobjdump -sass``, beside ``nvcc``) is the
same in both builds at every depth: the two kernels share the layout
helpers of the source. Exits non-zero without a card.
"""
import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import QUEUED, queued_ms  # noqa: E402

CIRCUITS, SEED = 1600, 2024
# wrapper calls a sample: the old wrapper makes ~60 launches a call, and the
# queue behind the device sleep has to hold them all
WRAPPER_CALLS = 10


def build_old(source: Path, kernels):
    """(the loaded library of the earlier source, its path)."""
    out = ROOT / "build" / "qv_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libqv_ideal_old.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(source)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.ideal_probs_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    dll.ideal_probs_launch.restype = ctypes.c_int
    return dll, lib


def traj_sass(lib: Path, nvcc: str) -> dict:
    """{depth: SASS lines of traj_probs_kernel<depth> in ``lib``}, without
    what depends on the rest of the module: addresses, encodings, the
    source file's hash in internal names and the numbers of labels."""
    dump = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for block in dump.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        m = re.search(r"traj_probs_kernelILi(\d+)E", name)
        if m:
            body = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", body)
            body = re.sub(r"\.L_x_\d+", ".L_x", body)
            out[int(m.group(1))] = [
                line for line in (re.sub(r"/\*[^*]*\*/", "", x).strip()
                                  for x in body.splitlines()) if line]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="source of the earlier qv_traj.cu")
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qv_ideal_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from forest_benchmarking_tpu_torch import kernels, quantum_volume
    from forest_benchmarking_tpu_torch.ops import pallas_traj
    from forest_benchmarking_tpu_torch.ops.random_operators import (
        haar_rand_unitary)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    old, old_lib = build_old(args.old, kernels)
    kernels.load()
    sass = [traj_sass(lib, kernels._nvcc()) for lib in (
        old_lib, kernels._lib_paths()["qv_traj"])]
    same = {d: sass[0][d] == sass[1].get(d) for d in sorted(sass[0])}
    print(f"traj_probs_kernel SASS the same in both builds, by depth: {same}")
    for d in (d for d, ok in same.items() if not ok):
        a, b = sass[0][d], sass[1].get(d, [])
        first = next(((x, y) for x, y in zip(a, b) if x != y), None)
        print(f"  depth {d}: {len(a)} / {len(b)} instructions, first "
              f"difference {first}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for depth in (8, 4):
        slots = depth // 2
        perms = quantum_volume._sample_perms(gen, CIRCUITS, depth)
        gates = haar_rand_unitary(gen, 4, batch=(CIRCUITS, depth, slots),
                                  dtype=torch.float32)

        def old_launch(hmaps, planes):
            out = torch.empty((CIRCUITS, 2 ** depth), device=dev)
            err = old.ideal_probs_launch(
                hmaps.data_ptr(), planes.data_ptr(), out.data_ptr(), CIRCUITS,
                depth, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"old kernel: CUDA error {err}")
            return out

        def old_inputs():
            hmaps = pallas_traj._boundary_maps(perms, depth).to(
                torch.int32).contiguous()
            planes = torch.stack([gates.real, gates.imag], dim=-3).reshape(
                CIRCUITS, depth, slots, 2, 16).contiguous()
            return hmaps, planes

        old_in = old_inputs()
        new_in = pallas_traj._ideal_kernel_inputs(perms, gates, depth)
        runs = {
            "old kernel": lambda: old_launch(*old_in),
            "old wrapper": lambda: old_launch(*old_inputs()),
            "new kernel": lambda: pallas_traj._ideal_launch(*new_in, depth),
            "new wrapper": lambda: pallas_traj.ideal_probs_kernel(
                perms, gates, depth),
        }
        diff = (runs["old kernel"]() - runs["new kernel"]()).abs().max().item()
        print(f"depth {depth}: max|old - new| = {diff:.3e}")
        times = {name: [] for name in runs}
        host = {name: [] for name in runs}
        for which in ["old", "new", "new", "old"] * args.pairs:
            for part in ("kernel", "wrapper"):
                name = f"{which} {part}"
                ms, host_ms = queued_ms(runs[name], launches=(
                    QUEUED if part == "kernel" else WRAPPER_CALLS))
                times[name].append(ms)
                host[name].append(host_ms)
        for name, ts in times.items():
            print(f"depth {depth} {name}: " + " ".join(f"{t:.4f}" for t in ts)
                  + f" ms; median {statistics.median(ts):.4f} ms; host "
                  f"{statistics.median(host[name]):.4f} ms a call")
        med = {name: statistics.median(ts) for name, ts in times.items()}
        print(f"depth {depth}, C = {CIRCUITS}: new kernel / old kernel = "
              f"{med['new kernel'] / med['old kernel']:.3f}; new wrapper / "
              f"old wrapper = {med['new wrapper'] / med['old wrapper']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
