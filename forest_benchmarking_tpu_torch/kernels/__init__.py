"""Build, load and launch the port's hand-written CUDA kernels.

This module is the one boundary between the ``ops/`` wrappers and the
kernels. Each source ``forest_benchmarking_tpu_torch/csrc/<name>.cu`` is
compiled on first use with ``nvcc`` for Hopper (``sm_90a``) into a shared
library of its own with a plain C interface, loaded with ``ctypes``; the
``nvcc`` processes of all sources run at once. The libraries land in
``build/kernels/`` beside the package, named by a hash of the flags, the
source and every file under ``csrc/`` that the source includes
(``#include "..."``), so an edited source or header builds anew and an
unchanged one loads at once. ``ENTRIES`` declares every ``extern "C"``
function once; :func:`check_operand` checks a tensor before its pointer is
passed, and :func:`launch` makes the call. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import types
from pathlib import Path

import torch

__all__ = ["ApgSchedule", "ENTRIES", "load", "build_log", "check_operand",
           "launch", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_PHASES = 8   # must match APG_MAX_PHASES in csrc/apg_fused.cu


class ApgSchedule(ctypes.Structure):
    """Host mirror of ``struct ApgSchedule`` in ``csrc/apg_fused.cu``: its
    two parts, ``ApgPhases`` and ``ApgSweepsRest``, end to end."""
    _fields_ = [
        ("n_phases", ctypes.c_int),
        ("outer", ctypes.c_int * MAX_PHASES),
        ("dykstra", ctypes.c_int * MAX_PHASES),
        ("sweeps", ctypes.c_int * MAX_PHASES),
        ("init_iters", ctypes.c_int),
        ("init_sweeps", ctypes.c_int),
        ("final_iters", ctypes.c_int),
        ("final_sweeps", ctypes.c_int),
        ("inv_mu", ctypes.c_float),
        ("sweeps_rest", ctypes.c_int * MAX_PHASES),
        ("final_sweeps_rest", ctypes.c_int),
    ]


_PTR, _INT = ctypes.c_void_p, ctypes.c_int

# {extern "C" function: (source stem, argtypes, restype)}. Every launch
# function takes PyTorch's current stream last and returns a cudaError_t.
ENTRIES = {
    "apg_fused_launch": ("apg_fused", [_PTR] * 9 + [_INT] * 3 + [
        ctypes.POINTER(ApgSchedule), _PTR], _INT),
    "cp_project_launch": ("apg_fused", [_PTR] * 2 + [_INT] * 2 + [_PTR], _INT),
    "traj_probs_launch": ("qv_traj", [_PTR] * 5 + [_INT] * 4 + [_PTR], _INT),
    "ideal_probs_launch": ("qv_traj", [_PTR] * 3 + [_INT] * 2 + [_PTR], _INT),
    "heavy_tallies_launch": ("qv_shots", [_PTR] * 4 + [_INT] * 4 + [_PTR],
                             _INT),
    "fbt_cuda_error_string": ("apg_fused", [_INT], ctypes.c_char_p),
}


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def _inputs(src: Path, csrc: Path) -> list:
    """``src`` and every file under ``csrc`` that it includes, directly or
    through another include, in a fixed order."""
    seen, todo = set(), [src.resolve()]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _INCLUDE.findall(path.read_text()):
            inc = (path.parent / name).resolve()
            if inc.is_file() and csrc in inc.parents:
                todo.append(inc)
    return sorted(seen)


def _lib_paths(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> dict:
    """{source stem: library path} for every ``.cu`` source in ``csrc``."""
    csrc = csrc.resolve()
    paths = {}
    for src in sorted(csrc.glob("*.cu")):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in _inputs(src, csrc):
            h.update(path.relative_to(csrc).as_posix().encode() + b"\0")
            h.update(path.read_bytes())
        name = f"libfbt_{src.stem}_{h.hexdigest()[:16]}.so"
        paths[src.stem] = build_dir / name
    return paths


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def _build(paths: dict) -> None:
    """Compile every source at once, each into its library and its log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        try:
            for stem in paths:
                so = os.path.join(tmp, stem + ".so")
                procs[stem] = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                     str(CSRC / f"{stem}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs = {stem: proc.communicate()[0] for stem, proc in procs.items()}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for stem, path in paths.items():
            path.with_suffix(".log").write_text(logs[stem])
        failed = [stem for stem, proc in procs.items() if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(
                f"== {stem}.cu\n{logs[stem]}" for stem in failed))
        for stem, path in paths.items():
            os.replace(os.path.join(tmp, stem + ".so"), path)   # atomic


@functools.lru_cache(maxsize=None)
def load() -> types.SimpleNamespace:
    """Build (if needed) and load the kernel libraries; the functions of
    ``ENTRIES``, typed, cached per process."""
    paths = _lib_paths()
    if not all(path.exists() for path in paths.values()):
        _build(paths)
    libs = {stem: ctypes.CDLL(str(path)) for stem, path in paths.items()}
    fns = {}
    for name, (stem, argtypes, restype) in ENTRIES.items():
        fn = fns[name] = getattr(libs[stem], name)
        fn.argtypes, fn.restype = argtypes, restype
    return types.SimpleNamespace(**fns)


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of the sources, or '' if not built."""
    return "".join(f"== {stem}.cu\n{path.with_suffix('.log').read_text()}"
                   for stem, path in _lib_paths().items()
                   if path.with_suffix(".log").exists())


def check_operand(name: str, x: torch.Tensor, device: torch.device,
                  dtype: torch.dtype, shape) -> None:
    """Raise unless ``x`` is a CUDA tensor on ``device`` of ``dtype`` and
    ``shape``: what every kernel asks of a tensor whose pointer it gets."""
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be on {device} (a CUDA tensor), got "
                         f"{x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the launch function ``entry`` of ``ENTRIES`` with ``args`` and
    PyTorch's current stream, with ``device`` the current device. A CUDA
    error it returns raises RuntimeError."""
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        kernel = entry.removesuffix("_launch")
        raise RuntimeError(
            f"{kernel} kernel launch failed: CUDA error {err} "
            f"({lib.fbt_cuda_error_string(err).decode()})")
