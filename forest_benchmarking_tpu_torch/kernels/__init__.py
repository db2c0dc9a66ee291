"""Build and load the port's hand-written CUDA kernels.

The sources under ``forest_benchmarking_tpu_torch/csrc/`` are compiled on
first use with ``nvcc`` for Hopper (``sm_90a``) into one shared library with
a plain C interface, loaded with ``ctypes``. The library lands in
``build/kernels/`` beside the package, named by a hash of the sources and the
flags, so an edited source builds anew and an unchanged one loads at once.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["ApgSchedule", "load", "build_log", "error_string", "CSRC",
           "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_PHASES = 8   # must match APG_MAX_PHASES in csrc/apg_fused.cu


class ApgSchedule(ctypes.Structure):
    """Host mirror of ``struct ApgSchedule`` in ``csrc/apg_fused.cu``."""
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
    ]


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfbt_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def _build(lib_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    lib_path = _lib_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.apg_fused_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ApgSchedule),
        ctypes.c_void_p]
    lib.apg_fused_launch.restype = ctypes.c_int
    lib.fbt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fbt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of the current sources, or '' if not built here."""
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def error_string(code: int) -> str:
    """``cudaGetErrorString`` of a code returned by a launch function."""
    return load().fbt_cuda_error_string(code).decode()
