"""Build and load the port's hand-written CUDA kernels.

Each source ``forest_benchmarking_tpu_torch/csrc/<name>.cu`` is compiled on
first use with ``nvcc`` for Hopper (``sm_90a``) into a shared library of its
own with a plain C interface, loaded with ``ctypes``; the ``nvcc`` processes
of all sources run at once. The libraries land in ``build/kernels/`` beside
the package, named by a hash of the flags, the source and every file under
``csrc/`` that the source includes (``#include "..."``), so an edited source
or header builds anew and an unchanged one loads at once. ``load`` and
``build_log`` also take another source directory (a variant of ``csrc/``
to measure) and its own build directory. Nothing here runs at import time.
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

__all__ = ["ApgSchedule", "load", "build_log", "error_string", "CSRC",
           "BUILD_DIR"]

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


def _build(paths: dict, csrc: Path) -> None:
    """Compile every source at once, each into its library and its log."""
    build_dir = next(iter(paths.values())).parent
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        procs = {}
        try:
            for stem in paths:
                so, src = os.path.join(tmp, stem + ".so"), csrc / f"{stem}.cu"
                procs[stem] = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-shared", "-o", so, str(src)],
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
def load(csrc: Path = CSRC,
         build_dir: Path = BUILD_DIR) -> types.SimpleNamespace:
    """Build (if needed) and load the kernel libraries of the sources in
    ``csrc``; their launch functions, cached per process."""
    paths = _lib_paths(csrc, build_dir)
    if not all(path.exists() for path in paths.values()):
        _build(paths, csrc)
    apg, qv, shots = (ctypes.CDLL(str(paths[stem])) for stem in (
        "apg_fused", "qv_traj", "qv_shots"))
    apg.apg_fused_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 3 + [ctypes.POINTER(ApgSchedule), ctypes.c_void_p]
    apg.apg_fused_launch.restype = ctypes.c_int
    apg.cp_project_launch.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    apg.cp_project_launch.restype = ctypes.c_int
    qv.traj_probs_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    qv.traj_probs_launch.restype = ctypes.c_int
    qv.ideal_probs_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    qv.ideal_probs_launch.restype = ctypes.c_int
    shots.heavy_tallies_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    shots.heavy_tallies_launch.restype = ctypes.c_int
    apg.fbt_cuda_error_string.argtypes = [ctypes.c_int]
    apg.fbt_cuda_error_string.restype = ctypes.c_char_p
    return types.SimpleNamespace(
        apg_fused_launch=apg.apg_fused_launch,
        cp_project_launch=apg.cp_project_launch,
        traj_probs_launch=qv.traj_probs_launch,
        ideal_probs_launch=qv.ideal_probs_launch,
        heavy_tallies_launch=shots.heavy_tallies_launch,
        fbt_cuda_error_string=apg.fbt_cuda_error_string)


def build_log(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of the sources in ``csrc``, or '' if not built
    there."""
    return "".join(f"== {stem}.cu\n{path.with_suffix('.log').read_text()}"
                   for stem, path in _lib_paths(csrc, build_dir).items()
                   if path.with_suffix(".log").exists())


def error_string(code: int) -> str:
    """``cudaGetErrorString`` of a code returned by a launch function."""
    return load().fbt_cuda_error_string(code).decode()
