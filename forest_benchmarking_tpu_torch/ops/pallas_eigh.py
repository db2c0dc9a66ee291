"""Batched 16x16 Hermitian CP projection by cyclic Jacobi: plain PyTorch
version and CUDA kernel wrapper.

Port of ``forest_benchmarking_tpu/ops/pallas_eigh.py``. The positive part
pos(H) = V relu(w) V^dag of each matrix comes from cyclic-Jacobi sweeps
started at V = I, without hermitianizing H first; the positive-part
semantics are those of
:func:`~forest_benchmarking_tpu_torch.ops.project_superoperators.proj_choi_to_completely_positive`.
The sweep is the fused APG solver's
(:func:`~forest_benchmarking_tpu_torch.ops.lanes_apg._multi_sweep`), and so
is the kernel's device code (``csrc/apg_fused.cu``).

:func:`cp_project_pallas` runs the hand-written CUDA kernel for a complex64
CUDA tensor and :func:`cp_project_reference` for a CPU tensor, or wherever
the tensor lies with ``use_pallas=False`` (the JAX function's switch). The
TPU-only argument ``block`` is not carried: the kernel takes any batch
size.
"""
from __future__ import annotations

import numpy as np
import torch

from forest_benchmarking_tpu_torch import kernels
from forest_benchmarking_tpu_torch.ops.lanes_apg import (
    _multi_sweep, _round_robin_pairs)

__all__ = ["round_robin_pairs", "cp_project_reference", "cp_project_pallas",
           "cp_project_flops", "jacobi_eigh_reference"]

N = 16  # matrix dimension the kernel is specialized for


def round_robin_pairs(n: int):
    """n-1 rounds of n/2 disjoint index pairs covering every pair once."""
    return _round_robin_pairs(n)


def cp_project_reference(h: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """Positive parts of (B, 16, 16) Hermitian matrices in plain PyTorch:
    ``sweeps`` Jacobi sweeps from V = I, then
    pos[i, j] = sum_k V[i, k] max(w_k, 0) conj(V[j, k]), accumulated over k
    in order, as the JAX ``_jacobi_pos_part`` does."""
    h_r, h_i = h.real, h.imag
    eps = 1e-30 if h_r.dtype == torch.float64 else 1e-18
    eye = torch.eye(N, dtype=h_r.dtype, device=h.device).expand(
        h.shape[0], N, N)
    a_r, _, v_r, v_i = _multi_sweep(h_r, h_i, eye, torch.zeros_like(eye), eps,
                                    sweeps)
    wpos = torch.diagonal(a_r, dim1=-2, dim2=-1).clamp(min=0.0)   # (B, 16)
    pos_r = torch.zeros_like(h_r)
    pos_i = torch.zeros_like(h_r)
    for k in range(N):
        w = wpos[:, k, None, None]
        ar = v_r[:, :, k, None] * w          # V[i, k] w_k, along i
        ai = v_i[:, :, k, None] * w
        br = v_r[:, None, :, k]              # conj(V[j, k]), along j
        bi = -v_i[:, None, :, k]
        pos_r = pos_r + ar * br - ai * bi
        pos_i = pos_i + ar * bi + ai * br
    return torch.complex(pos_r, pos_i).to(h.dtype)


def cp_project_flops(sweeps: int = 6) -> float:
    """Floating-point operations of one projection as the kernel computes
    it: ``sweeps`` sweeps of n - 1 rounds of rotations of M's columns and
    rows and V's columns (~36 n^2 per round), plus the reconstruction
    (8 n^3), n = 16; the count ``apg_fused_flops_per_solve`` uses."""
    return sweeps * 36.0 * N * N * (N - 1) + 8.0 * N ** 3


def cp_project_pallas(h: torch.Tensor, sweeps: int = 6, block: int = 128,
                      use_pallas: bool = True) -> torch.Tensor:
    """CP projection (positive part) of a batch of 16x16 Hermitian matrices.

    :param h: (B, 16, 16) complex tensor, read as given (not hermitianized).
    :param block: the JAX package's TPU batch tile, taken at its position;
        it changes nothing (the kernel runs one warp per matrix).
    :param use_pallas: False runs :func:`cp_project_reference` wherever
        ``h`` lies, the card included, at any complex dtype.
    :return: (B, 16, 16) positive parts, same dtype and device.

    On the card (complex64 only) this launches ``csrc/apg_fused.cu``'s
    ``cp_project_kernel``, one warp per matrix, and adds one to
    ``cp_project_pallas.launches``; on a CPU tensor it runs
    :func:`cp_project_reference`.
    """
    if h.dim() != 3 or tuple(h.shape[1:]) != (N, N):
        raise ValueError(f"h must have shape (B, {N}, {N}), got "
                         f"{tuple(h.shape)}")
    if h.device.type == "cpu" or (h.is_cuda and not use_pallas):
        return cp_project_reference(h, sweeps)
    if not h.is_cuda:
        raise ValueError(f"unsupported device {h.device}")
    if h.dtype != torch.complex64:
        raise TypeError(f"the CUDA kernel takes complex64, got {h.dtype}")
    # the data of a conjugate view holds the values before the conjugation
    h = h.resolve_conj().contiguous()
    out = torch.empty_like(h)
    lib = kernels.load()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cp_project_launch(h.data_ptr(), out.data_ptr(), h.shape[0],
                                    sweeps, stream)
    if err != 0:
        raise RuntimeError(f"cp_project kernel launch failed: CUDA error "
                           f"{err} ({kernels.error_string(err)})")
    cp_project_pallas.launches += 1
    return out


cp_project_pallas.launches = 0


def jacobi_eigh_reference(h: np.ndarray, sweeps: int = 8) -> np.ndarray:
    """Positive part of one 16x16 Hermitian numpy matrix by the same sweep
    schedule, in float64 on the CPU (for tests)."""
    x = torch.tensor(np.asarray(h, dtype=np.complex128))[None]
    return cp_project_reference(x, sweeps)[0].numpy()
