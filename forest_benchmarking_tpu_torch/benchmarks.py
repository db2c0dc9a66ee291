"""Benchmark problems: the 2Q process-tomography A-matrix, synthetic
count datasets, and the carry-across from numpy arrays for the config-2
(process MLE) and config-5 (quantum volume) paths.

Port of ``forest_benchmarking_tpu/benchmarks.py``. This system has no
weights: the A-matrix, its pseudo-inverse, the counts and the static solver
schedules, and the quantum-volume circuit stacks and branch uniforms, are the
state that carries across between the two packages.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.ops.lanes_apg import (
    full_f32_matmul, raster_a_matrix)
from forest_benchmarking_tpu_torch.ops.random_operators import (
    rand_map_with_BCSZ_dist)
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import vec
from forest_benchmarking_tpu_torch.tomography import (
    _pauli_process_tomo_settings, pgdb_a_row_pair, state_to_density)
from forest_benchmarking_tpu_torch.utils import pauli_string_to_matrix

__all__ = ["process_tomo_A_matrix", "synth_process_datasets",
           "split_complex", "join_complex", "SolveInputs", "inputs_from_numpy",
           "QVInputs", "qv_inputs_from_numpy"]


def split_complex(x: torch.Tensor) -> torch.Tensor:
    """Stack (real, imag) on a new leading axis."""
    return torch.stack([x.real, x.imag])


def join_complex(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_complex`."""
    return torch.complex(x[0], x[1])


@functools.lru_cache(maxsize=None)
def process_tomo_A_matrix(n_qubits: int) -> np.ndarray:
    """The (R, d^4) PGDB A-matrix for full Pauli-basis process tomography.

    Row pairs are the +/- projector rows of eq. A1 of [PGD] for each
    (input eigenstate, observable) setting; p = A vec(choi) gives outcome
    probabilities. Host numpy, cached; treat the result as read-only.
    """
    dim = 2 ** n_qubits
    eye = np.eye(dim)
    rows = []
    for states, obs in _pauli_process_tomo_settings(n_qubits):
        in_mat = state_to_density(states)
        op = pauli_string_to_matrix(obs)
        rows.extend(pgdb_a_row_pair(in_mat, op, eye))
    return np.stack(rows) / dim ** 2


def synth_process_datasets(generator: torch.Generator, a: torch.Tensor,
                           dim: int, batch: int, shots: int,
                           kraus_rank: Optional[int] = None,
                           dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``batch`` random CPTP channels and simulated count data.

    Draws on the generator's device; ``a`` is the (R, d^4) complex A-matrix
    on that device. Returns (n, true_chois): ``n`` is the (batch, R)
    normalized count vector fed to the solver, ``true_chois`` the
    (batch, d^2, d^2) ground-truth Choi matrices.
    """
    if kraus_rank is None:
        kraus_rank = dim * dim
    chois = rand_map_with_BCSZ_dist(generator, dim, kraus_rank,
                                    batch=(batch,), dtype=dtype)
    with full_f32_matmul():
        p = (vec(chois)[..., 0] @ a.to(chois.dtype).T).real     # (batch, R)
    p = p.clamp(0.0, 1.0)
    pp = p[:, 0::2]
    pm = p[:, 1::2]
    bern = pp / (pp + pm).clamp(min=1e-12)
    k = torch.binomial(torch.full_like(bern, float(shots)), bern,
                       generator=generator)
    counts = torch.stack([k, shots - k], dim=-1).reshape(batch, -1)
    grand_total = shots * pp.shape[1]
    return counts / grand_total, chois


class SolveInputs(NamedTuple):
    """The solver state carried over from the JAX package's numpy arrays."""
    a: torch.Tensor        # (R, d4) complex A-matrix, vec order
    ar: torch.Tensor       # (R, d4) real plane of A, raster order
    ai: torch.Tensor       # (R, d4) imaginary plane of A, raster order
    n: torch.Tensor        # (B, R) normalized counts
    a_pinv: torch.Tensor   # (d4, R) complex pseudo-inverse of A


def inputs_from_numpy(a: np.ndarray, n_counts: np.ndarray,
                      a_pinv: Optional[np.ndarray] = None, *,
                      device, dtype: torch.dtype = torch.float32) -> SolveInputs:
    """Turn the JAX package's (R, d^4) A-matrix and (B, R) counts, taken as
    numpy arrays, into the port's tensors of real dtype ``dtype`` on
    ``device``. ``pinv(A)`` is computed once on the host in float64 unless
    given, as the JAX bench does for its production solves."""
    a = np.asarray(a)
    if a_pinv is None:
        a_pinv = np.linalg.pinv(a.astype(np.complex128))
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    a_t = torch.tensor(a.astype(np.complex128)).to(device=device, dtype=cdtype)
    a_rast = raster_a_matrix(a_t, math.isqrt(a.shape[1]))
    return SolveInputs(
        a=a_t,
        ar=a_rast.real.contiguous(),
        ai=a_rast.imag.contiguous(),
        n=torch.tensor(np.asarray(n_counts)).to(device=device, dtype=dtype),
        a_pinv=torch.tensor(np.asarray(a_pinv).astype(np.complex128)).to(
            device=device, dtype=cdtype))


class QVInputs(NamedTuple):
    """A quantum-volume circuit stack carried over from numpy arrays."""
    perms: torch.Tensor               # (C, d, d) long qubit permutations
    gates: torch.Tensor               # (C, d, d//2, 4, 4) complex Haar gates
    kraus: Optional[torch.Tensor]     # (K, 4, 4) complex Kraus stack
    uniforms: Optional[torch.Tensor]  # (C, d, d//2, T) branch uniforms


def qv_inputs_from_numpy(perms: np.ndarray, gates: np.ndarray,
                         kraus: Optional[np.ndarray] = None,
                         uniforms: Optional[np.ndarray] = None, *,
                         device, dtype: torch.dtype = torch.float32) -> QVInputs:
    """Turn the JAX package's quantum-volume circuit stack, taken as numpy
    arrays, into the port's tensors on ``device``: permutations as int64,
    gates and Kraus operators as the complex dtype of the real ``dtype``,
    uniforms as ``dtype``."""
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128

    def cplx(x):
        return torch.tensor(np.asarray(x).astype(np.complex128)).to(
            device=device, dtype=cdtype)

    return QVInputs(
        perms=torch.tensor(np.asarray(perms).astype(np.int64), device=device),
        gates=cplx(gates),
        kraus=None if kraus is None else cplx(kraus),
        uniforms=None if uniforms is None else torch.tensor(
            np.asarray(uniforms).astype(np.float64)).to(device=device,
                                                        dtype=dtype))
