"""Process tomography, slice 1: the batched PGDB/APG maximum-likelihood route.

Port of the process path of ``forest_benchmarking_tpu/tomography.py``:

- the host-side helpers that build the PGDB A-matrix rows from the Pauli
  process-tomography settings (pure numpy; the six +-X/Y/Z eigenstate
  densities come from the same rotation matrices, applied in the same order,
  as ``observable_estimation._one_q_state_prep`` in the JAX package);
- :func:`pgdb_process_estimate_batched` with the fused-solver route
  (``method="apg", cp_method="pallas"``), which runs
  :func:`~forest_benchmarking_tpu_torch.ops.lanes_apg.apg_fused`.

The per-problem ``while``-loop solvers (``method="pgdb"``/``"apg"`` with
``cp_method="eigh"``/``"ns"``) come with ROADMAP.md queue 1, item 5.

Conventions: column-stacking vec; the first qubit is the left-most tensor
factor.
"""
from __future__ import annotations

import functools
import itertools
from math import pi
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.utils import all_traceless_pauli_strings

__all__ = ["state_to_density", "pgdb_a_row_pair",
           "pgdb_process_estimate_batched"]

# The Pauli-eigenstate inputs of process tomography, as (Pauli, index) with
# index 0 the +1 eigenstate: plusX, minusX, plusY, minusY, plusZ, minusZ.
_EIGENSTATES: Tuple[Tuple[str, int], ...] = (
    ("X", 0), ("X", 1), ("Y", 0), ("Y", 1), ("Z", 0), ("Z", 1))


def _rx(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=complex)


def _ry(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=complex)


# preparation rotations of each eigenstate from |0>, applied in order
_PREPS = {("X", 0): (_ry(pi / 2),), ("X", 1): (_ry(-pi / 2),),
          ("Y", 0): (_rx(-pi / 2),), ("Y", 1): (_rx(pi / 2),),
          ("Z", 0): (), ("Z", 1): (_rx(pi),)}


def _pauli_process_tomo_settings(n_qubits: int
                                 ) -> Iterator[Tuple[Tuple[Tuple[str, int], ...], str]]:
    """(input eigenstates, observable) pairs: +-XYZ eigenstate inputs on
    every qubit x all non-identity Pauli observables, in the JAX package's
    order."""
    for states in itertools.product(_EIGENSTATES, repeat=n_qubits):
        for obs in all_traceless_pauli_strings(n_qubits):
            yield states, obs


@functools.lru_cache(maxsize=None)
def _oneq_state_density(label: str, index: int) -> np.ndarray:
    """Density matrix of a Pauli eigenstate, from its preparation rotations."""
    psi = np.array([1.0, 0.0], dtype=complex)
    for gate in _PREPS[(label, index)]:
        psi = gate @ psi
    return np.outer(psi, psi.conj())


def state_to_density(states: Sequence[Tuple[str, int]]) -> np.ndarray:
    """Dense density matrix of a tensor product of Pauli eigenstates, given
    as (Pauli, index) per qubit, first qubit = left-most factor."""
    rho = np.array([[1.0 + 0j]])
    for label, index in states:
        rho = np.kron(rho, _oneq_state_density(label, index))
    return rho


def pgdb_a_row_pair(in_mat: np.ndarray, op: np.ndarray,
                    eye: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(+ row, - row) of the PGDB A-matrix (eq. A1 of [PGD]) for one
    (input state, coefficient-1 observable) setting, column-stacking vec."""
    proj_plus = (eye + op) / 2
    proj_minus = (eye - op) / 2
    return (np.kron(in_mat, proj_plus.T).T.reshape(-1),
            np.kron(in_mat, proj_minus.T).T.reshape(-1))


def pgdb_process_estimate_batched(a: torch.Tensor, n: torch.Tensor, dim: int,
                                  trace_preserving: bool = True,
                                  cp_method: str = "eigh",
                                  method: str = "pgdb",
                                  return_iters: bool = False,
                                  fused_schedule: str = "parity") -> torch.Tensor:
    """Batched PGDB: (R, d^4) shared A-matrix, (B, R) counts -> (B, d^2, d^2).

    Routes as the JAX function does. ``cp_method="pallas"`` (with
    ``method="apg"``) selects the fused solver
    :func:`~forest_benchmarking_tpu_torch.ops.lanes_apg.apg_fused`: the CUDA
    kernel for tensors on the card, its plain PyTorch version on the CPU.
    ``fused_schedule`` picks ``"parity"`` (strict <1e-6 f64 deviation from
    the converged optimum) or ``"headline"`` (statistical equivalence); the
    tuned schedules are for dim=4. The JAX function's tolerance and
    iteration arguments (``stop_tol``, ``maxiter``, ``dyk_*``, ``ns_iters``,
    ``loop_dyk_iters``, ``warm_start``) belong to the per-problem solvers,
    which are not ported yet, and are not accepted here.
    """
    if cp_method == "pallas":
        if method != "apg":
            raise ValueError("cp_method='pallas' requires method='apg'")
        if not trace_preserving:
            raise ValueError("cp_method='pallas' implements the CPTP "
                             "projection only (trace_preserving=True)")
        if return_iters:
            raise ValueError("return_iters is not available for the fused "
                             "solver (its iteration schedule is static)")
        if fused_schedule not in ("parity", "headline"):
            raise ValueError(f"Unknown fused_schedule '{fused_schedule}'")
        from forest_benchmarking_tpu_torch.ops.lanes_apg import (
            apg_fused, PARITY_TUNED_2Q, HEADLINE_TUNED_2Q)
        if dim == 4:
            cfg = (PARITY_TUNED_2Q if fused_schedule == "parity"
                   else HEADLINE_TUNED_2Q)
            return apg_fused(a, n, dim=dim, **cfg)
        if fused_schedule != "parity":
            raise ValueError(
                f"fused_schedule='{fused_schedule}' is only tuned/validated "
                f"for dim=4 (2Q); dim={dim} runs the conservative default "
                f"schedule — pass fused_schedule='parity' explicitly")
        return apg_fused(a, n, dim=dim)
    raise NotImplementedError(
        f"method={method!r} with cp_method={cp_method!r} is not ported yet: "
        "the per-problem PGDB/APG solvers come with ROADMAP.md queue 1, "
        "item 5 (tomography.py process path: _pgdb_kernel, _apg_kernel, "
        "proj_choi_to_physical). Use method='apg', cp_method='pallas'.")
