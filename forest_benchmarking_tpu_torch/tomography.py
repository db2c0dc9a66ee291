"""Process tomography, slice 1: the batched PGDB/APG maximum-likelihood route.

Port of the process path of ``forest_benchmarking_tpu/tomography.py``:

- the host-side helpers that build the PGDB A-matrix rows from the Pauli
  process-tomography settings (pure numpy, copied here because the JAX module
  imports jax);
- :func:`pgdb_process_estimate_batched` with the fused-solver route
  (``method="apg", cp_method="pallas"``), which runs
  :func:`~forest_benchmarking_tpu_torch.ops.lanes_apg.apg_fused`.

The per-problem ``while``-loop solvers (``method="pgdb"``/``"apg"`` with
``cp_method="eigh"``/``"ns"``) come with ROADMAP.md queue 1, item 5.

Conventions: column-stacking vec; the first qubit in ``qubits`` is the
left-most tensor factor.
"""
from __future__ import annotations

import functools
import itertools
from operator import mul
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu.observable_estimation import (
    ExperimentSetting, TensorProductState, plusX, minusX, plusY, minusY,
    plusZ, minusZ, _one_q_state_prep)
from forest_benchmarking_tpu.paulis import all_traceless_pauli_terms

__all__ = ["state_to_density", "pgdb_a_row_pair",
           "pgdb_process_estimate_batched"]


def _pauli_process_tomo_settings(qubits: Sequence[int]) -> Iterator[ExperimentSetting]:
    """+-XYZ eigenstate inputs x all non-identity Pauli observables."""
    for states in itertools.product([plusX, minusX, plusY, minusY, plusZ, minusZ],
                                    repeat=len(qubits)):
        i_state = functools.reduce(mul, (state(q) for state, q in zip(states, qubits)),
                                   TensorProductState())
        for obs in all_traceless_pauli_terms(qubits):
            yield ExperimentSetting(in_state=i_state, observable=obs)


@functools.lru_cache(maxsize=None)
def _oneq_state_density(label: str, index: int) -> np.ndarray:
    """Density matrix of a named 1q state, from its own prep circuit."""
    from forest_benchmarking_tpu.observable_estimation import _OneQState
    prep = _one_q_state_prep(_OneQState(label, index, 0))
    psi = np.array([1.0, 0.0], dtype=complex)
    for gate in prep.gates:
        psi = gate.get_matrix() @ psi
    return np.outer(psi, psi.conj())


def state_to_density(tps: TensorProductState, qubits: Sequence[int]) -> np.ndarray:
    """Dense density matrix of a TensorProductState on the given qubit order.

    Qubits not named in the state default to |0><0|.
    """
    named = {s.qubit: s for s in tps.states}
    rho = np.array([[1.0 + 0j]])
    for q in qubits:
        if q in named:
            s = named[q]
            rho = np.kron(rho, _oneq_state_density(s.label, s.index))
        else:
            rho = np.kron(rho, np.array([[1, 0], [0, 0]], dtype=complex))
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
