"""Density-matrix simulation with Kraus-channel noise and readout confusion.

Port of ``forest_benchmarking_tpu/sim/density.py``, with its public names.
The JAX package lifts every gate and every Kraus operator to a 2^n x 2^n
matrix (:func:`_lift`, kept here for its callers) and multiplies. Here the
density matrix is a (2,)*2n tensor, row axes first, and a channel
{K_k} on k qubits is applied as its superoperator
S = sum_k K_k (x) conj(K_k), one (4^k x 4^k) contraction with the k row
and k column axes it acts on: a unitary is the channel of one operator.
Runs on an explicit device, the card unless the caller passes
``device="cpu"``; products run in full float32 (not TF32) for complex64.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from forest_benchmarking_tpu_torch.circuits import Circuit, Gate
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.sim.statevector import apply_gate_matrix
from forest_benchmarking_tpu_torch.utils import entry_device

__all__ = ["run_density_matrix", "density_probabilities", "apply_confusion",
           "apply_gate_to_density", "apply_kraus_to_density",
           "decoherence_kraus", "confusion_matrix_for"]


def _lift(mat: torch.Tensor, axes: Sequence[int], n: int) -> torch.Tensor:
    """Lift a k-qubit matrix to the full 2**n space given tensor axis
    positions: (mat (x) I) with its tensor axes permuted back, as the JAX
    package forms it."""
    k = len(axes)
    d = 2 ** n
    perm = list(axes) + [i for i in range(n) if i not in axes]
    full = torch.kron(mat, torch.eye(2 ** (n - k), dtype=mat.dtype,
                                     device=mat.device))
    inv = np.argsort(perm).tolist()
    t = full.reshape((2,) * (2 * n)).permute(inv + [n + i for i in inv])
    return t.reshape(d, d)


def _superop_np(kraus_ops) -> np.ndarray:
    """(m^2, m^2) superoperator of a Kraus set of m x m operators, indexed
    (row out, column out), (row in, column in): S = sum_k K_k (x) conj K_k."""
    k = np.asarray(kraus_ops, dtype=complex)
    m = k.shape[-1]
    k = k.reshape(-1, m, m)
    return np.einsum("kac,kbd->abcd", k, k.conj()).reshape(m * m, m * m)


def _apply_superop(t: torch.Tensor, sup: torch.Tensor, axes: Sequence[int],
                   n: int) -> torch.Tensor:
    """Apply a superoperator on qubit axes ``axes`` to the density tensor
    ``t`` of shape (*lead, (2,)*2n), leading axes carried along."""
    lead = t.dim() - 2 * n
    return apply_gate_matrix(t, sup, [lead + a for a in axes]
                             + [lead + n + a for a in axes])


def apply_kraus_to_density(rho: torch.Tensor, kraus_stack: torch.Tensor,
                           axes: Sequence[int], n: int) -> torch.Tensor:
    """sum_k K_k rho K_k^dag for the (K, 2^k, 2^k) stack on qubit axes
    ``axes`` of the (..., 2^n, 2^n) density matrix ``rho``."""
    k = torch.as_tensor(kraus_stack, dtype=rho.dtype, device=rho.device)
    m = k.shape[-1]
    sup = torch.einsum("kac,kbd->abcd", k, k.conj()).reshape(m * m, m * m)
    lead = rho.shape[:-2]
    with full_f32_matmul():
        t = _apply_superop(rho.reshape(lead + (2,) * (2 * n)), sup, axes, n)
    return t.reshape(rho.shape)


def apply_gate_to_density(rho: torch.Tensor, mat: torch.Tensor,
                          axes: Sequence[int], n: int) -> torch.Tensor:
    """U rho U^dag for the gate matrix ``mat`` on qubit axes ``axes``."""
    return apply_kraus_to_density(rho, torch.as_tensor(mat)[None], axes, n)


def decoherence_kraus(duration: float, t1: Optional[float],
                      t2: Optional[float]) -> np.ndarray:
    """Kraus stack for idling ``duration`` with relaxation T1 and coherence T2.

    Amplitude damping gamma = 1 - exp(-t/T1) composed with pure dephasing
    chosen so off-diagonals decay as exp(-t/T2) overall (requires T2 <= 2 T1).
    Operators that are identically zero are dropped.
    """
    gamma = 0.0 if (t1 is None or t1 <= 0) else 1 - np.exp(-duration / t1)
    amp = [np.array([[1, 0], [0, np.sqrt(1 - gamma)]], dtype=complex)]
    if gamma > 0:  # gamma == 0 makes this operator identically zero
        amp.append(np.array([[0, np.sqrt(gamma)], [0, 0]], dtype=complex))
    ops = amp
    if t2 is not None and t2 > 0:
        half_t1_rate = 0.0 if (t1 is None or t1 <= 0) else 1 / (2 * t1)
        phi_rate = 1 / t2 - half_t1_rate
        lam = 1 - np.exp(-2 * duration * max(phi_rate, 0.0))
        deph = [np.diag([1, np.sqrt(1 - lam)]).astype(complex)]
        if lam > 0:
            deph.append(np.diag([0, np.sqrt(lam)]).astype(complex))
        ops = [d @ a for a in amp for d in deph]
    ops = [k for k in ops if np.abs(k).max() > 0]
    return np.stack(ops)


def _gate_channels(circuit: Circuit, gate: Gate, t1s: Optional[dict],
                   t2s: Optional[dict]) -> List[np.ndarray]:
    """The Kraus stacks applied after ``gate``, in order: the decoherence of
    a DELAY under the per-qubit T1/T2 model, then every noise entry of the
    circuit whose name (and qubits, if given) match the gate."""
    out = []
    if gate.name == "DELAY" and (t1s or t2s):
        q = gate.qubits[0]
        out.append(decoherence_kraus(gate.params[0], (t1s or {}).get(q),
                                     (t2s or {}).get(q)))
    for name, nq, kraus in circuit.gate_noise:
        if name == gate.name and (nq is None
                                  or tuple(nq) == tuple(gate.qubits)):
            out.append(np.asarray(kraus))
    return out


def run_density_matrix(circuit: Circuit, qubits: Sequence[int],
                       dtype=torch.complex128,
                       t1s: Optional[Dict[int, float]] = None,
                       t2s: Optional[Dict[int, float]] = None,
                       device=None) -> torch.Tensor:
    """Evolve |0..0><0..0| through the circuit including attached gate
    noise; returns the (2^n, 2^n) density matrix in the order of
    ``qubits`` (first = most significant). DELAY gates also decohere under
    the optional per-qubit ``t1s``/``t2s`` model. Runs on ``device``, the
    card by default."""
    dev = entry_device(device)
    qubits = list(qubits)
    n = len(qubits)
    pos = {q: i for i, q in enumerate(qubits)}
    t = torch.zeros((2,) * (2 * n), dtype=dtype, device=dev)
    t[(0,) * (2 * n)] = 1.0
    with full_f32_matmul():
        for gate in circuit.gates:
            axes = [pos[q] for q in gate.qubits]
            for kraus in [gate.get_matrix()[None]] + _gate_channels(
                    circuit, gate, t1s, t2s):
                sup = torch.tensor(_superop_np(kraus), dtype=dtype, device=dev)
                t = _apply_superop(t, sup, axes, n)
    return t.reshape(2 ** n, 2 ** n)


def _confusion_np(circuit: Circuit, qubits: Sequence[int]
                  ) -> Optional[np.ndarray]:
    """Full readout confusion C[observed, true] over the listed qubits
    (identity on qubits without one), or None without any."""
    if not circuit.readout_confusion:
        return None
    c = np.eye(1)
    for q in qubits:
        cq = circuit.readout_confusion.get(q, np.eye(2))
        # stored row-stochastic p(observed|true) with rows = true; transpose
        # to the column-action form obs = C @ true
        c = np.kron(c, np.asarray(cq, dtype=float).T)
    return c


def confusion_matrix_for(circuit: Circuit, qubits: Sequence[int],
                         dtype=torch.float64,
                         device=None) -> Optional[torch.Tensor]:
    """Full readout confusion C with C[obs, true] over the listed qubits, on
    ``device`` (the card by default), or None without any."""
    c = _confusion_np(circuit, qubits)
    return None if c is None else torch.tensor(c, dtype=dtype,
                                               device=entry_device(device))


def apply_confusion(probs: torch.Tensor, circuit: Circuit,
                    qubits: Sequence[int]) -> torch.Tensor:
    """Apply per-qubit readout confusion to a probability vector."""
    c = confusion_matrix_for(circuit, qubits, dtype=probs.dtype,
                             device=probs.device)
    if c is None:
        return probs
    with full_f32_matmul():
        return c @ probs


def density_probabilities(circuit: Circuit, qubits: Sequence[int],
                          dtype=torch.complex128,
                          t1s: Optional[Dict[int, float]] = None,
                          t2s: Optional[Dict[int, float]] = None,
                          device=None) -> torch.Tensor:
    """Measurement probabilities including gate noise and readout confusion."""
    rho = run_density_matrix(circuit, qubits, dtype, t1s=t1s, t2s=t2s,
                             device=device)
    probs = torch.diagonal(rho).real.clamp(min=0)
    return apply_confusion(probs / probs.sum(), circuit, qubits)
