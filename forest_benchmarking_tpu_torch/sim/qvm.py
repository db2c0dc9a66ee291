"""The in-process quantum virtual machine: circuits -> shot data.

Port of ``forest_benchmarking_tpu/sim/qvm.py``, with its public names:
``run`` and ``run_symmetrized_readout`` behave as pyquil's do
(observable_estimation.py:907,1016 of the reference), as circuits run on
the QVM's device with an explicit ``torch.Generator``. The JAX package runs
eagerly on the CPU and through its compiled executor on an accelerator;
the port has one route, the executor (:mod:`.executor`), on the QVM's
device, so the CPU runs the same code as the card.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from forest_benchmarking_tpu_torch.circuits import Circuit, Gate
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.paulis import PauliTerm, pauli_term_to_matrix
from forest_benchmarking_tpu_torch.sim.density import run_density_matrix
from forest_benchmarking_tpu_torch.sim.executor import (
    build_plan, sample_bits, sample_bits_symmetrized)
from forest_benchmarking_tpu_torch.sim.statevector import run_statevector
from forest_benchmarking_tpu_torch.utils import entry_device

__all__ = ["QVM", "_symmetrization_patterns"]


def _sylvester_hadamard(m: int) -> np.ndarray:
    """Sylvester Hadamard matrix of order m (m a power of two), entries +-1."""
    h = np.array([[1]])
    while h.shape[0] < m:
        h = np.block([[h, h], [h, -h]])
    return h


def _next_pow2(x: int) -> int:
    m = 1
    while m < x:
        m *= 2
    return m


def _symmetrization_patterns(symm_type: int, k: int) -> np.ndarray:
    """Flip-pattern matrix (n_patterns, k) for readout symmetrization.

    * -1: exhaustive, all 2**k rows.
    *  1: strength-1 OA — [all zeros; all ones] (2 rows).
    *  2: strength-2 OA from a Hadamard matrix of order m >= k+1 (m rows):
         drop the constant column, map +1 -> 0, -1 -> 1.
    *  3: strength-3 OA from [H; -H] with H of order m >= k (2m rows).
    """
    if symm_type == -1:
        ints = np.arange(2 ** k)
        shifts = np.arange(k - 1, -1, -1)
        return (ints[:, None] >> shifts) & 1
    if symm_type == 1:
        return np.stack([np.zeros(k, dtype=np.int64),
                         np.ones(k, dtype=np.int64)])
    if symm_type == 2:
        m = _next_pow2(k + 1)
        h = _sylvester_hadamard(m)
        return ((1 - h[:, 1:k + 1]) // 2).astype(np.int64)
    if symm_type == 3:
        m = _next_pow2(max(k, 2))
        h = _sylvester_hadamard(m)
        stacked = np.vstack([h, -h])
        return ((1 - stacked[:, :k]) // 2).astype(np.int64)
    raise ValueError(f"Unknown symmetrization type {symm_type}")


class QVM:
    """A seeded, in-process simulator with optional noise.

    :param seed: seed of the QVM's ``torch.Generator`` on its device (every
        draw of every run comes from it, in order).
    :param dtype: complex dtype of the simulation (complex128, the JAX
        package's default, or complex64).
    :param noisy: force the density-matrix route even without noise
        annotations.
    :param t1s, t2s: optional per-qubit decoherence applied at DELAY gates.
    :param device: where circuits run: the card by default (without a card
        this raises unless ``device="cpu"``).
    """

    def __init__(self, seed: int = 52, dtype=torch.complex128,
                 noisy: bool = False, t1s=None, t2s=None, device=None):
        self.device = entry_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.dtype = dtype
        self.noisy = noisy
        self.t1s = dict(t1s or {})
        self.t2s = dict(t2s or {})
        self.name = f"fbtpu-qvm-{seed}"

    def _plan(self, circuit: Circuit, qubits: Sequence[int]):
        return build_plan(circuit, qubits, self.dtype, t1s=self.t1s,
                          t2s=self.t2s, noisy=self.noisy, device=self.device)

    # ---- exact results ----
    def wavefunction(self, circuit: Circuit,
                     qubits: Sequence[int]) -> torch.Tensor:
        """Exact wavefunction over ``qubits`` (in that order)."""
        return run_statevector(circuit, qubits, self.dtype, self.device)

    def density(self, circuit: Circuit, qubits: Sequence[int]) -> torch.Tensor:
        """Exact density matrix over ``qubits``, with the circuit's gate
        noise (no DELAY decoherence, as in the JAX package)."""
        return run_density_matrix(circuit, qubits, self.dtype,
                                  device=self.device)

    def probabilities(self, circuit: Circuit,
                      qubits: Sequence[int]) -> torch.Tensor:
        """Measurement probabilities over ``qubits`` (in order), simulating
        the union of the circuit's qubits and the requested ones, then
        marginalizing — as a QVM measures a subset of a larger register."""
        plan = self._plan(circuit, list(qubits))
        return plan.trace_probs(*plan.args())

    def expectation(self, circuit: Circuit, qubits: Sequence[int],
                    observable: PauliTerm) -> float:
        """Exact <P> on the simulated (possibly noisy) state; no readout error.

        The union of the circuit's, observable's and requested qubits is
        simulated, so a circuit touching qubits outside ``qubits`` yields the
        marginal expectation.
        """
        sim_qubits = sorted(set(circuit.get_qubits()) | set(qubits)
                            | set(observable.get_qubits()))
        op = torch.tensor(pauli_term_to_matrix(observable, sim_qubits),
                          dtype=self.dtype, device=self.device)
        with full_f32_matmul():
            if circuit.gate_noise or self.noisy or self.t1s or self.t2s:
                rho = run_density_matrix(circuit, sim_qubits, self.dtype,
                                         t1s=self.t1s, t2s=self.t2s,
                                         device=self.device)
                return float(torch.trace(op @ rho).real)
            psi = run_statevector(circuit, sim_qubits, self.dtype, self.device)
            return float((psi.conj() @ (op @ psi)).real)

    # ---- sampling ----
    def run(self, circuit: Circuit, qubits: Sequence[int],
            num_shots: int) -> np.ndarray:
        """Sample bitstrings; returns a (num_shots, len(qubits)) 0/1 int64
        array. Column i is qubit ``qubits[i]`` (pyquil's ro register order).
        """
        plan = self._plan(circuit, list(qubits))
        return sample_bits(plan, num_shots, self.generator).cpu().numpy()

    def run_symmetrized_readout(self, circuit: Circuit, num_shots: int,
                                symm_type: int = -1,
                                meas_qubits: Sequence[int] = None) -> np.ndarray:
        """Run with readout symmetrization.

        Pre-measurement X flips are applied according to the rows of a flip
        pattern matrix; observed bits are XORed with the pattern. Pattern sets
        (mirroring pyquil's semantics, reference observable_estimation.py:880):

          * -1 — exhaustive: all 2**k patterns
          *  0 — none
          *  1/2/3 — orthogonal array of the given strength (balances flip
            marginals over every 1/2/3-qubit subset with far fewer patterns)

        Pattern i gets ``num_shots // n_patterns`` shots, plus one for the
        first ``num_shots % n_patterns`` patterns. ``meas_qubits`` defaults
        to the circuit's own qubits (sorted).

        A plain QVM samples every pattern in one batched call. Each pattern
        runs on its own through ``self.run``, with real X gates, where the
        circuit attaches a noise channel to X (the batched flip layer
        applies ideal flips) and where a subclass overrides ``run`` (a
        subclass that adds readout noise there must see it in symmetrized
        runs too, as the JAX package's QVM on the CPU and pyquil, which
        append the flips to the program, give it).
        """
        if meas_qubits is None:
            meas_qubits = sorted(circuit.get_qubits())
        meas_qubits = list(meas_qubits)
        if symm_type == 0:
            return self.run(circuit, meas_qubits, num_shots)
        patterns = _symmetrization_patterns(symm_type, len(meas_qubits))
        n_patterns = len(patterns)
        base = num_shots // n_patterns
        rem = num_shots - base * n_patterns

        flip_noise = any(
            name == "X" and (qs is None or any(q in meas_qubits for q in qs))
            for name, qs, _ in circuit.gate_noise)
        if not flip_noise and type(self).run is QVM.run:
            plan = self._plan(circuit, meas_qubits)
            bits = sample_bits_symmetrized(
                plan, patterns, base + (1 if rem else 0),
                self.generator).cpu().numpy()
            return np.concatenate([bits[i, :base + (1 if i < rem else 0)]
                                   for i in range(n_patterns)], axis=0)

        chunks = []
        for pat, flips in enumerate(patterns):
            shots = base + (1 if pat < rem else 0)
            if shots == 0:
                continue
            flipped = circuit.copy()
            for q, f in zip(meas_qubits, flips):
                if f:
                    flipped += Gate("X", (), (q,))
            bits = self.run(flipped, meas_qubits, shots)
            chunks.append(bits ^ np.asarray(flips, dtype=np.int64))
        return np.concatenate(chunks, axis=0)
