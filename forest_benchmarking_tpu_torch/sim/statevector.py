"""Pure-state simulation: gate application by tensor contraction.

Port of ``forest_benchmarking_tpu/sim/statevector.py``. The state is a
(2,)*n complex tensor; axis i is qubit ``qubits[i]``, the first qubit the
most significant bit of the flattened index (as
:func:`~forest_benchmarking_tpu_torch.paulis.pauli_term_to_matrix`). The
circuit runs on an explicit device, the card unless the caller passes
``device="cpu"``; products run in full float32 (not TF32) for complex64.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from forest_benchmarking_tpu_torch.circuits import Circuit
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.utils import (entry_device,
                                                 ints_to_bit_arrays)

__all__ = ["run_statevector", "statevector_probabilities", "all_bitstrings",
           "apply_gate_matrix"]


def apply_gate_matrix(psi: torch.Tensor, mat: torch.Tensor,
                      axes: Sequence[int]) -> torch.Tensor:
    """Apply a k-qubit gate matrix to tensor axes ``axes`` of the state
    tensor ``psi``; ``mat`` is (2**k, 2**k) with the first listed axis the
    most significant. Axes not listed (leading batch axes among them) are
    carried along."""
    k = len(axes)
    mat_t = mat.reshape((2,) * (2 * k))
    out = torch.tensordot(mat_t, psi, dims=(list(range(k, 2 * k)), list(axes)))
    return torch.movedim(out, list(range(k)), list(axes))


def run_statevector(circuit: Circuit, qubits: Sequence[int],
                    dtype=torch.complex128, device=None) -> torch.Tensor:
    """Evolve |0...0> through the circuit; returns the (2**n,) wavefunction.

    ``qubits`` fixes the tensor order (first = most significant bit); gates
    on qubits outside the list raise. Runs on ``device``, the card by
    default."""
    dev = entry_device(device)
    qubits = list(qubits)
    n = len(qubits)
    pos = {q: i for i, q in enumerate(qubits)}
    psi = torch.zeros((2,) * n, dtype=dtype, device=dev)
    psi[(0,) * n] = 1.0
    with full_f32_matmul():
        for gate in circuit.gates:
            mat = torch.tensor(gate.get_matrix(), dtype=dtype, device=dev)
            psi = apply_gate_matrix(psi, mat, [pos[q] for q in gate.qubits])
    return psi.reshape(-1)


def statevector_probabilities(circuit: Circuit, qubits: Sequence[int],
                              dtype=torch.complex128,
                              device=None) -> torch.Tensor:
    """|psi|^2 over the 2**n bitstrings (first qubit = most significant
    bit)."""
    return run_statevector(circuit, qubits, dtype, device).abs() ** 2


def all_bitstrings(n: int) -> np.ndarray:
    """(2**n, n) array of bitstrings in integer order (first column = MSB)."""
    return ints_to_bit_arrays(np.arange(2 ** n), n)
