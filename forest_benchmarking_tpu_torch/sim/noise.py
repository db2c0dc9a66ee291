"""Noise-channel constructors (numpy): the Pauli, depolarizing, bit-flip,
amplitude-damping and dephasing Kraus sets, and ``append_kraus_to_gate``.

Port of ``forest_benchmarking_tpu/sim/noise.py``, with its public names.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from forest_benchmarking_tpu_torch.utils import pauli_basis_matrices

__all__ = ["pauli_kraus_map", "damping_kraus_map", "dephasing_kraus_map",
           "depolarizing_kraus_map", "bit_flip_kraus_map", "append_kraus_to_gate"]


def pauli_kraus_map(probabilities: Sequence[float]) -> List[np.ndarray]:
    """Kraus set of a Pauli channel: sqrt(p_k) P_k with P_k in IXYZ product
    order (I first), for 4**n probabilities summing to 1."""
    probabilities = np.asarray(probabilities, dtype=float)
    if not np.isclose(probabilities.sum(), 1.0, atol=1e-3):
        raise ValueError("Probabilities must sum to one.")
    n = int(round(np.log(len(probabilities)) / np.log(4)))
    if 4 ** n != len(probabilities):
        raise ValueError("Need 4**n probabilities.")
    paulis = pauli_basis_matrices(n)
    return [np.sqrt(p) * P for p, P in zip(probabilities, paulis)]


def damping_kraus_map(p: float = 0.1) -> List[np.ndarray]:
    """Amplitude damping with damping probability p."""
    return [np.array([[1, 0], [0, np.sqrt(1 - p)]], dtype=complex),
            np.array([[0, np.sqrt(p)], [0, 0]], dtype=complex)]


def dephasing_kraus_map(p: float = 0.1) -> List[np.ndarray]:
    """Phase flip with probability p."""
    return [np.sqrt(1 - p) * np.eye(2, dtype=complex),
            np.sqrt(p) * np.diag([1, -1]).astype(complex)]


def depolarizing_kraus_map(p: float = 0.1) -> List[np.ndarray]:
    """Single-qubit depolarizing: I w.p. 1-3p/4, X/Y/Z w.p. p/4 each."""
    return pauli_kraus_map([1 - 3 * p / 4, p / 4, p / 4, p / 4])


def bit_flip_kraus_map(p: float = 0.1) -> List[np.ndarray]:
    """Bit flip with probability p."""
    return pauli_kraus_map([1 - p, p, 0, 0])


def append_kraus_to_gate(kraus_ops: Sequence[np.ndarray],
                         gate_matrix: np.ndarray) -> List[np.ndarray]:
    """Kraus set of (noise after gate): K_i @ U."""
    return [np.asarray(k) @ np.asarray(gate_matrix) for k in kraus_ops]
