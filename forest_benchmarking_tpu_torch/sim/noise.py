"""Noise-channel constructors (numpy).

Port of the subset of ``forest_benchmarking_tpu/sim/noise.py`` that the
port uses: the Pauli-channel Kraus sets.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from forest_benchmarking_tpu_torch.utils import pauli_basis_matrices

__all__ = ["pauli_kraus_map", "depolarizing_kraus_map"]


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


def depolarizing_kraus_map(p: float = 0.1) -> List[np.ndarray]:
    """Single-qubit depolarizing: I w.p. 1-3p/4, X/Y/Z w.p. p/4 each."""
    return pauli_kraus_map([1 - 3 * p / 4, p / 4, p / 4, p / 4])
