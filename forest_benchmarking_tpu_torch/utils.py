"""Host-side Pauli constants (numpy).

Port of the subset of ``forest_benchmarking_tpu/utils.py`` and
``forest_benchmarking_tpu/paulis.py`` that the port uses: the one-qubit
Pauli matrices, the stacked n-qubit Pauli basis, the traceless Pauli strings
in the JAX package's order and dense Pauli-string matrices. Conventions as
there: the first character of a Pauli string (and the first qubit) is the
left-most tensor factor.
"""
from __future__ import annotations

import functools
import itertools
from typing import List

import numpy as np

__all__ = ["I_MAT", "X_MAT", "Y_MAT", "Z_MAT", "PAULI_MATS",
           "pauli_basis_matrices", "all_traceless_pauli_strings",
           "pauli_string_to_matrix"]

I_MAT = np.eye(2, dtype=np.complex128)
X_MAT = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y_MAT = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z_MAT = np.array([[1, 0], [0, -1]], dtype=np.complex128)

PAULI_MATS = {"I": I_MAT, "X": X_MAT, "Y": Y_MAT, "Z": Z_MAT}


def all_traceless_pauli_strings(n: int) -> List[str]:
    """All non-identity Pauli strings on n qubits, in
    ``itertools.product('IXYZ', repeat=n)`` order."""
    return ["".join(x) for x in itertools.product("IXYZ", repeat=n)][1:]


def pauli_string_to_matrix(pauli_str: str) -> np.ndarray:
    """Dense matrix of a Pauli string, first character = left-most factor."""
    mat = np.array([[1.0 + 0j]])
    for ch in pauli_str:
        mat = np.kron(mat, PAULI_MATS[ch.upper()])
    return mat


@functools.lru_cache(maxsize=None)
def pauli_basis_matrices(n: int) -> np.ndarray:
    """Stacked unnormalized n-qubit Pauli basis, shape ``(4**n, 2**n, 2**n)``,
    in ``itertools.product('IXYZ', repeat=n)`` order. Cached; read-only."""
    return np.stack([pauli_string_to_matrix("".join(s))
                     for s in itertools.product("IXYZ", repeat=n)])

