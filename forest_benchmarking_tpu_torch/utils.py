"""Host-side Pauli constants and moment helpers (numpy).

Port of the subset of ``forest_benchmarking_tpu/utils.py`` and
``forest_benchmarking_tpu/paulis.py`` that the port uses: the one-qubit
Pauli matrices, the stacked n-qubit Pauli basis (also as an
:class:`OperatorBasis` with its labels), the traceless Pauli strings in the
JAX package's order, dense Pauli-string matrices, ``is_pos_pow_two`` and the
Pauli/bit moment transforms. Conventions as there: the first character of a
Pauli string (and the first qubit) is the left-most tensor factor.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["I_MAT", "X_MAT", "Y_MAT", "Z_MAT", "PAULI_MATS",
           "is_pos_pow_two", "OperatorBasis", "PAULI_BASIS",
           "n_qubit_pauli_basis", "pauli_basis_matrices",
           "pauli_label_strings", "all_traceless_pauli_strings",
           "pauli_string_to_matrix", "transform_pauli_moments_to_bit",
           "transform_bit_moments_to_pauli", "entry_device"]

I_MAT = np.eye(2, dtype=np.complex128)
X_MAT = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y_MAT = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z_MAT = np.array([[1, 0], [0, -1]], dtype=np.complex128)

PAULI_MATS = {"I": I_MAT, "X": X_MAT, "Y": Y_MAT, "Z": Z_MAT}


def is_pos_pow_two(x: int) -> bool:
    """Check that an integer is a positive power of two."""
    return x > 0 and (x & (x - 1)) == 0


class OperatorBasis:
    """A complete set of basis operators: ``labels`` and one stacked
    ``(num_ops, d, d)`` complex128 array ``ops``."""

    def __init__(self, labels_ops):
        labels, ops = zip(*labels_ops)
        self.labels = list(labels)
        self.ops = np.stack([np.asarray(op, dtype=np.complex128)
                             for op in ops])
        self.dim = len(self.labels)

    @property
    def ops_by_label(self):
        return dict(zip(self.labels, self.ops))

    def product(self, *bases: "OperatorBasis") -> "OperatorBasis":
        """Tensor product with one or more other bases."""
        rest = bases[0].product(*bases[1:]) if len(bases) > 1 else bases[0]
        labels = [l1 + l2 for l1 in self.labels for l2 in rest.labels]
        a, b = self.ops, rest.ops
        n1, r1, c1 = a.shape
        n2, r2, c2 = b.shape
        ops = np.einsum("nij,mkl->nmikjl", a, b).reshape(n1 * n2, r1 * r2,
                                                          c1 * c2)
        return OperatorBasis(list(zip(labels, ops)))

    def __iter__(self):
        yield from zip(self.labels, self.ops)

    def __pow__(self, n: int) -> "OperatorBasis":
        if not isinstance(n, int):
            raise TypeError("Can only accept an integer number of factors")
        if n < 1:
            raise ValueError("Need positive number of factors")
        return self if n == 1 else self.product(*([self] * (n - 1)))

    def __repr__(self):
        return "<span[{}]>".format(",".join(self.labels))


PAULI_BASIS = OperatorBasis([(k, PAULI_MATS[k]) for k in "IXYZ"])


@functools.lru_cache(maxsize=None)
def n_qubit_pauli_basis(n: int) -> OperatorBasis:
    """The tensor-product Pauli basis on ``n`` qubits, labels in
    ``itertools.product('IXYZ', repeat=n)`` order."""
    if n < 1:
        raise ValueError(f"n = {n} should be at least 1.")
    return PAULI_BASIS ** n


@functools.lru_cache(maxsize=None)
def pauli_label_strings(n: int) -> Tuple[str, ...]:
    """Labels of :func:`pauli_basis_matrices`, e.g. ('II', 'IX', ...)."""
    return tuple(n_qubit_pauli_basis(n).labels)


def transform_pauli_moments_to_bit(mean_p, var_p):
    """Pauli-operator moments on [-1, 1] -> bit (Bernoulli) moments on [0, 1]."""
    return (mean_p + 1) / 2, var_p / 4


def transform_bit_moments_to_pauli(mean_c, var_c):
    """Bit (Bernoulli) moments on [0, 1] -> Pauli-operator moments on [-1, 1]."""
    return 2 * mean_c - 1, 4 * var_c


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



def entry_device(device=None, *values) -> torch.device:
    """The device an entry point runs on.

    Where one of ``values`` is a tensor, the first such tensor's device:
    functions run where their tensors lie, and a ``device`` that names
    another raises ``ValueError``. Otherwise (numpy arrays, lists) ``device``,
    by default the card. Without a card, the card raises ``RuntimeError``
    unless the caller passes ``device="cpu"``: nothing falls back to the CPU.
    """
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        want = dev if device is None else torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"device={device} but the inputs lie on {dev}")
        return dev
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point runs on the "
                           "card unless called with device='cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
