"""A Pauli-operator algebra: ``PauliTerm`` (pure numpy).

Port of ``forest_benchmarking_tpu/paulis.py``, with its public names:
construction from strings and qubit sets, products with phase tracking,
compact serialization, dense matrices (:func:`pauli_term_to_matrix`, first
qubit = left-most factor) and the ``all_traceless_*`` constructors. Hashable on
the operator without its coefficient, as there.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from forest_benchmarking_tpu_torch.utils import PAULI_MATS

__all__ = ["PauliTerm", "sI", "sX", "sY", "sZ", "is_identity",
           "str_to_pauli_term", "all_traceless_pauli_terms",
           "all_traceless_pauli_choice_terms", "all_traceless_pauli_z_terms",
           "pauli_term_to_matrix"]

# single-qubit Pauli multiplication table: (result_op, phase)
_MUL = {
    ("I", "I"): ("I", 1), ("I", "X"): ("X", 1), ("I", "Y"): ("Y", 1), ("I", "Z"): ("Z", 1),
    ("X", "I"): ("X", 1), ("Y", "I"): ("Y", 1), ("Z", "I"): ("Z", 1),
    ("X", "X"): ("I", 1), ("Y", "Y"): ("I", 1), ("Z", "Z"): ("I", 1),
    ("X", "Y"): ("Z", 1j), ("Y", "X"): ("Z", -1j),
    ("Y", "Z"): ("X", 1j), ("Z", "Y"): ("X", -1j),
    ("Z", "X"): ("Y", 1j), ("X", "Z"): ("Y", -1j),
}


class PauliTerm:
    """An n-qubit Pauli operator: a coefficient times a product of X/Y/Z factors.

    Immutable-ish (treat as frozen); hashable on the operator content *excluding*
    the coefficient, mirroring how the reference groups observables
    (observable_estimation.py:1005-1008 strips coefficients before hashing).
    Use ``==`` for full equality including coefficient.
    """

    __slots__ = ("_ops", "coefficient")

    def __init__(self, ops: Dict[int, str] | Iterable[Tuple[int, str]] = (),
                 coefficient: complex = 1.0):
        if isinstance(ops, dict):
            items = ops.items()
        else:
            items = ops
        clean = {}
        seen = set()
        for q, op in items:
            op = op.upper()
            if op not in ("I", "X", "Y", "Z"):
                raise ValueError(f"Bad Pauli op '{op}'")
            q = int(q)
            if q in seen:
                raise ValueError(
                    f"Duplicate qubit {q} in PauliTerm factors (pyquil also "
                    f"rejects this); multiply two PauliTerms to compose "
                    f"operators on the same qubit")
            seen.add(q)
            if op == "I":
                continue
            clean[q] = op
        self._ops = tuple(sorted(clean.items()))
        self.coefficient = complex(coefficient)

    # ---- constructors ----
    @classmethod
    def from_list(cls, terms: Sequence[Tuple[str, int]], coefficient: complex = 1.0):
        """From [(op, qubit), ...] pairs (pyquil argument order)."""
        return cls([(q, op) for op, q in terms], coefficient)

    @classmethod
    def from_compact_str(cls, s: str) -> "PauliTerm":
        """Parse '(1+0j)*X0Y3' or 'X0Y3' or '(0.5+0j)*I'."""
        s = s.strip()
        if "*" in s:
            coeff_str, op_str = s.split("*", 1)
            coeff = complex(coeff_str.strip().strip("()"))
        else:
            coeff, op_str = 1.0, s
        op_str = op_str.strip()
        if op_str in ("I", ""):
            return cls((), coeff)
        pairs = re.findall(r"([XYZI])(\d+)", op_str)
        if "".join(op + q for op, q in pairs) != op_str:
            raise ValueError(f"Couldn't parse '{s}'")
        return cls([(int(q), op) for op, q in pairs], coeff)

    # ---- inspection ----
    def get_qubits(self) -> List[int]:
        return [q for q, _ in self._ops]

    def operations_as_set(self) -> frozenset:
        return frozenset(self._ops)

    def __getitem__(self, qubit: int) -> str:
        for q, op in self._ops:
            if q == qubit:
                return op
        return "I"

    def __iter__(self):
        yield from self._ops

    def __len__(self):
        return len(self._ops)

    @property
    def id(self) -> str:
        return "".join(f"{op}{q}" for q, op in self._ops)

    def compact_str(self) -> str:
        if not self._ops:
            return f"{self.coefficient}*I"
        return f"{self.coefficient}*{self.id}"

    def pauli_string(self, qubits: Sequence[int]) -> str:
        """The operator as a string over the given qubit order, e.g. 'XIZ'."""
        return "".join(self[q] for q in qubits)

    # ---- algebra ----
    def __mul__(self, other):
        if isinstance(other, (int, float, complex)):
            return PauliTerm(self._ops, self.coefficient * other)
        ops = dict(self._ops)
        coeff = self.coefficient * other.coefficient
        for q, op in other._ops:
            cur = ops.get(q, "I")
            new_op, phase = _MUL[(cur, op)]
            coeff *= phase
            if new_op == "I":
                ops.pop(q, None)
            else:
                ops[q] = new_op
        return PauliTerm(ops, coeff)

    __rmul__ = __mul__

    def __neg__(self):
        return PauliTerm(self._ops, -self.coefficient)

    def __eq__(self, other):
        if not isinstance(other, PauliTerm):
            return NotImplemented
        return (self._ops == other._ops
                and np.isclose(self.coefficient, other.coefficient))

    def __hash__(self):
        return hash(self._ops)

    def copy(self, coefficient=None) -> "PauliTerm":
        return PauliTerm(self._ops,
                         self.coefficient if coefficient is None else coefficient)

    def __str__(self):
        return self.compact_str()

    __repr__ = __str__


def sI(q: int = None) -> PauliTerm:  # noqa: N802  (pyquil-compatible name)
    return PauliTerm(())


def sX(q: int) -> PauliTerm:  # noqa: N802
    return PauliTerm([(q, "X")])


def sY(q: int) -> PauliTerm:  # noqa: N802
    return PauliTerm([(q, "Y")])


def sZ(q: int) -> PauliTerm:  # noqa: N802
    return PauliTerm([(q, "Z")])


def is_identity(term: PauliTerm) -> bool:
    return len(term._ops) == 0


def str_to_pauli_term(pauli_str: str, qubit_labels: Sequence[int] = None) -> PauliTerm:
    """'XY' on qubits [0, 1] -> X0*Y1 (reference utils.py:127)."""
    if qubit_labels is None:
        qubit_labels = list(range(len(pauli_str)))
    if len(qubit_labels) != len(pauli_str):
        raise ValueError(
            f"{len(pauli_str)} Pauli factors need {len(pauli_str)} qubit "
            f"labels, got {len(qubit_labels)} (zip would silently truncate)")
    return PauliTerm([(q, op) for op, q in zip(pauli_str, qubit_labels)])


def all_traceless_pauli_terms(qubits: Sequence[int]) -> List[PauliTerm]:
    """All 4^n - 1 non-identity Pauli terms on the qubits (utils.py:146)."""
    from forest_benchmarking_tpu_torch.utils import all_traceless_pauli_strings
    return [str_to_pauli_term(s, qubits)
            for s in all_traceless_pauli_strings(len(qubits))]


def all_traceless_pauli_choice_terms(qubits: Sequence[int], pauli_choice: str) -> List[PauliTerm]:
    from forest_benchmarking_tpu_torch.utils import all_traceless_pauli_choice_strings
    return [str_to_pauli_term(s, qubits)
            for s in all_traceless_pauli_choice_strings(len(qubits),
                                                        pauli_choice)]


def all_traceless_pauli_z_terms(qubits: Sequence[int]) -> List[PauliTerm]:
    return all_traceless_pauli_choice_terms(qubits, "Z")


def pauli_term_to_matrix(term: PauliTerm, qubits: Sequence[int]) -> np.ndarray:
    """Dense matrix of the term on the given qubit order (first = left factor).

    Mirrors pyquil's ``lifted_pauli`` except qubit order is explicit: the first
    qubit in ``qubits`` is the left-most (most significant) tensor factor.
    Like ``lifted_pauli``, factors on qubits outside ``qubits`` are an error
    (silently dropping them would return the wrong operator).
    """
    extra = set(term.get_qubits()) - set(qubits)
    if extra:
        raise ValueError(f"Pauli term {term} acts on qubit(s) "
                         f"{sorted(extra)} outside the qubit list {list(qubits)}")
    mat = np.array([[1.0 + 0j]])
    for q in qubits:
        mat = np.kron(mat, PAULI_MATS[term[q]])
    return term.coefficient * mat
