"""A minimal circuit IR: ``Gate`` and ``Circuit`` (pure numpy).

Port of ``forest_benchmarking_tpu/circuits.py``, with its public names. A
``Circuit`` is a host-side list of ``Gate`` ops that the port's simulator
(:mod:`forest_benchmarking_tpu_torch.sim`) runs; gate matrices are host
numpy constants, cast by the simulator to its dtype and device.
``DEFGATE``-style custom unitaries are passed as explicit matrices. Noise
is attached to a Circuit as (gate name, qubits or None, Kraus stack)
entries applied after matching gates (the analog of PRAGMA ADD-KRAUS), and
as per-qubit readout confusion matrices (the analog of PRAGMA
READOUT-POVM).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Gate", "Circuit", "gate_matrix", "GATES",
           "I", "X", "Y", "Z", "H", "S", "T", "RX", "RY", "RZ",
           "PHASE", "CZ", "CNOT", "SWAP", "ISWAP", "XY", "CCNOT", "CPHASE",
           "DELAY", "merge_circuits"]


# ----------------------------- gate matrices -------------------------------

def _rx(theta):
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=complex)


def _ry(theta):
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=complex)


def _rz(theta):
    return np.array([[np.exp(-1j * theta / 2), 0],
                     [0, np.exp(1j * theta / 2)]], dtype=complex)


def _phase(theta):
    return np.array([[1, 0], [0, np.exp(1j * theta)]], dtype=complex)


def _xy(theta):
    # pyquil XY(theta): exp(-i theta/2 (XX+YY)/2) — partial iSWAP
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[1, 0, 0, 0],
                     [0, c, 1j * s, 0],
                     [0, 1j * s, c, 0],
                     [0, 0, 0, 1]], dtype=complex)


def _cphase(theta):
    return np.diag([1, 1, 1, np.exp(1j * theta)]).astype(complex)


GATES: Dict[str, np.ndarray] = {
    "I": np.eye(2, dtype=complex),
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
    "Z": np.diag([1, -1]).astype(complex),
    "H": np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2),
    "S": np.diag([1, 1j]).astype(complex),
    "T": np.diag([1, np.exp(1j * np.pi / 4)]).astype(complex),
    "CZ": np.diag([1, 1, 1, -1]).astype(complex),
    "CNOT": np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                      [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex),
    "SWAP": np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex),
    "ISWAP": np.array([[1, 0, 0, 0], [0, 0, 1j, 0],
                       [0, 1j, 0, 0], [0, 0, 0, 1]], dtype=complex),
    "CCNOT": np.eye(8, dtype=complex)[:, [0, 1, 2, 3, 4, 5, 7, 6]],
}

_PARAMETRIC = {"RX": _rx, "RY": _ry, "RZ": _rz, "PHASE": _phase, "XY": _xy,
               "CPHASE": _cphase}


def gate_matrix(name: str, params: Tuple[float, ...] = (),
                matrix: Optional[np.ndarray] = None, dagger: bool = False) -> np.ndarray:
    """Dense matrix for a named gate (or an explicit custom matrix)."""
    if matrix is not None:
        mat = np.asarray(matrix, dtype=complex)
    elif name == "DELAY":
        mat = np.eye(2, dtype=complex)
    elif name in _PARAMETRIC:
        mat = _PARAMETRIC[name](*params)
    elif name in GATES:
        mat = GATES[name]
    else:
        raise ValueError(f"Unknown gate '{name}'")
    if dagger:
        mat = mat.conj().T
    return mat


@dataclass(frozen=True)
class Gate:
    """One circuit operation: a named (or custom-matrix) unitary on qubits.

    The first qubit listed is the most significant (left-most tensor factor) of
    the gate matrix, matching pyquil's convention for e.g. CNOT(control, target).
    """
    name: str
    params: Tuple[float, ...]
    qubits: Tuple[int, ...]
    matrix: Optional[Tuple[Tuple[complex, ...], ...]] = None  # custom unitary
    dagger: bool = False

    def get_matrix(self) -> np.ndarray:
        mat = None if self.matrix is None else np.array(self.matrix, dtype=complex)
        return gate_matrix(self.name, self.params, mat, self.dagger)

    def dag(self) -> "Gate":
        return Gate(self.name, self.params, self.qubits, self.matrix,
                    not self.dagger)

    def __str__(self):
        p = f"({', '.join(repr(x) for x in self.params)})" if self.params else ""
        d = "DAGGER " if self.dagger else ""
        return f"{d}{self.name}{p} {' '.join(str(q) for q in self.qubits)}"


# convenience constructors (pyquil-style call signatures)
def I(q):  # noqa: E743
    return Gate("I", (), (q,))


def X(q):
    return Gate("X", (), (q,))


def Y(q):
    return Gate("Y", (), (q,))


def Z(q):
    return Gate("Z", (), (q,))


def H(q):
    return Gate("H", (), (q,))


def S(q):
    return Gate("S", (), (q,))


def T(q):
    return Gate("T", (), (q,))


def RX(theta, q):
    return Gate("RX", (float(theta),), (q,))


def RY(theta, q):
    return Gate("RY", (float(theta),), (q,))


def RZ(theta, q):
    return Gate("RZ", (float(theta),), (q,))


def PHASE(theta, q):
    return Gate("PHASE", (float(theta),), (q,))


def CZ(q0, q1):
    return Gate("CZ", (), (q0, q1))


def CNOT(control, target):
    return Gate("CNOT", (), (control, target))


def SWAP(q0, q1):
    return Gate("SWAP", (), (q0, q1))


def ISWAP(q0, q1):
    return Gate("ISWAP", (), (q0, q1))


def XY(theta, q0, q1):
    return Gate("XY", (float(theta),), (q0, q1))


def CPHASE(theta, q0, q1):
    return Gate("CPHASE", (float(theta),), (q0, q1))


def CCNOT(c0, c1, target):
    return Gate("CCNOT", (), (c0, c1, target))


def DELAY(duration, q):
    """Idle for ``duration`` seconds (identity unitary; decoheres under a QVM
    with t1/t2 noise — the analog of quil-t Delay, qubit_spectroscopy.py:107)."""
    return Gate("DELAY", (float(duration),), (q,))


class Circuit:
    """An ordered list of gates plus optional noise annotations.

    Supports ``+`` composition like pyquil Programs. Noise:
      - ``gate_noise``: list of (gate_name, qubits_or_None, kraus_stack) —
        after every matching gate the Kraus channel is applied (qubits None
        matches any qubits; the channel acts on the gate's qubits).
      - ``readout_confusion``: {qubit: 2x2 row-stochastic p(observed|true)}.
    """

    def __init__(self, gates: Sequence[Gate] = (), *,
                 gate_noise: Optional[list] = None,
                 readout_confusion: Optional[Dict[int, np.ndarray]] = None):
        self.gates: List[Gate] = list(gates)
        self.gate_noise = list(gate_noise or [])
        self.readout_confusion = dict(readout_confusion or {})

    @staticmethod
    def _noise_key(entry):
        name, qubits, kraus = entry
        return (name, qubits, np.asarray(kraus).tobytes())

    def __add__(self, other):
        if isinstance(other, Gate):
            other = Circuit([other])
        seen = {self._noise_key(n) for n in self.gate_noise}
        noise = self.gate_noise + [n for n in other.gate_noise
                                   if self._noise_key(n) not in seen]
        confusion = {**self.readout_confusion, **other.readout_confusion}
        return Circuit(self.gates + other.gates, gate_noise=noise,
                       readout_confusion=confusion)

    def __iadd__(self, other):
        result = self + other
        self.gates = result.gates
        self.gate_noise = result.gate_noise
        self.readout_confusion = result.readout_confusion
        return self

    def __len__(self):
        return len(self.gates)

    def __iter__(self):
        yield from self.gates

    def get_qubits(self) -> set:
        qs = set()
        for g in self.gates:
            qs.update(g.qubits)
        return qs

    def dagger(self) -> "Circuit":
        return Circuit([g.dag() for g in reversed(self.gates)],
                       gate_noise=self.gate_noise,
                       readout_confusion=self.readout_confusion)

    def define_noisy_gate(self, name: str, qubits: Optional[Sequence[int]],
                          kraus_ops: Sequence[np.ndarray]) -> "Circuit":
        """Attach a Kraus channel applied after each matching gate (in place)."""
        stack = np.stack([np.asarray(k, dtype=complex) for k in kraus_ops])
        self.gate_noise.append((name, None if qubits is None else tuple(qubits),
                                stack))
        return self

    def define_noisy_readout(self, qubit: int, p00: float, p11: float) -> "Circuit":
        """Attach an asymmetric readout confusion to a qubit (in place)."""
        self.readout_confusion[qubit] = np.array(
            [[p00, 1 - p00], [1 - p11, p11]], dtype=float)
        return self

    def copy(self) -> "Circuit":
        return Circuit(self.gates, gate_noise=list(self.gate_noise),
                       readout_confusion=dict(self.readout_confusion))

    def __str__(self):
        return "\n".join(str(g) for g in self.gates)

    def __repr__(self):
        return f"Circuit[{len(self.gates)} gates on {sorted(self.get_qubits())}]"

    def __eq__(self, other):
        if not isinstance(other, Circuit):
            return False
        if self.gates != other.gates:
            return False
        # noise annotations change simulation semantics, so they are part of
        # circuit identity (two equal gate lists with different channels
        # produce different distributions)
        if len(self.gate_noise) != len(other.gate_noise):
            return False
        for (n1, q1, k1), (n2, q2, k2) in zip(self.gate_noise,
                                              other.gate_noise):
            if n1 != n2 or q1 != q2 or not np.array_equal(k1, k2):
                return False
        if sorted(self.readout_confusion) != sorted(other.readout_confusion):
            return False
        return all(np.array_equal(self.readout_confusion[q],
                                  other.readout_confusion[q])
                   for q in self.readout_confusion)

    def out(self) -> str:
        """Textual form (used by experiment JSON serialization)."""
        return "\n".join(str(g) for g in self.gates)


def merge_circuits(circuits: Sequence[Circuit]) -> Circuit:
    """Concatenate circuits (the analog of pyquil merge_programs)."""
    out = Circuit()
    for c in circuits:
        out = out + c
    return out
