"""A rudimentary, predictable compiler to the native RX(+-pi/2, pi)/RZ/CZ/XY
set (pure numpy).

Port of ``forest_benchmarking_tpu/compilation.py``, with its public names:
``basic_compile`` rewrites gate by gate, with no rewiring and no
optimization; some decompositions introduce global phases (noted per
function). Custom-matrix gates, DELAY and gates that carry a noise channel
pass through unchanged.
"""
from __future__ import annotations

from math import pi
from typing import Tuple

import numpy as np

from forest_benchmarking_tpu_torch.circuits import Circuit, RX, RZ, CZ, XY, I

__all__ = ["match_global_phase", "_RY", "_RX", "_X", "_H", "_CNOT", "_T",
           "_SWAP", "_CCNOT", "is_magic_angle", "basic_compile"]


def match_global_phase(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Phase both matrices so they agree at the entry where |b| is largest.

    After this, a' == b' implies a == b * exp(i t) for some t.
    """
    if a.shape != b.shape:
        return a, b
    k = max(np.ndindex(*a.shape), key=lambda t: abs(b[t]))

    def dephase(v):
        r, i = np.real(v), np.imag(v)
        if i == 0:
            return -1 if r < 0 else 1
        if r == 0:
            return 1j if i < 0 else -1j
        return np.exp(-1j * np.arctan2(i, r))

    return a * dephase(a[k]), b * dephase(b[k])


def _RY(angle, q) -> Circuit:  # noqa: N802
    """RY via RX(+-pi/2) conjugation of RZ."""
    return Circuit([RX(pi / 2, q), RZ(angle, q), RX(-pi / 2, q)])


def _RX(angle, q) -> Circuit:  # noqa: N802
    """Arbitrary-angle RX via native RX(+-pi/2) and RZ."""
    return Circuit([RZ(pi / 2, q), RX(pi / 2, q), RZ(angle, q),
                    RX(-pi / 2, q), RZ(-pi / 2, q)])


def _X(q) -> Circuit:  # noqa: N802
    """X as two RX(pi/2); introduces a global phase — don't control."""
    return Circuit([RX(pi / 2, q), RX(pi / 2, q)])


def _H(q) -> Circuit:  # noqa: N802
    """Hadamard as RY(-pi/2) then RZ(pi); global phase — don't control."""
    return _RY(-pi / 2, q) + RZ(pi, q)


def _CNOT(q1, q2) -> Circuit:  # noqa: N802
    """CNOT as H-CZ-H on the target; global phase — don't control."""
    return _H(q2) + CZ(q1, q2) + _H(q2)


def _T(q, dagger=False) -> Circuit:  # noqa: N802
    """T (or T^dag) as RZ(+-pi/4)."""
    return Circuit([RZ(-pi / 4 if dagger else pi / 4, q)])


def _SWAP(q1, q2) -> Circuit:  # noqa: N802
    """SWAP as three CNOTs; global phase — don't control."""
    return _CNOT(q1, q2) + _CNOT(q2, q1) + _CNOT(q1, q2)


def _CCNOT(q1, q2, q3) -> Circuit:  # noqa: N802
    """Toffoli via the standard T/CNOT network (with swaps for connectivity)."""
    c = Circuit()
    c += _H(q3)
    c += _CNOT(q2, q3)
    c += _T(q3, dagger=True)
    c += _SWAP(q2, q3)
    c += _CNOT(q1, q2)
    c += _T(q2)
    c += _CNOT(q3, q2)
    c += _T(q2, dagger=True)
    c += _CNOT(q1, q2)
    c += _SWAP(q2, q3)
    c += _T(q2)
    c += _T(q3)
    c += _CNOT(q1, q2)
    c += _H(q3)
    c += _T(q1)
    c += _T(q2, dagger=True)
    c += _CNOT(q1, q2)
    return c


def is_magic_angle(angle) -> bool:
    """True for the natively-implementable RX angles: 0, +-pi/2, +-pi."""
    return (np.isclose(np.abs(angle), pi / 2) or np.isclose(np.abs(angle), pi)
            or np.isclose(angle, 0.0))


def basic_compile(program: Circuit) -> Circuit:
    """Gate-by-gate rewrite to the native set; no rewiring, no optimization.

    Custom-matrix gates pass through unchanged (the analog of DEFGATE handling).
    DAGGER modifiers are folded into negated angles / reversed decompositions.

    Gates that carry a matching ``define_noisy_gate`` annotation also pass
    through unchanged: decomposing them would rename the gate and silently
    sever the Kraus channel keyed on it (the in-process simulator runs any
    named gate directly, so skipping the rewrite is semantically exact —
    a deviation from the reference, whose compiled programs go to a QVM that
    only applies noise to native gates).
    """
    new = Circuit(gate_noise=list(program.gate_noise),
                  readout_confusion=dict(program.readout_confusion))

    def _carries_noise(inst):
        return any(
            name == inst.name and (qs is None or tuple(qs) == tuple(inst.qubits))
            for name, qs, _ in program.gate_noise)

    for inst in program.gates:
        if _carries_noise(inst):
            new += inst
            continue
        needs_dagger = inst.dagger
        angle = None
        if inst.params:
            angle = -inst.params[0] if needs_dagger else inst.params[0]

        if inst.matrix is not None:
            new += inst
        elif inst.name == "DELAY":
            new += inst  # timing instruction, passes through untouched
        elif inst.name == "CZ":
            new += CZ(*inst.qubits)
        elif inst.name == "XY":
            new += XY(angle, *inst.qubits)
        elif inst.name == "I":
            new += I(inst.qubits[0])
        elif inst.name == "RZ":
            new += RZ(angle, inst.qubits[0])
        elif inst.name == "RX":
            if is_magic_angle(inst.params[0]):
                new += RX(angle, inst.qubits[0])
            else:
                new += _RX(angle, inst.qubits[0])
        elif inst.name == "RY":
            new += _RY(angle, inst.qubits[0])
        elif inst.name == "CNOT":
            new += _CNOT(*inst.qubits)
        elif inst.name == "CCNOT":
            new += _CCNOT(*inst.qubits)
        elif inst.name == "SWAP":
            new += _SWAP(*inst.qubits)
        elif inst.name == "T":
            new += _T(inst.qubits[0], needs_dagger)
        elif inst.name == "S":
            # extension over the reference: S = RZ(+-pi/2) (up to global phase)
            new += RZ(-pi / 2 if needs_dagger else pi / 2, inst.qubits[0])
        elif inst.name == "Z":
            # extension: Z = RZ(pi) up to global phase (self-inverse). The
            # Clifford synthesizer emits Z for sign fixes, so 3+ qubit RB
            # sequences route through here.
            new += RZ(pi, inst.qubits[0])
        elif inst.name == "Y":
            # extension: Y = Z X up to global phase -> RX(pi) then RZ(pi)
            new += RX(pi, inst.qubits[0])
            new += RZ(pi, inst.qubits[0])
        elif inst.name == "H":
            new += _H(inst.qubits[0])
        elif inst.name == "X":
            new += _X(inst.qubits[0])
        else:
            raise ValueError(f"Unknown gate instruction {inst}")
    return new
