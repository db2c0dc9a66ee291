"""Reversible classical-logic primitives (Z-basis and X-basis variants).

Port of ``forest_benchmarking_tpu/classical_logic/primitives.py``: pure
circuit algebra on the port's ``circuits``.

(Reference parity: forest/benchmarking/classical_logic/primitives.py —
CNOT_X_basis:5, CCNOT_X_basis:27, majority_gate:57, unmajority_add_gate:91,
unmajority_add_parallel_gate:124.)
"""
from __future__ import annotations

from forest_benchmarking_tpu_torch.circuits import (
    Circuit, CNOT, CCNOT, CZ, H, X)

__all__ = ["CNOT_X_basis", "CCNOT_X_basis", "majority_gate",
           "unmajority_add_gate", "unmajority_add_parallel_gate"]


def CNOT_X_basis(control, target) -> Circuit:  # noqa: N802
    """CNOT conjugated into the X basis: |+><+| ox I + |-><-| ox Z."""
    return Circuit([H(control), CZ(control, target), H(control)])


def CCNOT_X_basis(control1, control2, target) -> Circuit:  # noqa: N802
    """Toffoli in the X basis (H-conjugated on all three lines)."""
    return Circuit([H(control1), H(control2), H(target),
                    CCNOT(control1, control2, target),
                    H(control1), H(control2), H(target)])


def majority_gate(a: int, b: int, c: int, in_x_basis: bool = False) -> Circuit:
    """MAJ gate of [CDKM96]: leaves the majority of (a, b, c) on line a."""
    cnot_gate = CNOT_X_basis if in_x_basis else (lambda x, y: Circuit([CNOT(x, y)]))
    ccnot_gate = (CCNOT_X_basis if in_x_basis
                  else (lambda x, y, z: Circuit([CCNOT(x, y, z)])))
    return cnot_gate(a, b) + cnot_gate(a, c) + ccnot_gate(c, b, a)


def unmajority_add_gate(a: int, b: int, c: int, in_x_basis: bool = False) -> Circuit:
    """UMA gate of [CDKM96]: inverts MAJ and leaves the sum on line b."""
    cnot_gate = CNOT_X_basis if in_x_basis else (lambda x, y: Circuit([CNOT(x, y)]))
    ccnot_gate = (CCNOT_X_basis if in_x_basis
                  else (lambda x, y, z: Circuit([CCNOT(x, y, z)])))
    return ccnot_gate(c, b, a) + cnot_gate(a, c) + cnot_gate(c, b)


def unmajority_add_parallel_gate(a: int, b: int, c: int,
                                 in_x_basis: bool = False) -> Circuit:
    """3-CNOT UMA variant admitting more parallelism [CDKM96]."""
    cnot_gate = CNOT_X_basis if in_x_basis else (lambda x, y: Circuit([CNOT(x, y)]))
    ccnot_gate = (CCNOT_X_basis if in_x_basis
                  else (lambda x, y, z: Circuit([CCNOT(x, y, z)])))
    return (Circuit([X(b)]) + cnot_gate(a, b) + ccnot_gate(a, b, c)
            + Circuit([X(b)]) + cnot_gate(c, a) + cnot_gate(c, b))
