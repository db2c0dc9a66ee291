"""Tableau-based Clifford engine: sampling, composition, inversion, Pauli
conjugation and native-gate decomposition (host numpy).

Port of ``forest_benchmarking_tpu/clifford.py``, with its public names and
its own copy of the code, which is pure numpy: the port imports nothing of
the JAX package. It replaces the reference's quilc ``BenchmarkConnection``
calls ``generate_rb_sequence`` and ``apply_clifford_to_pauli`` by
in-process symplectic-tableau computations.

Representation: a Clifford on n qubits is stored by the images of the 2n
generators X_0..X_{n-1}, Z_0..Z_{n-1} under conjugation, each image a Pauli
in the form ``i^phase * prod_i X_i^{x_i} * prod_i Z_i^{z_i}`` with phase in
Z4 (Hermitian Paulis always land on phase in {0, 2}, i.e. sign +-1).

For 1 and 2 qubits the full Clifford groups (24 and 11520 elements) are
enumerated once per process by a breadth-first search over {H, S, CZ}
generator words, giving exact-uniform sampling and table-lookup inversion
words. The search visits generators and stores elements in the JAX
package's order, so an element index names the same Clifford in both
packages and a seeded ``np.random.RandomState`` draws the same sequences,
gate for gate. Larger n samples uniform tableaus and synthesizes circuits.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from forest_benchmarking_tpu_torch.circuits import Circuit, Gate
from forest_benchmarking_tpu_torch.paulis import PauliTerm

__all__ = ["PauliBits", "CliffordTableau", "pauli_to_bits", "bits_to_pauli",
           "clifford_group", "random_clifford_circuits", "clifford_circuit_to_tableau",
           "apply_clifford_to_pauli", "generate_rb_sequence", "CLIFFORD_GROUP_SIZES",
           "synthesize_circuit", "random_clifford_tableau"]

CLIFFORD_GROUP_SIZES = {1: 24, 2: 11520}


@dataclass(frozen=True)
class PauliBits:
    """i^phase * X^x Z^z with x, z boolean arrays of length n, phase in Z4."""
    x: tuple
    z: tuple
    phase: int

    @property
    def n(self):
        return len(self.x)


def _pb(x, z, phase) -> PauliBits:
    return PauliBits(tuple(int(b) for b in x), tuple(int(b) for b in z),
                     int(phase) % 4)


def _pb_mul(a: PauliBits, b: PauliBits) -> PauliBits:
    """(X^xa Z^za)(X^xb Z^zb): commuting Z^za through X^xb gives (-1)^(za.xb)."""
    comm = sum(za & xb for za, xb in zip(a.z, b.x))
    x = tuple(xa ^ xb for xa, xb in zip(a.x, b.x))
    z = tuple(za ^ zb for za, zb in zip(a.z, b.z))
    return _pb(x, z, a.phase + b.phase + 2 * comm)


def _pb_identity(n: int) -> PauliBits:
    return _pb((0,) * n, (0,) * n, 0)


def pauli_to_bits(term: PauliTerm, qubits: Sequence[int]) -> PauliBits:
    """PauliTerm -> bit form over the given qubit order (sign from coefficient)."""
    coeff = complex(term.coefficient)
    phase_map = {1: 0, 1j: 1, -1: 2, -1j: 3}
    key = min(phase_map, key=lambda p: abs(coeff - p))
    if abs(coeff - key) > 1e-9:
        raise ValueError(f"Coefficient {coeff} is not a power of i")
    x = []
    z = []
    phase = phase_map[key]
    for q in qubits:
        op = term[q]
        x.append(1 if op in ("X", "Y") else 0)
        z.append(1 if op in ("Z", "Y") else 0)
        if op == "Y":  # Y = i X Z
            phase += 1
    return _pb(x, z, phase)


def bits_to_pauli(pb: PauliBits, qubits: Sequence[int]) -> PauliTerm:
    """Bit form -> PauliTerm (phase folded into the coefficient)."""
    ops = {}
    phase = pb.phase
    for q, xb, zb in zip(qubits, pb.x, pb.z):
        if xb and zb:
            ops[q] = "Y"
            phase -= 1  # X Z = -i Y
        elif xb:
            ops[q] = "X"
        elif zb:
            ops[q] = "Z"
    coeff = 1j ** (phase % 4)
    return PauliTerm(ops, coeff)


class CliffordTableau:
    """Images of the 2n Pauli generators under conjugation by the Clifford."""

    def __init__(self, images: List[PauliBits], n: int):
        assert len(images) == 2 * n
        self.images = images
        self.n = n

    @classmethod
    def identity(cls, n: int) -> "CliffordTableau":
        images = []
        for i in range(n):
            x = [0] * n
            x[i] = 1
            images.append(_pb(x, [0] * n, 0))
        for i in range(n):
            z = [0] * n
            z[i] = 1
            images.append(_pb([0] * n, z, 0))
        return cls(images, n)

    def image_of(self, pb: PauliBits) -> PauliBits:
        """Conjugate an arbitrary Pauli through this Clifford."""
        out = _pb_identity(self.n)
        for i, xb in enumerate(pb.x):
            if xb:
                out = _pb_mul(out, self.images[i])
        for i, zb in enumerate(pb.z):
            if zb:
                out = _pb_mul(out, self.images[self.n + i])
        return _pb(out.x, out.z, out.phase + pb.phase)

    def then(self, other: "CliffordTableau") -> "CliffordTableau":
        """The Clifford 'apply self first, then other' (U = U_other U_self)."""
        return CliffordTableau([other.image_of(img) for img in self.images],
                               self.n)

    def key(self) -> tuple:
        return tuple((p.x, p.z, p.phase) for p in self.images)

    def __eq__(self, other):
        return isinstance(other, CliffordTableau) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())


# ---------------------- gate tableaus (on n qubits) --------------------------

def _gate_tableau(name: str, qubits: Tuple[int, ...], n: int) -> CliffordTableau:
    """Tableau of a named Clifford gate embedded on n qubits."""
    t = CliffordTableau.identity(n)
    imgs = list(t.images)

    def setimg(kind, q, x, z, phase):
        idx = q if kind == "X" else n + q
        imgs[idx] = _pb(x, z, phase)

    def unit(q):
        v = [0] * n
        v[q] = 1
        return v

    zero = [0] * n
    if name == "H":
        (q,) = qubits
        setimg("X", q, zero, unit(q), 0)
        setimg("Z", q, unit(q), zero, 0)
    elif name == "S":
        (q,) = qubits
        setimg("X", q, unit(q), unit(q), 1)  # X -> Y = i X Z
    elif name == "SDG":
        (q,) = qubits
        setimg("X", q, unit(q), unit(q), 3)  # X -> -Y
    elif name == "X":
        (q,) = qubits
        setimg("Z", q, zero, unit(q), 2)
    elif name == "Y":
        (q,) = qubits
        setimg("X", q, unit(q), zero, 2)
        setimg("Z", q, zero, unit(q), 2)
    elif name == "Z":
        (q,) = qubits
        setimg("X", q, unit(q), zero, 2)
    elif name == "CNOT":
        c, t_ = qubits
        xc = [0] * n
        xc[c] = 1
        xc[t_] = 1
        setimg("X", c, xc, zero, 0)  # X_c -> X_c X_t
        zt = [0] * n
        zt_z = [0] * n
        zt_z[c] = 1
        zt_z[t_] = 1
        setimg("Z", t_, zero, zt_z, 0)  # Z_t -> Z_c Z_t
    elif name == "CZ":
        a, b = qubits
        za = [0] * n
        za[b] = 1
        setimg("X", a, unit(a), za, 0)  # X_a -> X_a Z_b
        zb = [0] * n
        zb[a] = 1
        setimg("X", b, unit(b), zb, 0)  # X_b -> Z_a X_b
    elif name == "SWAP":
        a, b = qubits
        setimg("X", a, unit(b), zero, 0)
        setimg("X", b, unit(a), zero, 0)
        setimg("Z", a, zero, unit(b), 0)
        setimg("Z", b, zero, unit(a), 0)
    else:
        raise ValueError(f"Not a supported Clifford gate: {name}")
    return CliffordTableau(imgs, n)


# words (as circuit-time gate sequences) for the rotation gates, up to global phase
_MAGIC_WORDS = {
    ("RZ", 0.5): [("S",)], ("RZ", -0.5): [("SDG",)], ("RZ", 1.0): [("Z",)],
    ("RZ", -1.0): [("Z",)],
    ("RX", 0.5): [("H",), ("S",), ("H",)], ("RX", -0.5): [("H",), ("SDG",), ("H",)],
    ("RX", 1.0): [("X",)], ("RX", -1.0): [("X",)],
    # RY(t) = S RX(t) S^dag  => circuit-time: SDG, RX, S
    ("RY", 0.5): [("SDG",), ("H",), ("S",), ("H",), ("S",)],
    ("RY", -0.5): [("SDG",), ("H",), ("SDG",), ("H",), ("S",)],
    ("RY", 1.0): [("Y",)], ("RY", -1.0): [("Y",)],
}


def _gate_to_tableau_word(gate: Gate, n: int, pos: Dict[int, int]) \
        -> List[CliffordTableau]:
    """Sequence of elementary tableaus realizing the gate (circuit order)."""
    name = gate.name
    qs = tuple(pos[q] for q in gate.qubits)
    if gate.matrix is not None:
        # custom-matrix gates: identity (e.g. no-op noise carriers) is fine
        mat = np.array(gate.matrix, dtype=complex)
        if np.allclose(mat, np.eye(mat.shape[0])):
            return []
        raise ValueError(f"Unsupported custom-matrix gate for tableau: {gate.name}")
    if name in ("I",):
        return []
    if name in ("H", "S", "X", "Y", "Z", "CNOT", "CZ", "SWAP"):
        t = _gate_tableau(name, qs, n)
        if gate.dagger and name in ("S",):
            t = _gate_tableau("SDG", qs, n)
        return [t]
    if name in ("RX", "RY", "RZ"):
        theta = gate.params[0] * (-1 if gate.dagger else 1)
        # Clifford-ness is mod 2*pi (up to global phase): wrap into [-1, 1)
        # so e.g. RZ(3*pi/2) == RZ(-pi/2) and RZ(2*pi - eps) == identity
        frac = (theta / np.pi + 1.0) % 2.0 - 1.0
        if np.isclose(frac, 0.0):
            return []
        for key_frac in (0.5, -0.5, 1.0, -1.0):
            if np.isclose(frac, key_frac):
                return [_gate_tableau(w[0], qs, n)
                        for w in _MAGIC_WORDS[(name, key_frac)]]
        raise ValueError(f"{name}({gate.params[0]}) is not Clifford")
    if name == "T":
        raise ValueError("T is not a Clifford gate")
    raise ValueError(f"Unsupported gate for Clifford tableau: {gate}")


def clifford_circuit_to_tableau(circuit: Circuit, qubits: Sequence[int]) \
        -> CliffordTableau:
    """Compose the tableau of a Clifford circuit over the given qubit order."""
    n = len(qubits)
    pos = {q: i for i, q in enumerate(qubits)}
    t = CliffordTableau.identity(n)
    for gate in circuit.gates:
        for g in _gate_to_tableau_word(gate, n, pos):
            t = t.then(g)
    return t


def apply_clifford_to_pauli(clifford: Circuit, pauli: PauliTerm,
                            qubits: Optional[Sequence[int]] = None) -> PauliTerm:
    """Conjugate ``pauli`` by the Clifford circuit: returns C P C^dagger.

    The analog of BenchmarkConnection.apply_clifford_to_pauli
    (direct_fidelity_estimation.py:50). If ``qubits`` is None, the union of the
    circuit's and the Pauli's qubits is used (sorted).
    """
    if qubits is None:
        qubits = sorted(set(clifford.get_qubits()) | set(pauli.get_qubits()))
    qubits = list(qubits)
    tab = clifford_circuit_to_tableau(clifford, qubits)
    pb = pauli_to_bits(pauli.copy(coefficient=1.0), qubits)
    out = tab.image_of(pb)
    result = bits_to_pauli(out, qubits)
    return result * complex(pauli.coefficient)


# ------------------------- group enumeration (n <= 2) ------------------------

@functools.lru_cache(maxsize=None)
def clifford_group(n: int):
    """BFS-enumerate the n-qubit Clifford group (n in {1, 2}).

    Returns (elements, words, index): ``elements`` is a list of tableaus,
    ``words[i]`` the generator word (list of (gate_name, qubit_positions))
    reaching element i, and ``index`` maps tableau key -> i. Sizes are checked
    against the known |C_1| = 24, |C_2| = 11520.
    """
    if n not in CLIFFORD_GROUP_SIZES:
        raise NotImplementedError(
            "Group enumeration implemented for n <= 2; for larger n sample "
            "uniformly with random_clifford_tableau (symplectic sampling).")
    gens = []
    for q in range(n):
        gens.append(("H", (q,)))
        gens.append(("S", (q,)))
    if n == 2:
        gens.append(("CZ", (0, 1)))
    gen_tabs = {g: _gate_tableau(g[0], g[1], n) for g in gens}

    ident = CliffordTableau.identity(n)
    elements = [ident]
    words = [[]]
    index = {ident.key(): 0}
    frontier = [0]
    while frontier:
        new_frontier = []
        for i in frontier:
            for g in gens:
                t = elements[i].then(gen_tabs[g])
                k = t.key()
                if k not in index:
                    index[k] = len(elements)
                    elements.append(t)
                    words.append(words[i] + [g])
                    new_frontier.append(index[k])
        frontier = new_frontier
    assert len(elements) == CLIFFORD_GROUP_SIZES[n], len(elements)
    return elements, words, index


def _word_to_circuit(word, qubits: Sequence[int]) -> Circuit:
    gates = []
    for name, pos in word:
        qs = tuple(qubits[p] for p in pos)
        if name == "SDG":
            gates.append(Gate("S", (), qs, dagger=True))
        else:
            gates.append(Gate(name, (), qs))
    return Circuit(gates)


def random_clifford_circuits(qubits: Sequence[int], count: int,
                             rng: Optional[np.random.RandomState] = None) \
        -> Tuple[List[Circuit], List[CliffordTableau]]:
    """Sample exact-uniform random Cliffords as circuits + tableaus (any n).

    n <= 2 uses the enumerated groups (word-table circuits); larger n samples
    uniform tableaus over F2 constraint spaces and synthesizes circuits.
    """
    if rng is None:
        rng = np.random
    n = len(qubits)
    if n in CLIFFORD_GROUP_SIZES:
        elements, words, _ = clifford_group(n)
        idxs = rng.randint(len(elements), size=count)
        circuits = [_word_to_circuit(words[i], qubits) for i in idxs]
        return circuits, [elements[i] for i in idxs]
    tabs = [random_clifford_tableau(n, rng) for _ in range(count)]
    circuits = [synthesize_circuit(t, qubits) for t in tabs]
    return circuits, tabs


def _inverse_circuit_of(tableau: CliffordTableau, qubits: Sequence[int]) -> Circuit:
    """Inverse as a circuit: reversed-dagger of the group word of the element.

    If U has word g1 g2 ... gk (circuit order), then U^-1 = gk^dag ... g1^dag.
    """
    elements, words, index = clifford_group(len(qubits))
    word = words[index[tableau.key()]]
    inv_gates = []
    for name, pos in reversed(word):
        qs = tuple(qubits[p] for p in pos)
        if name == "S":
            inv_gates.append(Gate("S", (), qs, dagger=True))
        elif name == "SDG":
            inv_gates.append(Gate("S", (), qs))
        else:  # H, CZ are self-inverse
            inv_gates.append(Gate(name, (), qs))
    return Circuit(inv_gates)


def generate_rb_sequence(qubits: Sequence[int], depth: int,
                         interleaved_gate: Optional[Circuit] = None,
                         rng: Optional[np.random.RandomState] = None,
                         use_basic_compile: bool = True) -> List[Circuit]:
    """A depth-long RB sequence composing to the identity.

    Mirrors BenchmarkConnection.generate_rb_sequence semantics
    (randomized_benchmarking.py:105-127): depth includes the final inverse
    element, so depth-1 Cliffords are sampled uniformly; with
    ``interleaved_gate`` the gate is interleaved after every random Clifford
    and folded into the inversion.

    :return: list of circuits (native-gate compiled when use_basic_compile).
    """
    from forest_benchmarking_tpu_torch.compilation import basic_compile
    if depth < 2:
        raise ValueError("Sequence depth must be at least 2 for rb sequences, "
                         "or at least 1 for unitarity sequences.")
    n = len(qubits)
    circuits, tabs = random_clifford_circuits(qubits, depth - 1, rng)
    total = CliffordTableau.identity(n)
    seq = []
    inter_tab = (None if interleaved_gate is None
                 else clifford_circuit_to_tableau(interleaved_gate, qubits))
    for circ, tab in zip(circuits, tabs):
        seq.append(circ)
        total = total.then(tab)
        if interleaved_gate is not None:
            seq.append(interleaved_gate)
            total = total.then(inter_tab)
    # the closing element is the inverse of everything so far
    if n in CLIFFORD_GROUP_SIZES:
        seq.append(_inverse_circuit_of(total, qubits))  # word-table lookup
    else:
        # synthesize a circuit for `total` and invert it
        seq.append(synthesize_circuit(total, qubits).dagger())
    if use_basic_compile:
        seq = [basic_compile(c) for c in seq]
    return seq


# ----------------------- general-n synthesis & sampling ----------------------

_RX_WORD = (("H",), ("S",), ("H",))  # conjugation: X->X, Y->Z, Z->-Y


def _apply_named(tab: CliffordTableau, name: str, qs: Tuple[int, ...],
                 word: list) -> CliffordTableau:
    """Compose ``tab`` with a named gate and record it in ``word``."""
    word.append((name, qs))
    return tab.then(_gate_tableau(name, qs, tab.n))


def synthesize_circuit(tableau: CliffordTableau,
                       qubits: Sequence[int]) -> Circuit:
    """Synthesize an H/S/CZ/CNOT/SWAP circuit realizing the tableau (any n).

    Column-by-column reduction: compose elementary gates until the tableau is
    the identity, then emit the inverse word reversed. Verified against the
    enumerated 1Q/2Q groups and random n-qubit gate products in tests.
    """
    n = tableau.n
    t = CliffordTableau(list(tableau.images), n)
    word: list = []

    for k in range(n):
        # ---- fix image of X_k to exactly X_k ----
        p = t.images[k]
        if not any(p.x):
            # pure-Z image: H on some support qubit converts Z->X there
            j = next(i for i in range(n) if p.z[i])
            t = _apply_named(t, "H", (j,), word)
            p = t.images[k]
        if not p.x[k]:
            j = next(i for i in range(k, n) if p.x[i]) \
                if any(p.x[k:]) else next(i for i in range(n) if p.x[i])
            t = _apply_named(t, "SWAP", (k, j), word)
            p = t.images[k]
        # clear the k-th z bit first (Y_k -> X_k) via S^dag
        if p.z[k]:
            t = _apply_named(t, "SDG", (k,), word)
            p = t.images[k]
        # clear other x bits with CNOT(k, j): X_k X_j -> X_k
        for j in range(n):
            if j != k and p.x[j]:
                # if the j component is Y, make it X first
                if p.z[j]:
                    t = _apply_named(t, "SDG", (j,), word)
                t = _apply_named(t, "CNOT", (k, j), word)
        p = t.images[k]
        # clear remaining z bits with CZ(k, j): X_k Z_j -> X_k
        for j in range(n):
            if j != k and p.z[j]:
                t = _apply_named(t, "CZ", (k, j), word)
        p = t.images[k]
        if p.z[k]:  # may have reappeared; S^dag again
            t = _apply_named(t, "SDG", (k,), word)
            p = t.images[k]
        if p.phase % 4 == 2:  # -X_k -> X_k via Z_k
            t = _apply_named(t, "Z", (k,), word)

        # ---- fix image of Z_k to exactly Z_k (without disturbing X_k) ----
        q = t.images[n + k]
        # clear x bits on j != k using H_j (+ SDG_j for Y); H_j acts off qubit k
        for j in range(n):
            if j != k and q.x[j]:
                if q.z[j]:
                    t = _apply_named(t, "SDG", (j,), word)
                t = _apply_named(t, "H", (j,), word)
        q = t.images[n + k]
        # clear x_k (Y_k component) with the RX word: fixes X_k, maps Y_k -> Z_k
        if q.x[k]:
            for g in _RX_WORD:
                t = _apply_named(t, g[0], (k,), word)
            q = t.images[n + k]
        # clear z bits on j != k with CNOT(j, k): Z_k Z_j -> Z_k, fixes X_k
        for j in range(n):
            if j != k and q.z[j]:
                t = _apply_named(t, "CNOT", (j, k), word)
        q = t.images[n + k]
        if q.phase % 4 == 2:  # -Z_k -> Z_k via X_k (fixes X_k)
            t = _apply_named(t, "X", (k,), word)

    assert t == CliffordTableau.identity(n), "synthesis failed to reduce"

    # T.then(g1)...(gm) = I  =>  U_T = U_{g1}^-1 ... U_{gm}^-1, so the circuit
    # (time order) is gm^-1, ..., g1^-1
    gates = []
    for name, pos in reversed(word):
        qs = tuple(qubits[p] for p in pos)
        if name == "S":
            gates.append(Gate("S", (), qs, dagger=True))
        elif name == "SDG":
            gates.append(Gate("S", (), qs))
        else:  # H, CZ, CNOT, SWAP, X, Z are self-inverse
            gates.append(Gate(name, (), qs))
    return Circuit(gates)


def _symplectic_product(a: PauliBits, b: PauliBits) -> int:
    """0 if the Paulis commute, 1 if they anticommute."""
    s = sum(ax & bz for ax, bz in zip(a.x, b.z))
    s += sum(az & bx for az, bx in zip(a.z, b.x))
    return s % 2


def _sample_pauli_with_constraints(n: int, constraints, parities,
                                   rng) -> PauliBits:
    """Uniform random Pauli v in F2^{2n} with <v, c_i> = parity_i for all i.

    The symplectic product with a constraint (cx, cz) is v.x*cz + v.z*cx; solve
    the linear system over F2 by elimination and randomize the free variables.
    Rejects v = 0 (resamples).
    """
    m = len(constraints)
    # build constraint matrix acting on v = (x bits | z bits)
    rows = np.zeros((m, 2 * n), dtype=np.int64)
    rhs = np.array(parities, dtype=np.int64) % 2
    for i, c in enumerate(constraints):
        rows[i, :n] = c.z  # pairs with v.x
        rows[i, n:] = c.x  # pairs with v.z
    # Gaussian elimination to row echelon form — loop-invariant, so it runs
    # ONCE; only the free-variable randomization below is inside the
    # rejection loop (rejection probability can reach 1/4 on the last
    # sampling steps, exactly where elimination is most expensive)
    a = rows.copy()
    b = rhs.copy()
    pivots = []
    r = 0
    for col in range(2 * n):
        piv = None
        for rr in range(r, m):
            if a[rr, col]:
                piv = rr
                break
        if piv is None:
            continue
        a[[r, piv]] = a[[piv, r]]
        b[[r, piv]] = b[[piv, r]]
        for rr in range(m):
            if rr != r and a[rr, col]:
                a[rr] ^= a[r]
                b[rr] ^= b[r]
        pivots.append(col)
        r += 1
        if r == m:
            break
    # (constraints are independent by construction; solvable)
    free_cols = [c for c in range(2 * n) if c not in pivots]
    while True:
        v = np.zeros(2 * n, dtype=np.int64)
        v[free_cols] = rng.randint(2, size=len(free_cols))
        for i in range(len(pivots) - 1, -1, -1):
            col = pivots[i]
            v[col] = (b[i] ^ (a[i] @ v % 2) ^ (a[i, col] & v[col])) % 2
        if v.any():
            # Hermitian Pauli: i^phase X^x Z^z requires phase = (#Y) mod 2,
            # plus a uniform sign (adding 2)
            y_count = int(np.sum(v[:n] & v[n:]))
            phase = (y_count % 2) + 2 * rng.randint(2)
            return _pb(v[:n], v[n:], phase)


def random_clifford_tableau(n: int,
                            rng: Optional[np.random.RandomState] = None) \
        -> CliffordTableau:
    """Uniform random n-qubit Clifford tableau (any n).

    Sample the generator images pair by pair: each X_k image is uniform over
    Paulis commuting with all previously fixed images, each Z_k image uniform
    over those additionally anticommuting with the X_k image; signs uniform.
    The count of valid choices per step is history-independent, so the overall
    distribution is exactly uniform over the group.
    """
    if rng is None:
        rng = np.random
    ximgs = []
    zimgs = []
    for k in range(n):
        constraints = []
        parities = []
        for j in range(k):
            constraints += [ximgs[j], zimgs[j]]
            parities += [0, 0]
        xk = _sample_pauli_with_constraints(n, constraints, parities, rng)
        zk = _sample_pauli_with_constraints(n, constraints + [xk],
                                            parities + [1], rng)
        ximgs.append(xk)
        zimgs.append(zk)
    return CliffordTableau(ximgs + zimgs, n)
