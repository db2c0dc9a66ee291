"""The port's Clifford engine (``forest_benchmarking_tpu_torch.clifford``).

Mirrors tests/test_clifford.py on the port (tableau conjugation against
dense matrices from the port's simulator, group sizes, RB sequences,
synthesis and sampling), then holds the engine to the JAX package's on the
same inputs: the enumerated groups' words and elements, Pauli conjugation
of every two-qubit Pauli by sampled group elements, and the Cliffords,
tableaus and RB sequences that a seeded ``np.random.RandomState`` draws,
gate for gate. Both packages' two-qubit groups are built once per process
(a few seconds each), so every test that needs them is in this file and in
tests/test_torch_rb_protocol.py.
"""
import itertools

import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.clifford as jcl
import forest_benchmarking_tpu.paulis as jpaulis
from forest_benchmarking_tpu_torch.circuits import (
    Circuit, Gate, H, S, X, Y, Z, CZ, CNOT, SWAP, RX, RY, RZ)
from forest_benchmarking_tpu_torch.paulis import (
    sX, sY, sZ, str_to_pauli_term, pauli_term_to_matrix)
from forest_benchmarking_tpu_torch.clifford import (
    clifford_circuit_to_tableau, apply_clifford_to_pauli, clifford_group,
    random_clifford_circuits, generate_rb_sequence, CLIFFORD_GROUP_SIZES,
    pauli_to_bits, bits_to_pauli, synthesize_circuit,
    random_clifford_tableau, _symplectic_product)
from forest_benchmarking_tpu_torch.compilation import match_global_phase
from forest_benchmarking_tpu_torch.randomized_benchmarking import (
    circuit_unitary_np)
from forest_benchmarking_tpu_torch.sim.statevector import run_statevector
from torch_protocols import same_gates, to_jax_circuit as to_jax

torch.set_num_threads(1)


def circuit_unitary(circuit, qubits):
    n = len(qubits)
    cols = []
    for i in range(2 ** n):
        prep = Circuit([X(qubits[j]) for j in range(n)
                        if (i >> (n - 1 - j)) & 1])
        cols.append(run_statevector(prep + circuit, qubits,
                                    device="cpu").numpy())
    return np.stack(cols, axis=1)


def dense_conjugate(circuit, pauli, qubits):
    u = circuit_unitary(circuit, qubits)
    p = pauli_term_to_matrix(pauli, qubits)
    return u @ p @ u.conj().T


def composes_to_identity(seq, qubits):
    total = Circuit()
    for c in seq:
        total += c
    u = circuit_unitary(total, qubits)
    phase = u[0, 0] / abs(u[0, 0])
    return np.allclose(u / phase, np.eye(2 ** len(qubits)), atol=1e-9)


PAULIS_2Q = ["XI", "IX", "YI", "IY", "ZI", "IZ", "XX", "YZ", "ZY", "XZ", "YY"]


# --- tests/test_clifford.py on the port ------------------------------------

@pytest.mark.parametrize("circuit,qubits", [
    (Circuit([H(0)]), [0]),
    (Circuit([S(0)]), [0]),
    (Circuit([S(0).dag()]), [0]),
    (Circuit([X(0)]), [0]),
    (Circuit([Y(0)]), [0]),
    (Circuit([Z(0)]), [0]),
    (Circuit([RX(np.pi / 2, 0)]), [0]),
    (Circuit([RX(-np.pi / 2, 0)]), [0]),
    (Circuit([RY(np.pi / 2, 0)]), [0]),
    (Circuit([RY(-np.pi / 2, 0)]), [0]),
    (Circuit([RZ(np.pi / 2, 0)]), [0]),
    (Circuit([RZ(-np.pi / 2, 0)]), [0]),
    (Circuit([RZ(np.pi, 0)]), [0]),
    (Circuit([H(0), S(0), H(0), S(0).dag()]), [0]),
    (Circuit([CZ(0, 1)]), [0, 1]),
    (Circuit([CNOT(0, 1)]), [0, 1]),
    (Circuit([CNOT(1, 0)]), [0, 1]),
    (Circuit([SWAP(0, 1)]), [0, 1]),
    (Circuit([H(0), CNOT(0, 1), S(1), CZ(0, 1), H(1)]), [0, 1]),
])
def test_conjugation_matches_dense(circuit, qubits):
    """Tableau conjugation equals the dense U P U^dag for every Pauli."""
    paulis = (["X", "Y", "Z"] if len(qubits) == 1 else PAULIS_2Q)
    for ps in paulis:
        pauli = str_to_pauli_term(ps, qubits)
        result = apply_clifford_to_pauli(circuit, pauli, qubits)
        expected = dense_conjugate(circuit, pauli, qubits)
        got = pauli_term_to_matrix(result, qubits)
        assert np.allclose(got, expected, atol=1e-10), \
            f"{circuit} on {ps}: got {result}"


def test_pauli_bits_round_trip():
    for ps in PAULIS_2Q:
        term = str_to_pauli_term(ps, [0, 1])
        assert bits_to_pauli(pauli_to_bits(term, [0, 1]), [0, 1]) == term
    term = str_to_pauli_term("XY", [0, 1]) * -1
    assert bits_to_pauli(pauli_to_bits(term, [0, 1]), [0, 1]) == term


@pytest.mark.parametrize("n", [1, 2])
def test_clifford_group_sizes(n):
    elements, words, index = clifford_group(n)
    assert len(elements) == CLIFFORD_GROUP_SIZES[n]
    assert len(index) == len(elements)


def test_group_words_reproduce_elements():
    elements, words, index = clifford_group(1)
    for i in (0, 5, 17, 23):
        circ = Circuit([Gate(nm, (), (0,)) if nm != "SDG"
                        else Gate("S", (), (0,), dagger=True)
                        for nm, pos in words[i]])
        assert clifford_circuit_to_tableau(circ, [0]) == elements[i]


def test_random_cliffords_cover_group():
    circs, tabs = random_clifford_circuits([0], 500,
                                           np.random.RandomState(0))
    assert len({t.key() for t in tabs}) == 24


def test_rb_sequence_composes_to_identity():
    rng = np.random.RandomState(1)
    for qubits in ([0], [0, 1]):
        for depth in (2, 5, 10):
            seq = generate_rb_sequence(qubits, depth, rng=rng,
                                       use_basic_compile=False)
            assert len(seq) == depth
            assert composes_to_identity(seq, qubits)


def test_rb_sequence_native_gates():
    seq = generate_rb_sequence([0, 1], 4, rng=np.random.RandomState(2),
                               use_basic_compile=True)
    for circ in seq:
        for g in circ.gates:
            assert g.name in ("RX", "RZ", "CZ", "XY", "I")


def test_interleaved_rb_sequence():
    depth = 4
    seq = generate_rb_sequence([0, 1], depth, interleaved_gate=Circuit(
        [CZ(0, 1)]), rng=np.random.RandomState(3), use_basic_compile=False)
    assert len(seq) == 2 * (depth - 1) + 1
    assert composes_to_identity(seq, [0, 1])


def test_rb_depth_too_small_raises():
    with pytest.raises(ValueError):
        generate_rb_sequence([0], 1)


def test_apply_clifford_preserves_coefficient():
    out = apply_clifford_to_pauli(Circuit([H(0)]), sX(0) * -2.0, [0])
    assert out == sZ(0) * -2.0


def test_known_conjugations():
    assert apply_clifford_to_pauli(Circuit([H(0)]), sX(0), [0]) == sZ(0)
    assert apply_clifford_to_pauli(Circuit([H(0)]), sZ(0), [0]) == sX(0)
    assert apply_clifford_to_pauli(Circuit([H(0)]), sY(0), [0]) == sY(0) * -1
    assert apply_clifford_to_pauli(Circuit([S(0)]), sX(0), [0]) == sY(0)
    out = apply_clifford_to_pauli(Circuit([CNOT(0, 1)]), sX(0), [0, 1])
    assert out == sX(0) * sX(1)


def test_synthesis_round_trip_1q_2q_groups():
    for n in (1, 2):
        elements, words, _ = clifford_group(n)
        idxs = np.random.RandomState(n).randint(len(elements), size=40)
        for i in idxs:
            circ = synthesize_circuit(elements[i], list(range(n)))
            assert clifford_circuit_to_tableau(
                circ, list(range(n))) == elements[i]


def random_gate_product(rng, n_qubits=3, n_gates=12):
    gates = ["H", "S", "CZ", "CNOT", "SWAP", "X", "Z"]
    c = Circuit()
    for _ in range(n_gates):
        name = gates[rng.randint(len(gates))]
        if name in ("H", "S", "X", "Z"):
            c += Gate(name, (), (int(rng.randint(n_qubits)),))
        else:
            a, b = rng.choice(n_qubits, size=2, replace=False)
            c += Gate(name, (), (int(a), int(b)))
    return c


def test_synthesis_round_trip_3q_random_products():
    rng = np.random.RandomState(0)
    for trial in range(20):
        tab = clifford_circuit_to_tableau(random_gate_product(rng),
                                          [0, 1, 2])
        circ = synthesize_circuit(tab, [0, 1, 2])
        assert clifford_circuit_to_tableau(circ, [0, 1, 2]) == tab, trial


def test_random_clifford_tableau_valid_and_uniformish():
    rng = np.random.RandomState(1)
    for n in (1, 2, 3, 4):
        t = random_clifford_tableau(n, rng)
        for i in range(n):
            for j in range(n):
                xi, zj = t.images[i], t.images[n + j]
                assert _symplectic_product(xi, zj) == (1 if i == j else 0)
                assert _symplectic_product(t.images[i], t.images[j]) == 0
                assert _symplectic_product(t.images[n + i],
                                           t.images[n + j]) == 0
    counts = {}
    for _ in range(2400):
        t = random_clifford_tableau(1, rng)
        counts[t.key()] = counts.get(t.key(), 0) + 1
    assert len(counts) == 24
    assert np.array(list(counts.values())).min() > 50


def test_random_clifford_2q_covers_group():
    elements, _, index = clifford_group(2)
    rng = np.random.RandomState(2)
    seen = set()
    for _ in range(300):
        t = random_clifford_tableau(2, rng)
        assert t.key() in index
        seen.add(t.key())
    assert len(seen) > 290


def test_3q_rb_sequence_composes_to_identity():
    rng = np.random.RandomState(3)
    for depth in (2, 4):
        seq = generate_rb_sequence([0, 1, 2], depth, rng=rng,
                                   use_basic_compile=False)
        assert len(seq) == depth
        assert composes_to_identity(seq, [0, 1, 2])


def test_three_qubit_rb_sequence_compiles_and_inverts():
    """Three-qubit RB goes through synthesis, whose sign fixes emit Z
    gates; the compiled sequence still composes to the identity."""
    qubits = [0, 1, 2]
    u = np.eye(8, dtype=complex)
    for c in generate_rb_sequence(qubits, 3, rng=np.random.RandomState(0)):
        u = circuit_unitary_np(c, qubits) @ u
    a1, a2 = match_global_phase(u, np.eye(8, dtype=complex))
    assert np.abs(np.asarray(a1) - np.asarray(a2)).max() < 1e-9


def test_clifford_rotation_angles_wrap_mod_2pi():
    for theta in (3 * np.pi / 2, -np.pi / 2, 7 * np.pi / 2):
        out = apply_clifford_to_pauli(Circuit([RZ(theta, 0)]), sX(0), [0])
        assert str(out) == "(-1+0j)*Y0", (theta, out)
    out = apply_clifford_to_pauli(Circuit([RZ(2 * np.pi - 1e-12, 0)]),
                                  sX(0), [0])
    assert str(out) == str(sX(0))


# --- against the JAX package on the same inputs -----------------------------

@pytest.mark.parametrize("n", [1, 2])
def test_group_words_and_elements_equal_jax(n):
    """The breadth-first search visits and stores in JAX's order, so index
    i names the same Clifford, by the same word, in both packages."""
    elements, words, index = clifford_group(n)
    j_elements, j_words, j_index = jcl.clifford_group(n)
    assert words == j_words
    assert [e.key() for e in elements] == [e.key() for e in j_elements]
    assert list(index.items()) == list(j_index.items())


def test_conjugation_of_all_2q_paulis_equals_jax():
    """C P C^dag of every two-qubit Pauli, with a coefficient, by sampled
    elements of the group (as their word circuits): equal terms and
    coefficients in both packages."""
    qubits = [0, 1]
    circuits, _ = random_clifford_circuits(qubits, 24,
                                           np.random.RandomState(5))
    labels = ["".join(p) for p in itertools.product("IXYZ", repeat=2)]
    for circ in circuits:
        jc = to_jax(circ)
        for lab, coeff in zip(labels, itertools.cycle((1.0, -1.0, -0.5))):
            ours = apply_clifford_to_pauli(
                circ, str_to_pauli_term(lab, qubits) * coeff, qubits)
            theirs = jcl.apply_clifford_to_pauli(
                jc, jpaulis.str_to_pauli_term(lab, qubits) * coeff, qubits)
            assert ours.operations_as_set() == theirs.operations_as_set()
            assert complex(ours.coefficient) == complex(theirs.coefficient)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (3, 2), (4, 3)])
def test_seeded_random_cliffords_equal_jax(n, seed):
    """The same RandomState draws the same Cliffords: tableaus and
    circuits (word circuits for n <= 2, synthesized ones above)."""
    qubits = list(range(n))
    circs, tabs = random_clifford_circuits(qubits, 16,
                                           np.random.RandomState(seed))
    j_circs, j_tabs = jcl.random_clifford_circuits(
        qubits, 16, np.random.RandomState(seed))
    assert [t.key() for t in tabs] == [t.key() for t in j_tabs]
    assert same_gates(circs, j_circs, bar=0.0)


@pytest.mark.parametrize("qubits,interleaved,compiled", [
    ([0], False, True), ([0, 1], False, True), ([0, 1], True, True),
    ([0, 1], True, False), ([0, 1, 2], False, True),
    ([0, 1, 2], False, False)])
def test_seeded_rb_sequences_equal_jax(qubits, interleaved, compiled):
    """``generate_rb_sequence`` with the same RandomState seed: the same
    gates in the same order, parameters within 1e-12, at several depths."""
    gate = Circuit([CZ(0, 1)]) if interleaved else None
    j_gate = to_jax(gate) if interleaved else None
    for seed, depth in ((0, 2), (1, 5), (2, 9)):
        ours = generate_rb_sequence(qubits, depth, gate,
                                    rng=np.random.RandomState(seed),
                                    use_basic_compile=compiled)
        theirs = jcl.generate_rb_sequence(qubits, depth, j_gate,
                                          rng=np.random.RandomState(seed),
                                          use_basic_compile=compiled)
        assert len(ours) == len(theirs)
        assert same_gates(ours, theirs), (seed, depth)


def test_synthesis_equals_jax():
    rng = np.random.RandomState(7)
    for _ in range(10):
        c = random_gate_product(rng, n_qubits=4, n_gates=20)
        tab = clifford_circuit_to_tableau(c, [0, 1, 2, 3])
        j_tab = jcl.clifford_circuit_to_tableau(to_jax(c), [0, 1, 2, 3])
        assert tab.key() == j_tab.key()
        assert same_gates([synthesize_circuit(tab, [3, 1, 0, 2])],
                          [jcl.synthesize_circuit(j_tab, [3, 1, 0, 2])],
                          bar=0.0)
