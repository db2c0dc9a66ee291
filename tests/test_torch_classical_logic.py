"""The port's reversible classical logic and ripple-carry adder against the
JAX package.

- The five primitives, and ``adder`` for every 2-bit pair of summands in
  both bases, gate for gate and in measurement order.
- ``get_qubit_registers_for_adder`` equal to the JAX package's layout on
  path graphs (its own default topology and every JAX test's), with and
  without ``qubits``; on cycles and grids, where the JAX package's
  ``networkx`` VF2 matcher and the port's depth-first search may pick
  different paths, a valid layout: 2n + 2 distinct nodes
  within ``qubits`` whose consecutive pairs are edges.
- The adder tests of ``tests/test_readout_and_logic.py:142-185`` on
  ``QVM(device="cpu")``; the adder programs' probabilities within
  ``PROB_BAR`` (1e-12) of the JAX package's float64 QVM; the success and
  Hamming-weight statistics equal on the same shots.
"""

import networkx as nx
import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.classical_logic as jcl
from forest_benchmarking_tpu_torch._graph import path_graph
from forest_benchmarking_tpu_torch.classical_logic import (
    CNOT_X_basis, CCNOT_X_basis, majority_gate, unmajority_add_gate,
    unmajority_add_parallel_gate, adder, get_qubit_registers_for_adder,
    assign_registers_to_line_or_cycle, get_n_bit_adder_results,
    get_success_probabilities_from_results,
    get_error_hamming_distributions_from_results)
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.sim.statevector import all_bitstrings
from torch_protocols import PROB_BAR, max_probability_gap, same_gates

torch.set_num_threads(1)

REGISTERS_2BIT = ([2, 4], [1, 3], 0, 5)


def as_lists(layout):
    reg_a, reg_b, carry, z = layout
    return list(reg_a), list(reg_b), carry, z


@pytest.mark.parametrize("x_basis", [False, True])
def test_primitives_equal_jax(x_basis):
    for a, b, c in ((0, 1, 2), (2, 0, 1), (5, 3, 4)):
        for ours, theirs in ((majority_gate, jcl.majority_gate),
                             (unmajority_add_gate, jcl.unmajority_add_gate),
                             (unmajority_add_parallel_gate,
                              jcl.unmajority_add_parallel_gate)):
            assert same_gates([ours(a, b, c, x_basis)],
                              [theirs(a, b, c, x_basis)])
        assert same_gates([CNOT_X_basis(a, b)], [jcl.CNOT_X_basis(a, b)])
        assert same_gates([CCNOT_X_basis(a, b, c)],
                          [jcl.CCNOT_X_basis(a, b, c)])


@pytest.mark.parametrize("x_basis", [False, True])
def test_adder_equals_jax_for_every_2bit_pair(x_basis):
    for bits in all_bitstrings(4):
        num_a, num_b = list(bits[:2]), list(bits[2:])
        ours, meas = adder(num_a, num_b, *REGISTERS_2BIT, in_x_basis=x_basis)
        theirs, their_meas = jcl.adder(num_a, num_b, *REGISTERS_2BIT,
                                       in_x_basis=x_basis)
        assert same_gates([ours], [theirs]) and meas == their_meas


# the layouts the JAX package gives (its VF2 matcher) on path graphs
PATH_CASES = [(8, 3, None), (10, 3, None), (10, 2, list(range(3, 9))),
              (6, 2, None), (12, 2, None), (12, 2, list(range(2, 10))),
              (12, 1, [5, 6, 7, 8, 9]), (16, 4, None), (9, 3, [0, 8, 1, 7, 2, 6,
                                                                3, 5, 4])]


@pytest.mark.parametrize("size,n_bits,qubits", PATH_CASES)
def test_registers_equal_jax_on_path_graphs(size, n_bits, qubits):
    theirs = as_lists(jcl.get_qubit_registers_for_adder(nx.path_graph(size),
                                                        n_bits, qubits))
    for topology in (nx.path_graph(size), path_graph(size),
                     [(q, q + 1) for q in range(size - 1)]):
        assert as_lists(get_qubit_registers_for_adder(topology, n_bits,
                                                      qubits)) == theirs


def test_registers_match_jaxs_on_the_default_path_graphs():
    assert as_lists(get_qubit_registers_for_adder(nx.path_graph(8), 3)) == \
        ([2, 4, 6], [1, 3, 5], 0, 7)
    assert as_lists(get_qubit_registers_for_adder(
        nx.path_graph(10), 2, qubits=list(range(3, 9)))) == \
        ([5, 7], [4, 6], 3, 8)


def assert_valid_layout(graph, layout, n_bits, qubits=None):
    reg_a, reg_b, carry, z = layout
    interleaved = [x for pair in zip(reg_b, reg_a) for x in pair]
    path = [carry] + interleaved + [z]
    assert len(reg_a) == len(reg_b) == n_bits
    assert len(set(path)) == len(path) == 2 * n_bits + 2
    allowed = set(graph.nodes) if qubits is None else set(qubits)
    assert set(path) <= allowed
    for u, v in zip(path, path[1:]):
        assert graph.has_edge(u, v), (u, v)


CYCLE_GRID_CASES = [
    (nx.cycle_graph(8), 3, None),
    (nx.convert_node_labels_to_integers(nx.grid_2d_graph(2, 4)), 3, None),
    (nx.grid_2d_graph(3, 3), 3, None),
    (nx.cycle_graph(10), 2, [9, 0, 1, 2, 3, 4]),
    (nx.petersen_graph(), 3, None),
]


@pytest.mark.parametrize("case", range(len(CYCLE_GRID_CASES)))
def test_registers_are_valid_on_cycles_and_grids(case):
    graph, n_bits, qubits = CYCLE_GRID_CASES[case]
    ours = get_qubit_registers_for_adder(graph, n_bits, qubits)
    assert_valid_layout(graph, ours, n_bits, qubits)
    # the JAX package's layout is valid too, but may be another one
    assert_valid_layout(graph, jcl.get_qubit_registers_for_adder(
        graph, n_bits, qubits), n_bits, qubits)


def test_cycle_layout_differs_from_jax():
    """Where a graph holds several paths the layouts may differ: on an
    8-cycle the JAX package's VF2 match starts the path at node 1, the
    port's depth-first search at node 0."""
    assert as_lists(jcl.get_qubit_registers_for_adder(nx.cycle_graph(8), 3)) \
        == ([7, 5, 3], [0, 6, 4], 1, 2)
    assert as_lists(get_qubit_registers_for_adder(nx.cycle_graph(8), 3)) == \
        ([2, 4, 6], [1, 3, 5], 0, 7)


def test_no_layout_raises_as_jax():
    for graph, n_bits, qubits in ((nx.path_graph(5), 3, None),
                                  (nx.star_graph(6), 2, None),
                                  (nx.path_graph(10), 2, [0, 1, 2, 4, 5, 6])):
        for fn in (get_qubit_registers_for_adder,
                   jcl.get_qubit_registers_for_adder):
            with pytest.raises(ValueError, match="appropriate layout"):
                fn(graph, n_bits, qubits)


# --- tests/test_readout_and_logic.py:142-185 on the port --------------------

def test_assign_registers_line():
    reg_a, reg_b, carry, z = assign_registers_to_line_or_cycle(
        0, nx.path_graph(6), 2)
    assert carry == 0
    assert reg_b == [1, 3] and reg_a == [2, 4]
    assert z == 5


def test_assign_registers_too_small():
    for fn in (assign_registers_to_line_or_cycle,
               jcl.assign_registers_to_line_or_cycle):
        with pytest.raises(ValueError, match="not enough qubits"):
            fn(0, nx.path_graph(3), 2)


def test_get_qubit_registers_for_adder():
    reg_a, reg_b, carry, z = get_qubit_registers_for_adder(path_graph(8), 3)
    assert len(reg_a) == 3 and len(reg_b) == 3


def test_adder_all_2bit_sums():
    results = get_n_bit_adder_results(QVM(seed=7, device="cpu"), 2,
                                      num_shots=20)
    probs = get_success_probabilities_from_results(results)
    assert len(probs) == 16
    assert np.allclose(probs, 1.0), probs
    distrs = get_error_hamming_distributions_from_results(results)
    for d in distrs:
        assert np.isclose(d[0], 1.0)


def test_adder_x_basis():
    prog, meas = adder([0, 1], [0, 1], *REGISTERS_2BIT, in_x_basis=True)
    bits = QVM(seed=8, device="cpu").run(prog, meas, 50)
    assert np.all(bits == [0, 1, 0])


def test_adder_mismatched_lengths():
    with pytest.raises(ValueError):
        adder([0], [0, 1], [0], [1], 2, 3)


# --- probabilities and statistics against the JAX package --------------------

@pytest.mark.parametrize("x_basis", [False, True])
def test_adder_probabilities_equal_jax(x_basis):
    programs, meas = [], []
    for bits in all_bitstrings(4):
        prog, order = adder(list(bits[:2]), list(bits[2:]), *REGISTERS_2BIT,
                            in_x_basis=x_basis)
        programs.append(prog)
        meas.append(order)
    assert max_probability_gap(programs, meas) <= PROB_BAR


class ReadoutQVM(QVM):
    """The adder example's noisy readout (p00 = 0.95, p11 = 0.92)."""

    def run(self, circuit, qubits, num_shots):
        noisy = circuit.copy()
        for q in qubits:
            noisy.define_noisy_readout(q, p00=0.95, p11=0.92)
        return super().run(noisy, qubits, num_shots)


def test_adder_statistics_equal_jax_on_the_same_shots():
    results = get_n_bit_adder_results(ReadoutQVM(seed=1, device="cpu"), 2,
                                      num_shots=50)
    assert get_success_probabilities_from_results(results) == \
        jcl.get_success_probabilities_from_results(results)
    assert get_error_hamming_distributions_from_results(results) == \
        jcl.get_error_hamming_distributions_from_results(results)
    assert np.mean(get_success_probabilities_from_results(results)) < 1


def test_adder_results_follow_registers_and_qubits():
    """``registers`` and ``qubits`` reach the layout as in the JAX package:
    the same programs, run in the same summand order."""
    seen = []

    class Recording:
        def run(self, prog, order, shots):
            seen.append((prog, order))
            return np.zeros((shots, len(order)), dtype=int)

    layouts = [(dict(qubits=[3, 2, 1, 0]), jcl.get_qubit_registers_for_adder(
        nx.path_graph(4), 1, [3, 2, 1, 0])),
               (dict(registers=([3], [2], 1, 0)), ([3], [2], 1, 0))]
    for kw, registers in layouts:
        seen.clear()
        get_n_bit_adder_results(Recording(), 1, num_shots=2, **kw)
        theirs = [jcl.adder(list(b[:1]), list(b[1:]), *registers)
                  for b in all_bitstrings(2)]
        assert len(seen) == len(theirs) == 4
        for (prog, order), (tprog, torder) in zip(seen, theirs):
            assert same_gates([prog], [tprog]) and order == torder
