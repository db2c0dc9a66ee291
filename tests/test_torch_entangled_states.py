"""The port's entangled-state builders and its graph type, against the JAX
package and ``networkx``.

- ``_graph._Graph`` keeps ``networkx``'s orders (nodes, edges, neighbours,
  the topological order of branching trees), built from edge lists and from
  ``networkx`` graphs; the port itself never imports ``networkx``.
- Every builder gives the JAX package's circuit gate for gate and its
  measurement order, from edge lists and from ``networkx`` graphs.
- The entangled-state tests of ``tests/test_readout_and_logic.py:78-115``
  run on ``QVM(device="cpu")`` at the JAX suite's bars.
- GHZ and graph-state probabilities within ``PROB_BAR`` (1e-12) of the JAX
  package's float64 QVM.
"""
import networkx as nx
import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.entangled_states as jes
from forest_benchmarking_tpu_torch._graph import _Graph, path_graph
from forest_benchmarking_tpu_torch.entangled_states import (
    create_ghz_program, ghz_state_statistics, create_graph_state,
    measure_graph_state, compiled_parametric_graph_state)
from forest_benchmarking_tpu_torch.paulis import str_to_pauli_term
from forest_benchmarking_tpu_torch.sim import QVM
from torch_protocols import PROB_BAR, max_probability_gap, same_gates

torch.set_num_threads(1)

# directed trees with branching, given in an order that is not the
# topological one, and with node labels that are not positional
TREES = {
    "chain": [(0, 1), (1, 2)],
    "branching": [(0, 1), (0, 2), (1, 3), (1, 4), (2, 5), (2, 6), (5, 7)],
    "scrambled": [(3, 7), (0, 3), (5, 2), (0, 5), (3, 1), (5, 4), (2, 6)],
    "wide": [(4, 0), (4, 1), (4, 2), (4, 3), (2, 5), (2, 6)],
    "deep_first": [(6, 5), (5, 4), (4, 3), (6, 2), (2, 1), (1, 0)],
}

# undirected graphs for the graph states: edge lists whose first-appearance
# order and neighbour insertion order differ from sorted order
GRAPHS = {
    "path3": [(0, 1), (1, 2)],
    "reversed": [(1, 2), (0, 1)],
    "cycle5": [(q, (q + 1) % 5) for q in range(5)],
    "star": [(2, 0), (2, 3), (2, 1), (2, 4)],
    "random": list(nx.gnp_random_graph(6, 0.5, seed=3).edges),
    "shuffled": [(3, 1), (0, 2), (1, 0), (2, 3), (3, 0)],
}


def nx_digraph(edges):
    return nx.DiGraph(edges)


def nx_graph(edges):
    return nx.Graph(edges)


# --- the graph type against networkx ---------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_orders_equal_networkx(name):
    edges = GRAPHS[name]
    theirs = nx_graph(edges)
    for ours in (_Graph(edges), _Graph.from_any(theirs)):
        assert ours.nodes == list(theirs.nodes)
        assert ours.edges == list(theirs.edges)
        for node in theirs.nodes:
            assert ours.neighbors(node) == list(theirs.neighbors(node))
            assert sorted(ours[node]) == sorted(theirs[node])
            assert ours.degree(node) == theirs.degree(node)
        assert ours.is_tree() == nx.is_tree(theirs)


@pytest.mark.parametrize("name", sorted(TREES))
def test_topological_order_equals_networkx(name):
    edges = TREES[name]
    theirs = nx_digraph(edges)
    for ours in (_Graph(edges, directed=True), _Graph.from_any(theirs)):
        assert ours.directed
        assert ours.topological_sort() == list(nx.topological_sort(theirs))
        assert ours.edges == list(theirs.edges)
        assert ours.is_tree() == nx.is_tree(theirs)
        for node in theirs.nodes:
            assert ours.successors(node) == list(theirs.successors(node))


def test_graph_edits_and_path_graph_equal_networkx():
    ours, theirs = path_graph(7), nx.path_graph(7)
    assert ours.nodes == list(theirs.nodes) and ours.edges == list(theirs.edges)
    for node in (3, 0):
        ours.remove_node(node)
        theirs.remove_node(node)
        assert ours.nodes == list(theirs.nodes)
        assert ours.edges == list(theirs.edges)
        assert [ours.degree(n) for n in ours.nodes] == \
            [theirs.degree(n) for n in theirs.nodes]
    copy = ours.copy()
    copy.remove_node(5)
    assert 5 in ours and 5 not in copy
    cyclic = _Graph([(0, 1), (1, 2), (2, 0)], directed=True)
    assert not cyclic.is_tree() and not _Graph().is_tree()
    with pytest.raises(ValueError, match="cycle"):
        cyclic.topological_sort()
    with pytest.raises(ValueError, match="undirected"):
        _Graph([(0, 1)]).topological_sort()


# --- the builders against the JAX package -----------------------------------

@pytest.mark.parametrize("name", sorted(TREES))
def test_ghz_program_equals_jax(name):
    theirs, their_order = jes.create_ghz_program(nx_digraph(TREES[name]))
    for tree in (TREES[name], nx_digraph(TREES[name])):
        ours, order = create_ghz_program(tree)
        assert same_gates([ours], [theirs])
        assert order == their_order


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_state_builders_equal_jax(name):
    graph = nx_graph(GRAPHS[name])
    for ours_in in (GRAPHS[name], graph):
        assert same_gates([create_graph_state(ours_in)],
                          [jes.create_graph_state(graph)])
        for focal in graph.nodes:
            ours, meas = measure_graph_state(ours_in, focal, theta=0.3)
            theirs, their_meas = jes.measure_graph_state(graph, focal,
                                                         theta=0.3)
            assert same_gates([ours], [theirs]) and meas == their_meas
        focal = next(iter(graph.nodes))
        ours, meas = compiled_parametric_graph_state(ours_in, focal, 0.7)
        theirs, their_meas = jes.compiled_parametric_graph_state(graph, focal,
                                                                 0.7)
        assert same_gates([ours], [theirs]) and meas == their_meas


# --- tests/test_readout_and_logic.py:78-115 on the port ---------------------

def test_ghz_program_statistics():
    qvm = QVM(seed=5, device="cpu")
    program, nodes = create_ghz_program([(0, 1), (1, 2)])
    bits = qvm.run(program, nodes, 2000)
    stats = ghz_state_statistics(bits)
    assert stats["total"] == 2000
    assert stats["bell"] / stats["total"] > 0.99


def test_ghz_requires_tree():
    with pytest.raises(AssertionError):
        create_ghz_program([(0, 1), (1, 2), (2, 0)])
    with pytest.raises(AssertionError):
        create_ghz_program(nx.from_edgelist([(0, 1), (1, 2), (2, 0)],
                                            create_using=nx.DiGraph))


def test_graph_state_stabilizers():
    qvm = QVM(seed=6, device="cpu")
    program = create_graph_state(nx.path_graph(2))
    for s in ["XZ", "ZX"]:
        val = qvm.expectation(program, [0, 1], str_to_pauli_term(s, [0, 1]))
        assert np.isclose(val, 1.0, atol=1e-10), s


def test_measure_graph_state():
    prog, meas = measure_graph_state(path_graph(3), focal_node=1, theta=0.5)
    assert meas == [1, 0, 2]
    full, meas2 = compiled_parametric_graph_state([(0, 1), (1, 2)], 1,
                                                  theta=0.5)
    assert meas2 == meas
    for g in full.gates:
        assert g.name in ("RX", "RZ", "CZ", "XY", "I")


# --- probabilities against the JAX package's QVM -----------------------------

def test_entangled_state_probabilities_equal_jax():
    programs, meas = [], []
    for edges in TREES.values():
        program, nodes = create_ghz_program(edges)
        programs.append(program)
        meas.append(nodes)
    for edges in GRAPHS.values():
        graph = _Graph(edges)
        focal = graph.nodes[0]
        state = create_graph_state(edges)
        rotation, order = measure_graph_state(edges, focal, theta=0.4)
        compiled, _ = compiled_parametric_graph_state(edges, focal, 0.4)
        programs += [state + rotation, compiled]
        meas += [graph.nodes, order]
    assert max_probability_gap(programs, meas) <= PROB_BAR
