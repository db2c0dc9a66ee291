"""Entangled-state builders: GHZ (CNOT trees) and graph states.

Port of ``forest_benchmarking_tpu/entangled_states.py`` (reference parity:
forest/benchmarking/entangled_states.py — create_ghz_program:11,
ghz_state_statistics:36, create_graph_state:54, measure_graph_state:99,
compiled_parametric_graph_state:124).

Programs become Circuits; measurement is implicit in QVM.run, so the MEASURE
bookkeeping reduces to returning the qubit order to measure. A graph is a
list of ``(u, v)`` pairs (directed for the GHZ tree) or any object with
``nodes`` and ``edges``, such as a ``networkx`` graph; the port reads it
through its own :class:`~._graph._Graph`, in ``networkx``'s orders, and
does not import ``networkx``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from forest_benchmarking_tpu_torch._graph import _Graph
from forest_benchmarking_tpu_torch.circuits import Circuit, H, CNOT, CZ, RY
from forest_benchmarking_tpu_torch.compilation import basic_compile

__all__ = ["create_ghz_program", "ghz_state_statistics", "create_graph_state",
           "measure_graph_state", "compiled_parametric_graph_state"]


def create_ghz_program(tree) -> Tuple[Circuit, List[int]]:
    """GHZ state via a CNOT tree: H on the root, CNOT down each edge.

    :param tree: a directed tree: ``(parent, child)`` pairs, or a digraph
        object with ``nodes`` and ``edges``.
    :return: (circuit, qubit measurement order) — the order matches the
        reference's ro register layout (topological order of the tree).
    """
    tree = _Graph.from_any(tree, directed=True)
    assert tree.is_tree(), "Needs to be a tree"
    nodes = tree.topological_sort()
    program = Circuit([H(nodes[0])])
    for node in nodes:
        for child in tree.successors(node):
            program += CNOT(node, child)
    return program, nodes


def ghz_state_statistics(bitstrings) -> dict:
    """Count bitstrings consistent with a GHZ state (all zeros or all ones)."""
    bitstrings = np.asarray(bitstrings)
    bell = np.sum(np.logical_or(np.all(bitstrings == 0, axis=1),
                                np.all(bitstrings == 1, axis=1)))
    return {"bell": int(bell), "total": int(len(bitstrings))}


def create_graph_state(graph, use_pragmas: bool = False) -> Circuit:
    """Graph state: H on every node then CZ per edge [MBQC][MBCS].

    ``use_pragmas`` is accepted for API parity; the in-process simulator has no
    scheduling pragmas (CZs on disjoint edges commute regardless).
    """
    graph = _Graph.from_any(graph)
    program = Circuit()
    for q in graph.nodes:
        program += H(q)
    for a, b in graph.edges:
        program += CZ(a, b)
    return program


def measure_graph_state(graph, focal_node: int,
                        theta: float = 0.0) -> Tuple[Circuit, List[int]]:
    """Rotate the focal node by RY(theta) and measure it with its neighbors.

    :return: (circuit, qubit measurement order [focal, then sorted neighbors]).
        The reference returns classical register offsets; here the measurement
        order plays that role. ``theta`` replaces the run-time parameter.
    """
    graph = _Graph.from_any(graph)
    program = Circuit([RY(theta, focal_node)])
    neighbors = sorted(graph[focal_node])
    return program, [focal_node] + list(neighbors)


def compiled_parametric_graph_state(graph, focal_node: int,
                                    theta: float = 0.0) \
        -> Tuple[Circuit, List[int]]:
    """Full create-and-measure graph-state circuit in native gates.

    The reference compiles via a QPUCompiler and string-hacks a parameter slot
    (:124-146); in-process we simply build the circuit for the given theta and
    basic_compile it.
    """
    program = create_graph_state(graph)
    measure_prog, meas_qubits = measure_graph_state(graph, focal_node, theta)
    return basic_compile(program + measure_prog), meas_qubits
