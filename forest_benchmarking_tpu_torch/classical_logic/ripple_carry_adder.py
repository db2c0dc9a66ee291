"""CDKM ripple-carry adder benchmark [CDKM96] (arXiv:quant-ph/0410184).

Port of ``forest_benchmarking_tpu/classical_logic/ripple_carry_adder.py``.
A topology is a list of ``(u, v)`` pairs or any object with ``nodes`` and
``edges`` (a ``networkx`` graph), read through the port's own
:class:`~.._graph._Graph`; the port does not import ``networkx``.
:func:`get_qubit_registers_for_adder` finds its layout by a depth-first
search for a simple path, not by ``networkx``'s VF2 matcher: the same
layout on path graphs, another valid one where a graph holds several paths.

Reference parity: forest/benchmarking/classical_logic/ripple_carry_adder.py —
assign_registers_to_line_or_cycle:37, get_qubit_registers_for_adder:90
(subgraph monomorphism via line graph), adder:149, get_n_bit_adder_results:248,
get_success_probabilities_from_results:317,
get_error_hamming_distributions_from_results:350.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from forest_benchmarking_tpu_torch._graph import _Graph, path_graph
from forest_benchmarking_tpu_torch.circuits import Circuit, CNOT, H
from forest_benchmarking_tpu_torch.classical_logic.primitives import (
    CNOT_X_basis, majority_gate, unmajority_add_gate)
from forest_benchmarking_tpu_torch.utils import (
    bit_array_to_int, int_to_bit_array, bitstring_prep, progress_iter)
from forest_benchmarking_tpu_torch.sim.statevector import all_bitstrings

__all__ = ["assign_registers_to_line_or_cycle", "get_qubit_registers_for_adder",
           "adder", "get_n_bit_adder_results",
           "get_success_probabilities_from_results",
           "get_error_hamming_distributions_from_results", "REG_NAME"]

# classical-register name the reference binds input bitstrings to
# (ripple_carry_adder.py:34); the in-process executor preps bitstrings
# directly (utils.bitstring_prep), so this is kept for name/API parity
REG_NAME = "input"


def assign_registers_to_line_or_cycle(start: int, graph,
                                      num_length: int) \
        -> Tuple[Sequence[int], Sequence[int], int, int]:
    """Assign adder registers walking a line/cycle graph from ``start``
    (figure 4 layout of [CDKM96]: carry, b0, a0, ..., bn, an, z)."""
    graph = _Graph.from_any(graph)
    n_needed = 2 * num_length + 2
    if n_needed > len(graph):
        raise ValueError("There are not enough qubits in the graph to support "
                         "the computation.")
    # Extract a simple path of n_needed nodes rooted at `start` by greedily
    # stepping to any not-yet-visited neighbor (unambiguous on a line/cycle),
    # then read the register layout straight off the path: figure 4 of
    # [CDKM96] is carry, b0, a0, b1, a1, ..., b_{n-1}, a_{n-1}, z.
    path = [start]
    visited = {start}
    while len(path) < n_needed:
        fresh = [v for v in graph.neighbors(path[-1]) if v not in visited]
        if not fresh:
            raise ValueError("The qubit path dead-ends after "
                             f"{len(path)} nodes; register assignment failed.")
        path.append(fresh[0])
        visited.add(fresh[0])
    interleaved = path[1:-1]
    return interleaved[1::2], interleaved[0::2], path[0], path[-1]


def _simple_path(graph: _Graph, n_nodes: int) -> Optional[List]:
    """The first simple path of ``n_nodes`` nodes that a depth-first search
    finds: start nodes in node order, neighbours in order; None if there is
    none."""
    def extend(path, on_path):
        if len(path) == n_nodes:
            return path
        for v in graph.neighbors(path[-1]):
            if v not in on_path:
                on_path.add(v)
                found = extend(path + [v], on_path)
                if found:
                    return found
                on_path.discard(v)
        return None

    for start in graph.nodes:
        found = extend([start], {start})
        if found:
            return found
    return None


def get_qubit_registers_for_adder(topology, num_length: int,
                                  qubits: Optional[Sequence[int]] = None) \
        -> Tuple[Sequence[int], Sequence[int], int, int]:
    """Find a path layout for the adder in the given qubit topology.

    The reference takes a QuantumComputer and uses its topology (:90); here the
    topology graph is passed directly (the in-process simulator is
    all-to-all, so any graph you like): ``(u, v)`` pairs or an object with
    ``nodes`` and ``edges``.

    The JAX package takes the first match of ``networkx``'s VF2 matcher of a
    path on the line graph; the port takes the first simple path of
    2 n + 2 nodes of a depth-first search (:func:`_simple_path`). On path
    graphs both give the same layout; on graphs with several such paths
    (cycles, grids) each gives a valid one, not always the same.
    """
    graph = _Graph.from_any(topology)
    if qubits is not None:
        for qubit in list(graph.nodes):
            if qubit not in qubits:
                graph.remove_node(qubit)

    num_desired_nodes = 2 * num_length + 2
    path = _simple_path(graph, num_desired_nodes)
    if path is None:
        raise ValueError("An appropriate layout for the qubits could not be "
                         "found among the provided qubits.")
    on_path = set(path)
    subgraph = _Graph()
    for node in graph.nodes:
        if node in on_path:
            subgraph.add_node(node)
    for u, v in zip(path, path[1:]):
        subgraph.add_edge(u, v)
    start_node = -1
    for node in subgraph.nodes:
        if subgraph.degree(node) == 1:
            start_node = node
            break
    return assign_registers_to_line_or_cycle(start_node, subgraph, num_length)


def adder(num_a: Sequence[int], num_b: Sequence[int],
          register_a: Sequence[int], register_b: Sequence[int],
          carry_ancilla: int, z_ancilla: int, in_x_basis: bool = False,
          use_param_program: bool = False) -> Tuple[Circuit, Sequence[int]]:
    """Reversible ripple-carry addition a + b [CDKM96].

    :param num_a: bits of a, least significant bit LAST.
    :param num_b: bits of b, least significant bit LAST.
    :param register_a: qubits for a, least significant bit FIRST.
    :param register_b: qubits for b, least significant bit FIRST.
    :return: (circuit, measurement qubit order). The measurement order is
        [z_ancilla, register_b reversed], so a measured bitstring reads the sum
        most-significant-bit first — matching the reference's ro layout.
    """
    if len(num_a) != len(num_b):
        raise ValueError("Numbers being added must be equal length bitstrings")

    prog = Circuit()
    prog += bitstring_prep(register_a, list(num_a)[::-1], in_x_basis=in_x_basis)
    prog += bitstring_prep(register_b, list(num_b)[::-1], in_x_basis=in_x_basis)
    if in_x_basis:
        prog += H(carry_ancilla)
        prog += H(z_ancilla)

    prog_to_rev = Circuit()
    current_carry_label = carry_ancilla
    for (a, b) in zip(register_a, register_b):
        prog += majority_gate(a, b, current_carry_label, in_x_basis)
        prog_to_rev += unmajority_add_gate(a, b, current_carry_label,
                                           in_x_basis).dagger()
        current_carry_label = a

    undo_and_add_prog = prog_to_rev.dagger()
    if in_x_basis:
        prog += CNOT_X_basis(register_a[-1], z_ancilla)
        for qubit in register_b:
            undo_and_add_prog += H(qubit)
        undo_and_add_prog += H(z_ancilla)
    else:
        prog += CNOT(register_a[-1], z_ancilla)
    prog = prog + undo_and_add_prog

    meas_order = [z_ancilla] + list(register_b)[::-1]
    return prog, meas_order


def get_n_bit_adder_results(qc, n_bits: int,
                            registers: Optional[Tuple] = None,
                            qubits: Optional[Sequence[int]] = None,
                            in_x_basis: bool = False, num_shots: int = 100,
                            use_param_program: bool = False,
                            use_active_reset: bool = True,
                            show_progress_bar: bool = False) \
        -> Sequence[np.ndarray]:
    """Sample the adder output for every pair of n-bit summands.

    Results are in increasing order of the 2n-bit number (a_bits | b_bits).
    """
    if registers is None:
        # default: a line topology over 2 n_bits + 2 consecutive qubits
        topology = path_graph(2 * n_bits + 2)
        registers = get_qubit_registers_for_adder(topology, n_bits, qubits)

    all_results = []
    for bits in progress_iter(all_bitstrings(2 * n_bits), show_progress_bar,
                              desc="adder summand pairs",
                              total=4 ** n_bits):
        num_a = bits[:n_bits]
        num_b = bits[n_bits:]
        prog, meas_order = adder(num_a, num_b, *registers, in_x_basis=in_x_basis)
        results = qc.run(prog, meas_order, num_shots)
        all_results.append(results)
    return all_results


def get_success_probabilities_from_results(results) -> Sequence[float]:
    """Per-summand-pair probability that a shot equals the exact sum."""
    num_shots = len(results[0])
    n_bits = len(results[0][0]) - 1
    probabilities = []
    for result, bits in zip(results, all_bitstrings(2 * n_bits)):
        num_a = bit_array_to_int(bits[:n_bits])
        num_b = bit_array_to_int(bits[n_bits:])
        ans_bits = int_to_bit_array(num_a + num_b, n_bits + 1)
        probability = float(np.mean(np.all(np.asarray(result) == ans_bits,
                                           axis=1)))
        probabilities.append(probability)
    return probabilities


def get_error_hamming_distributions_from_results(results) -> Sequence[Sequence[float]]:
    """Per-summand-pair distribution of Hamming weight of the output error."""
    num_shots = len(results[0])
    n_bits = len(results[0][0]) - 1
    hamming_wt_distrs = []
    for result, bits in zip(results, all_bitstrings(2 * n_bits)):
        num_a = bit_array_to_int(bits[:n_bits])
        num_b = bit_array_to_int(bits[n_bits:])
        ans_bits = np.asarray(int_to_bit_array(num_a + num_b, n_bits + 1))
        wts = np.sum(np.asarray(result) != ans_bits, axis=1)
        distr = np.bincount(wts, minlength=n_bits + 2) / num_shots
        hamming_wt_distrs.append(distr.tolist())
    return hamming_wt_distrs
