"""The VF2 subgraph matcher of ``networkx``, for undirected simple graphs.

``classical_logic.get_qubit_registers_for_adder`` lays the adder out on
the first match that ``networkx.algorithms.isomorphism.GraphMatcher(G1,
G2).subgraph_isomorphisms_iter()`` yields; the card's machine has no
``networkx``, so the port carries its own copy of that search
(``networkx/algorithms/isomorphism/isomorphvf2.py``: ``GraphMatcher`` with
``test="subgraph"``, ``candidate_pairs_iter``, ``syntactic_feasibility``
and ``GMState``), in the same order: candidates from the insertion order
of the terminal-set dicts, the smallest unmatched node of ``G2`` by its
position in ``G2``, the new terminal nodes in the iteration order of the
set ``networkx`` collects them in. Only the undirected ``Graph`` case is
carried, and the search runs on an explicit stack, not by recursion, so a
long path does not meet Python's recursion limit.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterator

from forest_benchmarking_tpu_torch._graph import _Graph

__all__ = ["subgraph_isomorphisms_iter"]


def subgraph_isomorphisms_iter(g1, g2) -> Iterator[Dict[Hashable, Hashable]]:
    """Each isomorphism between a node-induced subgraph of ``g1`` and
    ``g2``, as a dict from ``g1``'s nodes to ``g2``'s in the order they were
    matched, in the order ``networkx``'s ``GraphMatcher(g1, g2)
    .subgraph_isomorphisms_iter()`` yields them."""
    g1, g2 = _Graph.from_any(g1), _Graph.from_any(g2)
    adj1 = {n: g1.neighbors(n) for n in g1.nodes}
    adj2 = {n: g2.neighbors(n) for n in g2.nodes}
    set1 = {n: set(nbrs) for n, nbrs in adj1.items()}
    set2 = {n: set(nbrs) for n, nbrs in adj2.items()}
    g2_nodes = set(g2.nodes)
    g2_order = {n: i for i, n in enumerate(g2.nodes)}.__getitem__
    core_1: Dict = {}
    core_2: Dict = {}
    inout_1: Dict = {}
    inout_2: Dict = {}

    def candidate_pairs():
        t1_inout = [node for node in inout_1 if node not in core_1]
        t2_inout = [node for node in inout_2 if node not in core_2]
        if t1_inout and t2_inout:
            node_2 = min(t2_inout, key=g2_order)
            return [(node_1, node_2) for node_1 in t1_inout]
        other_node = min(g2_nodes - set(core_2), key=g2_order)
        return [(node, other_node) for node in adj1 if node not in core_1]

    def feasible(n1, n2) -> bool:
        # self-loops: a simple graph has at most one at a node
        if (n1 in set1[n1]) != (n2 in set2[n2]):
            return False
        # matched neighbours must be matched to neighbours (in a simple
        # graph the edge counts networkx compares next are then 1 and 1)
        for neighbor in adj1[n1]:
            if neighbor in core_1 and core_1[neighbor] not in set2[n2]:
                return False
        for neighbor in adj2[n2]:
            if neighbor in core_2 and core_2[neighbor] not in set1[n1]:
                return False
        # look-ahead, test == "subgraph": terminal and new neighbours
        num1 = sum(1 for nb in adj1[n1] if nb in inout_1 and nb not in core_1)
        num2 = sum(1 for nb in adj2[n2] if nb in inout_2 and nb not in core_2)
        if not num1 >= num2:
            return False
        num1 = sum(1 for nb in adj1[n1] if nb not in inout_1)
        num2 = sum(1 for nb in adj2[n2] if nb not in inout_2)
        return num1 >= num2

    def push(n1, n2) -> int:
        core_1[n1] = n2
        core_2[n2] = n1
        depth = len(core_1)
        if n1 not in inout_1:
            inout_1[n1] = depth
        if n2 not in inout_2:
            inout_2[n2] = depth
        for core, inout, adj in ((core_1, inout_1, adj1),
                                 (core_2, inout_2, adj2)):
            new_nodes = set()
            for node in core:
                new_nodes.update([nb for nb in adj[node] if nb not in core])
            for node in new_nodes:
                if node not in inout:
                    inout[node] = depth
        return depth

    def restore(n1, n2, depth) -> None:
        del core_1[n1]
        del core_2[n2]
        for vector in (inout_1, inout_2):
            for node in list(vector.keys()):
                if vector[node] == depth:
                    del vector[node]

    if not g2_nodes:
        yield {}
        return
    frames = [iter(candidate_pairs())]
    pushed = []
    while frames:
        for n1, n2 in frames[-1]:
            if not feasible(n1, n2):
                continue
            pushed.append((n1, n2, push(n1, n2)))
            if len(core_1) == len(g2_nodes):
                yield dict(core_1)
                restore(*pushed.pop())
                continue
            frames.append(iter(candidate_pairs()))
            break
        else:
            frames.pop()
            if pushed:
                restore(*pushed.pop())
