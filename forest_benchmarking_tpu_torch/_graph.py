"""A small graph type: what ``entangled_states`` and
``classical_logic.ripple_carry_adder`` need of ``networkx``, which the port
does not import.

:class:`_Graph` is built from a list of ``(u, v)`` pairs, or from any object
with ``nodes`` and ``edges`` (a ``networkx`` graph a caller already holds),
read by duck typing. Its orders are ``networkx``'s, because they decide gate
order and measurement order:

- ``nodes``: first appearance (as ``nx.Graph(edges).nodes``);
- ``neighbors``/``successors``: insertion order;
- ``edges``: nodes in order, each node's neighbours in order; an undirected
  edge is reported once, from the endpoint that comes first
  (``nx.Graph([(1, 2), (0, 1)]).edges`` is ``[(1, 2), (1, 0)]``);
- ``topological_sort``: the generations of ``nx.topological_generations``,
  roots in node order, then children in successor order.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Tuple

__all__ = ["_Graph", "path_graph"]


class _Graph:
    """An undirected graph or, with ``directed=True``, a digraph."""

    def __init__(self, edges: Iterable[Tuple[Hashable, Hashable]] = (),
                 directed: bool = False):
        self.directed = directed
        self._succ: Dict[Hashable, Dict[Hashable, None]] = {}
        self._pred: Dict[Hashable, Dict[Hashable, None]] = {}
        for u, v in edges:
            self.add_edge(u, v)

    @classmethod
    def from_any(cls, graph, directed: bool = False) -> "_Graph":
        """A :class:`_Graph` of ``graph``: a :class:`_Graph` (copied), an
        object with ``nodes`` and ``edges`` (directed where its
        ``is_directed()`` says so, else as ``directed``), or an iterable of
        ``(u, v)`` pairs (a digraph when ``directed``)."""
        if isinstance(graph, _Graph):
            return graph.copy()
        if hasattr(graph, "nodes") and hasattr(graph, "edges"):
            is_directed = getattr(graph, "is_directed", None)
            if callable(is_directed):
                directed = bool(is_directed())
            out = cls(directed=directed)
            for node in graph.nodes:
                out.add_node(node)
            # each node's own neighbour order, where the object gives it
            # (rebuilt from the edges, a node's neighbours could come in
            # another order)
            nbrs = getattr(graph, "successors" if directed else "neighbors",
                           None)
            if not callable(nbrs):
                for u, v in graph.edges:
                    out.add_edge(u, v)
                return out
            for node in graph.nodes:
                for v in nbrs(node):
                    out.add_node(v)
                    out._succ[node][v] = None
                    if directed:
                        out._pred[v][node] = None
            return out
        return cls(graph, directed=directed)

    def add_node(self, node: Hashable) -> None:
        if node not in self._succ:
            self._succ[node] = {}
            self._pred[node] = {}

    def add_edge(self, u: Hashable, v: Hashable) -> None:
        self.add_node(u)
        self.add_node(v)
        self._succ[u][v] = None
        if self.directed:
            self._pred[v][u] = None
        else:
            self._succ[v][u] = None

    def remove_node(self, node: Hashable) -> None:
        for other in self._succ.pop(node):
            back = self._pred if self.directed else self._succ
            back.get(other, {}).pop(node, None)
        for other in self._pred.pop(node):
            self._succ.get(other, {}).pop(node, None)

    def copy(self) -> "_Graph":
        out = _Graph(directed=self.directed)
        out._succ = {n: dict(s) for n, s in self._succ.items()}
        out._pred = {n: dict(p) for n, p in self._pred.items()}
        return out

    @property
    def nodes(self) -> List[Hashable]:
        return list(self._succ)

    @property
    def edges(self) -> List[Tuple[Hashable, Hashable]]:
        if self.directed:
            return [(u, v) for u, nbrs in self._succ.items() for v in nbrs]
        seen, out = set(), []
        for u, nbrs in self._succ.items():
            out += [(u, v) for v in nbrs if v not in seen]
            seen.add(u)
        return out

    def __len__(self) -> int:
        return len(self._succ)

    def __contains__(self, node) -> bool:
        return node in self._succ

    def __getitem__(self, node) -> List[Hashable]:
        """The neighbours (successors in a digraph) of ``node``, as
        ``graph[node]`` iterates in ``networkx``."""
        return list(self._succ[node])

    def neighbors(self, node) -> List[Hashable]:
        return list(self._succ[node])

    successors = neighbors

    def degree(self, node) -> int:
        """Edges at ``node`` (a self-loop counts twice, as in networkx)."""
        if self.directed:
            return len(self._succ[node]) + len(self._pred[node])
        return len(self._succ[node]) + (node in self._succ[node])

    def number_of_edges(self) -> int:
        return len(self.edges)

    def _undirected_neighbors(self, node) -> List[Hashable]:
        return list(self._succ[node]) + list(self._pred[node])

    def is_tree(self) -> bool:
        """Connected (weakly, in a digraph) with one edge fewer than nodes.
        An empty graph is not a tree."""
        if not self._succ:
            return False
        if self.number_of_edges() != len(self) - 1:
            return False
        start = next(iter(self._succ))
        seen, stack = {start}, [start]
        while stack:
            for v in self._undirected_neighbors(stack.pop()):
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return len(seen) == len(self)

    def topological_sort(self) -> List[Hashable]:
        """Nodes generation by generation, as ``networkx``'s
        ``topological_sort`` yields them; raises ``ValueError`` for an
        undirected graph or a cycle."""
        if not self.directed:
            raise ValueError("Topological sort not defined on undirected "
                             "graphs.")
        indegree = {v: len(p) for v, p in self._pred.items() if p}
        generation = [v for v, p in self._pred.items() if not p]
        order = []
        while generation:
            order += generation
            nxt = []
            for node in generation:
                for child in self._succ[node]:
                    indegree[child] -= 1
                    if indegree[child] == 0:
                        nxt.append(child)
                        del indegree[child]
            generation = nxt
        if indegree:
            raise ValueError("Graph contains a cycle")
        return order


def path_graph(n: int) -> _Graph:
    """The path 0 - 1 - ... - (n-1), as ``networkx.path_graph(n)``."""
    graph = _Graph()
    for i in range(n):
        graph.add_node(i)
    for i in range(n - 1):
        graph.add_edge(i, i + 1)
    return graph
