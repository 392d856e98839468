"""Graph API + in-memory implementation.

Analog of the reference's graph/api/IGraph + graph/graph/Graph.java
(SURVEY §2.8): integer-indexed vertices with optional values, directed or
undirected weighted edges, adjacency queries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass
class Vertex:
    idx: int
    value: Any = None


@dataclasses.dataclass
class Edge:
    src: int
    dst: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """reference: graph/graph/Graph.java (adjacency-list in-memory)."""

    def __init__(self, n_vertices: int, directed: bool = False):
        self.directed = directed
        self._vertices = [Vertex(i) for i in range(n_vertices)]
        self._adj: List[List[Tuple[int, float]]] = [
            [] for _ in range(n_vertices)]

    @classmethod
    def from_edges(cls, n_vertices: int,
                   edges: Iterable[Tuple[int, int]],
                   directed: bool = False) -> "Graph":
        g = cls(n_vertices, directed)
        for e in edges:
            g.add_edge(*e)
        return g

    def num_vertices(self) -> int:
        return len(self._vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def set_vertex_value(self, idx: int, value: Any):
        self._vertices[idx].value = value

    def add_edge(self, src: int, dst: int, weight: float = 1.0):
        self._adj[src].append((dst, weight))
        if not self.directed:
            self._adj[dst].append((src, weight))

    def get_connected_vertices(self, idx: int) -> List[int]:
        return [d for d, _w in self._adj[idx]]

    def get_edges_out(self, idx: int) -> List[Tuple[int, float]]:
        return list(self._adj[idx])

    def degree(self, idx: int) -> int:
        return len(self._adj[idx])
