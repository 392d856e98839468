"""Random-walk sequence generators.

Analog of the reference's graph/iterator/RandomWalkIterator.java and
WeightedRandomWalkIterator.java (SURVEY §2.8): fixed-length walks from
every vertex, with NoEdgeHandling semantics (self-loop on dead ends).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph


class RandomWalkIterator:
    """Uniform-neighbor walks, one walk per starting vertex per pass."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 walks_per_vertex: int = 1):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.walks_per_vertex = walks_per_vertex

    def _next_step(self, rng, cur: int) -> int:
        nbrs = self.graph.get_connected_vertices(cur)
        if not nbrs:
            return cur   # NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED
        return nbrs[rng.integers(len(nbrs))]

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        n = self.graph.num_vertices()
        for _rep in range(self.walks_per_vertex):
            order = rng.permutation(n)
            for start in order:
                walk = [int(start)]
                cur = int(start)
                for _ in range(self.walk_length - 1):
                    cur = int(self._next_step(rng, cur))
                    walk.append(cur)
                yield walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional transition probabilities."""

    def _next_step(self, rng, cur: int) -> int:
        edges = self.graph.get_edges_out(cur)
        if not edges:
            return cur
        weights = np.asarray([w for _d, w in edges], np.float64)
        s = weights.sum()
        if s <= 0:
            return edges[rng.integers(len(edges))][0]
        return edges[rng.choice(len(edges), p=weights / s)][0]


class Node2VecWalkIterator(RandomWalkIterator):
    """node2vec biased second-order walks (reference: models/node2vec/ —
    SURVEY §2.7). Return parameter ``p`` penalizes immediate backtracking,
    in-out parameter ``q`` interpolates BFS-like (q>1) vs DFS-like (q<1)
    exploration (Grover & Leskovec 2016, public algorithm)."""

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, seed: int = 0, walks_per_vertex: int = 1):
        super().__init__(graph, walk_length, seed, walks_per_vertex)
        self.p = float(p)
        self.q = float(q)

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        n = self.graph.num_vertices()
        nbr_sets = [set(self.graph.get_connected_vertices(v))
                    for v in range(n)]
        for _rep in range(self.walks_per_vertex):
            order = rng.permutation(n)
            for start in order:
                walk = [int(start)]
                prev = None
                cur = int(start)
                for _ in range(self.walk_length - 1):
                    nbrs = self.graph.get_connected_vertices(cur)
                    if not nbrs:
                        walk.append(cur)
                        continue
                    if prev is None:
                        nxt = nbrs[rng.integers(len(nbrs))]
                    else:
                        w = np.empty(len(nbrs), np.float64)
                        prev_nbrs = nbr_sets[prev]
                        for i, x in enumerate(nbrs):
                            if x == prev:
                                w[i] = 1.0 / self.p
                            elif x in prev_nbrs:
                                w[i] = 1.0
                            else:
                                w[i] = 1.0 / self.q
                        nxt = nbrs[rng.choice(len(nbrs), p=w / w.sum())]
                    prev, cur = cur, int(nxt)
                    walk.append(cur)
                yield walk
