"""Vantage-point tree for exact metric nearest-neighbor search.

Analog of the reference's clustering/vptree/VPTree.java:48 (SURVEY
§2.10; backs wordsNearest-style serving and t-SNE's input neighborhoods).
Host-side index; batched distance evaluations are vectorized numpy.

A copy of the JAX package's ``clustering/vptree.py`` (host numpy).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional["_Node"] = None
        self.outside: Optional["_Node"] = None


class VPTree:
    def __init__(self, points: np.ndarray, distance: str = "euclidean",
                 seed: int = 0):
        self.points = np.asarray(points, np.float64)  # host-sync-ok: legacy host tree holds host f64 rows by design
        if distance not in ("euclidean", "cosine"):
            raise ValueError(f"unsupported distance {distance!r}")
        self.distance = distance
        if self.distance == "cosine":
            norms = np.linalg.norm(self.points, axis=1, keepdims=True)
            self._unit = self.points / np.maximum(norms, 1e-12)
        self._rng = np.random.default_rng(seed)
        idxs = list(range(len(self.points)))
        self.root = self._build(idxs)

    def _dist(self, i: int, idxs: np.ndarray) -> np.ndarray:
        if self.distance == "cosine":
            return 1.0 - self._unit[idxs] @ self._unit[i]
        diff = self.points[idxs] - self.points[i]
        return np.sqrt(np.sum(diff * diff, axis=1))

    def _build(self, idxs: List[int]) -> Optional[_Node]:
        if not idxs:
            return None
        vp_pos = int(self._rng.integers(len(idxs)))
        vp = idxs.pop(vp_pos)
        node = _Node(vp)
        if idxs:
            arr = np.asarray(idxs)  # host-sync-ok: build-time index array on host rows
            d = self._dist(vp, arr)
            median = float(np.median(d))  # host-sync-ok: build-time median split scalar
            node.threshold = median
            inside = [i for i, di in zip(idxs, d) if di < median]
            outside = [i for i, di in zip(idxs, d) if di >= median]
            node.inside = self._build(inside)
            node.outside = self._build(outside)
        return node

    def _dist_to_query(self, q: np.ndarray, idx: int) -> float:
        if self.distance == "cosine":
            qn = q / max(np.linalg.norm(q), 1e-12)
            return float(1.0 - self._unit[idx] @ qn)  # host-sync-ok: host walk: distance on host rows
        return float(np.linalg.norm(self.points[idx] - q))  # host-sync-ok: host walk: distance on host rows

    def search(self, query: np.ndarray, k: int
               ) -> Tuple[List[int], List[float]]:
        """k nearest (indices, distances), best-first with pruning."""
        q = np.asarray(query, np.float64)  # host-sync-ok: query decode at the host-tree input boundary
        heap: List[Tuple[float, int]] = []   # max-heap via negated dist
        tau = [np.inf]

        def visit(node: Optional[_Node]):
            if node is None:
                return
            d = self._dist_to_query(q, node.index)
            if d < tau[0] or len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) > k:
                    heapq.heappop(heap)
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                visit(node.inside)
                if d + tau[0] >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        return [i for _d, i in out], [d for d, _i in out]
