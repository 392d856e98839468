"""KD-tree for low-dimensional exact nearest neighbors.

Analog of the reference's clustering/kdtree/KDTree.java (SURVEY §2.10).

A copy of the JAX package's ``clustering/kdtree.py`` (host numpy).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _KDNode:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index: int, axis: int):
        self.index = index
        self.axis = axis
        self.left: Optional["_KDNode"] = None
        self.right: Optional["_KDNode"] = None


class KDTree:
    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)  # host-sync-ok: legacy host tree holds host f64 rows by design
        self.dims = self.points.shape[1]
        self.root = self._build(list(range(len(self.points))), 0)

    def _build(self, idxs: List[int], depth: int) -> Optional[_KDNode]:
        if not idxs:
            return None
        axis = depth % self.dims
        idxs.sort(key=lambda i: self.points[i, axis])
        mid = len(idxs) // 2
        node = _KDNode(idxs[mid], axis)
        node.left = self._build(idxs[:mid], depth + 1)
        node.right = self._build(idxs[mid + 1:], depth + 1)
        return node

    def insert_point_index(self, idx: int):
        raise NotImplementedError(
            "rebuild the tree to add points (static index)")

    def knn(self, query: np.ndarray, k: int
            ) -> Tuple[List[int], List[float]]:
        q = np.asarray(query, np.float64)  # host-sync-ok: query decode at the host-tree input boundary
        heap: List[Tuple[float, int]] = []

        def visit(node: Optional[_KDNode]):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.index] - q))  # host-sync-ok: host walk: distance on host rows
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            delta = q[node.axis] - self.points[node.index, node.axis]
            near, far = ((node.left, node.right) if delta < 0
                         else (node.right, node.left))
            visit(near)
            if len(heap) < k or abs(delta) < -heap[0][0]:
                visit(far)

        visit(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        return [i for _d, i in out], [d for d, _i in out]

    def nearest(self, query: np.ndarray) -> Tuple[int, float]:
        idxs, ds = self.knn(query, 1)
        return idxs[0], ds[0]
