"""SPTree (generalized quadtree/octree) with Barnes-Hut accumulation.

Analog of the reference's clustering/sptree/SpTree.java (SURVEY §2.10),
the spatial index behind BarnesHutTsne. Center-of-mass cells let the
repulsive-force sum be approximated in O(N log N) on host.

A copy of the JAX package's ``clustering/sptree.py`` (host numpy).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class _Cell:
    __slots__ = ("center", "width", "n", "com", "point_index", "children",
                 "is_leaf")

    def __init__(self, center: np.ndarray, width: np.ndarray):
        self.center = center
        self.width = width
        self.n = 0                       # points in subtree
        self.com = np.zeros_like(center)  # center of mass
        self.point_index: Optional[int] = None
        self.children: Optional[List["_Cell"]] = None
        self.is_leaf = True


class SpTree:
    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)  # host-sync-ok: legacy host tree holds host f64 rows by design
        lo = self.points.min(0)
        hi = self.points.max(0)
        center = (lo + hi) / 2
        width = np.maximum(hi - lo, 1e-10) * 0.5 + 1e-6
        self.d = self.points.shape[1]
        self.root = _Cell(center, width)
        for i in range(len(self.points)):
            self._insert(self.root, i)

    def _insert(self, cell: _Cell, idx: int, depth: int = 0):
        p = self.points[idx]
        cell.com = (cell.com * cell.n + p) / (cell.n + 1)
        cell.n += 1
        if cell.is_leaf and cell.point_index is None:
            cell.point_index = idx
            return
        if cell.is_leaf:
            # duplicate-point guard (reference caps subdivision depth)
            if depth > 48 or np.allclose(
                    self.points[cell.point_index], p, atol=1e-12):
                return
            self._subdivide(cell)
            old = cell.point_index
            cell.point_index = None
            self._insert(self._child_for(cell, self.points[old]), old,
                         depth + 1)
        self._insert(self._child_for(cell, p), idx, depth + 1)

    def _subdivide(self, cell: _Cell):
        cell.is_leaf = False
        cell.children = []
        for mask in range(1 << self.d):
            offs = np.array([(1 if mask >> j & 1 else -1)
                             for j in range(self.d)], np.float64)
            c = _Cell(cell.center + offs * cell.width / 2, cell.width / 2)
            cell.children.append(c)

    def _child_for(self, cell: _Cell, p: np.ndarray) -> _Cell:
        mask = 0
        for j in range(self.d):
            if p[j] > cell.center[j]:
                mask |= 1 << j
        return cell.children[mask]

    def compute_non_edge_forces(self, idx: int, theta: float
                                ) -> tuple:
        """Barnes-Hut negative-force accumulation for point ``idx``
        (reference: SpTree.computeNonEdgeForces): returns (neg_f, sum_q)
        using the t-SNE q_ij = 1/(1+||y_i-y_j||²) kernel."""
        p = self.points[idx]
        neg = np.zeros(self.d)
        sum_q = 0.0

        def visit(cell: _Cell):
            nonlocal sum_q, neg
            if cell.n == 0 or (cell.is_leaf and cell.point_index == idx
                               and cell.n == 1):
                return
            diff = p - cell.com
            d2 = float(diff @ diff)  # host-sync-ok: host walk scalar (Barnes-Hut criterion)
            max_w = float(cell.width.max() * 2)  # host-sync-ok: host walk scalar (Barnes-Hut criterion)
            if cell.is_leaf or (d2 > 0 and max_w / np.sqrt(d2) < theta):
                cnt = cell.n - (1 if (cell.is_leaf and
                                      cell.point_index == idx) else 0)
                if cnt <= 0:
                    return
                q = 1.0 / (1.0 + d2)
                sum_q += cnt * q
                neg += cnt * q * q * diff
                return
            for ch in cell.children or ():
                visit(ch)

        visit(self.root)
        return neg, sum_q
