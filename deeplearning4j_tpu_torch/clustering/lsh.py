"""Locality-sensitive hashing + random projection.

Analogs of the reference's clustering/lsh/ (RandomProjectionLSH.java) and
clustering/randomprojection/ (SURVEY §2.10): approximate cosine
neighbors via signed-random-projection bucket hashing.

A copy of the JAX package's ``clustering/lsh.py`` (host numpy).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


class RandomProjectionLSH:
    """Sign-LSH over ``n_tables`` independent hash tables of ``n_bits``
    hyperplanes each; candidates are re-ranked exactly."""

    def __init__(self, n_bits: int = 16, n_tables: int = 4, seed: int = 0):
        self.n_bits = n_bits
        self.n_tables = n_tables
        self.seed = seed
        self._planes: List[np.ndarray] = []
        self._tables: List[Dict[int, List[int]]] = []
        self._data: np.ndarray = None

    def _hash(self, planes: np.ndarray, x: np.ndarray) -> np.ndarray:
        bits = (x @ planes.T) > 0
        return bits @ (1 << np.arange(self.n_bits))

    def index(self, data: np.ndarray):
        self._data = np.asarray(data, np.float64)  # host-sync-ok: host hash-table structure holds host rows by design
        d = self._data.shape[1]
        rng = np.random.default_rng(self.seed)
        self._planes = [rng.normal(size=(self.n_bits, d))
                        for _ in range(self.n_tables)]
        self._tables = []
        for planes in self._planes:
            table: Dict[int, List[int]] = defaultdict(list)
            keys = self._hash(planes, self._data)
            for i, key in enumerate(keys):
                table[int(key)].append(i)
            self._tables.append(table)
        return self

    def search(self, query: np.ndarray, k: int
               ) -> Tuple[List[int], List[float]]:
        q = np.asarray(query, np.float64)  # host-sync-ok: query decode at the host-structure input boundary
        cands = set()
        for planes, table in zip(self._planes, self._tables):
            key = int(self._hash(planes, q[None, :])[0])
            cands.update(table.get(key, ()))
        if not cands:
            cands = set(range(len(self._data)))
        idxs = np.fromiter(cands, int)
        sub = self._data[idxs]
        qn = q / max(np.linalg.norm(q), 1e-12)
        sn = sub / np.maximum(np.linalg.norm(sub, axis=1, keepdims=True),
                              1e-12)
        sims = sn @ qn
        order = np.argsort(-sims)[:k]
        return idxs[order].tolist(), (1.0 - sims[order]).tolist()


class RandomProjection:
    """Johnson-Lindenstrauss Gaussian projection to ``n_components``
    (reference: randomprojection/RandomProjection.java)."""

    def __init__(self, n_components: int, seed: int = 0):
        self.n_components = n_components
        self.seed = seed
        self._proj: np.ndarray = None

    def fit(self, data: np.ndarray) -> "RandomProjection":
        d = np.asarray(data).shape[1]  # host-sync-ok: build-time shape probe on host ingest
        rng = np.random.default_rng(self.seed)
        self._proj = rng.normal(
            size=(d, self.n_components)) / np.sqrt(self.n_components)
        return self

    def transform(self, data: np.ndarray) -> np.ndarray:
        return np.asarray(data) @ self._proj  # host-sync-ok: build-time host projection of ingest rows

    def fit_transform(self, data: np.ndarray) -> np.ndarray:
        return self.fit(data).transform(data)
