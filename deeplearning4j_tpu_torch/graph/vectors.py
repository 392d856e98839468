"""GraphVectors: serving API over trained vertex embeddings.

Analog of the reference's graph/models/GraphVectors + embeddings holder
(SURVEY §2.8): lookup, similarity, nearest vertices, save/load.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np


class GraphVectors:
    def __init__(self, vectors: np.ndarray):
        self._vectors = np.asarray(vectors, np.float32)

    @classmethod
    def from_deepwalk(cls, dw) -> "GraphVectors":
        n = dw.graph.num_vertices() if dw.graph else dw.vocab.num_words()
        mat = np.stack([dw.get_vertex_vector(v) for v in range(n)])
        return cls(mat)

    def num_vertices(self) -> int:
        return self._vectors.shape[0]

    def get_vertex_vector(self, v: int) -> np.ndarray:
        return self._vectors[v]

    def similarity(self, a: int, b: int) -> float:
        va, vb = self._vectors[a], self._vectors[b]
        den = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / den) if den else 0.0

    def vertices_nearest(self, v: int, top_n: int = 10) -> List[int]:
        norms = np.linalg.norm(self._vectors, axis=1, keepdims=True)
        unit = self._vectors / np.maximum(norms, 1e-12)
        sims = unit @ unit[v]
        order = np.argsort(-sims)
        return [int(i) for i in order if i != v][:top_n]

    def save(self, path: str):
        np.savez_compressed(path, vectors=self._vectors)

    @classmethod
    def load(cls, path: str) -> "GraphVectors":
        import os
        data = np.load(path if os.path.exists(path) else path + ".npz")
        return cls(data["vectors"])
