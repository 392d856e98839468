"""NearestNeighborsServer: REST k-NN serving (legacy shim).

Analog of the reference's deeplearning4j-nearestneighbor-server
(NearestNeighborsServer.java:42, a Play REST app — SURVEY §2.10). POST
/knn with {"vector": [...], "k": N} (query by vector) or {"index": i,
"k": N} (query by stored point) returns {"results": [{"index",
"distance"}...]}, mirroring the reference's NearestNeighborRequest/
NearestNeighborsResults DTOs.

The port of the JAX package's ``clustering/server.py``: a thin
compatibility shim, a UIServer route over a RetrievalEngine
(retrieval/engine.py — distance + top-k on ``device``, the card unless
``"cpu"``, warmed at construction). The JSON contract:

- distances are reported in the legacy metric — true euclidean
  (sqrt of the kernel's squared L2) or cosine distance ``1 - cos``
  (rows and query are unit-normalized, so squared L2 = 2(1 - cos)
  and we report half of it);
- ``k > n`` returns n results, query-by-index returns the point
  itself first, and a body without ``vector``/``index`` answers 400.

``server.tree`` survives as a duck-typed handle (``.points``,
``.distance``, ``.search``) for callers that reached into the old
attribute; its ``search`` runs through the same engine.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.ui.modules import Route, UIModule


class _EngineTree:
    """Duck-type of the old ``VPTree`` attribute: ``.points``,
    ``.distance``, ``.search(q, k)`` — answered by the engine,
    distances in the legacy metric."""

    def __init__(self, server: "NearestNeighborsServer"):
        self._server = server
        self.points = server.points
        self.distance = server.distance

    def search(self, query: np.ndarray, k: int
               ) -> Tuple[List[int], List[float]]:
        return self._server.search(query, k)


class _KnnModule(UIModule):
    def __init__(self, server: "NearestNeighborsServer"):
        self._server = server

    def get_routes(self) -> List[Route]:
        return [Route("POST", "/knn", self._knn)]

    def _knn(self, ctx, query, body):
        # the legacy contract answers 400 with {"error": ...} for any
        # malformed request (the old handler caught in-loop), so catch
        # here rather than letting UIServer's 500 fallback see it
        try:
            req = body if isinstance(body, dict) else {}
            k = int(req.get("k", 5))
            if "vector" in req:
                q = np.asarray(req["vector"], np.float64)
            elif "index" in req:
                q = self._server.points[int(req["index"])]
            else:
                raise ValueError("request needs 'vector' or 'index'")
            idxs, dists = self._server.search(q, k)
            return {"results": [
                {"index": int(i), "distance": float(d)}
                for i, d in zip(idxs, dists)]}
        except (ValueError, KeyError, IndexError, TypeError) as e:
            return ({"error": str(e)}, None, 400)


class NearestNeighborsServer:
    def __init__(self, points: np.ndarray, port: int = 0,
                 distance: str = "euclidean", device=None):
        from deeplearning4j_tpu_torch.retrieval.engine import RetrievalEngine
        from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex
        if distance not in ("euclidean", "cosine"):
            raise ValueError(f"unsupported distance {distance!r}")
        self.points = np.asarray(points, np.float64)
        self.distance = distance
        self.port = port
        n = len(self.points)
        rows = np.asarray(self.points, np.float32)
        if distance == "cosine":
            norms = np.linalg.norm(rows, axis=1, keepdims=True)
            rows = rows / np.maximum(norms, np.float32(1e-12))
        # one shard (this is the single-host legacy surface); the
        # k-ladder covers 1..n in powers of 4 so any legacy k is
        # served by the next warmed cell and sliced
        ladder = []
        kk = 1
        while kk < min(n, 1024):
            ladder.append(kk)
            kk *= 4
        ladder.append(min(n, 1024))     # ladder top = full corpus
        ladder = sorted(set(ladder))
        index = ShardedCorpusIndex.build(rows, shard_rows=max(n, 2))
        self._engine = RetrievalEngine(index, k_ladder=tuple(ladder),
                                       max_batch=1,
                                       session_id="legacy-knn",
                                       device=device)
        self._engine.warmup()
        self.tree = _EngineTree(self)
        self._ui = None

    @staticmethod
    def _next_pow2(n: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return p

    def search(self, query: np.ndarray, k: int
               ) -> Tuple[List[int], List[float]]:
        """k nearest (indices, distances) in the legacy metric."""
        q = np.asarray(query, np.float32)
        if self.distance == "cosine":
            q = q / np.maximum(np.linalg.norm(q), np.float32(1e-12))
        n = len(self.points)
        k_eff = min(int(k), n)
        d2, ids = self._engine.search(q, k_eff)
        d2 = np.asarray(d2, np.float64)
        ids = np.asarray(ids)
        keep = ids >= 0
        d2, ids = d2[keep], ids[keep]
        if self.distance == "cosine":
            dist = d2 / 2.0          # unit rows: L2^2 = 2(1 - cos)
        else:
            dist = np.sqrt(np.maximum(d2, 0.0))
        return [int(i) for i in ids], [float(d) for d in dist]

    def start(self) -> "NearestNeighborsServer":
        from deeplearning4j_tpu_torch.ui.server import UIServer
        from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
        self._ui = UIServer(port=self.port)
        self._ui.attach(InMemoryStatsStorage())
        self._ui.register_module(_KnnModule(self))
        self._ui.start()
        self.port = self._ui.port
        return self

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self):
        if self._ui is not None:
            self._ui.stop()
            self._ui = None
        self._engine.shutdown()
