"""NeighborsModule: HTTP ingress for nearest-neighbor retrieval.

The port of the JAX package's ``ui/neighbors_module.py`` (the same
routes and JSON bodies): the JSON face of retrieval/engine.py behind a
FleetRouter retrieval pool — the modern replacement for the legacy
NearestNeighborsServer (clustering/server.py, a shim over this stack).

- ``POST /api/neighbors``  {"vector": [...]} (single) or
  {"queries": [[...], ...]} (batch), optional ``k`` (default 10),
  ``mode`` ("brute"|"ivf"), ``deadline_ms``/``X-Deadline-Ms``.
  Rides the pool's admission control: a shed answers HTTP 503 with
  ``Retry-After`` (one AIMD window), an expired deadline answers 504 —
  identical semantics to ``/api/predict`` so load balancers and the
  RemoteDispatcher treat both ingresses the same way.
- ``POST /api/neighbors/shard``  internal scatter-gather target used
  by NeighborsDispatcher: same body plus ``"shards": [ids]`` limiting
  the search to this node's slice of the corpus. Also rides admission —
  fan-out legs inherit shed/deadline semantics, and a 503 here is a
  retriable attempt for the dispatcher's breaker, not an error.
- ``GET  /api/neighbors/stats``  engine + pool snapshot.
- ``POST /api/neighbors/refresh``  {"key": optional} — gated hot
  promotion of a rebuilt index from the ArtifactStore (geometry must
  match the warmed executables; self-recall gate; zero live compiles).
  404-less: answers the refresh outcome dict (promoted|rejected|noop).

Distances are squared L2 (the kernel's native metric); ids are corpus
row ids, ``-1`` marking padded "no result" slots (k larger than the
corpus slice). The ``dl4j_nn_*`` series are scraped from ``/metrics``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.parallel.deadline import Deadline, DeadlineExceeded
from deeplearning4j_tpu_torch.ui.modules import Route, UIModule
from deeplearning4j_tpu_torch.ui.serving_module import _deadline_response

DEFAULT_K = 10


class NeighborsModule(UIModule):
    def __init__(self, router, *, model: str = "neighbors",
                 store=None, index_key: Optional[str] = None):
        self.router = router
        self.model = model
        self.store = store
        self.index_key = index_key

    def get_routes(self) -> List[Route]:
        return [
            Route("POST", "/api/neighbors", self._neighbors),
            Route("POST", "/api/neighbors/shard", self._shard),
            Route("GET", "/api/neighbors/stats", self._stats),
            Route("POST", "/api/neighbors/refresh", self._refresh),
        ]

    # ---- request decoding ----------------------------------------------
    @staticmethod
    def _decode(body):
        if not isinstance(body, dict) or \
                ("vector" not in body and "queries" not in body):
            raise ValueError('expected {"vector": [...]} or '
                             '{"queries": [[...], ...]}')
        if "vector" in body:
            q = np.asarray(body["vector"], np.float32)
            if q.ndim != 1:
                raise ValueError('"vector" must be a flat list')
            return q, True
        q = np.asarray(body["queries"], np.float32)
        if q.ndim != 2:
            raise ValueError('"queries" must be a list of rows')
        return q, False

    def _search(self, ctx, body, **extra):
        from deeplearning4j_tpu_torch.parallel.fleet import ShedError
        # malformed client input is a 400, not a 500 module bug (same
        # contract the legacy /knn surface kept)
        try:
            q, single = self._decode(body)
            k = int(body.get("k", DEFAULT_K))
        except (ValueError, TypeError) as e:
            return ({"error": str(e)}, None, 400)
        deadline = Deadline.from_ingress(getattr(ctx, "headers", None),
                                         body)
        try:
            d, i = self.router.neighbors(
                q, k, model=self.model, mode=body.get("mode"),
                deadline=deadline, **extra)
        except DeadlineExceeded:
            return _deadline_response(model=self.model)
        except ValueError as e:
            # e.g. k above the warmed ladder — client input, not a bug
            return ({"error": str(e)}, None, 400)
        except ShedError as e:
            if e.reason == "deadline":
                return _deadline_response(model=e.model)
            import math
            retry_after = max(1, int(math.ceil(
                getattr(self.router, "window_s", 1.0))))
            return ({"error": "shed", "model": e.model,
                     "reason": e.reason},
                    {"Retry-After": str(retry_after)}, 503)
        pool = self.router.retrieval_pool(self.model)
        out = {"distances": np.asarray(d).tolist(),
               "ids": np.asarray(i).tolist(),
               "k": k, "n": 1 if single else int(q.shape[0]),
               "index_version": pool.engine.version}
        return out

    # ---- routes ----------------------------------------------------------
    def _neighbors(self, ctx, query, body):
        return self._search(ctx, body)

    def _shard(self, ctx, query, body):
        if not isinstance(body, dict) or "shards" not in body:
            raise ValueError('expected {"queries": ..., "shards": [...]}')
        shard_ids = [int(s) for s in body["shards"]]
        engine = self.router.retrieval_pool(self.model).engine
        # answer only the slice this node actually holds; the
        # dispatcher treats unserved shards as missing and retries
        # them on a replica
        local = [s for s in shard_ids if s in set(engine.shard_ids)]
        if not local:
            return ({"error": "no local shards",
                     "requested": shard_ids,
                     "local": list(engine.shard_ids)}, None, 404)
        return self._search(ctx, body, shard_ids=local)

    def _stats(self, ctx, query, body):
        out = dict(self.router.stats())
        pool = self.router.retrieval_pool(self.model)
        out["engine"] = pool.engine.stats()
        return out

    def _refresh(self, ctx, query, body):
        body = body or {}
        key = body.get("key") or self.index_key
        if self.store is None or not key:
            return ({"error": "no artifact store wired for refresh"},
                    None, 503)
        engine = self.router.retrieval_pool(self.model).engine
        return engine.refresh(self.store, key)
