"""ServingModule / FleetModule: UI routes for live serving.

Plugs the serving engine (parallel/serving.py) and the fleet router
(parallel/fleet.py) into the dashboard via the UIModule SPI — the same
extension point custom reference modules use (UIModule.java).

``ServingModule`` (one engine):

- ``POST /api/predict``   {"features": [[...], ...]} -> {"output": ...}
  A convenience ingress for smoke tests and the CLI demo; production
  traffic should call ``ServingEngine.submit`` in-process. Requests ride
  the exact same queue/batching path, so a curl during a load test lands
  in the same buckets as everything else.
- ``GET /api/serving/stats``  engine snapshot: streaming p50/p95/p99,
  in-flight depth, queue depth, ladder, recompiles-after-warmup.

``FleetModule`` (a FleetRouter in front of one or more pools) replaces
the predict route with the admission-controlled one and adds the fleet
lifecycle surface:

- ``POST /api/predict``  {"features": ..., "model": optional} — passes
  through the router's admission control; a shed request answers **HTTP
  503** with ``{"error": "shed", "model": ..., "reason": "queue"|"slo"}``
  so external load balancers can react (retry-after, spillover).

Both predict routes honor an end-to-end deadline: ``X-Deadline-Ms``
header or ``"deadline_ms"`` body field (body wins). An expired budget
answers **HTTP 504** ``{"error": "deadline"}`` — shed synchronously at
whichever tier noticed first (admission, batch forming, dispatch), so
an expired request never reaches the device.
- ``GET /api/fleet/stats``  router snapshot: per-pool active/standby
  version, pending depth, shed fraction, windowed p99.
- ``POST /api/fleet/swap``  {"model": name, "version": v, "path": zip}
  restores the weights at ``path`` and hot-swaps them in (warm-first,
  atomic switch, previous version kept as standby).
- ``POST /api/fleet/rollback``  {"model": name} — back to the standby.

The Prometheus series (``dl4j_serving_*``, ``dl4j_fleet_*``) are
scraped from the server's existing ``/metrics``; these modules only add
the JSON/ingress surface.
"""

from __future__ import annotations

from typing import List

import numpy as np

from deeplearning4j_tpu_torch.parallel.deadline import Deadline, DeadlineExceeded
from deeplearning4j_tpu_torch.ui.modules import Route, UIModule


def _deadline_response(model=None):
    """504 Gateway Timeout: the request's own deadline ran out — not an
    overload (503, retryable here) and not a bug (500). No Retry-After:
    re-sending the same expired budget cannot succeed."""
    out = {"error": "deadline", "reason": "deadline"}
    if model is not None:
        out["model"] = model
    return (out, None, 504)


class ServingModule(UIModule):
    def __init__(self, engine):
        self.engine = engine

    def get_routes(self) -> List[Route]:
        return [
            Route("POST", "/api/predict", self._predict),
            Route("GET", "/api/serving/stats", self._stats),
        ]

    def _predict(self, ctx, query, body):
        if not isinstance(body, dict) or "features" not in body:
            raise ValueError('expected {"features": [[...], ...]}')
        deadline = Deadline.from_ingress(getattr(ctx, "headers", None), body)
        x = np.asarray(body["features"],
                       dtype=self.engine.dtype)
        try:
            # forward the deadline only when the client sent one, so
            # duck-typed engines without the kwarg keep working
            out = (self.engine.output(x, deadline=deadline)
                   if deadline is not None else self.engine.output(x))
        except DeadlineExceeded:
            return _deadline_response()
        return {"output": np.asarray(out).tolist(),
                "n": int(x.shape[0])}

    def _stats(self, ctx, query, body):
        return self.engine.stats()


class FleetModule(UIModule):
    """Routes for a FleetRouter front door (see module docstring)."""

    def __init__(self, router):
        self.router = router

    def get_routes(self) -> List[Route]:
        return [
            Route("POST", "/api/predict", self._predict),
            Route("GET", "/api/fleet/stats", self._stats),
            Route("POST", "/api/fleet/swap", self._swap),
            Route("POST", "/api/fleet/rollback", self._rollback),
        ]

    def _predict(self, ctx, query, body):
        from deeplearning4j_tpu_torch.parallel.fleet import ShedError
        if not isinstance(body, dict) or "features" not in body:
            raise ValueError('expected {"features": [[...], ...]}')
        deadline = Deadline.from_ingress(getattr(ctx, "headers", None), body)
        x = np.asarray(body["features"], dtype=np.float32)
        try:
            # forward the deadline only when the client sent one, so
            # duck-typed routers without the kwarg keep working
            out = (self.router.output(x, model=body.get("model"),
                                      deadline=deadline)
                   if deadline is not None
                   else self.router.output(x, model=body.get("model")))
        except DeadlineExceeded:
            return _deadline_response(model=body.get("model"))
        except ShedError as e:
            if e.reason == "deadline":
                return _deadline_response(model=e.model)
            # 503 = "overloaded, retry elsewhere/later" — distinct from
            # a 500 module bug, and load generators count it.
            # Retry-After tells remote retries to back off instead of
            # hammering: one p99 window is when the AIMD controller's
            # view of this pool can actually have changed
            import math
            retry_after = max(1, int(math.ceil(
                getattr(self.router, "window_s", 1.0))))
            return ({"error": "shed", "model": e.model,
                     "reason": e.reason},
                    {"Retry-After": str(retry_after)}, 503)
        return {"output": np.asarray(out).tolist(),
                "n": int(x.shape[0])}

    def _stats(self, ctx, query, body):
        return self.router.stats()

    def _swap(self, ctx, query, body):
        if not isinstance(body, dict) or "version" not in body \
                or "path" not in body:
            raise ValueError(
                'expected {"model": name?, "version": v, "path": zip}')
        from deeplearning4j_tpu_torch.models.serialization import restore_model
        name = body.get("model") or self.router.pool().name
        # the new version goes on the device the pool already serves on
        model = restore_model(body["path"],
                              device=self.router.pool(name).device)
        pool = self.router.swap(name, model, str(body["version"]))
        return {"model": name, "active_version": pool.active_version,
                "standby_version": pool.standby[0] if pool.standby
                else None}

    def _rollback(self, ctx, query, body):
        name = (body or {}).get("model") or self.router.pool().name
        pool = self.router.rollback(name)
        return {"model": name, "active_version": pool.active_version,
                "standby_version": pool.standby[0] if pool.standby
                else None}
