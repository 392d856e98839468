"""OnlineModule: UI routes for the online-learning runtime.

Rides the same UIModule SPI as serving_module.py, in front of an
``online.runtime.OnlineServing``:

- ``GET /api/online/stats`` — learner progress, stream counters,
  holdout depth, last promotion decision, sentinel state, pool view.
- ``POST /api/online/promote`` — run one promotion cycle NOW instead
  of waiting for the background interval; body ``{"force": true}``
  skips the score comparison (operator override — the sentinel still
  watches the result). Answers the full PromotionDecision.
- ``POST /api/online/rollback`` — manual param rollback to the
  standby captured at the last promotion.

The ``dl4j_online_*`` Prometheus series are scraped from the server's
existing ``/metrics``; this module only adds the JSON surface.
"""

from __future__ import annotations

from typing import List

from deeplearning4j_tpu_torch.ui.modules import Route, UIModule


class OnlineModule(UIModule):
    def __init__(self, online):
        self.online = online

    def get_routes(self) -> List[Route]:
        return [
            Route("GET", "/api/online/stats", self._stats),
            Route("POST", "/api/online/promote", self._promote),
            Route("POST", "/api/online/rollback", self._rollback),
        ]

    def _stats(self, ctx, query, body):
        return self.online.stats()

    def _promote(self, ctx, query, body):
        force = bool((body or {}).get("force", False))
        d = self.online.promoter.run_once(force=force)
        return {
            "promoted": d.promoted, "reason": d.reason,
            "candidate_score": d.candidate_score,
            "active_score": d.active_score,
            "version": d.version, "iteration": d.iteration,
            "score_seconds": d.score_seconds,
            "over_budget": d.over_budget,
        }

    def _rollback(self, ctx, query, body):
        name = self.online.model_name
        try:
            pool = self.online.router.rollback_params(name)
        except RuntimeError as e:
            return ({"error": str(e)}, None, 409)
        self.online.promoter.notify_rollback()
        return {"model": name, "active_version": pool.active_version,
                "param_standby_version": pool.param_standby[0]
                if pool.param_standby else None}
