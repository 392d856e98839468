"""RegressionSentinel: post-promotion watchdog with auto-rollback.

The promotion gate scores a candidate on holdout data BEFORE the swap;
the sentinel watches what actually happens AFTER — live fleet latency
(the pool's LatencyRing, which ``promote_params`` reset at the swap, so
every observation is post-swap) and the served params' holdout score
(re-scored live, which also catches in-place corruption). On a
regression it rolls the pool back to the bitwise param standby via
``FleetRouter.rollback_params``, counts it on
``dl4j_online_rollbacks_total{reason=p99|score|nan}``, and drops a
flight-recorder breadcrumb so the next crash dump carries the story.

The p99 probe reads ``pool.ring.quantiles()`` (the full post-reset
window) — NOT ``delta_quantiles()``, whose mark is owned by the fleet's
AIMD shed controller; a second delta reader would steal its
observations.

A baseline that survives ``window_s`` without tripping is retired: the
promotion stands and the sentinel goes idle until the next swap.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

from deeplearning4j_tpu_torch.online.promoter import SwapBaseline


class RegressionSentinel:
    """Watches one pool after each param promotion.

    Parameters
    ----------
    router / model_name : the pool to watch and roll back
    score_fn : zero-arg callable re-scoring the LIVE committed params
        on the holdout (``PromotionController.score_active``); None
        disables the score probe
    p99_factor : live p99 over ``baseline_p99 * factor`` is a
        regression (only after ``min_requests`` post-swap requests)
    p99_floor_s : absolute p99 the live value must also exceed — a
        factor alone would trip on micro-latency noise
    score_delta : tolerated live-score slack vs the pre-swap baseline
    min_requests : post-swap request count before the p99 rule arms
    window_s : how long after a swap the sentinel keeps watching
    on_rollback : callable(reason) fired after a rollback (the
        promoter's ``notify_rollback`` rides here)
    """

    def __init__(self, router, model_name: str, *,
                 score_fn: Optional[Callable[[], float]] = None,
                 p99_factor: float = 3.0, p99_floor_s: float = 0.050,
                 score_delta: float = 0.0, min_requests: int = 20,
                 window_s: float = 30.0, poll_s: float = 0.5,
                 on_rollback: Optional[Callable[[str], None]] = None,
                 registry=None):
        self.router = router
        self.model_name = model_name
        self.score_fn = score_fn
        self.p99_factor = float(p99_factor)
        self.p99_floor_s = float(p99_floor_s)
        self.score_delta = float(score_delta)
        self.min_requests = int(min_requests)
        self.window_s = float(window_s)
        self.poll_s = float(poll_s)
        self.on_rollback = on_rollback
        self.rollbacks = 0
        self.last_rollback_reason: Optional[str] = None
        self._baseline: Optional[SwapBaseline] = None
        self._count_at_swap = 0
        # baseline handoff: promoter thread writes, sentinel/bench
        # threads read-modify in check()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        from deeplearning4j_tpu_torch.observe.registry import default_registry
        reg = registry if registry is not None else default_registry()
        self._c_rollbacks = reg.counter(
            "dl4j_online_rollbacks_total",
            "automatic post-promotion rollbacks, per model; reason="
            "p99 (latency regression) | score (holdout regression) | "
            "nan (non-finite live score)")
        self._c_rollbacks.inc(0.0, model=model_name, reason="score")

    # ---- baseline handoff ------------------------------------------------
    def observe_swap(self, baseline: SwapBaseline):
        """Arm the sentinel for a fresh promotion (promoter calls this
        right after ``promote_params``; the pool ring is already
        reset)."""
        pool = self.router.pool(self.model_name)
        with self._lock:
            self._baseline = baseline
            self._count_at_swap = pool.ring.count

    @property
    def watching(self) -> bool:
        with self._lock:
            return self._baseline is not None

    # ---- the verdict -----------------------------------------------------
    def _regression(self, baseline: SwapBaseline) -> Optional[str]:
        pool = self.router.pool(self.model_name)
        # p99 rule: enough post-swap traffic, live p99 over both the
        # relative and the absolute bar
        served = pool.ring.count - self._count_at_swap
        if served >= self.min_requests \
                and baseline.baseline_p99_s is not None:
            q = pool.ring.quantiles((0.99,))
            live_p99 = q.get(0.99)
            if live_p99 is not None \
                    and live_p99 > self.p99_floor_s \
                    and live_p99 > baseline.baseline_p99_s \
                    * self.p99_factor:
                return "p99"
        # score rule: the LIVE committed params re-scored on holdout
        if self.score_fn is not None \
                and baseline.baseline_score is not None:
            try:
                live = float(self.score_fn())
            except Exception:
                return None   # holdout hiccup is not a regression
            if math.isnan(live) or math.isinf(live):
                return "nan"
            slack = (live - baseline.baseline_score) if baseline.minimize \
                else (baseline.baseline_score - live)
            if slack > self.score_delta:
                return "score"
        return None

    def check(self) -> Optional[str]:
        """One sentinel pass: returns the rollback reason when a
        regression fired, None otherwise (including idle / survived)."""
        with self._lock:
            baseline = self._baseline
        if baseline is None:
            return None
        reason = self._regression(baseline)
        if reason is None:
            if time.time() - baseline.t_swap > self.window_s:
                # survived the watch window: the promotion stands
                with self._lock:
                    if self._baseline is baseline:
                        self._baseline = None
            return None
        self._rollback(baseline, reason)
        return reason

    def _rollback(self, baseline: SwapBaseline, reason: str):
        self.router.rollback_params(self.model_name)
        with self._lock:
            self.rollbacks += 1
            self.last_rollback_reason = reason
            if self._baseline is baseline:
                self._baseline = None
        self._c_rollbacks.inc(1.0, model=self.model_name,
                              reason=reason)
        from deeplearning4j_tpu_torch.observe.flight_recorder import (
            default_flight_recorder)
        rec = default_flight_recorder()
        if rec is not None:
            rec.note(f"online_rollback_{self.model_name}", {
                "reason": reason,
                "rolled_back_version": baseline.version,
                "restored_version": baseline.prev_version,
                "baseline_score": baseline.baseline_score,
                "baseline_p99_s": baseline.baseline_p99_s,
            })
        if self.on_rollback is not None:
            self.on_rollback(reason)

    # ---- background loop -------------------------------------------------
    def start(self) -> "RegressionSentinel":
        if self._thread is not None:
            raise RuntimeError("RegressionSentinel already started")
        self._stop.clear()

        def run():
            while not self._stop.wait(self.poll_s):
                try:
                    self.check()
                except Exception:
                    # a probe hiccup must not kill the watchdog
                    pass

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="online-sentinel")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "watching": self._baseline is not None,
                "rollbacks": self.rollbacks,
                "last_rollback_reason": self.last_rollback_reason,
            }
