"""PromotionController: the gated path from candidate params to live
serving.

Each cycle: take a candidate snapshot from the OnlineLearner, score it
on the stream's holdout reservoir through the earlystopping
ScoreCalculator machinery (earlystopping/scorecalc.py), and promote
only a strict improvement — the quant-gate discipline
(evaluation/quant_gate.py): hard precondition, explicit result object,
pass/fail counters. Promotion is ``FleetRouter.promote_params`` — a
param-only hot swap into the warm engines, no new bucket dispatch —
and the pre-swap params/score/p99 baseline is handed to the
RegressionSentinel so a live regression can auto-roll-back.

A candidate whose score is worse, not better by ``min_delta``, NaN, or
unobtainable (scoring raised) is REJECTED and the active version is
untouched; every rejection is counted by reason on
``dl4j_online_rejections_total``.

Scoring runs on a dedicated eval model (a clone) — never on the live
training model (whose params the train step updates in place) and never
on the serving engines' committed copies. A candidate is loaded into the
clone by ``copy_`` into its own tensors, under ``no_grad``, on the
clone's device.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.models.serialization import flatten_paths
from deeplearning4j_tpu_torch.online.learner import Candidate


class PromotionDecision(NamedTuple):
    promoted: bool
    reason: str                   # improved|forced|worse|equal|nan|
    #                               error|no_candidate|no_holdout
    candidate_score: Optional[float]
    active_score: Optional[float]
    version: Optional[str]
    iteration: int
    score_seconds: float
    over_budget: bool


class SwapBaseline(NamedTuple):
    """What the sentinel compares live behavior against."""
    t_swap: float
    version: Optional[str]
    prev_version: Optional[str]
    baseline_score: Optional[float]
    baseline_p99_s: Optional[float]
    minimize: bool


class PromotionController:
    """Scores candidates against the holdout and hot-promotes winners.

    Parameters
    ----------
    router : FleetRouter serving the live pool
    model_name : the pool's name
    learner : OnlineLearner producing candidate snapshots
    score_calculator : earlystopping ScoreCalculator over the holdout
        (its ``minimize_score`` fixes the improvement direction)
    eval_model : a CLONE of the model used only for scoring (its
        params and state are overwritten per evaluation)
    min_delta : required improvement margin; a candidate within
        ``min_delta`` of the active score is rejected as "equal"
    score_budget_s : advisory wall-clock budget for one scoring pass;
        exceeding it flags the decision and the
        ``dl4j_online_score_seconds`` gauge, but does not reject
    interval_s : period of the optional background promotion thread
    sentinel : RegressionSentinel to arm after each promotion
    """

    def __init__(self, router, model_name: str, learner,
                 score_calculator, eval_model, *,
                 min_delta: float = 0.0,
                 score_budget_s: Optional[float] = None,
                 interval_s: float = 5.0,
                 sentinel=None, registry=None):
        self.router = router
        self.model_name = model_name
        self.learner = learner
        self.calc = score_calculator
        self.eval_model = eval_model
        self.min_delta = float(min_delta)
        self.score_budget_s = score_budget_s
        self.interval_s = float(interval_s)
        self.sentinel = sentinel
        self.active_score: Optional[float] = None
        self._prev_active_score: Optional[float] = None
        self.active_walltime: Optional[float] = None   # params trained at
        self.promotions = 0
        self.rejections = 0
        self.last_decision: Optional[PromotionDecision] = None
        self._version_seq = 0
        # promoter state is shared with the sentinel (notify_rollback)
        # and the stats route; one lock covers every mutation
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        from deeplearning4j_tpu_torch.observe.registry import default_registry
        reg = registry if registry is not None else default_registry()
        self._c_promotions = reg.counter(
            "dl4j_online_promotions_total",
            "candidate param sets hot-promoted into serving, per model")
        self._c_rejections = reg.counter(
            "dl4j_online_rejections_total",
            "candidates rejected by the promotion gate, per model; "
            "reason=worse|equal|nan|error|no_candidate|no_holdout")
        self._g_candidate = reg.gauge(
            "dl4j_online_candidate_score",
            "holdout score of the most recently evaluated candidate")
        self._g_active = reg.gauge(
            "dl4j_online_active_score",
            "holdout score of the params currently serving")
        self._g_staleness = reg.gauge(
            "dl4j_online_param_staleness_s",
            "age of the serving params: seconds since the active "
            "param set was snapshotted from the learner")
        self._g_score_s = reg.gauge(
            "dl4j_online_score_seconds",
            "wall seconds of the last holdout scoring pass (compare "
            "against the configured score budget)")
        self._c_promotions.inc(0.0, model=model_name)
        self._c_rejections.inc(0.0, model=model_name, reason="worse")

    # ---- scoring ---------------------------------------------------------
    def _load_eval(self, params, model_state):
        """Copy ``params`` and ``model_state`` (any device, any float
        dtype) into the eval clone's own tensors; names and shapes must
        match."""
        m = self.eval_model
        with torch.no_grad():
            for what, dst, src in (("params", m.params, params),
                                   ("model_state", m.model_state,
                                    model_state)):
                fd, fs = flatten_paths(dst), flatten_paths(src)
                if set(fd) != set(fs):
                    raise ValueError(
                        f"candidate {what} names differ from the eval "
                        f"model's: missing {sorted(set(fd) - set(fs))}, "
                        f"extra {sorted(set(fs) - set(fd))}")
                for k, t in fd.items():
                    t.copy_(torch.as_tensor(fs[k]))

    def _score(self, params, model_state) -> float:
        self._load_eval(params, model_state)
        return float(
            self.calc.calculate_score(self.eval_model))

    def score_active(self) -> float:
        """Score the params the fleet is serving RIGHT NOW (replica 0's
        committed copy) — the sentinel's live-score probe and the lazy
        initial baseline."""
        pool = self.router.pool(self.model_name)
        with pool.lock:
            engine = pool.engines[0]
        params, mstate = engine.committed_host()
        return self._score(params, mstate)

    def _better(self, cand: float, active: float) -> str:
        """improved | equal | worse under the calculator's direction."""
        delta = (active - cand) if self.calc.minimize_score \
            else (cand - active)
        if delta > self.min_delta:
            return "improved"
        if delta >= -self.min_delta:
            return "equal"
        return "worse"

    # ---- the gate --------------------------------------------------------
    def run_once(self, candidate: Optional[Candidate] = None,
                 force: bool = False) -> PromotionDecision:
        """One promotion cycle. ``force=True`` skips the score
        comparison (NOT the scoring itself) — the benchmark's
        deliberately-degraded-candidate path, exercising the sentinel.
        """
        if candidate is None:
            candidate = self.learner.snapshot()
        self._publish_staleness()
        if candidate is None:
            return self._reject("no_candidate", None, None, 0, 0.0,
                                False)
        if self.learner.stream.holdout_examples == 0:
            return self._reject("no_holdout", None, None,
                                candidate.iteration, 0.0, False)
        t0 = time.perf_counter()
        try:
            cand_score = self._score(candidate.params,
                                     candidate.model_state)
        except Exception:
            dt = time.perf_counter() - t0
            return self._reject("error", None, self.active_score,
                                candidate.iteration, dt,
                                self._over_budget(dt))
        dt = time.perf_counter() - t0
        over = self._over_budget(dt)
        self._g_score_s.set(dt, model=self.model_name)
        self._g_candidate.set(cand_score, model=self.model_name)
        if math.isnan(cand_score) or math.isinf(cand_score):
            return self._reject("nan", cand_score, self.active_score,
                                candidate.iteration, dt, over)
        with self._lock:
            if self.active_score is None:
                # first cycle: baseline = the params serving today,
                # scored on the same holdout
                self.active_score = self.score_active()
                self._g_active.set(self.active_score,
                                   model=self.model_name)
        if not force:
            verdict = self._better(cand_score, self.active_score)
            if verdict != "improved":
                return self._reject(verdict, cand_score,
                                    self.active_score,
                                    candidate.iteration, dt, over)
        return self._promote(candidate, cand_score,
                             "forced" if force else "improved", dt,
                             over)

    def _over_budget(self, dt: float) -> bool:
        return (self.score_budget_s is not None
                and dt > self.score_budget_s)

    def _reject(self, reason: str, cand_score, active_score,
                iteration: int, dt: float,
                over: bool) -> PromotionDecision:
        self._c_rejections.inc(1.0, model=self.model_name,
                               reason=reason)
        with self._lock:
            self.rejections += 1
            d = PromotionDecision(False, reason, cand_score,
                                  active_score, None, iteration, dt,
                                  over)
            self.last_decision = d
        return d

    def _promote(self, candidate: Candidate, cand_score: float,
                 reason: str, dt: float, over: bool
                 ) -> PromotionDecision:
        pool = self.router.pool(self.model_name)
        # baseline BEFORE the swap: promote_params resets the pool ring,
        # so these are the last pre-swap latencies
        q = pool.ring.quantiles((0.99,))
        baseline_p99 = q.get(0.99)
        with self._lock:
            prev_score = self.active_score
            prev_version = pool.active_version
            self._version_seq += 1
            version = f"online-{self._version_seq}" \
                      f"-it{candidate.iteration}"
        self.router.promote_params(self.model_name, candidate.params,
                                   candidate.model_state,
                                   version=version)
        with self._lock:
            self._prev_active_score = prev_score
            self.active_score = cand_score
            self.active_walltime = candidate.walltime
            self.promotions += 1
            d = PromotionDecision(True, reason, cand_score, prev_score,
                                  version, candidate.iteration, dt,
                                  over)
            self.last_decision = d
        self._c_promotions.inc(1.0, model=self.model_name)
        self._g_active.set(cand_score, model=self.model_name)
        self._publish_staleness()
        if self.sentinel is not None:
            self.sentinel.observe_swap(SwapBaseline(
                t_swap=time.time(), version=version,
                prev_version=prev_version,
                baseline_score=prev_score,
                baseline_p99_s=baseline_p99,
                minimize=self.calc.minimize_score))
        return d

    def notify_rollback(self):
        """Sentinel hook: the promotion was reverted — restore the
        pre-promotion score as the active baseline."""
        with self._lock:
            if self._prev_active_score is not None:
                self.active_score = self._prev_active_score
                self._g_active.set(self.active_score,
                                   model=self.model_name)
            self.active_walltime = None

    def _publish_staleness(self):
        if self.active_walltime is not None:
            self._g_staleness.set(time.time() - self.active_walltime,
                                  model=self.model_name)

    # ---- background loop -------------------------------------------------
    def start(self) -> "PromotionController":
        if self._thread is not None:
            raise RuntimeError("PromotionController already started")
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception:
                    # a scoring/promotion hiccup must not kill the
                    # promotion loop; the next cycle retries
                    pass

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="online-promoter")
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
            d = self.last_decision
            return {
                "promotions": self.promotions,
                "rejections": self.rejections,
                "active_score": self.active_score,
                "staleness_s": (time.time() - self.active_walltime
                                if self.active_walltime else None),
                "last_decision": None if d is None else {
                    "promoted": d.promoted, "reason": d.reason,
                    "candidate_score": d.candidate_score,
                    "active_score": d.active_score,
                    "version": d.version,
                    "iteration": d.iteration,
                    "score_seconds": d.score_seconds,
                    "over_budget": d.over_budget,
                },
            }
