"""OnlineServing: train-and-serve in one process.

The orchestrator that wires the online-learning subsystem together —
one call builds the whole loop:

- a **serving clone** of the model behind a FleetRouter pool (warm
  bucket ladder, admission control);
- a **SampleStreamIterator** subscribed to the broker topic, feeding
- the **OnlineLearner** incrementally fitting the TRAINING model;
- a **PromotionController** scoring candidate snapshots on the
  stream's holdout and hot-promoting improvements (param-only swap,
  no new bucket dispatch); and
- a **RegressionSentinel** watching post-swap telemetry, rolling back
  to the bitwise standby on live regressions.

Three model copies exist on purpose (the train step updates params in
place and the promoter copies candidates into its scorer, so serving
and scoring must never share storage with them): the caller's model
trains, ``clone()`` #1 serves (its engines commit copies of their
own), ``clone()`` #2 is the promoter's scoring scratchpad. On the card
the learner runs kernels 1-6 of the fused ResNet50 blocks, the serving
pool and the scorer kernels 1-2.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.earlystopping.scorecalc import (
    DataSetLossCalculator,
)
from deeplearning4j_tpu_torch.online.learner import OnlineLearner
from deeplearning4j_tpu_torch.online.promoter import PromotionController
from deeplearning4j_tpu_torch.online.sentinel import RegressionSentinel
from deeplearning4j_tpu_torch.online.stream import SampleStreamIterator
from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter


class OnlineServing:
    """One-process train-and-serve runtime over a broker-fed stream."""

    def __init__(self, model, transport, *, topic: str = "train",
                 model_name: str = "online",
                 feature_shape=None, batch_limit: int = 32,
                 pool_size: int = 1, slo_ms: Optional[float] = None,
                 holdout_every: int = 8, holdout_max: int = 512,
                 holdout_batch: int = 64,
                 promote_interval_s: float = 5.0,
                 min_delta: float = 0.0,
                 score_budget_s: Optional[float] = None,
                 rollback_p99_factor: float = 3.0,
                 rollback_p99_floor_s: float = 0.050,
                 rollback_score_delta: float = 0.0,
                 sentinel_window_s: float = 30.0,
                 sentinel_poll_s: float = 0.5,
                 router: Optional[FleetRouter] = None,
                 registry=None, **engine_kwargs):
        if model.params is None:
            model.init()
        self.model = model
        self.model_name = model_name
        # serving and eval copies: deep clones, never aliases of the
        # in-place updated training params
        serving_model = model.clone()
        eval_model = model.clone()
        self.router = router if router is not None else FleetRouter(
            slo_ms=slo_ms, registry=registry, device=model.device)
        self.pool = self.router.add_pool(
            model_name, serving_model, version="v0",
            pool_size=pool_size, slo_ms=slo_ms,
            feature_shape=feature_shape, batch_limit=batch_limit,
            **engine_kwargs)
        self.stream = SampleStreamIterator(
            transport, topic, holdout_every=holdout_every,
            holdout_max=holdout_max, registry=registry)
        self.learner = OnlineLearner(model, self.stream)
        calc = DataSetLossCalculator(
            self.stream.holdout_view(holdout_batch))
        self.sentinel = RegressionSentinel(
            self.router, model_name,
            p99_factor=rollback_p99_factor,
            p99_floor_s=rollback_p99_floor_s,
            score_delta=rollback_score_delta,
            window_s=sentinel_window_s, poll_s=sentinel_poll_s,
            registry=registry)
        self.promoter = PromotionController(
            self.router, model_name, self.learner, calc, eval_model,
            min_delta=min_delta, score_budget_s=score_budget_s,
            interval_s=promote_interval_s, sentinel=self.sentinel,
            registry=registry)
        # close the loop: the sentinel probes the LIVE committed params
        # with the promoter's scorer, and a rollback restores the
        # promoter's baseline
        self.sentinel.score_fn = self.promoter.score_active
        self.sentinel.on_rollback = \
            lambda reason: self.promoter.notify_rollback()
        self._started = False
        self._lock = threading.Lock()

    # ---- lifecycle -------------------------------------------------------
    def start(self, *, background_promotion: bool = True
              ) -> "OnlineServing":
        with self._lock:
            if self._started:
                raise RuntimeError("OnlineServing already started")
            self._started = True
        self.learner.start()
        if background_promotion:
            self.promoter.start()
            self.sentinel.start()
        return self

    def stop(self, timeout: float = 30.0):
        self.promoter.stop()
        self.sentinel.stop()
        try:
            self.learner.stop(timeout)
        finally:
            self.router.shutdown()

    # the CLI's serve front door calls shutdown() on whatever it built
    shutdown = stop

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # ---- serving passthrough ---------------------------------------------
    def submit(self, features):
        return self.router.submit(features, model=self.model_name)

    def output(self, features):
        return self.router.output(features, model=self.model_name)

    def promote_params(self, params, model_state=None, *,
                       version: Optional[str] = None):
        """Hot-swap externally refreshed params into the warm serving
        pool (FleetRouter.promote_params: structure-validated,
        param-only, no new bucket dispatch) — the path for weights trained
        OUTSIDE the broker-fed learner, e.g. embeddings refreshed by
        ``Word2Vec.fit_stream`` from a corpus stream. Bypasses the
        gated promoter deliberately: the caller owns quality gating."""
        return self.router.promote_params(self.model_name, params,
                                          model_state, version=version)

    # ---- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "model": self.model_name,
            "learner": {
                "alive": self.learner.alive,
                "iterations": self.learner.iterations,
            },
            "stream": {
                "topic": self.stream.topic,
                "batches": self.stream.batches_consumed,
                "samples": self.stream.samples_consumed,
                "malformed": self.stream.malformed,
                "holdout_examples": self.stream.holdout_examples,
            },
            "promotion": self.promoter.stats(),
            "sentinel": self.sentinel.stats(),
            "pool": self.pool.stats(),
        }
