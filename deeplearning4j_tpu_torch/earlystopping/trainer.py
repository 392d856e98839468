"""Early-stopping trainer.

The port of the JAX package's ``earlystopping/trainer.py`` (reference:
deeplearning4j-nn/.../earlystopping/trainer/ BaseEarlyStoppingTrainer,
EarlyStoppingTrainer, EarlyStoppingGraphTrainer): the held-out score
every N epochs, the best model kept by the saver and restored into the
result. One trainer serves both model classes.

Each epoch is one ``model.fit(train_data, k_steps=..., prefetch=...)``
call, so it runs through the device feeder and the K-step call, with
the model's listeners, telemetry, tracer and flight recorder attached.
The JAX package's trainer steps ``fit(DataSet)`` batch by batch; the
parameters after an epoch are the same (its fed and unfed K = 1 paths
agree). Iteration termination conditions are checked after every
dispatch (each batch at K = 1, each K-step call otherwise) on the
dispatch's loss — ``float(loss)``, a sync the JAX package's trainer pays
too — by a listener that the trainer attaches for the run; one that
fires ends the running fit after that dispatch.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSetIterator
from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    TerminationReason,
)
from deeplearning4j_tpu_torch.observe.tracer import get_tracer
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


class _IterationWatch(TrainingListener):
    """Checks the iteration termination conditions after each dispatch;
    the first that fires stops the model's running fit."""

    def __init__(self, conditions):
        self.conditions = conditions
        self.fired = None

    def iteration_done(self, model, iteration, epoch, loss, etl_ms,
                       batch_size):
        last = float(loss)
        for cond in self.conditions:
            if cond.terminate(last):
                self.fired = cond
                model._stop_requested = True
                return


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_data: DataSetIterator,
                 k_steps: Optional[int] = None,
                 prefetch: Optional[int] = None):
        self.config = config
        self.model = model
        self.train_data = train_data
        self.k_steps = k_steps
        self.prefetch = prefetch
        self.listener = None  # optional EarlyStoppingListener-style hook

    def set_listener(self, listener) -> None:
        self.listener = listener

    def _score_direction_minimize(self) -> bool:
        if self.config.score_calculator is not None:
            return self.config.score_calculator.minimize_score
        return self.config.minimize

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        minimize = self._score_direction_minimize()
        for c in cfg.epoch_terminations:
            c.initialize()
        for c in cfg.iteration_terminations:
            c.initialize()
        if self.model.params is None:
            self.model.init()
        watch = (_IterationWatch(cfg.iteration_terminations)
                 if cfg.iteration_terminations else None)
        if watch is not None:
            self.model.add_listeners(watch)
        try:
            return self._run(cfg, minimize, watch)
        finally:
            if watch is not None:
                self.model.listeners.remove(watch)

    def _run(self, cfg, minimize, watch) -> EarlyStoppingResult:
        best_score: Optional[float] = None
        best_epoch = -1
        score_vs_epoch = {}
        epoch = 0
        reason = None
        details = ""
        tracer = get_tracer(self.model)

        while True:
            # ---- one epoch; an iteration condition may end it early -----
            self.train_data.reset()
            self.model.fit(self.train_data, epochs=1, k_steps=self.k_steps,
                           prefetch=self.prefetch)
            if watch is not None and watch.fired is not None:
                reason = TerminationReason.ITERATION_TERMINATION_CONDITION
                details = str(watch.fired)
                break

            # ---- held-out score + best-model tracking -------------------
            score = None
            if (cfg.score_calculator is not None
                    and epoch % cfg.evaluate_every_n_epochs == 0):
                with tracer.span("eval", cat="eval"):
                    score = cfg.score_calculator.calculate_score(self.model)
                score_vs_epoch[epoch] = score
                improved = (best_score is None
                            or (minimize and score < best_score)
                            or (not minimize and score > best_score))
                if improved:
                    best_score = score
                    best_epoch = epoch
                    with tracer.span("checkpoint", cat="io"):
                        cfg.saver.save_best_model(self.model, score)
                if self.listener is not None:
                    self.listener(epoch, score, self.model)
            elif cfg.score_calculator is None:
                # no held-out calculator configured: the training loss is
                # the score by definition (reference default)
                score = self.model.score()

            if cfg.save_last_model:
                with tracer.span("checkpoint", cat="io"):
                    cfg.saver.save_latest_model(
                        self.model, score if score is not None
                        else self.model.score())

            # ---- epoch conditions ---------------------------------------
            # score-based conditions only see the calculator's metric; on
            # epochs without a held-out score only count/time conditions
            # can fire
            stop = False
            for cond in cfg.epoch_terminations:
                if score is None and getattr(cond, "score_based", True):
                    continue
                if cond.terminate(epoch, score, minimize):
                    stop = True
                    reason = TerminationReason.EPOCH_TERMINATION_CONDITION
                    details = str(cond)
                    break
            if stop:
                break
            epoch += 1

        best_model = cfg.saver.get_best_model()
        if best_model is None:
            best_model = self.model
            if best_score is None:
                best_score = float("nan")
                best_epoch = epoch
        return EarlyStoppingResult(
            termination_reason=reason or TerminationReason.ERROR,
            termination_details=details,
            score_vs_epoch=score_vs_epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score if best_score is not None
            else float("nan"),
            total_epochs=epoch + 1,
            best_model=best_model,
        )


# The reference has a distinct class for ComputationGraph; one here.
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
