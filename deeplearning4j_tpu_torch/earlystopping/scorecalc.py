"""Score calculators for early stopping (a copy of the JAX package's
``earlystopping/scorecalc.py``).

Analog of deeplearning4j-nn/.../earlystopping/scorecalc/
(DataSetLossCalculator.java, ClassificationScoreCalculator.java,
RegressionScoreCalculator.java, AutoencoderScoreCalculator.java).
Each computes one scalar score over a held-out iterator; ``minimize``
on the configuration decides the direction.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSetIterator
from deeplearning4j_tpu_torch.evaluation.evaluation import (
    Evaluation,
    RegressionEvaluation,
)


class ScoreCalculator:
    def calculate_score(self, model) -> float:
        raise NotImplementedError

    @property
    def minimize_score(self) -> bool:
        return True


class DataSetLossCalculator(ScoreCalculator):
    """Loss over the iterator (scorecalc/DataSetLossCalculator.java):
    ``average=True`` → example-weighted mean, ``average=False`` → plain
    sum of per-batch losses, as the reference defines."""

    def __init__(self, iterator: DataSetIterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        for ds in self.iterator:
            bs = int(np.asarray(ds.features).shape[0])
            total += float(model.score(ds)) * (bs if self.average else 1.0)
            n += bs
        return total / max(n, 1) if self.average else total


class ClassificationScoreCalculator(ScoreCalculator):
    """Metric from a classification Evaluation; maximized
    (scorecalc/ClassificationScoreCalculator.java)."""

    ACCURACY = "accuracy"
    F1 = "f1"
    PRECISION = "precision"
    RECALL = "recall"

    def __init__(self, metric: str, iterator: DataSetIterator):
        self.metric = metric
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        ev: Evaluation = model.evaluate(self.iterator)
        return float(getattr(ev, self.metric)())

    @property
    def minimize_score(self) -> bool:
        return False


class RegressionScoreCalculator(ScoreCalculator):
    """Metric from RegressionEvaluation; minimized except for
    R²/correlation (scorecalc/RegressionScoreCalculator.java). Valid
    metric names are RegressionEvaluation method names:
    "mean_squared_error", "mean_absolute_error",
    "root_mean_squared_error", "r_squared", "pearson_correlation",
    "average_mean_squared_error"."""

    _MAXIMIZED = ("r_squared", "pearson_correlation")

    def __init__(self, metric: str, iterator: DataSetIterator):
        if not hasattr(RegressionEvaluation, metric):
            raise ValueError(
                f"unknown regression metric {metric!r}; expected a "
                "RegressionEvaluation method name such as "
                "'mean_squared_error' or 'r_squared'")
        self.metric = metric
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        ev: RegressionEvaluation = model.evaluate_regression(self.iterator)
        return float(getattr(ev, self.metric)())

    @property
    def minimize_score(self) -> bool:
        return self.metric not in self._MAXIMIZED


class CustomScoreCalculator(ScoreCalculator):
    """Adapter for a plain callable ``model -> float``."""

    def __init__(self, fn: Callable, minimize: bool = True):
        self.fn = fn
        self._minimize = minimize

    def calculate_score(self, model) -> float:
        return float(self.fn(model))

    @property
    def minimize_score(self) -> bool:
        return self._minimize
