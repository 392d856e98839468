"""Termination conditions for early stopping (a copy of the JAX
package's ``earlystopping/termination.py``).

Analog of deeplearning4j-nn/.../earlystopping/termination/: epoch-level
(MaxEpochsTerminationCondition.java, ScoreImprovementEpochsTermination
Condition.java, BestScoreEpochTerminationCondition.java) and
iteration-level (MaxTimeIterationTerminationCondition.java,
MaxScoreIterationTerminationCondition.java, InvalidScoreIteration
TerminationCondition.java — the NaN/divergence guard, SURVEY §5.2).
"""

from __future__ import annotations

import math
import time


# ---- epoch-level --------------------------------------------------------

class EpochTerminationCondition:
    #: whether terminate() reads ``score``; conditions with score_based
    #: True are skipped on epochs where no held-out score was computed
    score_based = True

    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    score_based = False

    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochsTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) improvement."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.max_no_improve = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self._best = None
        self._epochs_since = 0

    def initialize(self) -> None:
        self._best = None
        self._epochs_since = 0

    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        if self._best is None:
            self._best = score
            return False
        improvement = (self._best - score) if minimize else (score - self._best)
        if improvement > self.min_improvement:
            self._best = score
            self._epochs_since = 0
            return False
        self._epochs_since += 1
        return self._epochs_since >= self.max_no_improve

    def __str__(self):
        return (f"ScoreImprovementEpochsTerminationCondition("
                f"{self.max_no_improve}, {self.min_improvement})")


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least as good as a target value."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = float(best_expected_score)

    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        if minimize:
            return score <= self.best_expected_score
        return score >= self.best_expected_score

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected_score})"


# ---- iteration-level ----------------------------------------------------

class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, last_minibatch_score: float) -> bool:
        raise NotImplementedError


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self) -> None:
        self._start = time.time()

    def terminate(self, last_minibatch_score: float) -> bool:
        if self._start is None:
            self._start = time.time()
        return (time.time() - self._start) >= self.max_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Divergence guard: stop if the minibatch score explodes past a bound."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, last_minibatch_score: float) -> bool:
        return last_minibatch_score > self.max_score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """NaN/Inf guard (termination/InvalidScoreIterationTerminationCondition
    .java) — the reference's divergence detector (SURVEY §5.2)."""

    def terminate(self, last_minibatch_score: float) -> bool:
        return math.isnan(last_minibatch_score) or math.isinf(
            last_minibatch_score)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"
