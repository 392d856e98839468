"""Early-stopping configuration + result (a copy of the JAX
package's ``earlystopping/config.py``).

Analog of the reference's early-stopping subsystem
(deeplearning4j-nn/.../earlystopping/EarlyStoppingConfiguration.java and
EarlyStoppingResult.java): a ``Builder`` gathering a model saver, a score
calculator, epoch/iteration termination conditions, and an evaluation
frequency; the trainer (earlystopping/trainer.py) drives the loop.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from deeplearning4j_tpu_torch.earlystopping.savers import InMemoryModelSaver, ModelSaver
from deeplearning4j_tpu_torch.earlystopping.scorecalc import ScoreCalculator
from deeplearning4j_tpu_torch.earlystopping.termination import (
    EpochTerminationCondition,
    IterationTerminationCondition,
)


class TerminationReason(enum.Enum):
    """Mirrors EarlyStoppingResult.TerminationReason."""
    ERROR = "Error"
    ITERATION_TERMINATION_CONDITION = "IterationTerminationCondition"
    EPOCH_TERMINATION_CONDITION = "EpochTerminationCondition"


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: TerminationReason
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: object  # model instance (restored from saver)

    def __str__(self):
        return (f"EarlyStoppingResult(reason={self.termination_reason.value}, "
                f"details={self.termination_details}, "
                f"bestModelEpoch={self.best_model_epoch}, "
                f"bestModelScore={self.best_model_score:.6f}, "
                f"totalEpochs={self.total_epochs})")


class EarlyStoppingConfiguration:
    """Holds the full early-stopping recipe. Use ``Builder``."""

    def __init__(self, saver: ModelSaver,
                 score_calculator: Optional[ScoreCalculator],
                 epoch_terminations: List[EpochTerminationCondition],
                 iteration_terminations: List[IterationTerminationCondition],
                 evaluate_every_n_epochs: int = 1,
                 save_last_model: bool = False,
                 minimize: bool = True):
        self.saver = saver
        self.score_calculator = score_calculator
        self.epoch_terminations = list(epoch_terminations)
        self.iteration_terminations = list(iteration_terminations)
        self.evaluate_every_n_epochs = evaluate_every_n_epochs
        self.save_last_model = save_last_model
        self.minimize = minimize

    class Builder:
        def __init__(self):
            self._saver: ModelSaver = InMemoryModelSaver()
            self._score_calc: Optional[ScoreCalculator] = None
            self._epoch_term: List[EpochTerminationCondition] = []
            self._iter_term: List[IterationTerminationCondition] = []
            self._eval_every = 1
            self._save_last = False
            self._minimize = True

        def model_saver(self, saver: ModelSaver):
            self._saver = saver
            return self

        def score_calculator(self, calc: ScoreCalculator):
            self._score_calc = calc
            return self

        def epoch_termination_conditions(self, *conds):
            self._epoch_term.extend(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._iter_term.extend(conds)
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._eval_every = int(n)
            return self

        def save_last_model(self, b: bool = True):
            self._save_last = b
            return self

        def minimize(self, b: bool = True):
            self._minimize = b
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            return EarlyStoppingConfiguration(
                saver=self._saver,
                score_calculator=self._score_calc,
                epoch_terminations=self._epoch_term,
                iteration_terminations=self._iter_term,
                evaluate_every_n_epochs=self._eval_every,
                save_last_model=self._save_last,
                minimize=self._minimize,
            )
