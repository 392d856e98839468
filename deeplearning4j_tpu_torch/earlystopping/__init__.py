"""Early stopping: the port of the JAX package's ``earlystopping/``
(reference: deeplearning4j-nn/.../earlystopping/). The configuration,
savers, score calculators and termination conditions are framework
neutral copies; the trainer runs each epoch through the model's
``fit(iterator)``, so the feeder, K-step calls, listeners, telemetry and
the tracer all apply."""

from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    TerminationReason,
)
from deeplearning4j_tpu_torch.earlystopping.savers import (
    InMemoryModelSaver,
    LocalFileGraphSaver,
    LocalFileModelSaver,
    ModelSaver,
)
from deeplearning4j_tpu_torch.earlystopping.scorecalc import (
    ClassificationScoreCalculator,
    CustomScoreCalculator,
    DataSetLossCalculator,
    RegressionScoreCalculator,
    ScoreCalculator,
)
from deeplearning4j_tpu_torch.earlystopping.termination import (
    BestScoreEpochTerminationCondition,
    EpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    IterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochsTerminationCondition,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import (
    EarlyStoppingGraphTrainer,
    EarlyStoppingTrainer,
)

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult", "TerminationReason",
    "ModelSaver", "InMemoryModelSaver", "LocalFileModelSaver",
    "LocalFileGraphSaver", "ScoreCalculator", "DataSetLossCalculator",
    "ClassificationScoreCalculator", "RegressionScoreCalculator",
    "CustomScoreCalculator", "EpochTerminationCondition",
    "MaxEpochsTerminationCondition",
    "ScoreImprovementEpochsTerminationCondition",
    "BestScoreEpochTerminationCondition", "IterationTerminationCondition",
    "MaxTimeIterationTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition", "EarlyStoppingTrainer",
    "EarlyStoppingGraphTrainer",
]
