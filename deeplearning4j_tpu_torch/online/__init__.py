"""Online learning: train-and-serve in one process with gated hot
promotion (the port of the JAX package's ``online/``).

- ``stream``   — broker-fed unbounded DataSetIterator + holdout
- ``learner``  — OnlineLearner: incremental fit off the stream
- ``promoter`` — PromotionController: holdout-gated param hot swap
- ``sentinel`` — RegressionSentinel: post-swap watchdog + rollback
- ``runtime``  — OnlineServing: the wired-together orchestrator
"""

from deeplearning4j_tpu_torch.online.learner import Candidate, OnlineLearner
from deeplearning4j_tpu_torch.online.promoter import (
    PromotionController,
    PromotionDecision,
    SwapBaseline,
)
from deeplearning4j_tpu_torch.online.runtime import OnlineServing
from deeplearning4j_tpu_torch.online.sentinel import RegressionSentinel
from deeplearning4j_tpu_torch.online.stream import (
    HoldoutIterator,
    SampleStreamIterator,
    pack_samples,
    publish_samples,
    unpack_samples,
)

__all__ = [
    "Candidate",
    "HoldoutIterator",
    "OnlineLearner",
    "OnlineServing",
    "PromotionController",
    "PromotionDecision",
    "RegressionSentinel",
    "SampleStreamIterator",
    "SwapBaseline",
    "pack_samples",
    "publish_samples",
    "unpack_samples",
]
