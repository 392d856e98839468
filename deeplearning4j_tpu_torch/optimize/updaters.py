"""Updater (optimizer) configurations.

The serializable config dataclasses of the JAX package's updater family
(reference: ``org.nd4j.linalg.learning.config.IUpdater`` — Sgd, Adam,
Nesterovs, RmsProp, AdaGrad, ...), with the same names and fields, so a
``configuration.json`` written by either package loads in the other. The
update math comes with the training slice; learning-rate schedules come
with it too, so ``learning_rate`` is a float here.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.utils.serde import register_serializable


class Updater:
    """Base class for serializable updater configs."""

    @property
    def has_state(self) -> bool:
        return True


@register_serializable
@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    learning_rate: float = 1e-3

    @property
    def has_state(self) -> bool:
        return False


@register_serializable
@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    learning_rate: float = 0.1
    momentum: float = 0.9


@register_serializable
@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_serializable
@dataclasses.dataclass(frozen=True)
class AdamW(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 1e-2


@register_serializable
@dataclasses.dataclass(frozen=True)
class AdaMax(Updater):
    learning_rate: float = 2e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_serializable
@dataclasses.dataclass(frozen=True)
class Nadam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_serializable
@dataclasses.dataclass(frozen=True)
class AMSGrad(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_serializable
@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8


@register_serializable
@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    learning_rate: float = 1e-1
    epsilon: float = 1e-6


@register_serializable
@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6


@register_serializable
@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    """Frozen parameters — the reference uses NoOp for FrozenLayer."""

    @property
    def has_state(self) -> bool:
        return False


@register_serializable
@dataclasses.dataclass(frozen=True)
class GradientNormalizationConfig:
    """Gradient normalization/clipping, analog of the reference's
    ``GradientNormalization`` enum (nn/conf/GradientNormalization.java)."""
    kind: str = "none"  # none|renormalize_l2|clip_value|clip_l2_per_layer|clip_l2_global
    threshold: float = 1.0
