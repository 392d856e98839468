"""Updaters (optimizers).

The serializable config dataclasses of the JAX package's updater family
(reference: ``org.nd4j.linalg.learning.config.IUpdater`` — Sgd, Adam,
Nesterovs, RmsProp, AdaGrad, ...), with the same names and fields, so a
``configuration.json`` written by either package loads in the other.

The update math of ``Sgd``, ``Nesterovs`` and ``NoOp`` is ported as
functional updates on dicts of tensors with optax's semantics
(``to_transform``): ``init(params) -> state`` and
``update(grads, state, params) -> (updates, new_state)``, applied as
``p + u``. The state nests dicts keyed by optax's pytree path parts
(``#0``, ``.trace``), so it flattens to the same checkpoint names as the
JAX package's ``updater/<path>.npy``. The other updaters' math and
learning-rate schedules (``optimize/schedules.py``) are not ported yet:
``learning_rate`` is a float here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from deeplearning4j_tpu_torch.utils.serde import register_serializable

Tree = Dict[str, Any]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensor leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class GradientTransformation(NamedTuple):
    """optax's (init, update) pair on nested dicts of tensors."""
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def _scale(step: float, grads: Tree) -> Tree:
    """optax's ``scale(-learning_rate)``: step · g per leaf."""
    return tree_map(lambda g: step * g, grads)


def _lr(updater) -> float:
    lr = updater.learning_rate
    if not isinstance(lr, (int, float)):
        raise NotImplementedError(
            f"{type(updater).__name__}: learning-rate schedules are not "
            "ported yet")
    return float(lr)


class Updater:
    """Base class for serializable updater configs."""

    def to_transform(self) -> GradientTransformation:
        raise NotImplementedError(
            f"{type(self).__name__}: the update math is not ported yet "
            "(Sgd, Nesterovs and NoOp are)")

    @property
    def has_state(self) -> bool:
        return True


@register_serializable
@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    learning_rate: float = 1e-3

    def to_transform(self):
        """``optax.sgd(lr)``: u = -lr · g, no state."""
        lr = _lr(self)
        return GradientTransformation(
            lambda params: {},
            lambda grads, state, params=None: (_scale(-lr, grads), state))

    @property
    def has_state(self) -> bool:
        return False


@register_serializable
@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    learning_rate: float = 0.1
    momentum: float = 0.9

    def to_transform(self):
        """``optax.sgd(lr, momentum, nesterov=True)``: t ← g + μ·t,
        u = -lr · (g + μ·t), with the trace t in the params' dtype under
        optax's state path ``#0/.trace``."""
        lr, mu = _lr(self), float(self.momentum)
        f = lambda g, t: g + mu * t

        def init(params):
            return {"#0": {".trace": tree_map(torch.zeros_like, params)}}

        def update(grads, state, params=None):
            trace = tree_map(f, grads, state["#0"][".trace"])
            return (_scale(-lr, tree_map(f, grads, trace)),
                    {"#0": {".trace": trace}})
        return GradientTransformation(init, update)


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

    def to_transform(self):
        """``optax.set_to_zero()``."""
        return GradientTransformation(
            lambda params: {},
            lambda grads, state, params=None: (
                tree_map(torch.zeros_like, grads), state))

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
