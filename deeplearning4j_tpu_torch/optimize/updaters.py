"""Updaters (optimizers).

The serializable config dataclasses of the JAX package's updater family
(reference: ``org.nd4j.linalg.learning.config.IUpdater`` — Sgd, Adam,
Nesterovs, RmsProp, AdaGrad, ...), with the same names and fields, so a
``configuration.json`` written by either package loads in the other.

Every updater's math and every gradient normalization is ported as a
functional update on dicts of tensors with the semantics of the optax
0.2.6 transforms the JAX package hands its configs to (``to_transform``):
``init(params) -> state`` and ``update(grads, state, params) ->
(updates, new_state)``, applied as ``p + u``. Each updater is the same
``chain`` of the same steps as its optax alias (``scale_by_adam``,
``add_decayed_weights``, ``scale_by_learning_rate``, ...), and the state
nests dicts keyed by optax's pytree path parts (``#0``, ``.mu``), so it
flattens to the same checkpoint names as the JAX package's
``updater/<path>.npy`` (``chain`` keys each transform's state by its
position, ``#i``, as ``optax.chain``'s tuple does; an empty state has no
leaves). A ``learning_rate`` is a float or a ``Schedule``
(``optimize/schedules.py``): a schedule is read at the step count that
the learning-rate step keeps in its own state (``#i/.count``), as
optax's ``scale_by_schedule`` does, not at the model's iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from deeplearning4j_tpu_torch.optimize.schedules import Schedule
from deeplearning4j_tpu_torch.utils.serde import register_serializable

Tree = Dict[str, Any]
LR = Union[float, Schedule]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensor leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The tensor leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def named_leaves(tree: Tree):
    """(leaf key, leaf) of nested dicts: the key is the last path part."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v)
        else:
            yield k, v


class GradientTransformation(NamedTuple):
    """optax's (init, update) pair on nested dicts of tensors."""
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def _scale(step: float, grads: Tree) -> Tree:
    """optax's ``scale(-learning_rate)``: step · g per leaf."""
    return tree_map(lambda g: step * g, grads)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """``optax.chain``: each transform in turn on the previous one's
    updates; the state keys each transform's state by its position."""
    def init(params):
        return {f"#{i}": tx.init(params) for i, tx in enumerate(txs)}

    def update(grads, state, params=None):
        new_state = {}
        for i, tx in enumerate(txs):
            grads, new_state[f"#{i}"] = tx.update(grads, state[f"#{i}"],
                                                  params)
        return grads, new_state
    return GradientTransformation(init, update)


def _device(params: Tree) -> Optional[torch.device]:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else None


def _count0(params: Tree) -> torch.Tensor:
    """optax's step count: an int32 zero beside the parameters."""
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _zeros(params: Tree) -> Tree:
    return tree_map(torch.zeros_like, params)


def _moment(grads: Tree, moments: Tree, decay: float, order: int) -> Tree:
    """``optax.tree.update_moment``: (1 - decay)·g^order + decay·t."""
    if order == 1:
        return tree_map(lambda g, t: (1 - decay) * g + decay * t, grads,
                        moments)
    return tree_map(lambda g, t: (1 - decay) * (g * g) + decay * t, grads,
                    moments)


def _bias_correction(moment: Tree, decay: float,
                     count: torch.Tensor) -> Tree:
    """``optax.tree.bias_correction``: t / (1 - decay^count), the power
    taken in float32, the division in the moment's dtype."""
    cf = count.to(torch.float32)
    bc = 1 - torch.pow(torch.tensor(decay, device=cf.device), cf)
    return tree_map(lambda t: t / bc.to(t.dtype), moment)


def identity() -> GradientTransformation:
    """``optax.identity()``: no state, updates as they are."""
    return GradientTransformation(
        lambda params: {}, lambda grads, state, params=None: (grads, state))


def scale_by_learning_rate(lr: Optional[LR]) -> GradientTransformation:
    """``optax.scale_by_learning_rate``: -lr · g for a float; for a
    schedule, ``scale_by_schedule``: -value_at(count) · g (in g's dtype)
    with the count in this step's own state (``.count``), advanced after
    it is read; ``None`` (AdaDelta's) is the identity, so the update keeps
    the sign of the scaled gradient, as optax 0.2.6 leaves it."""
    if lr is None:
        return identity()
    if isinstance(lr, Schedule):
        def update(grads, state, params=None):
            count = state[".count"]
            step = -lr.value_at(count)
            return (tree_map(lambda g: step.to(g.dtype) * g, grads),
                    {".count": count + 1})
        return GradientTransformation(
            lambda params: {".count": _count0(params)}, update)
    step = -float(lr)
    return GradientTransformation(
        lambda params: {},
        lambda grads, state, params=None: (_scale(step, grads), state))


def trace(decay: float, nesterov: bool) -> GradientTransformation:
    """``optax.trace``: t ← g + decay·t, u = g + decay·t (Nesterov) or t,
    with the trace in the params' dtype under ``.trace``."""
    f = lambda g, t: g + decay * t

    def update(grads, state, params=None):
        t = tree_map(f, grads, state[".trace"])
        return (tree_map(f, grads, t) if nesterov else t), {".trace": t}
    return GradientTransformation(lambda params: {".trace": _zeros(params)},
                                  update)


def scale_by_adam(b1: float, b2: float, eps: float,
                  nesterov: bool = False) -> GradientTransformation:
    """``optax.scale_by_adam``: mu ← (1-b1)·g + b1·mu, nu ← (1-b2)·g² +
    b2·nu, count ← count + 1 (int32), u = m̂ / (√v̂ + eps) with
    m̂ = mu / (1 - b1^count) and v̂ = nu / (1 - b2^count). With
    ``nesterov`` (Nadam), m̂ = b1 · mu / (1 - b1^(count+1)) +
    (1 - b1) · g / (1 - b1^count). State ``.count``, ``.mu``, ``.nu``."""
    def init(params):
        return {".count": _count0(params), ".mu": _zeros(params),
                ".nu": _zeros(params)}

    def update(grads, state, params=None):
        mu = _moment(grads, state[".mu"], b1, 1)
        nu = _moment(grads, state[".nu"], b2, 2)
        count = state[".count"] + 1
        if nesterov:
            mu_hat = tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                              _bias_correction(mu, b1, count + 1),
                              _bias_correction(grads, b1, count))
        else:
            mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        u = tree_map(lambda m, v: m / (torch.sqrt(v) + eps), mu_hat, nu_hat)
        return u, {".count": count, ".mu": mu, ".nu": nu}
    return GradientTransformation(init, update)


def scale_by_adamax(b1: float, b2: float,
                    eps: float) -> GradientTransformation:
    """``optax.scale_by_adamax``: mu as Adam's, nu ← max(|g| + eps,
    b2·nu) (no bias correction), u = m̂ / nu."""
    def init(params):
        return {".count": _count0(params), ".mu": _zeros(params),
                ".nu": _zeros(params)}

    def update(grads, state, params=None):
        count = state[".count"] + 1
        mu = _moment(grads, state[".mu"], b1, 1)
        nu = tree_map(lambda g, t: torch.maximum(torch.abs(g) + eps, b2 * t),
                      grads, state[".nu"])
        u = tree_map(lambda m, v: m / v, _bias_correction(mu, b1, count), nu)
        return u, {".count": count, ".mu": mu, ".nu": nu}
    return GradientTransformation(init, update)


def scale_by_amsgrad(b1: float, b2: float,
                     eps: float) -> GradientTransformation:
    """``optax.scale_by_amsgrad``: Adam's moments, nu_max ← max(nu_max,
    v̂), u = m̂ / (√nu_max + eps). State ``.count``, ``.mu``, ``.nu``,
    ``.nu_max``."""
    def init(params):
        return {".count": _count0(params), ".mu": _zeros(params),
                ".nu": _zeros(params), ".nu_max": _zeros(params)}

    def update(grads, state, params=None):
        mu = _moment(grads, state[".mu"], b1, 1)
        nu = _moment(grads, state[".nu"], b2, 2)
        count = state[".count"] + 1
        nu_max = tree_map(torch.maximum, state[".nu_max"],
                          _bias_correction(nu, b2, count))
        u = tree_map(lambda m, v: m / (torch.sqrt(v) + eps),
                     _bias_correction(mu, b1, count), nu_max)
        return u, {".count": count, ".mu": mu, ".nu": nu, ".nu_max": nu_max}
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """``optax.add_decayed_weights``: g + wd·p on EVERY leaf (biases too;
    no mask), no state."""
    return GradientTransformation(
        lambda params: {},
        lambda grads, state, params=None: (
            tree_map(lambda g, p: g + weight_decay * p, grads, params),
            state))


def scale_by_rms(decay: float, eps: float) -> GradientTransformation:
    """``optax.scale_by_rms`` (initial_scale 0, eps inside the root):
    nu ← (1-decay)·g² + decay·nu, u = g · rsqrt(nu + eps). State
    ``.nu``."""
    def update(grads, state, params=None):
        nu = _moment(grads, state[".nu"], decay, 2)
        return (tree_map(lambda n, g: torch.rsqrt(n + eps) * g, nu, grads),
                {".nu": nu})
    return GradientTransformation(lambda params: {".nu": _zeros(params)},
                                  update)


def scale_by_rss(initial: float, eps: float) -> GradientTransformation:
    """``optax.scale_by_rss``: the sum of squares starts at ``initial``
    (optax.adagrad's 0.1), s ← g² + s, u = g · rsqrt(s + eps) where
    s > 0, else 0. State ``.sum_of_squares``."""
    def update(grads, state, params=None):
        ss = tree_map(lambda g, t: g * g + t, grads, state[".sum_of_squares"])
        inv = tree_map(lambda t: torch.where(t > 0, torch.rsqrt(t + eps),
                                             torch.zeros_like(t)), ss)
        return (tree_map(lambda a, g: a * g, inv, grads),
                {".sum_of_squares": ss})
    return GradientTransformation(
        lambda params: {".sum_of_squares": tree_map(
            lambda p: torch.full_like(p, initial), params)}, update)


def scale_by_adadelta(rho: float, eps: float) -> GradientTransformation:
    """``optax.scale_by_adadelta``: e_g ← (1-rho)·g² + rho·e_g,
    u = √(e_x + eps) / √(e_g + eps) · g, e_x ← (1-rho)·u² + rho·e_x.
    State ``.e_g``, ``.e_x``."""
    def init(params):
        return {".e_g": _zeros(params), ".e_x": _zeros(params)}

    def update(grads, state, params=None):
        e_g = _moment(grads, state[".e_g"], rho, 2)
        u = tree_map(lambda g, cur, prev: (torch.sqrt(prev + eps)
                                           / torch.sqrt(cur + eps)) * g,
                     grads, e_g, state[".e_x"])
        return u, {".e_g": e_g, ".e_x": _moment(u, state[".e_x"], rho, 2)}
    return GradientTransformation(init, update)


class Updater:
    """Base class for serializable updater configs."""

    def to_transform(self) -> GradientTransformation:
        raise NotImplementedError

    @property
    def has_state(self) -> bool:
        return True


@register_serializable
@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    learning_rate: LR = 1e-3

    def to_transform(self):
        """``optax.sgd(lr)``: u = -lr · g."""
        return chain(identity(), scale_by_learning_rate(self.learning_rate))

    @property
    def has_state(self) -> bool:
        return False


@register_serializable
@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    learning_rate: LR = 0.1
    momentum: float = 0.9

    def to_transform(self):
        """``optax.sgd(lr, momentum, nesterov=True)``: t ← g + μ·t,
        u = -lr · (g + μ·t), the trace under ``#0/.trace``."""
        return chain(trace(float(self.momentum), nesterov=True),
                     scale_by_learning_rate(self.learning_rate))


@register_serializable
@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self):
        """``optax.adam(lr, b1, b2, eps)``: ``#0/.count``, ``#0/.mu``,
        ``#0/.nu`` (``scale_by_adam``), then the learning-rate step."""
        return chain(scale_by_adam(float(self.beta1), float(self.beta2),
                                   float(self.epsilon)),
                     scale_by_learning_rate(self.learning_rate))


@register_serializable
@dataclasses.dataclass(frozen=True)
class AdamW(Updater):
    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 1e-2

    def to_transform(self):
        """``optax.adamw``: Adam's step plus wd·p on every leaf, then
        scaled by -lr (so the decay is scaled by the learning rate)."""
        return chain(scale_by_adam(float(self.beta1), float(self.beta2),
                                   float(self.epsilon)),
                     add_decayed_weights(float(self.weight_decay)),
                     scale_by_learning_rate(self.learning_rate))


@register_serializable
@dataclasses.dataclass(frozen=True)
class AdaMax(Updater):
    learning_rate: LR = 2e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self):
        """``optax.adamax``."""
        return chain(scale_by_adamax(float(self.beta1), float(self.beta2),
                                     float(self.epsilon)),
                     scale_by_learning_rate(self.learning_rate))


@register_serializable
@dataclasses.dataclass(frozen=True)
class Nadam(Updater):
    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self):
        """``optax.nadam``: ``scale_by_adam(nesterov=True)``."""
        return chain(scale_by_adam(float(self.beta1), float(self.beta2),
                                   float(self.epsilon), nesterov=True),
                     scale_by_learning_rate(self.learning_rate))


@register_serializable
@dataclasses.dataclass(frozen=True)
class AMSGrad(Updater):
    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self):
        """``optax.amsgrad``."""
        return chain(scale_by_amsgrad(float(self.beta1), float(self.beta2),
                                      float(self.epsilon)),
                     scale_by_learning_rate(self.learning_rate))


@register_serializable
@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    learning_rate: LR = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def to_transform(self):
        """``optax.rmsprop(lr, decay, eps)``: ``#0/.nu``, the
        learning-rate step, and the identity where the momentum trace
        would go."""
        return chain(scale_by_rms(float(self.rms_decay), float(self.epsilon)),
                     scale_by_learning_rate(self.learning_rate), identity())


@register_serializable
@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    learning_rate: LR = 1e-1
    epsilon: float = 1e-6

    def to_transform(self):
        """``optax.adagrad(lr, eps=eps)``: the accumulator starts at
        optax's 0.1 (``#0/.sum_of_squares``)."""
        return chain(scale_by_rss(0.1, float(self.epsilon)),
                     scale_by_learning_rate(self.learning_rate))


@register_serializable
@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def to_transform(self):
        """``optax.adadelta(rho=rho, eps=eps)`` with no learning rate:
        weight decay 0 (``#0``), ``#1/.e_g`` and ``#1/.e_x``, and the
        identity in place of the learning-rate step. optax 0.2.6 turns a
        ``learning_rate=None`` into the identity, not into -1, so
        u = +√(e_x + eps) / √(e_g + eps) · g: the JAX package's AdaDelta
        steps along the gradient, and the port keeps that."""
        return chain(add_decayed_weights(0.0),
                     scale_by_adadelta(float(self.rho), float(self.epsilon)),
                     scale_by_learning_rate(None))


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


def _l2(g: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(g * g))


def _per_leaf(fn) -> GradientTransformation:
    return GradientTransformation(
        lambda params: {},
        lambda grads, state, params=None: (tree_map(fn, grads), state))


@register_serializable
@dataclasses.dataclass(frozen=True)
class GradientNormalizationConfig:
    """Gradient normalization/clipping, analog of the reference's
    ``GradientNormalization`` enum (nn/conf/GradientNormalization.java)."""
    kind: str = "none"  # none|renormalize_l2|clip_value|clip_l2_per_layer|clip_l2_global
    threshold: float = 1.0

    def to_transform(self) -> Optional[GradientTransformation]:
        """None for ``none``; otherwise a stateless transform chained
        before the updater, as the JAX package's:

        - ``clip_value``: ``optax.clip``, each element clamped to
          ±threshold;
        - ``clip_l2_global``: ``optax.clip_by_global_norm``, every leaf
          scaled by threshold / ‖g‖ (the norm over all leaves) when
          ‖g‖ ≥ threshold, else left as it is;
        - ``renormalize_l2``: each leaf (each parameter array) divided by
          max(its L2 norm, 1e-8);
        - ``clip_l2_per_layer``: each leaf scaled by
          min(1, threshold / max(its L2 norm, 1e-8))."""
        thr = float(self.threshold)
        if self.kind == "none":
            return None
        if self.kind == "clip_value":
            return _per_leaf(lambda g: torch.clamp(g, -thr, thr))
        if self.kind == "renormalize_l2":
            return _per_leaf(lambda g: g / torch.clamp(_l2(g), min=1e-8))
        if self.kind == "clip_l2_per_layer":
            return _per_leaf(lambda g: g * torch.clamp(
                thr / torch.clamp(_l2(g), min=1e-8), max=1.0))
        if self.kind == "clip_l2_global":
            def update(grads, state, params=None):
                leaves = tree_leaves(grads)
                norm = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
                keep = norm < thr
                return tree_map(lambda g: torch.where(
                    keep, g, (g / norm.to(g.dtype)) * thr), grads), state
            return GradientTransformation(lambda params: {}, update)
        raise ValueError(f"unknown gradient normalization kind: {self.kind}")
