"""Training core: optimizer assembly and the train steps.

The port of the JAX package's ``optimize/solver.py`` (reference:
Solver/ConvexOptimizer, deeplearning4j-nn/.../optimize/Solver.java:43).
A step is forward, ``torch.autograd`` backward, gradient transform and
parameter update over dicts of tensors; PyTorch runs eagerly, so there
is no jit and no buffer donation: each step returns a new ``TrainState``
(the old one's tensors are freed when nothing holds them).

Per-layer updater overrides and frozen layers group the top-level
parameter keys like ``optax.multi_transform``, with the same state paths
(``.inner_states/<label>/.inner_state/...``), the analog of the
reference's UpdaterBlock grouping (nn/updater/UpdaterBlock.java:25).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.optimize.updaters import (
    GradientNormalizationConfig,
    GradientTransformation,
    NoOp,
    Tree,
    Updater,
    chain,
    tree_leaves,
    tree_map,
)


class TrainState(NamedTuple):
    """What a step carries: parameters (f32 masters), non-trainable layer
    state (BN running statistics), optimizer state, and the iteration
    count (a host int: reading it never waits on the card)."""
    params: Any
    model_state: Any
    opt_state: Any
    iteration: int


def multi_transform(groups: Dict[str, GradientTransformation],
                    labels: Dict[str, str]) -> GradientTransformation:
    """Each label's transform over the layers (top-level keys) carrying
    it, as ``optax.multi_transform``."""
    def part(tree, g):
        return {ln: v for ln, v in tree.items() if labels.get(ln) == g}

    def init(params):
        return {".inner_states": {
            g: {".inner_state": tx.init(part(params, g))}
            for g, tx in groups.items()}}

    def update(grads, state, params=None):
        updates, inner = {}, {}
        for g, tx in groups.items():
            u, s = tx.update(part(grads, g),
                             state[".inner_states"][g][".inner_state"],
                             None if params is None else part(params, g))
            updates.update(u)
            inner[g] = {".inner_state": s}
        return {ln: updates[ln] for ln in grads}, {".inner_states": inner}
    return GradientTransformation(init, update)


def build_optimizer(
    layer_names: Tuple[str, ...],
    layer_updaters: Dict[str, Optional[Updater]],
    frozen: Dict[str, bool],
    global_updater: Updater,
    grad_norm: Optional[GradientNormalizationConfig] = None,
) -> GradientTransformation:
    """The gradient transformation of a model: layers with
    ``updater=None`` use the global updater; frozen layers get NoOp
    (reference: FrozenLayer wraps the layer with a NoOp updater); a
    gradient normalization (any kind) is chained before it."""
    clip = None if grad_norm is None else grad_norm.to_transform()
    groups = {"__global__": global_updater.to_transform()}
    labels: Dict[str, str] = {}
    for name in layer_names:
        if frozen.get(name, False):
            groups.setdefault("__frozen__", NoOp().to_transform())
            labels[name] = "__frozen__"
        elif layer_updaters.get(name) is not None:
            groups[name] = layer_updaters[name].to_transform()
            labels[name] = name
        else:
            labels[name] = "__global__"
    if set(labels.values()) <= {"__global__"}:
        tx = groups["__global__"]
    else:
        tx = multi_transform(groups, labels)
    # the normalization runs before the updater, as optax.chain(clip, tx)
    return tx if clip is None else chain(clip, tx)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``optax.apply_updates``: p + u, kept in p's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


LossFn = Callable[..., Tuple[torch.Tensor, Any]]


def value_and_grad(loss_fn: LossFn, ts: TrainState, features, labels,
                   fmask=None, lmask=None, generator=None):
    """(loss, new model state, grads) of ``loss_fn`` at ``ts.params``;
    a parameter the loss does not reach gets a zero gradient."""
    work = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), ts.params)
    loss, new_ms = loss_fn(work, ts.model_state, features, labels, fmask,
                           lmask, generator, ts.iteration)
    leaves = [p for p in tree_leaves(work) if p.requires_grad]
    grads = torch.autograd.grad(loss, leaves,
                                allow_unused=True) if leaves else ()
    found = {id(p): g for p, g in zip(leaves, grads) if g is not None}
    gtree = tree_map(lambda w, p: found[id(w)] if id(w) in found
                     else torch.zeros_like(p), work, ts.params)
    return loss.detach(), new_ms, gtree


def make_train_step(loss_fn: LossFn, tx: GradientTransformation):
    """``loss_fn(params, model_state, features, labels, fmask, lmask,
    generator, iteration) -> (loss, new_model_state)``.

    Returns ``step(train_state, features, labels, fmask, lmask,
    generator) -> (new_train_state, loss)``; the loss stays on the
    device (no host sync)."""
    def step(ts: TrainState, features, labels, fmask=None, lmask=None,
             generator=None):
        loss, new_ms, grads = value_and_grad(loss_fn, ts, features, labels,
                                             fmask, lmask, generator)
        with torch.no_grad():
            updates, new_opt = tx.update(grads, ts.opt_state, ts.params)
            new_params = apply_updates(ts.params, updates)
        return TrainState(new_params, new_ms, new_opt,
                          ts.iteration + 1), loss
    return step


def _at(batch, i):
    if batch is None:
        return None
    if isinstance(batch, (tuple, list)):
        return tuple(None if b is None else b[i] for b in batch)
    return batch[i]


def make_scan_train_step(loss_fn: LossFn, tx: GradientTransformation):
    """K optimizer steps in one call over pre-staged (K, B, ...) device
    tensors (features/labels, or tuples of them, and masks or None).

    Returns ``steps(train_state, features, labels, fmask, lmask,
    generator) -> (new_train_state, losses)``: the K per-step losses as
    one device tensor, with no host sync inside the call; the iteration
    count advances by K."""
    step = make_train_step(loss_fn, tx)

    def steps(ts: TrainState, features, labels, fmask=None, lmask=None,
              generator=None):
        first = features[0] if isinstance(features, (tuple, list)) \
            else features
        losses = []
        for i in range(first.shape[0]):
            ts, loss = step(ts, _at(features, i), _at(labels, i),
                            _at(fmask, i), _at(lmask, i), generator)
            losses.append(loss)
        return ts, torch.stack(losses)
    return steps
