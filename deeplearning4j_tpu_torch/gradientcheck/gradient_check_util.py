"""Finite-difference gradient checking.

The port of the JAX package's ``gradientcheck/gradient_check_util.py``
(reference: ``GradientCheckUtil``, deeplearning4j-nn/.../gradientcheck/
GradientCheckUtil.java:54, checkGradients:109: (C(w+ε) − C(w−ε)) / 2ε per
parameter with relative-error thresholds, in double precision). The
parameters are cast to float64 and ``torch.autograd``'s gradient is held
against central differences on a subsample of each leaf's entries. The
leaves are visited in the JAX package's order (dict keys sorted at every
level) and each leaf's subsample is drawn from the same
``np.random.default_rng(seed)`` stream, so both packages check the same
entries.

The hand-written kernels take float32 and bfloat16 only: a float64 model
whose layers launch one (an LSTM, attention, a fused block) raises on
the card, as a kernel wrapper must, and is checked on the CPU, where the
wrappers run their plain versions.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch


def _sorted_leaves(tree, prefix=()) -> List[Tuple[tuple, torch.Tensor]]:
    """(path, leaf) of nested dicts, keys sorted at every level (the JAX
    package's pytree order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_sorted_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _rebuild(tree, replace: dict, prefix=()):
    """``tree`` with the leaves at the paths of ``replace`` swapped."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, replace, prefix + (k,))
                for k, v in tree.items()}
    return replace.get(prefix, tree)


def _as_f64(t):
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.detach().to(torch.float64)
    return t


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def check_gradients(
    loss_fn: Callable,
    params,
    epsilon: float = 1e-6,
    max_rel_error: float = 1e-5,
    min_abs_error: float = 1e-8,
    max_params_per_leaf: int = 16,
    seed: int = 0,
    verbose: bool = True,
) -> bool:
    """Compare analytic against numeric gradients.

    ``loss_fn(params) -> scalar tensor``. Subsamples up to
    ``max_params_per_leaf`` scalar entries per leaf (the reference checks
    every parameter)."""
    params64 = _map(_as_f64, params)
    leaves = _sorted_leaves(params64)
    floating = [(p, t) for p, t in leaves
                if isinstance(t, torch.Tensor) and t.is_floating_point()]
    grad_in = {p: t.clone().requires_grad_(True) for p, t in floating}
    with torch.enable_grad():
        loss = loss_fn(_rebuild(params64, grad_in)).to(torch.float64)
        grads = torch.autograd.grad(loss, list(grad_in.values()),
                                    allow_unused=True)
    analytic = {p: (torch.zeros_like(grad_in[p]) if g is None else g)
                for p, g in zip(grad_in, grads)}

    rng = np.random.default_rng(seed)
    total_checked = 0
    max_err = 0.0
    failures = []
    for li, (path, leaf) in enumerate(leaves):
        if path not in analytic:
            continue
        n = leaf.numel()
        idxs = (np.arange(n) if n <= max_params_per_leaf
                else rng.choice(n, max_params_per_leaf, replace=False))
        g_np = analytic[path].detach().cpu().numpy().reshape(-1)
        leaf_np = leaf.cpu().numpy().reshape(-1)
        for idx in idxs:
            orig = float(leaf_np[idx])

            def loss_at(v):
                mod = leaf.clone()
                mod.view(-1)[int(idx)] = v
                with torch.no_grad():
                    return float(loss_fn(_rebuild(params64, {path: mod})))

            numeric = (loss_at(orig + epsilon) - loss_at(orig - epsilon)) \
                / (2 * epsilon)
            an = float(g_np[idx])
            abs_err = abs(an - numeric)
            denom = max(abs(an), abs(numeric))
            rel_err = abs_err / denom if denom > 0 else 0.0
            total_checked += 1
            max_err = max(max_err,
                          rel_err if abs_err > min_abs_error else 0.0)
            if rel_err > max_rel_error and abs_err > min_abs_error:
                failures.append((li, int(idx), an, numeric, rel_err))

    if verbose and failures:
        for li, idx, an, nu, re in failures[:10]:
            print(f"  leaf {li} [{idx}]: analytic={an:.8g} "
                  f"numeric={nu:.8g} rel_err={re:.3g}")
    if verbose:
        print(f"gradient check: {total_checked} params checked, "
              f"{len(failures)} failures, max rel err {max_err:.3g}")
    return len(failures) == 0


def check_model_gradients(model, dataset, **kwargs) -> bool:
    """Checks d(loss)/d(params) of a built model on one minibatch, in
    float64 on the model's device (the shape the reference's gradient
    check suites use)."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    if model.params is None:
        model.init()
    dev = model.device

    def f64(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.float64), device=dev)

    features, labels = f64(dataset.features), f64(dataset.labels)
    fmask, lmask = f64(dataset.features_mask), f64(dataset.labels_mask)
    state = _map(_as_f64, model.model_state)

    if isinstance(model, MultiLayerNetwork):
        def loss_fn(p):
            loss, _ = model._loss(p, state, features, labels, fmask, lmask,
                                  None, 0)
            return loss
    else:
        def loss_fn(p):
            loss, _ = model._loss(p, state, (features,), (labels,),
                                  (fmask,) if fmask is not None else None,
                                  (lmask,) if lmask is not None else None,
                                  None, 0)
            return loss

    return check_gradients(loss_fn, model.params, **kwargs)
