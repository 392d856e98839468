"""The port's updaters, optimizer assembly, train steps and losses against
the JAX package's (optax) on the same numpy inputs.

Tolerances: updaters relative 1e-6 (the same f32 operations in the same
order; the bound allows for a fused multiply-add on either side); the
K-step call against K single steps rtol 1e-6 (the same kernels in the
same order on the CPU); losses rtol 1e-6 / atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.models.serialization import \
    _flatten_with_paths as jax_paths
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.optimize import solver as jsolver
from deeplearning4j_tpu.optimize import updaters as jup
from deeplearning4j_tpu_torch.models.serialization import flatten_paths
from deeplearning4j_tpu_torch.ops import losses as tlosses
from deeplearning4j_tpu_torch.optimize import solver as tsolver
from deeplearning4j_tpu_torch.optimize import updaters as tup

SHAPES = {"a": {"W": (3, 4), "b": (4,)}, "c": {"W": (2, 2)},
          "d": {"gamma": (5,)}}


def _tree(rng, scale=1.0):
    return {ln: {k: (scale * rng.normal(0, 1, s)).astype(np.float32)
                 for k, s in lp.items()} for ln, lp in SHAPES.items()}


def _to_torch(tree):
    return {ln: {k: torch.from_numpy(v.copy()) for k, v in lp.items()}
            for ln, lp in tree.items()}


def _run_optax(tx, params, grads_seq):
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads_seq:
        u, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, u)
    return jax.tree_util.tree_map(np.asarray, p), state


def _run_port(tx, params, grads_seq):
    p = _to_torch(params)
    state = tx.init(p)
    for g in grads_seq:
        u, state = tx.update(_to_torch(g), state, p)
        p = tsolver.apply_updates(p, u)
    return p, state


def _assert_close(got, want, rel=1e-6):
    for ln, lp in want.items():
        for k, v in lp.items():
            np.testing.assert_allclose(got[ln][k].numpy(), v, rtol=rel,
                                       atol=rel * np.abs(v).max(),
                                       err_msg=f"{ln}/{k}")


def _assert_same_state(got, want):
    g = {k: v.numpy() for k, v in flatten_paths(got).items()}
    w = {k: np.asarray(v) for k, v in jax_paths(want).items()}
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(w[k]).max(), err_msg=k)


@pytest.mark.parametrize("name,kw", [
    ("Sgd", dict(learning_rate=0.05)),
    ("Nesterovs", dict(learning_rate=1e-2, momentum=0.9)),
    ("Nesterovs", dict(learning_rate=0.3, momentum=0.5)),
    ("Adam", dict(learning_rate=2e-3)),
    ("Adam", dict(learning_rate=0.1, beta1=0.8, beta2=0.99, epsilon=1e-6)),
    ("NoOp", {})])
def test_updater_matches_optax_over_three_steps(name, kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    want_p, want_s = _run_optax(getattr(jup, name)(**kw).to_optax(), params,
                                grads)
    got_p, got_s = _run_port(getattr(tup, name)(**kw).to_transform(), params,
                             grads)
    _assert_close(got_p, want_p)
    _assert_same_state(got_s, want_s)


def test_unported_updaters_and_clipping_raise():
    with pytest.raises(NotImplementedError):
        tup.AdamW().to_transform()
    with pytest.raises(NotImplementedError):
        tsolver.build_optimizer(("a",), {}, {}, tup.Sgd(0.1),
                                tup.GradientNormalizationConfig(
                                    "clip_l2_global", 1.0))


@pytest.mark.parametrize("threshold", [0.5, 5.0])
def test_clip_then_adam_matches_optax_chain(threshold):
    """build_optimizer chains clip_value before the updater, as the JAX
    package's optax.chain(clip, adam) does: same parameters and the same
    state paths (#1/#0/.count, .mu, .nu) after three steps."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(3)]
    names = tuple(SHAPES)
    gn = dict(kind="clip_value", threshold=threshold)
    want_p, want_s = _run_optax(jsolver.build_optimizer(
        names, {}, {}, jup.Adam(2e-3), jup.GradientNormalizationConfig(**gn)),
        params, grads)
    got_p, got_s = _run_port(tsolver.build_optimizer(
        names, {}, {}, tup.Adam(2e-3), tup.GradientNormalizationConfig(**gn)),
        params, grads)
    _assert_close(got_p, want_p)
    _assert_same_state(got_s, want_s)
    assert "#1/#0/.count" in flatten_paths(got_s)


def test_build_optimizer_with_override_and_frozen_layer_matches_jax():
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    names = tuple(SHAPES)
    args = lambda m: (names, {"c": m.Sgd(0.2)}, {"d": True},
                      m.Nesterovs(0.1, 0.9))
    want_p, want_s = _run_optax(jsolver.build_optimizer(*args(jup)), params,
                                grads)
    got_p, got_s = _run_port(tsolver.build_optimizer(*args(tup)), params,
                             grads)
    _assert_close(got_p, want_p)
    _assert_same_state(got_s, want_s)
    np.testing.assert_array_equal(got_p["d"]["gamma"].numpy(),
                                  params["d"]["gamma"])       # frozen


def test_global_nesterovs_state_has_the_jax_checkpoint_paths():
    tx = tsolver.build_optimizer(("a", "c"), {}, {}, tup.Nesterovs())
    state = tx.init(_to_torch(_tree(np.random.default_rng(2))))
    assert sorted(flatten_paths(state)) == [
        "#0/.trace/a/W", "#0/.trace/a/b", "#0/.trace/c/W",
        "#0/.trace/d/gamma"]


def _toy_loss(params, model_state, features, labels, fmask, lmask, gen,
              iteration):
    x, = features
    y, = labels
    h = torch.tanh(x @ params["a"]["W"] + params["a"]["b"])
    logits = h @ params["c"]["W"].repeat(2, 1)[:4, :2]
    loss = tlosses.stable_mcxent_from_logits(y, logits)
    loss = loss + 1e-3 * params["d"]["gamma"].square().sum()
    return loss, {"d": {"count": model_state["d"]["count"] + 1}}


def test_scan_train_step_equals_k_single_steps():
    rng = np.random.default_rng(3)
    params = _to_torch(_tree(rng, 0.5))
    tx = tup.Nesterovs(0.1, 0.9).to_transform()
    ts0 = tsolver.TrainState(params, {"d": {"count": torch.zeros(())}},
                             tx.init(params), 7)
    xs = torch.from_numpy(rng.normal(0, 1, (3, 6, 3)).astype(np.float32))
    ys = torch.from_numpy(np.eye(2, dtype=np.float32)[
        rng.integers(0, 2, (3, 6))])
    step = tsolver.make_train_step(_toy_loss, tx)
    ts, losses = ts0, []
    for i in range(3):
        ts, loss = step(ts, (xs[i],), (ys[i],))
        losses.append(loss)
    scan = tsolver.make_scan_train_step(_toy_loss, tx)
    ts_k, losses_k = scan(ts0, (xs,), (ys,))
    assert ts_k.iteration == ts.iteration == 10
    assert losses_k.shape == (3,) and isinstance(losses_k, torch.Tensor)
    np.testing.assert_allclose(losses_k.numpy(), torch.stack(losses).numpy(),
                               rtol=1e-6)
    for ln, lp in ts.params.items():
        for k, v in lp.items():
            np.testing.assert_allclose(ts_k.params[ln][k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-7)
    assert ts_k.model_state["d"]["count"].item() == 3.0
    # the unused parameter got a zero gradient: only weight decay moved it
    assert not torch.equal(ts_k.params["d"]["gamma"], params["d"]["gamma"])


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (6, 5)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    mask = (rng.uniform(size=6) > 0.3).astype(np.float32) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    want = jlosses.stable_mcxent_from_logits(
        jnp.asarray(labels), jnp.asarray(logits), mask)
    got = tlosses.stable_mcxent_from_logits(
        torch.from_numpy(labels), torch.from_numpy(logits), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits)))
    want = jlosses.LossFunction.MCXENT(jnp.asarray(labels),
                                       jnp.asarray(probs), mask)
    got = tlosses.LossFunction.MCXENT(torch.from_numpy(labels),
                                      torch.from_numpy(probs), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(NotImplementedError):
        tlosses.LossFunction.MSE(torch.zeros(2, 2), torch.zeros(2, 2))
