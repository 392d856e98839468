"""The port's updaters, optimizer assembly, train steps and losses against
the JAX package's (optax) on the same numpy inputs.

Tolerances: updaters, schedules and gradient normalizations relative
1e-6 (the same f32 operations in the same order; the bound allows for a
fused multiply-add on either side and for the norms' sums taken in
another order); the K-step call against K single steps rtol 1e-6 (the
same kernels in the same order on the CPU); losses and their gradients
rtol 1e-6 / atol 1e-7 (MAPE, whose per-feature terms reach 1e4, relative
to its largest gradient).
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
from deeplearning4j_tpu.optimize import schedules as jsched
from deeplearning4j_tpu.optimize import solver as jsolver
from deeplearning4j_tpu.optimize import updaters as jup
from deeplearning4j_tpu_torch.models.serialization import flatten_paths
from deeplearning4j_tpu_torch.ops import losses as tlosses
from deeplearning4j_tpu_torch.optimize import schedules as tsched
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


# a schedule in a parametrisation: (class name, fields), built in each
# package by _make
SCHEDULES = {
    "fixed": ("FixedSchedule", dict(value=0.02)),
    "exp": ("ExponentialSchedule", dict(initial_value=0.02, gamma=0.7)),
    "inv": ("InverseSchedule", dict(initial_value=0.02, gamma=0.5,
                                    power=1.5)),
    "poly": ("PolySchedule", dict(initial_value=0.02, power=2.0,
                                  max_iter=4)),
    "sigmoid": ("SigmoidSchedule", dict(initial_value=0.02, gamma=1.5,
                                        step_size=1)),
    "step": ("StepSchedule", dict(initial_value=0.02, decay_rate=0.5,
                                  step_size=2)),
    "warmup_cos": ("WarmupCosineSchedule", dict(peak_value=0.02,
                                                warmup_iters=1,
                                                total_iters=3)),
}


def _make(updaters, schedules, name, kw):
    kw = dict(kw)
    lr = kw.get("learning_rate")
    if isinstance(lr, str):
        cls, fields = SCHEDULES[lr]
        kw["learning_rate"] = getattr(schedules, cls)(**fields)
    return getattr(updaters, name)(**kw)


def _optax_vs_port(name, kw, seed=0, grad_scale=1.0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(3)]
    want = _run_optax(_make(jup, jsched, name, kw).to_optax(), params, grads)
    got = _run_port(_make(tup, tsched, name, kw).to_transform(), params,
                    grads)
    return got, want


@pytest.mark.parametrize("name,kw", [
    ("Sgd", dict(learning_rate=0.05)),
    ("Nesterovs", dict(learning_rate=1e-2, momentum=0.9)),
    ("Nesterovs", dict(learning_rate=0.3, momentum=0.5)),
    ("Adam", dict(learning_rate=2e-3)),
    ("Adam", dict(learning_rate=0.1, beta1=0.8, beta2=0.99, epsilon=1e-6)),
    ("NoOp", {}),
    ("AdamW", dict(learning_rate=1e-2, weight_decay=0.1)),
    ("AdamW", dict(learning_rate="exp", beta1=0.8, epsilon=1e-6)),
    ("AdaMax", dict(learning_rate=2e-2)),
    ("AdaMax", dict(learning_rate="inv", beta2=0.99, epsilon=1e-6)),
    ("Nadam", dict(learning_rate=1e-2)),
    ("Nadam", dict(learning_rate="poly", beta1=0.8)),
    ("AMSGrad", dict(learning_rate=1e-2)),
    ("AMSGrad", dict(learning_rate="sigmoid", beta2=0.9)),
    ("RmsProp", dict(learning_rate=1e-2)),
    ("RmsProp", dict(learning_rate="step", rms_decay=0.8, epsilon=1e-6)),
    ("AdaGrad", dict(learning_rate=0.1)),
    ("AdaGrad", dict(learning_rate="warmup_cos", epsilon=1e-8)),
    ("AdaDelta", {}),
    ("AdaDelta", dict(rho=0.8, epsilon=1e-4)),
    ("Sgd", dict(learning_rate="fixed")),
    ("Nesterovs", dict(learning_rate="step", momentum=0.9)),
    ("Adam", dict(learning_rate="warmup_cos"))])
def test_updater_matches_optax_over_three_steps(name, kw):
    (got_p, got_s), (want_p, want_s) = _optax_vs_port(name, kw)
    _assert_close(got_p, want_p)
    _assert_same_state(got_s, want_s)


@pytest.mark.parametrize("key", sorted(SCHEDULES))
def test_schedule_values_match_jax(key):
    """value_at over counts 0-9, as the int32 count an updater keeps."""
    cls, fields = SCHEDULES[key]
    want = getattr(jsched, cls)(**fields)
    got = getattr(tsched, cls)(**fields)
    for c in range(10):
        w = np.asarray(want.value_at(jnp.asarray(c, jnp.int32)))
        g = got.value_at(torch.tensor(c, dtype=torch.int32))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-9)


def test_unported_updaters_and_clipping_raise():
    """The updaters and normalizations that raised before they were
    ported now match optax (AdamW, and clip_l2_global before Sgd); an
    unknown normalization kind and the abstract base still raise."""
    (got_p, got_s), (want_p, want_s) = _optax_vs_port(
        "AdamW", dict(learning_rate=1e-2))
    _assert_close(got_p, want_p)
    _assert_same_state(got_s, want_s)
    rng = np.random.default_rng(5)
    params = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(3)]
    gn = ("clip_l2_global", 1.0)
    want_p, _ = _run_optax(jsolver.build_optimizer(
        ("a",), {}, {}, jup.Sgd(0.1), jup.GradientNormalizationConfig(*gn)),
        params, grads)
    got_p, _ = _run_port(tsolver.build_optimizer(
        ("a",), {}, {}, tup.Sgd(0.1), tup.GradientNormalizationConfig(*gn)),
        params, grads)
    _assert_close(got_p, want_p)
    with pytest.raises(ValueError, match="unknown gradient normalization"):
        tup.GradientNormalizationConfig("clip_l3", 1.0).to_transform()
    with pytest.raises(NotImplementedError):
        tup.Updater().to_transform()


@pytest.mark.parametrize("kind,threshold", [
    ("clip_value", 0.5), ("clip_value", 5.0),
    ("clip_l2_global", 2.0), ("clip_l2_global", 1e3),
    ("clip_l2_per_layer", 1.0), ("clip_l2_per_layer", 1e3),
    ("renormalize_l2", 1.0)], ids=[
    "0.5", "5.0", "clip_l2_global-2.0", "clip_l2_global-1e3",
    "clip_l2_per_layer-1.0", "clip_l2_per_layer-1e3", "renormalize_l2"])
def test_clip_then_adam_matches_optax_chain(kind, threshold):
    """build_optimizer chains the normalization before the updater, as
    the JAX package's optax.chain(norm, adam) does: same parameters and
    the same state paths (#1/#0/.count, .mu, .nu) after three steps. The
    thresholds of 1e3 leave the gradients as they are."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(3)]
    names = tuple(SHAPES)
    gn = dict(kind=kind, threshold=threshold)
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


def _loss_inputs(loss, rng):
    """(labels, output) in each loss's domain: probabilities for the
    log losses, ±1 labels for the hinges, class ids for SPARSE_MCXENT,
    labels away from 0 for MAPE."""
    n, c = 6, 5
    raw = rng.normal(0, 1.5, (n, c)).astype(np.float32)
    probs = np.exp(raw) / np.exp(raw).sum(-1, keepdims=True)
    onehot = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    name = loss.name
    if name in ("MCXENT", "NEGATIVELOGLIKELIHOOD", "KL_DIVERGENCE"):
        soft = rng.dirichlet(np.ones(c), n).astype(np.float32)
        return (soft if name == "KL_DIVERGENCE" else onehot), probs
    if name == "SPARSE_MCXENT":
        return rng.integers(0, c, n).astype(np.float32), probs
    if name == "XENT":
        return (rng.uniform(size=(n, c)) > 0.5).astype(np.float32), \
            (1 / (1 + np.exp(-raw))).astype(np.float32)
    if name in ("HINGE", "SQUARED_HINGE"):
        return np.where(rng.uniform(size=(n, c)) > 0.5, 1.0,
                        -1.0).astype(np.float32), raw
    if name in ("POISSON", "MEAN_SQUARED_LOGARITHMIC_ERROR"):
        return rng.poisson(2.0, (n, c)).astype(np.float32), \
            np.exp(raw).astype(np.float32)
    if name == "MEAN_ABSOLUTE_PERCENTAGE_ERROR":
        return (np.sign(raw) * (0.5 + np.abs(raw))).astype(np.float32), \
            rng.normal(0, 1.5, (n, c)).astype(np.float32)
    return rng.normal(0, 1, (n, c)).astype(np.float32), raw


def _value_and_grad_both(jfn, tfn, labels, output, mask):
    """(port value, JAX value, port d/d output, JAX d/d output)."""
    jl = jnp.asarray(labels)
    want, jg = jax.value_and_grad(lambda o: jfn(jl, o, mask))(
        jnp.asarray(output))
    out = torch.from_numpy(output.copy()).requires_grad_(True)
    tm = None if mask is None else torch.from_numpy(mask)
    got = tfn(torch.from_numpy(labels), out, tm)
    tg, = torch.autograd.grad(got, out)
    return got.detach().numpy(), np.asarray(want), tg.numpy(), np.asarray(jg)


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    """Every loss of the enum and the fused softmax and sigmoid losses on
    logits: value and gradient with respect to the output (or logits)
    against the JAX package's, with and without an example mask."""
    rng = np.random.default_rng(4)
    mask = (np.array([1, 0, 1, 1, 0, 1], np.float32) if masked else None)
    cases = [(l.name, jlosses.LossFunction[l.name], l,
              *_loss_inputs(l, rng)) for l in tlosses.LossFunction]
    logits = rng.normal(0, 3, (6, 5)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    bits = (rng.uniform(size=(6, 5)) > 0.5).astype(np.float32)
    cases += [("stable_mcxent", jlosses.stable_mcxent_from_logits,
               tlosses.stable_mcxent_from_logits, onehot, logits),
              ("stable_xent", jlosses.stable_xent_from_logits,
               tlosses.stable_xent_from_logits, bits, logits)]
    assert len(cases) == 17
    for name, jfn, tfn, labels, output in cases:
        got, want, tg, jg = _value_and_grad_both(jfn, tfn, labels, output,
                                                 mask)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(tg, jg, rtol=1e-6,
                                   atol=1e-7 * max(1.0, np.abs(jg).max()),
                                   err_msg=name)
