"""The port's model zoo against the JAX package's, on the CPU.

For each zoo entry: the port's configuration is the JAX one's, JSON for
JSON; the full-size parameter count (found from shapes: the JAX layers
under ``jax.eval_shape``, the port's on the ``meta`` device, no weights
allocated) is the same; and at a small input each model, built in both
packages from one ``configuration.json`` with the JAX weights carried by
``params_from_jax`` (BN running statistics and affine parameters made
with numpy so the random network keeps O(1) activations; dropout set to
0 in both), gives the same output and loss, the same gradients, and the
same parameters after one step of its own updater. ResNet50 is held
unfused and fused with ``fused_impl="xla"``, with both stems.

Bounds, float32:

* output within 1e-5 of its largest magnitude, loss within 1e-5 relative;
* gradients: each parameter's within 1e-4 relative L2, or within 1e-4 of
  1e-3 of the norm of all gradients where its own is smaller than that
  (a conv bias under a BatchNormalization has a gradient that is zero in
  exact arithmetic and rounding noise in both packages);
* one step: under Nesterovs, every parameter within 1e-4 of its array's
  largest magnitude (a deep BN stack: each parameter's step within the
  gradient bound below, relative L2); under Adam, whose first step moves
  each parameter by lr·g/(|g| + eps), i.e. ±lr for any gradient above
  eps, a gradient that the two summation orders put on either side of
  zero moves by ±lr in opposite directions, so: the step within 1e-3·lr
  wherever the JAX gradient is above both the gradient bound (at least
  1e-3) times its array's largest and 1e-6 of the norm of all gradients,
  and within 2·lr everywhere.

The deep BN stacks are wider, for the reason tests/test_torch_train.py
gives: in a train step a random-init BN network amplifies f32
summation-order differences, most where a BN normalizes a 1×1 plane over
a small batch (Darknet19's last stage takes a 7e-6 difference to 1.5e-4
in one BN). ResNet50 (either form, batch 8): loss 1e-4 relative,
gradients 10% relative L2; the other BN stacks (Darknet19, TinyYOLO,
YOLO2, InceptionResNetV1, FaceNetNN4Small2): loss 1e-4, gradients 3e-2
(the measured worst cases are listed at ``WIDE``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.zoo.models as JZ
import deeplearning4j_tpu_torch.zoo.models as TZ
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JGraph
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (
    _ensure_registry, opt_state_from_jax, params_from_jax)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph.config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.optimize import solver
from deeplearning4j_tpu_torch.optimize.updaters import Adam

# one intra-op thread a test process: the suite runs its workers side
# by side on the machine's cores, and a torch thread pool per worker
# oversubscribes them (small ops then wait on spinning threads)
torch.set_num_threads(1)

_ensure_registry()

OUT_TOL, LOSS_REL, GRAD_REL, PARAM_REL = 1e-5, 1e-5, 1e-4, 1e-4
GRAD_FLOOR = 1e-3

RESNET = [dict(), dict(s2d_stem=True), dict(fused_blocks=True,
                                            fused_impl="xla"),
          dict(fused_blocks=True, fused_impl="xla", s2d_stem=True)]
# (zoo class, the smallest input it accepts as (height, width), classes,
# batch): a size at which every spatial stage keeps at least one pixel
SMALL = {
    "VGG16": ((32, 32), 10, 4), "VGG19": ((32, 32), 10, 4),
    "AlexNet": ((67, 67), 10, 4), "Darknet19": ((32, 32), 10, 4),
    "TinyYOLO": ((32, 32), 4, 4), "YOLO2": ((64, 64), 4, 4),
    "GoogLeNet": ((32, 32), 7, 4), "InceptionResNetV1": ((32, 32), 9, 4),
    "FaceNetNN4Small2": ((32, 32), 11, 4),
}
RESNET_SMALL = ((32, 32), 10, 8)
# (loss rel, gradient rel L2) of the deep BN stacks; measured on a CPU
# (worst gradient): ResNet50 1.5-6.4%, FaceNetNN4Small2 6.3e-3, Darknet19
# 5.1e-4, InceptionResNetV1 1.8e-4, YOLO2 9.8e-5, TinyYOLO 5.2e-5; the
# train-mode loss up to 1.7e-5
WIDE = {"ResNet50": (1e-4, 1e-1), "Darknet19": (1e-4, 3e-2),
        "TinyYOLO": (1e-4, 3e-2), "YOLO2": (1e-4, 3e-2),
        "InceptionResNetV1": (1e-4, 3e-2),
        "FaceNetNN4Small2": (1e-4, 3e-2)}


# the four graph models' parity cases run from tests/test_torch_zoo_graphs.py
# (each compiles a JAX gradient of some hundred layers), so the two files
# share the test workers
GRAPHS = ("YOLO2", "GoogLeNet", "InceptionResNetV1", "FaceNetNN4Small2")


def _zoo_cases():
    cases = [("ResNet50", kw) for kw in RESNET]
    return cases + [(name, {}) for name in SMALL]


def _ids(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


def _no_dropout(layer):
    if layer is None or layer.dropout in (0, 0.0):
        return layer
    return dataclasses.replace(layer, dropout=0.0)


def _jax_conf(name, kw, small=True):
    """The JAX zoo configuration (small input unless ``small`` is False),
    dropout off."""
    if small:
        (h, w), classes, _ = RESNET_SMALL if name == "ResNet50" \
            else SMALL[name]
        kw = dict(kw, height=h, width=w, num_classes=classes)
    conf = getattr(JZ, name)(**kw).conf()
    if hasattr(conf, "layers"):
        conf.layers = tuple(_no_dropout(l) for l in conf.layers)
    else:
        conf.nodes = tuple(dataclasses.replace(n, layer=_no_dropout(n.layer))
                           for n in conf.nodes)
    return conf


@pytest.mark.parametrize("case", _zoo_cases(), ids=_ids)
def test_configuration_is_the_jax_one(case):
    """The port's zoo builds the JAX zoo's configuration.json, and each
    package reads the other's."""
    name, kw = case
    js = getattr(JZ, name)(**kw).conf().to_json()
    tconf = getattr(TZ, name)(**kw).conf()
    assert tconf.to_json() == js
    cls = (ComputationGraphConfiguration if isinstance(
        tconf, ComputationGraphConfiguration) else MultiLayerConfiguration)
    assert cls.from_json(js).to_json() == js
    assert type(tconf) is cls
    jcls = type(getattr(JZ, name)(**kw).conf())
    assert jcls.from_json(tconf.to_json()).to_json() == js


def _jax_param_count(conf) -> int:
    key = jax.random.PRNGKey(0)
    if hasattr(conf, "layers"):
        pairs = zip(conf.layers, conf.layer_input_types())
    else:
        pairs = ((n.layer, conf.layer_input_type(n.name))
                 for n in conf.nodes if n.layer is not None)
    total = 0
    for layer, it in pairs:
        if layer.has_params:
            shapes = jax.eval_shape(lambda k: layer.initialize(k, it), key)
            total += sum(int(np.prod(s.shape))
                         for s in jax.tree_util.tree_leaves(shapes))
    return total


def _port_param_count(conf) -> int:
    if isinstance(conf, MultiLayerConfiguration):
        pairs = zip(conf.layers, conf.layer_input_types())
    else:
        pairs = ((n.layer, conf.layer_input_type(n.name))
                 for n in conf.nodes if n.layer is not None)
    total = 0
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        for layer, it in pairs:
            if layer.has_params:
                total += sum(t.numel() for t in
                             layer.initialize(gen, it).values())
    return total


@pytest.mark.parametrize("case", _zoo_cases(), ids=_ids)
def test_full_size_parameter_count(case):
    name, kw = case
    want = _jax_param_count(getattr(JZ, name)(**kw).conf())
    assert _port_param_count(getattr(TZ, name)(**kw).conf()) == want
    assert want > 1_000_000


def test_known_parameter_counts():
    """Published totals at 1000 classes: VGG16 138,357,544 and ResNet50
    (no conv biases) 25,557,032, the fused form the same; the
    space-to-depth stem's 4×4×12 kernel holds 2,880 more (the folded 7×7's
    zero taps)."""
    count = lambda m: _port_param_count(m.conf())
    assert count(TZ.VGG16(num_classes=1000)) == 138_357_544
    for kw in RESNET:
        extra = 64 * (4 * 4 * 12 - 7 * 7 * 3) if kw.get("s2d_stem") else 0
        assert count(TZ.ResNet50(num_classes=1000, **kw)) == \
            25_557_032 + extra


def _nontrivial(params, state, rng):
    """BN running statistics and affine params from numpy; the residual
    branches' last BN (and a fused block's bn3/bnds) gets a small gamma."""
    small = ("_c_bn", "_ds_bn", "_up_bn")
    for st in state.values():
        for k, v in st.items():
            if k.endswith("mean"):
                st[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k.endswith("var"):
                st[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    for ln, lp in params.items():
        for k, v in lp.items():
            if k.endswith("gamma"):
                lo, hi = ((0.2, 0.4) if ln.endswith(small)
                          or k in ("bn3_gamma", "bnds_gamma") else (0.8, 1.2))
                lp[k] = rng.uniform(lo, hi, v.shape).astype(np.float32)
            elif k.endswith("beta"):
                lp[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)


def _labels(zoo_layer, out_shape, rng):
    """One-hot classes, or YOLO labels: boxes in grid units with a
    one-hot class in every cell but one (an empty cell)."""
    if len(out_shape) == 2:
        return np.eye(out_shape[1], dtype=np.float32)[
            rng.integers(0, out_shape[1], out_shape[0])]
    n, h, w, d = out_shape
    c = d // len(zoo_layer.boxes) - 5
    y = np.zeros((n, h, w, 4 + c), np.float32)
    y[..., 0] = rng.uniform(0, w, (n, h, w))
    y[..., 1] = rng.uniform(0, h, (n, h, w))
    y[..., 2:4] = rng.uniform(0.5, 3.0, (n, h, w, 2))
    y[..., 4:] = np.eye(c, dtype=np.float32)[rng.integers(0, c, (n, h, w))]
    y[0, 0, 0, 4:] = 0.0
    return y


def _pair(name, kw, seed=0):
    jconf = _jax_conf(name, kw)
    graph = not hasattr(jconf, "layers")
    tconf = (ComputationGraphConfiguration if graph
             else MultiLayerConfiguration).from_json(jconf.to_json())
    jm = (JGraph if graph else JMLN)(jconf).init()
    tm = (ComputationGraph if graph else MultiLayerNetwork)(
        tconf, device="cpu").init()
    rng = np.random.default_rng(seed)
    ts = jax.tree_util.tree_map(np.asarray, jm.train_state)
    p, s = ts.params, ts.model_state
    _nontrivial(p, s, rng)
    jm.train_state = jm.train_state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, p),
        model_state=jax.tree_util.tree_map(jnp.asarray, s))
    params_from_jax(p, s, "cpu", model=tm)
    opt_state_from_jax(ts.opt_state, tm)
    (h, w), _, n = RESNET_SMALL if name == "ResNet50" else SMALL[name]
    x = rng.normal(0, 1, (n, h, w, 3)).astype(np.float32)
    return jm, tm, p, x, rng, graph


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach().float().numpy()
                                         if isinstance(v, torch.Tensor)
                                         else v, np.float64)
    return out


def _check_grads(gt, gj, rel):
    gt, gj = _flat(gt), _flat(gj)
    total = np.sqrt(sum(float((v * v).sum()) for v in gj.values()))
    worst = (0.0, None)
    for k, want in gj.items():
        err = np.linalg.norm(gt[k] - want)
        scale = max(np.linalg.norm(want), GRAD_FLOOR * total)
        worst = max(worst, (err / scale, k))
    assert worst[0] <= rel, f"gradient {worst[1]}: {worst[0]:.3g} > {rel}"
    return total


# the cases of the other zoo models are spread over test_torch_zoo_*.py
# (one file each for the two ResNet50 stems, the fused "xla" ResNet50s and
# VGG16/VGG19/AlexNet/Darknet19), so that test workers run them side by
# side
ZOO_HERE = ("TinyYOLO",)


@pytest.mark.parametrize("case", [c for c in _zoo_cases()
                                  if c[0] in ZOO_HERE], ids=_ids)
def test_zoo_model_matches_jax(case):
    check_zoo_model(case)


def check_zoo_model(case):
    """Output, loss, gradients and one step of the zoo model of ``case``
    against the JAX package's (the bounds in the module docstring)."""
    name, kw = case
    loss_rel, grad_rel = WIDE.get(name, (LOSS_REL, GRAD_REL))
    jm, tm, p0, x, rng, graph = _pair(name, kw)
    jo = np.asarray(jm.output(x))
    to = tm.output(x).numpy()
    assert to.shape == jo.shape
    out_err = np.abs(to - jo).max() / np.abs(jo).max()
    assert out_err <= OUT_TOL, f"output {out_err:.3g}"
    out_layer = (tm.conf.node(tm.conf.network_outputs[0]).layer if graph
                 else tm.conf.layers[-1])
    y = _labels(out_layer, jo.shape, rng)

    # the JAX step, taken apart: gradients of the training loss at the
    # shared weights (one compiled call), then its optimizer's update
    import optax
    feats, labs = ((jnp.asarray(x),), (jnp.asarray(y),)) if graph else \
        (jnp.asarray(x), jnp.asarray(y))
    jts = jm.train_state
    grad_fn = jax.jit(jax.value_and_grad(
        lambda pp, ms: jm._loss(pp, ms, feats, labs, None, None, None, 0),
        has_aux=True))
    (lj, _), gj = grad_fn(jts.params, jts.model_state)
    lt, _, gt = solver.value_and_grad(tm._loss, tm.train_state, *(
        ((torch.from_numpy(x),), (torch.from_numpy(y),)) if graph
        else (torch.from_numpy(x), torch.from_numpy(y))))
    assert lt.item() == pytest.approx(float(lj), rel=loss_rel)
    # the update as one compiled call: eagerly, optax dispatches (and
    # compiles) each of its ops for every leaf, slower than the gradient
    step = jax.jit(lambda g, o, p: optax.apply_updates(
        p, jm._tx.update(g, o, p)[0]))
    pj = _flat(jax.tree_util.tree_map(
        np.asarray, step(gj, jts.opt_state, jts.params)))
    gj = jax.tree_util.tree_map(np.asarray, gj)
    total = _check_grads(gt, gj, grad_rel)

    # one step of the port's fit with the model's own updater
    tm.fit(DataSet(x, y))
    pt, p0, gflat = _flat(tm.params), _flat(p0), _flat(gj)
    updater = tm.conf.global_config.updater
    if name in WIDE and not isinstance(updater, Adam):
        for k, want in pj.items():
            d_j, d_t = want - p0[k], pt[k] - p0[k]
            err = np.linalg.norm(d_t - d_j) / max(np.linalg.norm(d_j),
                                                  1e-30)
            assert err <= grad_rel, f"step {k}: {err:.3g}"
    elif isinstance(updater, Adam):
        lr = updater.learning_rate
        for k, want in pj.items():
            d = np.abs((pt[k] - p0[k]) - (want - p0[k]))
            g = np.abs(gflat[k])
            sure = g > max(max(1e-3, grad_rel) * g.max(), 1e-6 * total)
            assert d.max() <= 2 * lr * (1 + 1e-3), k
            assert (d[sure] <= 1e-3 * lr).all(), \
                f"step {k}: {d[sure].max():.3g}"
    else:
        for k, want in pj.items():
            err = np.abs(pt[k] - want).max() / max(np.abs(want).max(),
                                                   1e-6)
            assert err <= PARAM_REL, f"step {k}: {err:.3g}"


@pytest.mark.parametrize("name,kw,graph", [
    ("ResNet50", dict(num_classes=5, height=32, width=32), True),
    ("TinyYOLO", dict(num_classes=3, height=32, width=32), False),
])
def test_zoo_zip_round_trips_both_ways(tmp_path, name, kw, graph):
    """A zoo model saved by either package restores in the other with the
    same output."""
    from deeplearning4j_tpu.models import serialization as jser
    from deeplearning4j_tpu_torch.models.serialization import (
        restore_model, save_model)
    jm = getattr(JZ, name)(**kw).init()
    x = np.random.default_rng(0).normal(
        0, 1, (2, kw["height"], kw["width"], 3)).astype(np.float32)
    jser.save_model(jm, str(tmp_path / "j.zip"))
    tm = restore_model(str(tmp_path / "j.zip"), device="cpu")
    np.testing.assert_allclose(tm.output(x).numpy(), np.asarray(
        jm.output(x)), rtol=1e-5, atol=1e-6)
    save_model(tm, str(tmp_path / "t.zip"))
    back = (jser.restore_computation_graph if graph
            else jser.restore_multi_layer_network)(str(tmp_path / "t.zip"))
    np.testing.assert_array_equal(np.asarray(back.output(x)),
                                  np.asarray(jm.output(x)))


def test_fused_xla_and_unfused_resnet50_default_to_cuda():
    """``ResNet50()`` (the unfused default) and the ``"xla"`` fused form
    build their configurations anywhere; ``init()`` wants the card unless
    the CPU is asked for."""
    for zoo in (TZ.ResNet50(height=32, width=32),
                TZ.ResNet50(height=32, width=32, fused_blocks=True,
                            fused_impl="xla")):
        zoo.conf()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                zoo.init()
        assert zoo.init(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("s2d", [False, True])
def test_unfused_resnet50_computes_the_fused_blocks_function(s2d):
    """``unfuse_resnet50_params`` carries a fused-block ResNet50's weights
    to the per-layer graph: the same probabilities (inference) and the
    same train-mode loss, against both fused implementations, f32."""
    cfg = dict(num_classes=6, height=32, width=32, s2d_stem=s2d)
    fused = {impl: TZ.ResNet50(fused_blocks=True, fused_impl=impl,
                               **cfg).init(device="cpu")
             for impl in ("xla", "pallas")}
    layer = TZ.ResNet50(**cfg).init(device="cpu")
    rng = np.random.default_rng(0)
    p = {k: {n: v.numpy() for n, v in lp.items()}
         for k, lp in fused["xla"].params.items()}
    s = {k: {n: v.numpy() for n, v in st.items()}
         for k, st in fused["xla"].model_state.items()}
    _nontrivial(p, s, rng)
    for m in fused.values():
        params_from_jax(p, s, "cpu", model=m)
    up, us = TZ.unfuse_resnet50_params(p, s)
    params_from_jax({k: up.get(k, {}) for k in layer.params},
                    {k: us.get(k, {}) for k in layer.model_state}, "cpu",
                    model=layer)
    x = rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 8)]
    want = layer.output(x)
    for m in fused.values():
        torch.testing.assert_close(m.output(x), want, rtol=1e-5, atol=1e-6)
        # the train-mode loss: the deep BN stack's bound (WIDE)
        assert m.score(DataSet(x, y)) == pytest.approx(
            layer.score(DataSet(x, y)), rel=WIDE["ResNet50"][0])
