"""The port's constraints, weight noise, weight distributions, legacy
optimizers and the model API remainder (``summary``, ``clone``,
``conf_global``), on the CPU, against the JAX package where both compute
the same numbers.

Bounds: parameters after N steps within 1e-4 of each array's largest
magnitude, losses within 1e-5 (the same f32 math in other orders). Weight
noise and the distributions draw from ``torch.Generator`` (Philox) where
the JAX package draws from threefry, so they are held to the rate-0 case
(bitwise no noise) and to their statistics, never to JAX's draws.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (
    _ensure_registry, flatten_paths, params_from_jax)
from deeplearning4j_tpu_torch.nn import constraints as C
from deeplearning4j_tpu_torch.nn import distributions as D
from deeplearning4j_tpu_torch.nn import weightnoise as W
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph.config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.optimize import legacy

_ensure_registry()

PARAM_REL, LOSS_REL = 1e-4, 1e-5


def _data(n=32, nf=5, nc=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, nf)).astype(np.float32)
    return x, np.eye(nc, dtype=np.float32)[rng.integers(0, nc, n)]


def _jax_mlp(layer_kw=None, out_kw=None, updater=None):
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JM
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.optimize.updaters import Sgd
    conf = (NeuralNetConfiguration.Builder().seed(7)
            .updater(updater or Sgd(0.5)).list()
            .layer(DenseLayer(n_out=8, activation=Activation.TANH,
                              **(layer_kw or {})))
            .layer(OutputLayer(n_out=3, **(out_kw or {})))
            .set_input_type(InputType.feed_forward(5)).build())
    return JM(conf).init()


def _port_of(jm):
    """The port model of the JAX model's configuration and weights."""
    import jax
    conf = MultiLayerConfiguration.from_json(jm.conf.to_json())
    m = MultiLayerNetwork(conf, device="cpu").init()
    m.set_params(*params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.train_state.params),
        jax.tree_util.tree_map(np.asarray, jm.train_state.model_state),
        model=m))
    return m


def _close(port_params, jax_params, skip=()):
    import jax
    jp = flatten_paths(jax.tree_util.tree_map(np.asarray, jax_params))
    for k, v in flatten_paths(port_params).items():
        if k in skip:
            continue
        want = np.asarray(jp[k])
        assert np.abs(v.numpy() - want).max() <= \
            PARAM_REL * max(np.abs(want).max(), 1e-30), k


def _jc(name, **kw):
    import deeplearning4j_tpu.nn.constraints as jc
    return getattr(jc, name)(**kw)


CONSTRAINTS = [
    ("MaxNormConstraint", dict(max_norm=0.6)),
    ("MaxNormConstraint", dict(max_norm=0.4, apply_to_bias=True)),
    ("MinMaxNormConstraint", dict(min_norm=0.5, max_norm=0.8, rate=0.7)),
    ("UnitNormConstraint", {}),
    ("NonNegativeConstraint", {}),
]


@pytest.mark.parametrize("name,kw", CONSTRAINTS)
def test_constraint_steps_match_jax(name, kw):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    c = (_jc(name, **kw),)
    jm = _jax_mlp({"constraints": c}, {"constraints": c})
    pm = _port_of(jm)
    assert type(pm.layers[0].constraints[0]).__name__ == name
    x, y = _data()
    for _ in range(3):
        jm.fit(JDS(x, y))
        pm.fit(DataSet(x, y))
    _close(pm.params, jm.train_state.params)
    if name == "NonNegativeConstraint":
        assert (pm.params["layer_0"]["W"] >= 0).all()
    if name == "UnitNormConstraint":
        norms = torch.linalg.norm(pm.params["layer_0"]["W"], dim=0)
        torch.testing.assert_close(norms, torch.ones_like(norms))


def test_constraint_projection_matches_jax_directly():
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    params = {"W": rng.normal(size=(4, 3, 6)).astype(np.float32),
              "b": rng.normal(size=(6,)).astype(np.float32),
              "centers": rng.normal(size=(2, 6)).astype(np.float32),
              "inner": {"W": rng.normal(size=(5, 2)).astype(np.float32)}}
    for name, kw in CONSTRAINTS:
        got = C.__dict__[name](**kw).apply(
            {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                 {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in params.items()})
        want = _jc(name, **kw).apply(
            {k: (jnp.asarray(v) if not isinstance(v, dict) else
                 {kk: jnp.asarray(vv) for kk, vv in v.items()})
             for k, v in params.items()})
        for k, v in flatten_paths(got).items():
            w = np.asarray(flatten_paths(want)[k])
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-6, atol=1e-6)
        assert torch.equal(got["centers"], torch.from_numpy(
            params["centers"]))


def test_constraint_on_a_graph_and_in_k_step_calls():
    """A ComputationGraph's step and the K-step call project too."""
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    mx = C.MaxNormConstraint(max_norm=0.3)
    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Sgd(1.0))
            .graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_out=8, constraints=(mx,)), "in")
            .add_layer("o", OutputLayer(n_out=3), "d").set_outputs("o")
            .set_input_types(InputType.feed_forward(5)).build())
    g = ComputationGraph(conf, device="cpu").init()
    x, y = _data()
    g.fit(DataSet(x, y))
    assert torch.linalg.norm(g.params["d"]["W"], dim=0).max() <= 0.3 + 1e-6
    k = 2
    xs = torch.from_numpy(x).expand(k, *x.shape)
    ys = torch.from_numpy(y).expand(k, *y.shape)
    g2 = ComputationGraph(conf, device="cpu").init()
    g2.train_state, losses = g2._build_scan_train_step()(
        g2.train_state, (xs,), (ys,))
    assert torch.linalg.norm(g2.params["d"]["W"], dim=0).max() <= 0.3 + 1e-6
    assert losses.shape == (k,)


@pytest.mark.parametrize("noise", [W.DropConnect(p=0.0),
                                   W.WeightNoise(D.ConstantDistribution(0.0)),
                                   W.WeightNoise(D.ConstantDistribution(1.0),
                                                 additive=False)])
def test_rate_zero_noise_is_no_noise(noise):
    """A noise that changes nothing gives bitwise the plain steps."""
    jm = _jax_mlp()
    plain = _port_of(jm)
    conf = dataclasses.replace(plain.conf, layers=tuple(
        dataclasses.replace(l, weight_noise=noise) for l in plain.conf.layers))
    noisy = MultiLayerNetwork(conf, device="cpu").init()
    noisy.set_params(plain.params, plain.model_state)
    x, y = _data()
    for _ in range(3):
        plain.fit(DataSet(x, y))
        noisy.fit(DataSet(x, y))
        assert noisy.score() == plain.score()
    for k, v in flatten_paths(plain.params).items():
        assert torch.equal(v, flatten_paths(noisy.params)[k]), k


def test_weight_noise_only_in_training_and_not_stored():
    from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    layer = DenseLayer(n_out=4, weight_noise=W.DropConnect(p=0.5))
    p = {"W": torch.ones(300, 40), "b": torch.ones(40)}
    g = torch.Generator().manual_seed(0)
    assert layer.apply_weight_noise(p, LayerContext(train=False,
                                                    generator=g)) is p
    assert layer.apply_weight_noise(p, LayerContext(train=True)) is p
    out = layer.apply_weight_noise(p, LayerContext(train=True, generator=g))
    assert torch.equal(out["b"], p["b"])            # bias exempt
    zeros = (out["W"] == 0).float().mean().item()
    n = p["W"].numel()
    assert abs(zeros - 0.5) <= 5 * math.sqrt(0.25 / n)
    assert torch.equal(out["W"][out["W"] != 0],
                       torch.full_like(out["W"][out["W"] != 0], 2.0))
    assert torch.equal(p["W"], torch.ones(300, 40))  # stored values kept


def test_weight_noise_statistics_and_gradients():
    g = torch.Generator().manual_seed(1)
    w = torch.randn(400, 300, generator=g)
    add = W.WeightNoise(D.NormalDistribution(0.0, 0.05)).apply_noise(
        {"W": w}, g)["W"] - w
    assert abs(add.mean().item()) <= 5 * 0.05 / math.sqrt(w.numel())
    assert abs(add.std().item() / 0.05 - 1) <= 0.01
    mult = W.WeightNoise(D.UniformDistribution(0.5, 1.5), additive=False,
                         apply_to_bias=True).apply_noise({"b": w}, g)["b"]
    ratio = mult / w
    assert 0.5 <= ratio.min().item() and ratio.max().item() <= 1.5 + 1e-6
    # gradients reach the stored weights through the noisy values
    leaf = w.clone().requires_grad_()
    noisy = W.DropConnect(p=0.25).apply_noise({"W": leaf}, g)["W"]
    noisy.sum().backward()
    kept = (noisy != 0)
    assert torch.allclose(leaf.grad[kept], torch.full_like(
        leaf.grad[kept], 1 / 0.75))
    assert (leaf.grad[~kept] == 0).all()


def test_noise_and_constraints_round_trip_through_json():
    import deeplearning4j_tpu.nn.weightnoise as jw
    import deeplearning4j_tpu.nn.distributions as jd
    jm = _jax_mlp({"weight_noise": jw.WeightNoise(jd.NormalDistribution(
        0.0, 0.02)), "constraints": (_jc("MaxNormConstraint",
                                         max_norm=1.5),)},
        {"weight_noise": jw.DropConnect(p=0.2)})
    pm = _port_of(jm)
    l0, l1 = pm.conf.layers
    assert l0.weight_noise == W.WeightNoise(D.NormalDistribution(0.0, 0.02))
    assert l0.constraints == (C.MaxNormConstraint(max_norm=1.5),)
    assert l1.weight_noise == W.DropConnect(p=0.2)
    again = MultiLayerConfiguration.from_json(pm.conf.to_json())
    assert again.layers == pm.conf.layers
    x, y = _data()
    pm.fit(DataSet(x, y))
    assert math.isfinite(pm.score())


def _draw(dist, shape=(200, 300), seed=0):
    return dist.sample(torch.Generator().manual_seed(seed), shape)


def test_distribution_statistics():
    n = 200 * 300
    x = _draw(D.NormalDistribution(1.5, 0.5))
    assert abs(x.mean().item() - 1.5) <= 5 * 0.5 / math.sqrt(n)
    assert abs(x.std().item() / 0.5 - 1) <= 0.01
    x = _draw(D.UniformDistribution(-2.0, 3.0))
    assert -2.0 <= x.min().item() and x.max().item() < 3.0
    assert abs(x.mean().item() - 0.5) <= 5 * (5 / math.sqrt(12)) / \
        math.sqrt(n)
    x = _draw(D.TruncatedNormalDistribution(0.0, 2.0))
    assert x.abs().max().item() <= 4.0
    assert abs(x.std().item() / (2.0 * 0.87962566) - 1) <= 0.01
    x = _draw(D.LogNormalDistribution(0.0, 0.25))
    assert (x > 0).all()
    assert abs(x.mean().item() / math.exp(0.25 ** 2 / 2) - 1) <= 0.01
    x = _draw(D.BinomialDistribution(trials=5, probability=0.3))
    assert set(x.unique().tolist()) <= set(range(6))
    assert abs(x.mean().item() - 1.5) <= 5 * math.sqrt(5 * 0.21 / n)
    x = _draw(D.ConstantDistribution(0.25), (3, 4))
    assert torch.equal(x, torch.full((3, 4), 0.25))
    for shape in ((6, 4), (4, 6), (3, 2, 5)):
        q = _draw(D.OrthogonalDistribution(gain=2.0), shape)
        assert q.shape == shape
        m = q.reshape(shape[0], -1) / 2.0
        small = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        torch.testing.assert_close(small, torch.eye(small.shape[0]),
                                   atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="2 dims"):
        _draw(D.OrthogonalDistribution(), (5,))


def test_distribution_as_weight_init():
    """A distribution goes wherever a WeightInit does, and the
    configuration carries it through JSON."""
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    conf = (NeuralNetConfiguration.Builder().seed(1).list()
            .layer(DenseLayer(n_out=4,
                              weight_init=D.ConstantDistribution(0.125)))
            .layer(OutputLayer(n_out=2,
                               weight_init=D.OrthogonalDistribution()))
            .set_input_type(InputType.feed_forward(4)).build())
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                          device="cpu").init()
    assert torch.equal(m.params["layer_0"]["W"], torch.full((4, 4), 0.125))
    w = m.params["layer_1"]["W"]
    torch.testing.assert_close(w.T @ w, torch.eye(2), atol=1e-5, rtol=0)


@pytest.mark.parametrize("algo", ["lbfgs", "cg"])
def test_legacy_optimizers_match_jax(algo):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    from deeplearning4j_tpu.optimize.legacy import optimize_model as jopt
    jm = _jax_mlp()
    pm = _port_of(jm)
    x, y = _data(64)
    jr = jopt(jm, JDS(x, y), algo, max_iterations=6, tolerance=0.0)
    pr = legacy.optimize_model(pm, DataSet(x, y), algo, max_iterations=6,
                               tolerance=0.0)
    assert pr.iterations == jr.iterations >= 3
    assert abs(pr.loss - jr.loss) <= LOSS_REL * abs(jr.loss)
    _close(pm.params, jm.train_state.params)
    assert pr.loss < float(pm.compute_loss(DataSet(x, y))) + 1e-6


def test_line_search_and_two_loop():
    """BackTrackLineSearch flips an ascent direction and backtracks; the
    L-BFGS two-loop recursion of one exact pair solves a quadratic."""
    a = torch.tensor([2.0, 0.5])
    f = lambda x: 0.5 * (a * x * x).sum()
    x = torch.tensor([1.0, -2.0])
    g = a * x
    step, loss, d = legacy.BackTrackLineSearch().search(f, x, float(f(x)),
                                                        g, g.clone())
    assert step > 0 and loss < float(f(x)) and torch.equal(d, -g)
    s = torch.tensor([1.0, 0.0])
    q = legacy.LBFGS._two_loop(g, [s], [a * s])
    assert q.shape == g.shape
    lb = legacy.LBFGS(max_iterations=30, tolerance=1e-12)
    res = lb.optimize(lambda p: f(p["x"]), {"x": x})
    assert res.loss < 1e-8


def test_summary_equals_jax_mln():
    jm = _jax_mlp()
    pm = _port_of(jm)
    assert pm.summary() == jm.summary()
    assert "total params: 75" in pm.summary()
    fresh = MultiLayerNetwork(pm.conf, device="cpu")
    assert fresh.summary().endswith("total params: ?")


def test_summary_equals_jax_graph():
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JG
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.graph.vertices import MergeVertex
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    jconf = (NeuralNetConfiguration.Builder().seed(2).graph_builder()
             .add_inputs("in")
             .add_layer("a", DenseLayer(n_out=4), "in")
             .add_layer("b", DenseLayer(n_out=3), "in")
             .add_vertex("m", MergeVertex(), "a", "b")
             .add_layer("o", OutputLayer(n_out=2), "m")
             .set_outputs("o")
             .set_input_types(InputType.feed_forward(5)).build())
    jg = JG(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    pg = ComputationGraph(conf, device="cpu").init()
    assert pg.summary() == jg.summary()
    assert pg.conf_global == pg.conf.global_config
    assert "total params" not in ComputationGraph(conf,
                                                  device="cpu").summary()


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_clone_is_bitwise_and_independent(kind):
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    b = NeuralNetConfiguration.Builder().seed(4).updater(Adam(1e-2))
    if kind == "mln":
        conf = (b.list().layer(DenseLayer(n_out=6, dropout=0.3))
                .layer(OutputLayer(n_out=3))
                .set_input_type(InputType.feed_forward(5)).build())
        m = MultiLayerNetwork(conf, device="cpu").init()
    else:
        conf = (b.graph_builder().add_inputs("in")
                .add_layer("d", DenseLayer(n_out=6, dropout=0.3), "in")
                .add_layer("o", OutputLayer(n_out=3), "d")
                .set_outputs("o")
                .set_input_types(InputType.feed_forward(5)).build())
        m = ComputationGraph(conf, device="cpu").init()
    x, y = _data()
    ds = DataSet(x, y) if kind == "mln" else MultiDataSet((x,), (y,))
    m.fit(ds)
    c = m.clone()
    assert type(c) is type(m) and c.iteration == m.iteration == 1
    assert c.conf_global == m.conf_global
    for tree in ("params", "model_state", "opt_state"):
        a, b_ = flatten_paths(getattr(m, tree)), flatten_paths(
            getattr(c, tree))
        assert a.keys() == b_.keys()
        for k in a:
            assert torch.equal(a[k], b_[k]) and \
                a[k].data_ptr() != b_[k].data_ptr(), (tree, k)
    # both take the same next step (dropout draws included) ...
    m.fit(ds)
    c.fit(ds)
    for k, v in flatten_paths(m.params).items():
        assert torch.equal(v, flatten_paths(c.params)[k])
    # ... and training one leaves the other as it was
    snap = {k: v.clone() for k, v in flatten_paths(m.params).items()}
    c.fit(ds)
    for k, v in flatten_paths(m.params).items():
        assert torch.equal(v, snap[k])
    unfit = MultiLayerNetwork(m.conf, device="cpu") if kind == "mln" \
        else ComputationGraph(m.conf, device="cpu")
    assert unfit.clone().params is None
