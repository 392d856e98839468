"""The recurrent family of the port against the JAX package on the CPU:
``GravesLSTM``, ``GravesBidirectionalLSTM``, ``SimpleRnn``,
``Bidirectional`` (every mode), ``LastTimeStep``, ``MaskZeroLayer``,
``EmbeddingLayer``, ``LossLayer``, ``RnnLossLayer``, ``GlobalPoolingLayer``
over time and the recurrent graph vertices, each forward and backward,
with and without a right-padded ragged mask (as
``tests/test_layers.py`` checks the JAX layers); ``rnn_time_step``
through the wrappers; and every new ``@type`` through configuration JSON
and a zip in both directions.

Each layer is built from the JAX layer's JSON and takes the JAX layer's
parameters, replaced by seeded numpy draws (so peepholes and biases are
not zero). The JAX LSTM runs its ``lax.scan`` recurrence, the port the
plain versions of its fused kernels (the CPU path of the wrappers).
Bounds (ROADMAP's f32 defaults): outputs and losses rel 1e-5 of the
largest magnitude; gradients 1e-4 of each array's largest.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.serialization import (
    _ensure_registry, restore_model, save_model)
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.utils import serde

N, T, F, H = 3, 7, 4, 5
FWD_REL, GRAD_REL = 1e-5, 1e-4


def _jax_it(kind, *a):
    from deeplearning4j_tpu.nn.inputs import InputType
    return getattr(InputType, kind)(*a)


def _port_it(kind, *a):
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    return getattr(InputType, kind)(*a)


def _port_layer(jlayer):
    """The port layer decoded from the JAX layer's JSON; its JSON equals
    the JAX layer's."""
    from deeplearning4j_tpu.utils import serde as jserde
    _ensure_registry()
    text = jserde.to_json(jlayer)
    tlayer = serde.from_json(text)
    assert json.loads(serde.to_json(tlayer)) == json.loads(text)
    assert type(tlayer).__name__ == type(jlayer).__name__
    return tlayer


def _random_like(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: (0.4 * rng.normal(size=a.shape)).astype(np.float32),
        tree)


def _torch(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).requires_grad_(grad)


def _ragged(n=N, t=T):
    m = np.ones((n, t), np.float32)
    m[0, t - 3:] = 0.0
    m[1, t - 1:] = 0.0
    return m


def _close(got, want, rel, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-6), (what, err)


def _check_layer(jlayer, x, mask, it_args=("recurrent", F, T), seed=0,
                 grad_x=True):
    """Forward and gradients (of a fixed random projection of the output)
    of the JAX layer and its port on the same parameters and input."""
    from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
    tlayer = _port_layer(jlayer)
    rng = np.random.default_rng(seed)
    jp = (_random_like(jlayer.initialize(jax.random.PRNGKey(seed),
                                         _jax_it(*it_args)), rng)
          if jlayer.has_params else {})
    tp = tlayer.initialize(torch.Generator().manual_seed(seed),
                           _port_it(*it_args)) if tlayer.has_params else {}
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, tp)) or not jp
    jst = jlayer.init_state(_jax_it(*it_args))
    jctx = JCtx(train=False, mask=None if mask is None else jnp.asarray(mask))
    jy, _ = jlayer.apply(jp, jst, jnp.asarray(x), jctx)
    w = rng.normal(size=jy.shape).astype(np.float32)

    def jf(p, xx):
        y, _ = jlayer.apply(p, jst, xx, jctx)
        return jnp.sum(y * w)
    grad_x = grad_x and x.dtype == np.float32
    jgp, jgx = (jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x)) if grad_x
                else (jax.grad(jf)(jp, jnp.asarray(x)), None))

    tparams = _torch(jp, grad=True)
    tx = torch.tensor(x).requires_grad_(grad_x)
    tctx = LayerContext(train=False,
                        mask=None if mask is None else torch.tensor(mask))
    ty, _ = tlayer.apply(tparams, _torch(jst), tx, tctx)
    _close(ty, jy, FWD_REL, "forward")
    leaves = jax.tree_util.tree_leaves(tparams)
    wanted = leaves + ([tx] if tx.requires_grad else [])
    if wanted:
        grads = torch.autograd.grad((ty * torch.tensor(w)).sum(), wanted,
                                    allow_unused=True)
        for g, want in zip(grads, jax.tree_util.tree_leaves(jgp)):
            _close(torch.zeros(want.shape) if g is None else g, want,
                   GRAD_REL, "param grad")
        if tx.requires_grad:
            _close(grads[-1], jgx, GRAD_REL, "input grad")
    return tlayer, tparams, jp


def _seq(seed=1, n=N, t=T, f=F):
    return np.random.default_rng(seed).normal(size=(n, t, f)).astype(
        np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["GravesLSTM", "SimpleRnn",
                                  "GravesBidirectionalLSTM", "LSTM"])
def test_recurrent_layer_matches_jax(kind, masked):
    from deeplearning4j_tpu.nn.layers import recurrent as R
    layer = getattr(R, kind)(n_in=F, n_out=H)
    _check_layer(layer, _seq(), _ragged() if masked else None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["concat", "add", "mul", "average"])
@pytest.mark.parametrize("inner", ["LSTM", "GravesLSTM", "SimpleRnn"])
def test_bidirectional_matches_jax(inner, mode, masked):
    from deeplearning4j_tpu.nn.layers import recurrent as R
    layer = R.Bidirectional(fwd=getattr(R, inner)(n_in=F, n_out=H),
                            mode=mode)
    _check_layer(layer, _seq(2), _ragged() if masked else None)


def test_bidirectional_backward_sees_leading_masked_ticks():
    """The reversed pass of a right-padded row starts with masked ticks:
    its carry stays at zero through them, so each row's backward output
    equals the inner layer run on that row alone, unpadded."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (LSTM,
                                                              Bidirectional)
    it = _port_it("recurrent", F, T)
    layer = Bidirectional(fwd=LSTM(n_in=F, n_out=H), mode="concat")
    p = layer.initialize(torch.Generator().manual_seed(0), it)
    x = torch.tensor(_seq(3))
    m = torch.tensor(_ragged())
    y, _ = layer.apply(p, {}, x, LayerContext(mask=m))
    for r in range(N):
        n_live = int(m[r].sum())
        alone, _ = layer.fwd.apply(
            p["bwd"], {}, torch.flip(x[r:r + 1, :n_live], (1,)),
            LayerContext())
        _close(y[r, :n_live, H:], torch.flip(alone, (1,))[0].numpy(),
               FWD_REL, f"row {r}")
        assert torch.all(y[r, n_live:] == 0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("inner", ["LSTM", "SimpleRnn"])
def test_last_time_step_matches_jax(inner, masked):
    from deeplearning4j_tpu.nn.layers import recurrent as R
    layer = R.LastTimeStep(inner=getattr(R, inner)(n_in=F, n_out=H))
    _check_layer(layer, _seq(4), _ragged() if masked else None)


def test_last_time_step_of_a_fully_masked_row_is_step_zero():
    from deeplearning4j_tpu_torch.nn.layers.recurrent import last_step
    y = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    m = torch.tensor([[0, 0, 0, 0], [1, 1, 0, 0]], dtype=torch.float32)
    assert torch.equal(last_step(y, m), torch.stack([y[0, 0], y[1, 1]]))


def test_mask_zero_layer_matches_jax():
    from deeplearning4j_tpu.nn.layers import recurrent as R
    x = _seq(5)
    x[0, 4:] = -1.0          # sentinel steps
    x[2, 6:] = -1.0
    layer = R.MaskZeroLayer(inner=R.LSTM(n_in=F, n_out=H), mask_value=-1.0)
    # the JAX gradient with respect to x is not defined through the
    # comparison; the parameters' gradients are
    _check_layer(layer, x, None, grad_x=False)


def test_embedding_layer_matches_jax():
    from deeplearning4j_tpu.nn.layers.feedforward import EmbeddingLayer
    from deeplearning4j_tpu.ops.activations import Activation
    ids = np.array([[3], [0], [9], [3]], np.int32)
    _check_layer(EmbeddingLayer(n_in=10, n_out=H,
                                activation=Activation.TANH),
                 ids, None, it_args=("feed_forward", 1))
    _check_layer(EmbeddingLayer(n_in=10, n_out=H, has_bias=False),
                 ids[:, 0].astype(np.float32), None,
                 it_args=("feed_forward", 1), grad_x=False)


def test_embedding_layer_refuses_bf16_ids():
    from deeplearning4j_tpu_torch.nn.layers.feedforward import EmbeddingLayer
    layer = EmbeddingLayer(n_in=300, n_out=2)
    p = layer.initialize(torch.Generator().manual_seed(0),
                         _port_it("feed_forward", 1))
    with pytest.raises(TypeError, match="integer tensor"):
        layer.apply(p, {}, torch.tensor([[257.0]], dtype=torch.bfloat16),
                    LayerContext())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pooling", ["MAX", "AVG", "SUM", "PNORM"])
def test_global_pooling_over_time_matches_jax(pooling, masked):
    from deeplearning4j_tpu.nn.layers.convolution import PoolingType
    from deeplearning4j_tpu.nn.layers.output import GlobalPoolingLayer
    _check_layer(GlobalPoolingLayer(pooling_type=PoolingType[pooling],
                                    pnorm=3),
                 _seq(6), _ragged() if masked else None)


def test_global_max_pooling_of_a_fully_masked_row_is_minus_inf():
    from deeplearning4j_tpu_torch.nn.layers.convolution import PoolingType
    from deeplearning4j_tpu_torch.nn.layers.output import GlobalPoolingLayer
    layer = GlobalPoolingLayer(pooling_type=PoolingType.MAX)
    m = torch.ones(2, 3)
    m[1] = 0.0
    y, _ = layer.apply({}, {}, torch.randn(2, 3, 4), LayerContext(mask=m))
    assert torch.isfinite(y[0]).all() and torch.all(y[1] == -np.inf)


def _loss_pair(jlayer, x, labels, mask):
    from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
    tlayer = _port_layer(jlayer)
    jm = None if mask is None else jnp.asarray(mask)
    jl, jg = jax.value_and_grad(lambda xx: jlayer.compute_loss(
        {}, {}, xx, jnp.asarray(labels), JCtx(train=True, mask=jm)))(
            jnp.asarray(x))
    tx = torch.tensor(x).requires_grad_()
    tl = tlayer.compute_loss({}, {}, tx, torch.tensor(labels),
                             LayerContext(train=True, mask=None if mask is None
                                          else torch.tensor(mask)))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=FWD_REL)
    _close(torch.autograd.grad(tl, tx)[0], jg, GRAD_REL, "loss grad")
    _close(tlayer.apply({}, {}, tx, LayerContext())[0],
           jlayer.apply({}, {}, jnp.asarray(x), JCtx())[0], FWD_REL,
           "activation")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind,act,loss", [
    ("RnnLossLayer", "SOFTMAX", "MCXENT"),
    ("RnnLossLayer", "IDENTITY", "MSE"),
    ("LossLayer", "SIGMOID", "XENT")])
def test_loss_layers_match_jax(kind, act, loss, masked):
    from deeplearning4j_tpu.nn.layers import output as O
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction
    rng = np.random.default_rng(7)
    x = _seq(8)
    if act == "SIGMOID":
        labels = (rng.random(x.shape) > 0.5).astype(np.float32)
    elif act == "SOFTMAX":
        labels = np.eye(F, dtype=np.float32)[rng.integers(0, F, (N, T))]
    else:
        labels = rng.normal(size=x.shape).astype(np.float32)
    layer = getattr(O, kind)(activation=Activation[act],
                             loss=LossFunction[loss])
    _loss_pair(layer, x, labels, _ragged() if masked else None)


def test_rnn_loss_layer_refuses_flat_input():
    from deeplearning4j_tpu_torch.nn.layers.output import RnnLossLayer
    with pytest.raises(ValueError, match="recurrent"):
        RnnLossLayer().output_type(_port_it("feed_forward", 3))


@pytest.mark.parametrize("masked", [False, True])
def test_recurrent_vertices_match_jax(masked):
    from deeplearning4j_tpu.nn.graph import vertices as JV
    from deeplearning4j_tpu_torch.nn.graph import vertices as V
    _ensure_registry()
    x = _seq(9)
    m = _ragged() if masked else None
    static = np.random.default_rng(3).normal(size=(N, 2)).astype(np.float32)
    cases = [
        ("LastTimeStepVertex", (x,), {"mask": m}),
        ("ReverseTimeSeriesVertex", (x,), {}),
        ("DuplicateToTimeSeriesVertex", (static, x), {}),
        ("MergeVertex", (x, x[..., :2]), {}),
    ]
    from deeplearning4j_tpu.utils import serde as jserde
    for name, xs, kw in cases:
        jv = getattr(JV, name)()
        tv = serde.from_json(jserde.to_json(jv))
        assert isinstance(tv, getattr(V, name))
        jkw = {k: None if v is None else jnp.asarray(v)
               for k, v in kw.items()}
        tkw = {k: None if v is None else torch.tensor(v)
               for k, v in kw.items()}
        want = jv.apply(*map(jnp.asarray, xs), **jkw)
        got = tv.apply(*map(torch.tensor, xs), **tkw)
        _close(got, want, 0.0, name)


def test_graves_bidirectional_refuses_initial_state():
    from deeplearning4j_tpu_torch.nn.layers.recurrent import \
        GravesBidirectionalLSTM
    layer = GravesBidirectionalLSTM(n_in=F, n_out=H)
    p = layer.initialize(torch.Generator().manual_seed(0),
                         _port_it("recurrent", F, T))
    h = torch.zeros(N, H)
    with pytest.raises(ValueError, match="carry state"):
        layer.apply(p, {}, torch.tensor(_seq()), LayerContext(),
                    initial_state=(h, h))


def test_graves_lstm_refuses_hidden_major():
    from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
    with pytest.raises(ValueError, match="gate_major"):
        GravesLSTM(n_out=3, gate_layout="hidden_major")


def test_graves_lstm_is_not_fused_and_step_one_is_its_cell():
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (LSTM,
                                                              GravesLSTM)
    assert LSTM(n_out=2)._fused_eligible()
    g = GravesLSTM(n_in=F, n_out=H)
    assert not g._fused_eligible()
    p = _torch(_random_like(g.initialize(torch.Generator().manual_seed(0),
                                         _port_it("recurrent", F, T)),
                            np.random.default_rng(0)))
    x = torch.tensor(_seq(10))
    y, st = g.apply(p, {}, x, LayerContext())
    carry = (torch.zeros(N, H), torch.zeros(N, H))
    for s in range(T):
        carry = g.step_one(p, x[:, s], carry)
    _close(carry[0], y[:, -1].numpy(), 1e-6, "h")
    _close(carry[1], st["last_c"].numpy(), 1e-6, "c")


def test_unwrap_and_bidirectional_helpers():
    from deeplearning4j_tpu_torch.nn.layers import recurrent as R
    core = R.LSTM(n_out=3)
    assert R.unwrap_recurrent(R.LastTimeStep(inner=R.MaskZeroLayer(
        inner=core))) is core
    bi = R.Bidirectional(fwd=core)
    assert R.unwrap_recurrent(bi) is bi
    assert R.first_bidirectional_name(
        [("a", core), ("b", R.LastTimeStep(inner=bi)),
         ("c", R.GravesBidirectionalLSTM(n_out=2))]) == "b"
    assert R.first_bidirectional_name(
        [("a", core), ("c", R.GravesBidirectionalLSTM(n_out=2))]) == "c"
    assert R.first_bidirectional_name([("a", core)]) is None
    with pytest.warns(UserWarning, match="bidirectional layer 'x'"):
        R.warn_tbptt_bidirectional("x")


def test_bidirectional_dropout_draws_one_generator_a_direction():
    """With dropout on the inner layer each direction draws from its own
    generator, seeded from the context's, so a train call is reproducible
    from the context generator's seed."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (LSTM,
                                                              Bidirectional)
    layer = Bidirectional(fwd=LSTM(n_in=F, n_out=H, dropout=0.5))
    p = layer.initialize(torch.Generator().manual_seed(0),
                         _port_it("recurrent", F, T))
    x = torch.tensor(_seq(11))
    run = lambda s: layer.apply(p, {}, x, LayerContext(
        train=True, generator=torch.Generator().manual_seed(s)))[0]
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    ev = layer.apply(p, {}, x, LayerContext())[0]
    assert not torch.equal(run(5), ev)


# ---- whole models: configuration JSON and zips both ways ---------------

def _jax_model(which):
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers import output as O
    from deeplearning4j_tpu.nn.layers import recurrent as R
    from deeplearning4j_tpu.nn.layers.convolution import PoolingType
    from deeplearning4j_tpu.nn.layers.feedforward import (DenseLayer,
                                                          EmbeddingLayer)
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction
    from deeplearning4j_tpu.optimize.updaters import Adam
    b = NeuralNetConfiguration.Builder().seed(5).updater(Adam(1e-2)).list()
    if which == "bidirectional":
        b = (b.layer(R.Bidirectional(fwd=R.LSTM(n_out=H), mode="add"))
             .layer(R.GravesBidirectionalLSTM(n_out=H))
             .layer(O.GlobalPoolingLayer(pooling_type=PoolingType.AVG))
             .layer(O.OutputLayer(n_out=3)))
        it = InputType.recurrent(F, T)
    elif which == "wrappers":
        b = (b.layer(R.MaskZeroLayer(inner=R.GravesLSTM(n_out=H),
                                     mask_value=0.0))
             .layer(R.SimpleRnn(n_out=H))
             .layer(R.LastTimeStep(inner=R.LSTM(n_out=H)))
             .layer(DenseLayer(n_out=4, activation=Activation.TANH))
             .layer(O.LossLayer(activation=Activation.SOFTMAX,
                                loss=LossFunction.MCXENT)))
        it = InputType.recurrent(F, T)
    else:     # an embedding into a one-step recurrence
        b = (b.layer(EmbeddingLayer(n_in=12, n_out=H))
             .layer(R.LSTM(n_out=H))
             .layer(O.RnnLossLayer(activation=Activation.SOFTMAX,
                                   loss=LossFunction.MCXENT)))
        it = InputType.feed_forward(1)
    return JMLN(b.set_input_type(it).build()).init()


def _inputs_for(which):
    if which == "embedding":
        return np.array([[1], [7], [11]], np.float32), None
    x = _seq(12)
    return x, _ragged()


@pytest.mark.parametrize("which", ["bidirectional", "wrappers", "embedding"])
def test_models_round_trip_json_and_zips_both_ways(which, tmp_path):
    from deeplearning4j_tpu.models.serialization import \
        restore_model as jax_restore
    from deeplearning4j_tpu.models.serialization import save_model as jax_save
    from deeplearning4j_tpu.nn.config import \
        MultiLayerConfiguration as JConf
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    jm = _jax_model(which)
    text = jm.conf.to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert json.loads(conf.to_json()) == json.loads(text)
    assert json.loads(JConf.from_json(conf.to_json()).to_json()) == \
        json.loads(text)
    x, m = _inputs_for(which)
    jmask = None if m is None else jnp.asarray(m)
    want = np.asarray(jm.output(x, mask=jmask))
    a = str(tmp_path / "jax.zip")
    jax_save(jm, a)
    tm = restore_model(a, device="cpu")
    _close(tm.output(x, mask=m), want, FWD_REL, "jax zip in the port")
    b = str(tmp_path / "port.zip")
    save_model(tm, b)
    back = jax_restore(b)
    np.testing.assert_allclose(np.asarray(back.output(x, mask=jmask)), want,
                               rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["MaskZeroLayer", "LastTimeStep"])
def test_rnn_time_step_through_the_wrappers_matches_jax(kind):
    """rnn_time_step looks through the wrappers: a wrapped LSTM core and a
    SimpleRnn carry their state across calls as the JAX model's do."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers import output as O
    from deeplearning4j_tpu.nn.layers import recurrent as R
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serialization import \
        params_from_jax
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    last = kind == "LastTimeStep"
    wrapped = (R.LastTimeStep(inner=R.LSTM(n_out=H)) if last
               else R.MaskZeroLayer(inner=R.LSTM(n_out=H), mask_value=9.0))
    b = (NeuralNetConfiguration.Builder().seed(2).list()
         .layer(R.SimpleRnn(n_out=H)).layer(wrapped)
         .layer(O.OutputLayer(n_out=3) if last else O.RnnOutputLayer(n_out=3))
         .set_input_type(InputType.recurrent(F)))
    jm = JMLN(b.build()).init()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jm.conf.to_json()), device="cpu").init()
    ts = jax.tree_util.tree_map(np.asarray, jm.train_state)
    params_from_jax(ts.params, ts.model_state, model=tm)
    x = _seq(13)
    jc, tc = None, None
    for s in range(0, T, 3):
        jy, jc = jm.rnn_time_step(x[:, s:s + 3], jc)
        ty, tc = tm.rnn_time_step(x[:, s:s + 3], tc)
        _close(ty, jy, FWD_REL, f"output at {s}")
    assert set(tc) == set(jc) == {"layer_0", "layer_1"}
    _close(tc["layer_0"], jc["layer_0"], FWD_REL, "SimpleRnn h")
    for i in (0, 1):
        _close(tc["layer_1"][i], jc["layer_1"][i], FWD_REL, "LSTM carry")
