"""The port's convolutional-library layers, vertices and preprocessors
against the JAX package's, on the CPU.

Every case builds the JAX object, carries it to the port through its
``configuration.json`` form (the port's serializer must read it and
write the same JSON back), initializes the JAX parameters and copies them
across, then holds the forward output and the gradients (of a random
linear function of the output, with respect to the input and every
parameter) against the JAX package's. Bounds: float32 forward within
1e-5 (rtol and atol), gradients within 1e-4 relative L2 — the same f32
math summed in other orders; bfloat16 forward within 2e-2 (one bf16
rounding at another place, 2^-8 relative). ``Deconvolution2D`` is held in
every ``ConvolutionMode``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.graph.vertices as jv
import deeplearning4j_tpu.nn.inputs as jin
import deeplearning4j_tpu.nn.layers.convolution as jconv
import deeplearning4j_tpu.nn.layers.feedforward as jff
import deeplearning4j_tpu.nn.layers.misc as jmisc
import deeplearning4j_tpu.nn.layers.normalization as jnorm
import deeplearning4j_tpu.nn.layers.output as jout
import deeplearning4j_tpu.nn.preprocessors as jpp
from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
from deeplearning4j_tpu.ops.activations import Activation as JAct
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.utils import serde as jserde
from deeplearning4j_tpu_torch.models.serialization import _ensure_registry
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.utils import serde as tserde

_ensure_registry()

FWD_TOL, GRAD_RTOL, BF16_TOL = 1e-5, 1e-4, 2e-2
CM = jconv.ConvolutionMode
PT = jconv.PoolingType


def _port(obj):
    """The port's object of the JAX object's JSON; the JSON round-trips."""
    js = jserde.to_json(obj)
    out = tserde.from_json(js)
    assert tserde.to_json(out) == js
    return out


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / max(np.linalg.norm(want), 1e-30))


def _init_params(jlayer, jit, seed=0):
    """JAX-initialized parameters (numpy), with every zero-initialized
    array (biases, centers) replaced by small random values so the
    gradients through them are exercised."""
    if not jlayer.has_params:
        return {}
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, jlayer.initialize(
        jax.random.PRNGKey(seed), jit))
    return {k: (rng.normal(0, 0.1, v.shape).astype(np.float32)
                if not v.any() else v.astype(np.float32))
            for k, v in p.items()}


def check_layer(jlayer, jit, x, mask=None, dtype="float32", train=False,
                grad=True, seed=0):
    """Forward (and, in float32, gradients) of ``jlayer`` and its port on
    the same input and parameters; returns the port's layer and output."""
    tl = _port(jlayer)
    tit = _port(jit)
    assert tl.output_type(tit).shape() == jlayer.output_type(jit).shape()
    params = _init_params(jlayer, jit, seed)
    state = jax.tree_util.tree_map(np.asarray, jlayer.init_state(jit))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    def jf(p, xx):
        y, _ = jlayer.apply(p, state, xx, JCtx(train=train, mask=jm))
        return y

    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    yj = jf(jp, jnp.asarray(x).astype(jdt))
    tp = {k: torch.from_numpy(v).to(tdt).requires_grad_(dtype == "float32")
          for k, v in params.items()}
    tx = torch.from_numpy(x).to(tdt)
    if x.dtype.kind == "f" and dtype == "float32":
        tx.requires_grad_(True)
    ts = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    yt, _ = tl.apply(tp, ts, tx, LayerContext(train=train, mask=tm))
    assert yt.dtype == tdt
    yj_np = np.asarray(yj.astype(jnp.float32))
    assert tuple(yt.shape) == yj_np.shape
    tol = FWD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(yt.detach().float().numpy(), yj_np,
                               rtol=tol, atol=tol)
    if grad and dtype == "float32":
        r = np.random.default_rng(seed + 1).normal(
            0, 1, yj_np.shape).astype(np.float32)
        _, vjp = jax.vjp(jf, jp, jnp.asarray(x))
        gp, gx = vjp(jnp.asarray(r))
        leaves = list(tp.values()) + ([tx] if tx.requires_grad else [])
        if leaves:
            grads = torch.autograd.grad((yt * torch.from_numpy(r)).sum(),
                                        leaves)
            for (k, g) in zip(tp, grads):
                assert _rel_l2(g.numpy(), gp[k]) <= GRAD_RTOL, k
            if tx.requires_grad:
                assert _rel_l2(grads[-1].numpy(), gx) <= GRAD_RTOL, "dx"
    return tl, yt


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def conv_it(h, w, c):
    return jin.ConvolutionalType(h, w, c)


def rnn_it(size, t):
    return jin.RecurrentType(size, t)


# ---------------------------------------------------------------------------
# 2-D convolutional layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["STRICT", "TRUNCATE", "SAME"])
@pytest.mark.parametrize("k,s,p,d,hw", [
    ((3, 3), (2, 2), (0, 0), (1, 1), (5, 5)),
    ((2, 3), (1, 2), (1, 0), (1, 1), (4, 5)),
    ((3, 3), (2, 1), (1, 1), (2, 1), (3, 4)),
    ((1, 1), (3, 3), (0, 0), (1, 1), (3, 2)),
])
def test_deconvolution2d_every_mode(mode, k, s, p, d, hw):
    layer = jconv.Deconvolution2D(n_out=5, kernel_size=k, stride=s,
                                  padding=p, dilation=d,
                                  convolution_mode=CM[mode],
                                  activation=JAct.IDENTITY)
    check_layer(layer, conv_it(*hw, 3), _x((2,) + hw + (3,)))


@pytest.mark.parametrize("kw,hw", [
    (dict(kernel_size=(3, 3), convolution_mode=CM.SAME,
          depth_multiplier=2), (6, 5)),
    (dict(kernel_size=(3, 2), stride=(2, 1), convolution_mode=CM.TRUNCATE,
          padding=(1, 0), depth_multiplier=1), (7, 6)),
    (dict(kernel_size=(3, 3), dilation=(2, 2), convolution_mode=CM.SAME,
          depth_multiplier=3, has_bias=False), (7, 7)),
])
def test_separable_convolution2d(kw, hw):
    layer = jconv.SeparableConvolution2D(n_out=6, activation=JAct.RELU,
                                         **kw)
    check_layer(layer, conv_it(*hw, 4), _x((2,) + hw + (4,)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_family_bf16_forward(dtype):
    x = _x((2, 6, 6, 4))
    check_layer(jconv.Deconvolution2D(n_out=3, kernel_size=(3, 3),
                                      stride=(2, 2),
                                      convolution_mode=CM.SAME),
                conv_it(6, 6, 4), x, dtype=dtype)
    check_layer(jconv.SeparableConvolution2D(n_out=3, kernel_size=(3, 3),
                                             convolution_mode=CM.SAME,
                                             depth_multiplier=2),
                conv_it(6, 6, 4), x, dtype=dtype)


@pytest.mark.parametrize("layer,hw", [
    (jconv.Upsampling2D(size=(2, 3)), (3, 4)),
    (jconv.Upsampling2D(size=2), (2, 2)),
    (jconv.Cropping2D(crop=(1, 0, 2, 1)), (5, 6)),
    (jconv.Cropping2D(crop=(0, 2, 0, 0)), (4, 3)),
    (jconv.SpaceToBatchLayer(block_size=(2, 2)), (4, 6)),
    (jconv.SpaceToBatchLayer(block_size=(1, 3)), (2, 6)),
])
def test_shape_layers_2d(layer, hw):
    check_layer(layer, conv_it(*hw, 3), _x((2,) + hw + (3,)))


def test_space_to_batch_block_order():
    """The new batch is ordered (bh, bw, n): row (a·bw + b)·N + n holds
    pixel (a, b) of every block of example n."""
    tl = _port(jconv.SpaceToBatchLayer(block_size=(2, 2)))
    x = torch.arange(2 * 4 * 4 * 1, dtype=torch.float32).reshape(2, 4, 4, 1)
    y, _ = tl.apply({}, {}, x, LayerContext())
    for a in range(2):
        for b in range(2):
            for n in range(2):
                torch.testing.assert_close(y[(a * 2 + b) * 2 + n],
                                           x[n, a::2, b::2, :])


# ---------------------------------------------------------------------------
# 1-D (N, T, F) layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, convolution_mode=CM.SAME),
    dict(kernel_size=4, stride=2, convolution_mode=CM.SAME),
    dict(kernel_size=3, stride=2, padding=1, dilation=2,
         convolution_mode=CM.TRUNCATE),
    dict(kernel_size=2, convolution_mode=CM.TRUNCATE, has_bias=False),
])
def test_convolution1d(kw):
    layer = jconv.Convolution1DLayer(n_out=5, activation=JAct.TANH, **kw)
    check_layer(layer, rnn_it(4, 9), _x((3, 9, 4)))


@pytest.mark.parametrize("pt", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("k,s", [(2, 2), (3, 1), (3, 2)])
def test_subsampling1d(pt, k, s):
    layer = jconv.Subsampling1DLayer(kernel_size=k, stride=s,
                                     pooling_type=PT[pt])
    check_layer(layer, rnn_it(4, 9), _x((3, 9, 4)))


@pytest.mark.parametrize("layer", [
    jconv.Upsampling1D(size=3),
    jconv.ZeroPadding1DLayer(pad=(2, 1)),
    jconv.Cropping1D(crop=(1, 2)),
    jconv.Cropping1D(crop=(0, 3)),
])
def test_shape_layers_1d(layer):
    check_layer(layer, rnn_it(4, 7), _x((2, 7, 4)))


def test_1d_stack_in_a_network_matches_jax():
    """The 1-D layers inside one MultiLayerNetwork built from the JAX
    configuration's JSON: output and loss."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    conf = (NeuralNetConfiguration.Builder().seed(3).list()
            .layer(jconv.ZeroPadding1DLayer(pad=(1, 1)))
            .layer(jconv.Convolution1DLayer(n_out=6, kernel_size=3,
                                            convolution_mode=CM.TRUNCATE,
                                            activation=JAct.RELU))
            .layer(jconv.Upsampling1D(size=2))
            .layer(jconv.Subsampling1DLayer(kernel_size=2, stride=2,
                                            pooling_type=PT.AVG))
            .layer(jconv.Cropping1D(crop=(1, 1)))
            .layer(RnnOutputLayer(n_out=3, loss=JLoss.MCXENT,
                                  activation=JAct.SOFTMAX))
            .set_input_type(jin.InputType.recurrent(4, 10))
            .build())
    jm = JMLN(conf).init()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                           device="cpu").init()
    params_from_jax(jax.tree_util.tree_map(np.asarray,
                                           jm.train_state.params),
                    jax.tree_util.tree_map(np.asarray,
                                           jm.train_state.model_state),
                    "cpu", model=tm)
    x = _x((2, 10, 4))
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(1).integers(
        0, 3, (2, 8))]
    np.testing.assert_allclose(tm.output(x).numpy(), np.asarray(
        jm.output(x)), rtol=FWD_TOL, atol=FWD_TOL)
    assert tm.score(DataSet(x, y)) == pytest.approx(
        float(jm.score(JDS(x, y))), rel=1e-5)


# ---------------------------------------------------------------------------
# normalization, feed-forward, misc and output layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [
    {}, dict(k=1.0, n=3, alpha=0.5, beta=0.5),
    dict(k=0.5, n=4, alpha=1.0, beta=0.75)])
def test_local_response_normalization(kw, dtype):
    layer = jnorm.LocalResponseNormalization(**kw)
    check_layer(layer, conv_it(3, 4, 7), 2 * _x((2, 3, 4, 7)), dtype=dtype)


def test_lrn_is_not_torch_local_response_norm():
    """alpha multiplies the window's sum as it is: torch's
    ``F.local_response_norm`` (alpha / size, NCHW) differs unless
    rescaled; with alpha·size it is the same function."""
    tl = _port(jnorm.LocalResponseNormalization(k=1.0, n=5, alpha=0.3,
                                                beta=0.75))
    x = torch.from_numpy(_x((2, 3, 4, 7)))
    y, _ = tl.apply({}, {}, x, LayerContext())
    ref = torch.nn.functional.local_response_norm(
        x.permute(0, 3, 1, 2), 5, alpha=0.3 * 5, beta=0.75, k=1.0)
    torch.testing.assert_close(y, ref.permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-6)
    raw = torch.nn.functional.local_response_norm(
        x.permute(0, 3, 1, 2), 5, alpha=0.3, beta=0.75, k=1.0)
    assert (y - raw.permute(0, 2, 3, 1)).abs().max() > 1e-2


@pytest.mark.parametrize("layer,it,shape", [
    (jff.ReshapeLayer(shape=(4, 6)), jin.FeedForwardType(24), (3, 24)),
    (jff.ReshapeLayer(shape=(2, -1, 3)), jin.FeedForwardType(24), (3, 24)),
    (jff.ReshapeLayer(shape=(12,)), jin.ConvolutionalType(2, 3, 2),
     (3, 2, 3, 2)),
    (jff.PermuteLayer(dims=(2, 1)), jin.RecurrentType(4, 5), (3, 5, 4)),
    (jff.PermuteLayer(dims=(3, 1, 2)), jin.ConvolutionalType(2, 3, 4),
     (3, 2, 3, 4)),
])
def test_reshape_and_permute(layer, it, shape):
    check_layer(layer, it, _x(shape))


@pytest.mark.parametrize("it,shape", [
    (jin.FeedForwardType(6), (4, 6)),
    (jin.RecurrentType(6, 3), (4, 3, 6)),
])
def test_elementwise_multiplication(it, shape):
    layer = jff.ElementWiseMultiplicationLayer(n_out=6,
                                               activation=JAct.TANH)
    tl, _ = check_layer(layer, it, _x(shape))
    with pytest.raises(ValueError):
        type(tl)(n_in=5, n_out=6)


@pytest.mark.parametrize("shape,mask", [
    ((4, 5), np.array([[1], [0], [1], [1]], np.float32)),
    ((3, 4, 5), np.array([[1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]],
                         np.float32)),
    ((3, 2, 2, 5), np.array([1, 0, 1], np.float32)),
    ((3, 5), None),
])
def test_mask_layer(shape, mask):
    it = {2: jin.FeedForwardType(5), 3: jin.RecurrentType(5, 4),
          4: jin.ConvolutionalType(2, 2, 5)}[len(shape)]
    check_layer(jmisc.MaskLayer(), it, _x(shape), mask=mask)


def test_mask_layer_rejects_a_sequence_mask_on_2d_input():
    tl = _port(jmisc.MaskLayer())
    with pytest.raises(ValueError):
        tl.apply({}, {}, torch.ones(3, 4),
                 LayerContext(mask=torch.ones(3, 2)))


def test_frozen_layer_runs_in_inference_mode():
    """A frozen BatchNormalization in a train step normalizes with its
    running statistics and returns them unchanged; a frozen dense layer
    takes no dropout; both delegate their configuration."""
    jl = jmisc.FrozenLayer(underlying=jnorm.BatchNormalization(name="bn"))
    tl, _ = check_layer(jl, conv_it(2, 2, 3), _x((4, 2, 2, 3)), train=True)
    assert tl.frozen and tl.name == "bn" and tl.decay == 0.9
    st = {"mean": torch.full((3,), 0.5), "var": torch.full((3,), 2.0)}
    p = {"gamma": torch.ones(3), "beta": torch.zeros(3)}
    x = torch.from_numpy(_x((4, 2, 2, 3)))
    y, new = tl.apply(p, st, x, LayerContext(train=True))
    assert new is st
    torch.testing.assert_close(y, (x - 0.5) / torch.sqrt(
        torch.tensor(2.0 + 1e-5)))
    dense = jff.DenseLayer(n_in=4, n_out=3, dropout=0.9,
                           activation=JAct.IDENTITY)
    check_layer(jmisc.FrozenLayer(underlying=dense),
                jin.FeedForwardType(4), _x((5, 4)), train=True)


def test_cnn_loss_layer():
    from deeplearning4j_tpu_torch.nn.layers.output import CnnLossLayer
    rng = np.random.default_rng(0)
    x = _x((2, 3, 4, 5))
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 3, 4))]
    mask = (rng.uniform(size=(2, 3, 4)) > 0.3).astype(np.float32)
    for act, loss in ((JAct.SOFTMAX, JLoss.MCXENT), (JAct.SIGMOID,
                                                      JLoss.XENT),
                      (JAct.IDENTITY, JLoss.MSE)):
        for m in (None, mask):
            jl = jout.CnnLossLayer(activation=act, loss=loss)
            tl = _port(jl)
            assert isinstance(tl, CnnLossLayer)
            jx = jnp.asarray(x)
            lj = jl.compute_loss({}, {}, jx, jnp.asarray(y), JCtx(
                mask=None if m is None else jnp.asarray(m)))
            tx = torch.from_numpy(x).requires_grad_(True)
            lt = tl.compute_loss({}, {}, tx, torch.from_numpy(y),
                                 LayerContext(mask=None if m is None
                                              else torch.from_numpy(m)))
            assert lt.item() == pytest.approx(float(lj), rel=1e-5)
            gj = jax.grad(lambda xx: jl.compute_loss(
                {}, {}, xx, jnp.asarray(y), JCtx(
                    mask=None if m is None else jnp.asarray(m))))(jx)
            gt, = torch.autograd.grad(lt, tx)
            assert _rel_l2(gt.numpy(), gj) <= GRAD_RTOL


def test_center_loss_output_layer():
    """The loss and its gradients (W, b, centers, input) against JAX; the
    centers start at zero, so they are set at random first."""
    rng = np.random.default_rng(0)
    jl = jout.CenterLossOutputLayer(n_in=6, n_out=4, lambda_=0.3)
    tl = _port(jl)
    params = _init_params(jl, jin.FeedForwardType(6))
    assert params["centers"].shape == (4, 6)
    x = _x((5, 6))
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 5)]

    def jloss(p, xx):
        return jl.compute_loss(p, {}, xx, jnp.asarray(y), JCtx())
    lj, (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    lt = tl.compute_loss(tp, {}, tx, torch.from_numpy(y), LayerContext())
    assert lt.item() == pytest.approx(float(lj), rel=1e-6)
    grads = torch.autograd.grad(lt, list(tp.values()) + [tx])
    for k, g in zip(tp, grads):
        assert _rel_l2(g.numpy(), gp[k]) <= GRAD_RTOL, k
    assert _rel_l2(grads[-1].numpy(), gx) <= GRAD_RTOL
    # the forward is the output layer's
    out, _ = tl.apply(tp, {}, tx, LayerContext())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jl.apply(
        {k: jnp.asarray(v) for k, v in params.items()}, {},
        jnp.asarray(x), JCtx())[0]), rtol=FWD_TOL, atol=FWD_TOL)


# ---------------------------------------------------------------------------
# vertices
# ---------------------------------------------------------------------------

def check_vertex(jvx, jits, xs, grad=True):
    tvx = _port(jvx)
    tits = [_port(it) for it in jits]
    assert tvx.output_type(*tits).shape() == \
        jvx.output_type(*jits).shape()
    yj = jvx.apply(*[jnp.asarray(x) for x in xs])
    txs = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    yt = tvx.apply(*txs)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=FWD_TOL, atol=FWD_TOL)
    if grad:
        r = _x(np.asarray(yj).shape, 7)
        _, vjp = jax.vjp(lambda *a: jvx.apply(*a),
                         *[jnp.asarray(x) for x in xs])
        gj = vjp(jnp.asarray(r))
        gt = torch.autograd.grad((yt * torch.from_numpy(r)).sum(), txs)
        for a, b in zip(gt, gj):
            assert _rel_l2(a.numpy(), b) <= GRAD_RTOL


FF, RNN, CNN = (jin.FeedForwardType(6), jin.RecurrentType(6, 3),
                jin.ConvolutionalType(2, 3, 6))


@pytest.mark.parametrize("vertex,its,shapes", [
    (jv.StackVertex(), (FF, FF, FF), [(2, 6), (2, 6), (2, 6)]),
    (jv.UnstackVertex(from_index=1, stack_size=3), (FF,), [(6, 6)]),
    (jv.UnstackVertex(from_index=0, stack_size=2), (CNN,), [(4, 2, 3, 6)]),
    (jv.SubsetVertex(from_index=1, to_index=3), (FF,), [(2, 6)]),
    (jv.SubsetVertex(from_index=0, to_index=4), (RNN,), [(2, 3, 6)]),
    (jv.SubsetVertex(from_index=2, to_index=5), (CNN,), [(2, 2, 3, 6)]),
    (jv.ScaleVertex(scale=0.17), (CNN,), [(2, 2, 3, 6)]),
    (jv.ShiftVertex(shift=-1.5), (RNN,), [(2, 3, 6)]),
    (jv.L2NormalizeVertex(), (FF,), [(3, 6)]),
    (jv.L2NormalizeVertex(eps=1e-3), (CNN,), [(2, 2, 3, 6)]),
    (jv.L2Vertex(), (FF, FF), [(3, 6), (3, 6)]),
    (jv.L2Vertex(eps=1e-6), (CNN, CNN), [(2, 2, 3, 6), (2, 2, 3, 6)]),
    (jv.ReshapeVertex(shape=(3, 2)), (FF,), [(4, 6)]),
    (jv.ReshapeVertex(shape=(1, 2, 3)), (FF,), [(4, 6)]),
    (jv.ReshapeVertex(shape=(36,)), (CNN,), [(2, 2, 3, 6)]),
    (jv.PreprocessorVertex(preprocessor=jpp.CnnToFeedForward(2, 3, 6)),
     (CNN,), [(2, 2, 3, 6)]),
    (jv.PreprocessorVertex(preprocessor=jpp.RnnToCnn(1, 3, 6)), (RNN,),
     [(2, 3, 6)]),
])
def test_vertices(vertex, its, shapes):
    check_vertex(vertex, its, [_x(s, i) for i, s in enumerate(shapes)])


def test_l2_normalize_zero_row_uses_eps():
    tv = _port(jv.L2NormalizeVertex())
    x = torch.zeros(2, 4)
    x[1] = 3.0
    y = tv.apply(x)
    assert torch.equal(y[0], torch.zeros(4))
    torch.testing.assert_close(y[1], torch.full((4,), 0.5))


# ---------------------------------------------------------------------------
# preprocessors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pp,it,shape", [
    (jpp.FeedForwardToCnn(2, 3, 4), jin.FeedForwardType(24), (3, 24)),
    (jpp.RnnToFeedForward(5), jin.RecurrentType(5, 4), (3, 4, 5)),
    (jpp.CnnToRnn(2, 3, 4), jin.ConvolutionalType(2, 3, 4), (3, 2, 3, 4)),
    (jpp.RnnToCnn(2, 3, 4), jin.RecurrentType(12, 2), (3, 2, 12)),
])
def test_preprocessors(pp, it, shape):
    tpp = _port(pp)
    assert tpp.output_type(_port(it)).shape() == pp.output_type(it).shape()
    x = _x(shape)
    tx = torch.from_numpy(x).requires_grad_(True)
    yt = tpp.apply(tx)
    yj = np.asarray(pp.apply(jnp.asarray(x)))
    np.testing.assert_array_equal(yt.detach().numpy(), yj)
    r = _x(yj.shape, 3)
    gt, = torch.autograd.grad((yt * torch.from_numpy(r)).sum(), tx)
    _, vjp = jax.vjp(pp.apply, jnp.asarray(x))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(vjp(
        jnp.asarray(r))[0]))


@pytest.mark.parametrize("prev,layer", [
    (jin.ConvolutionalType(2, 3, 4),
     jconv.Convolution1DLayer(n_out=3)),
    (jin.ConvolutionalType(2, 3, 4), jff.DenseLayer(n_out=3)),
    (jin.ConvolutionalFlatType(4, 4, 1), jconv.Upsampling2D()),
    (jin.ConvolutionalFlatType(4, 4, 1), jconv.SpaceToBatchLayer()),
    (jin.FeedForwardType(5), jconv.Convolution1DLayer(n_out=3)),
    (jin.RecurrentType(5, 3), jff.DenseLayer(n_out=3)),
])
def test_preprocessor_inference_matches_jax(prev, layer):
    from deeplearning4j_tpu.nn.preprocessors import \
        infer_preprocessor as jinfer
    from deeplearning4j_tpu_torch.nn.preprocessors import infer_preprocessor
    want = jinfer(prev, layer)
    got = infer_preprocessor(_port(prev), _port(layer))
    if want is None:
        assert got is None
    else:
        assert tserde.to_json(got) == jserde.to_json(want)


def test_graph_of_new_vertices_round_trips_and_matches_jax():
    """A small graph through Stack/Unstack/Subset/Scale/Shift/L2/Reshape/
    Preprocessor vertices, built from the JAX configuration's JSON:
    output, loss and one Nesterovs step against the JAX graph."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.optimize.updaters import Nesterovs
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.models.serialization import (
        opt_state_from_jax, params_from_jax)
    from deeplearning4j_tpu_torch.nn.graph.config import \
        ComputationGraphConfiguration
    g = (NeuralNetConfiguration.Builder().seed(5).updater(
        Nesterovs(0.05, 0.9)).graph_builder().add_inputs("a", "b")
        .set_input_types(jin.InputType.feed_forward(6),
                         jin.InputType.feed_forward(6)))
    g.add_vertex("stack", jv.StackVertex(), "a", "b")
    g.add_layer("d1", jff.DenseLayer(n_out=8, activation=JAct.TANH),
                "stack")
    g.add_vertex("ua", jv.UnstackVertex(from_index=0, stack_size=2), "d1")
    g.add_vertex("ub", jv.UnstackVertex(from_index=1, stack_size=2), "d1")
    g.add_vertex("dist", jv.L2Vertex(), "ua", "ub")
    g.add_vertex("sub", jv.SubsetVertex(from_index=2, to_index=7), "ua")
    g.add_vertex("scaled", jv.ScaleVertex(scale=0.5), "sub")
    g.add_vertex("shifted", jv.ShiftVertex(shift=0.1), "scaled")
    g.add_vertex("norm", jv.L2NormalizeVertex(), "shifted")
    g.add_vertex("rs", jv.ReshapeVertex(shape=(1, 2, 3)), "norm")
    g.add_vertex("flat", jv.PreprocessorVertex(
        preprocessor=jpp.CnnToFeedForward(1, 2, 3)), "rs")
    g.add_vertex("cat", jv.MergeVertex(), "flat", "dist")
    g.add_layer("out", jout.OutputLayer(n_out=3, loss=JLoss.MCXENT,
                                        activation=JAct.SOFTMAX), "cat")
    g.set_outputs("out")
    conf = g.build()
    jm = JGraph(conf).init()
    tconf = ComputationGraphConfiguration.from_json(conf.to_json())
    assert tconf.to_json() == conf.to_json()
    tm = ComputationGraph(tconf, device="cpu").init()
    ts = jax.tree_util.tree_map(np.asarray, jm.train_state)
    params_from_jax(ts.params, ts.model_state, "cpu", model=tm)
    opt_state_from_jax(ts.opt_state, tm)
    rng = np.random.default_rng(2)
    a, b = _x((4, 6), 1), _x((4, 6), 2)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    np.testing.assert_allclose(tm.output(a, b).numpy(),
                               np.asarray(jm.output(a, b)), rtol=FWD_TOL,
                               atol=FWD_TOL)
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    jm.fit(JMDS([a, b], [y]))
    tm.fit(MultiDataSet([a, b], [y]))
    for ln, lp in jax.tree_util.tree_map(np.asarray,
                                         jm.train_state.params).items():
        for k, v in lp.items():
            np.testing.assert_allclose(tm.params[ln][k].numpy(), v,
                                       rtol=1e-5, atol=1e-6)
    del JDS, DataSet
