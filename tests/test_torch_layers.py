"""The port's plain layers of the served ResNet50 (stem conv, max pool,
space-to-depth, zero padding, BatchNormalization, activation, global
pooling, output layer) against the JAX package's, on the same numpy
inputs and parameters.

float32: rtol/atol 1e-5. bfloat16: rtol/atol 2e-2 (a bf16 rounding at
another place, 2^-8 relative, can differ between the frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.layers.convolution as jconv
import deeplearning4j_tpu.nn.layers.feedforward as jff
import deeplearning4j_tpu.nn.layers.normalization as jnorm
import deeplearning4j_tpu.nn.layers.output as jout
from deeplearning4j_tpu.nn.inputs import ConvolutionalType as JType
from deeplearning4j_tpu.nn.inputs import FeedForwardType as JFF
from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
import deeplearning4j_tpu_torch.nn.layers.convolution as tconv
import deeplearning4j_tpu_torch.nn.layers.feedforward as tff
import deeplearning4j_tpu_torch.nn.layers.normalization as tnorm
import deeplearning4j_tpu_torch.nn.layers.output as tout
from deeplearning4j_tpu_torch.nn.inputs import ConvolutionalType, FeedForwardType
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _run(jlayer, tlayer, x, params, state, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    yj, _ = jlayer.apply(jp, js, jnp.asarray(x).astype(jdt),
                         JCtx(train=False))
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    yt, _ = tlayer.apply(tp, ts, torch.from_numpy(x).to(tdt), LayerContext())
    assert yt.dtype == tdt
    yj = np.asarray(yj.astype(jnp.float32))
    assert tuple(yt.shape) == yj.shape
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=TOL[dtype],
                               atol=TOL[dtype])
    return yt


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw,hw", [
    (dict(n_out=8, kernel_size=(4, 4), stride=(1, 1), padding=(0, 0),
          convolution_mode="TRUNCATE", has_bias=False), (9, 9)),
    (dict(n_out=8, kernel_size=(7, 7), stride=(2, 2),
          convolution_mode="SAME", has_bias=False), (11, 10)),
    (dict(n_out=6, kernel_size=(3, 3), stride=(1, 1),
          convolution_mode="SAME", has_bias=True), (5, 5)),
])
def test_convolution_layer(kw, hw, dtype):
    rng = np.random.default_rng(0)
    cin = 12
    kw = dict(kw)
    mode = kw.pop("convolution_mode")
    jl = jconv.ConvolutionLayer(convolution_mode=jconv.ConvolutionMode[mode],
                                **kw)
    tl = tconv.ConvolutionLayer(convolution_mode=tconv.ConvolutionMode[mode],
                                **kw)
    it = (hw[0], hw[1], cin)
    assert tl.output_type(ConvolutionalType(*it)) == \
        ConvolutionalType(*jl.output_type(JType(*it)).shape())
    k = kw["kernel_size"]
    params = {"W": rng.normal(0, 0.2, k + (cin, kw["n_out"]))
              .astype(np.float32)}
    if kw.get("has_bias"):
        params["b"] = rng.normal(0, 0.1, kw["n_out"]).astype(np.float32)
    x = rng.normal(0, 1, (2,) + it).astype(np.float32)
    _run(jl, tl, x, params, {}, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pool,mode,hw", [
    ("MAX", "SAME", (8, 8)), ("MAX", "SAME", (7, 9)),
    ("MAX", "TRUNCATE", (8, 8)), ("AVG", "SAME", (7, 7)),
    ("AVG", "TRUNCATE", (8, 8)), ("SUM", "TRUNCATE", (6, 6))])
def test_subsampling_layer(pool, mode, hw, dtype):
    """Max pooling pads with -inf: all-negative inputs catch a 0 pad."""
    kw = dict(kernel_size=(3, 3), stride=(2, 2))
    jl = jconv.SubsamplingLayer(pooling_type=jconv.PoolingType[pool],
                                convolution_mode=jconv.ConvolutionMode[mode],
                                **kw)
    tl = tconv.SubsamplingLayer(pooling_type=tconv.PoolingType[pool],
                                convolution_mode=tconv.ConvolutionMode[mode],
                                **kw)
    x = -np.abs(np.random.default_rng(1).normal(
        0, 1, (2,) + hw + (4,))).astype(np.float32) - 0.5
    _run(jl, tl, x, {}, {}, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_space_to_depth_and_zero_padding(dtype):
    x = np.random.default_rng(2).normal(0, 1, (2, 8, 6, 3)).astype(np.float32)
    _run(jconv.SpaceToDepthLayer(block_size=2),
         tconv.SpaceToDepthLayer(block_size=2), x, {}, {}, dtype)
    _run(jconv.ZeroPaddingLayer(pad=(1, 2, 0, 3)),
         tconv.ZeroPaddingLayer(pad=(1, 2, 0, 3)), x, {}, {}, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_normalization_inference(dtype):
    rng = np.random.default_rng(3)
    c = 16
    params = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "beta": rng.normal(0, 0.2, c).astype(np.float32)}
    state = {"mean": rng.normal(0, 0.5, c).astype(np.float32),
             "var": rng.uniform(0.2, 3.0, c).astype(np.float32)}
    x = rng.normal(0, 1, (2, 4, 4, c)).astype(np.float32)
    _run(jnorm.BatchNormalization(), tnorm.BatchNormalization(), x, params,
         state, dtype)
    bn = tnorm.BatchNormalization()
    st = bn.init_state(ConvolutionalType(4, 4, c))
    assert st["mean"].dtype == torch.float32 and torch.all(st["var"] == 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_activation_and_global_pooling(dtype):
    x = np.random.default_rng(4).normal(0, 1, (3, 4, 5, 6)).astype(np.float32)
    _run(jff.ActivationLayer(), tff.ActivationLayer(), x, {}, {}, dtype)
    for pool in ("AVG", "MAX", "SUM"):
        jl = jout.GlobalPoolingLayer(pooling_type=jconv.PoolingType[pool])
        tl = tout.GlobalPoolingLayer(pooling_type=tconv.PoolingType[pool])
        assert tl.output_type(ConvolutionalType(4, 5, 6)) == \
            FeedForwardType(6)
        _run(jl, tl, x, {}, {}, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_output_layer_softmax(dtype):
    rng = np.random.default_rng(5)
    params = {"W": rng.normal(0, 0.3, (32, 10)).astype(np.float32),
              "b": rng.normal(0, 0.1, 10).astype(np.float32)}
    x = rng.normal(0, 1, (4, 32)).astype(np.float32)
    y = _run(jout.OutputLayer(n_out=10), tout.OutputLayer(n_out=10), x,
             params, {}, dtype)
    np.testing.assert_allclose(y.float().sum(1).numpy(), 1.0, atol=1e-2)


def test_dense_layer_init_shapes_match_jax():
    jl = jff.DenseLayer(n_out=7)
    tl = tff.DenseLayer(n_out=7)
    jp = jl.initialize(jax.random.PRNGKey(0), JFF(5))
    tp = tl.initialize(torch.Generator().manual_seed(0), FeedForwardType(5))
    assert {k: v.shape for k, v in jp.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
