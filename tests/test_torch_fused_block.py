"""The port's FusedBottleneckBlock (inference) against the JAX package's,
with the JAX block's parameters carried across by ``params_from_jax`` and
non-trivial BN running statistics made with numpy.

float32: rtol/atol 1e-5 (the same f32 math in another summation order).
bfloat16: rtol/atol 3e-2 — parameters and activations are bf16 on both
sides, but XLA on the CPU may keep the block tail's intermediates in f32
where PyTorch rounds after every op (a few bf16 ulps, 2^-8 each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.base import cast_params as jax_cast_params
from deeplearning4j_tpu.nn.inputs import ConvolutionalType as JType
from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
from deeplearning4j_tpu.nn.layers.fused import FusedBottleneckBlock as JBlock
from deeplearning4j_tpu_torch.models.base import cast_params
from deeplearning4j_tpu_torch.models.serialization import params_from_jax
from deeplearning4j_tpu_torch.nn.inputs import ConvolutionalType
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneckBlock

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _random_bn(params, state, rng):
    for k, v in list(state.items()):
        if k.endswith("mean"):
            state[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        else:
            state[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    for k, v in list(params.items()):
        if k.endswith("gamma"):
            params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("beta"):
            params[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,downsample,cin", [
    (1, False, 32),      # identity shortcut (cin == 4f)
    (1, True, 16),       # projection shortcut, stage 0's first block
    (2, True, 32),       # strided projection, later stages' first block
])
def test_block_matches_jax(stride, downsample, cin, dtype):
    f, h, w, n = 8, 6, 6, 3
    rng = np.random.default_rng(11)
    jb = JBlock(filters=f, stride=stride, downsample=downsample)
    jp = jax.tree_util.tree_map(np.asarray, jb.initialize(
        jax.random.PRNGKey(0), JType(h, w, cin)))
    js = jax.tree_util.tree_map(np.asarray, jb.init_state(JType(h, w, cin)))
    _random_bn(jp, js, rng)
    x = rng.normal(0, 1, (n, h, w, cin)).astype(np.float32)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    lp = jax_cast_params(jax.tree_util.tree_map(jnp.asarray, jp), dtype)
    yj, _ = jb.apply(lp, jax.tree_util.tree_map(jnp.asarray, js),
                     jnp.asarray(x).astype(jdt), JCtx(train=False))
    yj = np.asarray(yj.astype(jnp.float32))

    tb = FusedBottleneckBlock(filters=f, stride=stride,
                              downsample=downsample)
    params, state = params_from_jax({"b": jp}, {"b": js}, "cpu")
    tdt = getattr(torch, dtype)
    yt, new_state = tb.apply(cast_params(params["b"], dtype), state["b"],
                             torch.from_numpy(x).to(tdt), LayerContext())
    assert yt.dtype == tdt and new_state is state["b"]
    assert tuple(yt.shape) == yj.shape == (n, -(-h // stride),
                                           -(-w // stride), 4 * f)
    assert tb.output_type(ConvolutionalType(h, w, cin)) == \
        ConvolutionalType(-(-h // stride), -(-w // stride), 4 * f)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("downsample", [False, True])
def test_params_and_state_names_match_jax(downsample):
    it = (8, 8, 32)
    jb = JBlock(filters=8, stride=1, downsample=downsample)
    tb = FusedBottleneckBlock(filters=8, stride=1, downsample=downsample)
    jp = jb.initialize(jax.random.PRNGKey(0), JType(*it))
    tp = tb.initialize(torch.Generator().manual_seed(0),
                       ConvolutionalType(*it))
    assert {k: tuple(v.shape) for k, v in jp.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    js = jb.init_state(JType(*it))
    ts = tb.init_state(ConvolutionalType(*it))
    assert {k: tuple(v.shape) for k, v in js.items()} == \
        {k: tuple(v.shape) for k, v in ts.items()}


def test_kernel_calls_describe_the_forward():
    tb = FusedBottleneckBlock(filters=8, stride=2, downsample=True)
    calls = tb.kernel_calls(ConvolutionalType(6, 6, 16), batch=4)
    assert [c.kernel for c in calls] == ["fused_mm", "fused_c3",
                                         "fused_mm", "fused_mm"]
    assert calls[0].x_shape == (4, 6, 6, 16) and calls[0].stride == 2
    assert calls[1].x_shape == (4, 3, 3, 8) and calls[1].norm_in
    assert calls[3].w_shape == (16, 32) and not calls[3].norm_in


def test_training_forward_is_not_ported():
    tb = FusedBottleneckBlock(filters=4, stride=1, downsample=True)
    it = ConvolutionalType(4, 4, 8)
    p = tb.initialize(torch.Generator().manual_seed(0), it)
    with pytest.raises(NotImplementedError):
        tb.apply(p, tb.init_state(it), torch.zeros((1, 4, 4, 8)),
                 LayerContext(train=True))
    with pytest.raises(NotImplementedError):
        FusedBottleneckBlock(impl="xla")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_inference_state_gives_the_same_bits(dtype):
    """The serving engine folds each BN's scale/shift once at commit; the
    forward on the folded state must equal the per-call folding."""
    it = ConvolutionalType(5, 5, 16)
    tb = FusedBottleneckBlock(filters=4, stride=2, downsample=True)
    p = cast_params(tb.initialize(torch.Generator().manual_seed(1), it),
                    dtype)
    st = tb.init_state(it)
    rng = np.random.default_rng(2)
    st = {k: torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                              .astype(np.float32)) for k, v in st.items()}
    x = torch.from_numpy(rng.normal(0, 1, (2, 5, 5, 16)).astype(
        np.float32)).to(getattr(torch, dtype))
    folded = tb.fold_inference_state(p, st)
    assert {"bn1_scale", "bnds_shift", "in_scale"} <= set(folded)
    assert set(st) < set(folded) and "bn1_scale" not in st
    y0, _ = tb.apply(p, st, x, LayerContext())
    y1, _ = tb.apply(p, folded, x, LayerContext())
    assert torch.equal(y0, y1)
