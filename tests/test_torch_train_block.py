"""The port's layers in train mode against the JAX package's: the
FusedBottleneckBlock (output, the new running statistics, and the
gradients of ``sum(tanh(y))`` with respect to every parameter), the
stem's BatchNormalization, the L1/L2 penalty and input dropout. The JAX
block's weights (with non-trivial BN affine params and running
statistics made with numpy) are carried across by ``params_from_jax``;
the JAX side runs its Pallas kernels in interpret mode.

Tolerances: output and state rtol/atol 2e-4, gradients 5e-4 — the bounds
``tests/test_fused_block.py`` holds the JAX block to against its
unfused reference (f32 math summed in other orders through three convs
and three batch normalizations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.inputs import ConvolutionalType as JType
from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
from deeplearning4j_tpu.nn.layers.fused import FusedBottleneckBlock as JBlock
from deeplearning4j_tpu_torch.models.serialization import params_from_jax
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneckBlock
from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
from deeplearning4j_tpu_torch.nn.layers.normalization import \
    BatchNormalization


def _setup(stride, downsample, cin, f=4, h=4, w=4, n=4, seed=11):
    rng = np.random.default_rng(seed)
    jb = JBlock(filters=f, stride=stride, downsample=downsample)
    it = JType(h, w, cin)
    jp = jax.tree_util.tree_map(np.asarray, jb.initialize(
        jax.random.PRNGKey(0), it))
    js = jax.tree_util.tree_map(np.asarray, jb.init_state(it))
    for k, v in list(js.items()):
        js[k] = (rng.normal(0, 0.2, v.shape) if k.endswith("mean")
                 else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
    for k, v in list(jp.items()):
        if k.endswith("gamma"):
            jp[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("beta"):
            jp[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
    x = rng.normal(0, 1, (n, h, w, cin)).astype(np.float32)
    tb = FusedBottleneckBlock(filters=f, stride=stride, downsample=downsample)
    return jb, jp, js, tb, x


def _jax_run(jb, jp, js, x):
    ctx = JCtx(train=True)
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    state = jax.tree_util.tree_map(jnp.asarray, js)

    def loss(p):
        y, st = jb.apply(p, state, jnp.asarray(x), ctx)
        return jnp.sum(jnp.tanh(y.astype(jnp.float32))), (y, st)
    (_, (y, st)), g = jax.value_and_grad(loss, has_aux=True)(params)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return np.asarray(y), np_(st), np_(g)


def _torch_run(tb, jp, js, x):
    params, state = params_from_jax({"b": jp}, {"b": js}, "cpu")
    p = {k: v.requires_grad_() for k, v in params["b"].items()}
    y, st = tb.apply(p, state["b"], torch.from_numpy(x),
                     LayerContext(train=True))
    loss = torch.tanh(y.float()).sum()
    keys = sorted(p)
    g = torch.autograd.grad(loss, [p[k] for k in keys])
    assert not any(v.requires_grad for v in st.values())
    return (y.detach().numpy(), {k: v.numpy() for k, v in st.items()},
            {k: gk.numpy() for k, gk in zip(keys, g)})


@pytest.mark.parametrize("stride,downsample,cin", [
    (1, False, 16),      # identity shortcut (cin == 4f)
    (1, True, 8),        # projection shortcut, stage 0's first block
    (2, True, 16),       # strided projection, later stages' first block
])
def test_train_block_matches_jax(stride, downsample, cin):
    jb, jp, js, tb, x = _setup(stride, downsample, cin)
    yj, sj, gj = _jax_run(jb, jp, js, x)
    yt, st, gt = _torch_run(tb, jp, js, x)
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt, yj, rtol=2e-4, atol=2e-4)
    assert set(st) == set(sj)
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=2e-4, atol=2e-4,
                                   err_msg=f"state {k}")
    assert set(gt) == set(gj)
    for k in gj:
        np.testing.assert_allclose(gt[k], gj[k], rtol=5e-4, atol=5e-4,
                                   err_msg=f"grad {k}")


def test_train_block_moves_every_running_statistic():
    """Each BN's running mean/var is updated with ``decay`` from its own
    batch statistics; the input state is left as it was."""
    jb, jp, js, tb, x = _setup(2, True, 16)
    params, state = params_from_jax({"b": jp}, {"b": js}, "cpu")
    before = {k: v.clone() for k, v in state["b"].items()}
    _, st = tb.apply(params["b"], state["b"], torch.from_numpy(x),
                     LayerContext(train=True))
    assert set(st) == {f"{bn}_{s}" for bn in ("bn1", "bn2", "bn3", "bnds")
                       for s in ("mean", "var")}
    for k, v in st.items():
        assert v.dtype == torch.float32
        assert not torch.equal(v, before[k]), k
        assert torch.equal(state["b"][k], before[k]), k


def test_batch_norm_train_matches_jax():
    """Batch statistics (f32, biased variance), the decayed running
    averages and the gradients of the stem's BN (rtol/atol 1e-5: the same
    f32 math)."""
    from deeplearning4j_tpu.nn.layers.normalization import \
        BatchNormalization as JBN
    rng = np.random.default_rng(5)
    x = rng.normal(1, 2, (3, 4, 4, 6)).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, 6).astype(np.float32),
         "beta": rng.normal(0, 0.2, 6).astype(np.float32)}
    st = {"mean": rng.normal(0, 0.2, 6).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    w = rng.normal(0, 1, x.shape).astype(np.float32)

    def jloss(pp):
        y, s = JBN().apply(pp, {k: jnp.asarray(v) for k, v in st.items()},
                           jnp.asarray(x), JCtx(train=True))
        return jnp.sum(y * w), (y, s)
    (_, (yj, sj)), gj = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    yt, stt = BatchNormalization().apply(
        tp, {k: torch.from_numpy(v) for k, v in st.items()},
        torch.from_numpy(x), LayerContext(train=True))
    gt = torch.autograd.grad((yt * torch.from_numpy(w)).sum(),
                             [tp["gamma"], tp["beta"]])
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(stt[k].numpy(), np.asarray(sj[k]),
                                   rtol=1e-5, atol=1e-5)
    for g, k in zip(gt, ("gamma", "beta")):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[k]), rtol=1e-5,
                                   atol=1e-5)


def test_regularization_loss_matches_jax():
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
    rng = np.random.default_rng(6)
    p = {"W": rng.normal(0, 1, (5, 3)).astype(np.float32),
         "b": rng.normal(0, 1, 3).astype(np.float32)}
    want = JDense(n_out=3, l1=0.01, l2=0.1).regularization_loss(
        {k: jnp.asarray(v) for k, v in p.items()})
    got = DenseLayer(n_out=3, l1=0.01, l2=0.1).regularization_loss(
        {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert DenseLayer(n_out=3).regularization_loss(
        {k: torch.from_numpy(v) for k, v in p.items()}).item() == 0.0


def test_float_dropout_only_in_training():
    """Inverted dropout of the layer input from the context's generator:
    kept entries scaled by 1/(1-p), about p of them dropped; none in
    inference."""
    layer = DenseLayer(n_out=4, dropout=0.25)
    x = torch.ones((64, 32))
    gen = torch.Generator().manual_seed(0)
    y = layer.maybe_dropout(x, LayerContext(train=True, generator=gen))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.15 < 1 - kept.float().mean().item() < 0.35
    assert layer.maybe_dropout(x, LayerContext()) is x
