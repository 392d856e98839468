"""The "xla" arm of the fused bottleneck block against the JAX package.

``conv_bn_stats_xla`` (both statistics routes, float32 and bfloat16: y,
(Σy, Σy²) and the gradients through both outputs), the Gram function's
backward, and ``FusedBottleneckBlock(impl="xla")`` against the JAX
block (inference and a train step's gradients) and against the port's
``"pallas"`` block on the same weights (whose kernels run their plain
versions on the CPU). The JAX routes are chosen as its own tests choose
them: ``DL4J_GRAM`` set through ``monkeypatch``, then
``jax.clear_caches()``.

Bounds: float32 y and gradients within 1e-5 (rtol and atol) and 1e-4
relative L2, statistics within 1e-5 of their largest magnitude — the
same f32 math in other orders. bfloat16: y within 2e-2 (rtol and atol;
one bf16 rounding, 2^-8, may land elsewhere), the Gram route's
statistics within 1e-5 relative (both take them in f32 from the same
bf16 input, so only the f32 summation order differs), the direct route's
within 1e-2 of their largest magnitude (they sum a y whose bf16
roundings may differ by an ulp), gradients within 3e-2 relative L2.
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
from deeplearning4j_tpu.ops import fused_conv as jfc
from deeplearning4j_tpu_torch.models.base import cast_params
from deeplearning4j_tpu_torch.models.serialization import params_from_jax
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneckBlock
from deeplearning4j_tpu_torch.ops import fused_conv as fc

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
Y_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_REL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture
def jax_gram(monkeypatch):
    """Set the JAX package's route for the calls that follow."""
    def set_mode(mode):
        monkeypatch.setenv("DL4J_GRAM", mode)
        jax.clear_caches()
    yield set_mode
    jax.clear_caches()


def _inputs(kind, dtype, rng):
    n, h, w = 2, 5, 6
    cin, cout = {"expand": (8, 32), "reduce": (32, 8), "c3": (8, 8)}[kind]
    x = rng.normal(0, 1, (n, h, w, cin)).astype(np.float32)
    shape = (3, 3, cin, cout) if kind == "c3" else (cin, cout)
    wt = (rng.normal(0, 1, shape) / np.sqrt(cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    shift = rng.normal(0, 0.3, cin).astype(np.float32)
    if dtype == "bfloat16":      # values the bf16 grid holds exactly
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32))
        wt = np.array(jnp.asarray(wt).astype(jnp.bfloat16).astype(
            jnp.float32))
    return x, wt, scale, shift


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["always", "never"])
@pytest.mark.parametrize("kind,stride,flags", [
    ("expand", 1, (True, True)), ("expand", 2, (False, False)),
    ("reduce", 1, (True, True)), ("reduce", 2, (False, False)),
    ("c3", 1, (True, True)), ("c3", 1, (False, True)),
])
def test_conv_bn_stats_xla_matches_jax(kind, stride, flags, mode, dtype,
                                       jax_gram):
    relu_in, norm_in = flags
    rng = np.random.default_rng(3)
    x, wt, scale, shift = _inputs(kind, dtype, rng)
    jax_gram(mode)
    jdt, tdt = JDT[dtype], getattr(torch, dtype)

    def jf(xx, ww, sc, sh):
        return jfc.conv_bn_stats_xla(xx, ww, sc, sh, relu_in, norm_in,
                                     stride)
    jargs = (jnp.asarray(x).astype(jdt), jnp.asarray(wt).astype(jdt),
             jnp.asarray(scale), jnp.asarray(shift))
    (yj, sj), vjp = jax.vjp(jf, *jargs)
    targs = [torch.from_numpy(x).to(tdt).requires_grad_(True),
             torch.from_numpy(wt).to(tdt).requires_grad_(True),
             torch.from_numpy(scale).requires_grad_(True),
             torch.from_numpy(shift).requires_grad_(True)]
    yt, st = fc.conv_bn_stats_xla(*targs, relu_in, norm_in, stride,
                                  gram=mode)
    assert yt.dtype == tdt and st.dtype == torch.float32
    yj32 = np.asarray(yj.astype(jnp.float32))
    np.testing.assert_allclose(yt.detach().float().numpy(), yj32,
                               rtol=Y_TOL[dtype], atol=Y_TOL[dtype])
    gram_route = kind != "c3" and mode == "always"
    stats_tol = 1e-5 if dtype == "float32" or gram_route else 1e-2
    sj = np.asarray(sj)
    assert np.abs(st.detach().numpy() - sj).max() <= \
        stats_tol * np.abs(sj).max()

    dy = rng.normal(0, 1, yj32.shape).astype(np.float32)
    ds = rng.normal(0, 1, sj.shape).astype(np.float32) / yj32[..., 0].size
    gj = vjp((jnp.asarray(dy).astype(jdt), jnp.asarray(ds)))
    gt = torch.autograd.grad(
        (yt.float() * torch.from_numpy(dy)).sum()
        + (st * torch.from_numpy(ds)).sum(), targs, allow_unused=True)
    for name, a, b in zip(("dx", "dw", "dscale", "dshift"), gt, gj):
        if not norm_in and name in ("dscale", "dshift"):
            assert a is None or not a.any()
            continue
        assert _rel_l2(a.float().numpy(), np.asarray(
            b.astype(jnp.float32))) <= GRAD_REL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_is_f32_and_its_backward_matches_jax(dtype):
    """G = eᵀe comes back f32 from a bf16 e (a bf16 matmul would round
    Σy² to 8 bits); de = e·(dG + dGᵀ) in e's dtype, against JAX's VJP."""
    rng = np.random.default_rng(0)
    e = rng.normal(0, 1, (2, 3, 4, 6)).astype(np.float32)
    dg = rng.normal(0, 1, (6, 6)).astype(np.float32)
    jdt, tdt = JDT[dtype], getattr(torch, dtype)
    gj, vjp = jax.vjp(jfc._gram, jnp.asarray(e).astype(jdt))
    te = torch.from_numpy(e).to(tdt).requires_grad_(True)
    gt = fc._Gram.apply(te)
    assert gt.dtype == torch.float32
    np.testing.assert_allclose(gt.detach().numpy(), np.asarray(gj),
                               rtol=1e-5, atol=1e-5)
    e32 = te.detach().double().reshape(-1, 6)
    np.testing.assert_allclose(gt.detach().double().numpy(),
                               (e32.t() @ e32).numpy(), rtol=1e-6,
                               atol=1e-5)
    (de_j,) = vjp(jnp.asarray(dg))
    (de_t,) = torch.autograd.grad(gt, te, torch.from_numpy(dg))
    assert de_t.dtype == tdt
    np.testing.assert_allclose(de_t.float().numpy(),
                               np.asarray(de_j.astype(jnp.float32)),
                               rtol=Y_TOL[dtype], atol=Y_TOL[dtype])


def test_gram_route_rule():
    assert fc.gram_route("always") and not fc.gram_route("never")
    # the rule the H100 set: the direct route at every width
    assert not fc.gram_route("auto") and not fc.gram_route()
    with pytest.raises(ValueError):
        fc.gram_route("sometimes")
    with pytest.raises(ValueError):
        fc.conv_bn_stats_xla(torch.ones(1, 2, 2, 4), torch.ones(4, 8),
                             torch.ones(4), torch.zeros(4), gram="yes")


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


def _block_pair(stride, downsample, cin, f=8, h=6, w=6, n=3):
    rng = np.random.default_rng(11)
    jb = JBlock(filters=f, stride=stride, downsample=downsample, impl="xla")
    it = JType(h, w, cin)
    jp = jax.tree_util.tree_map(np.asarray, jb.initialize(
        jax.random.PRNGKey(0), it))
    js = jax.tree_util.tree_map(np.asarray, jb.init_state(it))
    _random_bn(jp, js, rng)
    x = rng.normal(0, 1, (n, h, w, cin)).astype(np.float32)
    params, state = params_from_jax({"b": jp}, {"b": js}, "cpu")
    return jb, jp, js, x, params["b"], state["b"]


BLOCKS = [(1, False, 32), (1, True, 16), (2, True, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,downsample,cin", BLOCKS)
def test_xla_block_inference_matches_jax(stride, downsample, cin, dtype):
    jb, jp, js, x, params, state = _block_pair(stride, downsample, cin)
    jdt, tdt = JDT[dtype], getattr(torch, dtype)
    lp = jax_cast_params(jax.tree_util.tree_map(jnp.asarray, jp), dtype)
    yj, _ = jb.apply(lp, jax.tree_util.tree_map(jnp.asarray, js),
                     jnp.asarray(x).astype(jdt), JCtx(train=False))
    tb = FusedBottleneckBlock(filters=8, stride=stride,
                              downsample=downsample, impl="xla")
    yt, new = tb.apply(cast_params(params, dtype), state,
                       torch.from_numpy(x).to(tdt), LayerContext())
    assert yt.dtype == tdt and new is state
    tol = {"float32": 1e-5, "bfloat16": 3e-2}[dtype]
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("stride,downsample,cin", BLOCKS)
def test_xla_block_train_step_matches_jax(stride, downsample, cin):
    """Train mode (batch statistics): y, the new running statistics, and
    the gradients of a random linear function of y with respect to the
    input and every parameter, f32."""
    jb, jp, js, x, params, state = _block_pair(stride, downsample, cin)
    jsj = jax.tree_util.tree_map(jnp.asarray, js)
    r = np.random.default_rng(5).normal(0, 1, (3, -(-6 // stride),
                                               -(-6 // stride), 32))

    def jf(p, xx):
        y, new = jb.apply(p, jsj, xx, JCtx(train=True))
        return jnp.sum(y * r), (y, new)
    (_, (yj, newj)), (gpj, gxj) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    tb = FusedBottleneckBlock(filters=8, stride=stride,
                              downsample=downsample, impl="xla")
    tp = {k: v.requires_grad_(True) for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    yt, newt = tb.apply(tp, state, tx, LayerContext(train=True))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-5)
    for k, v in newj.items():
        np.testing.assert_allclose(newt[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad((yt * torch.from_numpy(r).float()).sum(),
                                list(tp.values()) + [tx])
    for k, g in zip(tp, grads):
        assert _rel_l2(g.numpy(), gpj[k]) <= 1e-4, k
    assert _rel_l2(grads[-1].numpy(), gxj) <= 1e-4


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stride,downsample,cin", BLOCKS)
def test_xla_block_matches_the_pallas_block(stride, downsample, cin, train):
    """The two implementations load the same parameter tree and give the
    same block (the "pallas" block's kernels run their plain versions on
    the CPU): y, the new running statistics and, in training, the
    gradients, f32."""
    _, _, _, x, params, state = _block_pair(stride, downsample, cin)
    outs = {}
    for impl in ("xla", "pallas"):
        tb = FusedBottleneckBlock(filters=8, stride=stride,
                                  downsample=downsample, impl=impl)
        tp = {k: v.detach().clone().requires_grad_(train)
              for k, v in params.items()}
        tx = torch.from_numpy(x).requires_grad_(train)
        y, new = tb.apply(tp, state, tx, LayerContext(train=train))
        grads = (torch.autograd.grad(y.square().sum(),
                                     list(tp.values()) + [tx])
                 if train else ())
        outs[impl] = (y.detach(), new, grads)
    (ya, na, ga), (yb, nb, gb) = outs["xla"], outs["pallas"]
    torch.testing.assert_close(ya, yb, rtol=1e-5, atol=1e-5)
    for k in na:
        torch.testing.assert_close(na[k], nb[k], rtol=1e-5, atol=1e-6)
    for a, b in zip(ga, gb):
        assert _rel_l2(a.numpy(), b.numpy()) <= 1e-4
