"""The transformer slice against the JAX package on the CPU.

Each new layer (``LayerNormalization``, ``EmbeddingSequenceLayer``,
``LearnedPositionalEmbedding``, ``SelfAttentionLayer`` masked and causal,
``TransformerEncoderBlock``) is initialised in the JAX package, its params
carried across with ``params_from_jax`` and applied to the same seeded
numpy inputs in both packages. A narrow stack of the slice's shape
(embedding, positions, 2 pre-LN blocks of width 64 with 4 heads,
``RnnOutputLayer``; vocabulary 97, T 16, integer ids, f32, Adam at the
slice's own rate 1e-4) is held to the JAX ``MultiLayerNetwork``: output,
loss, gradients, and params and Adam moments after 3 steps. Adam turns a
gradient's last-bit noise into a step of its full size wherever the
gradient is near zero, so a larger rate would compare noise in the
params; the moments check the gradients of every step. The port attends through the plain versions
of its flash kernels (CPU tensors), the JAX package through its plain
``scaled_dot_product_attention`` (its dispatch off a TPU).

Bounds (ROADMAP's f32 defaults): outputs and loss rel 1e-5; gradients,
post-step params and moments 1e-4 of each array's largest magnitude. The
``attn_v1`` regression fixture, a pre-0.2.0 checkpoint with which-major
QKV columns and trained Adam moments, is held to its committed
``output`` and ``output_after_step`` as ``tests/test_regression_fixtures.py``
holds the JAX package (rtol 1e-5, atol 1e-6).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (
    flatten_paths, opt_state_from_jax, params_from_jax,
    restore_multi_layer_network, save_model)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.inputs import RecurrentType
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.nn.layers.feedforward import \
    EmbeddingSequenceLayer
from deeplearning4j_tpu_torch.nn.layers.normalization import \
    LayerNormalization
from deeplearning4j_tpu_torch.optimize import solver
from deeplearning4j_tpu_torch.utils.serde import from_dict, to_dict
from deeplearning4j_tpu_torch.zoo.models import WEIGHTS_DIR

REPO = WEIGHTS_DIR.parents[2]
N, T, W, HEADS, V = 3, 16, 64, 4, 97
FWD_REL, TREE_REL = 1e-5, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_jax(tree):
    from deeplearning4j_tpu.models.serialization import _flatten_with_paths
    return _flatten_with_paths(tree)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _key_bias(width, heads):
    """Which entries of a head-major packed bqkv ((head, which, dh)) are
    key biases. Softmax is invariant to a shift of every score of a row,
    so a key bias gets an exactly zero gradient: both packages compute
    rounding noise there (~1e-9), and Adam divides that noise by its own
    root mean square into steps of ±lr, so after a step those entries are
    noise of size lr on both sides and are not compared."""
    which = np.arange(3 * width).reshape(heads, 3, width // heads)
    return np.isin(np.arange(3 * width), which[:, 1].ravel())


def _close_tree(got, want, rel, what, skip_key_bias=False):
    """Nested trees compared path for path, each leaf within rel of its
    largest magnitude (with ``skip_key_bias``, a bqkv's key-bias entries
    left out: ``_key_bias``)."""
    got, want = flatten_paths(got), _flat_jax(want)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in want.items():
        v = np.asarray(v, np.float32)
        g = got[k].detach().float().cpu().numpy()
        if skip_key_bias and k.endswith("bqkv"):
            keep = ~_key_bias(v.shape[0] // 3, HEADS)
            g, v = g[keep], v[keep]
        err = np.abs(g - v).max()
        assert err <= rel * max(np.abs(v).max(), 1e-6), (what, k, err)


def _to_torch(jlayer):
    """The port's layer from the JAX layer's serialized config."""
    from deeplearning4j_tpu.utils.serde import to_dict as jax_to_dict
    return from_dict(json.loads(json.dumps(jax_to_dict(jlayer))))


def _jlayer_run(jlayer, x, mask=None, width=W, seed=0):
    """(JAX params as numpy, JAX output) of ``jlayer`` on x."""
    from deeplearning4j_tpu.nn.inputs import RecurrentType as JRT
    from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
    params = jlayer.initialize(jax.random.PRNGKey(seed), JRT(width, T))
    # non-trivial LayerNorm affine params and biases, so every leaf counts
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.normal(
            size=a.shape).astype(np.float32)), params)
    y, _ = jlayer.apply(params, {}, jnp.asarray(x), JCtx(
        mask=None if mask is None else jnp.asarray(mask)))
    return _np(params), np.asarray(y)


def _mask():
    m = np.ones((N, T), np.float32)
    m[1, 11:] = 0.0
    m[2, 5:] = 0.0
    return m


def _tparams(p):
    return params_from_jax({"l": p}, {}, "cpu")[0]["l"]


@pytest.mark.parametrize("kind", ["layernorm", "embedding", "positional"])
def test_simple_layers_match_jax(kind):
    from deeplearning4j_tpu.nn.layers import attention as jatt
    from deeplearning4j_tpu.nn.layers import feedforward as jff
    from deeplearning4j_tpu.nn.layers import normalization as jnorm
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (N, T, W)).astype(np.float32)
    if kind == "layernorm":
        jl = jnorm.LayerNormalization()
    elif kind == "positional":
        jl = jatt.LearnedPositionalEmbedding(max_len=20)
    else:
        jl = jff.EmbeddingSequenceLayer(n_in=V, n_out=W)
        x = rng.integers(0, V, (N, T)).astype(np.int32)
    jp, want = _jlayer_run(jl, x)
    tl = _to_torch(jl)
    y, _ = tl.apply(_tparams(jp), {}, torch.tensor(x), LayerContext())
    _close(y, want, FWD_REL, kind)
    if kind == "embedding":
        # a trailing 1 is squeezed; float32 ids are exact
        y1, _ = tl.apply(_tparams(jp), {}, torch.tensor(x[..., None])
                         .float(), LayerContext())
        _close(y1, want, FWD_REL, "embedding (N, T, 1)")


@pytest.mark.parametrize("causal,masked", [(False, True), (True, False),
                                           (True, True)])
def test_self_attention_layer_matches_jax(causal, masked):
    from deeplearning4j_tpu.nn.layers.attention import SelfAttentionLayer
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (N, T, W)).astype(np.float32)
    mask = _mask() if masked else None
    jl = SelfAttentionLayer(n_in=W, n_out=W, n_heads=HEADS, causal=causal)
    jp, want = _jlayer_run(jl, x, mask)
    tl = _to_torch(jl)
    ctx = LayerContext(mask=None if mask is None else torch.tensor(mask))
    y, _ = tl.apply(_tparams(jp), {}, torch.tensor(x), ctx)
    _close(y, want, FWD_REL, "self-attention")
    # q, k, v are strided views of the packed projection: no copy
    q, k, v = tl._qkv(_tparams(jp), torch.tensor(x))
    assert q.stride(-1) == 1 and q.data_ptr() + W // HEADS * 4 == \
        k.data_ptr()


def test_transformer_block_matches_jax():
    from deeplearning4j_tpu.nn.layers.attention import \
        TransformerEncoderBlock
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (N, T, W)).astype(np.float32)
    mask = _mask()
    jl = TransformerEncoderBlock(n_in=W, n_out=W, n_heads=HEADS)
    jp, want = _jlayer_run(jl, x, mask)
    assert set(jp) == {"attn", "ln1", "ln2", "W1", "b1", "W2", "b2"}
    tl = _to_torch(jl)
    init = tl.initialize(torch.Generator().manual_seed(0),
                         RecurrentType(W, T))
    assert {k: tuple(v.shape) for k, v in flatten_paths(init).items()} == \
        {k: v.shape for k, v in _flat_jax(jp).items()}
    y, _ = tl.apply(_tparams(jp), {}, torch.tensor(x),
                    LayerContext(mask=torch.tensor(mask)))
    _close(y, want, FWD_REL, "block")
    assert not y[2, 5:].any()


# ---- the narrow stack of the slice's shape ------------------------------

def _jax_conf(compute="float32"):
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.attention import (
        LearnedPositionalEmbedding, TransformerEncoderBlock)
    from deeplearning4j_tpu.nn.layers.feedforward import \
        EmbeddingSequenceLayer as JEmb
    from deeplearning4j_tpu.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu.optimize.updaters import Adam
    b = (NeuralNetConfiguration.Builder().seed(1).updater(Adam(1e-4))
         .compute_dtype(compute).list()
         .layer(JEmb(n_in=V, n_out=W))
         .layer(LearnedPositionalEmbedding(max_len=T)))
    for _ in range(2):
        b = b.layer(TransformerEncoderBlock(n_out=W, n_heads=HEADS,
                                            ffn_mult=4))
    return (b.layer(RnnOutputLayer(n_out=V))
            .set_input_type(InputType.recurrent(1, T)).build())


def _pair(seed=0):
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    jconf = _jax_conf()
    jm = JMLN(jconf).init()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    ts = jm.train_state
    params_from_jax(_np(ts.params), _np(ts.model_state), "cpu", model=tm)
    opt_state_from_jax(_np(ts.opt_state), tm)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (N, T)).astype(np.int32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (N, T))]
    return jm, tm, x, y, _mask()


def _jax_ds(x, y, m=None):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    return JDataSet(x, y, m)


def test_stack_configuration_round_trips_with_jax():
    from deeplearning4j_tpu.nn.config import \
        MultiLayerConfiguration as JConf
    jconf = _jax_conf()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    back = JConf.from_json(conf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert [getattr(l, "n_in", None) for l in conf.layers] == \
        [V, None, W, W, W]
    for layer in conf.layers:
        assert from_dict(to_dict(layer)) == layer


@pytest.mark.parametrize("masked", [False, True])
def test_stack_output_loss_and_gradients_match_jax(masked):
    jm, tm, x, y, m = _pair()
    fm = m if masked else None
    assert tm.num_params() == jm.num_params()
    _close(tm.output(x, mask=fm), jm.output(x, mask=fm), FWD_REL, "output")
    jloss = float(jm.compute_loss(_jax_ds(x, y, fm)))
    ts = jm.train_state
    jgrads = jax.grad(lambda p: jm._loss(
        p, ts.model_state, jnp.asarray(x), jnp.asarray(y),
        None if fm is None else jnp.asarray(fm), None, None,
        ts.iteration)[0])(ts.params)
    loss, _, grads = solver.value_and_grad(
        tm._loss, tm.train_state, *tm._step_args(DataSet(x, y, fm)))
    assert float(loss) == pytest.approx(jloss, rel=FWD_REL)
    _close_tree(grads, _np(jgrads), TREE_REL, "grads")
    # the key biases' gradients are rounding noise in both packages
    kb = _key_bias(W, HEADS)
    for tree in (flatten_paths(grads), _flat_jax(_np(jgrads))):
        for k in ("layer_2/attn/bqkv", "layer_3/attn/bqkv"):
            g = np.abs(np.asarray(tree[k], np.float32))
            assert g[kb].max() <= 1e-6 * g.max()


def test_stack_three_adam_steps_match_jax():
    jm, tm, x, y, m = _pair(seed=1)
    for _ in range(3):
        jm.fit(_jax_ds(x, y, m))
        tm.fit(DataSet(x, y, m))
        assert tm.score() == pytest.approx(float(jm.score()), rel=FWD_REL)
    ts = jm.train_state
    _close_tree(tm.params, _np(ts.params), TREE_REL, "params", True)
    _close_tree(tm.opt_state, _np(ts.opt_state), TREE_REL, "opt_state",
                True)
    assert tm.iteration == 3


def test_l2_reaches_nested_params():
    """L1/L2 classify a block's nested leaves by their key, as the JAX
    package does (``bqkv``, ``b1`` and ``gamma`` are not bias keys there)."""
    from deeplearning4j_tpu.nn.layers.attention import \
        TransformerEncoderBlock
    jl = TransformerEncoderBlock(n_in=8, n_out=8, n_heads=2, l1=1e-3,
                                 l2=1e-2)
    from deeplearning4j_tpu.nn.inputs import RecurrentType as JRT
    jp = jl.initialize(jax.random.PRNGKey(0), JRT(8, 4))
    jp = jax.tree_util.tree_map(lambda a: a + 0.5, jp)
    want = float(jl.regularization_loss(jp))
    got = _to_torch(jl).regularization_loss(_tparams(_np(jp)))
    assert float(got) == pytest.approx(want, rel=1e-6)


# ---- checkpoints ---------------------------------------------------------

def _attn_v1():
    res = REPO / "tests" / "resources" / "regression"
    exp = json.loads((res / "expected_outputs.json").read_text())["attn_v1"]
    return str(res / "attn_v1.zip"), exp


def test_attn_v1_fixture_restores_with_its_qkv_migration():
    path, exp = _attn_v1()
    model = restore_multi_layer_network(path, device="cpu",
                                        load_updater=True)
    assert model.iteration == 3
    assert "#0/.mu/layer_1/attn/Wqkv" in flatten_paths(model.opt_state)
    x = np.asarray(exp["input"], np.float32)
    _close(model.output(x), exp["output"], 1e-5, "output")
    np.testing.assert_allclose(model.output(x).numpy(),
                               np.asarray(exp["output"]), rtol=1e-5,
                               atol=1e-6)
    # one more step from the migrated params AND moments reproduces the
    # never-serialized model's output
    model.fit(DataSet(x, np.asarray(exp["labels"], np.float32)))
    np.testing.assert_allclose(model.output(x).numpy(),
                               np.asarray(exp["output_after_step"]),
                               rtol=1e-5, atol=1e-6)


def test_attn_v1_without_migration_would_differ(tmp_path):
    """The migration matters: the same arrays read as head-major give
    another output."""
    import zipfile
    path, exp = _attn_v1()
    tagged = str(tmp_path / "tagged.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(tagged, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                meta = json.loads(data)
                meta["qkv_layout"] = "head_major"
                data = json.dumps(meta).encode()
            dst.writestr(name, data)
    model = restore_multi_layer_network(tagged, device="cpu")
    out = model.output(np.asarray(exp["input"], np.float32)).numpy()
    assert not np.allclose(out, np.asarray(exp["output"]), atol=1e-4)


def test_nested_params_round_trip(tmp_path):
    _, tm, x, y, m = _pair(seed=2)
    tm.fit(DataSet(x, y, m))
    path = str(tmp_path / "stack.zip")
    save_model(tm, path, save_updater=True)
    back = restore_multi_layer_network(path, device="cpu", load_updater=True)
    assert back.iteration == 1
    for a, b in ((tm.params, back.params), (tm.opt_state, back.opt_state)):
        fa, fb = flatten_paths(a), flatten_paths(b)
        assert set(fa) == set(fb) and "layer_2/attn/Wqkv" in \
            flatten_paths(tm.params)
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    torch.testing.assert_close(back.output(x, mask=m), tm.output(x, mask=m),
                               rtol=0, atol=0)
    # the JAX package reads the port's nested zip
    from deeplearning4j_tpu.models.serialization import \
        restore_multi_layer_network as jax_restore
    jm = jax_restore(path, load_updater=True)
    _close(tm.output(x, mask=m), jm.output(x, mask=m), FWD_REL, "jax read")


def test_bf16_float_ids_raise():
    conf = MultiLayerConfiguration.from_json(_jax_conf("bfloat16").to_json())
    tm = MultiLayerNetwork(conf, device="cpu").init()
    ids = np.random.default_rng(0).integers(0, V, (N, T))
    with pytest.raises(TypeError, match="integer tensor"):
        tm.output(ids.astype(np.float32))
    out = tm.output(ids)                     # integer ids pass through
    assert out.shape == (N, T, V) and torch.isfinite(out.float()).all()
    layer = EmbeddingSequenceLayer(n_in=V, n_out=4)
    w = {"W": torch.zeros((V, 4))}
    with pytest.raises(TypeError, match="bfloat16"):
        layer.apply(w, {}, torch.tensor(ids).bfloat16(), LayerContext())
    assert isinstance(conf.layers[2], tatt.TransformerEncoderBlock)
    assert isinstance(tatt.TransformerEncoderBlock(n_out=8)._parts()[1],
                      LayerNormalization)
