"""Megatron tensor parallelism of the port against the JAX package.

The JAX side plans with ``plan_tp`` on meshes over the eight virtual CPU
devices (tests/conftest.py) and trains its replicated model, the golden
reference its own tests hold its tensor-parallel step to
(tests/test_tensor_parallel.py, tests/test_tp_conv_lstm.py); the MLP also
runs the JAX wrapper with ``tensor_parallel()``. The port's side is four
gloo ranks spawned once for the module on a {data 2, model 2} mesh
(tests/torch_model_parallel_workers.py): ``ParallelWrapper(
tensor_parallel=True)`` over the same global batches, from the same
weights (the port's seeded init, carried into the JAX model), its split
trees gathered whole after the fit.

- the plans: every paired layer's partition spec equals the JAX plan's
  (the MLP at model 4, the transformer, the hidden-major LSTM, a
  ResNet50's bottleneck chains with their BN state, the imported BERT's
  attention); the layers the JAX plan splits by its fallback column rule
  stay whole in the port, and the plan names them;
- training: the MLP (3 epochs), the two-block transformer (one step, its
  heads and FFN split, class-split logits), the bottleneck conv chain (2
  epochs, BN split by channel), the hidden-major LSTM (one step);
- the imported BERT graph at its toy size: the split forward;
- the census of one transformer step.

Bounds: outputs within 1e-5 of their largest entry, parameters after the
steps within rel 1e-4 of each leaf's largest magnitude.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_model_parallel_workers as W
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.datasets.fetchers import IrisDataSetIterator
from deeplearning4j_tpu.parallel.mesh import create_mesh as jmesh
from deeplearning4j_tpu.parallel.tensor_parallel import plan_tp as jplan
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper as JWrapper
from deeplearning4j_tpu_torch.models.serialization import save_model
from deeplearning4j_tpu_torch.parallel.mesh import create_mesh
from deeplearning4j_tpu_torch.parallel.tensor_parallel import plan_tp

torch.set_num_threads(1)

RANKS = 4
AXES = {"data": 2, "model": 2}
FWD = 1e-5
REL = 1e-4
JAX, PORT = "deeplearning4j_tpu", "deeplearning4j_tpu_torch"


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def mlp_conf(pkg, grad_norm="none"):
    act = _m(pkg, "ops.activations").Activation
    ff = _m(pkg, "nn.layers.feedforward")
    return (_m(pkg, "nn.config").NeuralNetConfiguration.Builder().seed(7)
            .updater(_m(pkg, "optimize.updaters").Sgd(0.1))
            .gradient_normalization(grad_norm).list()
            .layer(ff.DenseLayer(n_out=16, activation=act.TANH))
            .layer(ff.DenseLayer(n_out=16, activation=act.RELU))
            .layer(_m(pkg, "nn.layers.output").OutputLayer(n_out=3))
            .set_input_type(_m(pkg, "nn.inputs").InputType.feed_forward(4))
            .build())


def transformer_conf(pkg, vocab=12, width=8, classes=4):
    # SGD: a key bias's gradient is exactly zero (softmax shift
    # invariance), which Adam would turn into ±lr steps of noise
    at = _m(pkg, "nn.layers.attention")
    return (_m(pkg, "nn.config").NeuralNetConfiguration.Builder().seed(3)
            .updater(_m(pkg, "optimize.updaters").Sgd(0.05)).list()
            .layer(_m(pkg, "nn.layers.feedforward").EmbeddingSequenceLayer(
                n_in=vocab, n_out=width))
            .layer(at.TransformerEncoderBlock(n_out=width, n_heads=2))
            .layer(at.TransformerEncoderBlock(n_out=width, n_heads=2))
            .layer(_m(pkg, "nn.layers.output").RnnOutputLayer(
                n_out=classes))
            .set_input_type(_m(pkg, "nn.inputs").InputType.recurrent(1, 6))
            .build())


def lstm_conf(pkg, hidden=16, gate_layout="hidden_major"):
    rec = _m(pkg, "nn.layers.recurrent")
    return (_m(pkg, "nn.config").NeuralNetConfiguration.Builder().seed(9)
            .updater(_m(pkg, "optimize.updaters").Sgd(0.05)).list()
            .layer(rec.LSTM(n_out=hidden, gate_layout=gate_layout))
            .layer(rec.LSTM(n_out=hidden, gate_layout=gate_layout))
            .layer(_m(pkg, "nn.layers.output").RnnOutputLayer(n_out=3))
            .set_input_type(_m(pkg, "nn.inputs").InputType.recurrent(6, 5))
            .build())


def bottleneck_conf(pkg, filters=8, classes=4):
    """tests/test_tp_conv_lstm.py's bottleneck (a/b/c convs, BNs, a
    downsample shortcut) and head."""
    conv = _m(pkg, "nn.layers.convolution")
    act = _m(pkg, "ops.activations").Activation
    ff = _m(pkg, "nn.layers.feedforward")
    out = _m(pkg, "nn.layers.output")
    bn_cls = _m(pkg, "nn.layers.normalization").BatchNormalization
    g = (_m(pkg, "nn.config").NeuralNetConfiguration.Builder().seed(5)
         .updater(_m(pkg, "optimize.updaters").Sgd(0.01)).graph_builder()
         .add_inputs("in")
         .set_input_types(_m(pkg, "nn.inputs").InputType.convolutional(
             8, 8, 6)))

    def conv_bn(name, src, n_out, k, relu=True):
        g.add_layer(f"{name}_conv", conv.ConvolutionLayer(
            n_out=n_out, kernel_size=k, stride=(1, 1),
            convolution_mode=conv.ConvolutionMode.SAME, has_bias=False,
            activation=act.IDENTITY), src)
        g.add_layer(f"{name}_bn", bn_cls(), f"{name}_conv")
        if not relu:
            return f"{name}_bn"
        g.add_layer(f"{name}_act", ff.ActivationLayer(activation=act.RELU),
                    f"{name}_bn")
        return f"{name}_act"

    x = conv_bn("a", "in", filters, (1, 1))
    x = conv_bn("b", x, filters, (3, 3))
    x = conv_bn("c", x, filters * 4, (1, 1), relu=False)
    sc = conv_bn("ds", "in", filters * 4, (1, 1), relu=False)
    g.add_vertex("add", _m(pkg, "nn.graph.vertices").ElementWiseVertex(
        op="add"), x, sc)
    g.add_layer("out_act", ff.ActivationLayer(activation=act.RELU), "add")
    g.add_layer("pool", out.GlobalPoolingLayer(), "out_act")
    g.add_layer("out", out.OutputLayer(
        n_out=classes, loss=_m(pkg, "ops.losses").LossFunction.MCXENT,
        activation=act.SOFTMAX), "pool")
    g.set_outputs("out")
    return g.build()


def _model(pkg, conf):
    graph = not hasattr(conf, "layers")
    cls = (_m(pkg, "models.computation_graph").ComputationGraph if graph
           else _m(pkg, "models.multi_layer_network").MultiLayerNetwork)
    return cls(conf, device="cpu") if pkg == PORT else cls(conf)


def _jax_twin(conf_fn, tm):
    """The JAX model of ``conf_fn`` holding the port model's weights and
    BN state, with fresh updater state."""
    from deeplearning4j_tpu.optimize.solver import TrainState as JTS
    jm = _model(JAX, conf_fn(JAX))
    tree = lambda t: {k: tree(v) if isinstance(v, dict)
                      else jnp.asarray(v.numpy()) for k, v in t.items()}
    params = tree(tm.params)
    jm._tx = jm._make_tx()
    jm._rng = jax.random.fold_in(jax.random.PRNGKey(1), 0x5eed)
    jm.train_state = JTS(params, tree(tm.model_state), jm._tx.init(params),
                         jnp.zeros((), jnp.int32))
    return jm


def _transformer_data():
    rng = np.random.default_rng(0)
    n, t, vocab, classes = 16, 6, 12, 4
    x = rng.integers(0, vocab, (n, t)).astype(np.float32)
    y = np.zeros((n, t, classes), np.float32)
    y[np.arange(n)[:, None], np.arange(t)[None, :],
      rng.integers(0, classes, (n, t))] = 1.0
    return [(x, y)]


def _conv_data():
    rng = np.random.default_rng(0)
    return [(rng.normal(0, 1, (16, 8, 8, 6)).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)])]


def _lstm_data():
    rng = np.random.default_rng(3)
    y = np.zeros((8, 5, 3), np.float32)
    y[np.arange(8)[:, None], np.arange(5)[None, :],
      rng.integers(0, 3, (8, 5))] = 1.0
    return [(rng.normal(0, 1, (8, 5, 6)).astype(np.float32), y)]


def _iris():
    return [(np.asarray(b.features), np.asarray(b.labels))
            for b in IrisDataSetIterator(batch_size=64)]


# name: (conf, batches, epochs, census)
FITS = {"mlp": (mlp_conf, _iris, 3, False),
        "transformer": (transformer_conf, _transformer_data, 1, True),
        "conv_chain": (bottleneck_conf, _conv_data, 2, False),
        "lstm": (lstm_conf, _lstm_data, 1, False)}

BERT = dict(seq_len=8, vocab=32, width=16, n_layers=2, n_heads=2, ffn=32,
            max_len=8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tensor_parallel"))
    spec, twins, data = [], {}, {}
    for name, (conf_fn, batches, epochs, census) in FITS.items():
        tm = _model(PORT, conf_fn(PORT)).init()
        zpath = f"{root}/{name}.zip"
        save_model(tm, zpath, save_updater=True)
        data[name] = batches()
        np.savez(f"{root}/{name}.npz", **{
            f"{a}{i}": arr for i, b in enumerate(data[name])
            for a, arr in zip("xy", b)})
        twins[name] = (conf_fn, tm)
        spec.append({"kind": "tp_fit", "name": name, "zip": zpath,
                     "data": f"{root}/{name}.npz", "axes": AXES,
                     "epochs": epochs, "census": census,
                     "int8": name == "mlp"})
    bert = _bert(root)
    spec.append({"kind": "tp_output", "name": "bert", "zip": bert["zip"],
                 "data": bert["inputs"], "axes": AXES})
    group = W.SpawnedGroup(root, spec, RANKS, "tp")
    yield {"group": group, "twins": twins, "data": data, "bert": bert}
    group.join()


def _bert(root):
    """The imported BERT graph at the JAX test's toy size, from one Keras
    file into both packages."""
    pytest.importorskip("keras")
    from deeplearning4j_tpu.modelimport.bert import example_inputs
    from deeplearning4j_tpu.modelimport.keras import \
        import_keras_model_and_weights as jimport
    from deeplearning4j_tpu_torch.modelimport.bert import import_bert_base
    h5 = f"{root}/bert.h5"
    tm, _ = import_bert_base(h5_path=h5, device="cpu", **BERT)
    zpath = f"{root}/bert.zip"
    save_model(tm, zpath)
    ids, pos = example_inputs(8, BERT["seq_len"], BERT["vocab"])
    np.savez(f"{root}/bert_inputs.npz", a_ids=ids, b_pos=pos)
    return {"zip": zpath, "inputs": f"{root}/bert_inputs.npz",
            "jax": jimport(h5), "port": tm, "ids": ids, "pos": pos}


def _ranks(world, name):
    out = world["group"].out()
    with open(f"{out}/{name}.json") as f:
        info = json.load(f)
    return W.unflat(dict(np.load(f"{out}/{name}.npz"))), info


def _assert_trees(got, want, what):
    got, want = W.flat(got), W.flat(want)
    assert set(got) == set(want), what
    for k in want:
        w = np.asarray(want[k])
        err = np.abs(got[k] - w).max()
        assert err <= REL * max(np.abs(w).max(), 1e-30), (what, k, err)


def _spec_of(jsharding):
    return tuple(jsharding.spec)


def _paired_specs_equal(tplan, jplan_, names):
    """Every leaf of the named layers has the JAX plan's spec."""
    for name in names:
        jsub = jplan_.param_shardings[name]
        tsub = tplan.param_shardings[name]
        leaves = jax.tree_util.tree_leaves_with_path(
            jsub, is_leaf=lambda s: hasattr(s, "spec"))
        for path, js in leaves:
            node = tsub
            for p in path:
                node = node[p.key]
            assert node == _spec_of(js), (name, path, node, js.spec)


def test_plan_pairs_consecutive_dense():
    """layer_0 opens a column pair, layer_1 closes it row-parallel, the
    3-class output layer (not divisible by 4) stays whole."""
    tm = _model(PORT, mlp_conf(PORT)).init()
    jm = _model(JAX, mlp_conf(JAX)).init()
    tp = plan_tp(tm, create_mesh({"data": 2, "model": 4}, range(8)))
    jp = jplan(jm, jmesh({"data": 2, "model": 4}))
    _paired_specs_equal(tp, jp, ["layer_0", "layer_1", "layer_2"])
    assert tp.param_shardings["layer_0"]["W"] == (None, "model")
    assert tp.act_kinds == {k: v for k, v in jp.act_kinds.items()}
    assert tp.parts == {"layer_0": {"dense:col"},
                        "layer_1": {"dense:row"}}


@pytest.mark.parametrize("kind", ["renormalize_l2", "clip_l2_per_layer",
                                  "clip_l2_global"])
def test_norm_based_gradient_normalization_refuses_split_leaves(kind):
    """A rank holds only slices of the split leaves, so an L2 norm over a
    leaf or over all of them is refused before anything is split; on a
    mesh whose model axis is 1 nothing splits and the state stays
    whole."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
        shard_train_state
    tm = _model(PORT, mlp_conf(PORT, kind)).init()
    whole = tm.params["layer_0"]["W"]
    with pytest.raises(ValueError, match=kind):
        shard_train_state(tm, plan_tp(tm, create_mesh(
            {"data": 4, "model": 2}, range(8))))
    assert tm.params["layer_0"]["W"] is whole
    shard_train_state(tm, plan_tp(tm, create_mesh({"data": 8, "model": 1},
                                                  range(8))))
    assert tm.params["layer_0"]["W"].shape == whole.shape


def test_plan_transformer_block_megatron_layout():
    tm = _model(PORT, transformer_conf(PORT)).init()
    jm = _model(JAX, transformer_conf(JAX)).init()
    tp = plan_tp(tm, create_mesh({"data": 4, "model": 2}, range(8)))
    jp = jplan(jm, jmesh({"data": 4, "model": 2}))
    _paired_specs_equal(tp, jp, ["layer_0", "layer_1", "layer_2",
                                 "layer_3"])
    assert tp.param_shardings["layer_1"]["attn"]["Wqkv"] == (None, "model")
    assert tp.parts["layer_1"] == {"attn:col", "attn:row", "ffn:col",
                                   "ffn:row"}
    # the class-split logits are gathered whole before the loss
    assert tp.parts["layer_3"] == {"dense:col", "dense:gather_out"}


def test_plan_hidden_major_lstm():
    tm = _model(PORT, lstm_conf(PORT)).init()
    jm = _model(JAX, lstm_conf(JAX)).init()
    tp = plan_tp(tm, create_mesh({"data": 4, "model": 2}, range(8)))
    jp = jplan(jm, jmesh({"data": 4, "model": 2}))
    _paired_specs_equal(tp, jp, ["layer_0", "layer_1"])
    assert tp.parts["layer_0"] == {"lstm:col", "lstm:gather_out"}
    # gate-major LSTMs: the JAX fallback column rule, whole in the port
    tm = _model(PORT, lstm_conf(PORT, gate_layout="gate_major")).init()
    tp = plan_tp(tm, create_mesh({"data": 4, "model": 2}, range(8)))
    assert tp.fallback == {"layer_0": "replicated",
                           "layer_1": "replicated"}
    assert tp.param_shardings["layer_0"]["Wx"] == ()


@pytest.mark.parametrize("conf_fn", [mlp_conf, lstm_conf, bottleneck_conf])
def test_infer_param_shardings_matches_jax(conf_fn):
    """The round-1 column rules over the model axis, leaf by leaf."""
    from deeplearning4j_tpu.parallel.sharding import \
        infer_param_shardings as jinfer
    from deeplearning4j_tpu_torch.parallel.sharding import \
        infer_param_shardings
    tm = _model(PORT, conf_fn(PORT)).init()
    jm = _model(JAX, conf_fn(JAX)).init()
    got = infer_param_shardings(tm.params, create_mesh(
        {"data": 4, "model": 2}, range(8)))
    want = jinfer(jm.params, jmesh({"data": 4, "model": 2}))
    jflat = {"/".join(p.key for p in path): tuple(s.spec) for path, s in
             jax.tree_util.tree_leaves_with_path(
                 want, is_leaf=lambda s: hasattr(s, "spec"))}
    tflat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                tflat[path] = v
    walk(got, "")
    assert tflat == jflat
    assert any(s for s in tflat.values())


def test_conv_chain_plan_pairs_bottlenecks():
    """A ResNet50's bottleneck chains (tests/test_tp_conv_lstm.py): a/b
    column-, c row-split, the in-chain BNs' params and running
    statistics by channel; the downsample convs are the JAX fallback rule,
    whole in the port."""
    zoo = lambda pkg: _m(pkg, "zoo.models").ResNet50(
        num_classes=4, height=32, width=32, channels=3, seed=5,
        updater=_m(pkg, "optimize.updaters").Sgd(1e-3))
    tm = zoo(PORT).init(device="cpu")
    jm = zoo(JAX).init()
    tp = plan_tp(tm, create_mesh({"data": 4, "model": 2}, range(8)))
    jp = jplan(jm, jmesh({"data": 4, "model": 2}))
    chains = sorted({n for n, p in tp.parts.items()})
    assert len(chains) == 16 * 3
    _paired_specs_equal(tp, jp, chains + [n.replace("_conv", "_bn") for n
                                          in chains if not n.endswith("c_conv")])
    assert tp.state_shardings["s0b0_a_bn"]["mean"] == ("model",)
    assert tuple(jp.state_shardings["s0b0_a_bn"]["mean"].spec) == \
        ("model",)
    assert tp.act_kinds == jp.act_kinds
    assert jp.param_shardings["s0b0_ds_conv"]["W"].spec == \
        (None, None, None, "model")
    assert tp.fallback["s0b0_ds_conv"] == "replicated"
    assert tp.param_shardings["s0b0_ds_conv"]["W"] == ()


@pytest.mark.parametrize("name", list(FITS))
def test_tp_training_matches_jax(world, name):
    """The port's four ranks after the fit against the JAX replicated
    model after the same steps (and, for the MLP, the JAX wrapper's own
    tensor-parallel fit on a {data 2, model 4} mesh)."""
    conf_fn, tm = world["twins"][name]
    _, _, epochs, _ = FITS[name]
    jm = _jax_twin(conf_fn, tm)
    batches = [JDataSet(x, y) for x, y in world["data"][name]]
    jm.fit(JListIt(batches), epochs=epochs)
    got, info = _ranks(world, name)
    _assert_trees(got["params"], jax.tree_util.tree_map(
        np.asarray, jm.params), name)
    if name == "mlp":
        jt = _jax_twin(conf_fn, tm)
        JWrapper.builder(jt).mesh(jmesh({"data": 2, "model": 4})) \
            .tensor_parallel().build().fit(JListIt(batches), epochs=epochs)
        _assert_trees(got["params"], jax.tree_util.tree_map(
            np.asarray, jt.params), "mlp jax tp")
    if name == "conv_chain":
        _assert_trees(got["model_state"], jax.tree_util.tree_map(
            np.asarray, jm.train_state.model_state), "bn state")
        # the chain's middle BN ran on this rank's 4 of 8 channels
        assert info["local_shapes"]["a_bn/gamma"] == [4]
        assert info["fallback"] == {"ds_conv": "replicated"}


def test_tp_int8_walk_of_the_split_mlp(world):
    """The int8 walk honours the plan: the split MLP (layer_0 column,
    layer_1 row) quantized on each rank's slices (its own weight and input
    scales) serves within the quantization error of its f32 forward."""
    _, info = _ranks(world, "mlp")
    q = info["int8"]
    assert q["quantized"] == ["layer_0", "layer_1", "layer_2"]
    assert q["rel_l2"] <= 0.05 and q["argmax_agree"] >= 0.95, q


def test_tp_census_two_all_reduces_per_block(world):
    """One SHARED_GRADIENTS step of the two-block transformer on {data 2,
    model 2}: 2 all-reduces a block forward (after attention, after the
    FFN) and 2 backward (the cotangents of their inputs), 1 backward for
    the class-split output layer's input, 1 for the example count and 1
    for the gradients and the loss over the data axis: 11; and 1
    all-gather (the class-split logits)."""
    _, info = _ranks(world, "transformer")
    assert info["census"] == {"all-reduce": 11, "all-gather": 1}


def test_tp_computation_graph_imported_bert(world):
    """The imported BERT graph (2 blocks of 2 heads at width 16): each
    rank attends with 1 of the 2 heads; the split forward against the JAX
    package's model on the same Keras weights."""
    b = world["bert"]
    jp = jplan(b["jax"], jmesh({"data": 4, "model": 2}))
    tp = plan_tp(b["port"], create_mesh({"data": 4, "model": 2},
                                        range(8)))
    _paired_specs_equal(tp, jp, ["l0_mha", "l1_mha"])
    want = np.asarray(b["jax"].output(b["ids"], b["pos"]))
    out = world["group"].out()
    got = np.load(f"{out}/bert.npy")
    with open(f"{out}/bert.json") as f:
        assert json.load(f)["parts"]["l0_mha"] == ["attn:col", "attn:row"]
    assert np.abs(got - want).max() <= FWD * np.abs(want).max()
