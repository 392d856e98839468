"""The port's transfer learning (``TransferLearning``,
``FineTuneConfiguration``, ``TransferLearningHelper``) and
``FrozenLayer`` against the JAX package's, on the CPU.

The ``test_freeze_*``, ``test_remove_and_add_layers`` and
``test_helper_featurize`` cases of tests/test_earlystopping_transfer.py,
mirrored; then the same surgery in both packages from the same weights
(the layers that surgery re-initializes are carried from the JAX model,
since the two packages draw different random numbers): the kept
parameters equal JAX's bitwise, one step of the fine-tuned model matches
JAX's, and the frozen leaves are bitwise unchanged by it. Bounds: the
loss within 1e-5 relative and each parameter within 1e-4 of its array's
largest magnitude after a step (the same f32 math in other orders).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (
    _ensure_registry, opt_state_from_jax, params_from_jax)
from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration, TransferLearning, TransferLearningHelper)
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.optimize.updaters import Sgd

_ensure_registry()

PARAM_REL, LOSS_REL = 1e-4, 1e-5


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _toy_data(n=64, nf=4, nc=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, nf)).astype(np.float32)
    y_idx = rng.integers(0, nc, size=n)
    x += y_idx[:, None].astype(np.float32)
    return x, np.eye(nc, dtype=np.float32)[y_idx]


def _mlp(pkg="deeplearning4j_tpu_torch", seed=123):
    act = _m(pkg, "ops.activations").Activation
    ff = _m(pkg, "nn.layers.feedforward")
    out = _m(pkg, "nn.layers.output")
    return (_m(pkg, "nn.config").NeuralNetConfiguration.Builder()
            .seed(seed)
            .updater(_m(pkg, "optimize.updaters").Adam(1e-2))
            .list()
            .layer(ff.DenseLayer(n_out=16, activation=act.RELU))
            .layer(ff.DenseLayer(n_out=8, activation=act.RELU))
            .layer(out.OutputLayer(n_out=3,
                                   loss=_m(pkg, "ops.losses")
                                   .LossFunction.MCXENT,
                                   activation=act.SOFTMAX))
            .set_input_type(_m(pkg, "nn.inputs").InputType.feed_forward(4))
            .build())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(jm, tm):
    """The JAX model's params, state and optimizer state into ``tm``."""
    ts = _np(jm.train_state)
    params_from_jax(ts.params, ts.model_state, "cpu", model=tm)
    opt_state_from_jax(ts.opt_state, tm)


def _close(tm, jm, rel=PARAM_REL):
    for ln, lp in _np(jm.train_state.params).items():
        for k, v in lp.items():
            got = tm.params[ln][k].detach().numpy()
            assert np.abs(got - v).max() <= rel * max(np.abs(v).max(),
                                                      1e-6), (ln, k)
    for ln, st in _np(jm.train_state.model_state).items():
        for k, v in st.items():
            got = tm.model_state[ln][k].numpy()
            assert np.abs(got - v).max() <= rel * max(np.abs(v).max(),
                                                      1e-6), (ln, k)


def _snapshot(model):
    return {ln: {k: v.detach().clone() for k, v in lp.items()}
            for ln, lp in model.params.items()}


# ---------------------------------------------------------------------------
# the JAX package's cases, mirrored
# ---------------------------------------------------------------------------

def test_freeze_and_nout_replace():
    x, y = _toy_data()
    orig = MultiLayerNetwork(_mlp(), device="cpu").init()
    orig.fit(DataSet(x, y))
    new = (TransferLearning.Builder(orig)
           .fine_tune_configuration(
               FineTuneConfiguration.Builder().updater(Sgd(1e-3)).build())
           .set_feature_extractor(0)
           .n_out_replace(2, 5)
           .build())
    assert new.conf.layers[0].frozen
    assert not new.conf.layers[2].frozen
    assert new.conf.layers[2].n_out == 5
    w_old = orig.params["layer_0"]["W"].clone()
    assert torch.equal(w_old, new.params["layer_0"]["W"])
    assert new.params["layer_0"]["W"].data_ptr() != \
        orig.params["layer_0"]["W"].data_ptr()
    assert tuple(new.output(x[:4]).shape) == (4, 5)
    new.fit(DataSet(x, np.eye(5, dtype=np.float32)[
        np.random.default_rng(0).integers(0, 5, len(x))]))
    assert torch.equal(w_old, new.params["layer_0"]["W"])
    assert torch.equal(w_old, orig.params["layer_0"]["W"])


def test_remove_and_add_layers():
    x, _ = _toy_data()
    orig = MultiLayerNetwork(_mlp(), device="cpu").init()
    new = (TransferLearning.Builder(orig)
           .remove_output_layer()
           .add_layer(DenseLayer(n_out=12, activation=Activation.RELU))
           .add_layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT,
                                  activation=Activation.SOFTMAX))
           .build())
    assert len(new.conf.layers) == 4
    assert tuple(new.output(x[:2]).shape) == (2, 3)
    assert [l.name for l in new.conf.layers] == ["layer_0", "layer_1",
                                                 "layer_2", "layer_3"]


def test_compute_dtype_override():
    x, y = _toy_data()
    orig = MultiLayerNetwork(_mlp(), device="cpu").init()
    new = (TransferLearning.Builder(orig)
           .fine_tune_configuration(
               FineTuneConfiguration.Builder().updater(Sgd(1e-3))
               .compute_dtype("bfloat16").build())
           .build())
    assert new.conf.global_config.compute_dtype == "bfloat16"
    assert new.params["layer_0"]["W"].dtype == torch.float32
    new.fit(DataSet(x, y))
    assert torch.isfinite(new.output(x[:4]).float()).all()


def test_helper_featurize():
    x, y = _toy_data()
    orig = MultiLayerNetwork(_mlp(), device="cpu").init()
    frozen = (TransferLearning.Builder(orig)
              .set_feature_extractor(1)
              .build())
    helper = TransferLearningHelper(frozen)
    feat = helper.featurize(DataSet(x, y))
    assert feat.features.shape == (64, 8)
    before = _snapshot(frozen)
    helper.fit_featurized(feat)
    assert tuple(helper.unfrozen_mln().output(feat.features[:4]).shape) \
        == (4, 3)
    after = frozen.params
    for ln in ("layer_0", "layer_1"):
        for k, v in before[ln].items():
            assert torch.equal(v, after[ln][k])
    assert not torch.equal(before["layer_2"]["W"], after["layer_2"]["W"])
    torch.testing.assert_close(after["layer_2"]["W"],
                               helper.unfrozen_mln().params["layer_2"]["W"])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _mlp_pair():
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    jm = JMLN(_mlp("deeplearning4j_tpu")).init()
    tm = MultiLayerNetwork(_mlp(), device="cpu").init()
    _carry(jm, tm)
    return jm, tm


def test_mln_surgery_and_step_match_jax():
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    from deeplearning4j_tpu.nn import transferlearning as jtl
    from deeplearning4j_tpu.optimize.updaters import Nesterovs as JNest
    from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
    x, y = _toy_data()
    jm, tm = _mlp_pair()
    jnew = (jtl.TransferLearning.Builder(jm)
            .fine_tune_configuration(jtl.FineTuneConfiguration.Builder()
                                     .updater(JNest(0.05, 0.9)).l2(1e-3)
                                     .build())
            .set_feature_extractor("layer_0")
            .n_out_replace("layer_1", 6)
            .build())
    tnew = (TransferLearning.Builder(tm)
            .fine_tune_configuration(FineTuneConfiguration.Builder()
                                     .updater(Nesterovs(0.05, 0.9)).l2(1e-3)
                                     .build())
            .set_feature_extractor("layer_0")
            .n_out_replace("layer_1", 6)
            .build())
    assert tnew.conf.to_json() == jnew.conf.to_json()
    # the kept layer is JAX's, bitwise; the re-initialized ones are carried
    np.testing.assert_array_equal(
        tnew.params["layer_0"]["W"].numpy(),
        np.asarray(jnew.train_state.params["layer_0"]["W"]))
    _carry(jnew, tnew)
    frozen = _snapshot(tnew)["layer_0"]
    y5 = y
    jnew.fit(JDS(x, y5))
    tnew.fit(DataSet(x, y5))
    assert tnew.score(DataSet(x, y5)) == pytest.approx(
        float(jnew.score(JDS(x, y5))), rel=LOSS_REL)
    _close(tnew, jnew)
    for k, v in frozen.items():
        assert torch.equal(v, tnew.params["layer_0"][k])


def test_helper_featurize_matches_jax():
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    from deeplearning4j_tpu.nn import transferlearning as jtl
    x, y = _toy_data()
    jm, tm = _mlp_pair()
    jfr = jtl.TransferLearning.Builder(jm).set_feature_extractor(1).build()
    tfr = TransferLearning.Builder(tm).set_feature_extractor(1).build()
    jh, th = jtl.TransferLearningHelper(jfr), TransferLearningHelper(tfr)
    _carry(jh.unfrozen_mln(), th.unfrozen_mln())
    jf, tf = jh.featurize(JDS(x, y)), th.featurize(DataSet(x, y))
    np.testing.assert_allclose(tf.features, np.asarray(jf.features),
                               rtol=1e-5, atol=1e-6)
    jh.fit_featurized(jf)
    th.fit_featurized(tf)
    _close(th.unfrozen_mln(), jh.unfrozen_mln())
    _close(tfr, jfr)


def _cnn_graph(pkg, seed=7):
    """A small conv graph with BN: conv → BN → ReLU → two branches merged
    → pooled → dense → output."""
    conv = _m(pkg, "nn.layers.convolution")
    act = _m(pkg, "ops.activations").Activation
    out = _m(pkg, "nn.layers.output")
    g = (_m(pkg, "nn.config").NeuralNetConfiguration.Builder().seed(seed)
         .updater(_m(pkg, "optimize.updaters").Nesterovs(0.05, 0.9))
         .graph_builder().add_inputs("in")
         .set_input_types(_m(pkg, "nn.inputs").InputType.convolutional(
             8, 8, 3)))
    g.add_layer("c1", conv.ConvolutionLayer(
        n_out=6, kernel_size=(3, 3), convolution_mode=conv.ConvolutionMode
        .SAME, activation=act.IDENTITY), "in")
    g.add_layer("bn1", _m(pkg, "nn.layers.normalization")
                .BatchNormalization(), "c1")
    g.add_layer("a1", _m(pkg, "nn.layers.feedforward").ActivationLayer(
        activation=act.RELU), "bn1")
    g.add_layer("b1", conv.ConvolutionLayer(
        n_out=4, kernel_size=(1, 1), activation=act.RELU), "a1")
    g.add_layer("b2", conv.ConvolutionLayer(
        n_out=4, kernel_size=(3, 3), convolution_mode=conv.ConvolutionMode
        .SAME, activation=act.RELU), "a1")
    g.add_vertex("cat", _m(pkg, "nn.graph.vertices").MergeVertex(), "b1",
                 "b2")
    g.add_layer("pool", out.GlobalPoolingLayer(
        pooling_type=conv.PoolingType.AVG), "cat")
    g.add_layer("fc", _m(pkg, "nn.layers.feedforward").DenseLayer(
        n_out=10, activation=act.TANH), "pool")
    g.add_layer("out", out.OutputLayer(
        n_out=4, loss=_m(pkg, "ops.losses").LossFunction.MCXENT,
        activation=act.SOFTMAX), "fc")
    g.set_outputs("out")
    return g.build()


def test_graph_surgery_and_step_match_jax():
    """GraphBuilder: freeze up to "cat" (conv, BN and both branches), swap
    the head for a new one on "fc" with another class count, add a layer;
    the step matches JAX, the frozen params are bitwise unchanged (the
    frozen-flag BN still updates its running statistics in a train step,
    as in the JAX package)."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JGraph
    from deeplearning4j_tpu.nn import transferlearning as jtl
    from deeplearning4j_tpu.nn.layers.output import OutputLayer as JOut
    from deeplearning4j_tpu.ops.activations import Activation as JAct
    from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    jm = JGraph(_cnn_graph("deeplearning4j_tpu")).init()
    tm = ComputationGraph(_cnn_graph("deeplearning4j_tpu_torch"),
                          device="cpu").init()
    _carry(jm, tm)

    def surgery(tl, out_cls, act, loss, model):
        return (tl.TransferLearning.GraphBuilder(model)
                .set_feature_extractor("cat")
                .n_out_replace("fc", 12)
                .remove_vertex_and_connections("out")
                .add_layer("out2", out_cls(n_out=2, loss=loss.MCXENT,
                                           activation=act.SOFTMAX), "fc")
                .set_outputs("out2")
                .build())
    jnew = surgery(jtl, JOut, JAct, JLoss, jm)
    tnew = surgery(importlib.import_module(
        "deeplearning4j_tpu_torch.nn.transferlearning"), OutputLayer,
        Activation, LossFunction, tm)
    assert tnew.conf.to_json() == jnew.conf.to_json()
    frozen = [n.name for n in tnew.conf.nodes
              if n.layer is not None and n.layer.frozen]
    assert sorted(frozen) == ["a1", "b1", "b2", "bn1", "c1"]
    for name in frozen:
        for k, v in tnew.params[name].items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jnew.train_state.params[name][k]))
    _carry(jnew, tnew)
    before = _snapshot(tnew)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (6, 8, 8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    for _ in range(2):
        jnew.fit(JDS(x, y))
        tnew.fit(DataSet(x, y))
    _close(tnew, jnew)
    for name in frozen:
        for k, v in before[name].items():
            assert torch.equal(v, tnew.params[name][k]), (name, k)
    assert not torch.equal(before["fc"]["W"], tnew.params["fc"]["W"])


def test_frozen_layer_wrapper_holds_params_and_bn_state_bitwise():
    """``FrozenLayer`` around a conv and a BatchNormalization: no updater
    moves them (AdamW's weight decay included), the BN's running
    statistics stay as they are in a train step, and the model's step
    matches the JAX model's."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN

    def conf(pkg):
        conv = _m(pkg, "nn.layers.convolution")
        misc = _m(pkg, "nn.layers.misc")
        act = _m(pkg, "ops.activations").Activation
        return (_m(pkg, "nn.config").NeuralNetConfiguration.Builder()
                .seed(3).updater(_m(pkg, "optimize.updaters").AdamW(
                    1e-2, weight_decay=0.1))
                .list()
                .layer(misc.FrozenLayer(underlying=conv.ConvolutionLayer(
                    n_out=4, kernel_size=(3, 3), activation=act.IDENTITY)))
                .layer(misc.FrozenLayer(underlying=_m(
                    pkg, "nn.layers.normalization").BatchNormalization()))
                .layer(_m(pkg, "nn.layers.feedforward").DenseLayer(
                    n_out=5, activation=act.RELU))
                .layer(_m(pkg, "nn.layers.output").OutputLayer(
                    n_out=3, loss=_m(pkg, "ops.losses").LossFunction.MCXENT,
                    activation=act.SOFTMAX))
                .set_input_type(_m(pkg, "nn.inputs").InputType
                                .convolutional(6, 6, 2))
                .build())
    jconf = conf("deeplearning4j_tpu")
    assert conf("deeplearning4j_tpu_torch").to_json() == jconf.to_json()
    jm = JMLN(jconf).init()
    tm = MultiLayerNetwork(conf("deeplearning4j_tpu_torch"),
                           device="cpu").init()
    _carry(jm, tm)
    p0 = _snapshot(tm)
    s0 = {ln: {k: v.clone() for k, v in st.items()}
          for ln, st in tm.model_state.items()}
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (8, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    for _ in range(3):
        jm.fit(JDS(x, y))
        tm.fit(DataSet(x, y))
    _close(tm, jm)
    for ln in ("layer_0", "layer_1"):
        for k, v in p0[ln].items():
            assert torch.equal(v, tm.params[ln][k]), (ln, k)
    for k, v in s0["layer_1"].items():
        assert torch.equal(v, tm.model_state["layer_1"][k])
    assert not torch.equal(p0["layer_2"]["W"], tm.params["layer_2"]["W"])


def test_lenet_digits_transfer_to_a_new_head():
    """The committed digit LeNet, frozen up to its last dense layer, with
    its head replaced by ``n_out_replace`` (even/odd, 2 classes) and fit
    on the digits: the frozen parameters are bitwise unchanged and the
    new head learns the new task."""
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    base = LeNet().init_pretrained(flavor="digits", device="cpu")
    names = [l.name for l in base.conf.layers]
    model = (TransferLearning.Builder(base)
             .fine_tune_configuration(FineTuneConfiguration.Builder()
                                      .updater(Sgd(0.05)).build())
             .set_feature_extractor(names[-2])
             .n_out_replace(names[-1], 2)
             .build())
    before = _snapshot(model)
    x, yi = DigitsDataSetIterator.fetch(train=True)
    xt, yti = DigitsDataSetIterator.fetch(train=False)
    x = x.reshape(len(x), -1).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[yi % 2]
    for _ in range(3):
        for lo in range(0, len(x) - 63, 64):
            model.fit(DataSet(x[lo:lo + 64], y[lo:lo + 64]))
    for ln in names[:-1]:
        for k, v in before[ln].items():
            assert torch.equal(v, model.params[ln][k]), (ln, k)
    pred = model.output(xt.reshape(len(xt), -1).astype(np.float32))
    acc = float((pred.argmax(1).numpy() == yti % 2).mean())
    assert acc >= 0.9, acc
