"""The whole training slice against the JAX package: a narrow fused graph
built with the same builder calls as ``ResNet50.conf()`` (s2d stem,
``conv1_bn``, ReLU, max pool, two fused blocks — one downsampling —,
average pool, softmax/MCXENT output), trained by Nesterovs through
``fit(DataSet)`` in both packages from the same weights; one step of the
fused ResNet50 itself; checkpoints with updater state in both directions.

The JAX side runs its Pallas kernels in interpret mode, the port its
plain versions (the CPU path of the kernel wrappers).

Bounds (f32): per step, the loss within rel 1e-5, and every parameter and
BN running statistic within 1e-4 of its array's largest magnitude — the
bounds ROADMAP.md sets for a slice (the same math summed in other
orders).

The ResNet50 step is wider, for a stated reason: the random-init 50-layer
BN stack amplifies f32 summation-order differences (activations drift
from 1e-7 to 1e-4 relative by the last stage), and the last stage's BN
normalizes only 8 values per channel at batch 8 (its plane is 1×1), so
its gradients differ by a few percent. Bounds: loss rel 1e-4; each
parameter's update Δp within 10% relative L2 of the JAX update (3.4%
measured on this CPU); running statistics within 1e-3 of their largest
magnitude. Batch 8 instead of 2: at batch 2 that BN sees 2 values per
channel, normalizes each to ±1, and the step is chaotic (the two
packages' losses differed by 47% there).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.serialization import (
    opt_state_from_jax, params_from_jax, restore_model, save_model)

# one intra-op thread a test process: the suite runs its workers side
# by side on the machine's cores, and a torch thread pool per worker
# oversubscribes them (small ops then wait on spinning threads)
torch.set_num_threads(1)

LOSS_REL, TREE_REL = 1e-5, 1e-4


def _conf(pkg: str, classes=5, hw=16):
    """The ResNet50.conf() builder calls, narrowed (both packages have the
    same builder API and layer names)."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    conv = m("nn.layers.convolution")
    act = m("ops.activations").Activation
    b = (m("nn.config").NeuralNetConfiguration.Builder()
         .seed(7).updater(m("optimize.updaters").Nesterovs(0.1, 0.9))
         .graph_builder().add_inputs("in")
         .set_input_types(m("nn.inputs").InputType.convolutional(hw, hw, 3)))
    b.add_layer("s2d", conv.SpaceToDepthLayer(block_size=2), "in")
    b.add_layer("s2d_pad", conv.ZeroPaddingLayer(pad=(1, 2, 1, 2)), "s2d")
    b.add_layer("conv1_conv", conv.ConvolutionLayer(
        n_out=8, kernel_size=(4, 4), stride=(1, 1),
        convolution_mode=conv.ConvolutionMode.TRUNCATE, has_bias=False,
        weight_init=m("ops.initializers").WeightInit.HE_NORMAL,
        activation=act.IDENTITY), "s2d_pad")
    b.add_layer("conv1_bn", m("nn.layers.normalization").BatchNormalization(),
                "conv1_conv")
    b.add_layer("conv1_act", m("nn.layers.feedforward").ActivationLayer(
        activation=act.RELU), "conv1_bn")
    b.add_layer("pool1", conv.SubsamplingLayer(
        kernel_size=(3, 3), stride=(2, 2),
        convolution_mode=conv.ConvolutionMode.SAME), "conv1_act")
    fused = m("nn.layers.fused").FusedBottleneckBlock
    b.add_layer("s0b0", fused(filters=4, stride=1, downsample=True), "pool1")
    b.add_layer("s1b0", fused(filters=8, stride=2, downsample=True), "s0b0")
    out = m("nn.layers.output")
    b.add_layer("avgpool", out.GlobalPoolingLayer(
        pooling_type=conv.PoolingType.AVG), "s1b0")
    b.add_layer("out", out.OutputLayer(
        n_out=classes, loss=m("ops.losses").LossFunction.MCXENT,
        activation=act.SOFTMAX), "avgpool")
    b.set_outputs("out")
    return b.build()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_tree(got, want, rel, what):
    for ln, lp in want.items():
        for k, v in lp.items():
            v = np.asarray(v)
            g = got[ln][k].detach().float().cpu().numpy()
            err = np.abs(g - v).max()
            assert err <= rel * max(np.abs(v).max(), 1e-6), \
                (what, ln, k, err, np.abs(v).max())


def _pair(seed=0, n=4, classes=5, hw=16):
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    jm = JGraph(_conf("deeplearning4j_tpu", classes, hw)).init()
    tm = ComputationGraph(_conf("deeplearning4j_tpu_torch", classes, hw),
                          device="cpu").init()
    ts = jm.train_state
    params_from_jax(_np_tree(ts.params), _np_tree(ts.model_state), "cpu",
                    model=tm)
    opt_state_from_jax(_np_tree(ts.opt_state), tm)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, hw, hw, 3)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return jm, tm, x, y


def _jax_ds(x, y):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    return JDataSet(x, y)


def _assert_models_agree(jm, tm, loss_rel=LOSS_REL):
    assert tm.score() == pytest.approx(float(jm.score()), rel=loss_rel)
    ts = jm.train_state
    _close_tree(tm.params, _np_tree(ts.params), TREE_REL, "params")
    _close_tree(tm.model_state, _np_tree(ts.model_state), TREE_REL, "state")
    assert tm.iteration == int(ts.iteration)


def test_three_nesterovs_steps_match_jax():
    jm, tm, x, y = _pair()
    jds, tds = _jax_ds(x, y), DataSet(x, y)
    before = {k: v.clone() for k, v in tm.model_state["s0b0"].items()}
    for _ in range(3):
        jm.fit(jds)
        tm.fit(tds)
        _assert_models_agree(jm, tm)
    assert not torch.equal(tm.model_state["s0b0"]["bn2_var"],
                           before["bn2_var"])
    # the score of a batch (train-mode loss, no update) agrees too
    assert tm.score(tds) == pytest.approx(float(jm.score(jds)), rel=LOSS_REL)


def test_resnet50_step_matches_jax():
    from deeplearning4j_tpu.zoo.models import ResNet50 as JResNet50
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    cfg = dict(num_classes=8, height=32, width=32, fused_blocks=True,
               s2d_stem=True)
    jm = JResNet50(**cfg).init()
    tm = ResNet50(**cfg).init(device="cpu")
    ts = jm.train_state
    p0 = _np_tree(ts.params)
    params_from_jax(p0, _np_tree(ts.model_state), "cpu", model=tm)
    opt_state_from_jax(_np_tree(ts.opt_state), tm)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, 8)]
    jm.fit(_jax_ds(x, y))
    tm.fit(DataSet(x, y))
    assert tm.score() == pytest.approx(float(jm.score()), rel=1e-4)
    p1 = _np_tree(jm.train_state.params)
    for ln, lp in p1.items():
        for k, v in lp.items():
            d_jax = v - p0[ln][k]
            d_port = tm.params[ln][k].numpy() - p0[ln][k]
            err = np.linalg.norm(d_port - d_jax)
            assert err <= 0.1 * np.linalg.norm(d_jax) + 1e-9, (ln, k, err)
    _close_tree(tm.model_state, _np_tree(jm.train_state.model_state),
                1e-3, "state")


def test_updater_checkpoints_carry_across_both_ways(tmp_path):
    """JAX → port → JAX with updater state: after each restore, one more
    step gives the same params as the other package's model continuing."""
    from deeplearning4j_tpu.models.serialization import \
        restore_computation_graph as jax_restore
    from deeplearning4j_tpu.models.serialization import save_model as jax_save
    jm, _, x, y = _pair(seed=2)
    jds, tds = _jax_ds(x, y), DataSet(x, y)
    jm.fit(jds)
    a = str(tmp_path / "jax.zip")
    jax_save(jm, a, save_updater=True)
    tm = restore_model(a, device="cpu", load_updater=True)
    assert tm.iteration == 1
    _close_tree(tm.opt_state["#0"][".trace"],
                _np_tree(jm.train_state.opt_state[0].trace), 0.0, "trace")
    without = restore_model(a, device="cpu")
    assert not any(v.any() for lp in without.opt_state["#0"][".trace"]
                   .values() for v in lp.values())
    jm.fit(jds)
    tm.fit(tds)
    _assert_models_agree(jm, tm)

    b = str(tmp_path / "port.zip")
    save_model(tm, b, save_updater=True)
    back = jax_restore(b, load_updater=True)
    assert int(back.train_state.iteration) == 2
    back.fit(jds)
    tm.fit(tds)
    _assert_models_agree(back, tm)


def test_opt_state_from_jax_rejects_name_mismatches():
    jm, tm, _, _ = _pair()
    st = _np_tree(jm.train_state.opt_state)
    trace = dict(st[0].trace)
    trace["extra"] = {"W": np.zeros(3, np.float32)}
    with pytest.raises(KeyError):
        opt_state_from_jax((st[0]._replace(trace=trace), st[1]), tm)
    with pytest.raises(KeyError):
        opt_state_from_jax({"trace": st[0].trace}, tm)
