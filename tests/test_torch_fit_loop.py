"""The port's fit loop (models/base.py) and device feeder
(datasets/feeder.py) against the JAX package on the CPU.

- LeNet (full width, 431,080 parameters) fitted for one epoch over 250
  real digits at batch 64 (three full batches and a ragged tail of 58)
  with ``k_steps`` 1, 3 and 4 in both packages from the same weights:
  parameters and Adam state within 1e-4 of each array's largest (ROADMAP's
  f32 bound; the packages' convolutions sum in other orders), the same
  ``iteration`` and ``epoch_count``;
- a tiny ``ComputationGraph`` fitted from an iterator (K 1 and 2) and from
  MultiDataSets, against the JAX graph;
- ``k_steps > 1`` without the feeder raises as in the JAX package;
- the feeder's slot ring, with a stand-in transport whose copies read
  their pinned slot only when their event completes: no batch is
  corrupted, and the same run without the ring's wait is (so the check
  can fail);
- the small CNN of the re-anchor probe (3×3 SAME conv, BatchNormalization
  in training, max/avg/sum/pnorm pooling, a ReLU dense layer, softmax
  MCXENT, L1 1e-3 and L2 1e-2) over three ``fit`` steps under Sgd,
  Nesterovs and Adam: scores rel 1e-5, parameters and BN statistics
  within 1e-4 of each array's largest. The convolution's bias feeds the
  BN, so its exact gradient is zero and both packages move it by
  rounding noise alone (an ±lr step under Adam); it is left out, and
  under Adam so is the BN running mean, which carries that bias.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import \
    ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.serialization import \
    _flatten_with_paths as jax_paths
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet, MultiDataSet)
from deeplearning4j_tpu_torch.datasets.feeder import (DeviceFeeder, FeedItem,
                                                      StagingRing,
                                                      pad_to_bucket)
from deeplearning4j_tpu_torch.datasets.fetchers import DigitsDataSetIterator
from deeplearning4j_tpu_torch.datasets.iterators import \
    AsyncShieldDataSetIterator
from deeplearning4j_tpu_torch.models.serialization import (flatten_paths,
                                                           opt_state_from_jax,
                                                           params_from_jax)

TREE_REL = 1e-4


@pytest.fixture(autouse=True)
def _no_crash_dumps(monkeypatch):
    """Some fits here raise on purpose: keep the flight recorders' default
    post-mortem dumps (both packages') out of the temporary directory."""
    monkeypatch.setenv("DL4J_CRASH_DUMPS", "0")


def _close_flat(got, want, rel, skip=()):
    g = {k: v.detach().float().numpy() for k, v in flatten_paths(got).items()}
    w = {k: np.asarray(v, np.float32) for k, v in jax_paths(want).items()}
    assert set(g) == set(w)
    for k in w:
        if any(s in k for s in skip):
            continue
        err = np.abs(g[k] - w[k]).max()
        assert err <= rel * max(np.abs(w[k]).max(), 1e-12), (k, err)


def _adopt(tm, jm):
    """The port model takes the JAX model's parameters, state and
    optimizer state."""
    ts = jax.device_get(jm.train_state)
    params_from_jax(ts.params, ts.model_state, model=tm)
    opt_state_from_jax(ts.opt_state, tm)


@pytest.fixture(scope="module")
def digits250():
    x, y = DigitsDataSetIterator.fetch(train=True)
    return x[:250], np.eye(10, dtype=np.float32)[y[:250]]


@pytest.mark.parametrize("k", [1, 3, 4])
def test_lenet_iterator_fit_matches_jax(digits250, k):
    from deeplearning4j_tpu.zoo.models import LeNet as JLeNet
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    x, y = digits250
    jm = JLeNet().init()
    tm = LeNet().init(device="cpu")
    _adopt(tm, jm)
    jm.fit(JArrayIt(JDataSet(x, y), 64, shuffle=True, seed=3), epochs=1,
           k_steps=k)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), 64, shuffle=True, seed=3),
           epochs=1, k_steps=k)
    ts = jax.device_get(jm.train_state)
    assert tm.iteration == int(ts.iteration) == 4
    assert tm.epoch_count == jm.epoch_count == 1
    _close_flat(tm.params, ts.params, TREE_REL)
    _close_flat(tm.opt_state, ts.opt_state, TREE_REL)
    assert tm.score() == pytest.approx(float(jm.score()), rel=1e-4)
    assert tm.last_feeder is not None and tm.last_feeder.k_steps == k
    assert len(tm.last_feeder.pass_stall_ms) == 1


def _graph_pair(seed=4):
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JCG
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.optimize.updaters import Adam
    import deeplearning4j_tpu_torch.nn.layers.feedforward  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.output  # noqa: F401
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph.config import \
        ComputationGraphConfiguration
    jconf = (NeuralNetConfiguration.Builder().seed(seed)
             .updater(Adam(1e-2)).graph_builder().add_inputs("in")
             .set_input_types(InputType.feed_forward(5))
             .add_layer("h", DenseLayer(n_out=7,
                                        activation=Activation.TANH), "in")
             .add_layer("out", OutputLayer(n_out=3), "h")
             .set_outputs("out").build())
    jm = JCG(jconf).init()
    tm = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    _adopt(tm, jm)
    return tm, jm


@pytest.mark.parametrize("k", [1, 2])
def test_graph_iterator_fit_matches_jax(k):
    tm, jm = _graph_pair()
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (90, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 90)]
    jm.fit(JArrayIt(JDataSet(x, y), 16, shuffle=True, seed=1), epochs=2,
           k_steps=k)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), 16, shuffle=True, seed=1),
           epochs=2, k_steps=k)
    ts = jax.device_get(jm.train_state)
    assert tm.iteration == int(ts.iteration) == 12
    assert tm.epoch_count == jm.epoch_count == 2
    _close_flat(tm.params, ts.params, TREE_REL)
    _close_flat(tm.opt_state, ts.opt_state, TREE_REL)


def test_graph_fits_multidatasets_and_mln_refuses_them():
    from deeplearning4j_tpu.datasets.dataset import \
        MultiDataSet as JMultiDataSet
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    tm, jm = _graph_pair(seed=5)
    rng = np.random.default_rng(9)
    batches = [(rng.normal(0, 1, (8, 5)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
               for _ in range(3)]
    # a list of MultiDataSets is an iterator the feeder passes through
    tm.fit([MultiDataSet([x], [y]) for x, y in batches])
    for x, y in batches:
        jm.fit(JMultiDataSet([x], [y]))
    ts = jax.device_get(jm.train_state)
    assert tm.iteration == int(ts.iteration) == 3
    _close_flat(tm.params, ts.params, TREE_REL)
    x, y = batches[0]
    with pytest.raises(TypeError, match="ComputationGraph"):
        LeNet(height=4, width=4).init(device="cpu").fit(
            MultiDataSet([x], [y]))


def test_k_steps_without_the_feeder_raises_as_in_jax():
    from deeplearning4j_tpu.datasets.iterators import \
        AsyncShieldDataSetIterator as JShield
    tm, jm = _graph_pair()
    x = np.zeros((32, 5), np.float32)
    y = np.eye(3, dtype=np.float32)[np.zeros(32, int)]
    for model, it, shield in ((tm, ArrayDataSetIterator(DataSet(x, y), 8),
                               AsyncShieldDataSetIterator),
                              (jm, JArrayIt(JDataSet(x, y), 8), JShield)):
        with pytest.raises(ValueError, match="k_steps > 1 needs the device "
                                             "feeder"):
            model.fit(it, k_steps=2, prefetch=0)
        with pytest.raises(ValueError, match="k_steps > 1 needs the device "
                                             "feeder"):
            model.fit(shield(it), k_steps=2)
        with pytest.raises(ValueError, match="k_steps must be >= 1"):
            model.fit(it, k_steps=0)
    # prefetch=0 alone is the synchronous loop
    tm.fit(ArrayDataSetIterator(DataSet(x, y), 8), prefetch=0)
    assert tm.iteration == 4 and tm.last_feeder is None


class _FakeEvent:
    """A copy's completion: the copy reads its slot when the event
    completes, as the card's copy engine may read it any time before."""

    def __init__(self, copies):
        self.copies = copies

    def synchronize(self):
        for c in self.copies:
            c()
        self.copies = []


class _FakeTransport:
    """CudaTransport's interface on the CPU: ``copy`` returns an empty
    tensor that is filled from the pinned slot only when the event of its
    item completes."""

    def __init__(self):
        self._pending = []

    def alloc(self, shape, dtype):
        return torch.empty(shape, dtype=dtype)

    def copy(self, host):
        dst = torch.full(host.shape, float("nan"), dtype=host.dtype)
        self._pending.append(lambda: dst.copy_(host))
        return dst

    def record(self):
        ev, self._pending = _FakeEvent(self._pending), []
        return ev

    def hand_off(self, tensors, event):
        event.synchronize()


def _staged(feeder, lag):
    """Iterate, handing each item off only ``lag`` items later (a step
    loop that runs behind), and return the items' arrays."""
    out, held = [], []
    for item in feeder:
        held.append(item)
        if len(held) > lag:
            out.append(feeder.hand_off(held.pop(0)))
    out += [feeder.hand_off(i) for i in held]
    return [tuple(None if t is None else t.numpy().copy() for t in i[:4])
            for i in out]


@pytest.mark.parametrize("k", [1, 2])
def test_slot_ring_never_rewrites_a_slot_whose_copy_is_pending(k):
    rng = np.random.default_rng(10)
    data = DataSet(rng.normal(size=(150, 6)).astype(np.float32),
                   np.eye(4, dtype=np.float32)[rng.integers(0, 4, 150)])
    want = _staged(DeviceFeeder(ArrayDataSetIterator(data, 16), k_steps=k,
                                device="cpu"),
                   0)
    feeder = DeviceFeeder(ArrayDataSetIterator(data, 16), k_steps=k,
                          device="cpu", depth=2, transport=_FakeTransport())
    got = _staged(feeder, lag=6)
    assert feeder.ring.waits > 0          # the ring did have to wait
    assert len(got) == len(want) == (10 if k == 1 else 5)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    # the same run with a ring that forgets pending copies corrupts
    # batches: the check can fail
    bad = DeviceFeeder(ArrayDataSetIterator(data, 16), k_steps=k,
                       device="cpu", depth=2, transport=_FakeTransport())
    bad.ring = _NoWaitRing(bad.ring.slots, bad.ring.alloc)
    got = _staged(bad, lag=6)
    assert bad.ring.waits == 0
    assert any(not np.array_equal(g[0], w[0]) for g, w in zip(got, want))


class _NoWaitRing(StagingRing):
    def stage(self, a):
        for ring in self._rings.values():
            for slot in ring:
                slot.event = None
        return super().stage(a)


def test_feeder_pads_the_ragged_tail_and_splits_the_remainder():
    rng = np.random.default_rng(11)
    data = DataSet(rng.normal(size=(100, 3)).astype(np.float32),
                   np.eye(2, dtype=np.float32)[rng.integers(0, 2, 100)])
    items = list(DeviceFeeder(ArrayDataSetIterator(data, 32), k_steps=3,
                              device="cpu"))
    # 4 batches (32, 32, 32, 4): one group of 3, then the tail split off
    assert [i.k for i in items] == [3, 1]
    assert items[0].features.shape == (3, 32, 3)
    assert items[1].features.shape == (32, 3)
    assert items[1].n_examples == 4
    np.testing.assert_array_equal(items[1].labels_mask.numpy(),
                                  np.r_[np.ones(4), np.zeros(28)])
    padded = pad_to_bucket(DataSet(data.features[96:], data.labels[96:]),
                           32)
    np.testing.assert_array_equal(items[1].features.numpy(),
                                  padded.features)
    assert isinstance(items[0], FeedItem) and items[0].event is None
    # "pad": the tail group repeats its last batch up to K
    data5 = DataSet(np.concatenate([data.features] * 2)[:160],
                    np.concatenate([data.labels] * 2)[:160])
    items = list(DeviceFeeder(ArrayDataSetIterator(data5, 32), k_steps=3,
                              device="cpu", group_remainder="pad"))
    assert [i.k for i in items] == [3, 3] and items[1].n_examples == 96
    np.testing.assert_array_equal(items[1].features[1].numpy(),
                                  items[1].features[2].numpy())


def _cnn_pair(updater, pooling):
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.convolution import (ConvolutionLayer,
                                                          ConvolutionMode,
                                                          PoolingType,
                                                          SubsamplingLayer)
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu.nn.layers.normalization import \
        BatchNormalization
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.optimize import updaters as U
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serialization import \
        _ensure_registry
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    jconf = (NeuralNetConfiguration.Builder().seed(2)
             .updater(getattr(U, updater[0])(*updater[1]))
             .l1(1e-3).l2(1e-2).list()
             .layer(ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                     convolution_mode=ConvolutionMode.SAME,
                                     activation=Activation.IDENTITY))
             .layer(BatchNormalization())
             .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                     pooling_type=PoolingType[pooling]))
             .layer(DenseLayer(n_out=8, activation=Activation.RELU))
             .layer(OutputLayer(n_out=3))
             .set_input_type(InputType.convolutional(6, 6, 2)).build())
    jm = JMLN(jconf).init()
    _ensure_registry()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    _adopt(tm, jm)
    return tm, jm


@pytest.mark.parametrize("pooling", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("updater", [("Sgd", (0.1,)),
                                     ("Nesterovs", (0.05, 0.9)),
                                     ("Adam", (1e-2,))])
def test_cnn_probe_three_fit_steps_match_jax(updater, pooling):
    tm, jm = _cnn_pair(updater, pooling)
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (10, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    np.testing.assert_allclose(tm.output(x).numpy(), np.asarray(
        jm.output(x)), rtol=1e-5, atol=1e-6)
    for _ in range(3):
        tm.fit(DataSet(x, y))
        jm.fit(JDataSet(x, y))
        assert tm.score() == pytest.approx(float(jm.score()), rel=1e-5)
    ts = jax.device_get(jm.train_state)
    skip = ["layer_0/b"] + (["layer_1/mean"] if updater[0] == "Adam"
                            else [])
    _close_flat(tm.params, ts.params, TREE_REL, skip)
    _close_flat(tm.model_state, ts.model_state, TREE_REL, skip)
    if updater[0] != "Adam":
        # (under Adam the inference output reads the BN running mean that
        # the left-out bias moves)
        np.testing.assert_allclose(tm.output(x).numpy(), np.asarray(
            jm.output(x)), rtol=1e-4, atol=1e-5)
