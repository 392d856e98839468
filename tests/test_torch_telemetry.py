"""The port's in-step telemetry (observe/telemetry.py and its hooks in the
train steps and the fit loop) against the JAX package's on the CPU.

The same numpy-seeded batches and the same carried weights
(``params_from_jax``) go through a narrow MultiLayerNetwork, a narrow
ComputationGraph, a 2-block fused-bottleneck graph (the ResNet50
configuration calls narrowed; the JAX side runs its Pallas kernels in interpret mode,
the port the kernels' plain versions), each fitted with K = 1 and K = 3
steps a call, and a TBPTT LSTM, with a ``TelemetryCollector`` (per-layer
ratios and histograms) attached in both packages.

Bounds, float32: the decoded rows' loss and grad_norm within 1e-5
relative, nonfinite_count and the iteration column exact, the per-layer
update ratios within 1e-4 relative (1e-9 absolute where a layer has no
parameters: both are 0); histogram ranges within 1e-5 of the
histogram's extent (its largest |min| or |max|); the counts equal except
for elements within rounding of a bin edge: at most 2 elements a
histogram may sit one bin over, so the summed absolute count difference
of a histogram is at most 4. The fetch counts are equal. A batch with a NaN feature gives the same
non-finite count in both packages and writes the histograms at that
step although none was due. The registry series are named alike.

The fused graph's histogram ranges are held to 1e-4 of the extent, for
the reason tests/test_torch_train.py gives for its 1e-4 parameter
bound: its BN stack takes the packages' f32 summation-order differences
to about 1e-5 relative in the gradients (1.3e-5 measured on the stem
convolution's gradient extremes after 6 steps on this CPU).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import \
    ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.observe.registry import MetricsRegistry as JRegistry
from deeplearning4j_tpu.observe.telemetry import \
    TelemetryCollector as JCollector
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet)
from deeplearning4j_tpu_torch.models.serialization import (opt_state_from_jax,
                                                           params_from_jax)
from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.observe.telemetry import (TelemetryCollector,
                                                        TelemetrySpec)

ROW_REL, RATIO_REL, RANGE_REL, FUSED_RANGE_REL = 1e-5, 1e-4, 1e-5, 1e-4
COUNT_SLACK = 4


def _adopt(tm, jm):
    ts = jax.device_get(jm.train_state)
    params_from_jax(ts.params, ts.model_state, model=tm)
    opt_state_from_jax(ts.opt_state, tm)


def mln_pair(seed=1, n_in=5):
    """A Dense(8) + softmax Output(3) MultiLayerNetwork in both packages."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.losses import LossFunction
    from deeplearning4j_tpu.optimize.updaters import Adam
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serialization import \
        _ensure_registry
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    jconf = (NeuralNetConfiguration.Builder().seed(seed)
             .updater(Adam(1e-2)).list()
             .layer(DenseLayer(n_out=8))
             .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT))
             .set_input_type(InputType.feed_forward(n_in)).build())
    jm = JMLN(jconf).init()
    _ensure_registry()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    _adopt(tm, jm)
    return tm, jm


def cg_pair():
    from test_torch_fit_loop import _graph_pair
    return _graph_pair()


def fused_pair():
    """The 2-block fused-bottleneck graph of test_torch_train.py."""
    from test_torch_train import _pair
    jm, tm, _, _ = _pair()
    return tm, jm


def tbptt_pair():
    from test_torch_tbptt import _jax_conf
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    jconf = _jax_conf("lstm", 10, 4)
    jm = JMLN(jconf).init()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    _adopt(tm, jm)
    return tm, jm


def batches(kind, n, seed=0):
    """(features, labels) of ``n`` rows for a model kind."""
    rng = np.random.default_rng(seed)
    if kind == "fused":
        x = rng.normal(0, 1, (n, 16, 16, 3)).astype(np.float32)
        return x, np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    width, classes = {"mln": (5, 3), "cg": (5, 3)}[kind]
    x = rng.normal(0, 1, (n, width)).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def collectors(**kw):
    cfg = dict(flush_interval=2, histograms=True, hist_interval=2,
               hist_bins=8)
    cfg.update(kw)
    return (TelemetryCollector(registry=MetricsRegistry(), **cfg),
            JCollector(registry=JRegistry(), **cfg))


def assert_rows_agree(tc, jc, range_rel=RANGE_REL):
    assert tc.fetch_count == jc.fetch_count
    assert len(tc.history) == len(jc.history) > 0
    for got, want in zip(tc.history, jc.history):
        assert set(got) == set(want)
        assert got["iteration"] == want["iteration"]
        assert got["nonfinite_count"] == want["nonfinite_count"]
        for key in ("loss", "grad_norm"):
            assert got[key] == pytest.approx(want[key], rel=ROW_REL), key
        for key in want:
            if key.startswith("update_ratio/"):
                assert got[key] == pytest.approx(want[key], rel=RATIO_REL,
                                                 abs=1e-9), key
    assert len(tc.hist_history) == len(jc.hist_history)
    for got, want in zip(tc.hist_history, jc.hist_history):
        assert got["iteration"] == want["iteration"]
        assert set(got["layers"]) == set(want["layers"])
        for lname, kinds in want["layers"].items():
            for kind, h in kinds.items():
                g = got["layers"][lname][kind]
                extent = max(abs(h["min"]), abs(h["max"]))
                for end in ("min", "max"):
                    assert abs(g[end] - h[end]) <= range_rel * extent, (
                        lname, kind, end, g[end], h[end])
                diff = np.abs(np.subtract(g["counts"], h["counts"])).sum()
                assert sum(g["counts"]) == sum(h["counts"])
                assert diff <= COUNT_SLACK, (lname, kind, g, h)


PAIRS = {"mln": mln_pair, "cg": cg_pair, "fused": fused_pair}


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kind", list(PAIRS))
def test_rows_match_jax(kind, k):
    """Iterator fits of 6 batches (``k`` steps a call, the feeder in both
    packages): every decoded row and histogram, and the fetch count."""
    tm, jm = PAIRS[kind]()
    n, b = (24, 4) if kind == "fused" else (48, 8)
    x, y = batches(kind, n)
    tc, jc = collectors()
    tm.set_telemetry(tc)
    jm.set_telemetry(jc)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), b), epochs=1, k_steps=k)
    jm.fit(JArrayIt(JDataSet(x, y), b), epochs=1, k_steps=k)
    assert tm.iteration == int(jm.train_state.iteration) == n // b
    assert_rows_agree(tc, jc, FUSED_RANGE_REL if kind == "fused"
                      else RANGE_REL)
    assert [r["iteration"] for r in tc.history] == list(range(1, n // b + 1))


def test_tbptt_segments_record_rows_like_jax():
    """Two TBPTT batches of 10 steps in segments of 4 (a ragged tail): a
    row a segment, as the JAX package records them."""
    from test_torch_tbptt import _data
    tm, jm = tbptt_pair()
    tc, jc = collectors(flush_interval=4, hist_interval=3)
    tm.set_telemetry(tc)
    jm.set_telemetry(jc)
    for seed in (0, 1):
        x, y, m = _data("lstm", 10, seed)
        tm.fit(DataSet(x, y, m, m))
        jm.fit(JDataSet(x, y, m, m))
    tc.flush(tm.train_state)
    jc.flush(jm.train_state)
    assert tm.iteration == int(jm.train_state.iteration) == 6
    assert_rows_agree(tc, jc)
    assert [r["loss"] for r in tc.history[3:]] == [
        float(v) for v in tm.last_segment_losses]


def test_nan_batch_counts_and_forces_the_histograms():
    """A batch with a NaN feature: the same exact count of non-finite
    gradient elements (plus the loss) in both packages, and the
    histograms written at that step although the interval was not due."""
    tm, jm = mln_pair()
    x, y = batches("mln", 32)
    x[9, 2] = np.nan                       # in the second batch of 8
    tc, jc = collectors(flush_interval=4, hist_interval=100)
    tm.set_telemetry(tc)
    jm.set_telemetry(jc)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), 8), epochs=1)
    jm.fit(JArrayIt(JDataSet(x, y), 8), epochs=1)
    nan_rows = [r for r in tc.history if r["nonfinite_count"] > 0]
    assert nan_rows and nan_rows[0]["iteration"] == 2
    assert [r["nonfinite_count"] for r in tc.history] == [
        r["nonfinite_count"] for r in jc.history]
    hist_iters = [h["iteration"] for h in tc.hist_history]
    assert hist_iters == [h["iteration"] for h in jc.hist_history]
    assert 1 in hist_iters and 2 in hist_iters


def test_registry_series_are_named_as_in_jax():
    tm, jm = mln_pair()
    x, y = batches("mln", 16)
    tc, jc = collectors(histograms=False)
    tm.set_telemetry(tc)
    jm.set_telemetry(jc)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), 8))
    jm.fit(JArrayIt(JDataSet(x, y), 8))

    def names(text):
        return sorted({line.split()[2] for line in text.splitlines()
                       if line.startswith("# TYPE")})
    got, want = names(tc.registry.render()), names(jc.registry.render())
    assert got == want
    assert {"dl4j_loss", "dl4j_grad_norm", "dl4j_iteration",
            "dl4j_nonfinite_values_total", "dl4j_update_ratio",
            "dl4j_telemetry_flushes_total"} <= set(got)


def test_one_fetch_per_interval_and_the_tail_flush():
    """Interval 4 over 10 steps: fetches at steps 4 and 8 and the tail
    flush when the fit ends — 3, in both packages."""
    tm, jm = mln_pair()
    x, y = batches("mln", 80)
    tc, jc = collectors(flush_interval=4, histograms=False)
    tm.set_telemetry(tc)
    jm.set_telemetry(jc)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), 8))
    jm.fit(JArrayIt(JDataSet(x, y), 8))
    assert tc.fetch_count == jc.fetch_count == 3
    assert len(tc.history) == 10


def test_ring_layout_is_one_tensor_and_replicas_wait_for_item_15():
    spec = TelemetrySpec(("a", "b"), capacity=4, histograms=True,
                         hist_bins=4, hist_capacity=2)
    buf = spec.init("cpu")
    for part in (buf.rows, buf.iters, buf.hist.counts, buf.hist.ranges,
                 buf.hist.iters, buf.hist.count):
        assert part.untyped_storage().data_ptr() == \
            buf.blob.untyped_storage().data_ptr()
    assert buf.iters.dtype == buf.hist.count.dtype == torch.int32
    assert (buf.iters == -1).all() and buf.count == 0
    # the replica ring (item 15's data-parallel half, ported) is views of
    # the same tensor, fetched in the same transfer
    rspec = TelemetrySpec(("a",), capacity=4, replicas=2)
    rbuf = rspec.init("cpu")
    for part in (rbuf.replica.rows, rbuf.replica.iters):
        assert part.untyped_storage().data_ptr() == \
            rbuf.blob.untyped_storage().data_ptr()
    assert rbuf.replica.rows.shape == (4, 2, 2)
    assert (rbuf.replica.iters == -1).all() and rbuf.replica.count == 0
    rbuf = rspec.record_replica(rbuf, values=torch.tensor([[1., 2.],
                                                           [3., 4.]]),
                                iteration=6)
    assert rbuf.replica.count == 1 and int(rbuf.replica.iters[0]) == 7
    tc = TelemetryCollector(flush_interval=1, capacity=4)
    with pytest.raises(RuntimeError, match="spec_for"):
        tc.enable_replicas(2)
