"""The port's ServingEngine on the CPU, over a narrow fused graph (stem +
two fused bottleneck blocks, filters 8): the bucket ladder, splitting and
reassembly of oversized requests, concurrent submits against
``model.output``, ``stats()`` and ``shutdown``."""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.convolution import (ConvolutionLayer,
                                                            ConvolutionMode,
                                                            PoolingType)
from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneckBlock
from deeplearning4j_tpu_torch.nn.layers.output import (GlobalPoolingLayer,
                                                       OutputLayer)
from deeplearning4j_tpu_torch.parallel.serving import ServingEngine

FEAT = (8, 8, 3)


def _model(compute_dtype="float32"):
    conf = (NeuralNetConfiguration.Builder().seed(5)
            .compute_dtype(compute_dtype)
            .graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.convolutional(*FEAT))
            .add_layer("stem", ConvolutionLayer(
                n_out=16, kernel_size=(3, 3),
                convolution_mode=ConvolutionMode.SAME), "in")
            .add_layer("b0", FusedBottleneckBlock(filters=8, stride=1,
                                                  downsample=True), "stem")
            .add_layer("b1", FusedBottleneckBlock(filters=8, stride=2,
                                                  downsample=True), "b0")
            .add_layer("pool", GlobalPoolingLayer(
                pooling_type=PoolingType.AVG), "b1")
            .add_layer("out", OutputLayer(n_out=5), "pool")
            .set_outputs("out")
            .build())
    return ComputationGraph(conf, device="cpu").init()


@pytest.fixture(scope="module")
def model():
    return _model()


def _x(rng, n):
    return rng.normal(0, 1, (n,) + FEAT).astype(np.float32)


@pytest.mark.parametrize("limit,min_bucket,ladder", [
    (8, 1, [1, 2, 4, 8]), (6, 1, [1, 2, 4, 6]), (8, 2, [2, 4, 8]),
    (8, 3, [4, 8]), (1, 1, [1])])
def test_ladder(model, limit, min_bucket, ladder):
    eng = ServingEngine(model, batch_limit=limit, min_bucket=min_bucket,
                        warmup=False)
    try:
        assert eng.ladder == ladder
        assert eng.bucket_of(1) == ladder[0]
        assert eng.bucket_of(limit) == limit
        with pytest.raises(ValueError):
            eng.bucket_of(limit + 1)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("n", [1, 3, 8, 19])
def test_answers_equal_model_output(model, n):
    """Padded (3), exact (8) and split (19 > batch_limit) requests."""
    rng = np.random.default_rng(n)
    with ServingEngine(model, batch_limit=8, feature_shape=FEAT) as eng:
        x = _x(rng, n)
        got = eng.output(x)
    assert got.shape == (n, 5)
    # the CPU's conv may pick another algorithm per batch size: allow a
    # last-bit difference (on the card chip_smoke.py checks bitwise)
    np.testing.assert_allclose(got, model.output(x).numpy(), rtol=1e-6,
                               atol=1e-7)


def test_concurrent_submits(model):
    rng = np.random.default_rng(0)
    reqs = [_x(rng, int(k)) for k in rng.integers(1, 14, 24)]
    answers = [None] * len(reqs)
    with ServingEngine(model, batch_limit=8, feature_shape=FEAT,
                       depth=2) as eng:
        def client(idx):
            futs = [(i, eng.submit(reqs[i])) for i in idx]
            for i, f in futs:
                answers[i] = f.result(timeout=60)
        threads = [threading.Thread(target=client,
                                    args=(range(t, len(reqs), 4),))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stats = eng.stats()
    for x, a in zip(reqs, answers):
        np.testing.assert_allclose(a, model.output(x).numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert stats["requests"] == sum(-(-len(x) // 8) for x in reqs)
    assert stats["inflight"] == 0 and stats["queue_depth"] == 0
    assert stats["batches"] >= -(-sum(len(x) for x in reqs) // 8)


def test_stats(model):
    with ServingEngine(model, batch_limit=4, feature_shape=FEAT) as eng:
        assert eng.stats()["requests"] == 0
        eng.output(_x(np.random.default_rng(1), 6))
        s = eng.stats()
    assert s["ladder"] == [1, 2, 4] and s["precision"] == "f32"
    assert s["batches"] == 2 and s["requests"] == 2
    assert set(s["latency_ms"]) == {"p50", "p95", "p99"}
    assert s["latency_ms"]["p50"] <= s["latency_ms"]["p99"]
    assert s["warmup_s"] > 0 and s["device"] == "cpu"


def test_bf16_precision_commits_a_bf16_copy():
    m = _model("bfloat16")
    x = _x(np.random.default_rng(2), 5)
    with ServingEngine(m, batch_limit=8, feature_shape=FEAT,
                       precision="bf16") as eng:
        assert all(v.dtype == torch.bfloat16 for lp in eng._params.values()
                   for v in lp.values())
        assert all(v.dtype == torch.float32 for st in eng._state.values()
                   for k, v in st.items() if k.endswith(("mean", "var")))
        assert "bn1_scale" in eng._state["b0"]       # folded at commit
        got = eng.output(x)
    assert m.params["stem"]["W"].dtype == torch.float32   # model untouched
    np.testing.assert_allclose(got, m.output(x).float().numpy(), rtol=1e-2,
                               atol=1e-3)


def test_shutdown(model):
    eng = ServingEngine(model, batch_limit=4, feature_shape=FEAT)
    eng.output(_x(np.random.default_rng(3), 2))
    eng.shutdown()
    eng.shutdown()                                   # idempotent
    assert not eng._dispatcher.is_alive()
    assert not eng._completer.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(_x(np.random.default_rng(3), 1))


def test_rejects_bad_requests_and_options(model):
    with pytest.raises(ValueError):
        ServingEngine(model, batch_limit=0)
    with pytest.raises(ValueError):
        ServingEngine(model, batch_limit=4, min_bucket=5)
    with pytest.raises(ValueError, match="int8"):
        ServingEngine(model, precision="int8")
    with ServingEngine(model, batch_limit=4, feature_shape=FEAT) as eng:
        with pytest.raises(ValueError, match="feature shape"):
            eng.submit(np.zeros((1, 4, 4, 3), np.float32))
        with pytest.raises(ValueError, match="non-empty"):
            eng.submit(np.zeros((0,) + FEAT, np.float32))
