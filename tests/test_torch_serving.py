"""The port's ServingEngine on the CPU, over a narrow fused graph (stem +
two fused bottleneck blocks, filters 8): the bucket ladder, splitting and
reassembly of oversized requests, concurrent submits against
``model.output``, ``stats()`` and ``shutdown``. Then what the CLI and
the fleet call: a ``MultiLayerNetwork`` served, deadlines, param swaps,
the ``dl4j_serving_*`` series against the JAX engine's, the warmup's first dispatches, and the options that are not
ported yet."""

import threading
import time

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
from deeplearning4j_tpu_torch.parallel.quant import QuantizationError
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
        params, _, state = eng._committed
        assert all(v.dtype == torch.bfloat16 for lp in params.values()
                   for v in lp.values())
        assert all(v.dtype == torch.float32 for st in state.values()
                   for k, v in st.items() if k.endswith(("mean", "var")))
        assert "bn1_scale" in state["b0"]            # folded at commit
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
    # int8 quantizes MultiLayerNetworks only (parallel/quant.py)
    with pytest.raises(QuantizationError, match="ComputationGraph"):
        ServingEngine(model, precision="int8")
    with ServingEngine(model, batch_limit=4, feature_shape=FEAT) as eng:
        with pytest.raises(ValueError, match="feature shape"):
            eng.submit(np.zeros((1, 4, 4, 3), np.float32))
        with pytest.raises(ValueError, match="non-empty"):
            eng.submit(np.zeros((0,) + FEAT, np.float32))


def _at_bucket(model, x, bucket):
    pad = np.concatenate([x, np.repeat(x[-1:], bucket - len(x), 0)])
    return model.output(pad).numpy()[:len(x)]


@pytest.fixture(scope="module")
def lstm():
    from deeplearning4j_tpu_torch.models.serialization import \
        restore_multi_layer_network
    from pathlib import Path
    return restore_multi_layer_network(str(
        Path(__file__).parent / "resources" / "regression" / "lstm_v1.zip"),
        device="cpu")


def test_serves_a_multi_layer_network_bitwise_at_the_bucket(lstm):
    """An LSTM ``MultiLayerNetwork`` (no ``inference_state``): padded (3)
    and split (6 > 4) requests equal the model's forward at the bucket
    shape bitwise."""
    rng = np.random.default_rng(7)
    with ServingEngine(lstm, batch_limit=4, feature_shape=(12, 2)) as eng:
        assert eng.ladder == [1, 2, 4]
        x3 = rng.normal(size=(3, 12, 2)).astype(np.float32)
        assert np.array_equal(eng.output(x3), _at_bucket(lstm, x3, 4))
        x6 = rng.normal(size=(6, 12, 2)).astype(np.float32)
        want = np.concatenate([_at_bucket(lstm, x6[:4], 4),
                               _at_bucket(lstm, x6[4:], 2)])
        assert np.array_equal(eng.output(x6), want)
        eng.assert_warm()
        assert eng.stats()["params_resident_bytes"] == sum(
            v.numel() * 4 for lp in lstm.params.values()
            for v in lp.values())


def test_deadline_sheds_at_ingress_and_while_queued(model):
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.deadline import (
        Deadline, DeadlineExceeded)
    reg = MetricsRegistry()
    x = _x(np.random.default_rng(8), 2)
    with ServingEngine(model, batch_limit=4, feature_shape=FEAT,
                       registry=reg, session_id="dl") as eng:
        with pytest.raises(DeadlineExceeded, match="ingress"):
            eng.submit(x, deadline=Deadline(time.monotonic() - 1.0))
        # a budget that is live at ingress (the clock's first read) and
        # spent at batch forming (every later read)
        reads = iter([0.0])
        late = Deadline(1.0, clock=lambda: next(reads, 2.0))
        f = eng.submit(x, deadline=late)
        with pytest.raises(DeadlineExceeded, match="queued"):
            f.result(timeout=30)
        assert eng.output(x, deadline=Deadline.after_ms(60e3)).shape == \
            (2, 5)
    shed = reg.get_metric("dl4j_serving_deadline_shed_total")
    assert shed.get(session="dl", precision="f32", stage="ingress") == 1.0
    assert shed.get(session="dl", precision="f32", stage="batch") == 1.0


def test_swap_params_keeps_the_ladder_warm(model):
    """New weights of the same structure serve through the warm ladder
    (no first dispatch after warmup); a mismatch raises before anything
    is committed; ``committed_host`` gives copies, never views."""
    other = _model()
    with torch.no_grad():
        for lp in other.params.values():
            for v in lp.values():
                v.mul_(0.5)
    x = _x(np.random.default_rng(9), 3)
    with ServingEngine(model, batch_limit=4, feature_shape=FEAT) as eng:
        before = eng.output(x)
        host_p, host_s = eng.committed_host()
        eng.swap_params(other.params, other.model_state, version="v2")
        assert eng.model_version == "v2" and eng.param_swaps == 1
        np.testing.assert_allclose(eng.output(x), other.output(x).numpy(),
                                   rtol=1e-6, atol=1e-7)
        bad = {k: dict(v) for k, v in other.params.items()}
        bad["out"]["W"] = torch.zeros(3, 3)
        with pytest.raises(ValueError, match="leaf"):
            eng.swap_params(bad)
        with pytest.raises(ValueError, match="structure"):
            eng.swap_params({"out": other.params["out"]})
        eng.swap_params(host_p, host_s)
        assert np.array_equal(eng.output(x), before)
        eng.assert_warm()
        assert eng.recompiles_after_warmup == 0
    assert host_p["stem"]["W"].data_ptr() != \
        model.params["stem"]["W"].data_ptr()


@pytest.mark.parametrize("kw,item", [
    (dict(replicas=2), "item 15"),
])
def test_unported_options_raise_with_their_roadmap_item(model, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        ServingEngine(model, batch_limit=2, warmup=False, **kw)


def test_replicas_auto_is_one_off_the_card(model):
    with ServingEngine(model, batch_limit=2, warmup=False,
                       replicas="auto") as eng:
        assert eng.stats()["replicas"] == 1


def test_warmup_counts_first_dispatches_and_no_recompile(model):
    """The sweep makes each bucket's first dispatch (phase warmup); live
    traffic at every bucket adds none and the watchdog stays at 0, so
    the process's /healthz verdict stays ok."""
    from deeplearning4j_tpu_torch.observe.health import health_status
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    reg = MetricsRegistry()
    rng = np.random.default_rng(11)
    with ServingEngine(model, batch_limit=4, feature_shape=FEAT,
                       registry=reg, session_id="warm") as eng:
        for n in (1, 2, 3, 4, 9):
            eng.output(_x(rng, n))
        eng.assert_warm()
    comp = reg.get_metric("dl4j_serving_compiles_total")
    lab = dict(session="warm", precision="f32")
    assert comp.get(phase="warmup", **lab) == 3.0
    assert comp.get(phase="live", **lab) == 0.0
    assert reg.get_metric("dl4j_recompiles_total").get(
        session="warm") == 0.0
    assert health_status(reg)["status"] == "ok"
    with ServingEngine(model, batch_limit=4, registry=reg,
                       session_id="cold") as cold:   # no warmup sweep
        cold.output(_x(rng, 1))
        with pytest.raises(AssertionError, match="after warmup"):
            cold.assert_warm()


def test_serving_series_match_the_jax_engine(model):
    """The same traffic through both packages' engines publishes the same
    ``dl4j_serving_*`` names with the same label keys (the persisted AOT
    cache's series aside: it is not ported)."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.inputs import InputType as JType
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JD
    from deeplearning4j_tpu.nn.layers.output import OutputLayer as JO
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    from deeplearning4j_tpu.parallel.serving import ServingEngine as JEngine
    from deeplearning4j_tpu.parallel.deadline import Deadline as JDeadline
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.deadline import Deadline
    jm = JMLN(JConf.Builder().seed(1).list().layer(JD(n_out=4))
              .layer(JO(n_out=3)).set_input_type(JType.feed_forward(5))
              .build()).init()
    series = []
    for make, dl in ((lambda r: JEngine(jm, batch_limit=4,
                                        feature_shape=(5,), registry=r),
                      JDeadline),
                     (lambda r: ServingEngine(model, batch_limit=4,
                                              feature_shape=FEAT,
                                              registry=r), Deadline)):
        reg = JRegistry() if dl is JDeadline else MetricsRegistry()
        eng = make(reg)
        try:
            shape = eng.feature_shape
            eng.output(np.zeros((3,) + shape, np.float32))
            with pytest.raises(Exception):
                eng.submit(np.zeros((1,) + shape, np.float32),
                           deadline=dl(time.monotonic() - 1.0))
        finally:
            eng.shutdown()
        found = set()
        for line in reg.render().splitlines():
            if line.startswith("dl4j_serving_"):
                name, _, rest = line.partition("{")
                keys = tuple(sorted(kv.split("=")[0]
                                    for kv in rest.split("}")[0].split(",")))
                found.add((name, keys))
        series.append(found)
    jax_series, port_series = series
    assert port_series == jax_series


def test_traced_engine_answers_bitwise_with_the_jax_span_names(model):
    """An engine with a SpanTracer answers bitwise as one without, and its
    trace holds the JAX engine's span names for the same traffic: the
    warmup and each bucket's first dispatch, and per batch ``queue_wait``
    (one a request), ``batch_form``, ``dispatch``, ``device`` and
    ``fetch``."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.inputs import InputType as JType
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JD
    from deeplearning4j_tpu.nn.layers.output import OutputLayer as JO
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    from deeplearning4j_tpu.observe.tracer import SpanTracer as JTracer
    from deeplearning4j_tpu.parallel.serving import ServingEngine as JEngine
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.observe.tracer import SpanTracer
    rng = np.random.default_rng(5)
    reqs = [_x(rng, n) for n in (1, 3, 4, 2)]
    tracer = SpanTracer()
    answers = []
    for tr in (None, tracer):
        with ServingEngine(model, batch_limit=4, feature_shape=FEAT,
                           registry=MetricsRegistry(), tracer=tr) as eng:
            answers.append([eng.output(x) for x in reqs])
    for got, want in zip(answers[1], answers[0]):
        np.testing.assert_array_equal(got, want)
    jm = JMLN(JConf.Builder().seed(1).list().layer(JD(n_out=4))
              .layer(JO(n_out=3)).set_input_type(JType.feed_forward(5))
              .build()).init()
    jtracer = JTracer()
    jeng = JEngine(jm, batch_limit=4, feature_shape=(5,),
                   registry=JRegistry(), tracer=jtracer)
    try:
        for x in reqs:
            jeng.output(np.zeros((x.shape[0], 5), np.float32))
    finally:
        jeng.shutdown()
    names = lambda t: {e["name"] for e in t.events}
    assert names(tracer) == names(jtracer) == {
        "serve_compile", "serve_warmup", "queue_wait", "batch_form",
        "dispatch", "device", "fetch"}
    per_batch = [e["name"] for e in tracer.events
                 if e["name"] in ("batch_form", "dispatch", "device",
                                  "fetch")]
    assert per_batch.count("batch_form") == per_batch.count("fetch") == \
        sum(1 for e in tracer.events if e["name"] == "device") == 4
    assert sum(e["name"] == "queue_wait" for e in tracer.events) == 4
