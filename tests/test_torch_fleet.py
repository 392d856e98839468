"""The port's FleetRouter (``parallel/fleet.py``) on the CPU, case by case
as the JAX package's ``tests/test_fleet.py``, plus the generation pool
(the JAX ``tests/test_generation.py`` admission case), session affinity,
param-only promotion and the parts that are not ported yet.

The contract under test:

- a shed request fails FAST with ``ShedError`` (reason ``"queue"``,
  ``"slo"`` or ``"deadline"``) raised synchronously from submit;
- dispatch goes to the least-loaded engine of the active version;
- ``swap()`` warms the new version before switching, keeps the old one
  as rollback standby, and ``rollback()`` flips back; every answer is
  bitwise the answering version's own forward at the bucket shape (the
  engine pads a request to its bucket by repeating the last row; the
  CPU's gemv at one row and gemm at several differ in the last bits, so
  a bucket-shaped forward is the bitwise reference, as
  ``tests/test_torch_serving.py`` states);
- the AIMD controller reacts to the WINDOWED p99;
- ``dl4j_fleet_*`` series render.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.parallel.deadline import Deadline
from deeplearning4j_tpu_torch.parallel.fleet import (
    FleetRouter,
    ShedError,
    _materialize,
)

N_IN = 5


def _tiny_model(seed: int = 1):
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _router(**kw):
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("window_s", 10.0)     # controller quiet unless asked
    return FleetRouter(**kw)


def _pool_kw():
    return dict(batch_limit=8, feature_shape=(N_IN,))


def _at_bucket(model, x, bucket):
    """``model``'s answer to ``x`` computed as the engine computes it: at
    the bucket shape, padded with the last row."""
    pad = np.concatenate([x, np.repeat(x[-1:], bucket - len(x), 0)])
    return model.output(pad).numpy()[:len(x)]


class Slow:
    """Duck-typed model whose forward blocks — lets tests hold requests
    in flight deterministically."""

    def __init__(self, delay=0.2):
        self.delay = delay

    def output(self, x):
        time.sleep(self.delay)
        return np.zeros((x.shape[0], 3), np.float32)


class TestAdmission:
    def test_queue_shed_fails_fast_distinct_error(self):
        with _router(max_pending=1) as r:
            r.add_pool("slow", Slow(), batch_limit=2)
            f1 = r.submit(np.zeros((1, N_IN), np.float32), model="slow")
            t0 = time.perf_counter()
            with pytest.raises(ShedError) as ei:
                r.submit(np.zeros((1, N_IN), np.float32), model="slow")
            assert time.perf_counter() - t0 < 0.1
            assert ei.value.reason == "queue"
            assert ei.value.model == "slow"
            assert "shed by fleet admission control" in str(ei.value)
            f1.result(timeout=5)        # the admitted one still lands

    def test_slo_shed_reason_and_recovery(self):
        reg = MetricsRegistry()
        with _router(slo_ms=50.0, window_s=0.01, registry=reg) as r:
            r.add_pool("m", _tiny_model(), **_pool_kw())
            pool = r.pool("m")
            for _ in range(20):
                pool.ring.record(0.5)           # 500 ms >> 50 ms SLO
            pool._last_tick = 0.0
            with pool.lock:
                pool._tick_controller(time.monotonic())
            assert pool.shed_fraction == pytest.approx(r.shed_step)
            pool._rand.random = lambda: 0.0     # always shed
            with pytest.raises(ShedError) as ei:
                r.submit(np.zeros((1, N_IN), np.float32), model="m")
            assert ei.value.reason == "slo"
            pool._rand.random = lambda: 1.0
            for _ in range(8):
                for _ in range(20):
                    pool.ring.record(0.001)
                pool._last_tick = 0.0
                with pool.lock:
                    pool._tick_controller(time.monotonic())
            assert pool.shed_fraction == 0.0
            r.output(np.zeros((1, N_IN), np.float32), model="m")
            rendered = reg.render()
            assert 'dl4j_fleet_shed_total' in rendered
            assert 'reason="slo"' in rendered

    def test_windowed_not_cumulative(self):
        with _router(slo_ms=50.0, window_s=0.01) as r:
            r.add_pool("m", _tiny_model(), **_pool_kw())
            pool = r.pool("m")
            for _ in range(50):
                pool.ring.record(0.5)
            pool._last_tick = 0.0
            with pool.lock:
                pool._tick_controller(time.monotonic())
            assert pool.windowed_p99_ms > 50.0
            for _ in range(50):
                pool.ring.record(0.001)
            pool._last_tick = 0.0
            with pool.lock:
                pool._tick_controller(time.monotonic())
            assert pool.windowed_p99_ms < 50.0

    def test_expired_deadline_sheds_before_admission(self):
        reg = MetricsRegistry()
        with _router(registry=reg) as r:
            pool = r.add_pool("m", _tiny_model(), **_pool_kw())
            with pytest.raises(ShedError) as ei:
                r.submit(np.zeros((1, N_IN), np.float32),
                         deadline=Deadline(time.monotonic() - 1.0))
            assert ei.value.reason == "deadline"
            assert pool.pending == 0
            assert reg.get_metric("dl4j_fleet_shed_total").get(
                model="m", reason="deadline") == 1.0


class TestDispatch:
    def test_least_loaded(self):
        with _router() as r:
            r.add_pool("m", _tiny_model(), pool_size=2, **_pool_kw())
            pool = r.pool("m")

            class Fake:
                def __init__(self, inflight):
                    self.inflight = inflight
            real = pool.engines
            try:
                a, b = Fake(3), Fake(1)
                pool.engines = [a, b]
                assert pool.least_loaded() is b
                b.inflight = 5
                assert pool.least_loaded() is a
            finally:
                pool.engines = real

    def test_pool_serves_bitwise(self):
        m = _tiny_model()
        rng = np.random.default_rng(0)
        with _router() as r:
            r.add_pool("m", m, pool_size=2, **_pool_kw())
            for n, bucket in ((1, 1), (3, 4), (8, 8)):
                x = rng.normal(size=(n, N_IN)).astype(np.float32)
                assert np.array_equal(r.output(x), _at_bucket(m, x, bucket))
            r.assert_warm()

    def test_default_pool_and_unknown_model(self):
        with _router() as r:
            r.add_pool("only", _tiny_model(), **_pool_kw())
            r.output(np.zeros((1, N_IN), np.float32))   # no name needed
            with pytest.raises(ValueError, match="no pool named"):
                r.submit(np.zeros((1, N_IN), np.float32), model="nope")


class TestSwapRollback:
    def test_swap_bitwise_then_rollback(self):
        reg = MetricsRegistry()
        m1, m2 = _tiny_model(1), _tiny_model(2)
        x = np.random.default_rng(3).normal(
            size=(3, N_IN)).astype(np.float32)
        with _router(registry=reg) as r:
            r.add_pool("m", m1, version="v1", **_pool_kw())
            assert np.array_equal(r.output(x), _at_bucket(m1, x, 4))
            pool = r.swap("m", m2, "v2")
            assert pool.active_version == "v2"
            assert pool.standby[0] == "v1"
            assert np.array_equal(r.output(x), _at_bucket(m2, x, 4))
            r.assert_warm()             # standby stays warm too
            r.rollback("m")
            assert pool.active_version == "v1"
            assert pool.standby[0] == "v2"
            assert np.array_equal(r.output(x), _at_bucket(m1, x, 4))
            rendered = reg.render()
            assert 'event="swap"' in rendered
            assert 'event="rollback"' in rendered

    def test_second_swap_retires_oldest(self):
        m1, m2, m3 = _tiny_model(1), _tiny_model(2), _tiny_model(3)
        with _router() as r:
            r.add_pool("m", m1, version="v1", **_pool_kw())
            r.swap("m", m2, "v2")
            v1_engines = r.pool("m").standby[1]
            r.swap("m", m3, "v3")
            pool = r.pool("m")
            assert pool.active_version == "v3"
            assert pool.standby[0] == "v2"
            for e in v1_engines:
                with pytest.raises(RuntimeError, match="shut down"):
                    e.submit(np.zeros((1, N_IN), np.float32))

    def test_rollback_without_standby_raises(self):
        with _router() as r:
            r.add_pool("m", _tiny_model(), **_pool_kw())
            with pytest.raises(RuntimeError, match="no standby"):
                r.rollback("m")

    def test_promote_then_rollback_params_bitwise_no_compile(self):
        """Param-only promotion pushes v2's weights into v1's warm engine
        (no new engine, no compile) and ``rollback_params`` restores v1
        bitwise."""
        reg = MetricsRegistry()
        m1, m2 = _tiny_model(1), _tiny_model(2)
        x = np.random.default_rng(4).normal(
            size=(3, N_IN)).astype(np.float32)
        with _router(registry=reg) as r:
            pool = r.add_pool("m", m1, version="v1", **_pool_kw())
            engine = pool.engines[0]
            before = r.output(x)
            r.promote_params("m", m2.params, m2.model_state, version="v2")
            assert pool.engines[0] is engine
            assert pool.active_version == "v2"
            assert np.array_equal(r.output(x), _at_bucket(m2, x, 4))
            r.rollback_params("m")
            assert pool.active_version == "v1"
            assert np.array_equal(r.output(x), before)
            engine.assert_warm()
            assert engine.param_swaps == 2
            rendered = reg.render()
            assert 'event="param_swap"' in rendered
            assert 'event="param_rollback"' in rendered


class TestMaterialize:
    def test_factory_and_builtin(self):
        m = _tiny_model()
        assert _materialize(m, "p") is m
        assert _materialize(lambda: m, "p") is m

    def test_zoo_name(self, monkeypatch):
        from deeplearning4j_tpu_torch.zoo import models as zoo_models
        m = _tiny_model()
        monkeypatch.setattr(zoo_models, "TinyTestEntry", lambda: m,
                            raising=False)
        assert _materialize("TinyTestEntry", "p") is m
        with pytest.raises(ValueError, match="no zoo model"):
            _materialize("NoSuchZooModel", "p")
        # a zoo entry class initializes on the router's device
        lenet = _materialize("LeNet", "p", device="cpu")
        assert lenet.device.type == "cpu"


class TestStatsAndMetrics:
    def test_stats_and_series(self):
        reg = MetricsRegistry()
        with _router(registry=reg, slo_ms=100.0) as r:
            r.add_pool("m", _tiny_model(), **_pool_kw())
            for _ in range(3):
                r.output(np.zeros((2, N_IN), np.float32))
            st = r.stats()
            p = st["pools"]["m"]
            assert p["active_version"] == "v1"
            assert p["pending"] == 0
            assert p["requests"] == 3
            assert p["engines"][0]["precision"] == "f32"
            assert st["slo_ms"] == 100.0
            rendered = reg.render()
            for series in ("dl4j_fleet_admitted_total",
                           "dl4j_fleet_pool_depth",
                           "dl4j_fleet_pool_engines"):
                assert series in rendered, series

    def test_shed_maps_to_http_503(self):
        from deeplearning4j_tpu_torch.ui.serving_module import FleetModule

        class Refusing:
            def output(self, features, model=None):
                raise ShedError("m", "slo", "over SLO")
        payload, headers, status = FleetModule(Refusing())._predict(
            None, {}, {"features": [[0.0] * N_IN]})
        assert status == 503
        assert payload == {"error": "shed", "model": "m",
                           "reason": "slo"}
        assert headers == {"Retry-After": "1"}


# ---- generation pools --------------------------------------------------

SMALL_VOCAB = 31


@pytest.fixture(scope="module")
def gen_model():
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    return TextGenerationLSTM(vocab_size=SMALL_VOCAB, timesteps=8,
                              lstm_units=32, seed=3).init(device="cpu")


def test_generation_pool_shed(gen_model):
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    eng = GenerationEngine(gen_model, max_slots=1, stop_text=None,
                           registry=MetricsRegistry(), session_id="gen-shed")
    fleet = FleetRouter(max_pending=1, registry=MetricsRegistry(),
                        session_id="gen-shed")
    fleet.add_generation_pool("gen", eng)
    try:
        first = fleet.generate([1], max_new_tokens=200)
        with pytest.raises(ShedError) as exc:
            fleet.generate([2], max_new_tokens=5)
        assert exc.value.reason == "queue"
        first.cancel()
        first.result(timeout=60)
        deadline = time.time() + 10
        while fleet.generation_pool("gen").pending and \
                time.time() < deadline:
            time.sleep(0.01)
        assert fleet.generate([2], max_new_tokens=5).result(
            timeout=60)["reason"] == "length"
        st = fleet.stats()["generation"]["gen"]
        assert st["pending"] == 0
        assert st["engine"]["slots"]["max"] == 1
        fleet.assert_warm()
    finally:
        fleet.shutdown()


def test_session_affinity_routes_to_the_pool_holding_the_carry(gen_model):
    """Two generation pools with session stores: a token's second turn
    goes to the pool whose store holds its carry, and resumes it."""
    from deeplearning4j_tpu_torch.generation import (
        GenerationEngine, SessionStore, extract_decode_spec,
        reference_decode)
    spec = extract_decode_spec(gen_model)
    engines = [GenerationEngine(
        gen_model, max_slots=2, stop_text=None,
        registry=MetricsRegistry(), session_id=f"aff-{i}",
        session_store=SessionStore(spec, registry=MetricsRegistry(),
                                   device="cpu"))
        for i in range(2)]
    fleet = FleetRouter(registry=MetricsRegistry(), session_id="aff")
    for i, e in enumerate(engines):
        fleet.add_generation_pool(f"g{i}", e)
    try:
        prompt, turn = [4, 8, 15], 6
        full = reference_decode(gen_model, prompt, 2 * turn)
        a = fleet.generate(prompt, model="g1", max_new_tokens=turn,
                           session="tok").result(timeout=60)
        assert a["ids"] == full[:turn]
        assert fleet._session_affinity("tok").name == "g1"
        b = fleet.generate([], max_new_tokens=turn,
                           session="tok").result(timeout=60)
        assert b["ids"] == full[turn:]
        assert engines[1].session_store.hits["device"] == 1
        assert engines[0].session_store.hits["device"] == 0
    finally:
        fleet.shutdown()


# ---- not ported yet ----------------------------------------------------

def test_unported_parts_raise_with_their_roadmap_item(tmp_path):
    """The router's ``aot_cache_dir`` and ``tuned_config``, which raised
    until the kernel cache and tuned configs were ported, now reach its
    engines: ``<dir>/<pool>`` as each engine's cache and the tuned
    ``serving.batch_limit`` where the pool leaves it unset."""
    from deeplearning4j_tpu_torch.optimize.autotune import TunedConfig
    fleet = FleetRouter(aot_cache_dir=str(tmp_path / "aot"),
                        tuned_config=TunedConfig({"serving.batch_limit": 4}),
                        registry=MetricsRegistry())
    try:
        pool = fleet.add_pool("m", _tiny_model(), feature_shape=(N_IN,))
        eng = pool.engines[0]
        assert eng.batch_limit == 4 and eng.ladder == [1, 2, 4]
        assert eng.stats()["aot_cache"]["dir"] == str(tmp_path / "aot" / "m")
        assert (tmp_path / "aot" / "m" / "manifest.json").exists()
    finally:
        fleet.shutdown()


def test_concurrent_clients_through_the_router():
    m = _tiny_model()
    rng = np.random.default_rng(5)
    reqs = [rng.normal(size=(int(k), N_IN)).astype(np.float32)
            for k in rng.integers(1, 12, 24)]
    answers = [None] * len(reqs)
    with _router() as r:
        r.add_pool("m", m, **_pool_kw())

        def client(idx):
            for i in idx:
                answers[i] = r.output(reqs[i])
        threads = [threading.Thread(target=client,
                                    args=(range(t, len(reqs), 4),))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert r.pool("m").pending == 0
    for x, a in zip(reqs, answers):
        np.testing.assert_allclose(a, m.output(x).numpy(), rtol=1e-6,
                                   atol=1e-7)
