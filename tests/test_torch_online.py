"""The port's online-learning tier (online/, ui/online_module.py,
``serve --online``) on the CPU, against the JAX package's.

- **Promoter and sentinel.** The scripted score calculators of the JAX
  package's tests/test_online.py give the same decision sequences
  (promoted, reason, scores, version) in both packages, and the same
  sentinel verdicts; a rejected candidate leaves the committed params
  bitwise, a rollback restores them bitwise.
- **Learner.** Over the same published stream, the port's learner ends
  with parameters within 1e-4 of each array's largest magnitude of the
  JAX learner's (float32; the same math summed in other orders, the
  bound tests/test_torch_train.py sets for a slice), for the narrow
  MultiLayerNetwork of test_online.py and for a two-block
  fused-bottleneck graph (the JAX side runs its Pallas kernels in
  interpret mode, the port the kernels' plain versions).
- **Threads and copies.** A snapshot taken while the learner trains is a
  CPU copy of its params at a step boundary; the three model copies and
  the engine's committed copy share no storage; ``learner.stop()`` ends
  an unbounded fit on an idle topic, and its feeder threads, within its
  timeout.
- **End to end.** The JAX package's learn-promote-serve test on the
  port's CPU path, the UI routes, and ``serve --online`` over a TCP
  broker.

Every threaded test bounds its waits with a deadline in the code.
"""

import json
import math
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.serialization import flatten_paths
from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.online import (OnlineLearner, OnlineServing,
                                             PromotionController,
                                             RegressionSentinel,
                                             SampleStreamIterator,
                                             publish_samples)
from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter
from deeplearning4j_tpu_torch.streaming.broker import (InProcessTransport,
                                                       TcpTransport)

N_IN, N_OUT = 5, 3
PARAM_REL = 1e-4
REPO = Path(__file__).resolve().parents[1]


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
            .layer(OutputLayer(n_out=N_OUT, loss=LossFunction.MCXENT))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _jax_tiny_model(seed: int = 1):
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.losses import LossFunction
    from deeplearning4j_tpu.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=N_OUT, loss=LossFunction.MCXENT))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    return MultiLayerNetwork(conf).init()


def _batch(rng, n):
    x = rng.normal(size=(n, N_IN)).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, size=n)]
    return x, y


def _host(router):
    return router.pool("m").engines[0].committed_host()


def _trees_equal(a, b):
    fa, fb = flatten_paths(a), flatten_paths(b)
    return set(fa) == set(fb) and all(
        torch.equal(torch.as_tensor(np.asarray(fa[k])),
                    torch.as_tensor(np.asarray(fb[k]))) for k in fa)


class _ScriptedCalc:
    """ScoreCalculator stand-in: scripted scores in call order (the
    candidate first, then the lazy active baseline), as test_online.py's."""
    minimize_score = True

    def __init__(self, scores):
        self.scores = list(scores)

    def calculate_score(self, model):
        s = self.scores.pop(0)
        if isinstance(s, Exception):
            raise s
        return s


class _Pkg:
    """One package's online pieces, so a test can drive both alike."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        if jax_side:
            from deeplearning4j_tpu.datasets.dataset import DataSet as D
            from deeplearning4j_tpu.observe.registry import \
                MetricsRegistry as R
            from deeplearning4j_tpu.online import (OnlineLearner as L,
                                                   PromotionController as P,
                                                   RegressionSentinel as S,
                                                   SampleStreamIterator as I)
            from deeplearning4j_tpu.parallel.fleet import FleetRouter as F
            from deeplearning4j_tpu.streaming.broker import \
                InProcessTransport as T
        else:
            D, R, L, P, S, I, F, T = (
                DataSet, MetricsRegistry, OnlineLearner, PromotionController,
                RegressionSentinel, SampleStreamIterator, FleetRouter,
                InProcessTransport)
        self.DataSet, self.Registry, self.Learner = D, R, L
        self.Controller, self.Sentinel, self.Stream = P, S, I
        self.Router, self.Transport = F, T

    def model(self, seed=1):
        return _jax_tiny_model(seed) if self.jax else _tiny_model(seed)

    def router(self):
        r = self.Router(registry=self.Registry())
        r.add_pool("m", self.model(), version="v0", feature_shape=(N_IN,),
                   batch_limit=8)
        return r

    def controller(self, router, calc, holdout=8, **kw):
        s = self.Stream(self.Transport(), "t", registry=self.Registry())
        if holdout:
            s._add_holdout(self.DataSet(*_batch(np.random.default_rng(0),
                                                holdout)))
        model = self.model(seed=3)
        return self.Controller(router, "m", self.Learner(model, s), calc,
                               model.clone(), registry=self.Registry(), **kw)


def _decision(d):
    return (d.promoted, d.reason, d.candidate_score, d.active_score,
            d.version, d.iteration, d.over_budget)


def _same(a, b):
    """Decision tuples equal, NaN equal to NaN."""
    return len(a) == len(b) and all(
        x == y or (isinstance(x, float) and isinstance(y, float)
                   and math.isnan(x) and math.isnan(y))
        for x, y in zip(a, b))


# ---- promoter and sentinel: the JAX package's decisions ------------------

SCRIPTS = {
    "worse": ([2.0, 1.0], {}),
    "equal": ([1.0, 1.0], {}),
    "within_min_delta": ([0.95, 1.0], {"min_delta": 0.1}),
    "nan": ([float("nan")], {}),
    "inf": ([math.inf], {}),
    "error": ([RuntimeError("holdout exploded")], {}),
    "improved": ([0.5, 1.0], {}),
    # three cycles: improved, then worse than the new active, improved
    "sequence": ([0.5, 1.0, 0.6, 0.4, 0.4], {}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_promotion_decisions_match_jax(name):
    scores, kw = SCRIPTS[name]
    cycles = 3 if name == "sequence" else 1
    seqs = []
    for pkg in (_Pkg(False), _Pkg(True)):
        router = pkg.router()
        try:
            before = _host(router)
            ctl = pkg.controller(router, _ScriptedCalc(scores), **kw)
            seq = [_decision(ctl.run_once()) for _ in range(cycles)]
            seqs.append(seq + [(ctl.promotions, ctl.rejections,
                                router.pool("m").active_version)])
            if not any(d[0] for d in seq) and not pkg.jax:
                # a rejected candidate never reaches serving
                assert _trees_equal(before[0], _host(router)[0])
                assert _trees_equal(before[1], _host(router)[1])
        finally:
            router.shutdown()
    assert all(_same(a, b) for a, b in zip(*seqs)), seqs


@pytest.mark.parametrize("jax_side", [False, True], ids=["port", "jax"])
def test_no_holdout_and_no_candidate_never_promote(jax_side):
    pkg = _Pkg(jax_side)
    router = pkg.router()
    try:
        ctl = pkg.controller(router, _ScriptedCalc([]), holdout=0)
        assert _decision(ctl.run_once())[:2] == (False, "no_holdout")

        class Idle:
            stream = ctl.learner.stream

            def snapshot(self):
                return None
        ctl.learner = Idle()
        assert _decision(ctl.run_once())[:2] == (False, "no_candidate")
    finally:
        router.shutdown()


SENTINEL_SCRIPTS = {
    "score": (lambda: 5.0, {"score_delta": 0.5}),
    "nan": (lambda: float("nan"), {}),
    "survives": (lambda: 0.4, {"window_s": 0.0}),
    "probe_error": (lambda: 1 / 0, {"window_s": 3600.0}),
}


@pytest.mark.parametrize("name", sorted(SENTINEL_SCRIPTS))
def test_sentinel_verdicts_match_jax(name):
    score_fn, kw = SENTINEL_SCRIPTS[name]
    verdicts = []
    for pkg in (_Pkg(False), _Pkg(True)):
        router = pkg.router()
        try:
            good = _host(router)
            rolled = []
            sentinel = pkg.Sentinel(router, "m", score_fn=score_fn,
                                    on_rollback=rolled.append,
                                    registry=pkg.Registry(), **kw)
            ctl = pkg.controller(router, _ScriptedCalc([0.5, 1.0]))
            ctl.sentinel = sentinel
            assert ctl.run_once().promoted
            time.sleep(0.01)
            got = sentinel.check()
            verdicts.append((got, rolled, sentinel.watching,
                             sentinel.rollbacks,
                             router.pool("m").active_version))
            if got is not None and not pkg.jax:
                # rolled back to the pre-swap params, bitwise
                assert _trees_equal(good[0], _host(router)[0])
        finally:
            router.shutdown()
    assert verdicts[0] == verdicts[1], verdicts


def test_rollback_restores_bitwise_and_needs_a_standby():
    router = _Pkg(False).router()
    try:
        with pytest.raises(RuntimeError):
            router.rollback_params("m")
        before_p, before_s = _host(router)
        m2 = _tiny_model(seed=99)
        router.promote_params("m", m2.params, m2.model_state, version="v1")
        assert router.pool("m").active_version == "v1"
        assert not _trees_equal(before_p, _host(router)[0])
        router.rollback_params("m")
        after_p, after_s = _host(router)
        assert _trees_equal(before_p, after_p)
        assert _trees_equal(before_s, after_s)
        assert router.pool("m").active_version == "v0"
        router.assert_warm()
        with pytest.raises(ValueError):
            router.promote_params("m", {"nope": np.zeros(3, np.float32)}, {})
        assert _trees_equal(after_p, _host(router)[0])
    finally:
        router.shutdown()


def test_swap_races_inflight_requests():
    """Requests submitted while params are promoted and rolled back all
    complete (old or new params), and the engines stay warm."""
    m2 = _tiny_model(seed=7)
    router = _Pkg(False).router()
    x = np.random.default_rng(0).normal(size=(4, N_IN)).astype(np.float32)
    stop = threading.Event()
    errors, done = [], [0] * 3

    def client(i):
        while not stop.is_set():
            try:
                out = router.submit(x, model="m").result(timeout=10)
                assert np.asarray(out).shape == (4, N_OUT)
                done[i] += 1
            except Exception as e:          # pragma: no cover
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 30
        while (not all(done) or sum(done) < 30) and not errors \
                and time.time() < deadline:
            router.promote_params("m", m2.params, m2.model_state,
                                  version="vX")
            router.rollback_params("m")
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        router.shutdown()
    assert not errors and all(done)
    router.assert_warm()


def test_eval_load_copies_into_the_clone():
    """A candidate is copied into the eval clone's own tensors (same
    storage before and after), and a candidate whose names differ is
    refused as an error decision."""
    pkg = _Pkg(False)
    router = pkg.router()
    try:
        ctl = pkg.controller(router, _ScriptedCalc([]))
        ptrs = {k: t.data_ptr()
                for k, t in flatten_paths(ctl.eval_model.params).items()}
        m2 = _tiny_model(seed=5)
        ctl._load_eval(m2.params, m2.model_state)
        assert _trees_equal(ctl.eval_model.params, m2.params)
        assert ptrs == {k: t.data_ptr() for k, t in
                        flatten_paths(ctl.eval_model.params).items()}
        with pytest.raises(ValueError, match="names differ"):
            ctl._load_eval({"x": torch.zeros(2)}, {})
    finally:
        router.shutdown()


# ---- the learner against the JAX package's -------------------------------

def _frames(n_batches, make, seed=4):
    rng = np.random.default_rng(seed)
    return [make(rng) for _ in range(n_batches)]


def _run_learner(pkg, model, frames, holdout_every, deadline_s=120):
    transport = pkg.Transport()
    if pkg.jax:
        from deeplearning4j_tpu.online import publish_samples as publish
    else:
        publish = publish_samples
    for x, y in frames:
        publish(transport, "t", x, y)
    stream = pkg.Stream(transport, "t", holdout_every=holdout_every,
                        poll_timeout_s=0.05, max_batches=len(frames),
                        registry=pkg.Registry())
    learner = pkg.Learner(model, stream).start()
    learner._thread.join(deadline_s)
    assert not learner.alive, "the learner did not drain its stream"
    learner.stop(5)
    assert learner.iterations == len(frames) - len(frames) // holdout_every
    return stream


def _assert_params_close(tm, jparams):
    import jax
    want = flatten_paths(jax.tree_util.tree_map(np.asarray, jparams))
    got = flatten_paths(tm.params)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= PARAM_REL * scale, k


def test_learner_matches_jax_on_the_mln():
    from test_torch_telemetry import mln_pair
    tm, jm = mln_pair()
    frames = _frames(12, lambda r: _batch(r, 6))
    ts = _run_learner(_Pkg(False), tm, frames, holdout_every=4)
    js = _run_learner(_Pkg(True), jm, frames, holdout_every=4)
    _assert_params_close(tm, jm.train_state.params)
    assert ts.holdout_examples == js.holdout_examples == 18


def test_learner_matches_jax_on_the_fused_graph():
    """Two fused bottleneck blocks at width 16 (test_torch_train.py's
    narrow ResNet50 configuration, 16x16x3, 5 classes)."""
    from test_torch_train import _pair
    jm, tm, _, _ = _pair()

    def make(r):
        x = r.normal(0, 1, (4, 16, 16, 3)).astype(np.float32)
        return x, np.eye(5, dtype=np.float32)[r.integers(0, 5, 4)]
    frames = _frames(6, make)
    _run_learner(_Pkg(False), tm, frames, holdout_every=3)
    _run_learner(_Pkg(True), jm, frames, holdout_every=3)
    _assert_params_close(tm, jm.train_state.params)


def test_snapshot_is_a_cpu_copy_at_a_step_boundary():
    transport = InProcessTransport()
    model = _tiny_model()
    stream = SampleStreamIterator(transport, "t", poll_timeout_s=0.05,
                                  registry=MetricsRegistry())
    learner = OnlineLearner(model, stream).start()
    stop = threading.Event()

    def feed():
        r = np.random.default_rng(1)
        while not stop.is_set():
            publish_samples(transport, "t", *_batch(r, 4))
            stop.wait(0.005)
    pub = threading.Thread(target=feed, daemon=True)
    pub.start()
    try:
        deadline = time.time() + 30
        cand = None
        while cand is None and time.time() < deadline:
            cand = learner.snapshot(timeout=1.0)
        assert cand is not None and cand.iteration >= 1
        leaves = list(flatten_paths(cand.params).values())
        assert all(t.device.type == "cpu" for t in leaves)
        live = {t.data_ptr() for t in flatten_paths(model.params).values()}
        assert not live & {t.data_ptr() for t in leaves}
    finally:
        stop.set()
        pub.join(5)
        learner.stop(10)
    # stopped: a snapshot is taken inline and equals the model bitwise
    cand = learner.snapshot()
    assert _trees_equal(cand.params, model.params)


def test_stop_ends_an_unbounded_fit_on_an_idle_topic():
    before = set(threading.enumerate())
    stream = SampleStreamIterator(InProcessTransport(), "idle",
                                  poll_timeout_s=0.05,
                                  registry=MetricsRegistry())
    learner = OnlineLearner(_tiny_model(), stream).start()
    time.sleep(0.3)
    assert learner.alive and learner.iterations == 0
    t0 = time.perf_counter()
    learner.stop(timeout=10)
    assert not learner.alive and time.perf_counter() - t0 < 5
    deadline = time.time() + 5
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before, \
        [t.name for t in set(threading.enumerate()) - before]


def test_the_three_copies_share_no_storage():
    online = OnlineServing(_tiny_model(), InProcessTransport(),
                           model_name="m", feature_shape=(N_IN,),
                           batch_limit=4, registry=MetricsRegistry())
    try:
        copies = [online.model, online.promoter.eval_model,
                  online.pool.engines[0].model]
        trees = [(m.params, m.model_state) for m in copies]
        trees.append(online.pool.engines[0]._committed[:2])
        ptrs = [{t.data_ptr() for t in flatten_paths(tree).values()}
                for tree in trees]
        assert all(ptrs)
        for i in range(len(ptrs)):
            for j in range(i + 1, len(ptrs)):
                assert not ptrs[i] & ptrs[j], (i, j)
        assert online.pool.engines[0].model is not online.model
    finally:
        online.stop()


# ---- end to end ------------------------------------------------------------

def _learnable(seed=5):
    w = np.random.default_rng(seed).normal(size=(N_IN, N_OUT)) \
        .astype(np.float32)

    def batch(n, g):
        x = g.normal(size=(n, N_IN)).astype(np.float32)
        return x, np.eye(N_OUT, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return batch


def _feeder(transport, topic, batch, stop, seed=6, width=None):
    def feed():
        prng = np.random.default_rng(seed)
        while not stop.is_set():
            publish_samples(transport, topic,
                            *batch(int(prng.integers(2, 9)), prng))
            stop.wait(0.02)
    t = threading.Thread(target=feed, daemon=True)
    t.start()
    return t


def test_learn_promote_serve_loop():
    """tests/test_online.py's end-to-end test on the port's CPU path."""
    transport = InProcessTransport()
    online = OnlineServing(
        _tiny_model(), transport, topic="train", model_name="m",
        feature_shape=(N_IN,), batch_limit=8, holdout_every=4,
        holdout_batch=8, registry=MetricsRegistry())
    batch = _learnable()
    online.start(background_promotion=False)
    stop = threading.Event()
    pub = _feeder(transport, "train", batch, stop)
    try:
        deadline = time.time() + 60
        while (online.learner.iterations < 30
               or online.stream.holdout_examples == 0):
            assert time.time() < deadline, online.stats()
            assert online.learner.alive, online.learner.error
            time.sleep(0.1)
        out = np.asarray(online.output(np.random.default_rng(5).normal(
            size=(3, N_IN)).astype(np.float32)))
        assert out.shape == (3, N_OUT)
        d = None
        while time.time() < deadline:
            d = online.promoter.run_once()
            if d.promoted:
                break
            time.sleep(0.5)
        assert d is not None and d.promoted, d
        assert online.pool.active_version == d.version
        assert online.sentinel.check() is None     # a good swap stands
        online.router.assert_warm()
        stats = online.stats()
        assert stats["promotion"]["promotions"] == 1
        assert stats["stream"]["holdout_examples"] > 0
        assert json.dumps(stats, default=str)
    finally:
        stop.set()
        pub.join(5)
        online.stop()


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=(
        "GET" if body is None else "POST"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_online_module_routes():
    from deeplearning4j_tpu_torch.ui.online_module import OnlineModule
    from deeplearning4j_tpu_torch.ui.server import UIServer
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
    transport = InProcessTransport()
    online = OnlineServing(_tiny_model(), transport, model_name="m",
                           feature_shape=(N_IN,), batch_limit=4,
                           holdout_every=2, registry=MetricsRegistry())
    server = UIServer(port=0, registry=MetricsRegistry())
    server.attach(InMemoryStatsStorage())
    server.register_module(OnlineModule(online))
    server.start()
    online.start(background_promotion=False)
    stop = threading.Event()
    pub = _feeder(transport, "train", _learnable(), stop)
    try:
        code, body = _http(server.url + "/api/online/rollback", {})
        assert code == 409 and "standby" in body["error"]
        deadline = time.time() + 30
        while online.stream.holdout_examples == 0 \
                or online.learner.iterations < 2:
            assert time.time() < deadline, online.stats()
            time.sleep(0.05)
        code, d = _http(server.url + "/api/online/promote", {"force": True})
        assert code == 200 and d["promoted"] and d["reason"] == "forced"
        code, stats = _http(server.url + "/api/online/stats")
        assert code == 200 and stats["learner"]["alive"]
        assert stats["promotion"]["promotions"] == 1
        code, r = _http(server.url + "/api/online/rollback", {})
        assert code == 200 and r["active_version"] == "v0"
        assert r["param_standby_version"] == d["version"]
    finally:
        stop.set()
        pub.join(5)
        server.stop()
        online.stop()


def test_serve_online_over_a_tcp_broker():
    """``serve --online`` on the committed regression MLP (4 -> 8 -> 3)
    fed through a TCP broker: it trains, serves, promotes and rolls
    back through its routes."""
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    broker = TcpTransport().serve()
    client = TcpTransport(port=broker.port)
    w = np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32)
    stop = threading.Event()

    def feed():
        g = np.random.default_rng(4)
        while not stop.is_set():
            x = g.normal(size=(8, 4)).astype(np.float32)
            publish_samples(client, "train", x,
                            np.eye(3, dtype=np.float32)[np.argmax(x @ w, 1)])
            stop.wait(0.01)
    front, server = cmd_serve(
        ["serve", "--model", str(REPO / "tests" / "resources" / "regression"
                                 / "mlp_v1.zip"),
         "--device", "cpu", "--ui-port", "0", "--warmup-shape", "4",
         "--online", "--stream-endpoint", f"127.0.0.1:{broker.port}",
         "--holdout-every", "2", "--promote-interval-s", "3600"],
        block=False)
    pub = threading.Thread(target=feed, daemon=True)
    pub.start()
    try:
        code, out = _http(server.url + "/api/predict",
                          {"features": [[0.1, 0.2, 0.3, 0.4]]})
        assert code == 200 and np.asarray(out["output"]).shape == (1, 3)
        deadline = time.time() + 30
        first = None
        while True:
            code, stats = _http(server.url + "/api/online/stats")
            assert code == 200 and stats["learner"]["alive"], stats
            it = stats["learner"]["iterations"]
            first = it if first is None else first
            if it > first and stats["stream"]["holdout_examples"]:
                break
            assert time.time() < deadline, stats
            time.sleep(0.05)
        code, d = _http(server.url + "/api/online/promote", {"force": True})
        assert code == 200 and d["promoted"], d
        code, stats = _http(server.url + "/api/online/stats")
        assert stats["promotion"]["promotions"] == 1
        code, r = _http(server.url + "/api/online/rollback", {})
        assert code == 200 and r["active_version"] == "v0"
    finally:
        stop.set()
        pub.join(5)
        front.shutdown()
        server.stop()
        client.close()
        broker.close()
