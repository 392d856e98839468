"""The port's cluster node tier (``parallel/node.py``, ``parallel/cluster.py``)
on the CPU, case by case as the JAX package's ``tests/test_node.py``.

Contracts under test:

- registry records are atomic, torn records surface as dead
  placeholders, a rejoining node overwrites its predecessor's record,
  and a record written by either package reads the same in the other;
- heartbeat health: exactly at ``stale_after_s`` is slow, exactly at
  ``dead_after_s`` still slow, strictly past it dead —
  ``classify_heartbeat_age`` equals the JAX function on a grid that
  holds the exact thresholds;
- graceful drain: new predicts get 503 + ``Retry-After`` once the
  drain starts, every accepted request completes with 200, the node
  deregisters before its server stops;
- ``serve --join`` in a subprocess drains on SIGTERM and exits 0;
- AutoScaler: scale-from-zero on demand is immediate, p99 pressure
  must hold, queue pressure scales up, idleness retires nodes down to
  ``min_nodes``, traffic resets idleness;
- a node serves on the card unless ``device="cpu"``; an artifact store
  reaches the engine as its persisted kernel cache (``aot_cache_dir``).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
from deeplearning4j_tpu_torch.parallel.cluster import classify_heartbeat_age
from deeplearning4j_tpu_torch.parallel.node import (
    NODE_UP,
    AutoScaler,
    NodeRegistry,
    ServingNode,
)

N_IN = 5
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


class Slow:
    """Duck-typed model whose forward blocks — holds requests in flight
    deterministically."""

    def __init__(self, delay=0.2):
        self.delay = delay

    def output(self, x):
        time.sleep(self.delay)
        return np.zeros((x.shape[0], 3), np.float32)


def _post(url, payload, timeout=10.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), json.loads(r.read())


# ---- heartbeat boundary ----------------------------------------------------

@pytest.mark.parametrize("dead,slow", [(6.0, 2.0), (6.0, None),
                                       (2.0, 2.0), (0.5, 0.25)])
def test_classify_heartbeat_age_matches_jax(dead, slow):
    from deeplearning4j_tpu.parallel.cluster import (
        classify_heartbeat_age as jax_classify)
    marks = [dead, slow if slow is not None else dead]
    grid = [None, 0.0, -1.0, 1e9]
    for m in marks:
        grid += [m, np.nextafter(m, -np.inf), np.nextafter(m, np.inf),
                 m / 2, m * 2]
    for age in grid:
        assert classify_heartbeat_age(age, dead, slow) == \
            jax_classify(age, dead, slow), (age, dead, slow)
    assert classify_heartbeat_age(dead, dead, slow) == "slow"
    assert classify_heartbeat_age(
        float(np.nextafter(dead, np.inf)), dead, slow) == "dead"


# ---- registry ---------------------------------------------------------------

class TestNodeRegistry:
    def test_write_read_roundtrip_and_rejoin_overwrite(self, tmp_path):
        reg = NodeRegistry(str(tmp_path / "r"))
        reg.write("a", "http://127.0.0.1:1", stats={"pending": 3})
        rec = reg.read_all()["a"]
        assert rec["url"] == "http://127.0.0.1:1"
        assert rec["state"] == NODE_UP
        assert rec["stats"] == {"pending": 3}
        reg.write("a", "http://127.0.0.1:2")
        assert reg.read_all()["a"]["url"] == "http://127.0.0.1:2"
        reg.deregister("a")
        assert reg.read_all() == {}
        reg.deregister("a")                 # idempotent

    def test_health_boundary_matches_watchdog(self, tmp_path):
        reg = NodeRegistry(str(tmp_path / "r"),
                           stale_after_s=2.0, dead_after_s=6.0)
        reg.write("a", "http://a", now=1000.0)
        assert reg.snapshot(now=1001.9)["a"]["health"] == "alive"
        assert reg.snapshot(now=1002.0)["a"]["health"] == "slow"
        assert reg.snapshot(now=1006.0)["a"]["health"] == "slow"
        assert reg.snapshot(now=1006.01)["a"]["health"] == "dead"

    def test_dispatchable_filters_and_orders(self, tmp_path):
        reg = NodeRegistry(str(tmp_path / "r"),
                           stale_after_s=2.0, dead_after_s=6.0)
        reg.write("slow", "http://s", now=997.0)
        reg.write("alive", "http://a", now=999.5)
        reg.write("dead", "http://d", now=900.0)
        reg.write("drain", "http://x", state="draining", now=999.9)
        got = [r["node_id"] for r in reg.dispatchable(now=1000.0)]
        assert got == ["alive", "slow"]

    def test_torn_record_classified_dead(self, tmp_path):
        reg = NodeRegistry(str(tmp_path / "r"))
        reg.write("good", "http://g")
        (tmp_path / "r" / "node_torn.json").write_text('{"node_id": "t')
        recs = reg.read_all()
        assert sorted(recs) == ["good", "torn"]
        assert recs["torn"]["corrupt"] is True
        assert reg.snapshot()["torn"]["health"] == "dead"
        assert [r["node_id"] for r in reg.dispatchable()] == ["good"]
        reg.write("torn", "http://t")          # clean beat heals it
        healed = reg.snapshot()["torn"]
        assert healed["health"] == "alive" and "corrupt" not in healed

    def test_dead_before_slow_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="dead before slow"):
            NodeRegistry(str(tmp_path / "r"),
                         stale_after_s=5.0, dead_after_s=2.0)

    @pytest.mark.parametrize("writer", ["torch", "jax"])
    def test_gossip_record_is_the_jax_format(self, tmp_path, writer):
        """A record written by either package reads the same in both:
        same file name, keys, state, stats and health."""
        from deeplearning4j_tpu.parallel.node import (
            NodeRegistry as JaxRegistry)
        d = str(tmp_path / "r")
        regs = {"torch": NodeRegistry(d, stale_after_s=2.0,
                                      dead_after_s=6.0),
                "jax": JaxRegistry(d, stale_after_s=2.0,
                                   dead_after_s=6.0)}
        regs[writer].write("n1", "http://n1", state="draining",
                           stats={"pending": 2, "shards": [0, 1]},
                           now=1000.0)
        assert os.listdir(d) == ["node_n1.json"]
        for now in (1001.0, 1002.0, 1006.0, 1006.5):
            a = regs["torch"].snapshot(now=now)["n1"]
            b = regs["jax"].snapshot(now=now)["n1"]
            assert a == b


# ---- drain ------------------------------------------------------------------

class TestServingNodeDrain:
    def test_drain_completes_inflight_rejects_new_deregisters(
            self, tmp_path):
        reg = NodeRegistry(str(tmp_path / "reg"))
        node = ServingNode(
            Slow(0.8), node_id="n1", registry=reg,
            metrics_registry=MetricsRegistry(), window_s=10.0,
            batch_limit=8, ui_port=0, device="cpu")
        try:
            rec = reg.read_all()["n1"]
            assert rec["state"] == NODE_UP and rec["url"] == node.url
            url = node.url + "/api/predict"
            payload = {"features": [[0.0] * N_IN]}
            results = []

            def client():
                status, _h, body = _post(url, payload)
                results.append((status, body))

            threads = [threading.Thread(target=client)
                       for _ in range(3)]
            for t in threads:
                t.start()
            time.sleep(0.25)                # all three admitted

            drain_result = {}

            def drainer():
                drain_result.update(node.drain(timeout_s=15.0))

            dt = threading.Thread(target=drainer)
            dt.start()
            deadline = time.time() + 5.0
            while time.time() < deadline:
                r = reg.read_all().get("n1")
                if r is None or r["state"] == "draining":
                    break
                time.sleep(0.02)
            time.sleep(0.05)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, payload)
            assert ei.value.code == 503
            assert ei.value.headers.get("Retry-After") is not None
            ei.value.read()

            dt.join(timeout=20)
            for t in threads:
                t.join(timeout=10)
            assert len(results) == 3
            assert all(status == 200 for status, _ in results)
            assert all(body["n"] == 1 for _, body in results)
            assert drain_result["drained"] is True
            assert drain_result["inflight_left"] == 0
            assert "n1" not in reg.read_all()
            assert "dl4j_cluster_drain_seconds" in node.metrics.render()
            again = node.drain()
            assert again == {"drained": True, "seconds": 0.0,
                             "inflight_left": 0}
        finally:
            node.shutdown()

    def test_sigterm_subprocess_drains_and_exits_zero(self, tmp_path):
        from deeplearning4j_tpu_torch.models.serialization import save_model
        zip_path = str(tmp_path / "m.zip")
        save_model(_tiny_model(), zip_path)
        reg_dir = str(tmp_path / "reg")
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
             "--model", zip_path, "--ui-port", "0", "--device", "cpu",
             "--join", reg_dir, "--node-id", "s1", "--batch-limit", "8"],
            cwd=_ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            reg = NodeRegistry(reg_dir)
            deadline = time.time() + 120
            while time.time() < deadline:
                rec = reg.read_all().get("s1")
                if rec and rec.get("pid") == proc.pid:
                    break
                time.sleep(0.1)
            else:
                out, _ = proc.communicate(timeout=5)
                raise AssertionError(f"node never registered:\n{out}")
            status, _, body = _post(rec["url"] + "/api/predict",
                                    {"features": [[0.5] * N_IN]})
            assert status == 200 and body["n"] == 1
            proc.terminate()                # SIGTERM -> graceful drain
            out, _ = proc.communicate(timeout=60)
            assert proc.returncode == 0, out
            assert "node s1 serving" in out
            assert "SIGTERM drain" in out
            assert "s1" not in reg.read_all()
        finally:
            if proc.poll() is None:
                proc.kill()


# ---- device and the AOT cache ------------------------------------------------

def test_node_needs_the_card_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = NodeRegistry(str(tmp_path / "reg"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingNode(Slow(0.0), node_id="x", registry=reg,
                    metrics_registry=MetricsRegistry())
    assert reg.read_all() == {}


def test_node_refuses_a_model_on_another_device(tmp_path):
    reg = NodeRegistry(str(tmp_path / "reg"))
    model = _tiny_model()
    model.device = torch.device("meta")
    with pytest.raises(ValueError, match="lies on"):
        ServingNode(model, node_id="x", registry=reg, device="cpu",
                    metrics_registry=MetricsRegistry())


def test_artifact_store_reaches_the_unported_aot_cache(tmp_path):
    """A node's artifact store reaches its engine as the persisted kernel
    cache of its key (unported until the cache was): the first node
    publishes the entry, a second node on the same key warms from it."""
    store = ArtifactStore(str(tmp_path / "store"))
    states = []
    for nid in ("w1", "w2"):
        with ServingNode(_tiny_model(), node_id=nid,
                         registry=NodeRegistry(str(tmp_path / "reg")),
                         artifact_store=store, model_key="m", device="cpu",
                         metrics_registry=MetricsRegistry(), batch_limit=8,
                         feature_shape=(N_IN,)) as node:
            aot = node.router.pool("default").engines[0].stats()[
                "aot_cache"]
            assert aot["dir"] == store.cache_dir("m")
            states.append(aot["state"])
    assert states == ["cold", "warm"]
    assert store.stats()["keys"]["m"] == {"published": True,
                                          "precisions": {"f32": 0}}


def test_node_stats_and_warm(tmp_path):
    reg = NodeRegistry(str(tmp_path / "reg"))
    model = _tiny_model()
    x = np.random.default_rng(0).normal(size=(3, N_IN)).astype(np.float32)
    with ServingNode(model, node_id="w1", registry=reg, model_name="mlp",
                     metrics_registry=MetricsRegistry(), window_s=10.0,
                     batch_limit=4, feature_shape=(N_IN,),
                     device="cpu") as node:
        eng = node.router.pool("mlp").engines[0]
        assert np.array_equal(np.asarray(node.output(x)), eng.output(x))
        ring = node.router.pool("mlp").ring
        deadline = time.time() + 10         # the done callback
        while ring.count < 1 and time.time() < deadline:
            time.sleep(0.01)
        node.assert_warm()
        st = node.stats()
        assert st["node_id"] == "w1" and st["state"] == "up"
        ns = node.node_stats()
        assert set(ns) == {"pending", "inflight", "queue_depth",
                           "windowed_p99_ms", "requests"}
        assert ns["requests"] == 1
    assert reg.read_all() == {}


# ---- autoscaler -------------------------------------------------------------

class _FakeFleet:
    def __init__(self, reg):
        self.reg = reg
        self.spawned = []
        self.stopped = []
        self._n = 0

    def spawn(self):
        nid = f"n{self._n}"
        self._n += 1
        self.spawned.append(nid)
        self.reg.write(nid, f"http://{nid}", stats={"requests": 0})

    def stop(self, node_id):
        self.stopped.append(node_id)
        self.reg.deregister(node_id)


class TestAutoScaler:
    def _scaler(self, tmp_path, **kw):
        reg = NodeRegistry(str(tmp_path / "reg"))
        fleet = _FakeFleet(reg)
        clk = {"t": 100.0}
        kw.setdefault("hold_s", 1.0)
        kw.setdefault("idle_after_s", 5.0)
        sc = AutoScaler(reg, spawn=fleet.spawn, stop=fleet.stop,
                        clock=lambda: clk["t"], **kw)
        return reg, fleet, clk, sc

    def test_scale_from_zero_on_demand_is_immediate(self, tmp_path):
        reg, fleet, clk, sc = self._scaler(tmp_path, min_nodes=0)
        assert sc.tick() is None
        sc.note_demand()
        assert sc.tick() == "up"
        assert fleet.spawned == ["n0"]

    def test_p99_pressure_requires_hold(self, tmp_path):
        reg, fleet, clk, sc = self._scaler(tmp_path, slo_ms=100.0,
                                           max_nodes=3)
        reg.write("a", "http://a",
                  stats={"windowed_p99_ms": 500.0, "requests": 1})
        assert sc.tick() is None
        clk["t"] += 1.0
        reg.write("a", "http://a",
                  stats={"windowed_p99_ms": 500.0, "requests": 2})
        assert sc.tick() == "up"
        assert sc.scale_ups == 1

    def test_queue_pressure_scales_up(self, tmp_path):
        reg, fleet, clk, sc = self._scaler(tmp_path, queue_high=4)
        reg.write("a", "http://a",
                  stats={"pending": 9, "queue_depth": 3, "requests": 1})
        sc.tick()
        clk["t"] += 1.0
        reg.write("a", "http://a",
                  stats={"pending": 9, "queue_depth": 3, "requests": 2})
        assert sc.tick() == "up"

    def test_idle_scales_down_to_min_nodes(self, tmp_path):
        reg, fleet, clk, sc = self._scaler(tmp_path, min_nodes=1)
        reg.write("a", "http://a", stats={"requests": 7})
        reg.write("b", "http://b", stats={"requests": 3})
        assert sc.tick() is None
        clk["t"] += 5.0
        reg.write("a", "http://a", stats={"requests": 7})
        reg.write("b", "http://b", stats={"requests": 3})
        assert sc.tick() == "down"
        assert fleet.stopped == ["b"]
        clk["t"] += 5.0
        reg.write("a", "http://a", stats={"requests": 7})
        assert sc.tick() is None
        clk["t"] += 5.0
        reg.write("a", "http://a", stats={"requests": 7})
        assert sc.tick() is None
        assert fleet.stopped == ["b"]
        assert sc.scale_downs == 1

    def test_traffic_resets_idleness(self, tmp_path):
        reg, fleet, clk, sc = self._scaler(tmp_path, min_nodes=0)
        reg.write("a", "http://a", stats={"requests": 1})
        sc.tick()
        clk["t"] += 4.0
        reg.write("a", "http://a", stats={"requests": 2})
        assert sc.tick() is None
        clk["t"] += 4.0
        reg.write("a", "http://a", stats={"requests": 2})
        assert sc.tick() is None
        clk["t"] += 1.0
        reg.write("a", "http://a", stats={"requests": 2})
        assert sc.tick() == "down"

    def test_reads_a_live_nodes_gossip(self, tmp_path):
        """The tick reads what a ServingNode heartbeats: its requests
        count resets idleness, its silence retires it."""
        reg = NodeRegistry(str(tmp_path / "reg"))
        clk = {"t": 0.0}
        stopped = []
        sc = AutoScaler(reg, spawn=lambda: None, stop=stopped.append,
                        idle_after_s=5.0, clock=lambda: clk["t"])
        x = np.zeros((1, N_IN), np.float32)
        with ServingNode(_tiny_model(), node_id="g1", registry=reg,
                         metrics_registry=MetricsRegistry(),
                         window_s=10.0, batch_limit=4,
                         heartbeat_interval_s=0.05,
                         device="cpu") as node:
            assert sc.tick() is None            # baseline
            node.output(x)
            ring = node.router.pool("default").ring
            deadline = time.time() + 10         # the done callback
            while ring.count < 1 and time.time() < deadline:
                time.sleep(0.01)
            node._beat_now()
            clk["t"] += 5.0
            assert sc.tick() is None            # traffic: a new baseline
            clk["t"] += 5.0
            assert sc.tick() == "down"
            assert stopped == ["g1"]
