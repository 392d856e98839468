"""The port's ``ui/`` (UIServer, the module SPI, storage, the binary stats
codec, i18n), ``streaming/serde.py`` and ``observe/health.py`` on the CPU,
held to the JAX package's copies where they are copies: the same bytes
from the codec and the NDArray frame, the same ``/healthz`` verdicts for
the same series under the same environment thresholds. Then the
serving surfaces over HTTP: SSE streaming of a module's generator, the
generation module over a ``FleetRouter`` pool (tokens equal
``reference_decode`` of the same model), drain, the chaos site on the
ingress edge, and the training-UI names that are not ported yet.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.ui.modules import Route, UIModule
from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage


def _srv(**kw):
    return UIServer(port=0, **kw).attach(InMemoryStatsStorage())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _read_sse(url, payload, timeout=60.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        ctype = r.headers.get("Content-Type", "")
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data:"):
                events.append(json.loads(line[5:].strip()))
    return ctype, events


# ---- /healthz: the same verdicts as the JAX package --------------------

SCENARIOS = {
    "empty": [],
    "clean": [("counter", "dl4j_recompiles_total", 0.0, {"session": "s"}),
              ("counter", "dl4j_nonfinite_values_total", 0.0, {})],
    "nonfinite": [("counter", "dl4j_nonfinite_values_total", 3.0,
                   {"what": "loss"})],
    "storm": [("counter", "dl4j_recompiles_total", 8.0, {"session": "a"}),
              ("counter", "dl4j_recompiles_total", 7.0, {"session": "b"})],
    "divergence": [("gauge", "dl4j_replica_divergence", 2.5, {}),
                   ("gauge", "dl4j_replica_divergence", float("nan"),
                    {"r": "1"})],
    "peer_loss": [("counter", "dl4j_elastic_peer_loss_total", 1.0,
                   {"peer": "2"})],
    "staleness": [("gauge", "dl4j_elastic_staleness", 4.0, {"w": "0"})],
}


@pytest.mark.parametrize("env", [{}, {"DL4J_RECOMPILE_STORM": "7",
                                      "DL4J_DIVERGENCE_THRESHOLD": "3",
                                      "DL4J_ELASTIC_STALENESS_LIMIT": "5"}])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_health_verdicts_match_jax(name, env, monkeypatch):
    from deeplearning4j_tpu.observe.health import health_status as jhealth
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    from deeplearning4j_tpu_torch.observe import health_status
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    regs = (MetricsRegistry(), JRegistry())
    for reg in regs:
        for kind, metric, value, labels in SCENARIOS[name]:
            if kind == "counter":
                reg.counter(metric).inc(value, **labels)
            else:
                reg.gauge(metric).set(value, **labels)
    assert health_status(regs[0]) == jhealth(regs[1])


def test_metrics_and_healthz_routes():
    reg = MetricsRegistry()
    srv = _srv(registry=reg).start()
    try:
        code, body = _get(srv.url + "/healthz")
        assert code == 200
        assert json.loads(body) == {"status": "ok", "reasons": [],
                                    "sessions": 0}
        reg.counter("dl4j_recompiles_total").inc(8.0, session="x")
        code, body = _get(srv.url + "/healthz")
        assert code == 503
        assert json.loads(body)["reasons"][0].startswith("recompile_storm")
        # /metrics scrapes the process-wide registry
        from deeplearning4j_tpu_torch.observe import default_registry
        default_registry().counter("dl4j_ui_test_total", "t").inc(2.0)
        code, text = _get(srv.url + "/metrics")
        assert code == 200 and "dl4j_ui_test_total 2.0" in text
    finally:
        srv.stop()


# ---- copies: the same bytes as the JAX package -------------------------

def test_stats_codec_and_ndarray_frame_match_jax(monkeypatch):
    # an array frame carries its creation time: pin the clock
    monkeypatch.setattr(time, "time_ns", lambda: 42)
    from deeplearning4j_tpu.streaming import serde as jserde
    from deeplearning4j_tpu.ui import codec as jcodec
    from deeplearning4j_tpu_torch.streaming import serde
    from deeplearning4j_tpu_torch.ui import codec
    rec = {"session_id": "s", "iteration": 3, "score": 0.25,
           "flags": [True, None, "x"],
           "param_stats": {"W": {"mean_magnitude": 1.5,
                                 "histogram": np.arange(6, dtype=np.float32)}}}
    blob = codec.encode_stats_record(rec)
    assert blob == jcodec.encode_stats_record(rec)
    assert codec.is_stats_record(blob)
    back = codec.decode_stats_record(blob)
    assert np.array_equal(back["param_stats"]["W"]["histogram"],
                          np.arange(6, dtype=np.float32))
    a = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    frame = serde.serialize_ndarray(a, timestamp_ns=7)
    assert frame == jserde.serialize_ndarray(a, timestamp_ns=7)
    got, ts = serde.deserialize_ndarray(frame)
    assert ts == 7 and np.array_equal(got, a)


def test_storage_and_remote_router(tmp_path):
    from deeplearning4j_tpu_torch.ui.storage import (
        RemoteUIStatsStorageRouter, SqliteStatsStorage)
    db = SqliteStatsStorage(str(tmp_path / "s.db"))
    db.put_static_info({"session_id": "a", "model": "m"})
    db.put_update({"session_id": "a", "iteration": 1, "score": 2.0})
    assert db.list_session_ids() == ["a"]
    assert db.get_all_updates("a")[0]["score"] == 2.0
    srv = _srv().start()
    try:
        router = RemoteUIStatsStorageRouter(srv.url)
        router.put_static_info({"session_id": "r", "model": "m"})
        router.put_update({"session_id": "r", "iteration": 1,
                           "score": 0.5, "param_stats": {
                               "W": {"mean_magnitude": 1.0}}})
        router.flush()
        code, body = _get(srv.url + "/api/overview?session=r")
        assert code == 200 and json.loads(body)["scores"] == [0.5]
    finally:
        srv.stop()


# ---- the module SPI -------------------------------------------------------

def test_custom_module_routes():
    class EchoModule(UIModule):
        def __init__(self):
            self.attached = None
            self.records = []

        def get_routes(self):
            return [
                Route("GET", "/api/echo",
                      lambda ctx, q, body: {
                          "echo": q.get("msg", ""),
                          "has_storage": ctx.storage is not None}),
                Route("POST", "/api/echo",
                      lambda ctx, q, body: {"got": body}),
            ]

        def on_attach(self, storage):
            self.attached = storage

        def on_update(self, record):
            self.records.append(record)

    mod = EchoModule()
    srv = _srv().register_module(mod).start()
    try:
        assert mod.attached is not None
        assert json.loads(_get(srv.url + "/api/echo?msg=hi")[1]) == \
            {"echo": "hi", "has_storage": True}
        assert _post(srv.url + "/api/echo", {"x": 1}) == \
            (200, {"got": {"x": 1}})
        assert _post(srv.url + "/remote", {"record": {
            "session_id": "s", "score": 1.0}})[1]["ok"]
        assert mod.records and mod.records[0]["score"] == 1.0
        assert _post(srv.url + "/api/nowhere", {})[0] == 404
    finally:
        srv.stop()


@pytest.mark.parametrize("handler,detail", [
    (lambda ctx, q, body: 1 / 0, "ZeroDivisionError"),
    (lambda ctx, q, body: (_ for _ in ()).throw(
        RuntimeError("secret /etc/path")), "RuntimeError"),
    (lambda ctx, q, body: "not a dict", "TypeError"),
    (lambda ctx, q, body: None, "TypeError")])
def test_module_errors_are_500_and_the_server_lives(handler, detail):
    class Bad(UIModule):
        def get_routes(self):
            return [Route("GET", "/api/bad", handler)]

    srv = _srv().register_module(Bad()).start()
    try:
        code, body = _get(srv.url + "/api/bad")
        assert code == 500
        err = json.loads(body)["error"]
        assert detail in err and "secret" not in err
        assert _get(srv.url + "/api/sessions")[0] == 200
    finally:
        srv.stop()


def test_i18n_bundles_and_page():
    from deeplearning4j_tpu_torch.ui.i18n import I18N
    i18n = I18N.get_instance()
    assert i18n.get_message("train.nav.overview", "ja") == "概要"
    assert i18n.get_message("train.nav.model", "xx") == "Model"
    srv = _srv().start()
    try:
        page = _get(srv.url + "/?lang=ja")[1]
        assert "概要" in page and "{{i18n:" not in page
        data = json.loads(_get(srv.url + "/api/i18n?lang=de")[1])
        assert data["messages"]["train.nav.system"] == "System"
    finally:
        srv.stop()


# ---- streaming, drain, chaos ---------------------------------------------

def test_generic_generator_payload_streams():
    class Mod(UIModule):
        def get_routes(self):
            return [Route("POST", "/api/things",
                          lambda ctx, q, body: iter([{"a": 1}, {"b": 2}]))]

    srv = _srv().register_module(Mod()).start()
    try:
        ctype, events = _read_sse(srv.url + "/api/things", {})
        assert ctype.startswith("text/event-stream")
        assert events == [{"a": 1}, {"b": 2}]
    finally:
        srv.stop()


class _GatedStream(UIModule):
    """A generator that blocks on an event — controls exactly when an
    in-flight stream finishes."""

    def __init__(self):
        self.gate = threading.Event()
        self.started = threading.Event()

    def get_routes(self):
        return [Route("POST", "/api/generate", self._gen)]

    def _gen(self, ctx, query, body):
        def events():
            yield {"token": 1}
            self.started.set()
            self.gate.wait(timeout=30)
            yield {"done": True}
        return events()


def test_drain_lets_inflight_streams_finish():
    mod = _GatedStream()
    srv = _srv().register_module(mod).start()
    try:
        got = {}

        def client():
            got["ctype"], got["events"] = _read_sse(
                srv.url + "/api/generate", {"prompt": "x"})

        t = threading.Thread(target=client)
        t.start()
        assert mod.started.wait(timeout=30)
        assert srv.active_requests == 1
        srv.drain()
        code, body = _post(srv.url + "/api/generate", {"prompt": "y"})
        assert code == 503 and body == {"error": "draining"}
        mod.gate.set()
        t.join(timeout=30)
        assert [e for e in got["events"] if "done" in e]
        deadline = time.time() + 10
        while srv.active_requests and time.time() < deadline:
            time.sleep(0.01)
        assert srv.active_requests == 0
    finally:
        mod.gate.set()
        srv.stop()


def test_chaos_site_on_the_ingress_edge(monkeypatch):
    """Armed ``ui.request:error``: the module route answers 500 once
    (the injected fault), then serves; built-in routes are untouched."""
    from deeplearning4j_tpu_torch import chaos

    class Ok(UIModule):
        def get_routes(self):
            return [Route("GET", "/api/ok", lambda ctx, q, body: {"ok": 1})]

    chaos.arm("seed=3;ui.request:error(count=1)")
    try:
        srv = _srv().register_module(Ok()).start()
    finally:
        chaos.disarm()
    try:
        assert _get(srv.url + "/api/ok")[0] == 500
        assert _get(srv.url + "/api/ok") == (200, '{"ok": 1}')
        assert _get(srv.url + "/healthz")[0] == 200
    finally:
        srv.stop()


# ---- the generation module over HTTP ------------------------------------

def test_sse_generation_over_a_fleet_pool():
    from deeplearning4j_tpu_torch.generation import (GenerationEngine,
                                                     reference_decode)
    from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter
    from deeplearning4j_tpu_torch.ui.generation_module import \
        GenerationModule
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    model = TextGenerationLSTM(vocab_size=31, timesteps=8, lstm_units=32,
                               seed=5).init(device="cpu")
    eng = GenerationEngine(model, max_slots=2, stop_text=None,
                           registry=MetricsRegistry(), session_id="gen-http")
    fleet = FleetRouter(registry=MetricsRegistry(), session_id="gen-http")
    fleet.add_generation_pool("gen", eng)
    srv = _srv().register_module(GenerationModule(router=fleet, model="gen"))
    srv.start()
    try:
        prompt = [4, 8, 15]
        ref = reference_decode(model, prompt, 16)
        ctype, events = _read_sse(
            srv.url + "/api/generate",
            {"prompt": prompt, "max_new_tokens": 16, "greedy": True})
        assert ctype.startswith("text/event-stream")
        assert [e["token"] for e in events if "token" in e] == ref
        assert events[-1]["done"] and events[-1]["reason"] == "length"
        code, res = _post(srv.url + "/api/generate",
                          {"prompt": prompt, "max_new_tokens": 16,
                           "stream": False})
        assert code == 200 and res["ids"] == ref
        st = json.loads(_get(srv.url + "/api/generation/stats")[1])
        assert st["engine"]["slots"]["max"] == 2
        # an expired budget answers 504 before any stream bytes
        req = urllib.request.Request(
            srv.url + "/api/generate",
            data=json.dumps({"prompt": prompt}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Deadline-Ms": "0.000001"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=60)
        assert exc.value.code == 504
        assert json.loads(exc.value.read())["error"] == "deadline"
        fleet.assert_warm()
    finally:
        srv.stop()
        fleet.shutdown()


# ---- the t-SNE listener ------------------------------------------------------

def test_tsne_listener_is_exported():
    """The last training-UI listener (ROADMAP item 9) is ported: the
    package exports it beside the rest."""
    import deeplearning4j_tpu_torch.ui as ui
    from deeplearning4j_tpu_torch.ui.tsne_listener import TsneListener
    assert ui.TsneListener is TsneListener
    assert {"UIServer", "InMemoryStatsStorage", "SqliteStatsStorage",
            "RemoteUIStatsStorageRouter", "StatsListener",
            "TsneListener"} == set(ui.__all__)
