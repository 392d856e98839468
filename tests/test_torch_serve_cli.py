"""``python -m deeplearning4j_tpu_torch serve`` on the CPU, held to the
JAX package's ``python -m deeplearning4j_tpu serve``.

Both packages' ``cmd_serve(args, block=False)`` serve the same zip on
port 0 (the port with ``--device cpu``) and get the same seeded numpy
features over HTTP:

- ``/api/predict`` answers agree within 1e-5 of the answer's largest
  magnitude (f32 on both sides, the same math summed in another order)
  with equal ``n``, on ``mlp_v1``, ``cnn_v1``, ``lstm_v1`` and a small
  fused-block graph saved by the JAX package;
- ``/api/serving/stats``, ``/healthz`` and ``/api/fleet/stats`` have the
  JAX package's key sets (the port's serving stats add one key,
  ``device``, so a client can see where it is served), and every
  ``dl4j_serving_*`` and ``dl4j_fleet_*`` series the JAX server's
  ``/metrics`` shows is in the port's;
- with ``--generate`` the committed ``textgen_lstm.zip`` streams equal
  greedy token ids over SSE, up to the oracle's first near tie (top-2
  probability gap below 1e-4, the generation engine's rule), with final
  events of equal keys, and a two-turn session resumes over HTTP.

Then the CLI itself: the JAX parser's option strings plus ``--device``,
every unported flag exiting with its ROADMAP item, no serving on the CPU
unless asked, the deadline contract (504 on an expired budget, 200 on
garbage) and the real entry point in a subprocess. Batch limits stay at
4 or below so the JAX package's warmup compiles stay short.
"""

import contextlib
import json
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
REG = REPO / "tests" / "resources" / "regression"
TEXTGEN = REPO / "deeplearning4j_tpu" / "zoo" / "weights" / "textgen_lstm.zip"
REL = 1e-5
NEAR_TIE = 1e-4


@pytest.fixture(autouse=True)
def _empty_default_registries():
    """Both packages' process-wide metrics registries empty during each
    test, then as they were: the tests compare the two servers'
    ``/metrics`` series, and a series an earlier test in the same
    process left in one registry (an AOT cache counter) parted them."""
    from deeplearning4j_tpu.observe.registry import default_registry as jr
    from deeplearning4j_tpu_torch.observe.registry import \
        default_registry as tr
    saved = []
    for r in (jr(), tr()):
        with r._lock:
            saved.append((r, dict(r._metrics)))
            r._metrics.clear()
    yield
    for r, metrics in saved:
        with r._lock:
            r._metrics.clear()
            r._metrics.update(metrics)


def _cli(pkg):
    if pkg == "jax":
        from deeplearning4j_tpu.__main__ import _build_parser, cmd_serve
        return _build_parser, cmd_serve, []
    from deeplearning4j_tpu_torch.__main__ import _build_parser, cmd_serve
    return _build_parser, cmd_serve, ["--device", "cpu"]


@contextlib.contextmanager
def served(pkg, argv):
    build, cmd_serve, extra = _cli(pkg)
    args = build().parse_args(["serve", *argv, "--ui-port", "0", *extra])
    front, server = cmd_serve(args, block=False)
    try:
        yield front, server
    finally:
        front.shutdown()
        server.stop()


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _keys(tree, prefix=""):
    """Every key path of nested dicts (a list contributes its first
    element's keys)."""
    out = set()
    if isinstance(tree, list):
        return _keys(tree[0], prefix + "[]") if tree else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.add(prefix + "/" + k)
            out |= _keys(v, prefix + "/" + k)
    return out


def _series(metrics_text, prefixes=("dl4j_serving_", "dl4j_fleet_")):
    """Names of the series with samples (not just HELP/TYPE lines)."""
    return {re.split(r"[{ ]", line)[0] for line in metrics_text.splitlines()
            if line.startswith(prefixes)}


def _fused_graph_zip(path):
    """A small fused-block graph (stem, two FusedBottleneckBlocks, average
    pool, softmax) built and saved by the JAX package."""
    from deeplearning4j_tpu.models.computation_graph import ComputationGraph
    from deeplearning4j_tpu.models.serialization import save_model
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.convolution import (
        ConvolutionLayer, ConvolutionMode, PoolingType)
    from deeplearning4j_tpu.nn.layers.fused import FusedBottleneckBlock
    from deeplearning4j_tpu.nn.layers.output import (GlobalPoolingLayer,
                                                     OutputLayer)
    conf = (NeuralNetConfiguration.Builder().seed(5).graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.convolutional(8, 8, 3))
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
            .set_outputs("out").build())
    save_model(ComputationGraph(conf).init(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def fused_zip(tmp_path_factory):
    return _fused_graph_zip(tmp_path_factory.mktemp("fused") / "fused.zip")


CASES = {"mlp_v1": (4,), "cnn_v1": (10, 10, 2), "lstm_v1": (12, 2),
         "fused": (8, 8, 3)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_through_the_fleet_front_door_matches_jax(case, fused_zip,
                                                        monkeypatch):
    # the AIMD controller ticks on every admission, in both packages, so
    # which fleet gauges exist does not depend on how long warmup took
    monkeypatch.setenv("DL4J_FLEET_WINDOW_S", "0.000001")
    shape = CASES[case]
    path = fused_zip if case == "fused" else str(REG / f"{case}.zip")
    x = np.random.default_rng(1).normal(size=(5,) + shape).astype(
        np.float32)
    argv = ["--model", path, "--batch-limit", "4", "--slo-ms", "5000",
            "--warmup-shape", *map(str, shape)]
    seen = {}
    for pkg in ("jax", "port"):
        with served(pkg, argv) as (front, server):
            status, _, out = _post(server.url + "/api/predict",
                                   {"features": x.tolist()})
            assert status == 200, out
            got = {"out": np.asarray(out["output"], np.float32),
                   "n": out["n"]}
            for route in ("/api/serving/stats", "/healthz",
                          "/api/fleet/stats"):
                code, body = _get(server.url + route)
                assert code == 200, (pkg, route, body)
                got[route] = json.loads(body)
            got["series"] = _series(_get(server.url + "/metrics")[1])
            front.assert_warm()
        seen[pkg] = got
    jx, pt = seen["jax"], seen["port"]
    assert pt["n"] == jx["n"] == 5
    assert pt["out"].shape == jx["out"].shape
    np.testing.assert_allclose(pt["out"], jx["out"], rtol=REL,
                               atol=REL * np.abs(jx["out"]).max())
    assert set(pt["/api/serving/stats"]) == \
        set(jx["/api/serving/stats"]) | {"device"}
    assert pt["/api/serving/stats"]["device"] == "cpu"
    assert set(pt["/healthz"]) == set(jx["/healthz"])
    assert pt["/healthz"]["status"] == jx["/healthz"]["status"] == "ok"
    assert _keys(pt["/api/fleet/stats"]) == _keys(jx["/api/fleet/stats"])
    assert jx["series"] and jx["series"] <= pt["series"], \
        jx["series"] - pt["series"]


def test_plain_batched_serve_matches_jax_and_splits():
    """Without ``--slo-ms``: the ParallelInference facade over the engine
    (a 7-row request splits into 4 + 3 at batch limit 4)."""
    path = str(REG / "mlp_v1.zip")
    x = np.random.default_rng(2).normal(size=(7, 4)).astype(np.float32)
    argv = ["--model", path, "--batch-limit", "4", "--warmup-shape", "4"]
    outs, series = [], []
    for pkg in ("jax", "port"):
        with served(pkg, argv) as (front, server):
            status, _, out = _post(server.url + "/api/predict",
                                   {"features": x.tolist()})
            assert status == 200 and out["n"] == 7
            outs.append(np.asarray(out["output"], np.float32))
            stats = json.loads(_get(server.url + "/api/serving/stats")[1])
            assert stats["batches"] >= 2 and stats["ladder"] == [1, 2, 4]
            assert stats["recompiles_after_warmup"] == 0
            series.append(_series(_get(server.url + "/metrics")[1]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=REL,
                               atol=REL * np.abs(outs[0]).max())
    assert series[0] <= series[1]


def test_inplace_mode_equals_batched():
    """``--inference-mode inplace`` answers /api/predict on the handler's
    thread through the facade, with the same clamp and split; its answer
    equals the batched engine's."""
    path = str(REG / "cnn_v1.zip")
    x = np.random.default_rng(3).normal(size=(6, 10, 10, 2)).astype(
        np.float32)
    outs = []
    for mode in ("batched", "inplace"):
        with served("port", ["--model", path, "--batch-limit", "4",
                             "--warmup-shape", "10", "10", "2",
                             "--inference-mode", mode]) as (front, server):
            status, _, out = _post(server.url + "/api/predict",
                                   {"features": x.tolist()})
            assert status == 200 and out["n"] == 6
            outs.append(np.asarray(out["output"], np.float32))
            stats = json.loads(_get(server.url + "/api/serving/stats")[1])
            assert stats["device"] == "cpu"
    assert np.array_equal(outs[0], outs[1])


def test_fleet_swap_and_rollback_over_http(tmp_path):
    """``POST /api/fleet/swap`` restores a second zip onto the pool's
    device and serves it; ``/api/fleet/rollback`` restores v1's answers
    bitwise."""
    from deeplearning4j_tpu_torch.models.serialization import (
        restore_model, save_model)
    m2 = restore_model(str(REG / "mlp_v1.zip"), device="cpu")
    for lp in m2.params.values():
        for v in lp.values():
            v.mul_(0.5)
    v2 = str(tmp_path / "v2.zip")
    save_model(m2, v2)
    x = np.random.default_rng(4).normal(size=(3, 4)).astype(np.float32)
    with served("port", ["--model", str(REG / "mlp_v1.zip"),
                         "--batch-limit", "4", "--warmup-shape", "4",
                         "--slo-ms", "5000"]) as (front, server):
        url = server.url
        a = np.asarray(_post(url + "/api/predict",
                             {"features": x.tolist()})[2]["output"])
        status, _, sw = _post(url + "/api/fleet/swap",
                              {"version": "v2", "path": v2})
        assert status == 200, sw
        assert sw == {"model": "mlp_v1", "active_version": "v2",
                      "standby_version": "v1"}
        b = np.asarray(_post(url + "/api/predict",
                             {"features": x.tolist()})[2]["output"])
        pad = np.concatenate([x, x[-1:]])
        assert np.array_equal(b.astype(np.float32),
                              m2.output(pad).numpy()[:3])
        status, _, rb = _post(url + "/api/fleet/rollback", {})
        assert status == 200 and rb["active_version"] == "v1"
        c = np.asarray(_post(url + "/api/predict",
                             {"features": x.tolist()})[2]["output"])
        assert np.array_equal(a, c) and not np.array_equal(a, b)
        st = json.loads(_get(url + "/api/fleet/stats")[1])
        assert st["pools"]["mlp_v1"]["standby_version"] == "v2"
        front.assert_warm()


# ---- generation over HTTP ----------------------------------------------

def _sse(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data:"):
                events.append(json.loads(line[5:].strip()))
    return events


def _first_near_tie(model, vocab, prompt, ids):
    """Index of the first decoded position whose top-2 probabilities are
    within NEAR_TIE of each other, teacher-forced on ``ids``."""
    import torch
    from deeplearning4j_tpu_torch.generation import extract_decode_spec
    seq = vocab.encode(prompt) + list(ids[:-1])
    eye = torch.eye(extract_decode_spec(model).vocab_size)
    probs, _ = model.rnn_time_step(eye[seq][None])
    top2 = probs[0, len(vocab.encode(prompt)) - 1:].topk(2, -1).values
    gaps = (top2[:, 0] - top2[:, 1]).numpy()
    ties = np.nonzero(gaps < NEAR_TIE)[0]
    return int(ties[0]) if len(ties) else len(ids)


def _common_prefix(a, b):
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


PROMPTS = ["the quick brown ", "to be or not to", "once upon a time"]


def test_generate_streams_match_jax_and_a_session_resumes():
    from deeplearning4j_tpu_torch.generation import Vocab, reference_decode
    from deeplearning4j_tpu_torch.models.serialization import restore_model
    argv = ["--model", str(TEXTGEN), "--batch-limit", "2",
            "--warmup-shape", "60", "77", "--generate", "--gen-slots", "4",
            "--gen-max-new", "24", "--gen-session-cap", "4"]
    streams, finals = {}, {}
    for pkg in ("jax", "port"):
        with served(pkg, argv) as (front, server):
            got = [None] * len(PROMPTS)

            def client(i):
                got[i] = _sse(server.url + "/api/generate",
                              {"prompt": PROMPTS[i], "greedy": True,
                               "max_new_tokens": 24})
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(PROMPTS))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            streams[pkg] = [[e["token"] for e in ev if "token" in e]
                            for ev in got]
            finals[pkg] = [ev[-1] for ev in got]
            code, body = _get(server.url + "/api/generation/stats")
            assert code == 200 and json.loads(body)["tokens"]["generated"]
            if pkg == "port":
                turn1 = _post(server.url + "/api/generate",
                              {"prompt": PROMPTS[0], "greedy": True,
                               "max_new_tokens": 8, "stream": False,
                               "session": "tok"})[2]
                turn2 = _post(server.url + "/api/generate",
                              {"prompt": [], "greedy": True,
                               "max_new_tokens": 8, "stream": False,
                               "session": "tok"})[2]
                gen_stats = json.loads(
                    _get(server.url + "/api/generation/stats")[1])
                metrics = _get(server.url + "/metrics")[1]
                assert _get(server.url + "/healthz")[0] == 200
    model = restore_model(str(TEXTGEN), device="cpu")
    vocab = Vocab.load()
    for p, a, b in zip(PROMPTS, streams["port"], streams["jax"]):
        assert a and b
        if a != b:
            tie = _first_near_tie(model, vocab, p, b)
            assert _common_prefix(a, b) >= tie, (p, a, b, tie)
    for fp, fj in zip(finals["port"], finals["jax"]):
        assert fp["done"] and set(fp) == set(fj)
    full = reference_decode(model, vocab.encode(PROMPTS[0]), 16,
                            stop_id=vocab.stoi.get("\n"))
    both = turn1["ids"] + turn2["ids"]
    assert turn2["session"] == "tok"
    tie = _first_near_tie(model, vocab, PROMPTS[0], full)
    assert _common_prefix(both, full) >= min(tie, len(full))
    assert gen_stats["session_store"]["hits"]["device"] == 1
    assert "dl4j_gen_tokens_total" in metrics


# ---- the CLI -------------------------------------------------------------

def _options(build):
    serve = build()._subparsers._group_actions[0].choices["serve"]
    return sorted(o for a in serve._actions for o in a.option_strings)


def test_parser_has_every_jax_flag_plus_device():
    from deeplearning4j_tpu.__main__ import _build_parser as jbuild
    from deeplearning4j_tpu_torch.__main__ import _build_parser as tbuild
    assert _options(tbuild) == sorted(_options(jbuild) + ["--device"])
    args = tbuild().parse_args(["serve", "--model", "m.zip"])
    assert args.device == "cuda" and args.ui_port == 9000
    assert args.join is None and args.online is False
    assert not hasattr(args, "no_pipeline")  # unported: absent unless given


@pytest.mark.parametrize("flag,item", [(["--no-pipeline"], 12)])
def test_unported_flags_exit_with_their_roadmap_item(flag, item):
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    with pytest.raises(SystemExit,
                       match=rf"{flag[0]}.*queue 1 item {item}\)"):
        cmd_serve(["serve", "--model", str(REG / "mlp_v1.zip"),
                   "--device", "cpu", "--ui-port", "0", *flag],
                  block=False)


def test_bf16_is_the_jax_spelling_of_precision_bf16():
    """``--bf16`` serves the bfloat16 committed copy, as the engine's
    ``precision="bf16"``, without a warning of the port's own."""
    import warnings

    import torch

    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with served("torch", ["--model", str(REG / "mlp_v1.zip"),
                              "--bf16", "--batch-limit", "2"]) as (front, _):
            eng = front.engine
            assert eng.precision == "bf16"
            leaves = flatten_paths(eng.committed_host()[0]).values()
            assert leaves and all(t.dtype == torch.bfloat16 for t in leaves
                                  if t.is_floating_point())
            with pytest.raises(TypeError):
                type(eng)(eng.model, bf16=True)


def test_serve_refuses_the_cpu_unless_asked(monkeypatch):
    import torch
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cmd_serve(["serve", "--model", str(REG / "mlp_v1.zip"),
                   "--ui-port", "0"], block=False)


def test_deadline_contract_and_no_chaos_import():
    """The verify skill's chaos-and-deadlines contract, disarmed, in a
    fresh process: 200 without a deadline, 504 ``{"error": "deadline"}``
    for an expired budget by header or body (body wins), 200 again for
    garbage budgets; serving never imports the chaos plan."""
    code = f"""
import json, sys, urllib.request, urllib.error
from deeplearning4j_tpu_torch.__main__ import cmd_serve
front, server = cmd_serve(["serve", "--model", {str(REG / 'mlp_v1.zip')!r},
    "--device", "cpu", "--ui-port", "0", "--batch-limit", "4",
    "--warmup-shape", "4", "--slo-ms", "5000"], block=False)
def post(body, headers):
    req = urllib.request.Request(server.url + "/api/predict",
        data=json.dumps(body).encode(),
        headers={{"Content-Type": "application/json", **headers}})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
x = [[0.1, 0.2, 0.3, 0.4]]
out = [post({{"features": x}}, {{}}),
       post({{"features": x}}, {{"X-Deadline-Ms": "0.000001"}}),
       post({{"features": x, "deadline_ms": 0.000001}},
            {{"X-Deadline-Ms": "60000"}}),
       post({{"features": x, "deadline_ms": "soon"}}, {{}}),
       post({{"features": x}}, {{"X-Deadline-Ms": "-5"}})]
front.shutdown(); server.stop()
print(json.dumps([[s, b.get("error")] for s, b in out]))
print("deeplearning4j_tpu_torch.chaos.plan" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(REPO), "HOME": str(REPO)})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == [[200, None], [504, "deadline"],
                                     [504, "deadline"], [200, None],
                                     [200, None]]
    assert lines[-1] == "False"


def test_entry_point_serves_and_exits_on_the_cpu():
    """``python -m deeplearning4j_tpu_torch serve ... --device cpu
    --duration`` starts, answers predict, /healthz, /metrics and
    /api/serving/stats, and exits 0; without ``--device cpu`` on a
    machine without a card it exits non-zero at once."""
    import torch
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(REPO)}
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
           "--model", str(REG / "mlp_v1.zip"), "--ui-port", "0",
           "--warmup-shape", "4", "--batch-limit", "4", "--duration", "6"]
    if not torch.cuda.is_available():
        bad = subprocess.run(cmd, cwd=REPO, capture_output=True,
                             text=True, timeout=120, env=env)
        assert bad.returncode != 0 and "--device cpu" in bad.stderr
    proc = subprocess.Popen(cmd + ["--device", "cpu"], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        url = None
        for line in proc.stdout:
            m = re.match(r"serving .* at (http://\S+) ", line)
            if m:
                url = m.group(1)
            if line.strip().startswith("stats:"):
                break
        assert url, proc.stderr.read()
        status, _, out = _post(url + "/api/predict",
                               {"features": [[0.1, 0.2, 0.3, 0.4]]})
        assert status == 200 and out["n"] == 1
        assert json.loads(_get(url + "/healthz")[1])["status"] == "ok"
        assert "dl4j_serving_requests_total" in _get(url + "/metrics")[1]
        assert json.loads(_get(url + "/api/serving/stats")[1])["device"] \
            == "cpu"
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
