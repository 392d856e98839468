"""The port's RemoteDispatcher / CircuitBreaker (``parallel/remote.py``) on
the CPU, case by case as the JAX package's ``tests/test_remote.py``, plus
the slice as a whole: a ServingNode and a RemoteDispatcher of each
package serving the committed LeNet digits zip over real HTTP.

The contracts under test:

- breaker state machine: closed -> open on N consecutive failures ->
  half-open after the reset window admitting EXACTLY ONE probe ->
  closed on probe success / re-open on probe failure;
- retry goes to a DIFFERENT node, and a request is never double-counted
  in per-node inflight across retries;
- a 503 is NOT a breaker failure and its ``Retry-After`` overrides the
  backoff curve; 4xx is non-retriable;
- a breaker-open node is excluded from the pick;
- hedged requests: a slow primary gets a duplicate on another node and
  the first answer wins;
- an empty registry raises ``NoNodesError`` after the ``on_no_nodes``
  hook; the ``remote.send`` chaos site fails an attempt like a transport
  fault and the retry lands elsewhere; ``call`` targets one node.

Everything but the slice test runs on injected transports, clocks and
sleeps — no sockets, no real time.
"""

import json
import os
import threading

import numpy as np
import pytest

from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.parallel.deadline import (Deadline,
                                                        DeadlineExceeded)
from deeplearning4j_tpu_torch.parallel.node import NodeRegistry
from deeplearning4j_tpu_torch.parallel.remote import (
    CircuitBreaker,
    NoNodesError,
    RemoteDispatcher,
    RemoteError,
)

OK_BODY = json.dumps({"output": [[0.0]], "n": 1}).encode()
LENET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "deeplearning4j_tpu", "zoo", "weights", "lenet_digits.zip")


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TestCircuitBreaker:
    def test_closed_open_half_open_closed(self):
        clk = Clock()
        br = CircuitBreaker(failure_threshold=3, reset_after_s=5.0,
                            clock=clk)
        assert br.state == "closed" and br.allow()
        br.record_failure()
        br.record_failure()
        assert br.state == "closed"         # under threshold
        br.record_failure()
        assert br.state == "open"
        assert br.opened_total == 1
        assert not br.allow() and not br.would_allow()
        clk.advance(5.0)                    # reset window elapsed
        assert br.would_allow()
        assert br.allow()                   # the half-open probe
        assert br.state == "half_open"
        br.record_success()
        assert br.state == "closed"
        assert br.allow()

    def test_probe_failure_reopens(self):
        clk = Clock()
        br = CircuitBreaker(failure_threshold=1, reset_after_s=2.0,
                            clock=clk)
        br.record_failure()
        assert br.state == "open"
        clk.advance(2.0)
        assert br.allow()
        br.record_failure()                 # the probe failed
        assert br.state == "open"
        assert br.opened_total == 2
        assert not br.allow()               # a fresh reset window

    def test_success_resets_consecutive_count(self):
        br = CircuitBreaker(failure_threshold=3, clock=Clock())
        br.record_failure()
        br.record_failure()
        br.record_success()
        br.record_failure()
        br.record_failure()
        assert br.state == "closed"         # never 3 IN A ROW

    def test_half_open_admits_exactly_one_concurrently(self):
        clk = Clock()
        br = CircuitBreaker(failure_threshold=1, reset_after_s=1.0,
                            clock=clk)
        br.record_failure()
        clk.advance(1.0)
        admitted = []
        barrier = threading.Barrier(8)

        def probe():
            barrier.wait()
            if br.allow():
                admitted.append(threading.get_ident())

        threads = [threading.Thread(target=probe) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(admitted) == 1
        # would_allow is a PEEK: it must not have consumed the slot
        assert not br.would_allow()
        br.record_success()
        assert br.state == "closed"


def _registry(tmp_path, *nodes, stats=None):
    reg = NodeRegistry(str(tmp_path / "reg"))
    for i, nid in enumerate(nodes):
        reg.write(nid, f"http://{nid}",
                  stats=(stats or {}).get(nid, {"pending": 0,
                                                "inflight": 0}))
    return reg


def _node_of(url):
    return url.split("/")[2]


def _dispatcher(reg, transport, **kw):
    kw.setdefault("metrics", MetricsRegistry())
    kw.setdefault("snapshot_ttl_s", 0.0)    # always re-read the gossip
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("seed", 0)
    return RemoteDispatcher(reg, transport=transport, **kw)


class TestDispatch:
    def test_least_loaded_pick_by_gossip(self, tmp_path):
        reg = _registry(tmp_path, "a", "b", stats={
            "a": {"pending": 5, "inflight": 2},
            "b": {"pending": 0, "inflight": 0}})
        calls = []

        def transport(url, body, timeout):
            calls.append(_node_of(url))
            return 200, {}, OK_BODY

        d = _dispatcher(reg, transport)
        out = d.predict([[1.0]])
        assert out == {"output": [[0.0]], "n": 1}
        assert calls == ["b"]               # the unloaded node

    def test_retry_lands_on_a_different_node(self, tmp_path):
        reg = _registry(tmp_path, "a", "b")
        calls = []

        def transport(url, body, timeout):
            calls.append(_node_of(url))
            if _node_of(url) == "a":
                raise ConnectionError("boom")
            return 200, {}, OK_BODY

        d = _dispatcher(reg, transport, retries=2)
        out = d.predict([[1.0]])
        assert out["n"] == 1
        assert calls == ["a", "b"]          # never a->a
        assert d.inflight() == {}           # fully released

    def test_retry_never_double_counts_inflight(self, tmp_path):
        """The idempotency invariant: during each attempt, exactly that
        node carries exactly one in-flight — the failed attempt's count
        is released BEFORE the retry's increment."""
        reg = _registry(tmp_path, "a", "b")
        seen = []
        holder = {}

        def transport(url, body, timeout):
            seen.append((_node_of(url), dict(holder["d"].inflight())))
            if _node_of(url) == "a":
                raise TimeoutError("slow")
            return 200, {}, OK_BODY

        d = _dispatcher(reg, transport, retries=2)
        holder["d"] = d
        d.predict([[1.0]])
        assert seen == [("a", {"a": 1}), ("b", {"b": 1})]

    def test_503_honors_retry_after_and_spares_breaker(self, tmp_path):
        reg = _registry(tmp_path, "a", "b", stats={
            "a": {"pending": 0, "inflight": 0},
            "b": {"pending": 9, "inflight": 9}})   # a picked first
        sleeps = []

        def transport(url, body, timeout):
            if _node_of(url) == "a":
                return 503, {"Retry-After": "7"}, b'{"error": "shed"}'
            return 200, {}, OK_BODY

        d = _dispatcher(reg, transport, retries=2,
                        sleep=lambda s: sleeps.append(s))
        out = d.predict([[1.0]])
        assert out["n"] == 1
        assert 7.0 in sleeps                # the header, not the curve
        # shedding is NOT a failure: the node answered
        assert d.breaker_state("a") == "closed"

    def test_4xx_is_not_retriable(self, tmp_path):
        reg = _registry(tmp_path, "a", "b")
        calls = []

        def transport(url, body, timeout):
            calls.append(_node_of(url))
            return 400, {}, b'{"error": "bad features"}'

        d = _dispatcher(reg, transport, retries=3)
        with pytest.raises(RemoteError, match="rejected"):
            d.predict([[1.0]])
        assert len(calls) == 1              # no retry can fix a 400
        assert d.breaker_state(calls[0]) == "closed"

    def test_open_breaker_excludes_node_from_pick(self, tmp_path):
        reg = _registry(tmp_path, "a", "b")
        calls = []
        clk = Clock()

        def transport(url, body, timeout):
            calls.append(_node_of(url))
            if _node_of(url) == "a":
                raise ConnectionError("down")
            return 200, {}, OK_BODY

        d = _dispatcher(reg, transport, retries=2, breaker_failures=2,
                        breaker_reset_s=60.0, clock=clk)
        for _ in range(2):                  # trips a's breaker
            d.predict([[1.0]])
        assert d.breaker_state("a") == "open"
        calls.clear()
        d.predict([[1.0]])
        assert calls == ["b"]               # a not even attempted
        # after the reset window the half-open probe goes out again
        clk.advance(60.0)
        calls.clear()
        d.predict([[1.0]])
        assert calls[0] == "a"              # the probe (a sorts first)

    def test_all_nodes_failing_raises_remote_error(self, tmp_path):
        reg = _registry(tmp_path, "a", "b")

        def transport(url, body, timeout):
            raise ConnectionError("down")

        d = _dispatcher(reg, transport, retries=3)
        with pytest.raises(RemoteError) as ei:
            d.predict([[1.0]])
        tried = [n for n, _ in ei.value.attempts]
        assert set(tried) == {"a", "b"}     # both tried, neither twice
        assert len(tried) == 2

    def test_empty_registry_raises_no_nodes_and_signals(self, tmp_path):
        reg = NodeRegistry(str(tmp_path / "reg"))
        demands = []
        d = _dispatcher(reg, lambda *a: (200, {}, OK_BODY),
                        on_no_nodes=lambda: demands.append(1))
        with pytest.raises(NoNodesError):
            d.predict([[1.0]])
        assert demands == [1]               # the scale-from-zero signal

    def test_draining_node_not_dispatched(self, tmp_path):
        reg = _registry(tmp_path, "b")
        reg.write("a", "http://a", state="draining", stats={})
        calls = []

        def transport(url, body, timeout):
            calls.append(_node_of(url))
            return 200, {}, OK_BODY

        d = _dispatcher(reg, transport)
        d.predict([[1.0]])
        assert calls == ["b"]

    def test_hedge_fires_on_slow_primary_and_wins(self, tmp_path):
        import time as _time
        reg = _registry(tmp_path, "a", "b", stats={
            "a": {"pending": 0, "inflight": 0},
            "b": {"pending": 9, "inflight": 9}})   # a is the primary
        release = threading.Event()
        calls = []

        def transport(url, body, timeout):
            calls.append(_node_of(url))
            if _node_of(url) == "a":
                release.wait(5.0)           # a never answers in time
                return 200, {}, json.dumps(
                    {"output": [[1.0]], "n": 1}).encode()
            return 200, {}, OK_BODY

        # real clock/sleep here: hedging is about wall time
        d = RemoteDispatcher(reg, transport=transport,
                             metrics=MetricsRegistry(),
                             snapshot_ttl_s=0.0, hedge_after_s=0.05,
                             seed=0)
        t0 = _time.perf_counter()
        out = d.predict([[1.0]])
        took = _time.perf_counter() - t0
        release.set()
        assert out == {"output": [[0.0]], "n": 1}   # b's (hedge) answer
        assert set(calls) == {"a", "b"}
        assert took < 4.0                   # did NOT wait out the primary
        d.shutdown()


class TestChaosAndTargets:
    def test_chaos_send_fails_an_attempt_and_retry_lands_elsewhere(
            self, tmp_path):
        from deeplearning4j_tpu_torch.chaos import plan as chaosplan
        reg = _registry(tmp_path, "a", "b")
        calls = []

        def transport(url, body, timeout):
            calls.append(_node_of(url))
            return 200, {}, OK_BODY

        try:
            chaosplan.arm(chaosplan.parse_plan(
                "seed=3;remote.send:error(arg=a)",
                registry=MetricsRegistry()))
            d = _dispatcher(reg, transport, retries=2)
            out = d.predict([[1.0]])
        finally:
            chaosplan.disarm()
        assert out["n"] == 1
        assert calls == ["b"]           # the injected fault never sent
        assert d.inflight() == {}

    def test_call_targets_one_node_without_retry(self, tmp_path):
        reg = _registry(tmp_path, "a", "b")
        calls = []

        def transport(url, body, timeout):
            calls.append((_node_of(url), url.split("/", 3)[3]))
            if _node_of(url) == "a":
                raise ConnectionError("down")
            return 200, {}, json.dumps({"ids": [[1]]}).encode()

        d = _dispatcher(reg, transport)
        recs = {r["node_id"]: r for r in d.records()}
        assert d.call(recs["b"], {"q": 1}, path="/api/x") == \
            {"ids": [[1]]}
        with pytest.raises(RemoteError, match="node a"):
            d.call(recs["a"], {"q": 1}, path="/api/x")
        assert calls == [("b", "api/x"), ("a", "api/x")]

    def test_expired_deadline_never_dispatches(self, tmp_path):
        reg = _registry(tmp_path, "a")
        calls = []
        d = _dispatcher(reg, lambda *a: calls.append(a) or
                        (200, {}, OK_BODY))
        with pytest.raises(DeadlineExceeded):
            d.predict([[1.0]], deadline=Deadline.after_ms(-1.0))
        assert calls == []

    def test_bad_retry_after_falls_back_to_the_curve(self, tmp_path):
        reg = _registry(tmp_path, "a", "b", stats={
            "a": {"pending": 0, "inflight": 0},
            "b": {"pending": 9, "inflight": 9}})
        sleeps = []

        def transport(url, body, timeout):
            if _node_of(url) == "a":
                return 503, {"Retry-After": "nan"}, b'{"error": "shed"}'
            return 200, {}, OK_BODY

        m = MetricsRegistry()
        d = _dispatcher(reg, transport, retries=2, metrics=m,
                        sleep=lambda s: sleeps.append(s))
        d.predict([[1.0]])
        assert len(sleeps) == 1 and sleeps[0] < 1.0
        assert "dl4j_remote_bad_retry_after_total" in m.render()


def _lenet_cluster(pkg, tmp_path):
    """Two ServingNodes of ``pkg`` on the committed LeNet zip behind one
    RemoteDispatcher of the same package, over real HTTP."""
    if pkg == "jax":
        from deeplearning4j_tpu.models.serialization import restore_model
        from deeplearning4j_tpu.observe.registry import MetricsRegistry as M
        from deeplearning4j_tpu.parallel import node as n_mod
        from deeplearning4j_tpu.parallel import remote as r_mod
        model = restore_model(LENET)
        extra = {}
    else:
        from deeplearning4j_tpu_torch.models.serialization import (
            restore_model)
        from deeplearning4j_tpu_torch.parallel import node as n_mod
        from deeplearning4j_tpu_torch.parallel import remote as r_mod
        M = MetricsRegistry
        model = restore_model(LENET, device="cpu")
        extra = {"device": "cpu"}
    reg = n_mod.NodeRegistry(str(tmp_path / pkg))
    nodes = [n_mod.ServingNode(model, node_id=f"{pkg}{i}", registry=reg,
                               metrics_registry=M(), window_s=10.0,
                               batch_limit=8, **extra)
             for i in range(2)]
    return nodes, r_mod.RemoteDispatcher(reg, metrics=M(), seed=0)


def test_lenet_slice_matches_jax_through_both_clusters(tmp_path):
    """The slice on the CPU: each package's two nodes behind its own
    dispatcher answer the same digits within rel 1e-5; then one node of
    each drains and the other answers alone."""
    from deeplearning4j_tpu_torch.datasets.fetchers import (
        DigitsDataSetIterator)
    x = next(iter(DigitsDataSetIterator(16, train=False,
                                        shuffle=False))).features
    x = np.asarray(x, np.float32)
    rows = [x[:1], x[1:8], x[8:16]]
    clusters = {p: _lenet_cluster(p, tmp_path) for p in ("torch", "jax")}
    try:
        got = {p: [np.asarray(d.output(r), np.float32) for r in rows]
               for p, (_, d) in clusters.items()}
        for a, b in zip(got["torch"], got["jax"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        for p, (nodes, d) in clusters.items():
            assert nodes[0].drain(5.0)["drained"] is True
            alone = np.asarray(d.output(rows[2]), np.float32)
            np.testing.assert_array_equal(alone, got[p][2])
    finally:
        for nodes, d in clusters.values():
            d.shutdown()
            for n in nodes:
                n.shutdown()
