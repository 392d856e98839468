"""RemoteDispatcher: FleetRouter's least-loaded dispatch, across nodes.

The port of the JAX package's ``parallel/remote.py`` (a copy: urllib,
json and threads, nothing of the device). The in-process router picks
the engine with the fewest in-flight requests; this tier does the same
across :class:`~deeplearning4j_tpu_torch.parallel.node.NodeRegistry`
worker nodes over HTTP, with the failure machinery a network hop makes
mandatory:

- **per-request timeout** — a dead TCP peer must cost one timeout, not
  a hung client thread;
- **bounded exponential-backoff retry onto a DIFFERENT node** —
  predict is idempotent (same features -> same answer, no state), so a
  failed or timed-out attempt re-dispatches elsewhere; a node that
  answered 503 (shedding / draining) is healthy-but-full, and its
  ``Retry-After`` header is honored instead of the backoff curve;
- **per-node circuit breaker** — consecutive transport failures open
  the breaker (the node stops being picked *before* its heartbeat goes
  stale); after ``reset_after_s`` exactly one half-open probe is
  admitted; success closes, failure re-opens. 503s never open a
  breaker: an overloaded node is alive;
- **hedged requests** — when the primary attempt has not answered
  within ``hedge_after_s``, a second copy goes to a different node and
  the first answer wins (the loser is discarded — idempotence again).
  This is the classic tail-latency trade: a few % duplicate work for a
  p99 bounded by the second-slowest node.

Accounting invariant (tested): a request is counted in a node's local
in-flight exactly once per dispatch to THAT node, and always released
before (or independent of) the retry's increment on the next node — a
retry can never double-count, so least-loaded stays truthful under
failures.

Prometheus series (the JAX package's ``dl4j_cluster_*`` names):
``dl4j_cluster_nodes{state}``, ``dl4j_cluster_breaker_state{node}``,
``dl4j_cluster_dispatch_total{node,outcome}``,
``dl4j_cluster_retries_total``, ``dl4j_cluster_hedges_total{outcome}``.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.chaos.hook import chaos_site
from deeplearning4j_tpu_torch.parallel.deadline import Deadline, DeadlineExceeded
from deeplearning4j_tpu_torch.parallel.node import NodeRegistry


class NoNodesError(RuntimeError):
    """No dispatchable node in the registry (empty fleet, everyone dead
    or draining). The autoscaler's ``note_demand`` hook fires before
    this is raised, so a scale-to-zero fleet restarts on it."""


class RemoteError(RuntimeError):
    """A request failed on every node it was tried on."""

    def __init__(self, detail: str, attempts: List[Tuple[str, str]]):
        super().__init__(detail)
        self.attempts = attempts        # [(node_id, reason), ...]


#: Gauge encoding of breaker states (closed is the healthy 0).
_BREAKER_GAUGE = {"closed": 0.0, "half_open": 0.5, "open": 1.0}


class CircuitBreaker:
    """Per-node breaker: closed -> (N consecutive failures) -> open ->
    (``reset_after_s`` elapsed) -> half-open, which admits EXACTLY one
    probe; probe success closes, probe failure re-opens. Thread-safe;
    ``clock`` is injectable so tests never sleep."""

    def __init__(self, *, failure_threshold: int = 3,
                 reset_after_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        self.opened_total = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def would_allow(self) -> bool:
        """Peek without consuming the half-open probe slot — the picker
        uses this to skip broken nodes; only a committed send may call
        :meth:`allow`."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                return (self.clock() - self._opened_at
                        >= self.reset_after_s)
            return not self._probe_inflight

    def allow(self) -> bool:
        """Admit one request. In half-open, exactly one caller gets
        True until its verdict lands (``record_success`` /
        ``record_failure`` release the probe slot)."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self.clock() - self._opened_at < self.reset_after_s:
                    return False
                self._state = "half_open"
                self._probe_inflight = True
                return True
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self):
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._probe_inflight = False

    def record_failure(self):
        with self._lock:
            self._probe_inflight = False
            self._consecutive += 1
            trip = self._state == "half_open" \
                or (self._state == "closed"
                    and self._consecutive >= self.failure_threshold)
            if trip:
                self._state = "open"
                self._opened_at = self.clock()
                self.opened_total += 1


class _Attempt:
    """Outcome of one send to one node."""

    __slots__ = ("ok", "value", "retriable", "retry_after", "reason")

    def __init__(self, ok, value, retriable=False, retry_after=None,
                 reason=""):
        self.ok = ok
        self.value = value
        self.retriable = retriable
        self.retry_after = retry_after
        self.reason = reason


def _http_transport(url: str, body: bytes, timeout_s: float
                    ) -> Tuple[int, Dict[str, str], bytes]:
    """Default transport: ``(status, headers, body)``; non-2xx statuses
    are RETURNED (they carry shed/drain semantics), transport-level
    failures raise."""
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class RemoteDispatcher:
    """Cluster front door: least-loaded node pick + timeout / retry /
    breaker / hedge. Thread-safe; one instance serves many client
    threads. ``transport``, ``clock`` and ``sleep`` are injectable so
    the failure machinery is testable without sockets or real time."""

    def __init__(self, registry: NodeRegistry, *,
                 timeout_s: float = 30.0,
                 retries: int = 2,
                 backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 hedge_after_s: Optional[float] = None,
                 breaker_failures: int = 3,
                 breaker_reset_s: float = 2.0,
                 snapshot_ttl_s: float = 0.1,
                 on_no_nodes: Optional[Callable[[], Any]] = None,
                 wait_for_nodes_s: float = 0.0,
                 metrics=None,
                 transport: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: Optional[int] = None):
        from deeplearning4j_tpu_torch.observe.registry import default_registry
        self.registry = registry
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.hedge_after_s = hedge_after_s
        self.breaker_failures = int(breaker_failures)
        self.breaker_reset_s = float(breaker_reset_s)
        self.snapshot_ttl_s = float(snapshot_ttl_s)
        self.on_no_nodes = on_no_nodes
        self.wait_for_nodes_s = float(wait_for_nodes_s)
        self.transport = transport if transport is not None \
            else _http_transport
        # chaos sites bind once here; disarmed runs hold None and the
        # send path pays a single is-None test per attempt
        self._chaos_send = chaos_site("remote.send")
        _chaos_clock = chaos_site("remote.clock")
        if _chaos_clock is not None:
            _base_clock = clock
            self._clock_skew_s = 0.0

            def _skewed_clock():
                self._clock_skew_s += _chaos_clock.skew()
                return _base_clock() + self._clock_skew_s
            clock = _skewed_clock
        self.clock = clock
        self.sleep = sleep
        # EWMA of attempt wall time: the budget gate below refuses a
        # retry the remaining deadline can't plausibly cover
        self._attempt_ewma_s = 0.0
        self._rand = random.Random(seed)
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._snap: List[Dict[str, Any]] = []
        self._snap_at: Optional[float] = None
        self._pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="dl4j-remote")

        reg = metrics if metrics is not None else default_registry()
        self._g_nodes = reg.gauge(
            "dl4j_cluster_nodes",
            "registry membership by state: up / slow / draining / dead")
        self._g_breaker = reg.gauge(
            "dl4j_cluster_breaker_state",
            "per-node circuit breaker: 0 closed, 0.5 half-open, 1 open")
        self._c_dispatch = reg.counter(
            "dl4j_cluster_dispatch_total",
            "attempts per node; outcome=ok|shed|error")
        self._c_retries = reg.counter(
            "dl4j_cluster_retries_total",
            "re-dispatches onto a different node after a retriable "
            "failure")
        self._c_hedges = reg.counter(
            "dl4j_cluster_hedges_total",
            "hedged duplicate requests; outcome=fired|won")
        self._c_bad_ra = reg.counter(
            "dl4j_remote_bad_retry_after_total",
            "malformed Retry-After headers (non-numeric, non-finite, "
            "negative, or absurd) ignored in favor of the backoff curve")
        self._c_deadline = reg.counter(
            "dl4j_remote_deadline_total",
            "dispatches given up on deadline; stage=ingress|retry")

    # ---- membership view -------------------------------------------------
    def _breaker(self, node_id: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(node_id)
            if br is None:
                br = CircuitBreaker(
                    failure_threshold=self.breaker_failures,
                    reset_after_s=self.breaker_reset_s,
                    clock=self.clock)
                self._breakers[node_id] = br
            return br

    def breaker_state(self, node_id: str) -> str:
        return self._breaker(node_id).state

    def inflight(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._inflight)

    def _nodes(self, force: bool = False) -> List[Dict[str, Any]]:
        now = self.clock()
        with self._lock:
            fresh = (self._snap_at is not None
                     and now - self._snap_at < self.snapshot_ttl_s)
            if fresh and not force:
                return list(self._snap)
        snap = self.registry.snapshot()
        counts = {"up": 0, "slow": 0, "draining": 0, "dead": 0}
        nodes = []
        for rec in snap.values():
            if rec["state"] == "draining":
                counts["draining"] += 1
            elif rec["health"] == "dead":
                counts["dead"] += 1
            else:
                counts["up" if rec["health"] == "alive" else "slow"] += 1
            if rec["state"] == "up" and rec["health"] != "dead":
                nodes.append(rec)
        for state, n in counts.items():
            self._g_nodes.set(float(n), state=state)
        with self._lock:
            self._snap = nodes
            self._snap_at = now
        return list(nodes)

    def _pick(self, exclude) -> Optional[Dict[str, Any]]:
        """Least-loaded dispatchable node not in ``exclude`` whose
        breaker would admit a request. Load = local in-flight first
        (ground truth we maintain), gossiped pending as the tie-break
        (staleness-tolerant), alive preferred over slow."""
        candidates = []
        with self._lock:
            local = dict(self._inflight)
        for rec in self._nodes():
            nid = rec["node_id"]
            if nid in exclude:
                continue
            if not self._breaker(nid).would_allow():
                self._g_breaker.set(
                    _BREAKER_GAUGE[self._breaker(nid).state], node=nid)
                continue
            gossip = int(rec["stats"].get("pending") or 0) \
                + int(rec["stats"].get("inflight") or 0)
            health_rank = 0 if rec["health"] == "alive" else 1
            candidates.append(
                (health_rank, local.get(nid, 0), gossip, nid, rec))
        if not candidates:
            return None
        candidates.sort(key=lambda t: t[:4])
        return candidates[0][4]

    # ---- one attempt -----------------------------------------------------
    _RETRY_AFTER_CAP_S = 3600.0

    def _parse_retry_after(self, v) -> Optional[float]:
        """Defensive Retry-After parse: a malformed value (non-numeric,
        NaN/inf, negative, or over an hour) must fall back to the
        backoff curve, never drive the pause — one bad node header
        can't stall the whole client."""
        try:
            ra = float(v)
        except (TypeError, ValueError):
            ra = None
        if ra is None or ra != ra or ra < 0 \
                or ra > self._RETRY_AFTER_CAP_S:
            self._c_bad_ra.inc(1.0)
            return None
        return ra

    def _send(self, rec: Dict[str, Any], body: bytes,
              timeout_s: Optional[float] = None,
              path: str = "/api/predict") -> _Attempt:
        nid = rec["node_id"]
        br = self._breaker(nid)
        if not br.allow():
            return _Attempt(False, None, retriable=True,
                            reason="breaker_open")
        url = rec["url"].rstrip("/") + path
        with self._lock:
            self._inflight[nid] = self._inflight.get(nid, 0) + 1
        try:
            if self._chaos_send is not None:
                # delay sleeps here; error/timeout raise and land in
                # the except arm exactly like an organic transport fault
                self._chaos_send.fail(arg=nid)
            status, headers, payload = self.transport(
                url, body,
                self.timeout_s if timeout_s is None else timeout_s)
        except Exception as e:
            br.record_failure()
            self._g_breaker.set(_BREAKER_GAUGE[br.state], node=nid)
            self._c_dispatch.inc(1.0, node=nid, outcome="error")
            return _Attempt(False, None, retriable=True,
                            reason=f"{type(e).__name__}: {e}")
        finally:
            # released HERE, before any retry touches the next node:
            # the idempotency/accounting invariant in the module doc
            with self._lock:
                n = self._inflight.get(nid, 1) - 1
                if n <= 0:
                    self._inflight.pop(nid, None)
                else:
                    self._inflight[nid] = n
        if status == 200:
            br.record_success()
            self._g_breaker.set(_BREAKER_GAUGE[br.state], node=nid)
            self._c_dispatch.inc(1.0, node=nid, outcome="ok")
            return _Attempt(True, json.loads(payload))
        if status == 503:
            # shedding / draining: the node is alive and answering —
            # never a breaker failure; honor its Retry-After
            br.record_success()
            self._g_breaker.set(_BREAKER_GAUGE[br.state], node=nid)
            self._c_dispatch.inc(1.0, node=nid, outcome="shed")
            ra = None
            for k, v in headers.items():
                if k.lower() == "retry-after":
                    ra = self._parse_retry_after(v)
            return _Attempt(False, None, retriable=True,
                            retry_after=ra, reason="shed(503)")
        if status >= 500:
            br.record_failure()
            self._g_breaker.set(_BREAKER_GAUGE[br.state], node=nid)
            self._c_dispatch.inc(1.0, node=nid, outcome="error")
            return _Attempt(False, None, retriable=True,
                            reason=f"http {status}")
        # 4xx: the REQUEST is bad — retrying elsewhere cannot fix the
        # caller's payload, and the node did nothing wrong
        br.record_success()
        self._c_dispatch.inc(1.0, node=nid, outcome="error")
        return _Attempt(False, None, retriable=False,
                        reason=f"http {status}: "
                        f"{payload[:200].decode('utf-8', 'replace')}")

    def _send_hedged(self, rec: Dict[str, Any], body: bytes,
                     tried: set,
                     deadline: Optional[Deadline] = None) -> _Attempt:
        """Primary send with an optional hedge: when the primary has
        not answered within ``hedge_after_s``, fire a duplicate at a
        different node; first OK wins, the loser's answer is discarded
        (predict is idempotent). A deadline caps the per-attempt
        transport timeout and suppresses the hedge when the remaining
        budget can't cover waiting for it."""
        timeout_s = None if deadline is None \
            else max(deadline.cap_timeout(self.timeout_s), 1e-3)
        if self.hedge_after_s is None or (
                deadline is not None
                and deadline.remaining_s()
                < self.hedge_after_s + max(self._attempt_ewma_s,
                                           self.hedge_after_s)):
            return self._send(rec, body, timeout_s)
        primary = self._pool.submit(self._send, rec, body, timeout_s)
        done, _ = wait([primary], timeout=self.hedge_after_s)
        if done:
            return primary.result()
        hedge_rec = self._pick(exclude=tried | {rec["node_id"]})
        if hedge_rec is None:
            return primary.result()
        tried.add(hedge_rec["node_id"])
        self._c_hedges.inc(1.0, outcome="fired")
        hedge = self._pool.submit(self._send, hedge_rec, body,
                                  timeout_s)
        pending = {primary, hedge}
        first_failure = None
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                att = f.result()
                if att.ok:
                    if f is hedge:
                        self._c_hedges.inc(1.0, outcome="won")
                    return att
                first_failure = first_failure or att
        return first_failure

    # ---- public API ------------------------------------------------------
    def predict(self, features, timeout_s: Optional[float] = None,
                deadline: Optional[Deadline] = None):
        """Dispatch one predict; returns the decoded JSON answer dict
        (``{"output": ..., "n": ...}``). Raises :class:`NoNodesError`
        when the registry has nothing dispatchable, :class:`RemoteError`
        when every attempt failed, :class:`DeadlineExceeded` when the
        caller's budget (``deadline``, or ``timeout_s`` from now) ran
        out — expired requests shed synchronously, and the retry/hedge
        loop stops as soon as the remaining budget can't cover a
        typical attempt."""
        if hasattr(features, "tolist"):
            features = features.tolist()
        body = json.dumps({"features": features}).encode()
        if timeout_s is not None:
            d2 = Deadline.after_ms(float(timeout_s) * 1e3,
                                   clock=self.clock)
            if deadline is None \
                    or d2.remaining_s() < deadline.remaining_s():
                deadline = d2
        if deadline is not None and deadline.expired:
            self._c_deadline.inc(1.0, stage="ingress")
            raise DeadlineExceeded(
                "remote predict: deadline expired before dispatch")
        tried: set = set()
        attempts: List[Tuple[str, str]] = []
        delay = self.backoff_s
        for attempt_no in range(self.retries + 1):
            rec = self._pick(exclude=tried)
            if rec is None and not tried:
                rec = self._await_first_node()
            if rec is None:
                break
            tried.add(rec["node_id"])
            t_att0 = self.clock()
            att = self._send_hedged(rec, body, tried, deadline)
            dt = max(self.clock() - t_att0, 0.0)
            self._attempt_ewma_s = dt if self._attempt_ewma_s == 0.0 \
                else 0.8 * self._attempt_ewma_s + 0.2 * dt
            if att.ok:
                return att.value
            attempts.append((rec["node_id"], att.reason))
            if not att.retriable:
                raise RemoteError(
                    f"predict rejected by node {rec['node_id']}: "
                    f"{att.reason}", attempts)
            if attempt_no >= self.retries:
                break
            # a 503's Retry-After overrides the backoff curve (the node
            # told us when it wants traffic back); otherwise bounded
            # exponential backoff with jitter
            if att.retry_after is not None:
                pause = att.retry_after
            else:
                pause = delay * (0.5 + self._rand.random())
                delay = min(delay * 2.0, self.backoff_max_s)
            if deadline is not None and pause + max(
                    self._attempt_ewma_s, 0.0) >= deadline.remaining_s():
                # the pause plus a typical attempt would blow the
                # budget: give up NOW and hand the budget back as 504
                self._c_deadline.inc(1.0, stage="retry")
                raise DeadlineExceeded(
                    "remote predict: budget exhausted after "
                    + "; ".join(f"{n}: {r}" for n, r in attempts))
            if pause > 0:
                self.sleep(min(pause, self.backoff_max_s * 4))
            self._c_retries.inc(1.0)
        if not attempts:
            raise NoNodesError(
                "no dispatchable node in the registry at "
                f"{self.registry.dir!r}")
        raise RemoteError(
            "predict failed on every tried node: "
            + "; ".join(f"{n}: {r}" for n, r in attempts), attempts)

    def records(self) -> List[Dict[str, Any]]:
        """The current dispatchable registry records — for callers
        that own placement themselves (the neighbors scatter-gather
        maps shard ownership from the gossiped stats) but still want
        this dispatcher's breakers/inflight accounting on every send."""
        return self._nodes()

    def call(self, rec: Dict[str, Any], payload: Dict[str, Any], *,
             path: str, timeout_s: Optional[float] = None,
             deadline: Optional[Deadline] = None) -> Dict[str, Any]:
        """One TARGETED dispatch: send ``payload`` to exactly the node
        in ``rec`` at ``path`` — no re-pick, no retry-elsewhere (the
        caller owns placement; a sharded corpus query cannot be
        answered by an arbitrary other node). Breaker accounting,
        deadline capping and the chaos seam are the same machinery
        :meth:`predict` uses. Raises :class:`RemoteError` on any
        failure (the caller decides between replica retry and partial
        degradation) and :class:`DeadlineExceeded` on an expired
        budget."""
        if deadline is not None and deadline.expired:
            self._c_deadline.inc(1.0, stage="ingress")
            raise DeadlineExceeded(
                f"remote call {path}: deadline expired before dispatch")
        body = json.dumps(payload).encode()
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        if deadline is not None:
            t = max(deadline.cap_timeout(t), 1e-3)
        att = self._send(rec, body, t, path=path)
        if att.ok:
            return att.value
        raise RemoteError(
            f"call {path} failed on node {rec['node_id']}: "
            f"{att.reason}", [(rec["node_id"], att.reason)])

    def _await_first_node(self) -> Optional[Dict[str, Any]]:
        """Scale-from-zero path: signal demand, then (optionally) wait
        for the autoscaler to bring a node up."""
        if self.on_no_nodes is not None:
            try:
                self.on_no_nodes()
            except Exception:
                pass        # a hook bug must not mask the NoNodes
        if self.wait_for_nodes_s <= 0:
            return None
        deadline = self.clock() + self.wait_for_nodes_s
        while self.clock() < deadline:
            self.sleep(min(0.05, self.wait_for_nodes_s))
            rec = self._pick(exclude=set())
            if rec is not None:
                return rec
        return None

    def output(self, features, timeout_s: Optional[float] = None,
               deadline: Optional[Deadline] = None):
        """Like :meth:`predict` but returns just the output list — the
        remote spelling of ``FleetRouter.output``."""
        return self.predict(features, timeout_s=timeout_s,
                            deadline=deadline)["output"]

    def shutdown(self):
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
