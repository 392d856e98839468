"""Multi-node serving: gossiped node registry + node lifecycle.

The port of the JAX package's ``parallel/node.py``: plain Python over the
port's FleetRouter (parallel/fleet.py) and UI server, so the gossip
record format, the HTTP routes and the ``dl4j_cluster_*`` series are the
JAX package's.

- :class:`NodeRegistry` — a file-gossiped membership view. Every worker
  node writes ``node_<id>.json`` (atomic tmp+rename) with its URL, state
  and a stats snapshot; any reader classifies each record's age through
  :func:`~deeplearning4j_tpu_torch.parallel.cluster.classify_heartbeat_age`
  (exactly at a threshold -> the less severe class). A shared filesystem
  is the transport; nothing here assumes a coordinator.
- :class:`ServingNode` — one worker: a FleetRouter-fronted ServingEngine
  behind the UI HTTP surface, heartbeating into a registry. ``drain()``
  is the graceful exit: gossip ``draining`` (dispatchers stop routing
  here), refuse NEW predicts with 503 + ``Retry-After``, finish every
  accepted in-flight request, deregister, then stop; SIGTERM is wired
  to it by :func:`install_sigterm_drain`. A node serves on the card
  unless ``device="cpu"`` is asked for, and raises without one.
- :class:`AutoScaler` — replica-count control loop over the gossiped
  sensors: windowed p99 over the SLO or queued work past ``queue_high``
  per live node scales up (one node at a time, after ``hold_s``);
  sustained idleness scales down to ``min_nodes``, zero included, and
  the dispatcher's ``on_no_nodes`` demand signal restarts the first
  node.

Given an ``artifact_store``, a node passes its key's directory on to its
engines as ``aot_cache_dir``, as the JAX node does: the engines warm from
the persisted kernel libraries there (parallel/aot_cache.py), and the
first node to warm up publishes them.

The HTTP dispatch half (circuit breakers, retries, hedging) lives in
parallel/remote.py.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.chaos.hook import chaos_site
from deeplearning4j_tpu_torch.parallel.cluster import classify_heartbeat_age

#: Node gossip states. ``draining`` nodes are alive (they still answer
#: in-flight work and their heartbeat stays fresh) but must receive no
#: new dispatches.
NODE_UP = "up"
NODE_DRAINING = "draining"


class NodeRegistry:
    """File-gossiped membership: one ``node_<id>.json`` per worker.

    Heartbeat classification (``health`` in :meth:`snapshot`): age
    exactly at ``stale_after_s`` is **slow** (still dispatchable,
    deprioritized), strictly past ``dead_after_s`` is **dead** (invisible
    to dispatch). Records are written atomically, so a rejoining node
    with a crashed predecessor's stale file simply overwrites it.
    """

    def __init__(self, registry_dir: str, *,
                 stale_after_s: float = 2.0,
                 dead_after_s: float = 6.0):
        if dead_after_s < stale_after_s:
            raise ValueError(
                f"dead_after_s {dead_after_s} < stale_after_s "
                f"{stale_after_s}: a node cannot be dead before slow")
        self.dir = str(registry_dir)
        self.stale_after_s = float(stale_after_s)
        self.dead_after_s = float(dead_after_s)
        os.makedirs(self.dir, exist_ok=True)
        self._chaos_write = chaos_site("registry.write")

    def _path(self, node_id: str) -> str:
        return os.path.join(self.dir, f"node_{node_id}.json")

    # ---- write side (one node gossiping itself) -------------------------
    def write(self, node_id: str, url: str, *, state: str = NODE_UP,
              stats: Optional[Dict[str, Any]] = None,
              now: Optional[float] = None):
        """Atomically publish one node's record (tmp + rename — readers
        never see a torn file)."""
        payload = json.dumps({
            "node_id": node_id, "url": url, "pid": os.getpid(),
            "state": state, "time": time.time() if now is None else now,
            "stats": stats or {}}).encode("utf-8")
        if self._chaos_write is not None:
            try:
                # torn_write truncates the record (readers classify it
                # dead), delay stalls the beat, error loses it entirely
                payload, _ = self._chaos_write.mangle(payload,
                                                      arg=node_id)
            except Exception:
                return      # injected write failure: this beat is lost
        try:
            fd, tmp = tempfile.mkstemp(dir=self.dir,
                                       prefix=f".node_{node_id}_")
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, self._path(node_id))
        except OSError:
            pass            # a full/slow disk must not kill the beat

    def deregister(self, node_id: str):
        try:
            os.remove(self._path(node_id))
        except OSError:
            pass

    # ---- read side (dispatchers, autoscaler) ----------------------------
    def read_all(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in sorted(names):
            if not name.startswith("node_") or not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    rec = json.load(f)
                out[str(rec["node_id"])] = rec
            except (OSError, ValueError, KeyError):
                # torn/garbage record: surface it as a DEAD placeholder
                # keyed by filename — never raise, never silently hide a
                # node whose record exists. ``time: None`` makes
                # snapshot() classify it dead; the next healthy beat
                # overwrites it whole.
                nid = name[len("node_"):-len(".json")]
                if nid:
                    out.setdefault(nid, {
                        "node_id": nid, "url": "", "pid": None,
                        "state": NODE_UP, "time": None, "stats": {},
                        "corrupt": True})
        return out

    def snapshot(self, now: Optional[float] = None
                 ) -> Dict[str, Dict[str, Any]]:
        """Every record + its heartbeat ``age_s`` and ``health``
        (``alive``/``slow``/``dead`` via the shared boundary)."""
        now = time.time() if now is None else now
        snap = {}
        for node_id, rec in self.read_all().items():
            try:
                age = now - float(rec.get("time", 0.0))
            except (TypeError, ValueError):
                age = None
            rec = dict(rec)
            rec["age_s"] = age
            rec["health"] = classify_heartbeat_age(
                age, self.dead_after_s, self.stale_after_s)
            snap[node_id] = rec
        return snap

    def dispatchable(self, now: Optional[float] = None
                     ) -> List[Dict[str, Any]]:
        """Nodes a dispatcher may route to: state ``up`` and not dead —
        alive first, slow after (a slow node is a last resort)."""
        rank = {"alive": 0, "slow": 1}
        nodes = [r for r in self.snapshot(now).values()
                 if r["state"] == NODE_UP and r["health"] in rank]
        nodes.sort(key=lambda r: (rank[r["health"]], r["node_id"]))
        return nodes


class _GossipNode:
    """The heartbeat and drain lifecycle a serving node and a retrieval
    node share (``retrieval/cluster.py``). A subclass builds ``router``
    and ``server`` and calls :meth:`_start_beat`; it defines
    ``node_stats()`` and ``_pending()``."""

    node_id: str
    registry: NodeRegistry
    heartbeat_interval_s: float

    def _start_beat(self, thread_name: str):
        self._lock = threading.Lock()
        self._state = NODE_UP
        self._stopped = False
        self._stop_beat = threading.Event()
        self._beat_now()            # visible before the thread spins up
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name=thread_name, daemon=True)
        self._beat_thread.start()

    @property
    def url(self) -> str:
        return self.server.url

    def _beat_now(self):
        with self._lock:
            state = self._state
        try:
            stats = self.node_stats()
        except Exception:
            stats = {}
        self.registry.write(self.node_id, self.url, state=state,
                            stats=stats)

    def _beat_loop(self):
        while not self._stop_beat.wait(self.heartbeat_interval_s):
            self._beat_now()

    def assert_warm(self):
        self.router.assert_warm()

    def stats(self) -> Dict[str, Any]:
        return {"node_id": self.node_id, "url": self.url,
                "state": self._state, **self.router.stats()}

    def _inflight_total(self) -> int:
        # HTTP handler threads may still be serializing a finished
        # answer after the pool drains — count them too, so "drained"
        # means the response bytes are on the wire
        return self._pending() + self.server.active_requests

    def _on_drained(self, seconds: float):
        """Hook between the wait and the deregistration."""

    def drain(self, timeout_s: float = 30.0) -> Dict[str, Any]:
        """Graceful exit: gossip ``draining`` (dispatchers stop routing
        here), refuse NEW requests with 503 + ``Retry-After``, wait for
        every accepted request to finish (admitted work is never shed),
        deregister, then stop the server and engines. Returns
        ``{"drained": bool, "seconds": float, "inflight_left": int}``.
        """
        t0 = time.monotonic()
        with self._lock:
            already = self._stopped
            self._state = NODE_DRAINING
        if already:
            return {"drained": True, "seconds": 0.0, "inflight_left": 0}
        self._beat_now()                    # gossip "draining" at once
        self.server.drain()                 # 503 + Retry-After on new work
        deadline = t0 + float(timeout_s)
        left = self._inflight_total()
        while left > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
            left = self._inflight_total()
        seconds = time.monotonic() - t0
        self._on_drained(seconds)
        # deregister BEFORE the server dies: peers must see an orderly
        # departure, never a record that just goes stale
        self._stop_beat.set()
        self._beat_thread.join(timeout=5 * self.heartbeat_interval_s + 1)
        self.registry.deregister(self.node_id)
        with self._lock:
            self._stopped = True
        self.server.stop()
        self.router.shutdown()
        return {"drained": left == 0, "seconds": seconds,
                "inflight_left": left}

    def shutdown(self):
        """Fast stop (no waiting): deregister + tear down. ``drain()``
        is the graceful path; this is for tests and error exits."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self._stop_beat.set()
        self._beat_thread.join(timeout=5 * self.heartbeat_interval_s + 1)
        self.registry.deregister(self.node_id)
        self.server.stop()
        self.router.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


class ServingNode(_GossipNode):
    """One worker node: FleetRouter + ServingEngine behind the UI HTTP
    surface, heartbeating into a :class:`NodeRegistry`.

    ``device`` is where the node serves: the card unless ``"cpu"``; a
    built model must already lie there. ``artifact_store``/``model_key``
    name the shared cache dir the node's engines warm from (the key
    defaults to ``model_name``).
    """

    def __init__(self, model, *, node_id: str, registry: NodeRegistry,
                 model_name: str = "default", version: str = "v1",
                 slo_ms: Optional[float] = None,
                 artifact_store=None, model_key: Optional[str] = None,
                 pool_size: int = 1, ui_port: int = 0,
                 heartbeat_interval_s: float = 0.5,
                 metrics_registry=None, window_s: Optional[float] = None,
                 device=None, **engine_kwargs):
        import torch

        from deeplearning4j_tpu_torch.observe.registry import (
            default_registry)
        from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter
        from deeplearning4j_tpu_torch.ui.server import UIServer
        from deeplearning4j_tpu_torch.ui.serving_module import (
            FleetModule, ServingModule)
        from deeplearning4j_tpu_torch.ui.storage import (
            InMemoryStatsStorage)
        from deeplearning4j_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        model_dev = getattr(model, "device", None)
        if model_dev is not None and torch.device(model_dev).type \
                != dev.type:
            raise ValueError(f"ServingNode on {dev}: the model lies on "
                             f"{model_dev}")
        self.node_id = str(node_id)
        self.registry = registry
        self.model_name = model_name
        self.device = dev
        self.metrics = metrics_registry if metrics_registry is not None \
            else default_registry()
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        if artifact_store is not None:
            key = model_key or model_name
            engine_kwargs["aot_cache_dir"] = artifact_store.cache_dir(key)
        self.router = FleetRouter(
            slo_ms=slo_ms, registry=self.metrics, window_s=window_s,
            session_id=f"node-{self.node_id}", device=dev)
        self.router.add_pool(model_name, model, version=version,
                             pool_size=pool_size, **engine_kwargs)
        self.server = UIServer(port=ui_port, registry=self.metrics)
        self.server.attach(InMemoryStatsStorage())
        # FleetModule first: its admission-controlled /api/predict wins
        self.server.register_module(FleetModule(self.router))
        self.server.register_module(
            ServingModule(self.router.pool(model_name).engines[0]))
        self.server.start()

        self._g_drain = self.metrics.gauge(
            "dl4j_cluster_drain_seconds",
            "wall seconds the last graceful drain took on this node")
        self._start_beat(f"dl4j-node-{self.node_id}")

    def node_stats(self) -> Dict[str, Any]:
        """The gossiped load snapshot (the dispatcher's least-loaded
        tie-break and the autoscaler's sensor)."""
        pool = self.router.pool(self.model_name)
        with pool.lock:
            pending = pool.pending
            p99 = pool.windowed_p99_ms
            engines = list(pool.engines)
        inflight = sum(e.inflight for e in engines)
        queue_depth = sum(e.stats().get("queue_depth", 0)
                          for e in engines)
        return {"pending": pending, "inflight": inflight,
                "queue_depth": queue_depth, "windowed_p99_ms": p99,
                "requests": pool.ring.count}

    def output(self, features):
        return self.router.output(features, model=self.model_name)

    def _pending(self) -> int:
        pool = self.router.pool(self.model_name)
        with pool.lock:
            return pool.pending

    def _on_drained(self, seconds: float):
        self._g_drain.set(seconds, node=self.node_id)


def install_sigterm_drain(node, timeout_s: float = 30.0) -> None:
    """SIGTERM -> graceful drain -> exit 0. The handler runs the full
    drain (finish in-flight, deregister) then ``os._exit(0)`` — the
    orchestrator's TERM..KILL grace window is what ``timeout_s`` should
    be set to."""
    def _handler(signum, frame):
        result = node.drain(timeout_s)
        print(f"[node {node.node_id}] SIGTERM drain: "
              f"{result['seconds']:.2f}s, "
              f"inflight_left={result['inflight_left']}", flush=True)
        sys.stdout.flush()
        os._exit(0 if result["drained"] else 1)
    signal.signal(signal.SIGTERM, _handler)


class AutoScaler:
    """Replica-count control loop over a :class:`NodeRegistry`.

    The sensor is the AIMD shed controller's own signals, gossiped: any
    node's windowed p99 over the SLO, or total queued work past
    ``queue_high`` per live node, means the fleet is tight; sustained
    for ``hold_s`` it spawns one node (additive increase). No traffic at
    all for ``idle_after_s`` retires one node, down to ``min_nodes`` —
    with ``min_nodes=0`` the fleet scales to zero and the dispatcher's
    ``on_no_nodes`` demand signal (:meth:`note_demand`) restarts the
    first node.

    ``spawn()`` / ``stop(node_id)`` are injected (a subprocess launcher
    in production, fakes in tests); ``clock`` is injectable so tests
    never sleep.
    """

    def __init__(self, registry: NodeRegistry, *,
                 spawn: Callable[[], Any],
                 stop: Callable[[str], Any],
                 slo_ms: Optional[float] = None,
                 min_nodes: int = 0, max_nodes: int = 4,
                 queue_high: int = 8, hold_s: float = 1.0,
                 idle_after_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.spawn = spawn
        self.stop = stop
        self.slo_ms = slo_ms
        self.min_nodes = int(min_nodes)
        self.max_nodes = int(max_nodes)
        self.queue_high = int(queue_high)
        self.hold_s = float(hold_s)
        self.idle_after_s = float(idle_after_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._over_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_requests: Optional[int] = None
        self._demand = False
        self.scale_ups = 0
        self.scale_downs = 0

    def note_demand(self):
        """Demand signal from the dispatch tier (``on_no_nodes``): a
        request arrived with nothing to route to — the scale-from-zero
        trigger."""
        with self._lock:
            self._demand = True

    def tick(self) -> Optional[str]:
        """One control step; returns ``"up"``/``"down"``/None for what
        it did."""
        now = self.clock()
        snap = self.registry.snapshot()
        live = [r for r in snap.values()
                if r["state"] == NODE_UP and r["health"] != "dead"]
        with self._lock:
            demand, self._demand = self._demand, False

        # ---- pressure sensor (the AIMD controller's own signals) -----
        p99s = [r["stats"].get("windowed_p99_ms") for r in live]
        p99s = [p for p in p99s if p is not None]
        queued = sum(int(r["stats"].get("pending") or 0)
                     + int(r["stats"].get("queue_depth") or 0)
                     for r in live)
        over = (demand and not live) \
            or (self.slo_ms is not None and p99s
                and max(p99s) > self.slo_ms) \
            or (live and queued > self.queue_high * len(live))
        if over:
            if self._over_since is None:
                self._over_since = now
            held = now - self._over_since
            # scale-from-zero is immediate: there is nothing to measure
            # a hold against, and every waiting request is an error
            if (not live or held >= self.hold_s) \
                    and len(live) < self.max_nodes:
                self._over_since = None
                self.scale_ups += 1
                self.spawn()
                return "up"
            return None
        self._over_since = None

        # ---- idleness sensor -----------------------------------------
        total_requests = sum(int(r["stats"].get("requests") or 0)
                             for r in live)
        if self._last_requests is None \
                or total_requests != self._last_requests:
            self._last_requests = total_requests
            self._idle_since = now
            return None
        if self._idle_since is not None \
                and now - self._idle_since >= self.idle_after_s \
                and len(live) > self.min_nodes:
            self._idle_since = now
            victim = max(live, key=lambda r: r["node_id"])
            self.scale_downs += 1
            self.stop(victim["node_id"])
            return "down"
        return None
