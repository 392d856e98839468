"""Cluster-wide retrieval: gossiped shard ownership + scatter-gather.

The port of the JAX package's ``retrieval/cluster.py`` (the same gossip
record, routes and ``dl4j_nn_*`` series).
Placement is gossip, not a coordinator: every :class:`RetrievalNode`
heartbeats its owned shard ids (and the index's full shard universe)
into the shared :class:`NodeRegistry`, exactly like the serving nodes
gossip load. A :class:`NeighborsDispatcher` reads the registry
snapshot, groups the universe by owner, and fans one POST
``/api/neighbors/shard`` out per owning node through the
:class:`RemoteDispatcher` machinery — per-node circuit breakers,
deadline-capped transport timeouts, and the ``remote.send`` chaos seam
all come along for free. Each node answers its shards' merged top-k;
the dispatcher k-way-merges the node answers host-side by
``(distance, id)``.

Degradation is partial, never silent: when a shard's owners all fail
mid-query (SIGKILL, breaker open, shed), the dispatcher retries the
missing shards once on surviving replicas and then answers from
whatever shards responded with ``partial: True`` and the answered/total
shard counts — every in-flight query gets an answer, flagged when the
corpus slice behind it was incomplete (the chaos-soak contract).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.chaos.hook import chaos_site
from deeplearning4j_tpu_torch.observe.latency import LatencyRing
from deeplearning4j_tpu_torch.parallel.deadline import Deadline
from deeplearning4j_tpu_torch.parallel.node import NodeRegistry, _GossipNode
from deeplearning4j_tpu_torch.parallel.remote import (
    RemoteDispatcher,
    RemoteError,
)
from deeplearning4j_tpu_torch.retrieval.engine import merge_topk

SHARD_PATH = "/api/neighbors/shard"


class RetrievalNode(_GossipNode):
    """One retrieval worker: RetrievalEngine behind the fleet front
    door + UI HTTP surface, heartbeating shard ownership into the
    registry. The lifecycle contract is ServingNode's: ``drain()``
    gossips ``draining``, refuses new neighbor queries with 503 +
    Retry-After, finishes admitted in-flight searches, deregisters,
    then stops; ``install_sigterm_drain`` from parallel/node.py works
    unchanged. ``device`` must be the engine's (the card unless
    ``"cpu"``)."""

    def __init__(self, engine, *, node_id: str,
                 registry: NodeRegistry, pool_name: str = "neighbors",
                 slo_ms: Optional[float] = None, ui_port: int = 0,
                 heartbeat_interval_s: float = 0.5,
                 metrics_registry=None,
                 window_s: Optional[float] = None,
                 store=None, index_key: Optional[str] = None,
                 device=None):
        from deeplearning4j_tpu_torch.observe.registry import \
            default_registry
        from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter
        from deeplearning4j_tpu_torch.ui.neighbors_module import \
            NeighborsModule
        from deeplearning4j_tpu_torch.ui.server import UIServer
        from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
        from deeplearning4j_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        if engine.device.type != dev.type:
            raise ValueError(f"RetrievalNode on {dev}: the engine serves "
                             f"on {engine.device}")
        self.node_id = str(node_id)
        self.registry = registry
        self.pool_name = pool_name
        self.engine = engine
        self.metrics = metrics_registry if metrics_registry is not None \
            else default_registry()
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        # warm BEFORE the first heartbeat: a node only becomes
        # dispatchable once every ladder cell has been dispatched
        engine.warmup()
        self.router = FleetRouter(
            slo_ms=slo_ms, registry=self.metrics, window_s=window_s,
            session_id=f"nn-node-{self.node_id}", device=dev)
        self.pool = self.router.add_retrieval_pool(
            pool_name, engine, slo_ms=slo_ms)
        self.server = UIServer(port=ui_port, registry=self.metrics)
        self.server.attach(InMemoryStatsStorage())
        self.server.register_module(NeighborsModule(
            router=self.router, model=pool_name, store=store,
            index_key=index_key))
        self.server.start()
        self._start_beat(f"dl4j-nn-node-{self.node_id}")

    def node_stats(self) -> Dict[str, Any]:
        """The gossiped snapshot: load (dispatcher tie-break) PLUS
        shard ownership (the scatter-gather placement map)."""
        pool = self.pool
        with pool.lock:
            pending = pool.pending
            p99 = pool.windowed_p99_ms
        return {"pending": pending,
                "inflight": self.engine.inflight,
                "windowed_p99_ms": p99,
                "requests": pool.ring.count,
                "shards": list(self.engine.shard_ids),
                "all_shards": list(self.engine.all_shard_ids),
                "index_version": self.engine.version}

    def search(self, queries, k: int, **kw):
        return self.router.neighbors(queries, k,
                                     model=self.pool_name, **kw)

    def _pending(self) -> int:
        with self.pool.lock:
            return self.pool.pending


class PartialResultError(RuntimeError):
    """Raised only under ``require_full=True``: some shard had no
    surviving owner. Default behavior degrades instead of raising."""


class NeighborsDispatcher:
    """Client-side scatter-gather over the gossiped shard map."""

    def __init__(self, registry: NodeRegistry, *,
                 dispatcher: Optional[RemoteDispatcher] = None,
                 timeout_s: float = 30.0,
                 max_fanout_workers: int = 16,
                 metrics=None, **dispatcher_kwargs):
        from deeplearning4j_tpu_torch.observe.registry import \
            default_registry
        self.registry = registry
        self._rd = dispatcher if dispatcher is not None else \
            RemoteDispatcher(registry, timeout_s=timeout_s,
                             metrics=metrics, **dispatcher_kwargs)
        self._owns_rd = dispatcher is None
        # chaos seam: the soak kills a shard owner mid-query by failing
        # its fan-out leg here (on top of the transport-level
        # remote.send site the RemoteDispatcher already arms)
        self._chaos_fanout = chaos_site("neighbors.fanout")
        self._pool = ThreadPoolExecutor(
            max_workers=max_fanout_workers,
            thread_name_prefix="dl4j-nn-fanout")
        self.merge_ring = LatencyRing()
        reg = metrics if metrics is not None else default_registry()
        self._c_shard_req = reg.counter(
            "dl4j_nn_shard_requests_total",
            "per-node shard fan-out legs; outcome=ok|error")
        self._c_partial = reg.counter(
            "dl4j_nn_partial_total",
            "queries answered with partial:true — some shard had no "
            "surviving owner inside the budget")
        self._g_fanout = reg.gauge(
            "dl4j_nn_fanout_nodes",
            "owning nodes the last query fanned out to")
        self._g_merge = reg.gauge(
            "dl4j_nn_fanout_merge_seconds",
            "host-side cross-node k-way merge wall time, last query")

    # ---- placement -------------------------------------------------------
    def shard_map(self) -> Tuple[Dict[int, List[Dict[str, Any]]],
                                 List[int]]:
        """(shard -> owner records, full shard universe) from the
        current registry snapshot. The universe is the union of the
        gossiped ``all_shards`` (any single surviving node knows the
        published index's full extent)."""
        owners: Dict[int, List[Dict[str, Any]]] = {}
        universe: set = set()
        for rec in self._rd.records():
            stats = rec.get("stats") or {}
            shards = stats.get("shards")
            if not shards:
                continue
            universe.update(stats.get("all_shards") or shards)
            for s in shards:
                owners.setdefault(int(s), []).append(rec)
        return owners, sorted(universe)

    # ---- one fan-out leg -------------------------------------------------
    def _leg(self, rec: Dict[str, Any], shards: List[int],
             payload: Dict[str, Any],
             deadline: Optional[Deadline]) -> Dict[str, Any]:
        if self._chaos_fanout is not None:
            self._chaos_fanout.fail(arg=rec["node_id"])
        body = dict(payload, shards=shards)
        out = self._rd.call(rec, body, path=SHARD_PATH,
                            deadline=deadline)
        if "ids" not in out or "distances" not in out:
            raise RemoteError(
                f"malformed shard answer from {rec['node_id']}: "
                f"{sorted(out)}", [(rec["node_id"], "malformed")])
        return out

    # ---- public API ------------------------------------------------------
    def search(self, queries, k: int, *,
               mode: Optional[str] = None,
               deadline: Optional[Deadline] = None,
               require_full: bool = False) -> Dict[str, Any]:
        """Scatter-gather one query batch across the cluster. Returns
        ``{"distances": [B, k], "ids": [B, k], "partial": bool,
        "shards_total": n, "shards_answered": m, "index_version": v}``
        (numpy arrays). ``partial`` means at least one shard had no
        surviving owner — the top-k covers only the answering slice."""
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        owners, universe = self.shard_map()
        if not universe:
            raise RemoteError("no retrieval nodes gossiping shards in "
                              f"the registry at {self.registry.dir!r}",
                              [])
        payload: Dict[str, Any] = {"queries": q.tolist(), "k": int(k)}
        if mode:
            payload["mode"] = mode
        if deadline is not None:
            payload["deadline_ms"] = max(
                deadline.remaining_s(), 0.0) * 1e3
        answered: Dict[int, None] = {}
        answers: List[Tuple[np.ndarray, np.ndarray]] = []
        version = None
        missing = list(universe)
        # round 0: primary owners; round 1: retry the missing shards on
        # any surviving replica not yet tried for them
        tried: Dict[int, set] = {s: set() for s in universe}
        for round_no in range(2):
            if not missing:
                break
            if deadline is not None and deadline.expired:
                break
            groups = self._group(missing, owners, tried)
            if not groups:
                break
            self._g_fanout.set(float(len(groups)))
            futs = {
                self._pool.submit(self._leg, rec, shards, payload,
                                  deadline): (rec, shards)
                for rec, shards in groups}
            for f in futs:
                rec, shards = futs[f]
                try:
                    out = f.result()
                except Exception:
                    self._c_shard_req.inc(1.0, outcome="error")
                    continue
                self._c_shard_req.inc(1.0, outcome="ok")
                answers.append((
                    np.asarray(out["distances"], np.float32),
                    np.asarray(out["ids"], np.int32)))
                version = out.get("index_version", version)
                for s in shards:
                    answered[s] = None
            missing = [s for s in universe if s not in answered]
        partial = bool(missing)
        if partial:
            if require_full:
                raise PartialResultError(
                    f"shards {missing} unanswered (owners down/"
                    f"breaker-open) out of {len(universe)}")
            self._c_partial.inc(float(q.shape[0]))
        if not answers:
            raise RemoteError(
                f"every shard owner failed for shards {missing}", [])
        t0 = time.perf_counter()
        kk = answers[0][0].shape[1]
        d = np.stack([a[0] for a in answers])
        i = np.stack([a[1] for a in answers])
        md, mi = merge_topk(d, i, min(k, kk))
        dt = time.perf_counter() - t0
        self.merge_ring.record(dt)
        self._g_merge.set(dt)
        out = {"distances": md[0] if single else md,
               "ids": mi[0] if single else mi,
               "partial": partial,
               "shards_total": len(universe),
               "shards_answered": len(answered),
               "index_version": version}
        return out

    def _group(self, shards: List[int],
               owners: Dict[int, List[Dict[str, Any]]],
               tried: Dict[int, set]
               ) -> List[Tuple[Dict[str, Any], List[int]]]:
        """Assign each missing shard to one untried owner, balancing
        by assigned-so-far, then coalesce per node (one HTTP round
        trip per owning node, not per shard)."""
        load: Dict[str, int] = {}
        per_node: Dict[str, Tuple[Dict[str, Any], List[int]]] = {}
        for s in shards:
            cands = [r for r in owners.get(s, ())
                     if r["node_id"] not in tried[s]]
            if not cands:
                continue
            rec = min(cands,
                      key=lambda r: (load.get(r["node_id"], 0),
                                     r["node_id"]))
            nid = rec["node_id"]
            tried[s].add(nid)
            load[nid] = load.get(nid, 0) + 1
            per_node.setdefault(nid, (rec, []))[1].append(s)
        return list(per_node.values())

    def shutdown(self):
        self._pool.shutdown(wait=False)
        if self._owns_rd:
            self._rd.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
