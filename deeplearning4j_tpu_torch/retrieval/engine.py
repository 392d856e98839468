"""RetrievalEngine: warmed distance+top-k serving over a sharded index.

The port of the JAX package's ``retrieval/engine.py``. The shards live on
the engine's device as torch tensors (the card unless ``device="cpu"``;
without a card the engine raises), and ``retrieval/kernels.py`` runs one
query batch against one shard.

The serving contract mirrors the predict engine's (parallel/serving.py):

- **Ladders, not live shapes.** Query batches pad up the pow2 bucket
  ladder; ``k`` pads up the configured k-ladder (a request for k=7
  runs the warmed k=10 cell and slices). Every (bucket, k, mode) cell is
  dispatched once by :meth:`warmup` — shards share one padded geometry,
  so the cell count is independent of shard count. As in the port's
  serving engine, a "compile" is a cell's first dispatch (cuBLAS picks
  its algorithm, the allocator grows): one made by live traffic after
  the warmup, or a signature drift the recompile watchdog sees, fails
  ``assert_warm``.
- **Only k leaves the device.** Per (query batch, shard) the host
  receives k ids + k distances; the cross-shard k-way merge is host
  numpy over S·k candidates, sorted by ``(distance, id)`` so tie order
  — and therefore the full response — is bitwise-deterministic
  run-to-run.
- **int8 refine.** The int8 arm overfetches to the ladder rung >= 2k
  on device, then exact-rescores those candidates against f32 source
  rows kept in HOST ram (FAISS IndexRefineFlat idiom): accelerator
  HBM holds only the 4x-dense int8 shard, and the recall the 8-bit
  ordering loses at depth k is recovered from the 2k candidate set.
- **Hot index promotion.** :meth:`refresh` loads the store's published
  version, gates it (recall@10 of the routed arm against the new
  index's own brute-force answers on seeded probes — routing loss, the
  thing a bad refresh regresses), and swaps the device arrays under the
  lock. Geometry equality is checked first: a refreshed index reuses
  the warmed cells, zero recompiles.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from deeplearning4j_tpu_torch.observe.latency import LatencyRing
from deeplearning4j_tpu_torch.observe.recompile import RecompileWatchdog
from deeplearning4j_tpu_torch.observe.registry import default_registry
from deeplearning4j_tpu_torch.parallel.deadline import Deadline
from deeplearning4j_tpu_torch.retrieval import kernels
from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex


class _DeviceShard:
    """One shard's tensors on the engine's device (host copies dropped)."""

    _ARRAYS = ("vectors", "c2", "ids", "row_scales", "centroids",
               "clustered", "c_scales", "c_c2", "c_ids")

    def __init__(self, shard, device: torch.device):
        self.shard_id = shard.shard_id
        self.n = shard.n
        for name in self._ARRAYS:
            a = getattr(shard, name)
            setattr(self, name, None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(device))

    @property
    def nbytes(self) -> int:
        """Bytes of corpus data resident on the device."""
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, n) for n in self._ARRAYS)
                   if t is not None)


def merge_topk(dists: np.ndarray, ids: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Host k-way merge of per-source candidates: ``dists``/``ids`` are
    [S, B, k'] — concat the source axis, order by ``(distance, id)``
    (the id tie-break makes cross-source ties deterministic regardless
    of arrival order), drop padding (id < 0), take k. Returns
    ([B, k] f32, [B, k] int32) padded with (+inf, -1) when fewer than k
    real candidates exist."""
    s, b, kk = dists.shape
    flat_d = np.transpose(dists, (1, 0, 2)).reshape(b, s * kk)
    flat_i = np.transpose(ids, (1, 0, 2)).reshape(b, s * kk)
    # padding sorts last: +inf distance, and id -1 remapped past every
    # real id so lexsort never prefers it on a distance tie
    tie = np.where(flat_i < 0, np.iinfo(np.int32).max, flat_i)
    order = np.lexsort((tie, flat_d), axis=1)[:, :k]
    out_d = np.take_along_axis(flat_d, order, axis=1)
    out_i = np.take_along_axis(flat_i, order, axis=1)
    out_d = np.where(out_i < 0, np.inf, out_d).astype(np.float32)
    return out_d, out_i.astype(np.int32)


class RetrievalEngine:
    """Fused distance+top-k serving over one node's index shards."""

    def __init__(self, index: ShardedCorpusIndex, *,
                 k_ladder: Optional[Tuple[int, ...]] = None,
                 max_batch: int = 64,
                 nprobe: Optional[int] = None,
                 registry=None, session_id: str = "neighbors",
                 tuned_config=None, device=None):
        from deeplearning4j_tpu_torch.optimize.autotune import (
            resolve_tuned, tuned_value)
        from deeplearning4j_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.registry = registry if registry is not None \
            else default_registry()
        self.session_id = session_id
        self.tuned_config = tuned_config
        self._lock = threading.Lock()
        self._inflight = 0
        self.max_batch = int(max_batch)
        self.buckets = _pow2_ladder(self.max_batch)
        k_ladder = resolve_tuned(k_ladder, tuned_config,
                                 "retrieval.k_ladder")
        self.k_ladder = tuple(sorted(int(k) for k in k_ladder))
        if not self.k_ladder or self.k_ladder[0] < 1:
            raise ValueError(f"bad k ladder {k_ladder!r}")
        self.modes = ["brute"] + (["ivf"] if index.ivf else [])
        if index.ivf:
            # explicit nprobe > machine-measured tuned value > the
            # index build's own geometry hint. The registry default (a
            # scalar) deliberately does NOT apply here: absent any
            # measurement, the per-index hint knows the geometry better
            if nprobe is None:
                nprobe = tuned_value("retrieval.nprobe", tuned_config)
            hint = index.ivf.get("nprobe_hint", 8)
            self.nprobe = min(int(nprobe or hint),
                              index.ivf["clusters"])
        else:
            self.nprobe = None
        self.default_mode = "ivf" if index.ivf else "brute"
        self._cells: set = set()        # cells dispatched at least once
        self._live_compiles = 0         # first dispatches after warmup
        self._install(index)

        self.watchdog = RecompileWatchdog(
            registry=self.registry, session_id=session_id)
        self.query_ring = LatencyRing()
        self.merge_ring = LatencyRing()
        self.warmup_seconds: Optional[float] = None
        self._warm = False
        reg = self.registry
        self._c_queries = reg.counter(
            "dl4j_nn_queries_total",
            "nearest-neighbor queries answered (query vectors, not "
            "HTTP requests), per search mode")
        self._c_refresh = reg.counter(
            "dl4j_nn_index_refresh_total",
            "hot index promotions; outcome=promoted|rejected|noop")
        self._g_vectors = reg.gauge(
            "dl4j_nn_index_vectors",
            "corpus vectors in the full published index this engine "
            "serves a slice of")
        self._g_merge = reg.gauge(
            "dl4j_nn_merge_seconds",
            "host-side k-way merge wall time of the last query batch")
        self._g_vectors.set(float(index.n_total))

    def _install(self, index: ShardedCorpusIndex):
        self.index = index
        self.dim = index.dim
        self.precision = index.precision
        self.version = index.version
        self.shard_ids = list(index.shard_ids)
        self.all_shard_ids = list(index.all_shard_ids)
        self._shards = [_DeviceShard(s, self.device)
                        for s in index.shards]
        # int8 arm: the f32 rows stay in HOST ram (never shipped to
        # the accelerator) so the 2k-deep int8 candidate list can be
        # rescored at full precision — global ids are contiguous per
        # shard, so (base id, rows) is the whole lookup
        self._refine: Dict[int, Tuple[int, np.ndarray]] = {}
        for s in index.shards:
            if s.refine is not None:
                self._refine[s.shard_id] = (
                    int(np.asarray(s.ids)[0]),
                    np.asarray(s.refine, np.float32))
        # drop the remaining host copies: the device arrays are the
        # only resident corpus from here on (the index object keeps
        # only geometry metadata for promotion checks)
        for s in index.shards:
            s.vectors = s.c2 = s.ids = s.row_scales = None
            s.centroids = s.clustered = s.c_scales = None
            s.c_c2 = s.c_ids = s.refine = None

    # ---- dispatch --------------------------------------------------------
    def _dispatch(self, q_dev, sh: _DeviceShard, k: int, mode: str):
        """One (padded query batch, shard) kernel call. The watchdog
        key pins one ladder cell — (mode, precision, bucket, k) — so
        exactly one signature per key is the expected first compile
        and anything else (dtype drift, a ragged batch escaping the
        pad) counts as a live recompile."""
        key = (f"nn.{mode}.{self.precision}"
               f".b{q_dev.shape[0]}.k{k}")
        if self.watchdog.observe(key, q_dev, k):
            with self._lock:
                if key not in self._cells:
                    self._cells.add(key)
                    if self._warm:
                        self._live_compiles += 1
        if mode == "ivf":
            if sh.centroids is None:
                raise ValueError("index built without IVF layout")
            if self.precision == "int8":
                return kernels.ivf_topk_int8(
                    q_dev, sh.centroids, sh.clustered, sh.c_scales,
                    sh.c_c2, sh.c_ids, k, self.nprobe)
            return kernels.ivf_topk_f32(
                q_dev, sh.centroids, sh.clustered, sh.c_c2, sh.c_ids,
                k, self.nprobe)
        if self.precision == "int8":
            return kernels.brute_topk_int8(
                q_dev, sh.vectors, sh.row_scales, sh.c2, sh.ids, k)
        return kernels.brute_topk_f32(
            q_dev, sh.vectors, sh.c2, sh.ids, k)

    def _pad_k(self, k: int) -> int:
        for kk in self.k_ladder:
            if kk >= k:
                return kk
        raise ValueError(
            f"k={k} above the warmed ladder {self.k_ladder}; raise "
            f"k_ladder at engine construction")

    def _device_k(self, k: int) -> int:
        """The rung the DEVICE kernel runs at. The int8 arm overfetches
        to the next rung >= 2k when the ladder has one: the int8
        top-2k survives quantization where the int8 top-k ordering does
        not, and the exact f32 rescore of those candidates recovers
        full recall (the FAISS refine idiom). Falls back to plain
        rung(k) when the ladder tops out — rescore then only reorders."""
        if self._refine:
            for kk in self.k_ladder:
                if kk >= 2 * k:
                    return kk
        return self._pad_k(k)

    def _rescore(self, q: np.ndarray, cand_d: np.ndarray,
                 cand_i: np.ndarray, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact-f32 rescore of the device's int8 candidates against
        the host-resident source rows, then (distance, id) re-sort to
        k. Host cost is O(B * k_dev * D) on k_dev rows per query —
        the candidate egress, not a corpus scan."""
        b, kk = cand_i.shape
        flat = cand_i.ravel()
        rows = np.zeros((flat.size, self.dim), np.float32)
        valid = flat >= 0
        for base, rr in self._refine.values():
            m = valid & (flat >= base) & (flat < base + rr.shape[0])
            if m.any():
                rows[m] = rr[flat[m] - base]
        d2 = ((q[:, None, :] - rows.reshape(b, kk, self.dim)) ** 2
              ).sum(-1).astype(np.float32)
        d2 = np.where(cand_i < 0, np.inf, d2)
        tie = np.where(cand_i < 0, np.iinfo(np.int32).max, cand_i)
        order = np.lexsort((tie, d2), axis=1)[:, :k]
        out_d = np.take_along_axis(d2, order, axis=1)
        out_i = np.take_along_axis(cand_i, order, axis=1)
        out_d = np.where(out_i < 0, np.inf, out_d).astype(np.float32)
        return out_d, out_i.astype(np.int32)

    def _pad_bucket(self, b: int) -> int:
        for bb in self.buckets:
            if bb >= b:
                return bb
        return self.buckets[-1]

    def search(self, queries, k: int, *, mode: Optional[str] = None,
               deadline: Optional[Deadline] = None,
               shard_ids: Optional[List[int]] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Answer ``queries`` ([D] or [B, D]) with the k nearest
        neighbors over this engine's (or the ``shard_ids`` subset's)
        shards. Returns ``(distances [B, k] f32, ids [B, k] int32)``
        — padded with (+inf, -1) when the corpus holds fewer than k.
        Batches over ``max_batch`` chunk internally."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        mode = mode or self.default_mode
        if mode not in self.modes:
            raise ValueError(f"mode {mode!r} not in {self.modes}")
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"queries must be [B, {self.dim}], got {q.shape}")
        with self._lock:
            self._inflight += 1
            shards = self._shards if shard_ids is None else \
                [s for s in self._shards if s.shard_id in shard_ids]
        try:
            if not shards:
                raise ValueError(f"no local shards in {shard_ids!r}")
            if deadline is not None:
                deadline.check("neighbors: before dispatch")
            t0 = time.perf_counter()
            k_dev = self._device_k(k)
            out_d, out_i = [], []
            for lo in range(0, q.shape[0], self.max_batch):
                chunk = q[lo:lo + self.max_batch]
                b = chunk.shape[0]
                bucket = self._pad_bucket(b)
                if bucket > b:
                    chunk = np.concatenate(
                        [chunk, np.zeros((bucket - b, self.dim),
                                         np.float32)])
                q_dev = torch.from_numpy(chunk).to(self.device)
                per = []
                for sh in shards:
                    if deadline is not None:
                        deadline.check("neighbors: mid fan-out")
                    per.append(self._dispatch(q_dev, sh, k_dev, mode))
                # fetch AFTER every shard dispatched: the shard launches
                # queue back to back; one sync point per chunk
                d = torch.stack([p[0] for p in per]).cpu().numpy()
                i = torch.stack([p[1] for p in per]).cpu().numpy()
                tm0 = time.perf_counter()
                if self._refine:
                    # keep the full k_dev candidate depth through the
                    # merge, then refine to k at exact f32
                    md, mi = merge_topk(d[:, :b], i[:, :b], k_dev)
                    md, mi = self._rescore(chunk[:b], md, mi, k)
                else:
                    md, mi = merge_topk(d[:, :b], i[:, :b], k)
                self.merge_ring.record(time.perf_counter() - tm0)
                out_d.append(md)
                out_i.append(mi)
            dists = np.concatenate(out_d)
            ids = np.concatenate(out_i)
            dt = time.perf_counter() - t0
            self.query_ring.record(dt)
            self._g_merge.set(self.merge_ring.quantiles((0.5,))[0.5]
                              if self.merge_ring.count else 0.0)
            self._c_queries.inc(float(q.shape[0]), mode=mode)
            if single:
                return dists[0], ids[0]
            return dists, ids
        finally:
            with self._lock:
                self._inflight -= 1

    # ---- warmup / recompile contract -------------------------------------
    def warmup(self) -> "RetrievalEngine":
        """Dispatch every (bucket, k, mode) cell once over every local
        shard and block, so no live query pays a compile. Idempotent."""
        t0 = time.perf_counter()
        for mode in self.modes:
            for bucket in self.buckets:
                q_dev = torch.zeros((bucket, self.dim),
                                    dtype=torch.float32, device=self.device)
                for kk in self.k_ladder:
                    last = None
                    for sh in self._shards:
                        last = self._dispatch(q_dev, sh, kk, mode)
                    if last is not None:
                        last[0].cpu()
        self._warm = True
        self.warmup_seconds = time.perf_counter() - t0
        return self

    @property
    def recompiles_after_warmup(self) -> int:
        return self._live_compiles + self.watchdog.count()

    @property
    def resident_bytes(self) -> int:
        """Bytes of corpus data on the engine's device (the int8 arm's
        f32 refine rows stay on the host and are not counted)."""
        return sum(sh.nbytes for sh in self._shards)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def assert_warm(self):
        n = self.recompiles_after_warmup
        if n:
            raise AssertionError(
                f"retrieval engine saw {n} recompile(s) after warmup: "
                f"{self.watchdog.events[-3:]}")

    # ---- hot index promotion ---------------------------------------------
    def refresh(self, store, key: str, *, probe_queries: int = 64,
                recall_floor: float = 0.95,
                recall_k: int = 10) -> Dict[str, Any]:
        """Load the store's published index version and hot-promote it.

        Gated: the candidate must (a) match the serving geometry — the
        warmed executables must keep fitting, zero recompiles — and
        (b) pass recall@``recall_k`` ≥ ``recall_floor`` of its routed
        arm (IVF when built, else brute) against its own exact
        brute-force answers on seeded probe queries. A candidate that
        fails either gate is rejected and the current version keeps
        serving."""
        new = ShardedCorpusIndex.load(store, key,
                                      shard_ids=self.shard_ids)
        if new.version == self.version:
            self._c_refresh.inc(1.0, outcome="noop")
            return {"promoted": False, "reason": "same version",
                    "version": self.version}
        if new.geometry() != self.index.geometry():
            self._c_refresh.inc(1.0, outcome="rejected")
            return {"promoted": False, "reason":
                    f"geometry mismatch: serving "
                    f"{self.index.geometry()}, candidate "
                    f"{new.geometry()}", "version": self.version}
        recall = _self_recall(new, n_queries=probe_queries,
                              k=recall_k)
        if recall is not None and recall < recall_floor:
            self._c_refresh.inc(1.0, outcome="rejected")
            return {"promoted": False, "reason":
                    f"recall@{recall_k} {recall:.3f} < gate "
                    f"{recall_floor}", "version": self.version}
        old = self.version
        with self._lock:
            self._install(new)
        # the warmed executables key on shapes only — same geometry,
        # same executables; re-observe nothing
        self._c_refresh.inc(1.0, outcome="promoted")
        self._g_vectors.set(float(new.n_total))
        return {"promoted": True, "from": old,
                "version": self.version,
                "recall_gate": recall}

    # ---- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        q = {f"p{int(k * 100)}": v * 1e3
             for k, v in self.query_ring.quantiles().items()}
        return {
            "session": self.session_id,
            "index_version": self.version,
            "precision": self.precision,
            "modes": list(self.modes),
            "default_mode": self.default_mode,
            "nprobe": self.nprobe,
            "dim": self.dim,
            "device": str(self.device),
            "resident_bytes": self.resident_bytes,
            "vectors_total": self.index.n_total,
            "shards": self.shard_ids,
            "all_shards": self.all_shard_ids,
            "shard_rows": self.index.shard_rows,
            "k_ladder": list(self.k_ladder),
            "buckets": list(self.buckets),
            "refine": bool(self._refine),
            "queries": self.query_ring.count,
            "latency_ms": q,
            "merge_p50_ms": (self.merge_ring.quantiles((0.5,))[0.5]
                             * 1e3 if self.merge_ring.count else None),
            "inflight": self.inflight,
            "warm": self._warm,
            "warmup_s": self.warmup_seconds,
            "recompiles_after_warmup": self.recompiles_after_warmup,
        }

    def shutdown(self):
        """API symmetry with the serving engines (the fleet router and
        node drain call it); no worker threads to stop here."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def _self_recall(index: ShardedCorpusIndex, *, n_queries: int,
                 k: int) -> Optional[float]:
    """Recall@k of the index's routed arm against its own exact
    brute-force answers, on seeded probes drawn from the corpus rows
    (plus noise) — host numpy, no compiles, measures ROUTING loss
    (quantization loss needs the f32 source and is gated by the
    correctness harness / benchmark instead). None when the index has
    no routed arm to gate."""
    if not index.ivf:
        return None
    rng = np.random.default_rng(index.seed + 0x5eed)
    rows, c2s, idss = [], [], []
    for sh in index.shards:
        v = np.asarray(sh.vectors)
        if v.dtype == np.int8:
            v = v.astype(np.float32) * np.asarray(
                sh.row_scales)[:, None]
        rows.append(v[:sh.n])
        idss.append(np.asarray(sh.ids)[:sh.n])
    corpus = np.concatenate(rows)
    ids = np.concatenate(idss)
    take = rng.choice(corpus.shape[0],
                      min(n_queries, corpus.shape[0]), replace=False)
    q = corpus[take] + rng.normal(
        0, 1e-3, (len(take), corpus.shape[1])).astype(np.float32)
    # exact: full distance, top-k by (d, id)
    d2 = (np.sum(q ** 2, axis=1, keepdims=True)
          - 2.0 * (q @ corpus.T) + np.sum(corpus ** 2, axis=1)[None])
    kk = min(k, corpus.shape[0])
    exact = ids[np.argsort(d2, axis=1, kind="stable")[:, :kk]]
    # routed: per-shard IVF emulation on host (same centroids/layout)
    hits = 0
    probe = min(index.ivf.get("nprobe_hint", 8),
                index.ivf["clusters"])
    routed_d, routed_i = [], []
    for sh in index.shards:
        cd2 = (np.sum(q ** 2, axis=1, keepdims=True)
               - 2.0 * (q @ np.asarray(sh.centroids).T)
               + np.sum(np.asarray(sh.centroids) ** 2, axis=1)[None])
        probes = np.argsort(cd2, axis=1, kind="stable")[:, :probe]
        cl = np.asarray(sh.clustered)
        if cl.dtype == np.int8:
            cl = cl.astype(np.float32) \
                * np.asarray(sh.c_scales)[..., None]
        cc2 = np.asarray(sh.c_c2)
        cids = np.asarray(sh.c_ids)
        for qi in range(q.shape[0]):
            sub = cl[probes[qi]].reshape(-1, q.shape[1])
            sd2 = (np.sum(q[qi] ** 2) - 2.0 * (sub @ q[qi])
                   + cc2[probes[qi]].reshape(-1))
            sids = cids[probes[qi]].reshape(-1)
            order = np.argsort(sd2, kind="stable")[:kk]
            routed_d.append(sd2[order])
            routed_i.append(sids[order])
    s = len(index.shards)
    routed_d = np.asarray(routed_d, np.float32).reshape(
        s, q.shape[0], -1)
    routed_i = np.asarray(routed_i, np.int32).reshape(
        s, q.shape[0], -1)
    _, got = merge_topk(routed_d, routed_i, kk)
    for qi in range(q.shape[0]):
        hits += len(set(exact[qi]) & set(got[qi][got[qi] >= 0]))
    return hits / float(exact.size)


def _pow2_ladder(top: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < top:
        out.append(b)
        b <<= 1
    out.append(top)
    return tuple(out)
