"""ShardedCorpusIndex: build / quantize / cluster / persist a corpus.

The port of the JAX package's ``retrieval/index.py``: host numpy plus the
port's ``clustering/kmeans.KMeansClustering`` (its kmeans++ seeding is
the JAX package's code with the same ``default_rng(seed)``; its Lloyd
steps run on ``device``, the card unless ``"cpu"``).

The on-disk format is the same bytes as the JAX package's: one ``.npz``
per shard plus the ``neighbors.json`` manifest under an ArtifactStore
key, so an index saved by either package loads in the other. That is
how a corpus is carried across; no other converter is needed.

The corpus matrix [N, D] is split into fixed-geometry shards of
``shard_rows`` rows (the last shard zero-padded, padding rows carrying
``+inf`` norm and id -1 so the kernels can never surface them). Fixed
geometry is the zero-recompile contract: every shard of an index — and
every shard of any *refreshed* version of it — dispatches through the
same compiled executables, so an index refresh while serving costs no
compiles.

Per shard, eagerly precomputed at build (never on the query path):

- **row norms** ``c2`` — the ``|c|²`` half of the expanded-quadratic
  distance; for int8 computed from the DEQUANTIZED rows so the kernel's
  distance algebra is self-consistent.
- **int8 arm** — per-row symmetric quantization via
  ``ops/quantize.quantize_rows`` (host numpy: two processes building
  the same corpus produce bitwise-identical shards).
- **IVF layout** — k-means centroids (``clustering/kmeans`` on a
  seeded subsample), then a capacity-BALANCED assignment: every row
  lands in its nearest centroid with free capacity (preference order by
  distance), capacity ``M = ceil(alpha · rows / K)``. Balancing keeps
  the padded [K, M, D] cluster-major layout dense (α bounds the padding
  waste) and — unlike truncating overfull clusters — drops no rows, so
  the recall gate measures routing loss only.

Persistence rides the ArtifactStore bucket layout
(``parallel/aot_cache.ArtifactStore``): one ``.npz`` per shard under
``objects/<key>/``, versioned filenames, and a ``neighbors.json``
manifest written atomically LAST — publish is a manifest flip, readers
mid-save just keep the previous version (the AOT cache's own
discipline, no locks).
"""

from __future__ import annotations

import json
import math
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.ops.quantize import quantize_rows

INDEX_MANIFEST = "neighbors.json"


class IndexShard:
    """One device-shard's arrays (numpy at build/load; the engine moves
    them on-device once and drops the host copies)."""

    def __init__(self, shard_id: int, n: int, vectors, c2, ids,
                 row_scales=None, centroids=None, clustered=None,
                 c_scales=None, c_c2=None, c_ids=None, refine=None):
        self.shard_id = int(shard_id)
        self.n = int(n)                      # real (non-padding) rows
        self.vectors = vectors               # [R, D] f32 | int8
        self.c2 = c2                         # [R] f32, +inf padding
        self.ids = ids                       # [R] int32, -1 padding
        self.row_scales = row_scales         # [R] f32 (int8 arm)
        self.centroids = centroids           # [K, D] f32 (IVF)
        self.clustered = clustered           # [K, M, D] (IVF)
        self.c_scales = c_scales             # [K, M] f32 (IVF int8)
        self.c_c2 = c_c2                     # [K, M] f32, +inf padding
        self.c_ids = c_ids                   # [K, M] int32, -1 padding
        # int8 arm only: the original f32 rows [n, D], HOST-resident
        # for the exact rescore of the device's int8 candidates —
        # never moved to the accelerator, so the 4x HBM density of the
        # int8 shard is kept while recall is recovered by refining a
        # 2k-deep candidate list against full precision
        self.refine = refine

    @property
    def has_ivf(self) -> bool:
        return self.centroids is not None


def _balanced_assign(x: np.ndarray, centroids: np.ndarray,
                     cap: int) -> List[np.ndarray]:
    """Capacity-balanced cluster assignment: rows claim centroids in
    preference order (nearest first) until one has free capacity.
    Greedy order is by each row's best distance, so contended clusters
    keep their closest members and spill their fringe. Returns the row
    indices per cluster (each ≤ cap; total == len(x)).

    The JAX package's assignment, computed with less work: the distances
    are its chunked numpy expression, kept whole; a row whose nearest
    cluster has room takes it (the first entry of its stable preference
    order is its stable ``argmin``), and only a row that spills sorts its
    full preference order. Same arrays, same memberships."""
    k = centroids.shape[0]
    n = x.shape[0]
    # chunked [N, K] distances, the JAX package's expression chunk by
    # chunk (the same bits), kept for the rows that spill
    d2 = np.empty((n, k), np.float32)
    for lo in range(0, n, 65536):
        hi = min(lo + 65536, n)
        d2[lo:hi] = (np.sum(x[lo:hi] ** 2, axis=1, keepdims=True)
                     - 2.0 * (x[lo:hi] @ centroids.T)
                     + np.sum(centroids ** 2, axis=1)[None, :])
    first = np.argmin(d2, axis=1)
    best = d2[np.arange(n), first]
    members: List[List[int]] = [[] for _ in range(k)]
    free = [cap] * k
    first_l = first.tolist()
    for row in np.argsort(best, kind="stable").tolist():
        c = first_l[row]
        if free[c] > 0:
            members[c].append(row)
            free[c] -= 1
            continue
        for c in np.argsort(d2[row], kind="stable").tolist():
            if free[c] > 0:
                members[c].append(row)
                free[c] -= 1
                break
        else:                                # cap·K ≥ N by construction
            raise AssertionError("balanced assignment ran out of "
                                 "capacity; alpha too small")
    return [np.asarray(m, np.int64) for m in members]


def _fit_centroids(x: np.ndarray, k: int, seed: int,
                   max_iterations: int, sample: int,
                   device=None) -> np.ndarray:
    """K-means centroids on a seeded subsample (Lloyd over the full
    shard buys nothing for routing quality once the sample covers the
    density; the subsample bounds build time on 1M-row shards)."""
    from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
    if x.shape[0] > sample:
        rng = np.random.default_rng(seed)
        x = x[rng.choice(x.shape[0], sample, replace=False)]
    km = KMeansClustering(k, max_iterations=max_iterations, seed=seed,
                          device=device)
    km.fit(x)
    return np.asarray(km.cluster_centers_, np.float32)


class ShardedCorpusIndex:
    """The built (or loaded) index: shard list + geometry metadata."""

    def __init__(self, shards: List[IndexShard], *, dim: int,
                 shard_rows: int, precision: str, n_total: int,
                 version: str = "v1",
                 ivf: Optional[Dict[str, int]] = None, seed: int = 0,
                 all_shard_ids: Optional[List[int]] = None):
        self.shards = shards
        self.dim = int(dim)
        self.shard_rows = int(shard_rows)
        self.precision = precision
        self.n_total = int(n_total)
        self.version = str(version)
        self.ivf = dict(ivf) if ivf else None   # {"clusters", "cap"}
        self.seed = int(seed)
        # the PUBLISHED index's full shard universe (a node loading a
        # slice still gossips how many shards exist cluster-wide)
        self.all_shard_ids = (list(all_shard_ids)
                              if all_shard_ids is not None
                              else [s.shard_id for s in shards])

    # ---- construction ----------------------------------------------------
    @classmethod
    def build(cls, corpus: np.ndarray, *, shard_rows: int = 262144,
              precision: str = "f32", ivf_clusters: int = 0,
              ivf_alpha: float = 1.25, nprobe_hint: int = 8,
              kmeans_iterations: int = 20, kmeans_sample: int = 65536,
              version: str = "v1", seed: int = 0, device=None
              ) -> "ShardedCorpusIndex":
        """Build from a host corpus [N, D], one thread a shard. ``device``
        is where the IVF k-means runs (the card unless ``"cpu"``); the
        rest is numpy. The arrays are the JAX package's, shard for
        shard."""
        if precision not in ("f32", "int8"):
            raise ValueError(f"precision must be f32|int8, "
                             f"got {precision!r}")
        corpus = np.ascontiguousarray(corpus, np.float32)
        n, dim = corpus.shape
        if n == 0:
            raise ValueError("empty corpus")
        shard_rows = min(int(shard_rows), _next_pow2(n))
        n_shards = max(1, math.ceil(n / shard_rows))
        ivf_meta = None
        if ivf_clusters:
            k = int(ivf_clusters)
            cap = math.ceil(ivf_alpha * shard_rows / k)
            ivf_meta = {"clusters": k, "cap": cap,
                        "nprobe_hint": int(nprobe_hint)}
        if ivf_meta is not None:
            from deeplearning4j_tpu_torch.utils.device import resolve_device
            device = resolve_device(device)

        def shard(s):
            return cls._build_shard(
                s, corpus[s * shard_rows:(s + 1) * shard_rows],
                s * shard_rows, shard_rows, precision, ivf_meta,
                kmeans_iterations, kmeans_sample, seed, device)
        # shards are independent (each seeds its own k-means), and the
        # build's numpy releases the interpreter lock: one thread a shard
        with ThreadPoolExecutor(
                max_workers=min(n_shards, os.cpu_count() or 1)) as pool:
            shards = list(pool.map(shard, range(n_shards)))
        return cls(shards, dim=dim, shard_rows=shard_rows,
                   precision=precision, n_total=n, version=version,
                   ivf=ivf_meta, seed=seed)

    @staticmethod
    def _build_shard(shard_id: int, rows: np.ndarray, base: int,
                     shard_rows: int, precision: str,
                     ivf: Optional[Dict[str, int]],
                     kmeans_iterations: int, kmeans_sample: int,
                     seed: int, device=None) -> IndexShard:
        n, dim = rows.shape
        ids = np.full(shard_rows, -1, np.int32)
        ids[:n] = np.arange(base, base + n, dtype=np.int32)
        if precision == "int8":
            q, scales = quantize_rows(rows)
            deq = q.astype(np.float32) * scales[:, None]
            vectors = np.zeros((shard_rows, dim), np.int8)
            vectors[:n] = q
            row_scales = np.ones(shard_rows, np.float32)
            row_scales[:n] = scales
            real_c2 = np.sum(deq * deq, axis=1)
        else:
            vectors = np.zeros((shard_rows, dim), np.float32)
            vectors[:n] = rows
            row_scales = None
            real_c2 = np.sum(rows * rows, axis=1)
        c2 = np.full(shard_rows, np.inf, np.float32)
        c2[:n] = real_c2
        shard = IndexShard(shard_id, n, vectors, c2, ids,
                           row_scales=row_scales,
                           refine=(np.ascontiguousarray(
                               rows, np.float32)
                               if precision == "int8" else None))
        if ivf is not None:
            k, cap = ivf["clusters"], ivf["cap"]
            centroids = _fit_centroids(
                rows, min(k, max(1, n)), seed + shard_id,
                kmeans_iterations, kmeans_sample, device)
            if centroids.shape[0] < k:       # degenerate small shard
                pad = np.zeros((k - centroids.shape[0], dim),
                               np.float32)
                centroids = np.concatenate([centroids, pad])
            members = _balanced_assign(rows, centroids, cap)
            cl_shape = (k, cap, dim)
            clustered = np.zeros(
                cl_shape, np.int8 if precision == "int8"
                else np.float32)
            c_scales = np.ones((k, cap), np.float32) \
                if precision == "int8" else None
            c_c2 = np.full((k, cap), np.inf, np.float32)
            c_ids = np.full((k, cap), -1, np.int32)
            for c, m in enumerate(members):
                t = len(m)
                if t == 0:
                    continue
                clustered[c, :t] = vectors[m]
                c_c2[c, :t] = c2[m]
                c_ids[c, :t] = ids[m]
                if c_scales is not None:
                    c_scales[c, :t] = row_scales[m]
            shard.centroids = centroids
            shard.clustered = clustered
            shard.c_scales = c_scales
            shard.c_c2 = c_c2
            shard.c_ids = c_ids
        return shard

    # ---- persistence -----------------------------------------------------
    def save(self, store, key: str) -> str:
        """Persist under the store's bucket layout and publish by
        flipping the manifest LAST (atomic tmp+rename). Returns the
        manifest path."""
        d = store.cache_dir(key)
        entries = []
        for sh in self.shards:
            fname = f"nn-{self.version}-shard{sh.shard_id}.npz"
            arrays = {"vectors": sh.vectors, "c2": sh.c2,
                      "ids": sh.ids}
            for attr in ("row_scales", "centroids", "clustered",
                         "c_scales", "c_c2", "c_ids", "refine"):
                v = getattr(sh, attr)
                if v is not None:
                    arrays[attr] = v
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, os.path.join(d, fname))
            entries.append({"id": sh.shard_id, "file": fname,
                            "n": sh.n})
        manifest = {"version": self.version, "dim": self.dim,
                    "shard_rows": self.shard_rows,
                    "precision": self.precision,
                    "n_total": self.n_total, "seed": self.seed,
                    "ivf": self.ivf, "shards": entries}
        path = os.path.join(d, INDEX_MANIFEST)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, store, key: str, *,
             shard_ids: Optional[List[int]] = None
             ) -> "ShardedCorpusIndex":
        """Load the published version; ``shard_ids`` restricts to this
        node's assigned shards (the scatter-gather placement)."""
        d = store.cache_dir(key)
        path = os.path.join(d, INDEX_MANIFEST)
        try:
            with open(path) as f:
                m = json.load(f)
        except (OSError, json.JSONDecodeError):
            raise FileNotFoundError(
                f"no published neighbors index under {d!r}")
        shards = []
        for e in m["shards"]:
            if shard_ids is not None and e["id"] not in shard_ids:
                continue
            with np.load(os.path.join(d, e["file"])) as z:
                a: Dict[str, Any] = {k: z[k] for k in z.files}
            shards.append(IndexShard(
                e["id"], e["n"], a["vectors"], a["c2"], a["ids"],
                row_scales=a.get("row_scales"),
                centroids=a.get("centroids"),
                clustered=a.get("clustered"),
                c_scales=a.get("c_scales"), c_c2=a.get("c_c2"),
                c_ids=a.get("c_ids"), refine=a.get("refine")))
        if not shards:
            raise ValueError(
                f"no shards matched {shard_ids!r} in index {key!r} "
                f"(have {[e['id'] for e in m['shards']]})")
        return cls(shards, dim=m["dim"], shard_rows=m["shard_rows"],
                   precision=m["precision"], n_total=m["n_total"],
                   version=m["version"], ivf=m.get("ivf"),
                   seed=m.get("seed", 0),
                   all_shard_ids=[e["id"] for e in m["shards"]])

    @staticmethod
    def published_version(store, key: str) -> Optional[str]:
        d = store.cache_dir(key)
        try:
            with open(os.path.join(d, INDEX_MANIFEST)) as f:
                return json.load(f).get("version")
        except (OSError, json.JSONDecodeError):
            return None

    # ---- geometry --------------------------------------------------------
    def geometry(self) -> Dict[str, Any]:
        """The compile-relevant shape signature: two indexes with equal
        geometry dispatch through the same executables, which is what
        hot promotion checks before swapping."""
        return {"dim": self.dim, "shard_rows": self.shard_rows,
                "precision": self.precision,
                "ivf": {k: self.ivf[k] for k in ("clusters", "cap")}
                if self.ivf else None}

    @property
    def shard_ids(self) -> List[int]:
        return [s.shard_id for s in self.shards]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p
