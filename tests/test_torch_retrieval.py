"""The port's retrieval tier (``retrieval/``, ``parallel/fleet.py``'s
retrieval pools, ``ui/neighbors_module.py``, ``clustering/server.py`` and
``serve --neighbors-index``) on the CPU, against the JAX package at small
sizes: a blob corpus of 3000 x 32, shards of 1024, 16 IVF clusters.

The contract under test:

- index build: shards, norms, ids, int8 rows and scales and the refine
  rows bitwise the JAX package's, IVF centroids within 1e-5 (the Lloyd
  step is torch's sum against XLA's); an index saved by either package
  loads in the other, array for array;
- the four search functions and the engine's brute and IVF search in
  f32 and int8 give the JAX package's ids, distances within rel 1e-5 of
  the expanded form's terms |q|² + |c|² (``assert_d2_close``: the form
  cancels for near neighbours, so the ulp of |q|² that two summation
  orders differ by is far above 1e-5 of d² itself); the int8 engine's
  distances are the host's exact f32 rescore, bitwise;
  on a tie-heavy integer corpus the ids come in ``lax.top_k``'s order;
- ``merge_topk`` is the JAX function; padding never surfaces; the
  recall gates hold (recall@10 >= 0.95 for int8, IVF and IVF-int8);
- zero live compiles after ``warmup()`` (a cell's first dispatch after
  it, or a signature drift, fails ``assert_warm``); ``refresh``'s
  geometry and self-recall gates;
- the fleet's retrieval pool sheds (queue, deadline); the
  ``/api/neighbors*`` routes answer 200/400/404/503 + Retry-After/504;
- the scatter-gather dispatcher: bitwise the single engine when full,
  ``partial: true`` with a node down, replica retry, the
  ``neighbors.fanout`` chaos site; the ``/knn`` shim's contract;
- the serve CLI's ``--neighbors-*`` flags, ``--join`` for an index, and
  the guard that refuses an artifact store holding a tuned config.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
from deeplearning4j_tpu_torch.parallel.node import NodeRegistry
from deeplearning4j_tpu_torch.retrieval import kernels as tk
from deeplearning4j_tpu_torch.retrieval.engine import (RetrievalEngine,
                                                       merge_topk)
from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex

REL = 1e-5


def assert_d2_close(got, want, q, c2):
    """Distances within REL of the expanded form's terms: ``d² = |q|² -
    2q·c + |c|²`` cancels when a neighbour is close, so one ulp of |q|²
    in another summation order (XLA's fused multiply-add chain against
    torch's vector sum) is far more than REL of d² itself. ``c2`` are
    the answered rows' norms [B, k]."""
    q2 = np.sum(np.asarray(q, np.float64) ** 2, axis=1, keepdims=True)
    scale = q2 + np.abs(np.asarray(c2, np.float64))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want,
                                                           np.float64))
    assert (err <= REL * scale).all(), float((err / scale).max())


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = ("vectors", "c2", "ids", "row_scales", "centroids", "clustered",
          "c_scales", "c_c2", "c_ids", "refine")


def blob_corpus(n, dim, k_blobs, seed=0, spread=0.15):
    """The JAX package's ``benchmarks/neighbors.py`` corpus (a copy)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k_blobs, dim)).astype(np.float32) * 3.0
    assign = rng.integers(k_blobs, size=n)
    pts = centers[assign] + \
        rng.normal(size=(n, dim)).astype(np.float32) * spread
    return pts.astype(np.float32)


def _exact_topk(corpus, queries, k):
    d2 = ((queries[:, None, :].astype(np.float64)
           - corpus[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, order, axis=1), order


def _recall(found_ids, oracle_ids):
    hits = sum(len(set(f.tolist()) & set(o.tolist()))
               for f, o in zip(found_ids, oracle_ids))
    return hits / oracle_ids.size


def _post(url, body, headers=None, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _engine(index, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return RetrievalEngine(index, device="cpu", **kw)


@pytest.fixture(scope="module")
def corpus():
    return blob_corpus(3000, 32, 24, seed=0)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(1)
    return (corpus[rng.integers(len(corpus), size=24)]
            + rng.normal(size=(24, 32)).astype(np.float32) * 0.05)


@pytest.fixture(scope="module")
def built(corpus):
    """(JAX index, port index) per precision, both IVF, same seed."""
    from deeplearning4j_tpu.retrieval.index import (
        ShardedCorpusIndex as JaxIndex)
    kw = dict(shard_rows=1024, ivf_clusters=16, nprobe_hint=4, seed=3)
    return {p: (JaxIndex.build(corpus, precision=p, **kw),
                ShardedCorpusIndex.build(corpus, precision=p,
                                         device="cpu", **kw))
            for p in ("f32", "int8")}


@pytest.fixture(scope="module")
def jax_store(built, tmp_path_factory):
    """The JAX-built indexes saved by the JAX package."""
    from deeplearning4j_tpu.parallel.aot_cache import (
        ArtifactStore as JaxStore)
    root = str(tmp_path_factory.mktemp("jax_store"))
    store = JaxStore(root)
    for p, (jidx, _) in built.items():
        jidx.save(store, f"idx-{p}")
    return root


# ---- index ------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_index_build_matches_jax(built, precision):
    jidx, tidx = built[precision]
    assert tidx.geometry() == jidx.geometry()
    assert tidx.shard_ids == jidx.shard_ids == [0, 1, 2]
    for js, ts in zip(jidx.shards, tidx.shards):
        assert ts.n == js.n
        for name in ("vectors", "c2", "ids", "row_scales", "refine"):
            a, b = getattr(ts, name), getattr(js, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                    name
        np.testing.assert_allclose(ts.centroids, js.centroids,
                                   rtol=1e-5, atol=1e-5)


def test_balanced_assign_is_the_jax_assignment(corpus):
    from deeplearning4j_tpu.retrieval.index import (
        _balanced_assign as jax_assign)
    from deeplearning4j_tpu_torch.retrieval.index import _balanced_assign
    rng = np.random.default_rng(5)
    x = corpus[:1000]
    cents = x[rng.choice(1000, 16, replace=False)]
    for cap in (63, 80, 200):                # tight, default-like, loose
        got = _balanced_assign(x, cents, cap)
        want = jax_assign(x, cents, cap)
        assert len(got) == len(want) == 16
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_jax_saved_index_loads_in_the_port_and_back(
        built, jax_store, tmp_path, precision):
    from deeplearning4j_tpu.parallel.aot_cache import (
        ArtifactStore as JaxStore)
    from deeplearning4j_tpu.retrieval.index import (
        ShardedCorpusIndex as JaxIndex)
    jidx, tidx = built[precision]
    key = f"idx-{precision}"
    back = ShardedCorpusIndex.load(ArtifactStore(jax_store), key)
    assert back.geometry() == jidx.geometry()
    assert back.all_shard_ids == [0, 1, 2] and back.n_total == 3000
    # the port saves what it loaded; the JAX package reads it back
    tidx.save(ArtifactStore(str(tmp_path)), key)
    jback = JaxIndex.load(JaxStore(str(tmp_path)), key, shard_ids=[1])
    assert jback.shard_ids == [1] and jback.all_shard_ids == [0, 1, 2]
    for a, b in ((back.shards[1], jidx.shards[1]),
                 (jback.shards[0], tidx.shards[1])):
        for name in ARRAYS:
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    with open(os.path.join(jax_store, "objects", key,
                           "neighbors.json")) as f:
        jm = json.load(f)
    with open(os.path.join(str(tmp_path), "objects", key,
                           "neighbors.json")) as f:
        tm = json.load(f)
    assert set(jm) == set(tm)
    assert {k: jm[k] for k in jm if k != "ivf"} == \
        {k: tm[k] for k in tm if k != "ivf"}


# ---- the four search functions -------------------------------------------------

def _shard_args(sh, fn):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return {"brute_topk_f32": (sh.vectors, sh.c2, sh.ids),
            "brute_topk_int8": (sh.vectors, sh.row_scales, sh.c2, sh.ids),
            "ivf_topk_f32": (sh.centroids, sh.clustered, sh.c_c2,
                             sh.c_ids),
            "ivf_topk_int8": (sh.centroids, sh.clustered, sh.c_scales,
                              sh.c_c2, sh.c_ids)}[fn], t


@pytest.mark.parametrize("fn", ["brute_topk_f32", "brute_topk_int8",
                                "ivf_topk_f32", "ivf_topk_int8"])
def test_search_function_matches_jax(built, queries, fn):
    from deeplearning4j_tpu.retrieval import kernels as jk
    sh = built["int8" if fn.endswith("int8") else "f32"][0].shards[1]
    args, t = _shard_args(sh, fn)
    extra = (4,) if fn.startswith("ivf") else ()
    jd, ji = getattr(jk, fn)(queries, *args, 10, *extra)
    td, ti = getattr(tk, fn)(t(queries), *map(t, args), 10, *extra)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    norms = np.concatenate([s.c2 for s in built["f32"][0].shards])
    assert_d2_close(td.numpy(), np.asarray(jd), queries,
                    norms[np.asarray(ji)])


def test_quantize_queries_matches_jax(queries):
    from deeplearning4j_tpu.retrieval import kernels as jk
    q = np.concatenate([queries, np.zeros((1, 32), np.float32),
                        np.full((1, 32), 0.5, np.float32)])
    jq, js = jk._quantize_queries(q)
    tq, ts = tk._quantize_queries(torch.from_numpy(q))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


@pytest.mark.parametrize("fn", ["brute_topk_f32", "ivf_topk_f32",
                                "brute_topk_int8", "ivf_topk_int8"])
def test_ties_come_in_lax_top_k_order(fn):
    """A tie-heavy integer corpus: every distance exact, many equal; the
    ids are lax.top_k's, in its order (lower position first)."""
    from deeplearning4j_tpu.retrieval import kernels as jk
    rng = np.random.default_rng(7)
    r, d, kc, m = 512, 4, 8, 64
    c = rng.integers(-2, 3, size=(r, d)).astype(np.float32)
    q = rng.integers(-2, 3, size=(16, d)).astype(np.float32)
    ids = np.arange(r, dtype=np.int32)
    c2 = np.sum(c * c, axis=1)
    cl = c.reshape(kc, m, d)
    cents = cl.mean(axis=1).round()
    c_ids = ids.reshape(kc, m)
    if fn.endswith("int8"):
        # integer rows with unit scales: the int8 arm's arithmetic is
        # exact here too (q rows scale by 2/127, every product exact)
        args = {"brute_topk_int8": (c.astype(np.int8),
                                    np.ones(r, np.float32), c2, ids),
                "ivf_topk_int8": (cents, cl.astype(np.int8),
                                  np.ones((kc, m), np.float32),
                                  c2.reshape(kc, m), c_ids)}[fn]
    else:
        args = {"brute_topk_f32": (c, c2, ids),
                "ivf_topk_f32": (cents, cl, c2.reshape(kc, m),
                                 c_ids)}[fn]
    extra = (5,) if fn.startswith("ivf") else ()
    for k in (10, 40):
        jd, ji = getattr(jk, fn)(q, *args, k, *extra)
        td, ti = getattr(tk, fn)(*map(torch.from_numpy, (q, *args)), k,
                                 *extra)
        assert np.array_equal(ti.numpy(), np.asarray(ji)), (fn, k)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=REL)
    # the distances really tie: at least one row has equal neighbours
    assert (np.diff(td.numpy(), axis=1) == 0).any()


def test_topk_smallest_orders_zeros_and_padding():
    d = torch.tensor([[0.0, -0.0, float("inf"), -1.0, 0.0, float("inf")]])
    v, p = tk.topk_smallest(d, 6)
    assert p.tolist() == [[3, 0, 1, 4, 2, 5]]
    assert v[0, :4].tolist() == [-1.0, 0.0, 0.0, 0.0]


# ---- the engine against the JAX engine ------------------------------------------

@pytest.mark.parametrize("precision,mode", [("f32", "brute"),
                                            ("f32", "ivf"),
                                            ("int8", "brute"),
                                            ("int8", "ivf")])
def test_engine_search_matches_jax(jax_store, corpus, queries, precision,
                                   mode):
    from deeplearning4j_tpu.observe.registry import MetricsRegistry as JM
    from deeplearning4j_tpu.parallel.aot_cache import (
        ArtifactStore as JaxStore)
    from deeplearning4j_tpu.retrieval.engine import (
        RetrievalEngine as JaxEngine)
    from deeplearning4j_tpu.retrieval.index import (
        ShardedCorpusIndex as JaxIndex)
    key = f"idx-{precision}"
    jeng = JaxEngine(JaxIndex.load(JaxStore(jax_store), key),
                     k_ladder=(10, 40), max_batch=16, registry=JM())
    teng = _engine(ShardedCorpusIndex.load(ArtifactStore(jax_store), key),
                   k_ladder=(10, 40), max_batch=16).warmup()
    norms = np.sum(corpus.astype(np.float64) ** 2, axis=1)
    for rows, k in ((queries[:1], 3), (queries, 10)):
        jd, ji = jeng.search(rows, k, mode=mode)
        td, ti = teng.search(rows, k, mode=mode)
        assert np.array_equal(ti, np.asarray(ji))
        assert_d2_close(td, jd, rows, norms[ti])
    teng.assert_warm()
    assert teng.stats()["refine"] is (precision == "int8")


# ---- merge ---------------------------------------------------------------------

def test_merge_topk_matches_jax():
    from deeplearning4j_tpu.retrieval.engine import merge_topk as jmerge
    rng = np.random.default_rng(9)
    d = rng.integers(0, 6, size=(3, 5, 8)).astype(np.float32)
    i = rng.permutation(3 * 5 * 8).reshape(3, 5, 8).astype(np.int32)
    d[0, :, 6:] = np.inf
    i[0, :, 6:] = -1
    for k in (1, 8, 24):
        a, b = merge_topk(d, i, k), jmerge(d, i, k)
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()


def test_merge_topk_padding_never_surfaces():
    d = np.array([[[0.5, np.inf, np.inf]]], np.float32)
    i = np.array([[[7, -1, -1]]], np.int32)
    md, mi = merge_topk(d, i, 3)
    assert mi[0, 0] == 7 and (mi[0, 1:] == -1).all()
    assert md[0, 0] == pytest.approx(0.5)
    assert np.isinf(md[0, 1:]).all()


def test_merge_is_shard_layout_invariant(corpus):
    q = corpus[:6] + 1e-4
    answers = []
    for rows in (256, 512, 4096):
        eng = _engine(ShardedCorpusIndex.build(corpus, shard_rows=rows),
                      k_ladder=(10,), max_batch=8).warmup()
        answers.append(eng.search(q, 10)[1])
    assert (answers[0] == answers[1]).all()
    assert (answers[0] == answers[2]).all()


def test_exact_against_a_float64_oracle(corpus, queries):
    eng = _engine(ShardedCorpusIndex.build(corpus, shard_rows=1024),
                  k_ladder=(10,), max_batch=32).warmup()
    d, i = eng.search(queries, 10)
    od, oi = _exact_topk(corpus, queries, 10)
    assert (i == oi).all()
    np.testing.assert_allclose(d, od, rtol=1e-4, atol=1e-3)


# ---- recall gates -----------------------------------------------------------------

@pytest.fixture(scope="module")
def gate_corpus():
    return blob_corpus(8192, 32, 64, seed=7)


@pytest.mark.parametrize("precision,ivf", [("int8", 0), ("f32", 64),
                                           ("int8", 64)])
def test_recall_gate(gate_corpus, precision, ivf):
    rng = np.random.default_rng(11)
    probes = gate_corpus[rng.integers(len(gate_corpus), size=64)] + \
        rng.normal(size=(64, 32)).astype(np.float32) * 0.05
    idx = ShardedCorpusIndex.build(
        gate_corpus, shard_rows=4096, precision=precision,
        ivf_clusters=ivf, nprobe_hint=8, seed=0, device="cpu")
    eng = _engine(idx, k_ladder=(10, 40), max_batch=64).warmup()
    _, ids = eng.search(probes, 10)
    _, oracle = _exact_topk(gate_corpus, probes, 10)
    r = _recall(ids, oracle)
    assert r >= 0.95, f"{precision} ivf={ivf} recall@10 {r:.3f} < 0.95"


# ---- warmup, ladders, refresh ----------------------------------------------------

def test_zero_recompiles_after_warmup_and_what_counts(corpus):
    idx = ShardedCorpusIndex.build(corpus[:2048], shard_rows=1024,
                                   precision="int8", ivf_clusters=16,
                                   device="cpu")
    eng = _engine(idx, k_ladder=(1, 10), max_batch=16)
    eng.search(corpus[:2], 1)            # before warmup: not live
    eng.warmup()
    rng = np.random.default_rng(0)
    for b, k, mode in [(1, 1, None), (3, 5, "brute"), (16, 10, "ivf"),
                       (7, 10, None), (16, 2, "brute"), (40, 10, "ivf")]:
        eng.search(rng.normal(size=(b, 32)).astype(np.float32), k,
                   mode=mode)
    assert eng.recompiles_after_warmup == 0
    eng.assert_warm()
    # a cell first dispatched after warmup is a live compile
    eng._dispatch(torch.zeros((3, 32)), eng._shards[0], 10, "brute")
    assert eng.recompiles_after_warmup == 1
    with pytest.raises(AssertionError, match="1 recompile"):
        eng.assert_warm()
    # a drifted signature of a warmed cell counts too
    eng.watchdog.observe("nn.brute.int8.b1.k1",
                         torch.zeros((1, 32), dtype=torch.float64), 1)
    assert eng.recompiles_after_warmup == 2


def test_k_above_ladder_and_bad_queries_rejected(corpus):
    eng = _engine(ShardedCorpusIndex.build(corpus[:256], shard_rows=256),
                  k_ladder=(10,), max_batch=4).warmup()
    with pytest.raises(ValueError, match="above the warmed ladder"):
        eng.search(corpus[:2], 50)
    with pytest.raises(ValueError, match="queries must be"):
        eng.search(np.zeros((2, 7), np.float32), 5)
    with pytest.raises(ValueError, match="mode"):
        eng.search(corpus[:2], 5, mode="ivf")


def test_engine_needs_the_card_unless_cpu(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = ShardedCorpusIndex.build(corpus[:64], shard_rows=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalEngine(idx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedCorpusIndex.build(corpus[:64], shard_rows=64,
                                 ivf_clusters=4)


def test_single_query_and_stats(corpus):
    eng = _engine(ShardedCorpusIndex.build(corpus[:256], shard_rows=128),
                  k_ladder=(10,), max_batch=4).warmup()
    d, i = eng.search(corpus[5], 3)
    assert i.shape == (3,) and int(i[0]) == 5
    st = eng.stats()
    assert st["warm"] and st["recompiles_after_warmup"] == 0
    assert st["vectors_total"] == 256 and st["device"] == "cpu"
    # two shards of 128 x 32 f32 rows, norms and ids
    assert st["resident_bytes"] == 2 * 128 * (32 * 4 + 4 + 4)
    assert st["latency_ms"]["p50"] > 0


def test_refresh_gates(corpus, tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    c1 = corpus[:1024]
    ShardedCorpusIndex.build(c1, shard_rows=512, version="v1").save(
        store, "ref")
    eng = _engine(ShardedCorpusIndex.load(store, "ref"), k_ladder=(10,),
                  max_batch=8).warmup()
    out = eng.refresh(store, "ref")
    assert out["promoted"] is False and out["reason"] == "same version"
    c2 = blob_corpus(1024, 32, 8, seed=13)
    ShardedCorpusIndex.build(c2, shard_rows=512, version="v2").save(
        store, "ref")
    out = eng.refresh(store, "ref")
    assert out["promoted"] is True and out["version"] == "v2"
    _, i = eng.search(c2[:4] + 1e-4, 10)
    assert (i[:, 0] == np.arange(4)).all()
    assert eng.recompiles_after_warmup == 0
    ShardedCorpusIndex.build(c2, shard_rows=256, version="v3").save(
        store, "ref")
    out = eng.refresh(store, "ref")
    assert out["promoted"] is False and "geometry" in out["reason"]
    # an IVF candidate whose routing cannot hold the self-recall gate
    ivf_kw = dict(shard_rows=512, ivf_clusters=16, nprobe_hint=1,
                  device="cpu")
    eng2 = _engine(ShardedCorpusIndex.build(c1, version="w1", **ivf_kw),
                   k_ladder=(10,), max_batch=8).warmup()
    noise = np.random.default_rng(2).normal(size=(1024, 32)).astype(
        np.float32)
    ShardedCorpusIndex.build(noise, version="w2", **ivf_kw).save(
        store, "ivf")
    out = eng2.refresh(store, "ivf")
    assert out["promoted"] is False and "recall@10" in out["reason"]
    assert eng2.version == "w1"


# ---- fleet pool and HTTP ----------------------------------------------------------

def test_router_pool_admission_and_shed(corpus):
    from deeplearning4j_tpu_torch.parallel.deadline import Deadline
    from deeplearning4j_tpu_torch.parallel.fleet import (FleetRouter,
                                                         ShedError)
    eng = _engine(ShardedCorpusIndex.build(corpus[:256], shard_rows=256),
                  k_ladder=(10,), max_batch=4).warmup()
    router = FleetRouter(registry=MetricsRegistry(), session_id="t-nn",
                         max_pending=1)
    pool = router.add_retrieval_pool("neighbors", eng)
    with pytest.raises(ValueError, match="already exists"):
        router.add_retrieval_pool("neighbors", eng)
    d, i = router.neighbors(corpus[:3], 10)
    assert i.shape == (3, 10) and pool.pending == 0
    assert "neighbors" in router.stats()["retrieval"]
    with pytest.raises(ShedError) as ei:
        router.neighbors(corpus[:1], 10, deadline=Deadline.after_ms(-1))
    assert ei.value.reason == "deadline"
    pool.pending = 1                          # the bound is reached
    with pytest.raises(ShedError) as ei:
        router.neighbors(corpus[:1], 10)
    assert ei.value.reason == "queue"
    pool.pending = 0
    router.assert_warm()
    router.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        router.neighbors(corpus[:1], 10)


def _http_front(corpus, store=None, key=None, **router_kw):
    from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter
    from deeplearning4j_tpu_torch.ui.neighbors_module import NeighborsModule
    from deeplearning4j_tpu_torch.ui.server import UIServer
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
    idx = ShardedCorpusIndex.build(corpus[:512], shard_rows=256)
    if store is not None:
        idx.save(store, key)
        idx = ShardedCorpusIndex.load(store, key)
    from deeplearning4j_tpu_torch.observe.registry import default_registry
    metrics = default_registry()          # what /metrics renders
    eng = _engine(idx, k_ladder=(10,), max_batch=8,
                  registry=metrics).warmup()
    router = FleetRouter(session_id="t-nn-http", registry=metrics,
                         **router_kw)
    router.add_retrieval_pool("neighbors", eng)
    server = UIServer(port=0, registry=metrics)
    server.attach(InMemoryStatsStorage())
    server.register_module(NeighborsModule(router=router, store=store,
                                           index_key=key))
    server.start()
    return eng, router, server


def test_http_routes(corpus, tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    eng, router, server = _http_front(corpus, store, "h")
    u = server.url
    try:
        st, _, out = _post(u + "/api/neighbors",
                           {"vector": corpus[9].tolist(), "k": 5})
        assert st == 200 and out["ids"][0] == 9 and len(out["ids"]) == 5
        assert out["n"] == 1 and out["index_version"] == "v1"
        st, _, out = _post(u + "/api/neighbors",
                           {"queries": corpus[:3].tolist()})
        _, want = eng.search(corpus[:3], 10)
        assert st == 200 and out["ids"] == want.tolist()
        st, _, out = _post(u + "/api/neighbors/shard",
                           {"queries": corpus[:2].tolist(), "k": 5,
                            "shards": [1]})
        assert st == 200 and all(i >= 256 for i in np.ravel(out["ids"]))
        st, _, _ = _post(u + "/api/neighbors/shard",
                         {"queries": [[0.0] * 32], "k": 5,
                          "shards": [99]})
        assert st == 404
        assert _post(u + "/api/neighbors", {"bogus": 1})[0] == 400
        assert _post(u + "/api/neighbors",
                     {"vector": corpus[0].tolist(), "k": 9999})[0] == 400
        st, _, out = _post(u + "/api/neighbors",
                           {"vector": corpus[0].tolist(),
                            "deadline_ms": 1e-9})
        assert st == 504 and out["error"] == "deadline"
        st, _, out = _post(u + "/api/neighbors/refresh", {})
        assert st == 200 and out["reason"] == "same version"
        with urllib.request.urlopen(u + "/api/neighbors/stats") as r:
            stats = json.loads(r.read())
        assert stats["engine"]["recompiles_after_warmup"] == 0
        assert "neighbors" in stats["retrieval"]
        with urllib.request.urlopen(u + "/metrics") as r:
            text = r.read().decode()
        assert "dl4j_nn_queries_total" in text
    finally:
        server.stop()
        router.shutdown()


def test_http_shed_answers_503_with_retry_after(corpus):
    _, router, server = _http_front(corpus, max_pending=0)
    try:
        st, hdrs, out = _post(server.url + "/api/neighbors",
                              {"vector": corpus[0].tolist()})
        assert st == 503 and out["reason"] == "queue"
        assert int(hdrs["Retry-After"]) >= 1
        assert _post(server.url + "/api/neighbors/refresh", {})[0] == 503
    finally:
        server.stop()
        router.shutdown()


# ---- cluster scatter-gather -------------------------------------------------------

def _cluster(corpus, tmp_path, n_nodes=2, replicate=False):
    from deeplearning4j_tpu_torch.retrieval.cluster import RetrievalNode
    c = corpus[:1024]
    store = ArtifactStore(str(tmp_path / "store"))
    ShardedCorpusIndex.build(c, shard_rows=256).save(store, "c")
    reg = NodeRegistry(str(tmp_path / "reg"))
    nodes = []
    for n in range(n_nodes):
        mine = [0, 1, 2, 3] if replicate else \
            [s for s in range(4) if s % n_nodes == n]
        eng = _engine(ShardedCorpusIndex.load(store, "c", shard_ids=mine),
                      k_ladder=(10,), max_batch=8)
        nodes.append(RetrievalNode(eng, node_id=f"n{n}", registry=reg,
                                   metrics_registry=MetricsRegistry(),
                                   device="cpu"))
    return c, store, reg, nodes


def _dispatcher(reg, **kw):
    from deeplearning4j_tpu_torch.retrieval.cluster import (
        NeighborsDispatcher)
    return NeighborsDispatcher(reg, timeout_s=15.0,
                               metrics=MetricsRegistry(), **kw)


def test_full_cluster_is_bitwise_the_single_engine(corpus, tmp_path):
    c, store, reg, nodes = _cluster(corpus, tmp_path)
    disp = _dispatcher(reg)
    try:
        assert all(n.engine.stats()["warm"] for n in nodes)
        q = c[:5] + 1e-4
        out = disp.search(q, 10)
        assert out["partial"] is False
        assert out["shards_answered"] == out["shards_total"] == 4
        ref = _engine(ShardedCorpusIndex.load(store, "c"), k_ladder=(10,),
                      max_batch=8).warmup()
        rd, ri = ref.search(q, 10)
        assert out["ids"].tobytes() == ri.tobytes()
        assert out["distances"].tobytes() == rd.tobytes()
        one = disp.search(q[0], 3)
        assert one["ids"].shape == (3,)
    finally:
        disp.shutdown()
        for n in nodes:
            n.shutdown()


def test_dead_node_degrades_to_partial(corpus, tmp_path):
    from deeplearning4j_tpu_torch.retrieval.cluster import (
        PartialResultError)
    c, store, reg, nodes = _cluster(corpus, tmp_path)
    disp = _dispatcher(reg)
    try:
        nodes[1].shutdown()
        out = disp.search(c[:3], 10)
        assert out["partial"] is True
        assert 0 < out["shards_answered"] < out["shards_total"]
        assert out["ids"].shape == (3, 10)
        with pytest.raises(PartialResultError):
            disp.search(c[:3], 10, require_full=True)
    finally:
        disp.shutdown()
        for n in nodes:
            n.shutdown()


def test_replica_covers_dead_primary(corpus, tmp_path):
    c, store, reg, nodes = _cluster(corpus, tmp_path, replicate=True)
    disp = _dispatcher(reg)
    try:
        nodes[0].shutdown()
        out = disp.search(c[:3], 10)
        assert out["partial"] is False
        assert out["shards_answered"] == out["shards_total"]
    finally:
        disp.shutdown()
        for n in nodes:
            n.shutdown()


@pytest.mark.parametrize("spec,replicate,partial", [
    ("seed=7;neighbors.fanout:error(arg=n0)", False, True),
    ("seed=7;neighbors.fanout:error(count=1)", True, False)])
def test_chaos_fanout(corpus, tmp_path, spec, replicate, partial):
    from deeplearning4j_tpu_torch.chaos import plan as chaosplan
    c, store, reg, nodes = _cluster(corpus, tmp_path, replicate=replicate)
    try:
        chaosplan.arm(chaosplan.parse_plan(spec,
                                           registry=MetricsRegistry()))
        disp = _dispatcher(reg)
        out = disp.search(c[:3], 10)
        assert out["partial"] is partial
        assert (out["shards_answered"] < out["shards_total"]) is partial
        disp.shutdown()
    finally:
        chaosplan.disarm()
        for n in nodes:
            n.shutdown()


def test_retrieval_node_drain_and_gossip(corpus, tmp_path):
    c, store, reg, nodes = _cluster(corpus, tmp_path, n_nodes=1,
                                    replicate=True)
    node = nodes[0]
    rec = reg.read_all()["n0"]
    assert rec["stats"]["shards"] == [0, 1, 2, 3]
    assert rec["stats"]["index_version"] == "v1"
    d, i = node.search(c[:2], 10)
    assert (i[:, 0] == [0, 1]).all()
    out = node.drain(timeout_s=10.0)
    assert out["drained"] is True
    assert node.node_id not in reg.snapshot()


# ---- the legacy /knn shim ---------------------------------------------------------

def test_knn_shim_contract_euclidean_and_cosine():
    from deeplearning4j_tpu_torch.clustering.server import (
        NearestNeighborsServer)
    from deeplearning4j_tpu_torch.clustering.vptree import VPTree
    rng = np.random.default_rng(19)
    pts = rng.normal(size=(80, 8))
    for metric in ("euclidean", "cosine"):
        srv = NearestNeighborsServer(pts, distance=metric, device="cpu")
        vt = VPTree(pts, distance=metric)
        ids, ds = srv.search(pts[7] + 1e-5, 5)
        vids, vds = vt.search(pts[7] + 1e-5, 5)
        assert ids == list(vids)
        np.testing.assert_allclose(ds, vds, atol=1e-4)
        assert srv.tree.search(pts[7] + 1e-5, 5)[0] == ids
        assert srv.tree.points is srv.points
        ids, _ = srv.search(pts[0], 500)     # k > n clamps to n
        assert len(ids) == 80
        srv.stop()
    with pytest.raises(ValueError, match="unsupported distance"):
        NearestNeighborsServer(pts, distance="manhattan", device="cpu")


def test_knn_shim_rest_contract():
    from deeplearning4j_tpu_torch.clustering.server import (
        NearestNeighborsServer)
    rng = np.random.default_rng(20)
    pts = rng.normal(size=(64, 8))
    srv = NearestNeighborsServer(pts, device="cpu").start()
    try:
        st, _, out = _post(srv.url + "/knn",
                           {"vector": pts[3].tolist(), "k": 3})
        assert st == 200 and out["results"][0]["index"] == 3
        assert len(out["results"]) == 3
        st, _, out = _post(srv.url + "/knn", {"index": 5, "k": 2})
        assert st == 200 and out["results"][0]["index"] == 5
        st, _, out = _post(srv.url + "/knn", {})
        assert st == 400 and "error" in out
    finally:
        srv.stop()


# ---- the serve CLI -----------------------------------------------------------------

def _serve(argv, **kw):
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    return cmd_serve(["serve", *argv, "--device", "cpu", "--ui-port", "0"],
                     block=False, **kw)


def test_cli_serves_a_saved_index(corpus, tmp_path, capsys):
    store_dir = str(tmp_path / "store")
    ShardedCorpusIndex.build(corpus[:1024], shard_rows=256,
                             ivf_clusters=8, nprobe_hint=2,
                             device="cpu").save(ArtifactStore(store_dir),
                                                "idx")
    router, server = _serve(["--neighbors-index", "idx",
                             "--artifact-store", store_dir,
                             "--neighbors-shards", "1,2",
                             "--neighbors-k-ladder", "5,20",
                             "--neighbors-batch", "8", "--nprobe", "3"])
    try:
        eng = router.retrieval_pool("neighbors").engine
        assert eng.shard_ids == [1, 2] and eng.all_shard_ids == [0, 1, 2, 3]
        assert eng.k_ladder == (5, 20) and eng.buckets == (1, 2, 4, 8)
        assert eng.nprobe == 3 and eng.device.type == "cpu"
        st, _, out = _post(server.url + "/api/neighbors",
                           {"queries": corpus[300:302].tolist(), "k": 4,
                            "mode": "brute"})
        assert st == 200 and out["ids"][0][0] == 300
        assert "serving index idx (1024 vectors, 2 shards)" in \
            capsys.readouterr().out
        router.assert_warm()
    finally:
        server.stop()
        router.shutdown()


def test_cli_neighbors_needs_a_store_and_refuses_a_tuned_one(tmp_path):
    """A neighbors index needs a store. A store's foreign tuned config
    (refused until tuned configs were ported) now loads as a named
    mismatch and the committed defaults serve."""
    from deeplearning4j_tpu_torch.optimize import autotune
    for argv in (["--neighbors-index", "idx"],
                 ["--neighbors-index", "idx", "--tuned-config"]):
        with pytest.raises(SystemExit, match="requires --artifact-store"):
            _serve(argv)
    store_dir = tmp_path / "store"
    tuned = store_dir / "objects" / "tuned_config"
    tuned.mkdir(parents=True)
    (tuned / "tuned.json").write_text("{}")
    try:
        front, server = _serve(
            ["--model", os.path.join(ROOT, "tests", "resources",
                                     "regression", "mlp_v1.zip"),
             "--artifact-store", str(store_dir)])
        front.shutdown()
        server.stop()
        cfg = autotune.process_tuned()
        assert (cfg.load_outcome, cfg.values) == ("mismatch", {})
        assert "'format_version'" in cfg.load_reason
        assert front.engine.batch_limit == 32
    finally:
        autotune.set_process_tuned(None)


def test_cli_store_without_tuned_config_goes_on(tmp_path):
    model = os.path.join(ROOT, "tests", "resources", "regression",
                         "mlp_v1.zip")
    front, server = _serve(["--model", model, "--artifact-store",
                            str(tmp_path / "store")])
    front.shutdown()
    server.stop()


def test_cli_parses_the_node_and_retrieval_flags():
    from deeplearning4j_tpu_torch.__main__ import _build_parser
    a = _build_parser().parse_args(["serve", "--model", "m.zip"])
    assert (a.join, a.node_id, a.model_key, a.artifact_store,
            a.neighbors_index, a.neighbors_shards, a.neighbors_k_ladder,
            a.nprobe) == (None,) * 8
    assert a.drain_timeout == 30.0 and a.neighbors_batch == 64
    a = _build_parser().parse_args(
        ["serve", "--join", "reg", "--node-id", "n1", "--drain-timeout",
         "5", "--model-key", "k", "--neighbors-index", "i", "--nprobe",
         "7"])
    assert (a.join, a.node_id, a.drain_timeout, a.model_key,
            a.neighbors_index, a.nprobe) == ("reg", "n1", 5.0, "k", "i", 7)


def test_cli_join_refuses_generate_and_inplace(tmp_path):
    model = os.path.join(ROOT, "tests", "resources", "regression",
                         "mlp_v1.zip")
    reg = str(tmp_path / "reg")
    with pytest.raises(SystemExit, match="--generate is not supported"):
        _serve(["--model", model, "--join", reg, "--generate"])
    with pytest.raises(SystemExit, match="inference-mode batched"):
        _serve(["--model", model, "--join", reg, "--inference-mode",
                "inplace"])
    assert NodeRegistry(reg).read_all() == {}


def test_cli_join_serves_an_index_and_drains_on_sigterm(corpus, tmp_path):
    store_dir = str(tmp_path / "store")
    ShardedCorpusIndex.build(corpus[:512], shard_rows=256).save(
        ArtifactStore(store_dir), "idx")
    reg_dir = str(tmp_path / "reg")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
         "--neighbors-index", "idx", "--artifact-store", store_dir,
         "--neighbors-k-ladder", "10", "--neighbors-batch", "4",
         "--join", reg_dir, "--node-id", "r1", "--ui-port", "0",
         "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        reg = NodeRegistry(reg_dir)
        deadline = time.time() + 120
        while time.time() < deadline:
            rec = reg.read_all().get("r1")
            if rec and rec.get("pid") == proc.pid:
                break
            time.sleep(0.1)
        else:
            out, _ = proc.communicate(timeout=5)
            raise AssertionError(f"node never registered:\n{out}")
        assert rec["stats"]["shards"] == [0, 1]
        disp = _dispatcher(reg)
        out = disp.search(corpus[:2], 10)
        disp.shutdown()
        assert out["partial"] is False and out["ids"][:, 0].tolist() == \
            [0, 1]
        proc.terminate()
        text, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, text
        assert "node r1 serving index idx (shards [0, 1])" in text
        assert "SIGTERM drain" in text
        assert "r1" not in reg.read_all()
    finally:
        if proc.poll() is None:
            proc.kill()


def test_committed_jax_index_is_the_tools_output(tmp_path):
    """tests/resources/retrieval is what tools/retrieval_resources.py
    writes with the JAX package (the on-card check loads it)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import retrieval_resources as rr
    finally:
        sys.path.pop(0)
    out = rr.write(tmp_path)
    committed = os.path.join(ROOT, "tests", "resources", "retrieval")
    assert np.array_equal(np.load(os.path.join(committed, "queries.npy")),
                          np.load(out / "queries.npy"))
    for key in ("small-f32", "small-int8"):
        a = ShardedCorpusIndex.load(ArtifactStore(committed), key)
        b = ShardedCorpusIndex.load(ArtifactStore(str(out)), key)
        assert a.geometry() == b.geometry() and a.n_total == b.n_total
        for sa, sb in zip(a.shards, b.shards):
            for name in ("vectors", "c2", "ids", "row_scales", "refine"):
                x, y = getattr(sa, name), getattr(sb, name)
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.tobytes() == y.tobytes(), (key, name)
            for name in ("centroids", "clustered", "c_scales", "c_c2"):
                x, y = getattr(sa, name), getattr(sb, name)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)


def test_blob_corpus_copies_are_the_benchmarks():
    """chip_smoke.py's and the tool's corpus is the JAX package's
    benchmarks/neighbors.py blob_corpus, bit for bit."""
    import chip_smoke
    from benchmarks.neighbors import blob_corpus as bench
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import retrieval_resources as rr
    finally:
        sys.path.pop(0)
    want = bench(500, 16, 8, seed=3)
    for fn in (chip_smoke.blob_corpus, rr.blob_corpus, blob_corpus):
        assert fn(500, 16, 8, seed=3).tobytes() == want.tobytes()
