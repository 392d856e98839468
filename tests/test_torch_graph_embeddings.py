"""The port's graph embeddings (``graph/``) against the JAX package's:
the walks bitwise, DeepWalk and Node2Vec fits (hierarchical softmax over
the port's ``SequenceVectors``) within 1e-4 of each table's largest
entry, and ``GraphVectors`` files both ways."""

import numpy as np
import pytest

from deeplearning4j_tpu import graph as jg
from deeplearning4j_tpu_torch import graph as tg

FIT_TOL = 1e-4


def _edges(n=24):
    rng = np.random.default_rng(4)
    ring = [(i, (i + 1) % n) for i in range(n)]
    chords = [tuple(int(v) for v in rng.choice(n, 2, replace=False))
              for _ in range(n // 2)]
    return ring + chords


def _graphs(n=24, weighted=False):
    edges = _edges(n)
    out = []
    for mod in (jg, tg):
        g = mod.Graph(n)
        for i, (a, b) in enumerate(edges):
            g.add_edge(a, b, 1.0 + (i % 3) if weighted else 1.0)
        out.append(g)
    return out


@pytest.mark.parametrize("kind", ["uniform", "weighted", "node2vec"])
def test_walks_match_jax(kind):
    jgr, tgr = _graphs(weighted=kind == "weighted")
    if kind == "node2vec":
        ref = jg.Node2VecWalkIterator(jgr, 12, p=0.5, q=2.0, seed=3,
                                      walks_per_vertex=2)
        got = tg.Node2VecWalkIterator(tgr, 12, p=0.5, q=2.0, seed=3,
                                      walks_per_vertex=2)
    else:
        cls = "WeightedRandomWalkIterator" if kind == "weighted" else \
            "RandomWalkIterator"
        ref = getattr(jg, cls)(jgr, 12, seed=3, walks_per_vertex=2)
        got = getattr(tg, cls)(tgr, 12, seed=3, walks_per_vertex=2)
    assert list(got) == list(ref)


def _close(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= FIT_TOL * np.abs(ref).max()


@pytest.mark.parametrize("model", ["DeepWalk", "Node2Vec"])
def test_graph_embedding_fit_matches_jax(model):
    jgr, tgr = _graphs()
    kw = dict(vector_size=16, window_size=3, walk_length=10, seed=2,
              epochs=3, batch_size=64, pairgen="numpy")
    ref = getattr(jg, model)(**kw)
    ref.fit(jgr)
    got = getattr(tg, model)(device="cpu", **kw)
    got.fit(tgr)
    _close(got.syn0, ref.syn0)
    _close(got.syn1, ref.syn1)
    assert got.vertices_nearest(0, 5) == ref.vertices_nearest(0, 5)


def test_graph_vectors_files_both_ways(tmp_path):
    _jgr, tgr = _graphs()
    dw = tg.DeepWalk(vector_size=8, window_size=2, walk_length=8, seed=1,
                     device="cpu")
    dw.fit(tgr)
    gv = tg.GraphVectors.from_deepwalk(dw)
    assert gv.num_vertices() == 24
    p = str(tmp_path / "gv")
    gv.save(p)
    back = jg.GraphVectors.load(p)
    assert np.array_equal(back._vectors, gv._vectors)
    assert back.vertices_nearest(3, 4) == gv.vertices_nearest(3, 4)
    assert tg.GraphVectors.load(p).similarity(1, 2) == gv.similarity(1, 2)
