"""The port's host pair generator and native library against the JAX
package's: bitwise, stream for stream.

``nlp/pairgen.py``'s counter streams (numpy against numpy, the port's
native walk against the numpy fallback), the epoch views, every superchunk
the producers hand to the device steps (SGNS shared and per-pair, HS,
CBOW, DBOW), the threshold codec and record readers of ``utils/native.py``,
the library's build directory and the ``DL4J_NATIVE=0`` switch.
"""

import os

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import pairgen as jpg
from deeplearning4j_tpu.nlp.paragraph_vectors import ParagraphVectors as JPV
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JW2V
from deeplearning4j_tpu_torch.nlp import pairgen as tpg
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import \
    ParagraphVectors as TPV
from deeplearning4j_tpu_torch.nlp.sequence_vectors import _corpus_positions
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec as TW2V
from deeplearning4j_tpu_torch.utils import native

needs_native = pytest.mark.skipif(not native.pairgen_available(),
                                  reason="no C++ compiler for the native "
                                  "pair generator")


@pytest.fixture
def rng():
    return np.random.default_rng(20)


def _corpus(rng, n=600, v=40):
    ids = rng.integers(0, v, n).astype(np.int32)
    seq = np.repeat(np.arange(n // 10), 10)
    seq[::7] += 1                          # uneven sentence lengths
    seq = np.maximum.accumulate(seq)
    pos, length = _corpus_positions(seq)
    return ids, pos, length


def test_seeds_and_draws_match_jax():
    for base, ep, ph in ((0, 0, 1), (123, 4, 3), (2**63 + 5, 9, 4)):
        assert tpg.stream_seed(base, ep, ph) == jpg.stream_seed(base, ep, ph)
    assert tpg.base_seed(42) == jpg.base_seed(42)
    k = np.arange(1000, dtype=np.uint64)
    assert np.array_equal(tpg.draws_at(77, k), jpg.draws_at(77, k))
    d = tpg.draws_at(5, k)
    assert np.array_equal(tpg.unit(d), jpg.unit(d))
    assert np.array_equal(tpg.range_reduce(d, 97), jpg.range_reduce(d, 97))


@pytest.mark.parametrize("force_numpy", [True, False])
def test_sm64_subsample_negatives(rng, force_numpy):
    if not force_numpy and not native.pairgen_available():
        pytest.skip("no C++ compiler for the native pair generator")
    assert np.array_equal(
        tpg.sm64_fill(9, 100, 500, force_numpy=force_numpy),
        jpg.sm64_fill(9, 100, 500, force_numpy=True))
    ids = rng.integers(0, 30, 2000).astype(np.int32)
    keep_p = rng.random(30)
    assert np.array_equal(
        tpg.subsample(ids, keep_p, 31, force_numpy=force_numpy),
        jpg.subsample(ids, keep_p, 31, force_numpy=True))
    table = rng.integers(0, 30, 5000).astype(np.int32)
    pos = rng.integers(0, 30, 700).astype(np.int32)
    assert np.array_equal(
        tpg.negatives(table, pos, 5, 30, 1, 2, 40, force_numpy=force_numpy),
        jpg.negatives(table, pos, 5, 30, 1, 2, 40, force_numpy=True))
    # every draw collides twice: the double collision cycles to pos + 1
    table1 = np.zeros(8, np.int32)
    zeros = np.zeros(10, np.int32)
    got = tpg.negatives(table1, zeros, 3, 4, 1, 2, 0,
                        force_numpy=force_numpy)
    assert np.array_equal(got, jpg.negatives(table1, zeros, 3, 4, 1, 2, 0,
                                             force_numpy=True))
    assert (got == 1).all()


@pytest.mark.parametrize("window,n_neg", [(1, 0), (3, 0), (4, 5)])
@pytest.mark.parametrize("force_numpy", [True, False])
def test_walk_matches_jax(rng, window, n_neg, force_numpy):
    if not force_numpy and not native.pairgen_available():
        pytest.skip("no C++ compiler for the native pair generator")
    ids, pos, length = _corpus(rng)
    table = rng.integers(0, 40, 3000).astype(np.int32)
    kw = dict(table=table, n_neg=n_neg, n_words=40, nseed=5, n2seed=6,
              pair_base=11)
    got = tpg.walk(ids, pos, length, 30, 470, window, 99,
                   force_numpy=force_numpy, **kw)
    ref = jpg.walk(ids, pos, length, 30, 470, window, 99, force_numpy=True,
                   **kw)
    for g, r in zip(got, ref):
        assert (g is None and r is None) or np.array_equal(g, r)


@pytest.mark.parametrize("window", [2, 5])
@pytest.mark.parametrize("force_numpy", [True, False])
def test_walk_cbow_matches_jax(rng, window, force_numpy):
    if not force_numpy and not native.pairgen_available():
        pytest.skip("no C++ compiler for the native pair generator")
    ids, pos, length = _corpus(rng)
    table = rng.integers(0, 40, 3000).astype(np.int32)
    kw = dict(table=table, n_neg=4, n_words=40, nseed=7, n2seed=8,
              row_base=3)
    got = tpg.walk_cbow(ids, pos, length, 0, 600, window, 21,
                        force_numpy=force_numpy, **kw)
    ref = jpg.walk_cbow(ids, pos, length, 0, 600, window, 21,
                        force_numpy=True, **kw)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)


def _sentences(rng, n_words=60, n_seq=120):
    words = [f"w{i}" for i in range(n_words)]
    return [" ".join(rng.choice(words, rng.integers(3, 13)))
            for _ in range(n_seq)]


def _preps(model, fit_arg):
    """Every superchunk the producer hands to the device steps."""
    out = []
    model._dispatch_chunks = out.append
    model.fit(fit_arg)
    return out


def _same_preps(a, b):
    assert len(a) == len(b) and len(a) > 0
    for pa, pb in zip(a, b):
        assert pa[0] == pb[0] and len(pa) == len(pb)
        for x, y in zip(pa[1:], pb[1:]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


W2V_ARMS = {"sgns_shared": dict(),
            "sgns_per_pair": dict(shared_negatives=False),
            "sampling": dict(sampling=1e-3, shared_negatives=False),
            "hs": dict(use_hierarchic_softmax=True),
            "cbow": dict(use_cbow=True),
            "cbow_hs": dict(use_cbow=True, use_hierarchic_softmax=True)}


@pytest.mark.parametrize("arm", sorted(W2V_ARMS))
@pytest.mark.parametrize("pairgen", ["auto", "numpy"])
def test_word2vec_superchunks_bitwise(rng, arm, pairgen):
    """The port's producer (native or numpy) hands the device bitwise the
    JAX package's numpy producer's superchunks, in the same order."""
    if pairgen == "auto" and not native.pairgen_available():
        pytest.skip("no C++ compiler for the native pair generator")
    sents = _sentences(rng)
    kw = dict(layer_size=8, window_size=3, negative=4, epochs=2, seed=11,
              batch_size=64, overlap_pairgen=False, **W2V_ARMS[arm])
    ref = _preps(JW2V(pairgen="numpy", **kw), sents)
    got = _preps(TW2V(pairgen=pairgen, device="cpu", **kw), sents)
    _same_preps(got, ref)


@pytest.mark.parametrize("pairgen", ["auto", "legacy"])
def test_dbow_superchunks_bitwise(rng, pairgen):
    if pairgen == "auto" and not native.pairgen_available():
        pytest.skip("no C++ compiler for the native pair generator")
    sents = _sentences(rng, n_seq=60)
    kw = dict(layer_size=8, window_size=3, negative=4, epochs=2, seed=3,
              batch_size=64, overlap_pairgen=False)
    ref = _preps(JPV(pairgen="numpy" if pairgen == "auto" else pairgen,
                     **kw), sents)
    got = _preps(TPV(pairgen=pairgen, device="cpu", **kw), sents)
    _same_preps(got, ref)


def test_walker_telemetry_counts_tokens(rng):
    from deeplearning4j_tpu_torch.observe.registry import default_registry
    reg = default_registry()
    c = reg.counter("dl4j_pairgen_tokens_total")
    key = (("path", "native" if native.pairgen_available() else "numpy"),)
    before = c.series().get(key, 0.0)
    sents = _sentences(rng, n_seq=30)
    m = TW2V(layer_size=8, window_size=2, negative=2, epochs=1, seed=1,
             device="cpu", overlap_pairgen=False)
    m.fit(sents)
    assert c.series()[key] - before == sum(len(s.split()) for s in sents)
    assert "dl4j_pairgen_pairs_total" in reg.render()


# ---- the native library ---------------------------------------------------

@needs_native
def test_library_builds_under_build_keyed_by_source():
    path = native.library_path()
    assert os.path.exists(path)
    assert os.sep + os.path.join("build", "native") + os.sep in path
    assert not path.startswith(os.path.dirname(native.SOURCE) + os.sep)


def test_kill_switch_takes_the_numpy_path(monkeypatch, rng):
    monkeypatch.setenv("DL4J_NATIVE", "0")
    assert not native.available() and not native.pairgen_available()
    assert native.encode(np.ones(4, np.int8)) is None
    assert native.parse_csv("1,2\n") is None
    m = TW2V(layer_size=8, window_size=2, negative=2, epochs=1, seed=1,
             device="cpu")
    m.build_vocab(["a b c a"])
    walker = tpg.CorpusWalker(m, np.zeros(4, np.int32), np.zeros(4, int))
    assert walker.force_numpy and walker._path == "numpy"


@needs_native
@pytest.mark.parametrize("density", [0.001, 0.3])
def test_codec_matches_jax(rng, density):
    from deeplearning4j_tpu.parallel import compression as jc
    signs = np.zeros(5000, np.int8)
    hit = rng.random(5000) < density
    signs[hit] = rng.choice([-1, 1], hit.sum()).astype(np.int8)
    msg = native.encode(signs)
    assert np.array_equal(native.decode(msg), signs)
    acc = np.zeros(5000, np.float32)
    assert native.decode_axpy(msg, 0.5, acc)
    assert np.array_equal(acc, signs.astype(np.float32) * 0.5)
    assert np.array_equal(msg, jc.encode(signs))
    assert np.array_equal(np.asarray(jc.decode(msg)).reshape(-1), signs)


@needs_native
def test_record_readers():
    got = native.parse_csv("1,2.5,3\r\n\n4,5,6e1\n")
    assert np.array_equal(got, np.array([[1, 2.5, 3], [4, 5, 60]],
                                        np.float32))
    with pytest.raises(ValueError):
        native.parse_csv("1,2\n3\n")
    raw = (bytes([0, 0, 8, 3]) + (2).to_bytes(4, "big")
           + (2).to_bytes(4, "big") + (3).to_bytes(4, "big")
           + bytes(range(0, 240, 20)))
    arr, shape = native.decode_idx(raw)
    assert shape == (2, 2, 3)
    assert np.allclose(arr.reshape(-1), np.arange(0, 240, 20) / 255.0)
