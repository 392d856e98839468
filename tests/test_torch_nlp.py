"""The port's NLP tier against the JAX package's: whole fits, the copied
text front end, files both ways, the streaming corpus and the cluster
pipeline.

Whole fits (SGNS, HS, CBOW, DBOW, DM, GloVe) at toy size from the same
seed: every table within 1e-4 of its largest entry. One ulp of start
noise moves the JAX package's own fits by at most 3.3e-6 of the largest
entry, so the bound leaves a margin of 30x. Everything the two packages
compute on the host (vocab, Huffman codes, unigram table, files) is
bitwise equal.
"""

import os
import queue
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import serializer as jser
from deeplearning4j_tpu.nlp import skipgram as jsk
from deeplearning4j_tpu.nlp.glove import Glove as JGlove
from deeplearning4j_tpu.nlp.paragraph_vectors import ParagraphVectors as JPV
from deeplearning4j_tpu.nlp.sentence_iterators import \
    LabelledDocument as JDoc
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JW2V
from deeplearning4j_tpu_torch.datasets.corpus import (CorpusDataSetIterator,
                                                      CorpusShardWriter,
                                                      spool_stream)
from deeplearning4j_tpu_torch.nlp import serializer as tser
from deeplearning4j_tpu_torch.nlp.glove import Glove as TGlove
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import \
    ParagraphVectors as TPV
from deeplearning4j_tpu_torch.nlp.sentence_iterators import (
    LabelledDocument as TDoc, StreamingSentenceIterator, publish_sentences)
from deeplearning4j_tpu_torch.nlp.vocab import Huffman, VocabConstructor
from deeplearning4j_tpu_torch.nlp.word2vec import (StaticWord2Vec,
                                                   Word2Vec as TW2V)
from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore

FIT_TOL = 1e-4


def _toy_corpus(n=120):
    """Two topics that never mix: (cat, dog, pet, fur, paw) and (car,
    truck, road, wheel, engine)."""
    rng = np.random.default_rng(0)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    vehicles = ["car", "truck", "road", "wheel", "engine"]
    return [" ".join(rng.choice(animals if rng.random() < 0.5 else vehicles,
                                size=6)) for _ in range(n)]


def _close(got, ref, tol=FIT_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


W2V = dict(layer_size=24, window_size=3, negative=4, epochs=12,
           batch_size=256, seed=7, pairgen="numpy")
W2V_ARMS = {"sgns": {}, "hs": {"use_hierarchic_softmax": True},
            "cbow": {"use_cbow": True}}


@pytest.mark.parametrize("arm", sorted(W2V_ARMS))
def test_word2vec_fit_matches_jax(arm):
    kw = {**W2V, **W2V_ARMS[arm]}
    corpus = _toy_corpus()
    ref = JW2V(**kw).fit(corpus)
    got = TW2V(device="cpu", **kw).fit(corpus)
    _close(got.syn0, ref.syn0)
    _close(got.syn1, ref.syn1)
    assert got.similarity("cat", "dog") > got.similarity("cat", "car")
    assert got.words_nearest("cat", 4) == ref.words_nearest("cat", 4)


def _docs(cls, n=40):
    return [cls(d, [f"L{i % 4}"]) for i, d in enumerate(_toy_corpus()[:n])]


@pytest.mark.parametrize("dm", [False, True])
def test_paragraph_vectors_fit_matches_jax(dm):
    kw = dict(dm=dm, layer_size=16, window_size=3, negative=4, epochs=8,
              batch_size=128, seed=5, pairgen="numpy")
    ref = JPV(**kw).fit(_docs(JDoc))
    got = TPV(device="cpu", **kw).fit(_docs(TDoc))
    _close(got.syn0, ref.syn0)
    _close(got.syn1, ref.syn1)
    assert got.labels() == ref.labels()


def test_infer_vector_matches_the_jax_step_loop():
    """``infer_vector`` against the JAX package's ``infer_step`` driven
    with the same targets. (The JAX package's own ``infer_vector`` hands
    ``infer_step`` numpy buffers that it rewrites before the CPU backend's
    asynchronous step has read them, so it does not repeat in one
    process; the loop here gives the step its own copies.)"""
    import jax.numpy as jnp
    kw = dict(layer_size=16, window_size=3, negative=4, epochs=8,
              batch_size=128, seed=5, pairgen="numpy")
    ref = JPV(**kw).fit(_docs(JDoc))
    got = TPV(device="cpu", **kw).fit(_docs(TDoc))
    got.set_tables(np.asarray(ref.syn0), np.asarray(ref.syn1))
    text = "cat dog pet fur"
    rng = np.random.default_rng(0)
    vec = jnp.array(((rng.random(16) - 0.5) / 16).astype(np.float32))
    idxs = [ref.vocab.index_of(t) for t in text.split()]
    k = ref._k()
    for _ in range(10):
        targets = np.zeros((4, k), np.int32)
        labels = np.zeros((4, k), np.float32)
        mask = np.zeros((4, k), np.float32)
        for p, w in enumerate(idxs):
            t, lb = jsk.negative_sample_targets(w, ref._table, 4, rng)
            targets[p], labels[p], mask[p] = t, lb, 1.0
        vec = jsk.infer_step(vec, ref.syn1, jnp.array(targets),
                             jnp.array(labels), jnp.array(mask),
                             jnp.float32(ref.learning_rate))
    v = got.infer_vector(text)
    _close(v, vec, 1e-5)
    assert np.array_equal(v, got.infer_vector(text))
    assert got.predict(text) in got.labels()
    assert -1.0 <= got.similarity_to_label(text, "L0") <= 1.0


def test_glove_fit_matches_jax():
    kw = dict(layer_size=16, window_size=3, epochs=5, batch_size=64, seed=3)
    seqs = [s.split() for s in _toy_corpus()]
    ref = JGlove(**kw).fit(seqs)
    got = TGlove(device="cpu", **kw).fit(seqs)
    _close(got.syn0, ref.syn0)
    _close(got.syn1, ref.syn1)
    assert abs(got.last_loss - ref.last_loss) <= FIT_TOL * ref.last_loss


def test_overlapped_producer_is_bitwise_the_serial_loop():
    for arm in ({}, {"use_cbow": True}, {"use_hierarchic_softmax": True}):
        tables = []
        for overlap in (True, False):
            m = TW2V(device="cpu", overlap_pairgen=overlap,
                     **{**W2V, "epochs": 3, **arm})
            m.fit(_toy_corpus())
            tables.append((m.syn0.clone(), m.syn1.clone()))
        assert torch.equal(tables[0][0], tables[1][0])
        assert torch.equal(tables[0][1], tables[1][1])


def test_device_pair_generation_trains_and_repeats():
    kw = {**W2V, "device_pair_generation": True}
    a = TW2V(device="cpu", **kw).fit(_toy_corpus())
    b = TW2V(device="cpu", **kw).fit(_toy_corpus())
    assert torch.equal(a.syn0, b.syn0) and torch.equal(a.syn1, b.syn1)
    assert a.similarity("cat", "dog") > a.similarity("cat", "car")


def test_tables_own_their_memory():
    syn0 = np.ones((3, 2), np.float32)
    m = TW2V(device="cpu")
    m.set_tables(syn0, syn0)
    m.syn0.add_(1.0)
    assert (syn0 == 1.0).all()


def test_host_front_end_is_the_jax_packages():
    from deeplearning4j_tpu.nlp import vocab as jv
    from deeplearning4j_tpu.nlp.bagofwords import TfidfVectorizer as JT
    from deeplearning4j_tpu.nlp.tokenization import (
        CommonPreprocessor as JCP, DefaultTokenizerFactory as JDF)
    from deeplearning4j_tpu_torch.nlp.bagofwords import TfidfVectorizer
    from deeplearning4j_tpu_torch.nlp.tokenization import (
        CommonPreprocessor, DefaultTokenizerFactory)
    corpus = _toy_corpus() + ["Hello, World! 123 cat"]
    tf = DefaultTokenizerFactory().set_token_pre_processor(
        CommonPreprocessor())
    jtf = JDF().set_token_pre_processor(JCP())
    seqs = [tf.create(s).get_tokens() for s in corpus]
    assert seqs == [jtf.create(s).get_tokens() for s in corpus]
    mine = VocabConstructor(min_word_frequency=2).build_vocab(seqs)
    theirs = jv.VocabConstructor(min_word_frequency=2).build_vocab(seqs)
    assert mine.words() == theirs.words()
    Huffman(mine.vocab_words()).build()
    jv.Huffman(theirs.vocab_words()).build()
    for a, b in zip(mine.vocab_words(), theirs.vocab_words()):
        assert (a.count, a.index, a.codes, a.points) == \
            (b.count, b.index, b.codes, b.points)
    assert np.array_equal(mine.unigram_table(5000),
                          theirs.unigram_table(5000))
    assert np.array_equal(TfidfVectorizer().fit_transform(corpus[:20]),
                          JT().fit_transform(corpus[:20]))


def test_language_packs_match_jax():
    from deeplearning4j_tpu.nlp import language_packs as jlp
    from deeplearning4j_tpu_torch.nlp import language_packs as tlp
    text = "我们在北京学习 Python. 東京は大きい都市です。 서울에서 공부합니다"
    for name in ("ChineseTokenizerFactory", "JapaneseTokenizerFactory",
                 "KoreanTokenizerFactory"):
        if hasattr(jlp, name):
            assert getattr(tlp, name)().create(text).get_tokens() == \
                getattr(jlp, name)().create(text).get_tokens()


def test_full_model_files_both_ways(tmp_path):
    kw = {**W2V, "use_hierarchic_softmax": True}
    ref = JW2V(**kw).fit(_toy_corpus())
    jpath = str(tmp_path / "jax.npz")
    jser.write_full_model(ref, jpath)
    got = tser.read_full_model(jpath, device="cpu")
    assert np.array_equal(got.syn0.numpy(), np.asarray(ref.syn0))
    assert np.array_equal(got.syn1.numpy(), np.asarray(ref.syn1))
    assert got.vocab.words() == ref.vocab.words()
    tpath = str(tmp_path / "port.npz")
    tser.write_full_model(got, tpath)
    back = jser.read_full_model(tpath)
    assert np.array_equal(np.asarray(back.syn0), np.asarray(ref.syn0))
    assert [w.codes for w in back.vocab.vocab_words()] == \
        [w.codes for w in ref.vocab.vocab_words()]
    # the loaded model trains on
    got.fit(_toy_corpus()[:20])
    assert np.isfinite(got.syn0.numpy()).all()


def test_text_vectors_both_ways(tmp_path):
    m = TW2V(device="cpu", **W2V).fit(_toy_corpus())
    for name in ("v.txt", "v.txt.gz"):
        p = str(tmp_path / name)
        tser.write_word_vectors(m, p)
        q = str(tmp_path / ("j" + name))
        jser.write_word_vectors(jser.read_word_vectors(p), q)
        with open(p, "rb") as f1, open(q, "rb") as f2:
            if not name.endswith(".gz"):
                assert f1.read() == f2.read()
        s = tser.read_word_vectors(q)
        assert isinstance(s, StaticWord2Vec)
        assert abs(s.similarity("cat", "dog")
                   - m.similarity("cat", "dog")) < 1e-5


class _Topic:
    """An in-process transport with one topic queue (publish/poll)."""

    def __init__(self):
        self.q = queue.Queue()

    def publish(self, topic, payload):
        self.q.put(payload)

    def poll(self, topic, timeout):
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


def test_stream_spool_corpus_and_fit_stream(tmp_path):
    """Broker-shaped stream -> object-store shards -> windowed training:
    the vocab is fixed by the first window and every window fires the
    hook."""
    corpus = _toy_corpus(60)
    transport = _Topic()
    assert publish_sentences(transport, corpus) == 60
    stream = StreamingSentenceIterator(transport, idle_timeout_s=1.0)
    store = ArtifactStore(str(tmp_path))
    assert spool_stream(stream, store, "c1", shard_sentences=25) == 60
    assert stream.termination_reason == "eos"
    it = CorpusDataSetIterator(store, "c1")
    assert list(it) == corpus and it.termination_reason == "eos"
    follow = CorpusDataSetIterator(store, "c1", follow=True)
    assert list(follow) == corpus
    assert follow.termination_reason == "complete"
    seen = []
    m = TW2V(device="cpu", **{**W2V, "epochs": 2})
    m.fit_stream(CorpusDataSetIterator(store, "c1"), window_sentences=25,
                 on_window=lambda mod, i, n: seen.append((i, n)))
    assert seen == [(0, 25), (1, 25), (2, 10)]
    assert m.vocab.num_words() == 10


def test_corpus_follow_sees_a_writer_append(tmp_path):
    store = ArtifactStore(str(tmp_path))
    w = CorpusShardWriter(store, "live", shard_sentences=2)
    got = []
    reader = CorpusDataSetIterator(store, "live", follow=True,
                                   poll_interval_s=0.01, idle_timeout_s=5)
    t = threading.Thread(target=lambda: got.extend(reader))
    t.start()
    w.extend(["a b", "c d", "e f"])
    w.close()
    t.join(10)
    assert got == ["a b", "c d", "e f"]
    assert reader.termination_reason == "complete"
    assert os.path.exists(os.path.join(store.cache_dir("live"),
                                       "manifest.json"))


def test_text_pipeline_and_distributed_word2vec_match_jax():
    from deeplearning4j_tpu.nlp.cluster import DistributedWord2Vec as JD
    from deeplearning4j_tpu_torch.nlp.cluster import (DistributedWord2Vec,
                                                      TextPipeline)
    corpus = _toy_corpus(80)
    kw = dict(num_workers=2, averaging_rounds=2, layer_size=16,
              window_size=3, negative=4, epochs=4, batch_size=128, seed=2,
              pairgen="numpy")
    ref = JD(**kw).fit(corpus)
    got = DistributedWord2Vec(device="cpu", **kw).fit(corpus)
    assert got.vocab.words() == ref.vocab.words()
    assert got.vocab.words() == TextPipeline(2).build_vocab(corpus).words()
    _close(got.syn0, ref.syn0)
    _close(got.syn1, ref.syn1)


def test_entry_points_need_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TW2V, TPV, TGlove):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
    m = TW2V(device="cpu", **W2V).fit(_toy_corpus()[:10])
    p = str(tmp_path / "m.npz")
    tser.write_full_model(m, p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tser.read_full_model(p)
