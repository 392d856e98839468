"""The port's v2 generation modes on the CPU, case by case as the JAX
package's ``tests/test_generation_v2.py``, plus parity with the JAX
package.

The v1 invariant — continuous batching is bitwise-invisible — must
survive each v2 serving mode: chunked prefill (multi-token prefill
dispatches), speculative decode (n-gram draft + batched verify under
counter-based sampling keys), and resumable sessions (carry tiers:
device LRU -> host LRU -> shared ArtifactStore checkpoint, resumed
across engines). Plus the scheduler edges the modes open up: mid-prefill
cancel/deadline retirement, the pruned resize-pair warmup sweep, and
int8 carry quantization. The small model is the JAX file's, built with
``device="cpu"``.

The JAX file's ``test_fleet_session_affinity`` is
``tests/test_torch_fleet.py``'s session-affinity test.

Against the JAX package: ``counter_keys``, ``NGramDraft.propose`` and
the int8 carry rows of ``SessionStore`` are equal bit for bit.
"""

import random

import numpy as np
import pytest

from deeplearning4j_tpu_torch.generation import (
    CarrySnapshot,
    GenerationEngine,
    NGramDraft,
    SessionStore,
    counter_keys,
    extract_decode_spec,
    reference_decode,
)
from deeplearning4j_tpu_torch.generation.engine import \
    _reachable_resize_pairs
from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore

SMALL_VOCAB = 31


def _small_model():
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    return TextGenerationLSTM(vocab_size=SMALL_VOCAB, timesteps=8,
                              lstm_units=32).init(device="cpu")


def _store(spec, **kw):
    return SessionStore(spec, device="cpu", **kw)


@pytest.fixture(scope="module")
def model():
    return _small_model()


@pytest.fixture(scope="module")
def spec(model):
    return extract_decode_spec(model)


@pytest.fixture(scope="module")
def plain_engine(model):
    eng = GenerationEngine(model, max_slots=4,
                           registry=MetricsRegistry(),
                           session_id="v2-plain")
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def chunked_engine(model):
    eng = GenerationEngine(model, max_slots=4, prefill_chunk=8,
                           registry=MetricsRegistry(),
                           session_id="v2-chunked")
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def spec_engine(model):
    eng = GenerationEngine(model, max_slots=4, speculative=3,
                           registry=MetricsRegistry(),
                           session_id="v2-spec")
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def counter_engine(model):
    eng = GenerationEngine(model, max_slots=2, sampling="counter",
                           registry=MetricsRegistry(),
                           session_id="v2-counter")
    yield eng
    eng.shutdown()


# ---- chunked prefill ---------------------------------------------------


def test_chunked_staggered_greedy_parity(chunked_engine, model):
    """Long prompts through the chunked prefill, short ones through tick
    prefill, joining staggered — every output equal to the sequential
    reference."""
    rng = random.Random(41)
    cfgs = [([rng.randrange(SMALL_VOCAB)
              for _ in range(rng.randrange(2, 40))],
             rng.randrange(8, 24)) for _ in range(8)]
    refs = [reference_decode(model, p, m) for p, m in cfgs]
    streams = []
    for i, (p, m) in enumerate(cfgs):
        streams.append(chunked_engine.submit(p, max_new_tokens=m,
                                             greedy=True))
    for i, (s, ref) in enumerate(zip(streams, refs)):
        assert s.result(timeout=60)["ids"] == ref, f"sequence {i}"
    st = chunked_engine.stats()
    assert st["prefill"]["chunks"] >= 1
    assert st["prefill"]["chunk_tokens"] >= 1
    chunked_engine.assert_warm()


def test_chunked_sampled_matches_tick_prefill(chunked_engine,
                                              plain_engine):
    """Prefill mode is a dispatch-shape choice: the key chain advances
    one split per consumed token either way, so a seeded sampled run is
    bitwise-identical across prefill modes."""
    prompt = list(range(1, 21))     # long enough to take chunked path
    kw = dict(greedy=False, temperature=0.8, top_k=10, seed=11,
              max_new_tokens=16)
    a = chunked_engine.submit(prompt, **kw).result(timeout=60)["ids"]
    b = plain_engine.submit(prompt, **kw).result(timeout=60)["ids"]
    assert a == b


def test_chunked_ttft_ring_split(chunked_engine):
    st = chunked_engine.stats()
    assert set(st["latency_ms"]["ttft_by_mode"]) == {"chunked", "tick"}


# ---- speculative decode ------------------------------------------------


def test_speculative_greedy_parity_staggered(spec_engine, model):
    rng = random.Random(43)
    cfgs = [([rng.randrange(SMALL_VOCAB)
              for _ in range(rng.randrange(2, 8))],
             rng.randrange(16, 40)) for _ in range(8)]
    refs = [reference_decode(model, p, m) for p, m in cfgs]
    streams = [spec_engine.submit(p, max_new_tokens=m, greedy=True)
               for p, m in cfgs]
    for i, (s, ref) in enumerate(zip(streams, refs)):
        assert s.result(timeout=60)["ids"] == ref, f"sequence {i}"
    st = spec_engine.stats()["speculative"]
    assert st["proposed"] > 0
    spec_engine.assert_warm()


def test_speculative_sampled_matches_plain_counter(spec_engine,
                                                   counter_engine):
    """Acceptance sampling under counter-based keys is exact: the
    speculative stream equals the non-speculative counter-mode stream
    bitwise, token for token."""
    kw = dict(greedy=False, temperature=0.9, top_k=12, seed=5,
              max_new_tokens=24)
    prompt = [2, 7, 2, 7, 2, 7]
    a = spec_engine.submit(prompt, **kw).result(timeout=60)["ids"]
    b = counter_engine.submit(prompt, **kw).result(timeout=60)["ids"]
    assert a == b
    # same-seed replay on the speculative engine is exact too (keys are
    # (seed, position) counters, independent of acceptance history)
    c = spec_engine.submit(prompt, **kw).result(timeout=60)["ids"]
    assert a == c


def test_counter_keys_deterministic():
    seeds = np.array([7, 8], np.uint32)
    pos = np.array([3, 3], np.uint64)
    a = counter_keys(seeds, pos, 4)
    b = counter_keys(seeds, pos, 4)
    assert a.shape == (2, 4, 2) and a.dtype == np.uint32
    assert np.array_equal(a, b)
    assert not np.array_equal(a[0], a[1])        # seed separates
    c = counter_keys(seeds, pos + 1, 4)
    assert not np.array_equal(a, c)              # position separates
    # consecutive draft positions of one dispatch tile the same keys a
    # later plain tick would use — that is the bitwise-equality trick
    d = counter_keys(seeds, pos + 1, 3)
    assert np.array_equal(a[:, 1:, :], d[:, :3, :])


def test_ngram_draft_learns_a_loop():
    d = NGramDraft()
    d.observe_many([1, 2, 3] * 6)
    assert d.propose(3) == [1, 2, 3]
    d2 = NGramDraft()
    assert d2.propose(4) == []                   # no history, no guess


# ---- resumable sessions ------------------------------------------------


def test_session_requires_store(plain_engine):
    with pytest.raises(ValueError):
        plain_engine.submit([1, 2], session="nope")


def test_session_multi_turn_device_tier(model, spec):
    store = _store(spec, registry=MetricsRegistry(),
                   session_id="v2-turns")
    eng = GenerationEngine(model, max_slots=2, session_store=store,
                           registry=MetricsRegistry(),
                           session_id="v2-turns")
    try:
        prompt = [3, 1, 4, 1, 5]
        full = reference_decode(model, prompt, 30)
        got = eng.submit(prompt, max_new_tokens=10,
                         session="t").result(timeout=60)
        assert got["ids"] == full[:10]
        assert got["session"] == "t"
        for turn in (1, 2):
            got = eng.submit([], max_new_tokens=10,
                             session="t").result(timeout=60)
            assert got["ids"] == full[10 * turn:10 * (turn + 1)]
        assert store.stats()["hits"]["device"] >= 2
        eng.assert_warm()
    finally:
        eng.shutdown()


def test_session_cross_engine_resume_zero_compiles(model, spec,
                                                   tmp_path):
    """Node A decodes turn 1 and drains; node B (sharing only the
    ArtifactStore directory) continues turn 2 bitwise from the store
    checkpoint without a single live compile."""
    shared = ArtifactStore(str(tmp_path))
    prompt = [9, 8, 7, 6]
    full = reference_decode(model, prompt, 24)
    eng_a = GenerationEngine(
        model, max_slots=2, registry=MetricsRegistry(),
        session_id="v2-node-a",
        session_store=_store(spec, store=shared,
                             registry=MetricsRegistry(),
                             session_id="v2-node-a"))
    try:
        turn1 = eng_a.submit(prompt, max_new_tokens=12,
                             session="xnode").result(timeout=60)
        assert turn1["ids"] == full[:12]
    finally:
        eng_a.shutdown()
    store_b = _store(spec, store=shared, registry=MetricsRegistry(),
                     session_id="v2-node-b")
    eng_b = GenerationEngine(model, max_slots=2, session_store=store_b,
                             registry=MetricsRegistry(),
                             session_id="v2-node-b")
    try:
        turn2 = eng_b.submit([], max_new_tokens=12,
                             session="xnode").result(timeout=60)
        assert turn2["ids"] == full[12:]
        assert store_b.stats()["hits"]["store"] == 1
        eng_b.assert_warm()
    finally:
        eng_b.shutdown()


def test_sampled_session_resumes_its_key_chain(model, spec):
    """A seeded chain-mode stream split over two turns equals one run:
    the stored key row continues the chain."""
    store = _store(spec, registry=MetricsRegistry(),
                   session_id="v2-chain")
    eng = GenerationEngine(model, max_slots=2, session_store=store,
                           stop_text=None, registry=MetricsRegistry(),
                           session_id="v2-chain")
    try:
        kw = dict(greedy=False, temperature=0.8, top_k=10, seed=9)
        one = eng.submit([4, 2], max_new_tokens=30,
                         **kw).result(timeout=60)["ids"]
        a = eng.submit([4, 2], max_new_tokens=12, session="c",
                       **kw).result(timeout=60)["ids"]
        b = eng.submit([], max_new_tokens=18, session="c",
                       **kw).result(timeout=60)["ids"]
        assert a + b == one
    finally:
        eng.shutdown()


def test_session_lru_tiers(spec):
    store = _store(spec, device_capacity=2, host_capacity=2,
                   registry=MetricsRegistry(), session_id="v2-lru")

    def snap(seed):
        r = np.random.RandomState(seed)
        return CarrySnapshot(
            [r.randn(hd).astype(np.float32)
             for hd in spec.hidden_sizes],
            [r.randn(hd).astype(np.float32)
             for hd in spec.hidden_sizes],
            np.array([seed, seed], np.uint32), [seed], seed, [seed])

    for i in range(3):
        store.save(f"s{i}", snap(i))
    assert store.resident("s0") == "host"        # LRU'd off the device
    assert store.resident("s2") == "device"
    got = store.load("s0")                       # host hit, repinned
    assert got.pending == [0]
    np.testing.assert_array_equal(got.h[0], snap(0).h[0])
    st = store.stats()
    assert st["hits"]["host"] == 1
    for i in range(3, 7):                        # overflow both tiers
        store.save(f"s{i}", snap(i))
    st = store.stats()
    assert st["evictions"] >= 1
    assert store.load("missing") is None
    assert st["misses"] >= 0


def test_session_store_quarantine(spec, tmp_path):
    shared = ArtifactStore(str(tmp_path))
    a = _store(spec, store=shared, registry=MetricsRegistry(),
               session_id="v2-qa")
    r = np.random.RandomState(0)
    a.save("tok", CarrySnapshot(
        [r.randn(hd).astype(np.float32) for hd in spec.hidden_sizes],
        [r.randn(hd).astype(np.float32) for hd in spec.hidden_sizes],
        np.array([1, 2], np.uint32), [3], 4, [3]))
    blobs = list(tmp_path.glob("objects/**/*.npz"))
    assert blobs
    raw = bytearray(blobs[0].read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    blobs[0].write_bytes(bytes(raw))
    b = _store(spec, store=shared, registry=MetricsRegistry(),
               session_id="v2-qb")
    assert b.load("tok") is None                 # checksum mismatch
    assert b.stats()["quarantined"] == 1
    assert list(tmp_path.glob("objects/**/*.quarantine"))


def test_session_int8_carry_roundtrip(spec):
    store = _store(spec, carry_dtype="int8", registry=MetricsRegistry(),
                   session_id="v2-int8")
    r = np.random.RandomState(7)
    h = [r.uniform(-1, 1, hd).astype(np.float32)
         for hd in spec.hidden_sizes]
    c = [r.uniform(-3, 3, hd).astype(np.float32)
         for hd in spec.hidden_sizes]
    store.save("q", CarrySnapshot(h, c, np.array([1, 2], np.uint32),
                                  [0], 1, [0]))
    got = store.load("q")
    for x, y in zip(h + c, got.h + got.c):
        assert y.dtype == np.float32
        scale = float(np.max(np.abs(x))) / 127.0
        assert float(np.max(np.abs(x - y))) <= scale + 1e-6
    np.testing.assert_array_equal(got.rng,
                                  np.array([1, 2], np.uint32))


# ---- mid-prefill retirement --------------------------------------------


def test_mid_prefill_cancel(chunked_engine, model):
    prompt = [i % SMALL_VOCAB for i in range(4096)]
    stream = chunked_engine.submit(prompt, max_new_tokens=8,
                                   greedy=True)
    stream.cancel()
    res = stream.result(timeout=60)
    assert res["reason"] == "cancelled"
    # the slot is free and the engine state sane: a normal request
    # still decodes bitwise with zero live compiles
    ref = reference_decode(model, [1, 2, 3], 10)
    assert chunked_engine.submit(
        [1, 2, 3], max_new_tokens=10,
        greedy=True).result(timeout=60)["ids"] == ref
    chunked_engine.assert_warm()


def test_mid_prefill_deadline(chunked_engine, model):
    from deeplearning4j_tpu_torch.parallel.deadline import Deadline
    prompt = [i % SMALL_VOCAB for i in range(4096)]
    stream = chunked_engine.submit(prompt, max_new_tokens=8,
                                   greedy=True,
                                   deadline=Deadline.after_ms(30.0))
    res = stream.result(timeout=60)
    assert res["reason"] == "deadline"
    ref = reference_decode(model, [4, 5], 10)
    assert chunked_engine.submit(
        [4, 5], max_new_tokens=10,
        greedy=True).result(timeout=60)["ids"] == ref
    chunked_engine.assert_warm()


# ---- warmup sweep pruning ----------------------------------------------


def test_reachable_resize_pairs_pruned():
    ladder = [1, 2, 4, 8]
    pairs = set(_reachable_resize_pairs(ladder))
    grows = {(s, d) for i, s in enumerate(ladder)
             for d in ladder[i + 1:]}
    shrinks = {(2, 1), (4, 2), (8, 4)}
    assert pairs == grows | shrinks
    # the quadratic sweep had 12 ordered pairs; multi-rung shrinks are
    # unreachable (the scheduler steps down one rung at a time)
    assert len(pairs) == 9


def test_burst_grow_then_shrink_zero_live_compiles(model):
    eng = GenerationEngine(model, max_slots=8,
                           registry=MetricsRegistry(),
                           session_id="v2-burst")
    try:
        streams = [eng.submit([i % SMALL_VOCAB], max_new_tokens=10)
                   for i in range(8)]        # 1 -> 8 in one admission
        for s in streams:
            s.result(timeout=60)
        # drain, then trickle so the scheduler walks the bucket back
        # down the ladder one rung at a time
        for _ in range(3):
            eng.submit([3], max_new_tokens=4).result(timeout=60)
        eng.assert_warm()
    finally:
        eng.shutdown()


# ---- stats surface -----------------------------------------------------


def test_v2_stats_and_metrics_series(model, spec):
    reg = MetricsRegistry()
    store = _store(spec, registry=reg, session_id="v2-stats")
    eng = GenerationEngine(model, max_slots=2, prefill_chunk=8,
                           speculative=2, session_store=store,
                           registry=reg, session_id="v2-stats")
    try:
        st = eng.stats()
        assert st["sampling"] == "counter"
        assert st["prefill"]["chunk"] == 8
        assert st["speculative"]["k"] == 2
        assert st["session_store"]["capacity"]["device"] >= 1
        text = reg.render()
        for name in ("dl4j_gen_prefill_chunks_total",
                     "dl4j_gen_prefill_tokens_total",
                     "dl4j_gen_prefill_ttft_ms",
                     "dl4j_gen_spec_proposed_total",
                     "dl4j_gen_spec_accepted_total",
                     "dl4j_gen_session_hits_total",
                     "dl4j_gen_session_misses_total",
                     "dl4j_gen_session_evictions_total",
                     "dl4j_gen_session_resident"):
            assert name in text, name
    finally:
        eng.shutdown()


# ---- parity with the JAX package ---------------------------------------


def test_engine_registers_the_jax_engines_series(model):
    """Every ``dl4j_gen_*`` series the JAX engine registers at start, the
    port's registers too: the same names, types, label sets and values
    (the warmup's compile counts included)."""
    from deeplearning4j_tpu.generation import GenerationEngine as JEngine
    from deeplearning4j_tpu.generation import SessionStore as JStore
    from deeplearning4j_tpu.generation import \
        extract_decode_spec as jspec_of
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    from deeplearning4j_tpu.zoo.models import TextGenerationLSTM as JText
    jm = JText()
    jm.lstm_units, jm.vocab_size, jm.timesteps = 32, SMALL_VOCAB, 8
    jm = jm.init()
    texts = []
    for eng_cls, store_cls, m, spec_of, reg, extra in (
            (GenerationEngine, SessionStore, model, extract_decode_spec,
             MetricsRegistry(), {"device": "cpu"}),
            (JEngine, JStore, jm, jspec_of, JRegistry(), {})):
        store = store_cls(spec_of(m), registry=reg, session_id="series",
                          **extra)
        eng = eng_cls(m, max_slots=2, prefill_chunk=8, speculative=2,
                      session_store=store, registry=reg,
                      session_id="series")
        eng.shutdown()
        texts.append("\n".join(
            l for l in reg.render().splitlines()
            if "dl4j_gen_" in l and not l.startswith("# HELP")))
    assert texts[0] == texts[1]


def test_counter_keys_and_draft_match_jax():
    from deeplearning4j_tpu.generation.speculative import NGramDraft as JD
    from deeplearning4j_tpu.generation.speculative import \
        counter_keys as jkeys
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 1 << 32, 16, dtype=np.uint64).astype(np.uint32)
    pos = rng.integers(0, 1 << 40, 16, dtype=np.uint64)
    got, want = counter_keys(seeds, pos, 5), jkeys(seeds, pos, 5)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    toks = rng.integers(0, 6, 300).tolist()
    a, b = NGramDraft(max_order=3, max_history=64), JD(3, 64)
    for i, t in enumerate(toks):
        a.observe(t)
        b.observe(t)
        if i % 7 == 0:
            for k in (1, 3, 5):
                assert a.propose(k) == b.propose(k)
    assert a.history == b.history


def test_session_int8_carry_rows_match_jax(spec, tmp_path):
    """The int8 rows of both packages' stores, saved from one snapshot:
    the same bytes, in memory and read back from each one's checkpoint."""
    from deeplearning4j_tpu.generation import SessionStore as JStore
    from deeplearning4j_tpu.generation.session import \
        _quantize_rows as jq
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    from deeplearning4j_tpu.parallel.aot_cache import \
        ArtifactStore as JArtifacts
    from deeplearning4j_tpu_torch.generation.session import _quantize_rows
    r = np.random.RandomState(11)
    h = [r.uniform(-1, 1, hd).astype(np.float32)
         for hd in spec.hidden_sizes]
    c = [r.uniform(-4, 4, hd).astype(np.float32)
         for hd in spec.hidden_sizes]
    for (qa, sa), (qb, sb) in ((_quantize_rows(h), jq(h)),
                               (_quantize_rows(c), jq(c))):
        assert np.array_equal(sa, sb)
        for x, y in zip(qa, qb):
            assert x.dtype == y.dtype == np.int8 and np.array_equal(x, y)
    snap = CarrySnapshot(h, c, np.array([5, 6], np.uint32), [2], 7, [2])
    mine = _store(spec, carry_dtype="int8", registry=MetricsRegistry(),
                  store=ArtifactStore(str(tmp_path / "port")))
    theirs = JStore(spec, carry_dtype="int8", registry=JRegistry(),
                    store=JArtifacts(str(tmp_path / "jax")))
    mine.save("q", snap)
    theirs.save("q", snap)
    fresh = (_store(spec, carry_dtype="int8", registry=MetricsRegistry(),
                    store=ArtifactStore(str(tmp_path / "port"))),
             JStore(spec, carry_dtype="int8", registry=JRegistry(),
                    store=JArtifacts(str(tmp_path / "jax"))))
    for a, b in ((mine.load("q"), theirs.load("q")),
                 tuple(s.load("q") for s in fresh)):
        for x, y in zip(a.h + a.c, b.h + b.c):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert (a.pending, a.pos, a.history) == (b.pending, b.pos,
                                                 b.history)
    assert fresh[0].stats()["hits"]["store"] == 1
