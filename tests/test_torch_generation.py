"""The port's generation engine on the CPU, case by case as the JAX
package's ``tests/test_generation.py``, plus parity with the JAX package.

Continuous batching must be *invisible*: a sequence decoded in a shared
slot batch with co-residents joining and retiring around it equals the
same sequence decoded alone through ``rnn_time_step`` (greedy), and a
seeded sampling run reproduces exactly. Plus the serving surface
(stop/length retirement, warmth) and the decode-level int8 head gate.
The small model is the JAX file's (``lstm_units=32``, ``vocab_size=31``,
``timesteps=8``), built with ``device="cpu"`` and carrying the JAX
model's parameters (``params_from_jax``), so the port's streams can be
held against the JAX package's.

The JAX file's ``GenerationPool`` and HTTP cases have their ports in
``tests/test_torch_fleet.py`` (``test_generation_pool_shed``) and
``tests/test_torch_ui.py`` (``test_sse_generation_over_a_fleet_pool``,
``test_drain_lets_inflight_streams_finish``,
``test_generic_generator_payload_streams``).

Tolerances against the JAX package: the tick's carries within 1e-6
(absolute; |h| < 1 and |c| of a few units, the same f32 products summed
in another order), greedy tokens equal; the quantized weights, rows and
the int8 accumulation bitwise, the rescaled int8 product within 1e-6;
the key hash against its numpy ``uint64`` twin bitwise.
"""

import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.generation import (
    GenerationEngine,
    Vocab,
    extract_decode_spec,
    head_bytes_per_token,
    reference_decode,
)
from deeplearning4j_tpu_torch.generation import decode as D
from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry

SMALL_VOCAB = 31
CARRY_TOL = 1e-6


def _jax_model():
    from deeplearning4j_tpu.zoo.models import TextGenerationLSTM
    m = TextGenerationLSTM()
    m.lstm_units = 32
    m.vocab_size = SMALL_VOCAB
    m.timesteps = 8
    return m.init()


def _port_model(jm):
    from deeplearning4j_tpu_torch.models.serialization import \
        params_from_jax
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    tm = TextGenerationLSTM(vocab_size=SMALL_VOCAB, timesteps=8,
                            lstm_units=32).init(device="cpu")
    ts = jax.tree_util.tree_map(np.asarray, jm.train_state)
    params_from_jax(ts.params, ts.model_state, model=tm)
    return tm


@pytest.fixture(scope="module")
def jmodel():
    return _jax_model()


@pytest.fixture(scope="module")
def model(jmodel):
    return _port_model(jmodel)


@pytest.fixture(scope="module")
def engine(model):
    eng = GenerationEngine(model, max_slots=4,
                           registry=MetricsRegistry(),
                           session_id="gen-test")
    yield eng
    eng.shutdown()


# ---- decode parity ----------------------------------------------------


def test_greedy_parity_static(engine, model):
    prompts = [[1, 2, 3], [7, 11, 13, 17], [30]]
    refs = [reference_decode(model, p, 20) for p in prompts]
    streams = [engine.submit(p, max_new_tokens=20, greedy=True)
               for p in prompts]
    for s, ref in zip(streams, refs):
        assert s.result(timeout=60)["ids"] == ref


def test_greedy_parity_staggered_join_leave(engine, model):
    rng = random.Random(99)
    cfgs = [([rng.randrange(SMALL_VOCAB)
              for _ in range(rng.randrange(2, 7))],
             rng.randrange(10, 30)) for _ in range(8)]
    refs = [reference_decode(model, p, m) for p, m in cfgs]
    streams = []
    for i, (p, m) in enumerate(cfgs):
        streams.append(engine.submit(p, max_new_tokens=m, greedy=True))
        if i >= 4:          # first burst fills the 4 slots; the rest
            time.sleep(0.002)       # join as retirements free slots
    for i, (s, ref) in enumerate(zip(streams, refs)):
        assert s.result(timeout=60)["ids"] == ref, f"sequence {i}"
    assert engine.stats()["slots"]["max_active"] >= 2


def test_bucket_jump_no_live_compile(model):
    """A demand burst jumps the bucket several ladder rungs at once
    (1 -> 8); the warmup sweep must have covered that resize."""
    eng = GenerationEngine(model, max_slots=8,
                           registry=MetricsRegistry(),
                           session_id="gen-jump")
    try:
        streams = [eng.submit([i % SMALL_VOCAB], max_new_tokens=12)
                   for i in range(8)]
        for s in streams:
            s.result(timeout=60)
        eng.assert_warm()
    finally:
        eng.shutdown()


def test_seeded_sampling_reproducible(engine):
    kw = dict(greedy=False, temperature=0.8, top_k=10,
              max_new_tokens=24)
    a = engine.generate([3, 1, 4], seed=7, **kw)
    b = engine.generate([3, 1, 4], seed=7, **kw)
    c = engine.generate([3, 1, 4], seed=8, **kw)
    assert a["ids"] == b["ids"]
    assert a["ids"] != c["ids"]


def test_sampled_stream_does_not_depend_on_its_bucket(model):
    """A slot's stream depends only on its seed and its position: alone
    at bucket 1 and among three co-residents at bucket 4 it is the same,
    bit for bit (the tick's products run at a fixed row count)."""
    eng = GenerationEngine(model, max_slots=4, stop_text=None,
                           registry=MetricsRegistry(),
                           session_id="gen-bucket")
    try:
        kw = dict(greedy=False, temperature=0.8, top_k=10, seed=3,
                  max_new_tokens=40)
        alone = eng.submit([1, 2, 3], **kw).result(timeout=60)["ids"]
        others = [eng.submit([j], greedy=False, seed=j, max_new_tokens=60)
                  for j in range(3)]
        crowd = eng.submit([1, 2, 3], **kw).result(timeout=60)["ids"]
        for s in others:
            s.result(timeout=60)
        assert eng.stats()["slots"]["max_active"] == 4
        assert alone == crowd
    finally:
        eng.shutdown()


def test_concurrent_submitters_stress(model):
    """More client threads than cores submit and cancel at once, with a
    short switch interval: every uncancelled stream equals its
    reference, every stream ends, and the engine's counts add up."""
    import sys
    import threading
    rng = random.Random(5)
    cfgs = [([rng.randrange(SMALL_VOCAB) for _ in range(3)],
             rng.randrange(4, 12)) for _ in range(12)]
    refs = [reference_decode(model, p, m) for p, m in cfgs]
    eng = GenerationEngine(model, max_slots=4, registry=MetricsRegistry(),
                           session_id="gen-stress")
    got, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(t):
        try:
            for rep in range(2):
                i = (t + rep) % len(cfgs)
                s = eng.submit(cfgs[i][0], max_new_tokens=cfgs[i][1])
                if (t + rep) % 5 == 0:
                    eng.cancel(s)
                    s.result(timeout=60)
                else:
                    got[(t, rep)] = (i, s.result(timeout=60)["ids"])
        except Exception as e:          # surfaced below, with the thread
            errors.append((t, e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(24)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        eng.shutdown()
    assert not errors, errors
    for i, ids in got.values():
        assert ids == refs[i]
    st = eng.stats()
    assert st["sequences"]["submitted"] == 48
    assert sum(st["sequences"]["retired"].values()) == 48
    assert st["tokens"]["generated"] >= sum(len(ids)
                                            for _, ids in got.values())


# ---- retirement -------------------------------------------------------


def test_stop_token_retirement(engine, model):
    prompt = [5, 9]
    free = reference_decode(model, prompt, 30)
    stop = free[3]      # a token greedy decode actually produces
    ref = reference_decode(model, prompt, 30, stop_id=stop)
    res = engine.generate(prompt, max_new_tokens=30, stop=int(stop))
    assert res["reason"] == "stop"
    assert res["ids"] == ref
    assert res["ids"][-1] == stop


def test_max_length_retirement(engine):
    res = engine.generate([2], max_new_tokens=9)
    assert res["reason"] == "length"
    assert len(res["ids"]) == 9
    assert res["ttft_ms"] is not None and res["ttft_ms"] >= 0.0


def test_invalid_prompt_rejected(engine):
    with pytest.raises(ValueError):
        engine.submit([SMALL_VOCAB + 5])


def test_engine_warm_after_traffic(engine):
    engine.assert_warm()
    st = engine.stats()
    assert st["recompiles_after_warmup"] == 0
    assert st["tokens"]["generated"] > 0
    assert st["device"] == "cpu"


# ---- int8 head gate ----------------------------------------------------


def test_int8_gate_mechanism(model):
    from deeplearning4j_tpu_torch.evaluation.quant_gate import \
        QuantGateError
    spec = extract_decode_spec(model)
    probe = list(range(10))
    x_scale, result = D.int8_head_gate(model, spec, probe,
                                       top1_budget=1.0)
    assert x_scale > 0.0
    assert result.passed
    assert 0.0 <= result.top1_agreement <= 1.0
    with pytest.raises(QuantGateError):
        # impossible budget: the gate must refuse, not clamp
        D.int8_head_gate(model, spec, probe, top1_budget=-0.1)


def test_int8_engine_decodes(model):
    eng = GenerationEngine(model, max_slots=2, precision="int8",
                           int8_budget=1.0,
                           registry=MetricsRegistry(),
                           session_id="gen-int8")
    try:
        res = eng.generate([1, 2], max_new_tokens=12)
        assert len(res["ids"]) == 12
        assert eng.stats()["head_agreement"] is not None
        eng.assert_warm()
    finally:
        eng.shutdown()


def test_head_bytes_per_token_ordering(model):
    spec = extract_decode_spec(model)
    h = spec.hidden_sizes[-1]
    f32 = head_bytes_per_token(spec, h, "f32")
    bf16 = head_bytes_per_token(spec, h, "bf16")
    int8 = head_bytes_per_token(spec, h, "int8")
    assert int8 < bf16 < f32


# ---- vocab -------------------------------------------------------------


def test_vocab_identity_and_committed():
    v = Vocab.identity(5)
    assert v.decode([0, 4]) == "��"
    assert v.encode("ab") == [0, 0]
    committed = Vocab.load()
    text = "the quick fox"
    assert committed.decode(committed.encode(text)) == text


# ---- the port's own rules ----------------------------------------------


def test_engine_refuses_a_tuned_config_and_a_foreign_store(model):
    from deeplearning4j_tpu_torch.generation import SessionStore
    with pytest.raises(NotImplementedError, match="item 16"):
        GenerationEngine(model, tuned_config=object(),
                         registry=MetricsRegistry())
    spec = extract_decode_spec(model)
    store = SessionStore(spec, registry=MetricsRegistry(), device="cpu")
    store.device = torch.device("meta")
    with pytest.raises(ValueError, match="device tier"):
        GenerationEngine(model, session_store=store,
                         registry=MetricsRegistry())


def test_engine_raises_without_a_card(monkeypatch):
    """An engine over a model that names the card, and a session store
    left on its default device, raise without one."""
    from deeplearning4j_tpu_torch.generation import SessionStore
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    m = TextGenerationLSTM(vocab_size=5, timesteps=4,
                           lstm_units=3).init(device="cpu")
    m.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(m, registry=MetricsRegistry())
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionStore(extract_decode_spec(m))


def test_rows_do_not_depend_on_the_row_count():
    """``_mm`` gives each row the same bits at every row count (the CPU's
    own matmul does not: one row takes a gemv)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((20, 32), generator=g)
    w = torch.randn((32, 128), generator=g)
    full = D._mm(x, w)
    for s in (1, 2, 3, 8, 9, 17):
        assert torch.equal(D._mm(x[:s], w), full[:s])


def _np_mix32(x):
    m = np.uint64(0xFFFFFFFF)
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & m
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & m
    return x ^ (x >> np.uint64(16))


def _np_hash2(k0, k1, ctr):
    """The key hash in plain numpy uint64 arithmetic (whole products,
    then masks): the twin the port's 16-bit-half version must equal."""
    m = np.uint64(0xFFFFFFFF)
    with np.errstate(over="ignore"):
        ctr = np.asarray(ctr, np.uint64)
        a = _np_mix32((k0 + ((ctr + np.uint64(1)) * np.uint64(0x9E3779B9)
                             & m)) & m)
        b = _np_mix32(k1 ^ a ^ np.uint64(0x632BE5AB))
        a = _np_mix32(a ^ ((b + np.uint64(0x85EBCA6B)) & m))
    return a, b


def test_key_hash_matches_its_numpy_uint64_twin():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        np.array([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                  0xFFFFFFFE, 0xFFFFFFFF], np.uint64),
        rng.integers(0, 1 << 32, 4096, dtype=np.uint64)])
    k0, k1 = words, np.roll(words, 7)
    for ctr in (0, 1, 76, 0xFFFFFFFE):
        a, b = D._hash2(torch.from_numpy(k0.astype(np.int64)),
                        torch.from_numpy(k1.astype(np.int64)), ctr)
        na, nb = _np_hash2(k0, k1, ctr)
        np.testing.assert_array_equal(a.numpy().astype(np.uint64), na)
        np.testing.assert_array_equal(b.numpy().astype(np.uint64), nb)
        assert int(a.max()) <= 0xFFFFFFFF and int(a.min()) >= 0
    x = torch.from_numpy(words.astype(np.int64))
    np.testing.assert_array_equal(
        D._mul32(x, 0x846CA68B).numpy().astype(np.uint64),
        (words * np.uint64(0x846CA68B)) & np.uint64(0xFFFFFFFF))


def test_key_contract():
    """A reset key is (0, seed); a split gives two keys that differ from
    each other and from the parent; the Gumbel noise of a key depends on
    that key alone (not on the other rows) and spans (0, 1)'s
    transform."""
    seeds = torch.tensor([0, 7, 0xFFFFFFFF], dtype=torch.int64)
    keys = D._fresh_keys(seeds)
    assert keys.tolist() == [[0, 0], [0, 7], [0, 0xFFFFFFFF]]
    carry, sample = D._split(keys)
    assert not torch.equal(carry, sample) and not torch.equal(carry, keys)
    g = D._gumbel(sample, SMALL_VOCAB)
    assert torch.equal(D._gumbel(sample[1:2], SMALL_VOCAB), g[1:2])
    assert torch.isfinite(g).all()
    many = D._gumbel(D._split(D._fresh_keys(torch.arange(4096)))[1], 4)
    assert abs(many.mean().item() - 0.5772) < 0.02     # Euler-Mascheroni


# ---- parity with the JAX package ---------------------------------------


def _tick_inputs(S=5, seed=0):
    rng = np.random.default_rng(seed)
    h = [rng.uniform(-1, 1, (S, 32)).astype(np.float32) for _ in range(2)]
    c = [rng.uniform(-3, 3, (S, 32)).astype(np.float32) for _ in range(2)]
    ctl = dict(tokens=rng.integers(0, SMALL_VOCAB, S).astype(np.int32),
               reset=np.array([True, False, False, True, False][:S]),
               seeds=rng.integers(0, 1 << 31, S).astype(np.uint32),
               active=np.array([True, True, False, True, True][:S]))
    return h, c, ctl


def _port(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                            else a)


def test_tick_matches_jax(model, jmodel):
    from deeplearning4j_tpu.generation import decode as JD
    S = 5
    h, c, ctl = _tick_inputs(S)
    samp = (np.ones(S, np.float32), np.zeros(S, np.int32),
            np.ones(S, bool))
    jspec = JD.extract_decode_spec(jmodel)
    jtick = jax.jit(JD.build_tick(jmodel, jspec))
    jh, jc, _, jtok = jtick(
        JD.commit_decode_params(jmodel, jspec, "f32"), h, c,
        np.zeros((S, 2), np.uint32), ctl["tokens"], ctl["reset"],
        ctl["seeds"], ctl["active"], *samp, np.zeros((S, 2), np.uint32),
        np.zeros(S, bool))
    spec = extract_decode_spec(model)
    th, tc, _, ttok = D.build_tick(model, spec)(
        D.commit_decode_params(model, spec, "f32"),
        [_port(x) for x in h], [_port(x) for x in c],
        torch.zeros((S, 2), dtype=torch.int64),
        *map(_port, (ctl["tokens"], ctl["reset"], ctl["seeds"],
                     ctl["active"], *samp, np.zeros((S, 2), np.uint32),
                     np.zeros(S, bool))))
    for a, b in zip(th + tc, list(jh) + list(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=CARRY_TOL)
    assert ttok.tolist() == np.asarray(jtok).tolist()


def test_prefill_carries_match_jax(model, jmodel):
    from deeplearning4j_tpu.generation import decode as JD
    S, C = 5, 8
    h, c, ctl = _tick_inputs(S, seed=1)
    rng = np.random.default_rng(2)
    chunk = rng.integers(0, SMALL_VOCAB, (S, C)).astype(np.int32)
    lens = np.array([8, 3, 5, 0, 1], np.int32)
    args = (chunk, lens, ctl["reset"], ctl["seeds"], ctl["active"])
    jspec = JD.extract_decode_spec(jmodel)
    jh, jc, _ = jax.jit(JD.build_prefill(jmodel, jspec))(
        JD.commit_decode_params(jmodel, jspec, "f32"), h, c,
        np.zeros((S, 2), np.uint32), *args)
    spec = extract_decode_spec(model)
    th, tc, _ = D.build_prefill(model, spec)(
        D.commit_decode_params(model, spec, "f32"),
        [_port(x) for x in h], [_port(x) for x in c],
        torch.zeros((S, 2), dtype=torch.int64), *map(_port, args))
    for a, b in zip(th + tc, list(jh) + list(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=CARRY_TOL)


def test_spec_tick_matches_jax(model, jmodel):
    """Greedy verify: the per-position tokens (``emitted``) and the
    commit counts (``n_emit``) equal the JAX package's, with drafts that
    the model accepts in full on some rows and not on others."""
    from deeplearning4j_tpu.generation import decode as JD
    from deeplearning4j_tpu.generation.speculative import \
        build_spec_tick as jbuild
    from deeplearning4j_tpu_torch.generation.speculative import \
        build_spec_tick
    S, k = 5, 3
    h, c, ctl = _tick_inputs(S, seed=3)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, SMALL_VOCAB, (S, k + 1)).astype(np.int32)
    toks[:, 0] = ctl["tokens"]
    n_draft = np.array([3, 2, 3, 0, 1], np.int32)
    jspec = JD.extract_decode_spec(jmodel)
    jdp = JD.commit_decode_params(jmodel, jspec, "f32")
    jfn = jax.jit(jbuild(jmodel, jspec, k))
    tail = (ctl["reset"], ctl["seeds"], ctl["active"],
            np.ones(S, np.float32), np.zeros(S, np.int32),
            np.ones(S, bool), np.zeros((S, k + 1, 2), np.uint32),
            np.zeros(S, bool))
    zr = np.zeros((S, 2), np.uint32)
    for j in range(k):                    # rows 0-1: drafts it accepts
        got = np.asarray(jfn(jdp, h, c, zr, toks, n_draft, *tail)[3])
        toks[:2, j + 1] = got[:2, j]
    _, _, _, jem, jne = jfn(jdp, h, c, zr, toks, n_draft, *tail)
    spec = extract_decode_spec(model)
    _, _, _, tem, tne = build_spec_tick(model, spec, k)(
        D.commit_decode_params(model, spec, "f32"),
        [_port(x) for x in h], [_port(x) for x in c],
        torch.zeros((S, 2), dtype=torch.int64),
        *map(_port, (toks, n_draft) + tail))
    assert tem.tolist() == np.asarray(jem).tolist()
    assert tne.tolist() == np.asarray(jne).tolist()
    assert tne[0] == 4 and tne[2] == 0    # a full accept; an idle slot


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_head_bytes_per_token_matches_jax(model, jmodel, precision):
    from deeplearning4j_tpu.generation import decode as JD
    spec, jspec = extract_decode_spec(model), JD.extract_decode_spec(jmodel)
    assert spec == D.DecodeSpec(*jspec.__dict__.values())
    assert head_bytes_per_token(spec, 32, precision) == \
        JD.head_bytes_per_token(jspec, 32, precision)


def test_quantize_weight_and_rows_match_jax():
    from deeplearning4j_tpu.ops import quantize as JQ
    from deeplearning4j_tpu_torch.ops import quantize as TQ
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.2, (48, 31)).astype(np.float32)
    w[:, 3] = 0.0                                   # a dead channel
    for a, b in zip(TQ.quantize_weight(w, reduce_axes=(0,)),
                    JQ.quantize_weight(w, reduce_axes=(0,))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    x = rng.normal(0, 1, (9, 40)).astype(np.float32)
    x[2] = 0.0                                      # a dead row
    for a, b in zip(TQ.quantize_rows(x), JQ.quantize_rows(x)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert TQ.activation_scale(0.73) == JQ.activation_scale(0.73)
    assert TQ.Q_MAX == JQ.Q_MAX


def test_int8_dot_matches_jax():
    from deeplearning4j_tpu.ops import quantize as JQ
    from deeplearning4j_tpu_torch.ops import quantize as TQ
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (7, 32)).astype(np.float32)
    x[0, :4] = np.array([0.5, -0.5, 1.5, 2.5]) / 127   # half-even ties
    w_q, w_s = TQ.quantize_weight(rng.normal(0, 0.2, (32, 31))
                                  .astype(np.float32), reduce_axes=(0,))
    xs = TQ.activation_scale(1.0)
    jq = np.asarray(JQ.quantize_act(jnp.asarray(x), jnp.float32(xs)))
    tq = TQ.quantize_act(torch.from_numpy(x), torch.tensor(xs)).numpy()
    assert np.array_equal(tq, jq)
    acc = (torch.from_numpy(tq).float() @ torch.from_numpy(w_q).float())
    exact = tq.astype(np.int64) @ w_q.astype(np.int64)
    assert np.array_equal(acc.numpy().astype(np.int64), exact)
    got = TQ.int8_dot(torch.from_numpy(x), torch.from_numpy(w_q),
                      torch.from_numpy(w_s), torch.tensor(xs)).numpy()
    want = np.asarray(JQ.int8_dot(jnp.asarray(x), jnp.asarray(w_q),
                                  jnp.asarray(w_s), jnp.float32(xs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # past the f32 route's exact width (1040) the port sums exact chunks
    # in int32, as JAX's int32 accumulator does: bitwise equal
    xk = rng.uniform(-1, 1, (3, 1041)).astype(np.float32)
    wk, sk = TQ.quantize_weight(rng.normal(0, 0.2, (1041, 2))
                                .astype(np.float32))
    got = TQ.int8_dot(torch.from_numpy(xk), torch.from_numpy(wk),
                      torch.from_numpy(sk), torch.tensor(xs)).numpy()
    want = np.asarray(JQ.int8_dot(jnp.asarray(xk), jnp.asarray(wk),
                                  jnp.asarray(sk), jnp.float32(xs)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["plain", "chunked", "speculative"])
def test_engine_greedy_streams_match_jax(model, jmodel, mode):
    """Staggered greedy prompts at 4 slots through the port's engine and
    the JAX package's: the same tokens and the same retirement outcomes
    (a stop token the model produces retires some streams early)."""
    from deeplearning4j_tpu.generation import GenerationEngine as JEngine
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    kw = {"plain": {}, "chunked": {"prefill_chunk": 8},
          "speculative": {"speculative": 3}}[mode]
    rng = random.Random(7)
    cfgs = [([rng.randrange(SMALL_VOCAB)
              for _ in range(rng.randrange(2, 20))],
             rng.randrange(8, 28)) for _ in range(8)]
    stop = reference_decode(model, [5, 9], 8)[4]
    results = []
    for make in (lambda: GenerationEngine(model, max_slots=4,
                                          registry=MetricsRegistry(),
                                          session_id=f"par-{mode}", **kw),
                 lambda: JEngine(jmodel, max_slots=4, registry=JRegistry(),
                                 session_id=f"par-{mode}", **kw)):
        eng = make()
        try:
            streams = []
            for i, (p, m) in enumerate(cfgs):
                streams.append(eng.submit(p, max_new_tokens=m, stop=stop))
                if i >= 4:
                    time.sleep(0.002)
            results.append([s.result(timeout=120) for s in streams])
            eng.assert_warm()
        finally:
            eng.shutdown()
    port, ref = results
    assert [r["ids"] for r in port] == [r["ids"] for r in ref]
    assert [r["reason"] for r in port] == [r["reason"] for r in ref]
    assert {r["reason"] for r in port} == {"stop", "length"}


# ---- GravesLSTM cores ---------------------------------------------------


def _graves_jax_model():
    """2 x GravesLSTM(32) under the dense head, one-hot over the small
    vocab; peepholes drawn from a seed (they initialize to zero)."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu.nn.layers.recurrent import GravesLSTM
    conf = (NeuralNetConfiguration.Builder().seed(123).list()
            .layer(GravesLSTM(n_out=32)).layer(GravesLSTM(n_out=32))
            .layer(RnnOutputLayer(n_out=SMALL_VOCAB))
            .set_input_type(InputType.recurrent(SMALL_VOCAB)).build())
    jm = JMLN(conf).init()
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map(np.asarray, jm.train_state.params)
    for name in ("layer_0", "layer_1"):
        for k in ("pI", "pF", "pO"):
            params[name][k] = rng.uniform(-0.5, 0.5, 32).astype(np.float32)
    jm.train_state = jm.train_state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    return jm


@pytest.fixture(scope="module")
def graves(request):
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serialization import (
        _ensure_registry, params_from_jax)
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    _ensure_registry()
    jm = _graves_jax_model()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jm.conf.to_json()), device="cpu").init()
    ts = jax.tree_util.tree_map(np.asarray, jm.train_state)
    params_from_jax(ts.params, ts.model_state, model=tm)
    return jm, tm


def test_graves_spec_and_tick_match_jax(graves):
    from deeplearning4j_tpu.generation import decode as JD
    from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
    jm, tm = graves
    spec = extract_decode_spec(tm)
    assert spec.lstm_names == ("layer_0", "layer_1")
    assert all(isinstance(c, GravesLSTM) for c in D._lstm_cores(tm, spec))
    dp = D.commit_decode_params(tm, spec, "f32")
    assert {"pI", "pF", "pO"} <= set(dp["lstm"][0])
    S = 5
    h, c, ctl = _tick_inputs(S, seed=3)
    samp = (np.ones(S, np.float32), np.zeros(S, np.int32),
            np.ones(S, bool))
    jspec = JD.extract_decode_spec(jm)
    jh, jc, _, jtok = jax.jit(JD.build_tick(jm, jspec))(
        JD.commit_decode_params(jm, jspec, "f32"), h, c,
        np.zeros((S, 2), np.uint32), ctl["tokens"], ctl["reset"],
        ctl["seeds"], ctl["active"], *samp, np.zeros((S, 2), np.uint32),
        np.zeros(S, bool))
    th, tc, _, ttok = D.build_tick(tm, spec)(
        dp, [_port(x) for x in h], [_port(x) for x in c],
        torch.zeros((S, 2), dtype=torch.int64),
        *map(_port, (ctl["tokens"], ctl["reset"], ctl["seeds"],
                     ctl["active"], *samp, np.zeros((S, 2), np.uint32),
                     np.zeros(S, bool))))
    for a, b in zip(th + tc, list(jh) + list(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=CARRY_TOL)
    assert ttok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("mode", ["plain", "chunked", "speculative"])
def test_graves_engine_greedy_streams_match_jax(graves, mode):
    """Greedy streams of a Graves-core model through the port's engine
    (tick, chunked prefill or speculative verify, each applying the
    peepholes) equal the JAX package's engine and ``reference_decode``."""
    from deeplearning4j_tpu.generation import GenerationEngine as JEngine
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    jm, tm = graves
    kw = {"plain": {}, "chunked": {"prefill_chunk": 8},
          "speculative": {"speculative": 3}}[mode]
    rng = random.Random(17)
    cfgs = [([rng.randrange(SMALL_VOCAB)
              for _ in range(rng.randrange(2, 20))],
             rng.randrange(8, 24)) for _ in range(6)]
    results = []
    for make in (lambda: GenerationEngine(tm, max_slots=4, stop_text=None,
                                          registry=MetricsRegistry(),
                                          session_id=f"graves-{mode}", **kw),
                 lambda: JEngine(jm, max_slots=4, stop_text=None,
                                 registry=JRegistry(),
                                 session_id=f"graves-{mode}", **kw)):
        eng = make()
        try:
            streams = [eng.submit(p, max_new_tokens=m, greedy=True)
                       for p, m in cfgs]
            results.append([s.result(timeout=120)["ids"] for s in streams])
            eng.assert_warm()
        finally:
            eng.shutdown()
    assert results[0] == results[1]
    assert results[0][:2] == [reference_decode(tm, p, m)
                              for p, m in cfgs[:2]]


def test_graves_sampled_stream_does_not_depend_on_its_bucket(graves):
    _, tm = graves
    eng = GenerationEngine(tm, max_slots=4, stop_text=None,
                           registry=MetricsRegistry(),
                           session_id="graves-bucket")
    try:
        kw = dict(greedy=False, temperature=0.8, top_k=10, seed=5,
                  max_new_tokens=40)
        alone = eng.submit([4, 2, 7], **kw).result(timeout=60)["ids"]
        others = [eng.submit([j], greedy=False, seed=j, max_new_tokens=60)
                  for j in range(3)]
        crowd = eng.submit([4, 2, 7], **kw).result(timeout=60)["ids"]
        for s in others:
            s.result(timeout=60)
        assert eng.stats()["slots"]["max_active"] == 4
        assert alone == crowd
    finally:
        eng.shutdown()
