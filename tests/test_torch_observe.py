"""The port's copies of the JAX package's small framework-neutral modules,
held against the originals: ``MetricsRegistry`` (the same exposition
text for the same calls), ``Deadline`` and the chaos ``parse_plan`` (the
same behaviour and replay signature for one seed), ``ArtifactStore``
(a put/get round trip of a session carry, quarantine of a corrupt
blob, and each package reading the other's objects), the splitmix64
mixer, the tunable defaults, ``GateResult`` and the recompile watchdog.
All comparisons are exact."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry


def _drive_registry(reg):
    c = reg.counter("dl4j_gen_tokens_total", "generated tokens streamed")
    g = reg.gauge("dl4j_gen_ttft_ms", "time-to-first-token quantiles")
    c.inc(0.0, session="a")
    c.inc(3.0, session="a")
    c.inc(1.5, session="b\n\"x\"")
    g.set(float("nan"), session="a", quantile="0.5")
    g.set(float("inf"), session="a", quantile="0.99")
    g.set(-2.25, session="b", quantile="0.5")
    reg.gauge("dl4j_plain").set(7)
    with pytest.raises(ValueError):
        c.inc(-1.0)
    with pytest.raises(TypeError):
        reg.gauge("dl4j_gen_tokens_total")
    with pytest.raises(ValueError):
        reg.counter("bad name")
    return reg.render(), c.get(session="a"), reg.get_metric("nope")


def test_registry_renders_what_the_jax_package_renders():
    from deeplearning4j_tpu.observe import registry as jreg
    from deeplearning4j_tpu_torch.observe import registry as treg
    mine = _drive_registry(treg.MetricsRegistry())
    theirs = _drive_registry(jreg.MetricsRegistry())
    assert mine == theirs
    assert "dl4j_gen_tokens_total{session=\"a\"} 3.0" in mine[0]
    assert treg.default_registry() is treg.default_registry()


class _Clock:
    """A deterministic clock: each call advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 100.0, list(steps)

    def __call__(self):
        if self.steps:
            self.t += self.steps.pop(0)
        return self.t


def _drive_deadline(mod, seed):
    rng = np.random.default_rng(seed)
    steps = rng.uniform(0, 0.02, 64).tolist()
    d = mod.Deadline.after_ms(150.0, clock=_Clock(steps))
    trace = []
    for cap in rng.uniform(0, 0.2, 24):
        trace.append((d.expired, round(d.cap_timeout(float(cap)), 12),
                      round(d.cap_timeout(None), 12)))
    try:
        d.check("late")
        trace.append("ok")
    except mod.DeadlineExceeded as e:
        trace.append(e.detail)
    parsed = [mod.Deadline.from_ingress(h, b, clock=lambda: 5.0)
              for h, b in (({"X-Deadline-Ms": "250"}, None),
                           ({"X-Deadline-Ms": "250"}, {"deadline_ms": 10}),
                           (None, {"deadline_ms": "nan"}),
                           (None, {"deadline_ms": -1}), (None, None),
                           ({"X-Deadline-Ms": "junk"}, None))]
    trace.append([None if p is None else p.t_end for p in parsed])
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_deadline_behaves_as_the_jax_package(seed):
    from deeplearning4j_tpu.parallel import deadline as jdl
    from deeplearning4j_tpu_torch.parallel import deadline as tdl
    assert _drive_deadline(tdl, seed) == _drive_deadline(jdl, seed)


PLAN = ("seed=42;store.save:corrupt(p=0.5,count=3);"
        "store.save:torn_write(after=2,p=0.3,arg=blob);"
        "remote.send:delay(p=0.25,ms=0);remote.clock:clock_skew(skew_ms=7)")


def _drive_plan(plan_mod, reg):
    plan = plan_mod.parse_plan(PLAN, registry=reg)
    save, send = plan.site("store.save"), plan.site("remote.send")
    clock = plan.site("remote.clock")
    out = []
    for i in range(40):
        data, inj = save.mangle(bytes(range(i % 7 + 3)),
                                arg="blob" if i % 2 else "manifest")
        out.append((data, None if inj is None else inj.kind))
        out.append(send.fail(arg=f"node-{i % 3}") is not None)
        out.append(clock.skew())
    assert plan.site("ui.request") is None
    return plan.replay_signature(), out, plan.injected(), reg.render()


def test_chaos_plan_replays_as_the_jax_package():
    from deeplearning4j_tpu.chaos import plan as jplan
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    from deeplearning4j_tpu_torch.chaos import plan as tplan
    mine = _drive_plan(tplan, MetricsRegistry())
    assert mine == _drive_plan(jplan, JRegistry())
    assert mine == _drive_plan(tplan, MetricsRegistry())    # replay
    assert len(mine[0]) > 0
    for bad in ("store.save", "x:nope", "x:delay(p=2)", "x:delay(q=1)"):
        with pytest.raises(ValueError):
            tplan.parse_plan(bad)


def test_chaos_site_arms_the_session_store(tmp_path):
    """An armed plan reaches the port's ``store.save`` seam: a corrupted
    carry blob is quarantined at load, never resumed."""
    from deeplearning4j_tpu_torch import chaos
    from deeplearning4j_tpu_torch.generation import (CarrySnapshot,
                                                     DecodeSpec,
                                                     SessionStore)
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    spec = DecodeSpec(("l0",), (4,), "out", 5)
    chaos.arm("seed=1;store.save:corrupt(count=1,arg=blob)",
              registry=MetricsRegistry())
    try:
        bad = SessionStore(spec, store=ArtifactStore(str(tmp_path)),
                           registry=MetricsRegistry(), device="cpu")
    finally:
        chaos.disarm()
    bad.save("s", CarrySnapshot([np.ones(4, np.float32)],
                                [np.ones(4, np.float32)],
                                np.zeros(2, np.uint32), [1], 1, [1]))
    fresh = SessionStore(spec, store=ArtifactStore(str(tmp_path)),
                         registry=MetricsRegistry(), device="cpu")
    assert fresh.load("s") is None
    assert fresh.stats()["quarantined"] == 1


def test_artifact_store_round_trip_and_quarantine(tmp_path):
    """A session carry put through the port's ``ArtifactStore`` comes
    back from a second store on the same root; the JAX package's store
    reads the same objects and the port reads the JAX package's; a
    flipped byte quarantines the blob."""
    from deeplearning4j_tpu.generation import SessionStore as JStore
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    from deeplearning4j_tpu.parallel.aot_cache import \
        ArtifactStore as JArtifacts
    from deeplearning4j_tpu_torch.generation import (CarrySnapshot,
                                                     DecodeSpec,
                                                     SessionStore)
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    spec = DecodeSpec(("l0", "l1"), (6, 3), "out", 5)
    r = np.random.RandomState(2)
    snap = CarrySnapshot([r.randn(6).astype(np.float32),
                          r.randn(3).astype(np.float32)],
                         [r.randn(6).astype(np.float32),
                          r.randn(3).astype(np.float32)],
                         np.array([9, 10], np.uint32), [4, 1], 12, [3, 4])
    art = ArtifactStore(str(tmp_path))
    SessionStore(spec, store=art, registry=MetricsRegistry(),
                 device="cpu").save("tok", snap)
    JStore(spec, store=JArtifacts(str(tmp_path)),
           registry=JRegistry()).save("jax-tok", snap)
    assert art.keys() == JArtifacts(str(tmp_path)).keys() == [
        "gen-session-jax-tok", "gen-session-tok"]
    assert art.stats() == JArtifacts(str(tmp_path)).stats()
    assert art.manifest("gen-session-tok") is None      # not an AOT entry
    readers = (SessionStore(spec, store=ArtifactStore(str(tmp_path)),
                            registry=MetricsRegistry(), device="cpu"),
               JStore(spec, store=JArtifacts(str(tmp_path)),
                      registry=JRegistry()))
    for reader in readers:
        for tok in ("tok", "jax-tok"):
            got = reader.load(tok)
            for x, y in zip(got.h + got.c, snap.h + snap.c):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(got.rng, snap.rng)
            assert (got.pending, got.pos, got.history) == (
                snap.pending, snap.pos, snap.history)
    blob = tmp_path / "objects" / "gen-session-tok" / "carry.npz"
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 3] ^= 0xFF
    blob.write_bytes(bytes(raw))
    late = SessionStore(spec, store=ArtifactStore(str(tmp_path)),
                        registry=MetricsRegistry(), device="cpu")
    assert late.load("tok") is None
    assert late.stats()["quarantined"] == 1
    assert (blob.parent / "carry.npz.quarantine").exists()
    with pytest.raises(ValueError):
        art.cache_dir("..")


def test_splitmix_constants_and_mixer_match_jax():
    from deeplearning4j_tpu.nlp import pairgen as jpg
    from deeplearning4j_tpu_torch.nlp import pairgen as tpg
    assert (tpg.GOLDEN, tpg.M1, tpg.M2) == (jpg.GOLDEN, jpg.M1, jpg.M2)
    z = np.random.default_rng(0).integers(0, 1 << 63, 512,
                                          dtype=np.uint64)
    assert np.array_equal(tpg._mix_np(z.copy()), jpg._mix_np(z.copy()))


def test_tunable_defaults_and_precedence_match_jax():
    from deeplearning4j_tpu.optimize import autotune as jat
    from deeplearning4j_tpu_torch.optimize import autotune as tat
    assert set(tat.REGISTRY) == set(jat.REGISTRY)
    for name in jat.REGISTRY:
        assert tat.REGISTRY[name] == tat.Tunable(
            **jat.REGISTRY[name].__dict__)
        assert tat.resolve_tuned(None, None, name) == \
            jat.resolve_tuned(None, None, name)
        assert tat.resolve_tuned(5, None, name) == 5
        assert tat.resolve_tuned(5, tat.TunedConfig({name: 7}), name) == 5
        assert tat.resolve_tuned(None, tat.TunedConfig({name: 7}),
                                 name) == 7


def test_gate_result_matches_jax():
    from deeplearning4j_tpu.evaluation import quant_gate as jqg
    from deeplearning4j_tpu_torch.evaluation import quant_gate as tqg
    kw = dict(model="m", n_examples=3, n_positions=9, top1_agreement=0.9,
              top1_delta=0.1, max_logit_delta=0.2, mean_logit_delta=0.05,
              top1_budget=0.03, logit_budget=None,
              layer_errors={"h": 0.01}, fallback=[], passed=False)
    mine, theirs = tqg.GateResult(**kw), jqg.GateResult(**kw)
    assert mine.summary() == theirs.summary()
    assert str(tqg.QuantGateError(mine)) == str(jqg.QuantGateError(theirs))
    assert tqg.QuantGateError(mine).result is mine


def test_recompile_watchdog_counts_as_the_jax_package():
    """The same dispatches (numpy arguments, as the engines observe)
    give the same counts and events in both; the port's signature also
    reads tensors, nested lists and dicts, with their devices."""
    from deeplearning4j_tpu.observe.recompile import \
        RecompileWatchdog as JDog
    from deeplearning4j_tpu.observe.registry import \
        MetricsRegistry as JRegistry
    from deeplearning4j_tpu_torch.observe.recompile import (
        RecompileWatchdog, signature_of)
    dogs = (RecompileWatchdog(MetricsRegistry(), session_id="w"),
            JDog(JRegistry(), session_id="w"))
    calls = [("tick", (np.zeros(4, np.int32), np.ones(4, bool))),
             ("tick", (np.zeros(4, np.int32), np.ones(4, bool))),
             ("tick", (np.zeros(8, np.int32), np.ones(8, bool))),
             ("prefill", (np.zeros((4, 8), np.int32), 3)),
             ("prefill", (np.zeros((4, 8), np.int32), 4)),
             ("tick", (np.zeros(4, np.int64), np.ones(4, bool)))]
    for dog in dogs:
        assert [dog.observe(k, *a) for k, a in calls] == [
            True, False, True, True, True, True]
    assert [d.count() for d in dogs] == [3, 3]
    assert dogs[0].count("tick") == dogs[1].count("tick") == 2
    assert dogs[0].registry.render() == dogs[1].registry.render()
    a = signature_of([torch.zeros(2, 3)], {"b": torch.zeros(1), "a": None})
    assert a == signature_of([torch.ones(2, 3)],
                             {"a": None, "b": torch.ones(1)})
    assert a != signature_of([torch.zeros(2, 3, dtype=torch.float64)],
                             {"b": torch.zeros(1), "a": None})
    assert a != signature_of((torch.zeros(2, 3),),
                             {"b": torch.zeros(1), "a": None})
    assert a[1][0] == ((2, 3), "torch.float32", "cpu")
