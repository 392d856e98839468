"""The data-parallel tier's pieces against the JAX package, in one process:
the compression codecs bit for bit on seeded arrays, the mesh arithmetic
and its errors, sharded checkpoints in both directions (format 2 and the
legacy format 1, a partial checkpoint, a shape mismatch, the emergency
save), the collective watchdog's classification on an injected clock
with the JAX package's marker and dump fields, the YOLO2 decode check of
chip_smoke.py (``decodes_agree``), MagicQueue, and the wrapper and the
training masters at one worker (no process group: every collective is the
identity, so the steps are the plain ``fit`` steps bitwise)."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.parallel.checkpoint as JK
import deeplearning4j_tpu.parallel.cluster as JCl
import deeplearning4j_tpu.parallel.compression as JC
import deeplearning4j_tpu.parallel.mesh as JM
import deeplearning4j_tpu_torch.parallel.checkpoint as TK
import deeplearning4j_tpu_torch.parallel.cluster as TCl
import deeplearning4j_tpu_torch.parallel.compression as TC
import deeplearning4j_tpu_torch.parallel.mesh as TM
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.solver import TrainState as JTS
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (
    flatten_paths, opt_state_from_jax, params_from_jax)
from deeplearning4j_tpu_torch.optimize.solver import TrainState
from deeplearning4j_tpu_torch.parallel.wrapper import (ParallelWrapper,
                                                       TrainingMode)
import torch_parallel_workers as tpw
from test_torch_parallel_modes import _mlp

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_default_registries():
    """Both packages' process-wide registries as they were before each
    test (``torch_parallel_workers.registries_restored``)."""
    from deeplearning4j_tpu.observe.registry import default_registry as jr
    from deeplearning4j_tpu_torch.observe.registry import \
        default_registry as tr
    with tpw.registries_restored(jr(), tr()):
        yield


# ---- compression -------------------------------------------------------------

def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"W": (rng.normal(size=(5, 7)) * 2e-3).astype(np.float32),
                  "b": (rng.normal(size=(37,)) * 2e-3).astype(np.float32)},
            "c": {"W": (rng.normal(size=(3, 4, 5)) * 2e-3).astype(
                np.float32)}}


def _leaves(tree):
    return [np.asarray(v) for v in flatten_paths(tree).values()]


def test_quantize_matches_jax_bit_for_bit():
    g, r = _grads(0), _grads(1)
    t = 1e-3
    for (gj, rj), (gt, rt) in zip(
            zip(_leaves(g), _leaves(r)), zip(_leaves(g), _leaves(r))):
        sj, resj = JC.quantize(jnp.asarray(gj), jnp.asarray(rj), t)
        st, rest = TC.quantize(torch.from_numpy(gt), torch.from_numpy(rt),
                               t)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(rest.numpy(), np.asarray(resj))
        np.testing.assert_array_equal(
            TC.dequantize(st, t).numpy(), np.asarray(JC.dequantize(sj, t)))
    sj, rj = JC.quantize_pytree(jax.tree_util.tree_map(jnp.asarray, g),
                                jax.tree_util.tree_map(jnp.asarray, r), t)
    st, rt = TC.quantize_pytree(
        {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in g.items()},
        {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in r.items()}, t)
    for a, b in zip(_leaves(st), _leaves(sj)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(rt), _leaves(rj)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("density", [0.01, 0.5])
def test_wire_codecs_match_jax_bit_for_bit(density):
    rng = np.random.default_rng(3)
    n = 1001
    signs = np.where(rng.random(n) < density,
                     rng.choice([-1, 1], n), 0).astype(np.int8)
    for fn in ("encode_flexible", "encode_bitmap", "encode"):
        mj = getattr(JC, fn)(signs)
        mt = getattr(TC, fn)(signs)
        np.testing.assert_array_equal(mt, mj, err_msg=fn)
        assert mt.dtype == mj.dtype
        np.testing.assert_array_equal(TC.decode(mj), signs)
        np.testing.assert_array_equal(JC.decode(mt), signs)
        np.testing.assert_array_equal(TC.decode(mj, (7, 143)),
                                      JC.decode(mt, (7, 143)))
        assert TC.compression_ratio(mt, n) == JC.compression_ratio(mj, n)
    np.testing.assert_array_equal(TC.encode(torch.from_numpy(signs)),
                                  JC.encode(signs))


def test_schedule_and_accumulator_match_jax():
    kw = dict(threshold=1e-3, step_delay=2, shake_frequency=3)
    sj, st = JC.ThresholdSchedule(**kw), TC.ThresholdSchedule(**kw)
    for density in (0.01, 0.01, 0.2, 0.01, 0.01, 0.01):
        assert st.current() == sj.current()
        sj.observe(density)
        st.observe(density)
        assert st.threshold == sj.threshold
    aj = JC.EncodedGradientsAccumulator(3, JC.ThresholdSchedule(**kw))
    at = TC.EncodedGradientsAccumulator(3, TC.ThresholdSchedule(**kw))
    for step in range(3):
        for wk in range(3):
            g = _grads(10 * step + wk)
            aj.store_update(wk, jax.tree_util.tree_map(jnp.asarray, g))
            at.store_update(wk, {k: {n: torch.from_numpy(v)
                                     for n, v in d.items()}
                                 for k, d in g.items()})
        for wk in range(3):
            uj, ut = aj.apply_updates(wk), at.apply_updates(wk)
            for a, b in zip(_leaves(ut), _leaves(uj)):
                np.testing.assert_array_equal(a, b)
    assert [s.threshold for s in at.schedules] == \
        [s.threshold for s in aj.schedules]


# ---- mesh and sharding --------------------------------------------------------

@pytest.mark.parametrize("axes", [
    None, {"data": -1, "model": 2}, {"data": 2, "model": -1, "seq": 2},
    {"data": 3}, {"data": -1, "model": -1}, {"data": -1, "model": 3},
    {"data": 4, "model": 4}])
def test_create_mesh_arithmetic_and_errors_match_jax(axes):
    def outcome(fn):
        try:
            return dict(fn().shape)
        except ValueError as e:
            return ("ValueError", str(e))
    want = outcome(lambda: JM.create_mesh(axes, jax.devices()))
    got = outcome(lambda: TM.create_mesh(axes, list(range(8))))
    assert got == want


def test_mesh_helpers_at_one_process():
    mesh = TM.create_mesh()
    assert mesh.shape == {"data": 1} and TM.local_device_count() == 1
    assert TM.global_device_value_range(3.5) == (3.5, 3.5)
    from deeplearning4j_tpu_torch.parallel.sharding import (
        REPLICATED, apply_shardings, batch_shardings, infer_param_shardings)
    tree = {"l": {"W": torch.zeros(2, 2)}}
    assert infer_param_shardings(tree, mesh) == {"l": {"W": REPLICATED}}
    assert apply_shardings(tree, None) is tree
    assert batch_shardings(TM.create_mesh({"data": 4}, range(4)),
                           index=2).rows(8) == slice(4, 6)
    with pytest.raises(ValueError, match="does not split evenly"):
        batch_shardings(TM.create_mesh({"data": 2}, range(2)),
                        index=0).rows(5)


def test_global_batch_stats_hold_only_in_the_thread_that_opened_them():
    """BN statistics are summed over the group only inside the wrapper's
    step and in its own thread: a model trained on another thread of the
    process (an online learner beside serving) keeps local statistics.
    Inside, a BN layer takes its moments from the group's sums: with a sum
    that doubles (two ranks holding the same rows) they are the local
    ones."""
    import threading
    from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
    from deeplearning4j_tpu_torch.nn.layers.normalization import \
        BatchNormalization
    from deeplearning4j_tpu_torch.ops import batch_stats
    seen = {}
    opened, release = threading.Event(), threading.Event()

    def other():
        opened.wait(10)
        seen["other"] = batch_stats.current()
        release.set()
    t = threading.Thread(target=other)
    t.start()
    with TM.global_batch_stats(2):
        seen["inside"] = batch_stats.current()
        opened.set()
        release.wait(10)
    t.join(10)
    assert seen["inside"].world == 2 and seen["other"] is None
    assert batch_stats.current() is None
    with TM.global_batch_stats(1):
        assert batch_stats.current() is None

    bn = BatchNormalization()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        1.0, 2.0, (6, 3, 3, 4)).astype(np.float32))
    params = {"gamma": torch.full((4,), 1.5), "beta": torch.full((4,), .2)}
    state = {"mean": torch.zeros(4), "var": torch.ones(4)}
    ctx = LayerContext(train=True)
    want, want_st = bn.apply(params, state, x, ctx)
    with batch_stats.summed(lambda v: v * 2, 2):
        got, got_st = bn.apply(params, state, x, ctx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    for k in want_st:
        np.testing.assert_allclose(got_st[k].numpy(), want_st[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_second_half_of_item_15_still_raises():
    """Of item 15's second half only serving with replicas > 1 still
    raises (tests/test_torch_serving.py pins it): the mesh, the sharding
    rules and the wrapper's tensor parallelism build now."""
    assert TM.create_3d_mesh(1, 1, 1).shape == {"data": 1, "model": 1,
                                                 "pipe": 1}
    from deeplearning4j_tpu_torch.parallel.sharding import \
        infer_param_shardings
    tree = {"l": {"W": torch.zeros(3, 4), "b": torch.zeros(4)}}
    assert infer_param_shardings(tree, TM.create_mesh(
        {"data": 4, "model": 2}, range(8))) == {"l": {"W": (None, "model"),
                                                     "b": ()}}
    with pytest.raises(ValueError, match="SHARED_GRADIENTS"):
        ParallelWrapper(None, mode=TrainingMode.AVERAGING,
                        tensor_parallel=True)


# ---- checkpoints -----------------------------------------------------------------

def _models(steps=1):
    """A JAX MLP (Adam: an integer count in its state) after ``steps``
    steps, and the port's model of the same configuration, initialized
    (other weights until restored)."""
    jm = JMLN(_mlp("deeplearning4j_tpu", "adam")).init()
    rng = np.random.default_rng(0)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    for _ in range(steps):
        jm.fit(JDataSet(x, y))
    tm = MultiLayerNetwork(_mlp("deeplearning4j_tpu_torch", "adam"),
                           device="cpu").init()
    return jm, tm


def _carry(jm, tm):
    """The port model given the JAX model's trees and iteration."""
    ts = jax.tree_util.tree_map(np.asarray, jm.train_state)
    params_from_jax(ts.params, ts.model_state, "cpu", model=tm)
    opt_state_from_jax(ts.opt_state, tm)
    tm.iteration = int(ts.iteration)


def _same(tm, jm):
    ts = jax.tree_util.tree_map(np.asarray, jm.train_state)
    for group in ("params", "model_state", "opt_state"):
        want = flatten_paths(getattr(ts, group))
        got = flatten_paths(getattr(tm, group))
        assert set(got) == set(want), group
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=f"{group}/{k}")
            assert got[k].dtype == torch.from_numpy(np.array(v)).dtype
    assert tm.iteration == int(ts.iteration)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jm, tm = _models(steps=2)
    path = JK.save_sharded(jm.train_state, str(tmp_path))
    assert TK.latest_checkpoint(str(tmp_path)) == path
    TK.restore_sharded(tm, path)
    _same(tm, jm)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jm, tm = _models(steps=3)
    _carry(jm, tm)
    path = TK.save_sharded(tm.train_state, str(tmp_path))
    assert os.path.basename(path) == "step_0000000003"
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["format"] == 2 and man["process_count"] == 1
    assert sorted(os.listdir(path)) == sorted(
        ["COMMITTED", "manifest.json"] + [
            f"{g}.proc0000.{e}" for g in ("params", "model_state",
                                          "opt_state")
            for e in ("npz", "idx.json")])
    back = JMLN(_mlp("deeplearning4j_tpu", "adam")).init()
    JK.restore_sharded(back, path)
    _same(tm, back)
    # a second save of a committed step is a no-op
    assert TK.save_sharded(tm.train_state, str(tmp_path)) == path


def test_bf16_leaves_use_the_jax_encoding(tmp_path):
    vals = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    jts = JTS({"l": {"W": jnp.asarray(vals, jnp.bfloat16)}}, {}, (),
              jnp.asarray(4, jnp.int32))
    jpath = JK.save_sharded(jts, str(tmp_path / "j"))
    tts = TrainState({"l": {"W": torch.from_numpy(vals).bfloat16()}}, {},
                     {}, 4)
    tpath = TK.save_sharded(tts, str(tmp_path / "t"))
    for p in (jpath, tpath):
        with open(os.path.join(p, "manifest.json")) as f:
            assert json.load(f)["dtypes"] == {"params/l/W": "bfloat16"}
    raw = [np.load(os.path.join(p, "params.proc0000.npz"))["l/W::0"]
           for p in (jpath, tpath)]
    assert raw[0].dtype == raw[1].dtype == np.uint16
    np.testing.assert_array_equal(raw[1], raw[0])


def _legacy(path, jm, drop=None, extra=None, reshape=None):
    """A format-1 checkpoint of ``jm`` written by hand: one
    ``{group}.npz`` a group, keyed by the JAX package's leaf paths."""
    os.makedirs(path)
    ts = jax.tree_util.tree_map(np.asarray, jm.train_state)
    for group in ("params", "model_state", "opt_state"):
        flat = {k: np.asarray(v)
                for k, v in JK._flatten(getattr(ts, group)).items()}
        if group == "params":
            flat.pop(drop, None)
            flat.update(extra or {})
            if reshape:
                flat[reshape] = flat[reshape].reshape(-1)
        np.savez(os.path.join(path, f"{group}.npz"), **flat)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"format": 1, "iteration": int(ts.iteration)}, f)
    return path


def test_legacy_format_1_restores_in_both(tmp_path):
    jm, tm = _models(steps=2)
    path = _legacy(str(tmp_path / "step_0000000002"), jm)
    TK.restore_sharded(tm, path)
    back = JMLN(_mlp("deeplearning4j_tpu", "adam")).init()
    JK.restore_sharded(back, path)
    _same(tm, back)
    _same(tm, jm)


def test_partial_extra_and_mismatched_checkpoints_as_in_jax(tmp_path):
    jm, tm = _models()
    back = JMLN(_mlp("deeplearning4j_tpu", "adam")).init()
    cases = [
        (dict(drop="layer_1/b"), KeyError, "missing params leaf"),
        (dict(reshape="layer_0/W"), ValueError, "has shape"),
    ]
    for i, (kw, exc, msg) in enumerate(cases):
        path = _legacy(str(tmp_path / f"c{i}"), jm, **kw)
        with pytest.raises(exc, match=msg):
            JK.restore_sharded(back, path)
        with pytest.raises(exc, match=msg):
            TK.restore_sharded(tm, path)
    path = _legacy(str(tmp_path / "extra"), jm,
                   extra={"gone/W": np.zeros(2, np.float32)})
    for restore, model in ((JK.restore_sharded, back),
                           (TK.restore_sharded, tm)):
        with pytest.warns(UserWarning, match="not used by this model"):
            restore(model, path)
    _same(tm, jm)


def test_emergency_save_is_complete_alone_and_restores(tmp_path):
    jm, tm = _models(steps=2)
    _carry(jm, tm)
    path = TK.save_sharded(tm.train_state, str(tmp_path), emergency=True)
    assert os.path.basename(path) == "step_0000000002.em0"
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["emergency"] == {"process_index": 0}
    assert man["process_count"] == 1
    assert TK.latest_checkpoint(str(tmp_path)) == path
    back = JMLN(_mlp("deeplearning4j_tpu", "adam")).init()
    JK.restore_sharded(back, path)
    _same(tm, back)


def test_elastic_trainer_saves_prunes_and_resumes(tmp_path):
    jm, tm = _models()
    d = str(tmp_path / "ck")
    rng = np.random.default_rng(5)
    data = [DataSet(rng.normal(size=(8, 4)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(5)]
    et = TK.ElasticTrainer(tm, d, checkpoint_every=2, keep_last=2)
    et.fit(ListDataSetIterator(data))
    steps = sorted(os.listdir(d))
    assert steps == ["step_0000000004", "step_0000000005"], steps
    fresh = MultiLayerNetwork(_mlp("deeplearning4j_tpu_torch", "adam"),
                              device="cpu").init()
    assert TK.ElasticTrainer(fresh, d).resume()
    assert fresh.iteration == 5
    for a, b in zip(flatten_paths(fresh.params).values(),
                    flatten_paths(tm.params).values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TK.ElasticTrainer(tm, d, keep_last=0)


# ---- the collective watchdog -----------------------------------------------------

class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _beat(hb, rank, t, iteration=0):
    with open(os.path.join(hb, f"hb_{rank}.json"), "w") as f:
        json.dump({"rank": rank, "time": t, "iteration": iteration}, f)


@pytest.mark.parametrize("age,dead,slow", [
    (None, 0.5, None), (0.49, 0.5, None), (0.5, 0.5, None),
    (0.51, 0.5, None), (1.99, 6.0, 2.0), (2.0, 6.0, 2.0), (6.0, 6.0, 2.0),
    (6.000001, 6.0, 2.0)])
def test_heartbeat_boundary_matches_jax(age, dead, slow):
    assert TCl.classify_heartbeat_age(age, dead, slow) == \
        JCl.classify_heartbeat_age(age, dead, slow)


def test_dead_peers_on_an_injected_clock(tmp_path):
    hb = str(tmp_path)
    clock = Clock()
    wd = TCl.CollectiveWatchdog(hb, rank=0, n_ranks=3, interval_s=0.01,
                                dead_after_s=2.0, exit_on_loss=False,
                                clock=clock, sleep=clock.sleep)
    _beat(hb, 1, clock.t - 2.0)          # exactly at the horizon: slow
    assert wd.dead_peers() == {2: None}  # rank 2 never beat: dead
    _beat(hb, 2, clock.t)
    clock.t += 1e-3                      # rank 1 strictly past: dead
    assert list(wd.dead_peers()) == [1]
    assert wd.dead_peers()[1] == pytest.approx(2.001)
    _beat(hb, 1, clock.t)                # a rejoiner overwrites its file
    assert wd.dead_peers() == {}


def _wait_for(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while not pred() and time.monotonic() < end:
        time.sleep(0.01)
    return pred()


def test_monitor_tells_a_straggler_from_a_lost_peer(tmp_path):
    """The in-flight window on the injected clock: past the deadline with
    the peer beating is a straggler (the deadline extends); the peer's
    heartbeat going stale is peer loss (no exit here)."""
    hb = str(tmp_path / "hb")
    clock = Clock()
    wd = TCl.CollectiveWatchdog(hb, rank=0, n_ranks=2, interval_s=0.01,
                                deadline_s=5.0, dead_after_s=2.0,
                                exit_on_loss=False, clock=clock,
                                sleep=clock.sleep,
                                checkpoint_dir=str(tmp_path / "ck"))
    events = []
    wd.on_peer_loss = events.append
    _beat(hb, 1, clock.t)
    wd.start()
    try:
        with wd.guard(iteration=9):
            clock.t += 6.0
            _beat(hb, 1, clock.t)
            assert _wait_for(lambda: wd.straggler_waits >= 1)
            assert wd.peer_loss_event is None
            clock.t += 3.0               # rank 1 stopped beating
            assert _wait_for(lambda: wd.peer_loss_event is not None)
    finally:
        wd.stop()
    ev = wd.peer_loss_event
    assert ev["dead_ranks"] == [1] and ev["iteration"] == 9
    assert ev["heartbeat_age_s"]["1"] == pytest.approx(3.0)
    assert events and events[0]["reason"] == "peer_loss"
    assert os.path.exists(tmp_path / "ck" / f"{TCl.PEER_LOSS_MARKER}.0")


def test_peer_loss_marker_and_dump_carry_the_jax_fields(tmp_path,
                                                        monkeypatch):
    """on_collective_error with a stale peer: True, with the marker, the
    peer_loss dump and an emergency checkpoint; the marker's and the
    dump context's fields are the JAX package's. With every peer fresh
    the error is the caller's own: False."""
    from deeplearning4j_tpu.observe.flight_recorder import \
        FlightRecorder as JFR
    from deeplearning4j_tpu_torch.observe.flight_recorder import \
        FlightRecorder as TFR
    jm, tm = _models()
    _carry(jm, tm)
    out = {}
    for pkg, model, Wd, FR in (("jax", jm, JCl.CollectiveWatchdog, JFR),
                               ("port", tm, TCl.CollectiveWatchdog, TFR)):
        root = tmp_path / pkg
        hb = root / "hb"
        hb.mkdir(parents=True)
        _beat(str(hb), 1, time.time() - 60, iteration=3)
        model.set_flight_recorder(FR(str(root / "dumps"), enabled=True))
        wd = Wd(str(hb), rank=0, n_ranks=2, interval_s=0.01,
                dead_after_s=0.5, model=model,
                checkpoint_dir=str(root / "ck"), exit_on_loss=True)
        assert wd.on_collective_error(RuntimeError("gloo reset")) is True
        with open(root / "ck" / f"{JCl.PEER_LOSS_MARKER}.0") as f:
            marker = json.load(f)
        dumps = [d for d in os.listdir(root / "dumps") if "peer_loss" in d]
        assert len(dumps) == 1
        with open(root / "dumps" / dumps[0] / "context.json") as f:
            ctx = json.load(f)
        out[pkg] = (marker, ctx)
    (jmk, jctx), (tmk, tctx) = out["jax"], out["port"]
    assert set(tmk) == set(jmk)
    assert {k: tmk[k] for k in ("reason", "rank", "n_ranks", "iteration",
                                "dead_ranks")} == \
        {k: jmk[k] for k in ("reason", "rank", "n_ranks", "iteration",
                             "dead_ranks")}
    assert set(tctx) >= set(jmk)
    assert os.path.basename(tmk["emergency_checkpoint"]) == \
        os.path.basename(jmk["emergency_checkpoint"])
    fresh = MultiLayerNetwork(_mlp("deeplearning4j_tpu_torch", "adam"),
                              device="cpu").init()
    TK.restore_sharded(fresh, tmk["emergency_checkpoint"])
    assert fresh.iteration == tm.iteration
    # every peer fresh: the caller's own bug. The peer beats at every
    # tick of the injected clock while the classifier waits
    hb = tmp_path / "fresh"
    hb.mkdir()
    clock = Clock(time.time())

    def tick(s):
        clock.sleep(s)
        _beat(str(hb), 1, clock.t)
    tick(0.0)
    t0 = clock.t
    wd = TCl.CollectiveWatchdog(str(hb), rank=0, n_ranks=2,
                                interval_s=0.01, dead_after_s=0.5,
                                exit_on_loss=False, clock=clock, sleep=tick)
    assert wd.on_collective_error(ValueError("my bug")) is False
    assert clock.t - t0 >= 0.5              # it waited the horizon out
    assert wd.peer_loss_event is None
    assert TCl.PEER_LOSS_EXIT_CODE == JCl.PEER_LOSS_EXIT_CODE == 43


# ---- the YOLO2 decode check ---------------------------------------------------------

def _dets(rows):
    from deeplearning4j_tpu_torch.nn.layers.objdetect import DetectedObject
    return [DetectedObject(0, 1.0, 1.0, 1.0, 1.0, c, s) for c, s in rows]


def _decoded(scores):
    one = np.full((1, 2, 2, 5), 0.5, np.float32)
    return {"cx": one, "cy": one, "bw": one, "bh": one, "conf": one,
            "probs": np.full((1, 2, 2, 5, 3), 0.3, np.float32),
            "score": np.asarray(scores, np.float32)}


def test_decodes_agree_accepts_only_near_ties():
    import chip_smoke
    host = _decoded([0.5, 0.4, 0.3])
    bound = chip_smoke.DECODE_ULPS * float(np.spacing(np.float32(0.5)))
    tie = 0.4 + 0.5 * bound                  # within 2x the score bound
    ref = _dets([(0, 0.5), (1, 0.4), (2, tie), (3, 0.3)])
    swapped = _dets([(0, 0.5), (2, tie), (1, 0.4), (3, 0.3)])
    rep = chip_smoke.decodes_agree(host, host, 0.25, ref, swapped)
    assert rep["ok"] and not rep["same"] and rep["parting"]["near_tie"]
    assert chip_smoke.decodes_agree(host, host, 0.25, ref, ref)["same"]
    far = _dets([(0, 0.5), (2, 0.35), (1, 0.45), (3, 0.3)])
    far_ref = _dets([(0, 0.5), (1, 0.45), (2, 0.35), (3, 0.3)])
    assert not chip_smoke.decodes_agree(host, host, 0.25, far_ref,
                                        far)["ok"]
    missing = [d for d in far_ref if d.predicted_class != 1]
    rep = chip_smoke.decodes_agree(host, host, 0.25, far_ref, missing)
    assert not rep["ok"] and rep["parting"]["index"] == 1
    # a box at the threshold may fall on either side of it
    at_edge = far_ref + _dets([(4, 0.25 + 0.5 * bound)])
    assert chip_smoke.decodes_agree(host, host, 0.25, at_edge,
                                    far_ref)["ok"]
    card = dict(host, score=host["score"] + np.float32(4 * bound))
    rep = chip_smoke.decodes_agree(card, host, 0.25, ref, ref)
    assert not rep["ok"] and "score" in rep["why"]
    d, b = rep["diffs"]["cx"]
    assert d == 0.0 and b == pytest.approx(
        chip_smoke.DECODE_ULPS * np.spacing(np.float32(0.5)))


# ---- MagicQueue, the wrapper and the masters at one worker ---------------------------

def test_magic_queue_places_batches_in_turn():
    from deeplearning4j_tpu_torch.parallel.magic_queue import MagicQueue
    q = MagicQueue(["cpu", "cpu"])
    for i in range(4):
        q.add(DataSet(np.full((2, 3), i, np.float32)))
    assert q.size() == 4 and q.size(0) == 2
    assert [float(q.poll(i % 2).features[0, 0]) for i in range(4)] == \
        [0.0, 1.0, 2.0, 3.0]
    assert q.poll(0, timeout=0.01) is None
    t = MagicQueue(["cpu", "cpu"], mode=MagicQueue.THROUGHPUT)
    t.add(DataSet(np.zeros((1, 2), np.float32)))
    assert t.size(0) == t.size(1) == 1
    with pytest.raises(ValueError):
        MagicQueue(["cpu"], mode="other")


def _batches(n=4, seed=7):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(8, 4)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(n)]


def _fresh(updater="adam"):
    return MultiLayerNetwork(_mlp("deeplearning4j_tpu_torch", updater),
                             device="cpu").init()


@pytest.mark.parametrize("mode", ["SHARED_GRADIENTS", "AVERAGING"])
def test_one_worker_steps_are_the_plain_fit_steps_bitwise(mode):
    plain, par = _fresh(), _fresh()
    for b in _batches():
        plain.fit(b)
    w = (ParallelWrapper.builder(par).training_mode(TrainingMode[mode])
         .workers(1).averaging_frequency(2).build())
    w.fit(ListDataSetIterator(_batches()))
    for group in ("params", "model_state", "opt_state"):
        a, b = (flatten_paths(getattr(m, group)) for m in (par, plain))
        for k in b:
            assert torch.equal(a[k], b[k]), (group, k)
    assert par.iteration == plain.iteration == 4


def test_wrapper_refusals_and_collective_census():
    m = _fresh()
    w = ParallelWrapper.builder(m).training_mode(TrainingMode.CUSTOM).build()
    with pytest.raises(ValueError, match="unsupported mode"):
        w.fit(ListDataSetIterator(_batches(1)))
    with pytest.raises(ValueError, match="requested 2 workers"):
        ParallelWrapper.builder(m).workers(2)
    before = {k: v.clone() for k, v in flatten_paths(m.params).items()}
    census = ParallelWrapper(m).collective_census(_batches(1)[0])
    assert census == {"all-reduce": 2}        # the count, the gradients
    assert all(torch.equal(before[k], v)
               for k, v in flatten_paths(m.params).items())
    with pytest.raises(ValueError, match="audits the sync step"):
        ParallelWrapper(m, mode=TrainingMode.AVERAGING).collective_census(
            _batches(1)[0])


def test_training_masters_and_stats_at_one_worker(tmp_path):
    plain = _fresh("sgd")
    plain.fit(ListDataSetIterator(_batches()))
    shared = TCl.SharedTrainingMaster.Builder(2e-3).min_threshold(1e-4) \
        .threshold_step(4.0).shake_frequency(3).build()
    assert (shared.threshold_schedule.threshold,
            shared.threshold_schedule.min_threshold,
            shared.threshold_schedule.threshold_step,
            shared.threshold_schedule.shake_frequency) == (2e-3, 1e-4, 4.0, 3)
    for master in (TCl.SharedTrainingMaster.Builder(1e-3).workers(1)
                   .collect_training_stats(True).build(),
                   TCl.ParameterAveragingTrainingMaster.Builder(8)
                   .averaging_frequency(1).workers(1)
                   .collect_training_stats(True).build()):
        net = TCl.DistributedNetwork(_fresh("sgd"), master)
        net.fit(ListDataSetIterator(_batches()))
        for k, v in flatten_paths(plain.params).items():
            assert torch.equal(flatten_paths(net.get_network().params)[k],
                               v), k
        ev = net.evaluate(ListDataSetIterator(_batches()))
        assert ev.accuracy() == plain.evaluate(
            ListDataSetIterator(_batches())).accuracy()
        events = json.loads(net.stats.as_json())
        assert len(events) == 1 and events[0]["duration_ms"] > 0
        net.stats.export_timeline_html(str(tmp_path / "t.html"))
        assert "Training timeline" in (tmp_path / "t.html").read_text()


def test_mirror_opt_shardings_follows_the_param_paths():
    """An updater-state leaf that mirrors a parameter (its path ends with
    the parameter's, at its shape) takes that parameter's placement; the
    rest (step counts) the replicated one, as in the JAX package."""
    _, tm = _models(steps=0)
    marks = {ln: {k: f"{ln}/{k}" for k in lp}
             for ln, lp in tm.params.items()}
    got = flatten_paths(TK.mirror_opt_shardings(tm.opt_state, tm.params,
                                                marks, "replicated"))
    for path, mark in got.items():
        tail = "/".join(path.split("/")[-2:])
        if ".count" in path:
            assert mark == "replicated", path
        else:
            assert mark == tail, (path, mark)
