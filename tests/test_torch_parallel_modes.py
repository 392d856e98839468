"""ParallelWrapper's three modes at two workers against the JAX package.

The JAX side runs its wrapper on a mesh over the first two of the eight
virtual CPU devices (tests/conftest.py); the port's side is two gloo
ranks, spawned once for the whole module (tests/torch_parallel_workers.py
runs every scenario in them). Both start from the same weights (the
port's seeded init, carried into the JAX model) and fresh updater state,
and fit the same global batches.

- SHARED_GRADIENTS on the Iris MLP of tests/test_parallel.py and on a
  two-block fused graph with BN (s2d stem, conv1_bn, two fused blocks):
  the JAX package's step is the step on the global batch, its BN
  statistics global, and the test asserts that it found them so (the JAX
  wrapper against one JAX device on the same batches); the ranks bitwise
  equal each other; within rel 1e-4 of the JAX wrapper and of the port's
  single-process fit on the global batches. The JAX graph runs its fused
  blocks with ``fused_impl="xla"`` (the same function, without Pallas
  interpret mode under a sharded jit); the port's with ``"pallas"``, whose
  CPU path is the kernels' plain versions, where the global sums hook in.
- AVERAGING (Sgd on a step schedule, whose count is an integer leaf of
  the updater state; not Adam, which turns the f32 noise of a near-zero
  gradient into a step of up to its learning rate, ROADMAP queue 3 "Not
  faults", beyond any rel 1e-4 bound) and
  ASYNC_ELASTIC with a deterministic straggler (worker 1 misses rounds
  1-3; a staleness bound of 4 merges its late delta, a bound of 2
  discards it): the same membership bookkeeping (ages, rounds, counters),
  and parameters, state and updater state within rel 1e-4; integer leaves
  stay integers, counting every local step.
- An uneven batch of 5 rows at two workers, padded as the JAX package
  pads it.

Bounds: rel 1e-4 of each leaf's largest magnitude (ROADMAP's post-step
bound for f32).
"""

import dataclasses
import importlib
import json
import threading

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as tpw
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.datasets.fetchers import IrisDataSetIterator
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JGraph
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel.wrapper import ElasticOptions as JElastic
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel.wrapper import TrainingMode as JMode
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.models.serialization import (
    flatten_paths, restore_model, save_model)
from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
from deeplearning4j_tpu_torch.parallel.sharding import BatchSharding
from deeplearning4j_tpu_torch.parallel.wrapper import pad_for_workers

torch.set_num_threads(1)

W = 2
REL = 1e-4


@pytest.fixture(autouse=True)
def _restore_default_registries():
    """Both packages' process-wide registries as they were before each
    test (``torch_parallel_workers.registries_restored``)."""
    from deeplearning4j_tpu.observe.registry import default_registry as jr
    from deeplearning4j_tpu_torch.observe.registry import \
        default_registry as tr
    with tpw.registries_restored(jr(), tr()):
        yield


def _mlp(pkg, updater):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    act = m("ops.activations").Activation
    up = m("optimize.updaters")
    if updater == "sgd":
        upd = up.Sgd(0.1)
    elif updater == "schedule":
        upd = up.Sgd(m("optimize.schedules").StepSchedule(0.1, 0.5, 4))
    else:
        upd = up.Adam(0.01)
    return (m("nn.config").NeuralNetConfiguration.Builder().seed(1)
            .updater(upd).list()
            .layer(m("nn.layers.feedforward").DenseLayer(
                n_out=16, activation=act.TANH))
            .layer(m("nn.layers.output").OutputLayer(n_out=3))
            .set_input_type(m("nn.inputs").InputType.feed_forward(4))
            .build())


def _graph(pkg, impl, hw=16, classes=5):
    """tests/test_torch_train.py's narrow ResNet50 graph, with the fused
    blocks' implementation chosen."""
    import test_torch_train
    conf = test_torch_train._conf(pkg, classes, hw)
    conf.nodes = tuple(
        dataclasses.replace(n, layer=dataclasses.replace(n.layer, impl=impl))
        if type(n.layer).__name__ == "FusedBottleneckBlock" else n
        for n in conf.nodes)
    return conf


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(kind, updater):
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    if kind == "mlp":
        return MultiLayerNetwork(_mlp("deeplearning4j_tpu_torch", updater),
                                 device="cpu").init()
    return ComputationGraph(_graph("deeplearning4j_tpu_torch", "pallas"),
                            device="cpu").init()


def _jax_model(kind, updater, tm):
    """The JAX model of ``kind`` holding the port model ``tm``'s weights,
    BN state and (fresh) updater state: the JAX package's eager init of
    the graph took longer than every check of this module."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.optimize.solver import TrainState as JTS
    jm = (JMLN(_mlp("deeplearning4j_tpu", updater)) if kind == "mlp"
          else JGraph(_graph("deeplearning4j_tpu", "xla")))
    tree = lambda t: {k: tree(v) if isinstance(v, dict)
                      else jnp.asarray(v.numpy()) for k, v in t.items()}
    params = tree(tm.params)
    jm._tx = jm._make_tx()
    jm._rng = jax.random.fold_in(jax.random.PRNGKey(1), 0x5eed)
    jm.train_state = JTS(params, tree(tm.model_state),
                         jm._tx.init(params), jnp.zeros((), jnp.int32))
    return jm


def _iris(batch):
    return [(np.asarray(b.features), np.asarray(b.labels))
            for b in IrisDataSetIterator(batch_size=batch)]


def _graph_batches():
    rng = np.random.default_rng(4)
    return [(rng.normal(0, 1, (8, 16, 16, 3)).astype(np.float32),
             np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)])
            for _ in range(3)]


# name: (model kind, updater, mode, k, epochs, batches, elastic bound)
SCENARIOS = {
    "mlp_sync": ("mlp", "sgd", "SHARED_GRADIENTS", 1, 2, lambda: _iris(64),
                 None),
    "bn_sync": ("graph", "nesterovs", "SHARED_GRADIENTS", 1, 1,
                _graph_batches, None),
    "averaging": ("mlp", "schedule", "AVERAGING", 2, 2, lambda: _iris(32),
                  None),
    "async_merge": ("mlp", "sgd", "ASYNC_ELASTIC", 2, 2, lambda: _iris(32),
                    4),
    "async_discard": ("mlp", "sgd", "ASYNC_ELASTIC", 2, 2,
                      lambda: _iris(32), 2),
    "uneven": ("mlp", "sgd", "SHARED_GRADIENTS", 1, 1,
               lambda: [tuple(a[:5] for a in _iris(64)[0])], None),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario's JAX model, data and the two ranks' results: one
    spawned group for the module."""
    root = tmp_path_factory.mktemp("parallel_modes")
    spec, jax_models, data = {}, {}, {}
    for name, (kind, updater, mode, k, epochs, batches, bound) in \
            SCENARIOS.items():
        tm = _port_model(kind, updater)
        jm = _jax_model(kind, updater, tm)
        zpath, dpath = str(root / f"{name}.zip"), str(root / f"{name}.npz")
        save_model(tm, zpath, save_updater=True)
        data[name] = batches()
        np.savez(dpath, **{f"{a}{i}": arr for i, b in enumerate(data[name])
                           for a, arr in zip("xy", b)})
        jax_models[name] = jm
        spec[name] = {"zip": zpath, "data": dpath, "mode": mode, "k": k,
                      "epochs": epochs, "bound": bound}
    spec_path = str(root / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    out = root / "out"
    out.mkdir()
    # the ranks run while the tests build their JAX references
    codes = []
    group = threading.Thread(target=lambda: codes.extend(spawn_ranks(
        tpw.run_modes, W, (spec_path, str(out)), run_dir=str(root),
        timeout_s=240.0, group_timeout_s=120.0, name="modes")))
    group.start()

    def ranks(name):
        group.join()
        assert codes == [0] * W, codes
        return [(dict(np.load(out / f"{name}.rank{r}.npz")),
                 json.load(open(out / f"{name}.rank{r}.json")))
                for r in range(W)]
    yield {"spec": spec, "jax": jax_models, "data": data, "ranks": ranks}
    group.join()


def _jax_fit(world, name):
    """The JAX wrapper at two workers over the scenario's batches; returns
    (model, wrapper)."""
    kind, updater, mode, k, epochs, _, bound = SCENARIOS[name]
    jm = world["jax"][name]
    batches = [JDataSet(x, y) for x, y in world["data"][name]]
    b = (JWrapper.builder(jm).training_mode(JMode[mode]).workers(W)
         .averaging_frequency(k))
    if mode == "ASYNC_ELASTIC":
        b = b.elastic_options(JElastic(staleness_bound=bound,
                                       straggler_policy=tpw.straggler_policy))
    w = b.build()
    w.fit(JListIt(batches), epochs=epochs)
    return jm, w


def _jax_flat(jm):
    ts = _np(jm.train_state)
    out = {}
    for group in ("params", "model_state", "opt_state"):
        for k, v in flatten_paths(getattr(ts, group)).items():
            out[f"{group}/{k}"] = np.asarray(v)
    return out


def _close(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in want.items():
        g = got[k]
        if not np.issubdtype(v.dtype, np.floating):
            np.testing.assert_array_equal(g, v, err_msg=f"{what} {k}")
            continue
        err = np.abs(g.astype(np.float64) - v).max(initial=0.0)
        assert err <= REL * max(np.abs(v).max(initial=0.0), 1e-6), \
            (what, k, err, np.abs(v).max(initial=0.0))


def _bitwise_ranks(ranks):
    (a, ia), (b, ib) = ranks
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ia == ib


def _port_single(world, name):
    """The port's plain fit of the scenario's global batches."""
    _, _, _, _, epochs, _, _ = SCENARIOS[name]
    tm = restore_model(world["spec"][name]["zip"], device="cpu",
                       load_updater=True)
    tm.fit(ListDataSetIterator([DataSet(x, y)
                                for x, y in world["data"][name]]),
           epochs=epochs)
    return tpw.flat_trees(tm)


def test_sync_mlp_matches_jax_and_the_global_batch(world):
    jm, _ = _jax_fit(world, "mlp_sync")
    ranks = world["ranks"]("mlp_sync")
    _bitwise_ranks(ranks)
    _close(ranks[0][0], _jax_flat(jm), "port ranks vs JAX wrapper")
    _close(ranks[0][0], _port_single(world, "mlp_sync"),
           "port ranks vs port single process")
    assert ranks[0][1]["iteration"] == 6


def test_sync_bn_graph_takes_global_batch_statistics_as_jax_does(world):
    """The JAX package decides: its two-device step equals its one-device
    step on the global batch (BN statistics included), so the port sums
    the statistics over the ranks; per-shard statistics would put the BN
    running averages and the parameters far outside the bound."""
    ranks = world["ranks"]("bn_sync")
    _bitwise_ranks(ranks)
    jm2, _ = _jax_fit(world, "bn_sync")
    j2 = _jax_flat(jm2)
    jm1 = _jax_model("graph", None, restore_model(
        world["spec"]["bn_sync"]["zip"], device="cpu"))
    jm1.fit(JListIt([JDataSet(x, y) for x, y in world["data"]["bn_sync"]]))
    _close(j2, _jax_flat(jm1), "JAX two devices vs one: global statistics")
    _close(ranks[0][0], j2, "port ranks vs JAX wrapper")
    _close(ranks[0][0], _port_single(world, "bn_sync"),
           "port ranks vs port single process")


def test_averaging_matches_jax_and_keeps_integer_leaves(world):
    ranks = world["ranks"]("averaging")
    _bitwise_ranks(ranks)
    jm, _ = _jax_fit(world, "averaging")
    want = _jax_flat(jm)
    _close(ranks[0][0], want, "port AVERAGING vs JAX")
    counts = {k: v for k, v in ranks[0][0].items()
              if not np.issubdtype(v.dtype, np.floating)}
    assert counts, "the schedule's step count is an integer leaf"
    # 2 epochs x 3 rounds x k = 2 local steps, never averaged into a float
    assert all(int(v) == 12 for v in counts.values()), counts
    assert ranks[0][1]["iteration"] == 12 == int(jm.train_state.iteration)


@pytest.mark.parametrize("name", ["async_merge", "async_discard"])
def test_async_elastic_membership_and_merge_match_jax(world, name):
    from deeplearning4j_tpu.observe.registry import default_registry
    ranks = world["ranks"](name)
    _bitwise_ranks(ranks)
    before = tpw.elastic_counters(default_registry())
    jm, jw = _jax_fit(world, name)
    after = tpw.elastic_counters(default_registry())
    info = ranks[0][1]
    el = jw._elastic
    assert info["ages"] == np.asarray(el["ages"]).tolist()
    assert info["round"] == el["round"] == 6
    assert info["hard_next"] == bool(el["hard_next"])
    assert info["counters"] == {k: after[k] - before[k] for k in after}
    c = info["counters"]
    assert c["dl4j_elastic_stragglers_dropped_total"] == 3
    key = ("dl4j_elastic_stale_merged_total" if name == "async_merge"
           else "dl4j_elastic_stale_discarded_total")
    assert c[key] == 1
    _close(ranks[0][0], _jax_flat(jm), f"port {name} vs JAX")


def test_uneven_batch_is_padded_as_jax_pads_it(world):
    ranks = world["ranks"]("uneven")
    _bitwise_ranks(ranks)
    jm, jw = _jax_fit(world, "uneven")
    _close(ranks[0][0], _jax_flat(jm), "port uneven step vs JAX")
    x, y = world["data"]["uneven"][0]
    jp = jw._pad_batch(JDataSet(x, y))
    tp = pad_for_workers(DataSet(x, y), W)
    for a, b in ((tp.features, jp.features), (tp.labels, jp.labels),
                 (tp.labels_mask, jp.labels_mask)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(tp.labels_mask).reshape(-1).tolist() == \
        [1, 1, 1, 1, 1, 0]
    # rank order: rank 1 holds the padded row
    assert [BatchSharding(r, W).rows(6) for r in range(W)] == \
        [slice(0, 3), slice(3, 6)]
