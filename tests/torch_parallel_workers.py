"""The ranks of tests/test_torch_parallel_modes.py: one spawned gloo group
runs every scenario of a spec, each rank writing what it ends with.

A scenario is a port model zip (with its updater state), a list of global
batches and a mode. Every rank restores the same zip, fits the same
batches through ``ParallelWrapper`` and writes its trees, its last loss
and, for ASYNC_ELASTIC, its membership bookkeeping. This module imports
no JAX: a spawned rank imports it by name.
"""

import json
import os
from contextlib import contextmanager

import numpy as np
import torch


def straggler_policy(round_index, n_workers):
    """Worker 1 misses rounds 1 to 3 (then rejoins): a deterministic
    policy every rank and the JAX package evaluate alike."""
    delays = [0.0] * n_workers
    if 1 <= round_index <= 3:
        delays[1] = 1e9
    return delays


def flat_trees(model):
    """{group/path: numpy} of a model's params, BN state, updater state."""
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    out = {}
    for group in ("params", "model_state", "opt_state"):
        for k, v in flatten_paths(getattr(model, group)).items():
            out[f"{group}/{k}"] = v.detach().cpu().numpy()
    return out


ELASTIC_COUNTERS = ("dl4j_elastic_stragglers_dropped_total",
                    "dl4j_elastic_stale_merged_total",
                    "dl4j_elastic_stale_discarded_total",
                    "dl4j_elastic_hard_syncs_total")


def elastic_counters(registry):
    """The ASYNC_ELASTIC counters' values (0 where never incremented);
    either package's registry."""
    return {name: registry.counter(name, "").get(session="elastic") or 0.0
            for name in ELASTIC_COUNTERS}


@contextmanager
def registries_restored(*registries):
    """Each registry's series as they were before the block: the
    watchdog's peer-loss counter and the elastic staleness gauge degrade
    ``/healthz`` (503) for every later test in the same process."""
    snaps = []
    for r in registries:
        with r._lock:
            snaps.append({name: dict(m._series)
                          for name, m in r._metrics.items()})
    try:
        yield
    finally:
        for r, snap in zip(registries, snaps):
            with r._lock:
                for name in list(r._metrics):
                    if name in snap:
                        r._metrics[name]._series = dict(snap[name])
                    else:
                        del r._metrics[name]


def batches_of(path):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    data = np.load(path)
    n = len([k for k in data.files if k.startswith("x")])
    return [DataSet(data[f"x{i}"], data[f"y{i}"],
                    None, data[f"m{i}"] if f"m{i}" in data.files else None)
            for i in range(n)]


def run_modes(rank, world, spec_path, out_dir):
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.datasets.dataset import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.serialization import restore_model
    from deeplearning4j_tpu_torch.observe.registry import default_registry
    from deeplearning4j_tpu_torch.parallel.wrapper import (ElasticOptions,
                                                           ParallelWrapper,
                                                           TrainingMode)
    with open(spec_path) as f:
        spec = json.load(f)
    for name, sc in spec.items():
        m = restore_model(sc["zip"], device="cpu", load_updater=True)
        mode = TrainingMode[sc["mode"]]
        b = (ParallelWrapper.builder(m).training_mode(mode).workers(world)
             .averaging_frequency(sc.get("k", 1)))
        if mode is TrainingMode.ASYNC_ELASTIC:
            b = b.elastic_options(ElasticOptions(
                staleness_bound=sc["bound"],
                straggler_policy=straggler_policy))
        w = b.build()
        batches = batches_of(sc["data"])
        before = elastic_counters(default_registry())
        w.fit(ListDataSetIterator(batches), epochs=sc.get("epochs", 1))
        info = {"loss": float(m._last_loss), "iteration": m.iteration}
        if mode is TrainingMode.ASYNC_ELASTIC:
            el = w._elastic
            after = elastic_counters(default_registry())
            info.update(ages=el["ages"].tolist(), round=el["round"],
                        hard_next=bool(el["hard_next"]),
                        counters={k: after[k] - before[k] for k in after})
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
                 **flat_trees(m))
        with open(os.path.join(out_dir, f"{name}.rank{rank}.json"),
                  "w") as f:
            json.dump(info, f)
