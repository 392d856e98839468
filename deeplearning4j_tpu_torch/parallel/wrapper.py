"""ParallelWrapper: data-parallel training, one process per device.

The port of the JAX package's ``parallel/wrapper.py`` (reference:
ParallelWrapper.java:58). The JAX package drives every device from one
process with a jitted or ``shard_map``ped step; here each device has a
process of its own in a ``torch.distributed`` group (parallel/mesh.py:
NCCL on the card, gloo on the CPU or for several ranks on one card), and
every rank runs the same ``fit`` over the same global batches. A global
batch is padded to a multiple of the worker count as the JAX package
pads it (``datasets.feeder.pad_rows``: duplicated rows with a zero
labels mask) and split along its first axis in rank order, as a
``PartitionSpec("data")`` splits it; each rank stages only its rows.

- **SHARED_GRADIENTS** is the step on the global batch. Each rank weighs
  its loss by its share of the global example count (the first output's
  labels-mask sum, or its rows), its backward runs with the BN
  statistics summed over the group
  (``mesh.global_batch_stats``: the fused blocks' (Σy, Σy²) and count,
  ``BatchNormalization``'s moments, and their gradients), and the
  gradients and the loss are summed over the group in one all-reduce per
  dtype. Every rank then applies the same update to the same parameters,
  so the ranks stay bitwise equal.
- **AVERAGING** runs ``averaging_frequency`` local steps per rank on its
  own rows with local BN, then averages the parameters, the model state
  and (``average_updaters``) the updater state over the group. Integer
  leaves (step counts) are kept as they are.
- **ASYNC_ELASTIC** runs the JAX package's bounded-staleness rounds: the
  membership comes from the deterministic ``straggler_policy``, which
  every rank evaluates itself; the merge is ``θ + Σ wᵢ(localᵢ − baseᵢ) /
  Σ wᵢ`` with ``wᵢ = decay^ageᵢ`` (0 past the bound); members adopt the
  merged state; past ``divergence_threshold`` the next round is a hard
  sync.
- **CUSTOM** raises in ``fit``, as in the JAX package.

With one rank every collective is the identity: SHARED_GRADIENTS and
AVERAGING then take the plain ``fit`` steps bitwise.

- **tensor_parallel=True** (SHARED_GRADIENTS only) runs over a ``{data,
  model}`` mesh whose size is the group's: ``parallel/tensor_parallel``'s
  Megatron plan splits the model over the ``model`` axis (each rank keeps
  its slices of the parameters, BN state and updater state; the layers
  issue the plan's all-reduces), the ranks of one ``model`` line take the
  same rows, and the loss, the gradients and the BN statistics are summed
  over the ``data`` axis only: split leaves stay split. The updater must be
  elementwise (no gradient normalization across a split leaf).

An attached ``CollectiveWatchdog`` (parallel/cluster.py) marks every
dispatch in flight (``guard``), and an exception out of a collective goes
through its classifier first: peer loss leaves an emergency checkpoint,
the ``PEER_LOSS.json`` marker and a flight-recorder dump.
"""

from __future__ import annotations

import contextlib
import enum
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       DataSetIterator)
from deeplearning4j_tpu_torch.datasets.feeder import (DeviceFeeder,
                                                      ones_labels_mask,
                                                      pad_rows)
from deeplearning4j_tpu_torch.datasets.iterators import AsyncDataSetIterator
from deeplearning4j_tpu_torch.observe.telemetry import has_buffer
from deeplearning4j_tpu_torch.observe.tracer import get_tracer
from deeplearning4j_tpu_torch.optimize.solver import (TrainState,
                                                      make_constrain_fn,
                                                      train_update)
from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves, tree_map
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                    all_reduce_, count_calls,
                                                    create_mesh,
                                                    global_batch_stats, rank,
                                                    world_size)
from deeplearning4j_tpu_torch.parallel.sharding import batch_shardings


class TrainingMode(enum.Enum):
    SHARED_GRADIENTS = "shared_gradients"   # sync allreduce DP
    AVERAGING = "averaging"                 # local SGD + periodic averaging
    ASYNC_ELASTIC = "async_elastic"         # bounded-staleness PS rounds
    CUSTOM = "custom"


def _default_divergence_threshold() -> float:
    # observe/health.py's: past this relative spread of per-replica grad
    # norms the replicas are diverging
    try:
        return float(os.environ.get("DL4J_DIVERGENCE_THRESHOLD", "2.0"))
    except ValueError:
        return 2.0


@dataclass
class ElasticOptions:
    """Knobs of :attr:`TrainingMode.ASYNC_ELASTIC` (the JAX package's).

    Each round every worker runs ``averaging_frequency`` local steps from
    its last adopted server snapshot. Workers whose delay is within
    ``round_deadline_ms`` are the round's members; their parameter
    deltas are merged weighted by ``staleness_decay ** (age - 1)``, age
    counting the rounds since the worker last adopted, and with weight 0
    past ``staleness_bound``. Members adopt the merged state; dropped
    stragglers keep training on their own parameters and age by one.
    Past ``divergence_threshold`` (relative spread of the workers' grad
    norms) the next round is a hard sync: every worker contributes with
    weight 1 and adopts.

    ``straggler_policy``: ``(round_index, n_workers) -> per-worker delay
    in ms``, for tests and benchmarks. It must be deterministic in its
    arguments: every rank evaluates it and they must agree on the
    membership. None means nobody lags."""
    round_deadline_ms: float = 250.0
    staleness_bound: int = 3
    staleness_decay: float = 0.5
    divergence_threshold: float = field(
        default_factory=_default_divergence_threshold)
    straggler_policy: Optional[
        Callable[[int, int], Sequence[float]]] = None


# ---- trees flattened for one collective per dtype ---------------------------

def _reduce_leaves(leaves, scale: Optional[float] = None, group=None):
    """The float leaves summed over the group (or ``group``; divided by
    ``scale`` when given), one all-reduce per dtype; other leaves as they
    are."""
    out = list(leaves)
    by_dtype = {}
    for i, t in enumerate(leaves):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        all_reduce_(flat, group=group)
        if scale is not None:
            flat = flat / scale
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view_as(leaves[i])
            off += n
    return out


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _mean_tree(tree, w: int):
    """The float leaves' mean over the group; integer leaves verbatim
    (a mean would make a step count a float)."""
    return _rebuild(tree, _reduce_leaves(tree_leaves(tree), float(w)))


def _grad_norm(grads) -> torch.Tensor:
    leaves = [g for g in tree_leaves(grads) if g is not None]
    sq = sum((torch.sum(torch.square(g.float())) for g in leaves),
             torch.zeros((), dtype=torch.float32, device=leaves[0].device))
    return torch.sqrt(sq)


def pad_for_workers(batch: DataSet, workers: int,
                    target: Optional[int] = None) -> DataSet:
    """``batch`` padded to a multiple of ``workers`` (and first to
    ``target`` examples) with zero-weight rows, as the JAX package's
    wrapper pads (``pad_rows``): the masked loss mean ignores them; BN
    batch statistics see the duplicated rows."""
    n = batch.num_examples()
    pad = ((target - n) if target else 0) + ((-(target or n)) % workers)
    return pad_rows(batch, pad)


def _slice_rows(a, rows: slice, dim: int = 0):
    if a is None:
        return None
    a = np.asarray(a)
    return np.ascontiguousarray(a[rows] if dim == 0 else a[:, rows])


class ParallelWrapper:
    """Builder-style API, as the reference's::

        wrapper = (ParallelWrapper.builder(model)
                   .training_mode(TrainingMode.SHARED_GRADIENTS)
                   .workers(2)
                   .averaging_frequency(5)
                   .build())
        wrapper.fit(iterator, epochs)

    Every rank of the process group builds the same model (same seed)
    and calls ``fit`` with the same iterator; ``workers`` is the group's
    size."""

    def __init__(self, model, mesh=None,
                 mode: TrainingMode = TrainingMode.SHARED_GRADIENTS,
                 averaging_frequency: int = 5,
                 average_updaters: bool = True,
                 tensor_parallel: bool = False,
                 elastic_options: Optional[ElasticOptions] = None,
                 watchdog=None):
        if tensor_parallel and mode is not TrainingMode.SHARED_GRADIENTS:
            raise ValueError(
                f"tensor_parallel requires SHARED_GRADIENTS mode, not"
                f" {mode.name}")
        self.model = model
        self.mesh = mesh if mesh is not None else create_mesh()
        if self.mesh.size != world_size():
            raise ValueError(
                f"the mesh {self.mesh.shape} holds {self.mesh.size} ranks "
                f"but the process group has {world_size()}: each rank is "
                "one device of the mesh")
        self.mode = mode
        self.averaging_frequency = int(averaging_frequency)
        self.average_updaters = average_updaters
        self.tensor_parallel = tensor_parallel
        self.elastic_options = (elastic_options if elastic_options
                                is not None else ElasticOptions())
        self._watchdog = watchdog
        self._shard = batch_shardings(self.mesh)
        self._data = self.mesh.axis(DATA_AXIS)
        self._elastic = None        # ASYNC_ELASTIC per-worker state
        if model.params is None:
            model.init()
        if tensor_parallel:
            from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
                plan_tp, shard_train_state)
            if MODEL_AXIS not in self.mesh.shape:
                raise ValueError("tensor_parallel needs a mesh with a "
                                 f"'model' axis; got {self.mesh.shape}")
            shard_train_state(model, plan_tp(model, self.mesh))

    # ---- builder --------------------------------------------------------
    class Builder:
        def __init__(self, model):
            self._model = model
            self._mesh = None
            self._mode = TrainingMode.SHARED_GRADIENTS
            self._avg_freq = 5
            self._avg_updaters = True
            self._tp = False
            self._elastic_opts = None
            self._wd = None

        def workers(self, n: int):
            have = world_size()
            if n > have:
                raise ValueError(f"requested {n} workers but only"
                                 f" {have} ranks present")
            if n != have:
                raise ValueError(f"requested {n} workers but the process "
                                 f"group has {have} ranks: each rank is "
                                 "one worker")
            self._mesh = create_mesh({DATA_AXIS: n})
            return self

        def mesh(self, mesh):
            self._mesh = mesh
            return self

        def training_mode(self, mode: TrainingMode):
            self._mode = mode
            return self

        def averaging_frequency(self, k: int):
            self._avg_freq = k
            return self

        def average_updaters(self, flag: bool):
            self._avg_updaters = flag
            return self

        def tensor_parallel(self, flag: bool = True):
            """Megatron tensor parallelism over the mesh's ``model`` axis
            (parallel/tensor_parallel.py)."""
            self._tp = flag
            return self

        def elastic_options(self, opts: "ElasticOptions"):
            """Bounded-staleness knobs for ASYNC_ELASTIC mode."""
            self._elastic_opts = opts
            return self

        def watchdog(self, wd):
            """Attach a CollectiveWatchdog (parallel/cluster.py)."""
            self._wd = wd
            return self

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self._model, self._mesh, self._mode,
                                   self._avg_freq, self._avg_updaters,
                                   tensor_parallel=self._tp,
                                   elastic_options=self._elastic_opts,
                                   watchdog=self._wd)

    @staticmethod
    def builder(model) -> "ParallelWrapper.Builder":
        return ParallelWrapper.Builder(model)

    @property
    def num_workers(self) -> int:
        return int(self.mesh.shape[DATA_AXIS])

    # ---- the steps --------------------------------------------------------
    def _sync_step(self, ts: TrainState, features, labels, fmask, lmask,
                   generator):
        """One SHARED_GRADIENTS step on this rank's rows of the global
        batch: the model's own step, its loss weighted by this rank's
        share of the examples, with the BN statistics and then the
        gradients and the loss summed over the group; returns (new train
        state, global loss)."""
        m = self.model
        w = self.num_workers
        lead = labels[0] if isinstance(labels, (tuple, list)) else labels
        lm0 = (lmask[0] if isinstance(lmask, (tuple, list)) else lmask) \
            if lmask is not None else None
        count = (lm0.float().sum() if lm0 is not None else
                 torch.full((), float(lead.shape[0]), dtype=torch.float32,
                            device=lead.device))
        group = self._data.group
        total = all_reduce_(count.clone().reshape(1),
                            group=group).reshape(())
        share = count / torch.clamp(total, min=1.0)

        def weighted_loss(*args):
            loss, new_ms = m._loss(*args)
            return loss * share.to(loss.dtype), new_ms

        def summed(grads, loss):
            red = _reduce_leaves(tree_leaves(grads) + [loss.reshape(1)],
                                 group=group)
            return _rebuild(grads, red[:-1]), red[-1].reshape(())

        spec = m._telemetry_spec()
        with global_batch_stats(w, group):
            ts, loss = train_update(
                weighted_loss, m._tx, ts, features, labels, fmask, lmask,
                generator, make_constrain_fn(m._constraint_layers()),
                telemetry=spec, reduce=summed)
        if w > 1 and spec is not None and has_buffer(ts.telemetry) and \
                not self.tensor_parallel:
            with torch.no_grad():
                # the replicas agree when their parameters do: an L2
                # fingerprint per rank, gathered over the group
                fp = torch.zeros((w, 1), dtype=torch.float32,
                                 device=loss.device)
                fp[rank(), 0] = torch.sqrt(sum(
                    torch.sum(torch.square(p.float()))
                    for p in tree_leaves(ts.params)))
                ts = ts._replace(telemetry=spec.record_replica(
                    ts.telemetry, values=all_reduce_(fp),
                    iteration=ts.iteration - 1))
        return ts, loss

    def _local_steps(self, params, opt_state, model_state, iteration,
                     features, labels, fmask, lmask, generator):
        """``averaging_frequency`` plain local steps on this rank's rows
        (the model's own step, local BN); returns (params, opt state,
        model state, per-step losses, per-step grad norms)."""
        m = self.model
        constrain = make_constrain_fn(m._constraint_layers())
        at = lambda a, i: None if a is None else a[i]
        ts = TrainState(params, model_state, opt_state, iteration)
        losses, gnorms = [], []

        def note_norm(grads, loss):
            gnorms.append(_grad_norm(grads))
            return grads, loss
        for i in range(features.shape[0]):
            ts, loss = train_update(
                m._loss, m._tx, ts, *m._staged_step_args(
                    features[i], labels[i], at(fmask, i), at(lmask, i)),
                generator, constrain, reduce=note_norm)
            losses.append(loss)
        return (ts.params, ts.opt_state, ts.model_state,
                torch.stack(losses), torch.stack(gnorms))

    def _worker_stats(self, losses, gnorms) -> torch.Tensor:
        """(n_workers, 2): each worker's mean loss and grad norm over its
        local steps, the same in every rank."""
        stats = torch.zeros((self.num_workers, 2), dtype=torch.float32,
                            device=losses.device)
        stats[rank(), 0] = losses.float().mean()
        stats[rank(), 1] = gnorms.mean()
        return all_reduce_(stats)

    def _averaging_round(self, ts: TrainState, features, labels, fmask,
                         lmask, generator):
        w = self.num_workers
        params, opt, ms, losses, gnorms = self._local_steps(
            ts.params, ts.opt_state, ts.model_state, ts.iteration,
            features, labels, fmask, lmask, generator)
        k = features.shape[0]
        buf = ts.telemetry
        spec = self.model._telemetry_spec()
        with torch.no_grad():
            if spec is not None and has_buffer(buf) and w > 1:
                buf = spec.record_replica(
                    buf, values=self._worker_stats(losses, gnorms),
                    iteration=ts.iteration + k - 1)
            params = _mean_tree(params, w)
            ms = _mean_tree(ms, w)
            if self.average_updaters:
                opt = _mean_tree(opt, w)
            loss = all_reduce_(losses.mean().reshape(1)).reshape(()) / w
        return TrainState(params, ms, opt, ts.iteration + k, buf), loss

    # ---- fit ------------------------------------------------------------
    def fit(self, iterator, epochs: int = 1):
        """Train over the iterator. Every rank calls this with the same
        iterator (the same global batches in the same order)."""
        if self.mode not in (TrainingMode.SHARED_GRADIENTS,
                             TrainingMode.AVERAGING,
                             TrainingMode.ASYNC_ELASTIC):
            raise ValueError(f"unsupported mode: {self.mode}")
        m = self.model
        self._arm_telemetry()
        try:
            if self.mode is TrainingMode.SHARED_GRADIENTS:
                return self._fit_sync(iterator, epochs)
            if self.mode is TrainingMode.ASYNC_ELASTIC:
                if self._elastic is None:
                    self._init_elastic_state()
                return self._fit_rounds(iterator, epochs,
                                        self._async_round)
            return self._fit_rounds(iterator, epochs, self._averaging_round)
        except Exception as e:
            # an exception out of a collective (gloo fails fast when a
            # peer dies) goes through the watchdog's classifier first:
            # peer loss gets the emergency checkpoint, the marker and the
            # peer_loss dump instead of a generic crash
            wd = self._watchdog
            if wd is not None and wd.on_collective_error(e):
                raise
            rec = m._recorder()
            if rec is not None:
                rec.record_crash(m, exc=e)
            raise

    def _arm_telemetry(self):
        """Extend an attached TelemetryCollector with the per-device row
        ring: AVERAGING and ASYNC_ELASTIC workers report their mean loss
        and grad norm, SHARED_GRADIENTS an L2 parameter fingerprint per
        rank (its gradients are reduced before any code sees them)."""
        m = self.model
        tel = m.telemetry
        if tel is None or self.num_workers <= 1 or self.tensor_parallel:
            return
        metrics = (("loss", "grad_norm")
                   if self.mode in (TrainingMode.AVERAGING,
                                    TrainingMode.ASYNC_ELASTIC)
                   else ("param_norm",))
        tel.spec_for(m)
        if tel.enable_replicas(self.num_workers, metrics):
            m.train_state = tel.rebind_buffer(m.train_state, m.device)

    def _pad_batch(self, batch: DataSet, target: Optional[int] = None
                   ) -> DataSet:
        return pad_for_workers(batch, self.num_workers, target)

    def _sync_prepare(self, batch: DataSet) -> DataSet:
        """Host side of one SHARED_GRADIENTS batch: padded, then this
        rank's rows."""
        batch = self._pad_batch(batch)
        rows = self._shard.rows(batch.num_examples())
        return DataSet(*(_slice_rows(a, rows) for a in (
            batch.features, batch.labels, batch.features_mask,
            batch.labels_mask)))

    def _avg_group_prepare(self, batches):
        """Host side of one round: equal example counts by masked
        padding, labels masks made uniform, stacked to (k, B, ...), then
        this rank's rows of each."""
        target = max(b.num_examples() for b in batches)
        batches = [self._pad_batch(b, target=target) for b in batches]
        # padding gave short batches a labels mask; full ones then need
        # an all-ones mask, or the stack would drop every mask
        if any(b.labels_mask is not None for b in batches):
            batches = [b if b.labels_mask is not None else DataSet(
                b.features, b.labels, b.features_mask, ones_labels_mask(b))
                for b in batches]
        rows = self._shard.rows(batches[0].num_examples())

        def stack(get):
            vals = [get(b) for b in batches]
            if any(v is None for v in vals):
                return None
            return _slice_rows(np.stack([np.asarray(v) for v in vals]),
                               rows, dim=1)

        return (stack(lambda b: b.features), stack(lambda b: b.labels),
                stack(lambda b: b.features_mask),
                stack(lambda b: b.labels_mask))

    def _make_feeder(self, iterator):
        """(feeder, source): the DeviceFeeder of this mode (this rank's
        rows staged while the current step runs), or None when the
        iterator opted out of asynchronous prefetch."""
        if not getattr(iterator, "async_supported", True):
            return None, iterator
        source = iterator
        if (isinstance(iterator, DataSetIterator)
                and not isinstance(iterator, AsyncDataSetIterator)):
            source = AsyncDataSetIterator(iterator)
        m = self.model
        tracer = get_tracer(m)
        if self.mode is TrainingMode.SHARED_GRADIENTS:
            feeder = DeviceFeeder(source, device=m.device,
                                  prepare=self._sync_prepare, tracer=tracer,
                                  session_id="parallel")
        else:
            feeder = DeviceFeeder(source, device=m.device,
                                  k_steps=self.averaging_frequency,
                                  group_prepare=self._avg_group_prepare,
                                  group_remainder="pad", tracer=tracer,
                                  session_id="parallel")
        return feeder, source

    def _staged(self, arrays):
        return tuple(self.model._as_tensor(a) for a in arrays)

    def _fit_sync(self, iterator, epochs):
        m = self.model
        feeder, source = self._make_feeder(iterator)
        for _ in range(epochs):
            for lst in m.listeners:
                lst.on_epoch_start(m, m.epoch_count)
            if feeder is not None:
                for item in feeder:
                    if item.k == 0:
                        raise TypeError(
                            "ParallelWrapper consumes DataSet batches, "
                            f"got {type(item.raw).__name__}")
                    item = feeder.hand_off(item)
                    self._dispatch(self._sync_step, m._staged_step_args(
                        item.features, item.labels, item.features_mask,
                        item.labels_mask), 1, item.queue_wait_ms,
                        item.n_examples)
            else:
                t0 = time.perf_counter()
                for batch in iterator:
                    etl_ms = (time.perf_counter() - t0) * 1000
                    b = self._sync_prepare(batch)
                    self._dispatch(self._sync_step, m._staged_step_args(
                        *self._staged((b.features, b.labels,
                                       b.features_mask, b.labels_mask))),
                        1, etl_ms, batch.num_examples())
                    t0 = time.perf_counter()
            if isinstance(source, DataSetIterator):
                source.reset()
            for lst in m.listeners:
                lst.on_epoch_end(m, m.epoch_count)
            m.epoch_count += 1
        self._tail_flush()
        return m

    def _fit_rounds(self, iterator, epochs, run_round):
        """The round loop of the k-local-steps modes: k batches a round
        (a short tail repeats its last batch, as in the JAX package)."""
        m = self.model
        k = self.averaging_frequency
        feeder, source = self._make_feeder(iterator)
        for _ in range(epochs):
            for lst in m.listeners:
                lst.on_epoch_start(m, m.epoch_count)
            if feeder is not None:
                for item in feeder:
                    if item.k == 0:
                        raise TypeError(
                            f"ParallelWrapper {self.mode.name} consumes "
                            "DataSet batches, got "
                            f"{type(item.raw).__name__}")
                    item = feeder.hand_off(item)
                    self._dispatch(run_round, (
                        item.features, item.labels, item.features_mask,
                        item.labels_mask), item.k, item.queue_wait_ms,
                        item.n_examples)
            else:
                pending = []
                for batch in iterator:
                    pending.append(batch)
                    if len(pending) == k:
                        self._legacy_round(run_round, pending)
                        pending = []
                if pending:
                    while len(pending) < k:
                        pending.append(pending[-1])
                    self._legacy_round(run_round, pending)
            if isinstance(source, DataSetIterator):
                source.reset()
            for lst in m.listeners:
                lst.on_epoch_end(m, m.epoch_count)
            m.epoch_count += 1
        self._tail_flush()
        return m

    def _legacy_round(self, run_round, batches):
        n_real = sum(b.num_examples() for b in batches)
        arrays = self._staged(self._avg_group_prepare(batches))
        self._dispatch(run_round, arrays, len(batches), 0.0, n_real)

    def _dispatch(self, step, args, steps: int, wait_ms: float,
                  n_examples: int):
        """One step or round on the model's train state, under the
        watchdog's in-flight window when one is attached (the collectives
        run inside the call); then the telemetry epilogue and the
        listeners."""
        m = self.model
        m._ensure_ring()
        with self._guard():
            with get_tracer(m).span("dispatch", cat="step", k=steps):
                m.train_state, loss = step(m.train_state, *args,
                                           m._generator)
            if self._watchdog is not None and loss.is_cuda:
                torch.cuda.synchronize(loss.device)
        m._notify(m._post_step(steps), loss, wait_ms, n_examples)

    def _guard(self):
        wd = self._watchdog
        if wd is None:
            return contextlib.nullcontext()
        return wd.guard(iteration=self.model.iteration)

    def _tail_flush(self):
        """Drain the telemetry rows still on the device when the fit
        ends, then give the recorder a final look."""
        m = self.model
        if m._telemetry is not None:
            m._telemetry.flush(m.train_state)
            rec = m._recorder()
            if rec is not None:
                rec.poll(m)

    def collective_census(self, batch: DataSet):
        """The collectives one SHARED_GRADIENTS step issues for this
        batch, by kind, forward and backward (the JAX package counts the
        compiled step's collective HLOs): ``{"all-reduce": n,
        "all-gather": n, ...}``, the tensor-parallel plan's with the data
        axis's. The step runs on the model's state and its result is
        dropped."""
        if self.mode is not TrainingMode.SHARED_GRADIENTS:
            raise ValueError("collective_census audits the sync step")
        m = self.model
        b = self._sync_prepare(batch)
        args = m._staged_step_args(*self._staged((
            b.features, b.labels, b.features_mask, b.labels_mask)))
        with count_calls() as calls:
            self._sync_step(m.train_state._replace(telemetry=()), *args,
                            m._generator)
        names = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                 "all_to_all": "all-to-all",
                 "ppermute": "collective-permute"}
        return {names[k]: n for k, n in calls.items() if n}

    # ---- ASYNC_ELASTIC --------------------------------------------------
    def _init_elastic_state(self):
        """This worker's local parameters and updater state and the base
        snapshot it diverges from, copies of the server's."""
        ts = self.model.train_state
        clone = lambda tree: tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
        self._elastic = {
            "local_params": clone(ts.params),
            "local_opt": clone(ts.opt_state),
            "base_params": clone(ts.params),
            "ages": np.zeros(self.num_workers, dtype=np.float32),
            "round": 0,
            "hard_next": False,
        }

    def _membership(self):
        """(present, hard) of this round, from the host-side policy that
        every rank evaluates alike."""
        el, opts, n = self._elastic, self.elastic_options, self.num_workers
        hard = bool(el["hard_next"])
        if opts.straggler_policy is not None and not hard:
            delays = np.asarray(opts.straggler_policy(el["round"], n),
                                dtype=np.float64)
            if delays.shape != (n,):
                raise ValueError(
                    "straggler_policy must return one delay per worker "
                    f"({n}), got shape {delays.shape}")
            present = (delays <= opts.round_deadline_ms).astype(np.float32)
        else:
            present = np.ones(n, dtype=np.float32)
        return present, hard

    def _async_round(self, ts: TrainState, features, labels, fmask, lmask,
                     generator):
        """One bounded-staleness round: k local steps from this worker's
        own state, then the staleness-weighted delta merge over the
        group, adoption, and the host bookkeeping (ages, counters, the
        divergence guard for the next round)."""
        el, opts = self._elastic, self.elastic_options
        n, r = self.num_workers, rank()
        present, hard = self._membership()
        ages = el["ages"]
        lp, lo, ms, losses, gnorms = self._local_steps(
            el["local_params"], el["local_opt"], ts.model_state,
            ts.iteration, features, labels, fmask, lmask, generator)
        k = features.shape[0]
        # the weights, as the JAX package computes them in f32; each rank
        # evaluates every worker's, so the denominators need no collective
        age1 = ages + np.float32(1.0)
        decay = np.float32(opts.staleness_decay)
        w_all = np.where(hard, np.float32(1.0), present * np.where(
            age1 <= opts.staleness_bound, decay ** (age1 - np.float32(1.0)),
            np.float32(0.0))).astype(np.float32)
        a_all = np.where(hard, np.float32(1.0), present).astype(np.float32)
        den, da = np.float32(w_all.sum()), np.float32(a_all.sum())
        w_r, a_r = float(w_all[r]), float(a_all[r])
        with torch.no_grad():
            stats = self._worker_stats(losses, gnorms)
            buf = ts.telemetry
            spec = self.model._telemetry_spec()
            if spec is not None and has_buffer(buf) and n > 1:
                buf = spec.record_replica(buf, values=stats,
                                          iteration=ts.iteration + k - 1)
            # θ' = θ + Σ w·(local − base) / Σ w
            srv = tree_leaves(ts.params)
            delta = _reduce_leaves([w_r * (l - b) for l, b in zip(
                tree_leaves(lp), tree_leaves(el["base_params"]))])
            theta = [s + d / float(max(den, 1e-12)) if den > 0 else s
                     for s, d in zip(srv, delta)]
            new_theta = _rebuild(ts.params, theta)

            # model and updater state: the members' adoption-weighted
            # mean; integer leaves keep the server's copy
            def merge(server_tree, local_tree):
                s_leaves = tree_leaves(server_tree)
                summed = _reduce_leaves([
                    a_r * l if l.is_floating_point() else l
                    for l in tree_leaves(local_tree)])
                return _rebuild(server_tree, [
                    s if not s.is_floating_point() else
                    (v / float(max(da, 1e-12)) if da > 0 else s)
                    for s, v in zip(s_leaves, summed)])
            new_ms = merge(ts.model_state, ms)
            new_opt = (merge(ts.opt_state, lo) if self.average_updaters
                       else ts.opt_state)
            adopt = hard or present[r] > 0

            def take(new, old):
                if not old.is_floating_point():
                    return old          # counts advance locally
                return new if adopt else old
            el["local_params"] = tree_map(take, new_theta, lp)
            el["base_params"] = tree_map(take, new_theta,
                                         el["base_params"])
            el["local_opt"] = (tree_map(take, new_opt, lo)
                               if self.average_updaters else lo)
            loss = all_reduce_(losses.mean().reshape(1)).reshape(()) / n
        self._elastic_bookkeeping(present, hard, stats)
        return TrainState(new_theta, new_ms, new_opt, ts.iteration + k,
                          buf), loss

    def _elastic_bookkeeping(self, present, hard, stats):
        el, opts, n = self._elastic, self.elastic_options, self.num_workers
        ages = el["ages"]
        age1 = ages + 1.0
        adopted = np.ones(n, dtype=bool) if hard else present > 0
        merged_stale = int(np.sum(adopted & (age1 > 1)
                                  & (age1 <= opts.staleness_bound)))
        discarded_stale = 0 if hard else int(
            np.sum(adopted & (age1 > opts.staleness_bound)))
        dropped = int(np.sum(~adopted))
        el["ages"] = np.where(adopted, 0.0, age1).astype(np.float32)
        el["round"] += 1
        # one small fetch a round: the guard needs the grad norms
        gnorms = stats[:, 1].cpu().numpy()
        finite = gnorms[np.isfinite(gnorms)]
        if finite.size < gnorms.size:
            div = float("inf")      # a non-finite worker IS divergence
        elif finite.size >= 2:
            scale = float(np.mean(np.abs(finite)))
            div = float((finite.max() - finite.min()) / (scale + 1e-12))
        else:
            div = 0.0
        el["hard_next"] = div > opts.divergence_threshold
        self._publish_elastic(n - dropped, dropped, merged_stale,
                              discarded_stale, float(el["ages"].max()),
                              div, hard)

    def _publish_elastic(self, members, dropped, merged_stale,
                         discarded_stale, max_age, div, was_hard):
        from deeplearning4j_tpu_torch.observe.registry import \
            default_registry
        r = default_registry()
        s = "elastic"
        r.gauge("dl4j_elastic_round_members", "workers whose delta was "
                "merged in the latest ASYNC_ELASTIC round").set(
            members, session=s)
        r.gauge("dl4j_elastic_staleness", "max rounds any worker has "
                "drifted without adopting the server params").set(
            max_age, session=s)
        if dropped:
            r.counter("dl4j_elastic_stragglers_dropped_total", "workers "
                      "dropped from a round for missing the deadline"
                      ).inc(dropped, session=s)
        if merged_stale:
            r.counter("dl4j_elastic_stale_merged_total", "late worker "
                      "contributions merged staleness-weighted").inc(
                merged_stale, session=s)
        if discarded_stale:
            r.counter("dl4j_elastic_stale_discarded_total", "late "
                      "contributions discarded past the staleness bound"
                      ).inc(discarded_stale, session=s)
        if was_hard:
            r.counter("dl4j_elastic_hard_syncs_total", "rounds forced "
                      "into full synchronous averaging by the "
                      "divergence guard").inc(session=s)
        r.gauge("dl4j_replica_divergence", "relative max pairwise "
                "spread of per-replica grad norms (0 = replicas in "
                "sync)").set(div, session=s)
