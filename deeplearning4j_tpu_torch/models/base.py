"""Base model: the precision policy and the fit-loop core.

The JAX package's ``compute_cast`` and ``cast_params``: with
``compute_dtype="bfloat16"`` the graph input and every floating
**parameter** are rounded to bf16 for the forward (inside the loss, so
gradients pass back through the cast to the f32 masters), while the
layer **state** (BatchNorm running statistics) stays float32 and the
master parameters stay as stored.

``BaseModel`` holds the shared part of the fit loop (reference:
MultiLayerNetwork.fit, nn/multilayer/MultiLayerNetwork.java:1268) with
the JAX package's semantics: ``fit(DataSet)`` is one optimizer step;
``fit(iterator, epochs, k_steps, prefetch, byte_budget)`` runs each epoch
through the device feeder (datasets/feeder.py), wrapping a plain iterator
in an ``AsyncDataSetIterator``, grouping K batches into one
``make_scan_train_step`` call when ``k_steps > 1``, and resetting the
iterator after each epoch. ``evaluate`` and ``evaluate_regression`` bring
each batch's predictions to the host once and accumulate them in the
numpy evaluation classes (evaluation/evaluation.py). ``score`` and
``compute_loss`` read the loss. The iteration count is a host int,
advanced by each step (the JAX package's host mirror of its device
scalar). ``k_steps`` and ``prefetch`` left at None take the tuned
``fit.k_steps`` and ``feeder.depth`` of an installed process
``TunedConfig`` (optimize/autotune.py), else the defaults (1 and
``feeder.DEFAULT_DEPTH``); an explicit argument wins, and a tuned k the
feeder cannot serve degrades to 1 where an explicit one raises.
``conf_global`` is the configuration's global part and ``clone`` a
copy that trains on independently (``_clone_into``).

The observed loop is the JAX package's too: listeners
(optimize/listeners.py; ``set_listeners``, ``add_listeners``) fire once
a dispatch and at each epoch's start and end; an attached
``TelemetryCollector`` (``set_telemetry``) has every optimizer step,
TBPTT segments included, write a row into a ring on the card that is
fetched once every ``flush_interval`` steps and once more when a fit
ends; a ``SpanTracer`` (``set_tracer``) records ``etl``,
``host_to_device``, ``dispatch`` and ``telemetry_flush`` spans; and
every exception leaving ``fit`` passes through the flight recorder
(``set_flight_recorder``, else the process-wide default) before it is
raised again.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       DataSetIterator,
                                                       MultiDataSet)
from deeplearning4j_tpu_torch.datasets.feeder import (DEFAULT_DEPTH,
                                                      DeviceFeeder)
from deeplearning4j_tpu_torch.datasets.iterators import AsyncDataSetIterator
from deeplearning4j_tpu_torch.evaluation.evaluation import (
    Evaluation, RegressionEvaluation)
from deeplearning4j_tpu_torch.ops import tensor_split
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    carry_core, first_bidirectional_name, warn_tbptt_bidirectional)
from deeplearning4j_tpu_torch.observe.flight_recorder import \
    default_flight_recorder
from deeplearning4j_tpu_torch.observe.tracer import get_tracer
from deeplearning4j_tpu_torch.optimize.autotune import tuned_value
from deeplearning4j_tpu_torch.optimize.solver import (TrainState,
                                                      make_constrain_fn,
                                                      make_tbptt_train_step)
from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves, tree_map

# params[layer][key], where a layer's params may nest further
# (params[block]["attn"]["Wqkv"])
Tree = Dict[str, Dict[str, Any]]


def compute_cast(x: torch.Tensor, dt: str) -> torch.Tensor:
    """Cast an activation to the configured compute dtype (bf16 policy)."""
    if dt == "bfloat16" and x.is_floating_point():
        return x.to(torch.bfloat16)
    return x


def cast_params(lp: Dict[str, Any], dt: str) -> Dict[str, Any]:
    """A layer's float params (nested dicts too) in the compute dtype (a
    no-op for params already held in it, e.g. a serving engine's
    committed bf16 copy)."""
    if dt != "bfloat16":
        return lp
    return tree_map(lambda v: v.to(torch.bfloat16) if v.is_floating_point()
                    else v, lp)


def moe_aux_loss(state) -> Optional[torch.Tensor]:
    """The sum of the auxiliary losses that layers surface through their
    state (MixtureOfExperts' load-balancing and router-z term,
    ``moe_aux_loss``), which the models add to the training loss; None
    when no layer has one."""
    terms = [s["moe_aux_loss"] for s in state.values()
             if isinstance(s, dict) and "moe_aux_loss" in s]
    return sum(terms[1:], terms[0]) if terms else None


class BaseModel:
    """The fit core shared by the models (parameters, state, optimizer
    state, iteration and the telemetry ring as one ``train_state``;
    ``fit``, ``score``, ``set_params``, the listener and observability
    hooks); a subclass provides ``init``, ``_build_train_step``,
    ``_step_args`` and ``compute_loss``."""

    def __init__(self):
        self._train_step = None
        self._scan_step = None
        self._last_loss: Optional[torch.Tensor] = None
        self.iteration = 0
        self.epoch_count = 0
        # the last fit's feeder (its stall_ms), None after an unfed fit
        self.last_feeder: Optional[DeviceFeeder] = None
        self._tbptt_step = None
        # the per-segment losses (device tensors) of the last TBPTT batch
        self.last_segment_losses = []
        self.listeners: List[Any] = []
        # observability (observe/): all optional; unset, they cost one
        # branch a step
        self._telemetry = None
        self._telemetry_buf: Any = ()
        self.tracer = None
        # None: the process-wide default recorder, armed unless
        # DL4J_CRASH_DUMPS=0 (the reference's CrashReportingUtil is on
        # by default too)
        self._flight_recorder = None
        # set by a listener (the early-stopping trainer's iteration
        # conditions) to end the running fit after the current dispatch
        self._stop_requested = False
        # a tensor-parallel plan (parallel/tensor_parallel.py): its layers
        # run on this rank's slices with their split points open
        self._tp_plan = None

    def _split(self, name: str):
        """The split points of layer ``name`` under the tensor-parallel
        plan (ops/tensor_split.py), or nothing without one."""
        plan = self._tp_plan
        return tensor_split.split(None if plan is None
                                  else plan.split_spec(name))

    # ---- listeners and observability -------------------------------------
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    @property
    def telemetry(self):
        """The attached TelemetryCollector, or None."""
        return self._telemetry

    def set_telemetry(self, collector):
        """Attach an ``observe.TelemetryCollector``: the next train steps
        built record its spec's row each optimizer step into a ring on
        the model's device, carried in the train state, and the
        collector fetches the ring every ``flush_interval`` steps in one
        transfer. Pass None to detach."""
        if collector is not None:
            collector.spec_for(self)
        self._telemetry = collector
        # the spec is part of the built steps: rebuild them
        self._train_step = None
        self._scan_step = None
        self._tbptt_step = None
        return self

    def set_tracer(self, tracer):
        """Attach an ``observe.SpanTracer`` recording etl, host_to_device,
        dispatch and telemetry_flush spans around the fit loop."""
        self.tracer = tracer
        return self

    def set_flight_recorder(self, recorder):
        """Attach an ``observe.FlightRecorder`` (post-mortem dumps on a
        non-finite row, an OOM or any exception leaving ``fit``). Without
        one the process-wide default recorder is used; a recorder with
        ``enabled=False`` opts this model out without touching the
        environment."""
        self._flight_recorder = recorder
        return self

    def _recorder(self):
        if self._flight_recorder is not None:
            return self._flight_recorder
        return default_flight_recorder()

    def _telemetry_spec(self):
        return (None if self._telemetry is None
                else self._telemetry.spec_for(self))

    def _ensure_ring(self):
        if self._telemetry is not None:
            self.train_state = self._telemetry.ensure_buffer(
                self.train_state, self.device)

    def _post_step(self, steps: int = 1) -> int:
        """The epilogue of each dispatch: give the telemetry collector its
        flush opportunity (one fetch when an interval completed, nothing
        otherwise) and let the flight recorder scan what that flush
        decoded (host-side history only). Returns the iteration count."""
        tel = self._telemetry
        if tel is not None:
            if tel.will_flush(steps):
                with get_tracer(self).span("telemetry_flush",
                                           cat="telemetry"):
                    tel.on_step(self.train_state, steps)
                rec = self._recorder()
                if rec is not None:
                    rec.poll(self)
            else:
                tel.on_step(self.train_state, steps)
        return self.iteration

    def _notify(self, it: int, loss, etl_ms: float, n_examples: int):
        """The listeners' ``iteration_done`` after a dispatch."""
        for lst in self.listeners:
            lst.iteration_done(self, it, self.epoch_count, loss, etl_ms,
                               n_examples)
        self._last_loss = loss

    # ---- fit loop -------------------------------------------------------
    def fit(self, data, epochs: int = 1, k_steps: Optional[int] = None,
            prefetch: Optional[int] = None,
            byte_budget: Optional[int] = None):
        """fit(DataSet) / fit(DataSetIterator[, epochs]) — the reference's
        MultiLayerNetwork.fit(DataSetIterator) loop.

        A DataSet (or a MultiDataSet, for a ComputationGraph) is one
        step. An iterator runs through the DeviceFeeder: the next
        ``prefetch`` batches (default 2) are staged onto the device while
        the current step runs, and a plain iterator is wrapped in an
        AsyncDataSetIterator so host batch production overlaps too. Wrap
        the iterator in AsyncShieldDataSetIterator or pass ``prefetch=0``
        for the synchronous loop. ``k_steps > 1`` groups K staged batches
        into one K-step call (padding a ragged batch to the bucket with a
        zero labels mask) and needs the feeder: without it, it raises.
        ``iteration`` advances by one per optimizer step, ``epoch_count``
        by one per epoch, and the iterator is reset after each epoch.
        Listeners fire once a dispatch (with a K-step call's last loss)
        and at each epoch's start and end; telemetry records a row per
        optimizer step and is flushed once more when the fit ends.

        Any exception leaving the loop (an OOM included) first passes
        through the flight recorder, which writes a post-mortem dump, and
        is then raised again: the crash still surfaces, and the evidence
        survives."""
        try:
            return self._fit_inner(data, epochs, k_steps, prefetch,
                                   byte_budget)
        except Exception as e:
            rec = self._recorder()
            if rec is not None:
                rec.record_crash(self, exc=e)
            raise

    def _fit_inner(self, data, epochs, k_steps, prefetch, byte_budget):
        if self.params is None:
            self.init()
        if self._train_step is None:
            self._train_step = self._build_train_step()
        if isinstance(data, MultiDataSet) and not self._multi_inputs:
            raise TypeError("MultiDataSet requires a ComputationGraph; wrap "
                            "single-input data in a DataSet for "
                            "MultiLayerNetwork")
        self._stop_requested = False
        tracer = get_tracer(self)
        if isinstance(data, (DataSet, MultiDataSet)):
            # one step: _post_step already flushed if an interval
            # completed (a flush here would make a fit-per-batch calling
            # loop fetch every step)
            self._fit_batch(data)
            return self
        iterator = data
        # left at None, k_steps and prefetch take the installed process
        # TunedConfig's values, else the committed defaults
        k_tuned = False
        if k_steps is None:
            k_steps = tuned_value("fit.k_steps")
            k_tuned = k_steps is not None
        k = 1 if k_steps is None else int(k_steps)
        if k < 1:
            raise ValueError("k_steps must be >= 1")
        if prefetch is None:
            prefetch = tuned_value("feeder.depth")
        depth = DEFAULT_DEPTH if prefetch is None else int(prefetch)
        feed = (depth > 0 and self._feed_supported()
                and getattr(iterator, "async_supported", True))
        if k > 1 and not feed:
            if k_tuned:
                # a machine-tuned k never breaks a fit the feeder cannot
                # serve: implicit tuning degrades, explicit asks raise
                k = 1
            else:
                raise ValueError(
                    "k_steps > 1 needs the device feeder: prefetch must be "
                    ">= 1, the iterator async-capable (no AsyncShield), and "
                    "the model not configured for TBPTT")
        source = iterator
        if (feed and isinstance(iterator, DataSetIterator)
                and not isinstance(iterator, AsyncDataSetIterator)):
            source = AsyncDataSetIterator(iterator)
        feeder = (DeviceFeeder(source, device=self.device, depth=depth,
                               byte_budget=byte_budget, k_steps=k,
                               tracer=tracer)
                  if feed else None)
        self.last_feeder = feeder
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self, self.epoch_count)
            if feeder is not None:
                for item in feeder:
                    self._fit_item(feeder, item, tracer)
                    if self._stop_requested:
                        break
            else:
                it_start = time.perf_counter()
                for batch in iterator:
                    now = time.perf_counter()
                    tracer.add_span("etl", it_start, now, cat="data")
                    self._fit_batch(batch, etl_ms=(now - it_start) * 1e3)
                    if self._stop_requested:
                        break
                    it_start = time.perf_counter()
            if isinstance(source, DataSetIterator):
                source.reset()
            for lst in self.listeners:
                lst.on_epoch_end(self, self.epoch_count)
            self.epoch_count += 1
            if self._stop_requested:
                break
        # the tail flush: the last (< flush_interval) rows are not left
        # on the card when training ends
        if self._telemetry is not None:
            with tracer.span("telemetry_flush", cat="telemetry"):
                self._telemetry.flush(self.train_state)
            rec = self._recorder()
            if rec is not None:
                rec.poll(self)
        return self

    _multi_inputs = False   # a ComputationGraph also takes MultiDataSets

    def _feed_supported(self) -> bool:
        """TBPTT slices batches along time on the host, so those configs
        take the unfed path; everything else can be staged ahead."""
        return getattr(getattr(self, "conf", None), "backprop_type",
                       None) != "tbptt"

    # ---- truncated BPTT (reference: doTruncatedBPTT) --------------------
    def _named_layers(self):
        """(name, layer) of every layer, in order; a subclass provides."""
        raise NotImplementedError

    def _recurrent_carry_nodes(self):
        """(name, core, is_lstm) of every layer whose hidden state crosses
        TBPTT segments and ``rnn_time_step`` calls: LSTM and SimpleRnn
        cores, looking through LastTimeStep and MaskZeroLayer."""
        return [(name,) + cc for name, layer in self._named_layers()
                if (cc := carry_core(layer)) is not None]

    def _zero_carries(self, batch_size: int) -> Dict[str, Any]:
        """Zero initial states at a new batch, in the compute dtype (bf16
        carries under bf16 compute, the dtype of the ``zx`` the LSTM
        kernels see)."""
        dt = (torch.bfloat16 if self.conf.global_config.compute_dtype
              == "bfloat16" else torch.float32)
        out = {}
        for name, core, is_lstm in self._recurrent_carry_nodes():
            h = torch.zeros((batch_size, core.n_out), dtype=dt,
                            device=self.device)
            out[name] = (h, h) if is_lstm else h
        return out

    def _carries_of(self, model_state) -> Dict[str, Any]:
        """The carries a new state hands on: (h, c) of an LSTM core, h of
        a SimpleRnn."""
        return {name: ((model_state[name]["last_h"],
                        model_state[name]["last_c"])
                       if is_lstm else model_state[name]["last_h"])
                for name, _, is_lstm in self._recurrent_carry_nodes()}

    def _build_tbptt_step(self):
        return make_tbptt_train_step(
            self._loss, self._tx, self._carries_of,
            make_constrain_fn(self._constraint_layers()),
            telemetry=self._telemetry_spec())

    def _start_tbptt(self, batch_size: int) -> Dict[str, Any]:
        """Warn about a bidirectional layer (its backward direction is cut
        at every segment boundary), build the segment step once, attach
        the telemetry ring, and return the batch's zero carries."""
        bidi = first_bidirectional_name(self._named_layers())
        if bidi is not None:
            warn_tbptt_bidirectional(bidi)
        if self._tbptt_step is None:
            self._tbptt_step = self._build_tbptt_step()
        self._ensure_ring()
        return self._zero_carries(batch_size)

    def _tbptt_segment(self, *args, carries):
        """One segment's dispatch (a ``dispatch`` span); returns (loss,
        carries handed on)."""
        with get_tracer(self).span("dispatch", cat="step"):
            self.train_state, loss, carries = self._tbptt_step(
                self.train_state, *args, self._generator, carries)
        return loss, carries

    def _end_tbptt(self, losses, etl_ms: float, n_examples: int):
        """After a TBPTT batch: the epilogue over its segments (the
        iteration count went up by one a segment) and the listeners, once,
        with the last segment's loss."""
        self.last_segment_losses = losses
        self._notify(self._post_step(len(losses)), losses[-1], etl_ms,
                     n_examples)

    def _staged_step_args(self, features, labels, fmask, lmask):
        """Adapt staged tensors to this model's step signature (the
        ComputationGraph wraps singles into input/output tuples)."""
        return features, labels, fmask, lmask

    def _dispatch(self, step, args, **span_args):
        """One train-step call on the current train state, inside a
        ``dispatch`` span; returns the call's loss (or losses)."""
        with get_tracer(self).span("dispatch", cat="step", **span_args):
            self.train_state, loss = step(self.train_state, *args,
                                          self._generator)
        return loss

    def _fit_batch(self, batch, etl_ms: float = 0.0):
        """One step on a host batch (moved to the device here, inside a
        ``host_to_device`` span)."""
        with get_tracer(self).span("host_to_device", cat="data"):
            args = self._step_args(batch)
        self._ensure_ring()
        loss = self._dispatch(self._train_step, args)
        self._notify(self._post_step(), loss, etl_ms, batch.num_examples())

    def _fit_item(self, feeder: DeviceFeeder, item, tracer):
        """One feeder item: a passthrough object (``k == 0``) takes the
        unfed step, a staged batch one step, a K-group one K-step call
        (the iteration advances by K, telemetry records K rows, the
        listeners fire once with the last inner loss and the group's real
        example count)."""
        if item.k == 0:
            self._fit_batch(item.raw, etl_ms=item.queue_wait_ms)
            return
        item = feeder.hand_off(item)
        args = self._staged_step_args(item.features, item.labels,
                                      item.features_mask, item.labels_mask)
        self._ensure_ring()
        if item.k == 1:
            loss = self._dispatch(self._train_step, args)
        else:
            if self._scan_step is None:
                self._scan_step = self._build_scan_train_step()
            loss = self._dispatch(self._scan_step, args, k=item.k)[-1]
        self._notify(self._post_step(item.k), loss, item.queue_wait_ms,
                     item.n_examples)

    # ---- evaluation -------------------------------------------------------
    def _output_for_eval(self, batch: DataSet) -> torch.Tensor:
        """Inference with the batch's features mask threaded through."""
        return self.output(batch.features, mask=batch.features_mask)

    def _eval_batches(self, iterator):
        """(batch, host predictions) of a DataSet or an iterator; an
        iterator is reset after its pass."""
        single = isinstance(iterator, DataSet)
        for batch in ([iterator] if single else iterator):
            yield batch, self._output_for_eval(batch).float().cpu().numpy()
        if not single and isinstance(iterator, DataSetIterator):
            iterator.reset()

    def evaluate(self, iterator, evaluation: Optional[Evaluation] = None
                 ) -> Evaluation:
        """Classification metrics over a DataSet or an iterator
        (reference: MultiLayerNetwork.evaluate); the labels mask, else the
        features mask, masks the rows."""
        e = evaluation or Evaluation()
        for batch, preds in self._eval_batches(iterator):
            e.eval(batch.labels, preds,
                   mask=batch.labels_mask if batch.labels_mask is not None
                   else batch.features_mask)
        return e

    def evaluate_regression(self, iterator) -> RegressionEvaluation:
        """Regression metrics over a DataSet or an iterator (reference:
        MultiLayerNetwork.evaluateRegression)."""
        e = RegressionEvaluation()
        for batch, preds in self._eval_batches(iterator):
            e.eval(batch.labels, preds, mask=batch.labels_mask)
        return e

    def score(self, dataset: Optional[DataSet] = None) -> float:
        """Loss on a dataset (reference: MultiLayerNetwork.score(DataSet)),
        or the last training loss when called without arguments."""
        if dataset is None:
            if self._last_loss is None:
                raise RuntimeError("no score yet: call fit() first or pass a"
                                   " DataSet to score(dataset)")
            return float(self._last_loss)
        return float(self.compute_loss(dataset))

    @property
    def train_state(self) -> TrainState:
        """(params, model_state, opt_state, iteration, telemetry ring) as
        one value, the shape the train steps take and return."""
        return TrainState(self.params, self.model_state, self.opt_state,
                          self.iteration, self._telemetry_buf)

    @train_state.setter
    def train_state(self, ts: TrainState):
        (self.params, self.model_state, self.opt_state, self.iteration,
         self._telemetry_buf) = TrainState(*ts)

    def set_params(self, params: Tree, model_state: Optional[Tree] = None):
        """Replace parameters (and state) with tensors of the same names
        and shapes as this model's; a missing, extra or mis-shaped leaf
        raises. Floating leaves keep the incoming dtype."""
        if self.params is None:
            self.init()
        self.params = conform(self.params, params, self.device, "params")
        if model_state is not None:
            self.model_state = conform(self.model_state, model_state,
                                        self.device, "state")

    def num_params(self) -> int:
        return sum(v.numel() for v in tree_leaves(self.params or {}))

    @property
    def conf_global(self):
        """The configuration's global settings (seed, updater, compute
        dtype, ...)."""
        return self.conf.global_config

    def _clone_into(self, m: "BaseModel") -> "BaseModel":
        """``m`` (a fresh model of this configuration, not initialized)
        given copies of this model's parameters, state, optimizer state,
        counters and generator state: the two then train independently
        from the same point."""
        if self.params is not None:
            m._tx = m._make_tx()
            m.params, m.model_state, m.opt_state = (
                _copy_tree(t) for t in (self.params, self.model_state,
                                        self.opt_state))
            m.iteration = self.iteration
            m.epoch_count = self.epoch_count
            m._generator = torch.Generator(device=self.device)
            m._generator.set_state(self._generator.get_state())
        return m

    def _as_tensor(self, a) -> Optional[torch.Tensor]:
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)


def _copy_tree(tree):
    """A copy of nested dicts, lists and tuples whose tensors are cloned."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def conform(template: Tree, new: Tree, device: torch.device,
            what: str) -> Tree:
    """``new`` checked name for name (at every level of nesting) and shape
    for shape against ``template``, moved to ``device``."""
    if not isinstance(new, dict) or set(new) != set(template):
        got = set(new) if isinstance(new, dict) else set()
        raise KeyError(f"{what}: names differ: missing "
                       f"{sorted(set(template) - got)}, unexpected "
                       f"{sorted(got - set(template))}")
    out = {}
    for k, t in template.items():
        where = f"{what}[{k!r}]"
        if isinstance(t, dict):
            out[k] = conform(t, new[k], device, where)
            continue
        v = torch.as_tensor(new[k])
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{where}: shape {tuple(v.shape)} != "
                             f"{tuple(t.shape)}")
        out[k] = v.to(device)
    return out
