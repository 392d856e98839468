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
scalar). The port has no autotune, so ``k_steps`` and ``prefetch`` are
the caller's or the defaults (1 and ``feeder.DEFAULT_DEPTH``).
Listeners, telemetry, the tracer and the flight recorder are not ported
yet (ROADMAP).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
from deeplearning4j_tpu_torch.optimize.solver import TrainState
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


class BaseModel:
    """The fit core shared by the models (parameters, state, optimizer
    state and iteration as one ``train_state``; ``fit``, ``score``,
    ``set_params``); a subclass provides ``init``, ``_build_train_step``,
    ``_step_args`` and ``compute_loss``."""

    def __init__(self):
        self._train_step = None
        self._scan_step = None
        self._last_loss: Optional[torch.Tensor] = None
        self.iteration = 0
        self.epoch_count = 0
        # the last fit's feeder (its stall_ms), None after an unfed fit
        self.last_feeder: Optional[DeviceFeeder] = None

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
        by one per epoch, and the iterator is reset after each epoch."""
        if self.params is None:
            self.init()
        if self._train_step is None:
            self._train_step = self._build_train_step()
        if isinstance(data, MultiDataSet) and not self._multi_inputs:
            raise TypeError("MultiDataSet requires a ComputationGraph; wrap "
                            "single-input data in a DataSet for "
                            "MultiLayerNetwork")
        if isinstance(data, (DataSet, MultiDataSet)):
            self._fit_batch(data)
            return self
        iterator = data
        k = 1 if k_steps is None else int(k_steps)
        if k < 1:
            raise ValueError("k_steps must be >= 1")
        depth = DEFAULT_DEPTH if prefetch is None else int(prefetch)
        feed = (depth > 0 and self._feed_supported()
                and getattr(iterator, "async_supported", True))
        if k > 1 and not feed:
            raise ValueError(
                "k_steps > 1 needs the device feeder: prefetch must be >= 1, "
                "the iterator async-capable (no AsyncShield), and the model "
                "not configured for TBPTT")
        source = iterator
        if (feed and isinstance(iterator, DataSetIterator)
                and not isinstance(iterator, AsyncDataSetIterator)):
            source = AsyncDataSetIterator(iterator)
        feeder = (DeviceFeeder(source, device=self.device, depth=depth,
                               byte_budget=byte_budget, k_steps=k)
                  if feed else None)
        self.last_feeder = feeder
        for _ in range(epochs):
            if feeder is not None:
                for item in feeder:
                    self._fit_item(feeder, item)
            else:
                for batch in iterator:
                    self._fit_batch(batch)
            if isinstance(source, DataSetIterator):
                source.reset()
            self.epoch_count += 1
        return self

    _multi_inputs = False   # a ComputationGraph also takes MultiDataSets

    def _feed_supported(self) -> bool:
        """TBPTT slices batches along time on the host, so those configs
        take the unfed path; everything else can be staged ahead."""
        return getattr(getattr(self, "conf", None), "backprop_type",
                       None) != "tbptt"

    def _staged_step_args(self, features, labels, fmask, lmask):
        """Adapt staged tensors to this model's step signature (the
        ComputationGraph wraps singles into input/output tuples)."""
        return features, labels, fmask, lmask

    def _fit_batch(self, batch):
        """One step on a host batch (moved to the device here)."""
        self.train_state, self._last_loss = self._train_step(
            self.train_state, *self._step_args(batch), self._generator)

    def _fit_item(self, feeder: DeviceFeeder, item):
        """One feeder item: a passthrough object (``k == 0``) takes the
        unfed step, a staged batch one step, a K-group one K-step call."""
        if item.k == 0:
            self._fit_batch(item.raw)
            return
        item = feeder.hand_off(item)
        args = self._staged_step_args(item.features, item.labels,
                                      item.features_mask, item.labels_mask)
        if item.k == 1:
            self.train_state, self._last_loss = self._train_step(
                self.train_state, *args, self._generator)
            return
        if self._scan_step is None:
            self._scan_step = self._build_scan_train_step()
        self.train_state, losses = self._scan_step(
            self.train_state, *args, self._generator)
        self._last_loss = losses[-1]

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
        """(params, model_state, opt_state, iteration) as one value, the
        shape the train steps take and return."""
        return TrainState(self.params, self.model_state, self.opt_state,
                          self.iteration)

    @train_state.setter
    def train_state(self, ts: TrainState):
        self.params, self.model_state, self.opt_state, self.iteration = ts

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

    def _as_tensor(self, a) -> Optional[torch.Tensor]:
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)


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
