"""Base model: the precision policy and the fit-loop core.

The JAX package's ``compute_cast`` and ``cast_params``: with
``compute_dtype="bfloat16"`` the graph input and every floating
**parameter** are rounded to bf16 for the forward (inside the loss, so
gradients pass back through the cast to the f32 masters), while the
layer **state** (BatchNorm running statistics) stays float32 and the
master parameters stay as stored.

``BaseModel`` holds the shared part of the fit loop (reference:
MultiLayerNetwork.fit, nn/multilayer/MultiLayerNetwork.java:1268): a
``fit(DataSet)`` is one optimizer step; ``score`` and ``compute_loss``
read the loss. The iteration count is a host int, advanced by each step
(the JAX package's host mirror of its device scalar). The device feeder,
listeners, telemetry and flight recorder are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
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
        self._last_loss: Optional[torch.Tensor] = None
        self.iteration = 0
        self.epoch_count = 0

    def fit(self, data: DataSet):
        """One optimizer step on the batch ``data`` (reference:
        MultiLayerNetwork.fit(DataSet)). Iterator fits through the device
        feeder are not ported yet; K steps per call go through
        ``make_scan_train_step`` (``_build_scan_train_step``)."""
        if not isinstance(data, DataSet):
            raise TypeError("fit: only fit(DataSet) is ported (one step); "
                            "the iterator fit loop waits")
        if self.params is None:
            self.init()
        if self._train_step is None:
            self._train_step = self._build_train_step()
        self.train_state, self._last_loss = self._train_step(
            self.train_state, *self._step_args(data), self._generator)
        return self

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
