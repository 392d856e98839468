"""ComputationGraph — arbitrary-DAG model.

Analog of the reference's ``ComputationGraph``
(nn/graph/ComputationGraph.java:93 — init():377, topologicalSortOrder()
:1216) in the JAX package's form: parameters and layer state are plain
dicts keyed ``params[layer][key]``, and the forward walks the
configuration's topological order, calling each layer's ``apply``.
A step is the loss of the walk in train mode (output layers' losses on
their logits, plus L1/L2), ``torch.autograd`` for the gradients in place
of backprop in reverse topological order, and the configured updater
(optimize/solver.py); ``fit`` takes a DataSet, a MultiDataSet or an
iterator (models/base.py), and ``make_scan_train_step`` runs K steps in
one call.

The model lives on one device, chosen at construction: ``cuda`` unless
the caller passes ``device="cpu"`` (utils/device.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models.base import (BaseModel, Tree,
                                                  cast_params, compute_cast)
from deeplearning4j_tpu_torch.nn.graph.config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.optimize.solver import (build_optimizer,
                                                      make_scan_train_step,
                                                      make_train_step)
from deeplearning4j_tpu_torch.optimize.updaters import (tree_leaves,
                                                         tree_map)
from deeplearning4j_tpu_torch.utils.device import DeviceLike, resolve_device


class ComputationGraph(BaseModel):
    def __init__(self, conf: ComputationGraphConfiguration,
                 device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)
        self.conf = conf
        conf.resolve()
        self._topo = conf.topological_order()
        self._nodes = {n.name: n for n in conf.nodes}
        self._layer_nodes = [n for n in conf.nodes if n.layer is not None]
        self.layer_names = tuple(n.name for n in self._layer_nodes)
        self.params: Optional[Tree] = None
        self.model_state: Optional[Tree] = None
        self.opt_state = None
        self._tx = None
        self._generator = None

    # ---- init -----------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Random parameters from a ``torch.Generator`` seeded with the
        configuration's seed (or ``seed``); drawn on the CPU so they do
        not depend on the device, then moved to it once."""
        g = self.conf.global_config
        gen = torch.Generator().manual_seed(g.seed if seed is None else seed)
        params: Tree = {}
        state: Tree = {}
        for node in self._layer_nodes:
            it = self.conf.layer_input_type(node.name)
            layer = node.layer
            lp = layer.initialize(gen, it) if layer.has_params else {}
            params[node.name] = tree_map(lambda v: v.to(self.device), lp)
            state[node.name] = tree_map(lambda v: v.to(self.device),
                                        layer.init_state(it))
        self.params, self.model_state = params, state
        self._tx = self._make_tx()
        self.opt_state = self._tx.init(params)
        self.iteration = 0
        self._train_step = None
        # dropout's random numbers (the JAX package's step keys)
        self._generator = torch.Generator(device=self.device).manual_seed(
            g.seed if seed is None else seed)
        return self

    def _make_tx(self):
        g = self.conf.global_config
        return build_optimizer(
            self.layer_names,
            {n.name: n.layer.updater for n in self._layer_nodes},
            {n.name: n.layer.frozen for n in self._layer_nodes},
            g.updater, g.gradient_normalization)

    # ---- forward --------------------------------------------------------
    def _walk(self, params: Tree, model_state: Tree,
              inputs: Dict[str, torch.Tensor], train: bool = False,
              generator: Optional[torch.Generator] = None,
              stop_before_loss: bool = False):
        """Execute the DAG; returns (activations, new model state). With
        ``stop_before_loss`` an output layer that has ``compute_loss``
        stores (input, params, context) for the loss instead of running."""
        dt = self.conf.global_config.compute_dtype
        acts = {k: compute_cast(v, dt) for k, v in inputs.items()}
        new_state = dict(model_state)
        ctx = LayerContext(train=train, generator=generator)
        for name in self._topo:
            node = self._nodes[name]
            xs = [acts[s] for s in node.inputs]
            if node.layer is None:
                acts[name] = node.vertex.apply(*xs)
                continue
            x = xs[0]
            if node.preprocessor is not None:
                x = node.preprocessor.apply(x)
            lp = cast_params(params.get(name, {}), dt)
            if stop_before_loss and name in self.conf.network_outputs and \
                    hasattr(node.layer, "compute_loss"):
                acts[name] = (x, lp, ctx)
                continue
            acts[name], new_state[name] = node.layer.apply(
                lp, model_state.get(name, {}), x, ctx)
        return acts, new_state

    def _loss(self, params, model_state, features, labels, fmasks, lmasks,
              generator, iteration):
        """(total loss, new model state) of one batch in train mode: every
        output's loss in promote(f32, param dtype), plus each layer's
        L1/L2 penalty."""
        inputs = dict(zip(self.conf.network_inputs, features))
        acts, new_state = self._walk(params, model_state, inputs, True,
                                     generator, stop_before_loss=True)
        leaves = tree_leaves(params)
        acc = (torch.promote_types(torch.float32, leaves[0].dtype)
               if leaves else torch.float32)
        total = torch.zeros((), dtype=acc, device=self.device)
        for i, out_name in enumerate(self.conf.network_outputs):
            node = self._nodes[out_name]
            entry = acts[out_name]
            if not isinstance(entry, tuple):
                raise TypeError(f"output node '{out_name}' is not a loss-"
                                "bearing layer")
            x, lp, ctx = entry
            lmask = lmasks[i] if lmasks and i < len(lmasks) else None
            if lmask is not None:
                ctx = dataclasses.replace(ctx, mask=lmask)
            loss = node.layer.compute_loss(
                lp, model_state.get(out_name, {}), x, labels[i], ctx)
            total = total + loss.to(acc)
        for n in self._layer_nodes:
            total = total + n.layer.regularization_loss(params.get(n.name,
                                                                   {}))
        return total, new_state

    def _check_trainable(self):
        for n in self._layer_nodes:
            if n.layer.constraints or n.layer.weight_noise is not None:
                raise NotImplementedError(
                    f"layer '{n.name}': constraints and weight noise are not "
                    "ported yet")

    def _build_train_step(self):
        self._check_trainable()
        return make_train_step(self._loss, self._tx)

    def _build_scan_train_step(self):
        """K steps per call over (K, B, ...) tuples of inputs/labels."""
        self._check_trainable()
        return make_scan_train_step(self._loss, self._tx)

    def _step_args(self, batch):
        """(features, labels, fmasks, lmasks) tuples on the device."""
        t = self._as_tensor
        if isinstance(batch, MultiDataSet):
            masks = lambda ms: (None if not ms
                                else tuple(t(m) for m in ms))
            return (tuple(t(f) for f in batch.features),
                    tuple(t(l) for l in batch.labels),
                    masks(batch.features_masks), masks(batch.labels_masks))
        return ((t(batch.features),), (t(batch.labels),),
                None if batch.features_mask is None
                else (t(batch.features_mask),),
                None if batch.labels_mask is None
                else (t(batch.labels_mask),))

    _multi_inputs = True

    def _staged_step_args(self, features, labels, fmask, lmask):
        """The feeder stages plain DataSets; this graph's step takes
        input/output tuples."""
        return ((features,), (labels,),
                None if fmask is None else (fmask,),
                None if lmask is None else (lmask,))

    def _output_for_eval(self, batch):
        if batch.features_mask is not None:
            raise NotImplementedError(
                "ComputationGraph.evaluate with a features mask is not "
                "ported yet (output() takes no mask)")
        return self.output(batch.features)

    def compute_loss(self, dataset):
        """The training loss (batch statistics, no update) on a batch."""
        if self.params is None:
            self.init()
        feats, labels, fmasks, lmasks = self._step_args(dataset)
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.model_state, feats,
                                 labels, fmasks, lmasks, None,
                                 self.iteration)
        return loss

    def inference_state(self, params: Tree, model_state: Tree) -> Tree:
        """``model_state`` with each layer's inference constants folded in
        (layers that define ``fold_inference_state``, e.g. the fused
        block's BN scale/shift), computed from ``params`` cast to the
        compute dtype exactly as the forward casts them — so a forward on
        the folded state gives the same bits as one on the plain state."""
        dt = self.conf.global_config.compute_dtype
        out = dict(model_state)
        with torch.inference_mode():
            for node in self._layer_nodes:
                fold = getattr(node.layer, "fold_inference_state", None)
                if fold is not None:
                    out[node.name] = fold(cast_params(params[node.name], dt),
                                          model_state[node.name])
        return out

    def build_inference_fn(self):
        """Pure inference forward ``(params, model_state, x) -> y`` for
        single-input single-output graphs — the shape the serving engine
        (parallel/serving.py) batches over."""
        if len(self.conf.network_inputs) != 1 or \
                len(self.conf.network_outputs) != 1:
            raise ValueError(
                "build_inference_fn requires a single-input single-output"
                f" graph; this one has inputs={self.conf.network_inputs}"
                f" outputs={self.conf.network_outputs}")
        if self.params is None:
            self.init()
        in_name = self.conf.network_inputs[0]
        out_name = self.conf.network_outputs[0]

        def fwd(params, model_state, x):
            with torch.inference_mode():
                return self._walk(params, model_state,
                                  {in_name: x})[0][out_name]
        return fwd

    def output(self, *features):
        """Forward pass on this model's device; returns a tensor for
        single-output graphs, else a list (reference:
        ComputationGraph.output(INDArray...))."""
        if self.params is None:
            self.init()
        if len(features) == 1 and isinstance(features[0], (list, tuple)):
            features = tuple(features[0])
        inputs = {k: self._as_tensor(f)
                  for k, f in zip(self.conf.network_inputs, features)}
        with torch.inference_mode():
            acts, _ = self._walk(self.params, self.model_state, inputs)
        outs = [acts[o] for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def summary(self) -> str:
        lines = [f"{'name':<24}{'type':<26}{'inputs':<30}{'params':>10}"]
        for name in self._topo:
            node = self._nodes[name]
            kind = (type(node.layer).__name__ if node.layer is not None
                    else type(node.vertex).__name__)
            n = sum(v.numel() for v in (self.params or {}).get(name,
                                                                {}).values())
            lines.append(f"{name:<24}{kind:<26}"
                         f"{','.join(node.inputs):<30}{n:>10}")
        lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)

