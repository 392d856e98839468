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
one call. Features masks go through the walk as the JAX package's do:
each recurrent layer (and ``LastTimeStepVertex``) sees its input's mask,
else the default (the first input's), and an output layer's loss is
bounded by its labels mask, else by that features mask. With
``backprop_type="tbptt"`` a sequence batch trains segment by segment
(reference: ComputationGraph.java:955): 3-D inputs and sequence labels
are sliced along time, a static (2-D) input goes whole into every
segment. ``rnn_time_step`` streams with stored state (reference:
rnnTimeStep:2720).

The model lives on one device, chosen at construction: ``cuda`` unless
the caller passes ``device="cpu"`` (utils/device.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models.base import (BaseModel, Tree,
                                                  cast_params, compute_cast,
                                                  moe_aux_loss)
from deeplearning4j_tpu_torch.models.multi_layer_network import _pad_time
from deeplearning4j_tpu_torch.nn.graph.config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph.vertices import LastTimeStepVertex
from deeplearning4j_tpu_torch.nn.inputs import RecurrentType
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.nn.layers.recurrent import \
    first_bidirectional_name
from deeplearning4j_tpu_torch.observe.tracer import get_tracer
from deeplearning4j_tpu_torch.optimize.solver import (build_optimizer,
                                                      make_constrain_fn,
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
        self._rnn_carries: Optional[Dict[str, Any]] = None

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
        self._tbptt_step = None
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
              inputs: Dict[str, torch.Tensor],
              fmasks: Optional[Dict[str, Optional[torch.Tensor]]] = None,
              train: bool = False,
              generator: Optional[torch.Generator] = None,
              stop_before_loss: bool = False,
              carries: Optional[Dict[str, Any]] = None):
        """Execute the DAG; returns (activations, new model state).
        ``fmasks`` maps a network input's name (and ``"__default__"``) to
        its (N, T) features mask: a recurrent layer or a
        ``LastTimeStepVertex`` takes its input's, else the default.
        ``carries`` maps a recurrent node to its initial state (TBPTT
        segments, ``rnn_time_step``; reference:
        rnnActivateUsingStoredState, ComputationGraph.java:2753). With
        ``stop_before_loss`` an output layer that has ``compute_loss``
        stores (input, params, context) for the loss instead of running."""
        dt = self.conf.global_config.compute_dtype
        fmasks = fmasks or {}
        acts = {k: compute_cast(v, dt) for k, v in inputs.items()}
        new_state = dict(model_state)

        def mask_of(node):
            m = fmasks.get(node.inputs[0])
            return fmasks.get("__default__") if m is None else m

        for name in self._topo:
            node = self._nodes[name]
            xs = [acts[s] for s in node.inputs]
            if node.layer is None:
                if isinstance(node.vertex, LastTimeStepVertex):
                    acts[name] = node.vertex.apply(*xs, mask=mask_of(node))
                else:
                    acts[name] = node.vertex.apply(*xs)
                continue
            x = xs[0]
            if node.preprocessor is not None:
                x = node.preprocessor.apply(x)
            mask = (mask_of(node) if isinstance(
                self.conf.layer_input_type(name), RecurrentType) else None)
            ctx = LayerContext(train=train, generator=generator, mask=mask)
            lp = cast_params(params.get(name, {}), dt)
            lp = node.layer.apply_weight_noise(lp, ctx)
            if stop_before_loss and name in self.conf.network_outputs and \
                    hasattr(node.layer, "compute_loss"):
                acts[name] = (x, lp, ctx)
                continue
            st = model_state.get(name, {})
            with self._split(name):
                if carries is not None and name in carries:
                    acts[name], new_state[name] = node.layer.apply(
                        lp, st, x, ctx, initial_state=carries[name])
                else:
                    acts[name], new_state[name] = node.layer.apply(
                        lp, st, x, ctx)
        return acts, new_state

    def _fmask_dict(self, fmasks) -> Dict[str, Optional[torch.Tensor]]:
        """The walk's mask dict of a tuple of per-input features masks:
        one entry per network input, and the first input's as the
        default."""
        fm = {"__default__": fmasks[0] if fmasks else None}
        for i, k in enumerate(self.conf.network_inputs):
            fm[k] = fmasks[i] if fmasks and i < len(fmasks) else None
        return fm

    def _loss(self, params, model_state, features, labels, fmasks, lmasks,
              generator, iteration, carries=None):
        """(total loss, new model state) of one batch in train mode: every
        output's loss in promote(f32, param dtype), bounded by its labels
        mask, else by the features mask its context carries, plus each
        layer's L1/L2 penalty and the auxiliary losses the layers put in
        their state (MixtureOfExperts' ``moe_aux_loss``). The new state
        (each recurrent node's last carry) is detached."""
        inputs = dict(zip(self.conf.network_inputs, features))
        acts, new_state = self._walk(params, model_state, inputs,
                                     self._fmask_dict(fmasks), True,
                                     generator, stop_before_loss=True,
                                     carries=carries)
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
            with self._split(out_name):
                loss = node.layer.compute_loss(
                    lp, model_state.get(out_name, {}), x, labels[i], ctx)
            total = total + loss.to(acc)
        for n in self._layer_nodes:
            total = total + n.layer.regularization_loss(params.get(n.name,
                                                                   {}))
        aux = moe_aux_loss(new_state)
        if aux is not None:
            total = total + aux.to(acc)
        return total, tree_map(lambda t: t.detach(), new_state)

    def _constraint_layers(self):
        return [n.layer for n in self._layer_nodes]

    def _build_train_step(self):
        return make_train_step(self._loss, self._tx,
                               make_constrain_fn(self._constraint_layers()),
                               telemetry=self._telemetry_spec())

    def _build_scan_train_step(self, shadow_cast=None):
        """K steps per call over (K, B, ...) tuples of inputs/labels."""
        return make_scan_train_step(
            self._loss, self._tx, make_constrain_fn(self._constraint_layers()),
            shadow_cast=shadow_cast, telemetry=self._telemetry_spec())

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

    # ---- truncated BPTT (reference: ComputationGraph.java:955,1184) -----
    def _named_layers(self):
        return [(n.name, n.layer) for n in self._layer_nodes]

    def _fit_batch(self, batch, etl_ms: float = 0.0):
        """One step of standard BPTT, or with ``backprop_type="tbptt"``,
        recurrent nodes and a 3-D input, one step per segment."""
        feats = (batch.features if isinstance(batch, MultiDataSet)
                 else [batch.features])
        if (self.conf.backprop_type == "tbptt"
                and self._recurrent_carry_nodes()
                and any(f.ndim == 3 for f in feats)):
            return self._fit_batch_tbptt(batch, etl_ms)
        return super()._fit_batch(batch, etl_ms)

    def _fit_batch_tbptt(self, batch, etl_ms: float = 0.0):
        """Segments of ``tbptt_fwd_length`` over a DAG: 3-D features and
        sequence labels are sliced along time, 2-D (static) inputs and
        labels go whole into every segment, and a ragged last segment pads
        every 3-D stream to the segment length with its padded steps
        masked out of the recurrence and the loss."""
        with get_tracer(self).span("host_to_device", cat="data"):
            feats, labels, fmasks, lmasks = self._step_args(batch)
        fmasks = fmasks or (None,) * len(feats)
        lmasks = lmasks or (None,) * len(labels)
        k = self.conf.tbptt_fwd_length
        seq_lens = {f.shape[1] for f in feats if f.ndim == 3}
        if len(seq_lens) > 1:
            raise ValueError(
                "TBPTT fit needs equal sequence lengths across all 3-D "
                f"inputs (got {sorted(seq_lens)}): chunking slices every "
                "sequence with the same time window. Pad the shorter "
                "streams (with a features mask) to a common length.")
        t_len = seq_lens.pop()
        n = feats[0].shape[0]
        carries = self._start_tbptt(n)
        losses = []
        for lo in range(0, t_len, k):
            hi = min(lo + k, t_len)
            cut = lambda a, m: ((a[:, lo:hi], None if m is None
                                 else m[:, lo:hi]) if a.ndim == 3
                                else (a, m))
            cf, cfm = map(list, zip(*(cut(f, m)
                                      for f, m in zip(feats, fmasks))))
            cl, clm = map(list, zip(*(cut(l, m)
                                      for l, m in zip(labels, lmasks))))
            if hi - lo < k:
                self._pad_tail(cf, cfm, cl, clm, k - (hi - lo), n, hi - lo)
            loss, carries = self._tbptt_segment(
                tuple(cf), tuple(cl), tuple(cfm), tuple(clm),
                carries=carries)
            losses.append(loss)
        self._end_tbptt(losses, etl_ms, n)

    def _pad_tail(self, cf, cfm, cl, clm, pad, n, t):
        """The multi-stream ragged tail, in place: every 3-D stream padded
        by ``pad`` steps with a features mask that masks them; a sequence
        label without a labels mask takes the first padded features mask
        (the loss falls back to it), never ones."""
        ones = lambda: torch.ones((n, t), dtype=torch.float32,
                                  device=self.device)
        for i in range(len(cf)):
            if cf[i].ndim != 3:
                continue
            base = cfm[i] if cfm[i] is not None else ones()
            cf[i] = _pad_time(cf[i], pad)
            cfm[i] = _pad_time(base, pad)
        default_fm = next((m for f, m in zip(cf, cfm)
                           if f.ndim == 3 and m is not None and m.ndim == 2),
                          None)
        for i in range(len(cl)):
            if cl[i].ndim != 3:
                continue
            if clm[i] is None:
                clm[i] = (default_fm if default_fm is not None
                          else _pad_time(ones(), pad))
            else:
                clm[i] = _pad_time(clm[i], pad)
            cl[i] = _pad_time(cl[i], pad)

    # ---- stateful streaming (reference: ComputationGraph.rnnTimeStep) --
    def rnn_time_step(self, *features, mask=None):
        """Streaming inference with stored recurrent state (reference:
        ComputationGraph.rnnTimeStep, ComputationGraph.java:2720). A 2-D
        input is one timestep and the time axis is squeezed from the
        outputs; a 3-D input runs several. The state persists across
        calls until ``rnn_clear_previous_state`` and is reset when the
        batch size changes. A graph with a bidirectional layer is
        refused: its backward direction needs the future steps."""
        bidi = first_bidirectional_name(self._named_layers())
        if bidi is not None:
            raise ValueError(
                "rnn_time_step is not supported on graphs with "
                f"bidirectional layers ('{bidi}'): the backward "
                "pass needs future timesteps")
        if self.params is None:
            self.init()
        if len(features) == 1 and isinstance(features[0], (list, tuple)):
            features = tuple(features[0])
        feats = [self._as_tensor(f) for f in features]
        squeeze = all(f.ndim == 2 for f in feats)
        feats = [f[:, None, :] if f.ndim == 2 else f for f in feats]
        n = feats[0].shape[0]
        first = next(iter((self._rnn_carries or {}).values()), None)
        if isinstance(first, tuple):
            first = first[0]
        if self._rnn_carries is None or (first is not None
                                         and first.shape[0] != n):
            self._rnn_carries = self._zero_carries(n)
        inputs = dict(zip(self.conf.network_inputs, feats))
        with torch.inference_mode():
            acts, new_state = self._walk(
                self.params, self.model_state, inputs,
                {"__default__": self._as_tensor(mask)},
                carries=self._rnn_carries)
        self._rnn_carries = self._carries_of(new_state)
        outs = [acts[o] for o in self.conf.network_outputs]
        if squeeze:
            outs = [o[:, 0] if o.ndim >= 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self):
        """Reference: ComputationGraph.rnnClearPreviousState():2828."""
        self._rnn_carries = None

    def rnn_get_previous_state(self) -> Optional[Dict[str, Any]]:
        """Node name -> stored state ((h, c) of an LSTM core, h of a
        SimpleRnn; reference: rnnGetPreviousState)."""
        return self._rnn_carries

    def rnn_set_previous_state(self, carries: Optional[Dict[str, Any]]):
        self._rnn_carries = None if carries is None else dict(carries)

    def compute_loss(self, dataset):
        """The training loss (batch statistics, no update) on a batch,
        bounded by its masks. (The JAX package's graph ``compute_loss``
        passes no masks, so it also scores padded steps; its MLN's passes
        them, as this does.)"""
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
        """Pure inference forward ``(params, model_state, x, fmask=None)
        -> y`` for single-input single-output graphs — the shape the
        serving engine (parallel/serving.py) batches over; ``fmask`` is
        the (N, T) features mask of a padded sequence batch."""
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

        def fwd(params, model_state, x, fmask=None):
            with torch.inference_mode():
                return self._walk(params, model_state, {in_name: x},
                                  {"__default__": fmask})[0][out_name]
        return fwd

    def output(self, *features, mask=None):
        """Forward pass on this model's device; returns a tensor for
        single-output graphs, else a list (reference:
        ComputationGraph.output(INDArray...)). ``mask`` is the default
        (N, T) features mask of recurrent inputs."""
        if self.params is None:
            self.init()
        if len(features) == 1 and isinstance(features[0], (list, tuple)):
            features = tuple(features[0])
        inputs = {k: self._as_tensor(f)
                  for k, f in zip(self.conf.network_inputs, features)}
        with torch.inference_mode():
            acts, _ = self._walk(self.params, self.model_state, inputs,
                                 {"__default__": self._as_tensor(mask)})
        outs = [acts[o] for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def summary(self) -> str:
        """One line a node (name, type, inputs, parameter count) and the
        total, in the JAX package's layout."""
        lines = [f"{'name':<24}{'type':<26}{'inputs':<30}{'params':>10}"]
        for name in self._topo:
            node = self._nodes[name]
            kind = (type(node.layer).__name__ if node.layer is not None
                    else type(node.vertex).__name__)
            n = 0
            if self.params is not None and node.layer is not None:
                n = sum(v.numel()
                        for v in tree_leaves(self.params.get(name, {})))
            lines.append(f"{name:<24}{kind:<26}"
                         f"{','.join(node.inputs):<30}{n:>10}")
        if self.params is not None:
            lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)

    def clone(self) -> "ComputationGraph":
        """An independent copy on the same device (see
        ``MultiLayerNetwork.clone``)."""
        return self._clone_into(ComputationGraph(self.conf,
                                                 device=self.device))
