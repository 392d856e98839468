"""MultiLayerNetwork — sequential-stack model.

Analog of the reference's ``MultiLayerNetwork``
(deeplearning4j-nn/.../nn/multilayer/MultiLayerNetwork.java:94 — init():549,
fit(DataSet), output:2031, rnnTimeStep:2806) in the JAX package's form:
parameters and layer state are dicts keyed by layer name, the forward
walks the layers in order (with the configuration's preprocessors and an
(N, T) features mask for recurrent inputs), and the training loss is the
output layer's loss plus L1/L2 in promote(f32, loss dtype), differentiated
by ``torch.autograd``. ``fit`` (models/base.py) takes a DataSet (one
step of standard BPTT) or an iterator (through the device feeder);
``_build_scan_train_step`` runs K steps in one call. With
``backprop_type="tbptt"`` a batch of sequences trains segment by segment
(reference: doTruncatedBPTT, MultiLayerNetwork.java:1521): each
``tbptt_fwd_length`` slice of time is one optimizer step whose recurrent
layers start from the state the previous segment handed on, with the
gradients cut at the boundary; a ragged last segment is padded and
masked. ``rnn_time_step`` is the stateful streaming forward: the caller
threads each recurrent layer's carry ((h, c) for an LSTM core, h for a
SimpleRnn). ``pretrain`` and ``pretrain_layer`` train the layers that
define ``pretrain_loss`` (``AutoEncoder``, ``VariationalAutoencoder``)
greedily, one at a time, on the activations of the frozen layers below
(reference: MultiLayerNetwork.pretrain).

The model lives on one device, chosen at construction: ``cuda`` unless
the caller passes ``device="cpu"`` (utils/device.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.base import (BaseModel, Tree,
                                                  cast_params, compute_cast,
                                                  moe_aux_loss)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.inputs import RecurrentType
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.nn.layers.recurrent import carry_core
from deeplearning4j_tpu_torch.observe.tracer import get_tracer
from deeplearning4j_tpu_torch.optimize.solver import (apply_updates,
                                                      build_optimizer,
                                                      make_constrain_fn,
                                                      make_scan_train_step,
                                                      make_train_step)
from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves, tree_map
from deeplearning4j_tpu_torch.utils.device import DeviceLike, resolve_device

# recurrent layer name -> (h, c) of an LSTM core, or h of a SimpleRnn
Carries = Dict[str, Any]


def _pad_time(a: torch.Tensor, pad: int) -> torch.Tensor:
    """``a`` with ``pad`` zero steps appended on the time axis (the MLN's
    and the graph's ragged TBPTT tails)."""
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])],
                     dim=1)


def _pad_tbptt_tail(f, l, fm, lm, k, seq_labels):
    """A ragged last TBPTT segment padded to length ``k`` along time, the
    padded steps masked out of the recurrence and the loss. Without a
    labels mask the labels mask is the padded features mask (the loss
    falls back to it), never ones: ones would unmask steps the features
    mask excludes."""
    n, t = f.shape[0], f.shape[1]
    pad = k - t
    f = _pad_time(f, pad)
    base_fm = fm if fm is not None else torch.ones(
        (n, t), dtype=torch.float32, device=f.device)
    fm = _pad_time(base_fm, pad)
    if seq_labels:
        l = _pad_time(l, pad)
        lm = _pad_time(lm, pad) if lm is not None else fm
    return f, l, fm, lm


class MultiLayerNetwork(BaseModel):
    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)
        self.conf = conf
        conf.resolve_shapes()
        self.layers = conf.layers
        self.layer_names = tuple(l.name for l in self.layers)
        self._preprocessors = conf.preprocessors()
        self._input_types = conf.layer_input_types()
        self.params: Optional[Tree] = None
        self.model_state: Optional[Tree] = None
        self.opt_state = None
        self._tx = None
        self._generator = None

    # ---- init -----------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Random parameters from a ``torch.Generator`` seeded with the
        configuration's seed (or ``seed``), drawn on the CPU layer by layer
        and moved to the device once."""
        g = self.conf.global_config
        seed = g.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        params: Tree = {}
        state: Tree = {}
        for layer, it in zip(self.layers, self._input_types):
            lp = layer.initialize(gen, it) if layer.has_params else {}
            params[layer.name] = tree_map(lambda v: v.to(self.device), lp)
            state[layer.name] = tree_map(lambda v: v.to(self.device),
                                         layer.init_state(it))
        self.params, self.model_state = params, state
        self._tx = self._make_tx()
        self.opt_state = self._tx.init(params)
        self.iteration = 0
        self._train_step = None
        self._tbptt_step = None
        # dropout's random numbers (the JAX package's step keys)
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed)
        return self

    def _make_tx(self):
        g = self.conf.global_config
        return build_optimizer(
            self.layer_names,
            {l.name: l.updater for l in self.layers},
            {l.name: l.frozen for l in self.layers},
            g.updater, g.gradient_normalization)

    # ---- functional forward --------------------------------------------
    def _forward(self, params: Tree, model_state: Tree, x: torch.Tensor,
                 fmask: Optional[torch.Tensor], train: bool,
                 generator: Optional[torch.Generator] = None,
                 upto: Optional[int] = None, collect: bool = False,
                 carries: Optional[Carries] = None):
        """Forward through layers [0, upto): (activation, new state), or
        (list of activations, new state) with ``collect`` (reference:
        feedForwardToLayer:955). Recurrent layers see the features mask;
        ``carries`` maps a recurrent layer's name to its initial state
        (TBPTT segments, ``rnn_time_step``; reference:
        rnnActivateUsingStoredState:2881)."""
        dt = self.conf.global_config.compute_dtype
        x = compute_cast(x, dt)
        n = len(self.layers) if upto is None else upto
        new_state = dict(model_state)
        acts = []
        for i in range(n):
            layer = self.layers[i]
            pp = self._preprocessors.get(i)
            if pp is not None:
                x = pp.apply(x)
            mask = fmask if isinstance(self._input_types[i],
                                       RecurrentType) else None
            ctx = LayerContext(train=train, generator=generator, mask=mask)
            lp = cast_params(params.get(layer.name, {}), dt)
            lp = layer.apply_weight_noise(lp, ctx)
            st = model_state.get(layer.name, {})
            if carries is not None and layer.name in carries:
                x, new_state[layer.name] = layer.apply(
                    lp, st, x, ctx, initial_state=carries[layer.name])
            else:
                x, new_state[layer.name] = layer.apply(lp, st, x, ctx)
            if collect:
                acts.append(x)
        return (acts if collect else x), new_state

    def _loss(self, params, model_state, features, labels, fmask, lmask,
              generator, iteration, carries: Optional[Carries] = None):
        """(training loss, new state): forward to the last hidden layer
        (from ``carries``' initial states), the output layer's loss on its
        logits with the output layer's parameters in the compute dtype,
        plus each layer's L1/L2 and the auxiliary losses the layers put in
        their state (MixtureOfExperts' ``moe_aux_loss``), in promote(f32,
        loss dtype) (reference:
        computeGradientAndScore:2360). The new state (each recurrent
        layer's last carry) is detached."""
        n = len(self.layers)
        x, new_state = self._forward(params, model_state, features, fmask,
                                     True, generator, upto=n - 1,
                                     carries=carries)
        out = self.layers[-1]
        pp = self._preprocessors.get(n - 1)
        if pp is not None:
            x = pp.apply(x)
        mask = lmask if lmask is not None else (
            fmask if isinstance(self._input_types[n - 1], RecurrentType)
            else None)
        if not hasattr(out, "compute_loss"):
            raise TypeError(f"last layer {type(out).__name__} is not an "
                            "output/loss layer")
        ctx = LayerContext(train=True, generator=generator, mask=mask)
        out_lp = cast_params(params.get(out.name, {}),
                             self.conf.global_config.compute_dtype)
        out_lp = out.apply_weight_noise(out_lp, ctx)
        loss = out.compute_loss(out_lp, model_state.get(out.name, {}), x,
                                labels, ctx)
        reg = torch.zeros((), dtype=torch.float32, device=loss.device)
        for l in self.layers:
            reg = reg + l.regularization_loss(params.get(l.name, {}))
        acc = torch.promote_types(torch.float32, loss.dtype)
        total = loss.to(acc) + reg.to(acc)
        aux = moe_aux_loss(new_state)
        if aux is not None:
            total = total + aux.to(acc)
        new_state = tree_map(lambda t: t.detach(), new_state)
        return total, new_state

    def _constraint_layers(self):
        return self.layers

    def _build_train_step(self):
        return make_train_step(self._loss, self._tx,
                               make_constrain_fn(self._constraint_layers()),
                               telemetry=self._telemetry_spec())

    def _build_scan_train_step(self, shadow_cast=None):
        """K steps per call over (K, B, ...) staged tensors."""
        return make_scan_train_step(
            self._loss, self._tx, make_constrain_fn(self._constraint_layers()),
            shadow_cast=shadow_cast, telemetry=self._telemetry_spec())

    def _named_layers(self):
        return [(l.name, l) for l in self.layers]

    def _fit_batch(self, batch, etl_ms: float = 0.0):
        """One step of standard BPTT, or with ``backprop_type="tbptt"``
        and a sequence batch, one step per ``tbptt_fwd_length`` segment
        (the iteration count advances by the number of segments)."""
        if (self.conf.backprop_type != "tbptt" or batch.features.ndim != 3
                or not self._recurrent_carry_nodes()):
            return super()._fit_batch(batch, etl_ms)
        with get_tracer(self).span("host_to_device", cat="data"):
            features, labels, fmask, lmask = self._step_args(batch)
        carries = self._start_tbptt(features.shape[0])
        k = self.conf.tbptt_fwd_length
        t_len = features.shape[1]
        seq_labels = labels.ndim == 3
        losses = []
        for lo in range(0, t_len, k):
            hi = min(lo + k, t_len)
            f = features[:, lo:hi]
            l = labels[:, lo:hi] if seq_labels else labels
            fm = None if fmask is None else fmask[:, lo:hi]
            # a labels mask is per step only for sequence labels; for 2-D
            # labels it is per output and is not sliced
            lm = (lmask if not seq_labels
                  else None if lmask is None else lmask[:, lo:hi])
            if hi - lo < k:
                f, l, fm, lm = _pad_tbptt_tail(f, l, fm, lm, k, seq_labels)
            loss, carries = self._tbptt_segment(f, l, fm, lm,
                                                carries=carries)
            losses.append(loss)
        self._end_tbptt(losses, etl_ms, batch.num_examples())

    def _step_args(self, batch: DataSet):
        """(features, labels, fmask, lmask) on the device."""
        t = self._as_tensor
        return (t(batch.features), t(batch.labels), t(batch.features_mask),
                t(batch.labels_mask))

    def compute_loss(self, dataset: DataSet) -> torch.Tensor:
        """The training loss (no update) on a batch."""
        if self.params is None:
            self.init()
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.model_state,
                                 *self._step_args(dataset), None,
                                 self.iteration)
        return loss

    # ---- inference ------------------------------------------------------
    def build_inference_fn(self):
        """The pure inference forward ``(params, model_state, x, fmask)
        -> y`` behind ``output()``; the output layer applies its
        activation."""
        if self.params is None:
            self.init()

        def fwd(params, model_state, x, fmask=None):
            n = len(self.layers)
            with torch.inference_mode():
                h, _ = self._forward(params, model_state, x, fmask, False,
                                     upto=n - 1)
                out = self.layers[-1]
                pp = self._preprocessors.get(n - 1)
                if pp is not None:
                    h = pp.apply(h)
                ctx = LayerContext(train=False, mask=fmask)
                lp = cast_params(params.get(out.name, {}),
                                 self.conf.global_config.compute_dtype)
                y, _ = out.apply(lp, model_state.get(out.name, {}), h, ctx)
            return y
        return fwd

    def output(self, features, mask=None) -> torch.Tensor:
        """Inference forward on this model's device (reference: output:2031
        / output(INDArray, ..., featuresMask)); ``mask`` is the (N, T)
        features mask of a padded sequence batch."""
        return self.build_inference_fn()(self.params, self.model_state,
                                         self._as_tensor(features),
                                         self._as_tensor(mask))

    def feed_forward(self, features, train: bool = False
                     ) -> List[torch.Tensor]:
        """Every layer's activation (reference: feedForward())."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts, _ = self._forward(self.params, self.model_state,
                                    self._as_tensor(features), None, train,
                                    collect=True)
        return acts

    # ---- misc -----------------------------------------------------------
    def summary(self) -> str:
        """One line a layer (index, name, type, parameter count, output
        shape) and the total, in the JAX package's layout."""
        lines = [f"{'idx':<4}{'name':<22}{'type':<26}{'params':>10}  out"]
        for i, l in enumerate(self.layers):
            n = 0
            if self.params is not None:
                n = sum(v.numel()
                        for v in tree_leaves(self.params.get(l.name, {})))
            out_t = l.output_type(self._input_types[i])
            lines.append(f"{i:<4}{l.name:<22}{type(l).__name__:<26}"
                         f"{n:>10}  {out_t.shape()}")
        lines.append("total params: "
                     f"{self.num_params() if self.params is not None else '?'}")
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        """An independent copy on the same device: the same configuration,
        parameters, state, optimizer state and counters (no re-init)."""
        return self._clone_into(MultiLayerNetwork(self.conf,
                                                  device=self.device))

    def rnn_time_step(self, features, carries: Optional[Carries] = None
                      ) -> Tuple[torch.Tensor, Carries]:
        """Stateful single- or multi-step inference (reference:
        rnnTimeStep, MultiLayerNetwork.java:2806): ``carries`` maps each
        recurrent layer's name to its state ((h, c) of an LSTM core, h of
        a SimpleRnn, wrapped or not); returns (output, new carries). A
        (N, F) input is one timestep. Parameters are used as stored, as
        the JAX package's ``rnn_time_step`` uses them."""
        if self.params is None:
            self.init()
        x = self._as_tensor(features)
        if x.ndim == 2:
            x = x[:, None, :]
        carries = dict(carries or {})
        with torch.inference_mode():
            for i, layer in enumerate(self.layers):
                pp = self._preprocessors.get(i)
                if pp is not None:
                    x = pp.apply(x)
                ctx = LayerContext(train=False)
                lp = self.params.get(layer.name, {})
                st = self.model_state.get(layer.name, {})
                cc = carry_core(layer)
                if cc is not None:
                    x, s = layer.apply(lp, st, x, ctx,
                                       initial_state=carries.get(layer.name))
                    carries[layer.name] = ((s["last_h"], s["last_c"])
                                           if cc[1] else s["last_h"])
                else:
                    x, _ = layer.apply(lp, st, x, ctx)
        return x, carries

    # ---- layerwise pretraining ------------------------------------------
    def pretrain(self, iterator, epochs: int = 1) -> "MultiLayerNetwork":
        """Greedy layerwise unsupervised pretraining of every layer that
        defines ``pretrain_loss`` (AutoEncoder, VariationalAutoencoder):
        the reference's MultiLayerNetwork.pretrain(DataSetIterator)."""
        for i, layer in enumerate(self.layers):
            if getattr(layer, "supports_pretrain", False):
                self.pretrain_layer(i, iterator, epochs)
        return self

    def pretrain_layer(self, idx: int, iterator,
                       epochs: int = 1) -> "MultiLayerNetwork":
        """Pretrain layer ``idx`` on the activations of the (frozen)
        layers below it (reference: pretrainLayer(int, DataSetIterator)):
        its own params, with its updater (else the global one) and a
        fresh optimizer state, one step a batch. The noise (the VAE's
        samples, the autoencoder's corruption) comes from the model's
        generator."""
        if self.params is None:
            self.init()
        layer = self.layers[idx]
        if not getattr(layer, "supports_pretrain", False):
            return self
        g = self.conf.global_config
        tx = (layer.updater or g.updater).to_transform()
        lp = self.params[layer.name]
        opt_state = tx.init(lp)
        loss = None
        for _ in range(epochs):
            for ds in iterator:
                lp, opt_state, loss = self.pretrain_step(
                    idx, tx, lp, opt_state, ds.features,
                    generator=self._generator)
            if hasattr(iterator, "reset"):
                iterator.reset()
        self.params = dict(self.params)
        self.params[layer.name] = lp
        if loss is not None:
            self._last_loss = loss
        return self

    def pretrain_step(self, idx: int, tx, lp, opt_state, features,
                      **noise):
        """One update of layer ``idx``'s params ``lp`` (optimizer ``tx``,
        state ``opt_state``) on one batch: (new params, new state, loss).
        ``noise`` goes to the layer's ``pretrain_loss`` (``generator``,
        or an injected ``eps`` for a VAE, ``keep`` for an autoencoder)."""
        layer = self.layers[idx]
        x = self._as_tensor(features)
        with torch.no_grad():
            h, _ = self._forward(self.params, self.model_state, x, None,
                                 False, upto=idx)
            pp = self._preprocessors.get(idx)
            if pp is not None:
                h = pp.apply(h)
            leaves = tree_leaves(lp)
            h = h.to(torch.promote_types(h.dtype, leaves[0].dtype))
        lp_g = tree_map(lambda t: t.detach().requires_grad_(True), lp)
        with torch.enable_grad():
            loss = layer.pretrain_loss(lp_g, h, **noise)
            grads = torch.autograd.grad(loss, tree_leaves(lp_g))
        it = iter(grads)
        grads = tree_map(lambda _: next(it), lp)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, lp)
            lp = apply_updates(lp, updates)
        return lp, opt_state, loss.detach()
