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
``_build_scan_train_step`` runs K steps in one call; truncated BPTT is not
ported yet. ``rnn_time_step`` is the stateful streaming forward: the caller
threads each LSTM's (h, c) carry.

The model lives on one device, chosen at construction: ``cuda`` unless
the caller passes ``device="cpu"`` (utils/device.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.base import (BaseModel, Tree,
                                                  cast_params, compute_cast)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.inputs import RecurrentType
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.nn.layers.recurrent import (LSTM,
                                                          unwrap_recurrent)
from deeplearning4j_tpu_torch.optimize.solver import (build_optimizer,
                                                      make_scan_train_step,
                                                      make_train_step)
from deeplearning4j_tpu_torch.optimize.updaters import tree_map
from deeplearning4j_tpu_torch.utils.device import DeviceLike, resolve_device

Carries = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


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
                 upto: Optional[int] = None, collect: bool = False):
        """Forward through layers [0, upto): (activation, new state), or
        (list of activations, new state) with ``collect`` (reference:
        feedForwardToLayer:955). Recurrent layers see the features mask."""
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
            x, new_state[layer.name] = layer.apply(
                lp, model_state.get(layer.name, {}), x, ctx)
            if collect:
                acts.append(x)
        return (acts if collect else x), new_state

    def _loss(self, params, model_state, features, labels, fmask, lmask,
              generator, iteration):
        """(training loss, new state): forward to the last hidden layer,
        the output layer's loss on its logits with the output layer's
        parameters in the compute dtype, plus each layer's L1/L2, in
        promote(f32, loss dtype) (reference: computeGradientAndScore:2360).
        The new state (each LSTM's last carry) is detached."""
        n = len(self.layers)
        x, new_state = self._forward(params, model_state, features, fmask,
                                     True, generator, upto=n - 1)
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
        loss = out.compute_loss(out_lp, model_state.get(out.name, {}), x,
                                labels, ctx)
        reg = torch.zeros((), dtype=torch.float32, device=loss.device)
        for l in self.layers:
            reg = reg + l.regularization_loss(params.get(l.name, {}))
        acc = torch.promote_types(torch.float32, loss.dtype)
        new_state = tree_map(lambda t: t.detach(), new_state)
        return loss.to(acc) + reg.to(acc), new_state

    def _check_trainable(self):
        if self.conf.backprop_type == "tbptt":
            raise NotImplementedError(
                "backprop_type='tbptt': truncated BPTT fit is not ported yet "
                "(ROADMAP.md, queue 1); use backprop_type='standard'")
        for l in self.layers:
            if l.constraints or l.weight_noise is not None:
                raise NotImplementedError(
                    f"layer '{l.name}': constraints and weight noise are not "
                    "ported yet")

    def _build_train_step(self):
        self._check_trainable()
        return make_train_step(self._loss, self._tx)

    def _build_scan_train_step(self):
        """K steps per call over (K, B, ...) staged tensors."""
        self._check_trainable()
        return make_scan_train_step(self._loss, self._tx)

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

    def rnn_time_step(self, features, carries: Optional[Carries] = None
                      ) -> Tuple[torch.Tensor, Carries]:
        """Stateful single- or multi-step inference (reference:
        rnnTimeStep, MultiLayerNetwork.java:2806): ``carries`` maps each
        LSTM's name to its (h, c); returns (output, new carries). A (N, F)
        input is one timestep. Parameters are used as stored, as the JAX
        package's ``rnn_time_step`` uses them."""
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
                if isinstance(unwrap_recurrent(layer), LSTM):
                    x, s = layer.apply(lp, st, x, ctx,
                                       initial_state=carries.get(layer.name))
                    carries[layer.name] = (s["last_h"], s["last_c"])
                else:
                    x, _ = layer.apply(lp, st, x, ctx)
        return x, carries
