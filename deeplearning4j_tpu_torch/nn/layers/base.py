"""Layer API.

Analog of the reference's layer contract (deeplearning4j-nn/.../nn/api/
Layer.java:38) in the JAX package's functional form: a layer is a
**serializable config** with

- ``output_type(input_type)``          shape inference,
- ``initialize(generator, input_type)`` → parameter dict of tensors,
- ``init_state(input_type)``           → non-trainable state (BN running
  stats),
- ``apply(params, state, x, ctx)``     → ``(y, new_state)``; in training
  (``ctx.train``) the new state carries updated running statistics.

Gradients come from ``torch.autograd`` through ``apply`` (and through the
fused conv's ``autograd.Function``), as the JAX package takes them from
``jax.grad``. Field names match the JAX package's, so
``configuration.json`` reads and writes the same. ``initialize`` and
``init_state`` return CPU tensors; the model moves them to its device once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.dropout import Dropout
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.param_keys import is_weight_key
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.initializers import WeightInit
from deeplearning4j_tpu_torch.optimize.updaters import Updater, named_leaves
from deeplearning4j_tpu_torch.utils.device import float_dtype

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LayerContext:
    """Train/eval mode, the generator of stochastic layers (dropout) and
    an optional input mask. A ``torch.Generator`` takes the place of the
    JAX package's PRNG key; the two never give the same numbers."""
    train: bool = False
    generator: Optional[torch.Generator] = None
    mask: Optional[torch.Tensor] = None    # (N, T) for sequence data


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base config for all layers (the knobs every DL4J layer config
    inherits from ``BaseLayer``)."""

    name: Optional[str] = None
    # float drop-probability, or an nn.dropout.IDropout instance
    # (Dropout/AlphaDropout/GaussianDropout/GaussianNoise)
    dropout: Any = 0.0            # applied to the layer INPUT during training
    l1: float = 0.0
    l2: float = 0.0
    updater: Optional[Updater] = None   # per-layer override; None = global
    frozen: bool = False
    dtype: Optional[str] = None   # param dtype override ("float32"/"bfloat16")
    weight_noise: Optional[Any] = None  # nn.weightnoise.IWeightNoise
    constraints: Tuple = ()             # nn.constraints.LayerConstraint s

    # ---- contract -------------------------------------------------------
    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def initialize(self, generator: torch.Generator,
                   input_type: InputType) -> Params:
        return {}

    def init_state(self, input_type: InputType) -> State:
        return {}

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError

    # ---- helpers --------------------------------------------------------
    @property
    def has_params(self) -> bool:
        return True

    def param_dtype(self) -> torch.dtype:
        return float_dtype(self.dtype)

    def regularization_loss(self, params: Params) -> torch.Tensor:
        """L1/L2 penalty over this layer's weight-like params (bias-like
        keys are exempt: nn/param_keys.py), in f32. Nested params (a
        transformer block's) are classified by their leaf key."""
        leaves = list(named_leaves(params))
        dev = leaves[0][1].device if leaves else None
        total = torch.zeros((), dtype=torch.float32, device=dev)
        if self.l1 == 0.0 and self.l2 == 0.0:
            return total
        for key, leaf in leaves:
            if not is_weight_key(key):
                continue
            if self.l1:
                total = total + self.l1 * leaf.abs().sum()
            if self.l2:
                total = total + 0.5 * self.l2 * leaf.square().sum()
        return total

    def maybe_dropout(self, x: torch.Tensor,
                      ctx: LayerContext) -> torch.Tensor:
        """Input dropout in training, drawn from ``ctx.generator``:
        ``dropout`` is a float DROP probability (inverted dropout) or any
        ``IDropout`` of nn/dropout.py. Without a generator (an eval-mode
        loss, ``compute_loss``) the input passes unchanged, as the JAX
        package's does without a key."""
        if not ctx.train or ctx.generator is None:
            return x
        if isinstance(self.dropout, (int, float)):
            if self.dropout <= 0.0:
                return x
            return Dropout(float(self.dropout)).apply_dropout(
                x, ctx.generator)
        return self.dropout.apply_dropout(x, ctx.generator)

    def apply_weight_noise(self, params: Params,
                           ctx: LayerContext) -> Params:
        """``params`` perturbed for this forward pass when a weight-noise
        conf is set, in training with a generator (reference:
        conf/weightnoise/, BaseLayer.getParamWithNoise); else unchanged."""
        if self.weight_noise is None or not ctx.train \
                or ctx.generator is None or not params:
            return params
        return self.weight_noise.apply_noise(params, ctx.generator)


@dataclasses.dataclass(frozen=True)
class FeedForwardLayer(Layer):
    """Base for layers with explicit nIn/nOut (reference:
    ``FeedForwardLayer``). ``n_in`` may be None — inferred from the
    incoming ``InputType``."""
    n_in: Optional[int] = None
    n_out: int = 0
    activation: Activation = Activation.IDENTITY
    weight_init: WeightInit = WeightInit.XAVIER
    has_bias: bool = True

    def resolved_n_in(self, input_type: InputType) -> int:
        if self.n_in is not None:
            return self.n_in
        return input_type.shape()[-1]
