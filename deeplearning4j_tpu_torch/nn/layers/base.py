"""Layer API.

Analog of the reference's layer contract (deeplearning4j-nn/.../nn/api/
Layer.java:38) in the JAX package's functional form: a layer is a
**serializable config** with

- ``output_type(input_type)``          shape inference,
- ``initialize(generator, input_type)`` → parameter dict of tensors,
- ``init_state(input_type)``           → non-trainable state (BN running
  stats),
- ``apply(params, state, x, ctx)``     → ``(y, new_state)``.

Field names match the JAX package's, so ``configuration.json`` reads and
writes the same. ``initialize`` and ``init_state`` return CPU tensors; the
model moves them to its device once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.initializers import WeightInit
from deeplearning4j_tpu_torch.optimize.updaters import Updater
from deeplearning4j_tpu_torch.utils.device import float_dtype

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LayerContext:
    train: bool = False
    mask: Optional[torch.Tensor] = None    # (N, T) for sequence data


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base config for all layers (the knobs every DL4J layer config
    inherits from ``BaseLayer``)."""

    name: Optional[str] = None
    dropout: Any = 0.0            # applied to the layer INPUT during training
    l1: float = 0.0
    l2: float = 0.0
    updater: Optional[Updater] = None   # per-layer override; None = global
    frozen: bool = False
    dtype: Optional[str] = None   # param dtype override ("float32"/"bfloat16")
    weight_noise: Optional[Any] = None
    constraints: Tuple = ()

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

    def check_inference(self, ctx: LayerContext):
        """The port serves; training comes with a later slice."""
        if ctx.train:
            raise NotImplementedError(
                f"{type(self).__name__}: the training forward is not "
                "ported yet (inference only)")


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
