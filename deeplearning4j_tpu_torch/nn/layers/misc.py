"""Mask, frozen-wrapper and custom-function layers.

Analogs of the reference's ``MaskLayer`` (nn/conf/layers/util/MaskLayer
.java), ``FrozenLayer`` (nn/conf/layers/misc/FrozenLayer.java) and the
SameDiff layer family (nn/conf/layers/samediff/), in the JAX package's
form (its ``nn/layers/misc.py``): ``LambdaLayer`` and ``SameDiffLayer``
run a user's torch function inside a model, differentiated by
``torch.autograd`` like everything else. Like the JAX package's, the two
hold a Python function and are not registered for serialization.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, LayerContext
from deeplearning4j_tpu_torch.utils.serde import register_serializable


@register_serializable
@dataclasses.dataclass(frozen=True)
class MaskLayer(Layer):
    """Multiplies the activations by the current mask, passing them
    through without one: a per-example (N,) or (N, 1) mask over 2-D
    input, an (N, T) mask over (N, T, F), a per-example mask over NHWC.
    Zeroing the forward zeroes the gradient at masked positions."""

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def apply(self, params, state, x, ctx):
        m = ctx.mask
        if m is None:
            return x, state
        m = m.to(device=x.device, dtype=x.dtype)
        if x.ndim == 2:
            m2 = m.reshape(m.shape[0], -1)
            if m2.shape[1] != 1 or m.shape[0] != x.shape[0]:
                raise ValueError(
                    f"MaskLayer: 2d input {tuple(x.shape)} needs a "
                    f"per-example (minibatch, 1) mask, got {tuple(m.shape)}")
            m = m2
        elif x.ndim == 3:
            if m.ndim != 2 or tuple(m.shape) != tuple(x.shape[:2]):
                raise ValueError(
                    f"MaskLayer: 3d input {tuple(x.shape)} needs a "
                    f"(minibatch, sequenceLength) mask, got "
                    f"{tuple(m.shape)}")
            m = m[:, :, None]
        elif x.ndim == 4:
            m = m.reshape(m.shape[0], 1, 1, 1)
        else:
            raise ValueError(f"MaskLayer: unsupported rank {x.ndim}")
        return x * m, state


@register_serializable
@dataclasses.dataclass(frozen=True)
class FrozenLayer(Layer):
    """Wraps any layer so that it never trains: ``frozen`` is always True,
    so the models give its parameters the no-op updater (no update and no
    weight decay from any updater), and it runs in inference mode even in
    a train step (no dropout; a BatchNormalization inside normalizes with
    its running statistics and leaves them as they are)."""
    underlying: Optional[Layer] = None

    def __post_init__(self):
        object.__setattr__(self, "frozen", True)
        if self.underlying is not None and self.name is None:
            object.__setattr__(self, "name", self.underlying.name)

    @property
    def has_params(self) -> bool:
        return self.underlying.has_params

    def output_type(self, input_type: InputType) -> InputType:
        return self.underlying.output_type(input_type)

    def initialize(self, generator, input_type):
        return self.underlying.initialize(generator, input_type)

    def init_state(self, input_type):
        return self.underlying.init_state(input_type)

    def apply(self, params, state, x, ctx: LayerContext):
        return self.underlying.apply(params, state, x,
                                     dataclasses.replace(ctx, train=False))

    def compute_loss(self, params, state, x, labels, ctx):
        return self.underlying.compute_loss(params, state, x, labels, ctx)

    def __getattr__(self, item):
        # configuration fields (n_out, ...) of the wrapped layer
        return getattr(object.__getattribute__(self, "underlying"), item)


@dataclasses.dataclass(frozen=True)
class LambdaLayer(Layer):
    """Parameter-free custom function layer (reference:
    samediff/SameDiffLambdaLayer.java). ``fn(x) -> y`` is a torch
    function; ``output_type_fn`` maps the input type to the output type
    when it changes."""
    fn: Optional[Callable] = None
    output_type_fn: Optional[Callable] = None

    @property
    def has_params(self) -> bool:
        return False

    def output_type(self, input_type: InputType) -> InputType:
        if self.output_type_fn is not None:
            return self.output_type_fn(input_type)
        return input_type

    def apply(self, params, state, x, ctx: LayerContext):
        return self.fn(x), state


@dataclasses.dataclass(frozen=True)
class SameDiffLayer(Layer):
    """Custom layer with trainable params (reference:
    samediff/SameDiffLayer.java: defineLayer + defineParameters).

    - ``param_shapes``: dict name -> shape (defineParameters)
    - ``fn(params, x) -> y`` in torch (defineLayer)
    - ``out_type(input_type) -> InputType`` (getOutputType)
    - ``init_fn(generator, name, shape) -> tensor``, optional custom init
      (initializeParameters); default: a normal scaled by
      1/sqrt(fan_in), fan_in being the shape's first dimension
    """
    param_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
    fn: Optional[Callable] = None
    out_type: Optional[Callable] = None
    init_fn: Optional[Callable] = None

    def output_type(self, input_type: InputType) -> InputType:
        if self.out_type is not None:
            return self.out_type(input_type)
        return input_type

    def initialize(self, generator, input_type):
        params = {}
        for name, shape in sorted((self.param_shapes or {}).items()):
            shape = tuple(int(d) for d in shape)
            if self.init_fn is not None:
                params[name] = self.init_fn(generator, name, shape)
            else:
                fan_in = shape[0] if shape else 1
                params[name] = torch.randn(
                    shape, generator=generator, dtype=torch.float32).to(
                        self.param_dtype()) / math.sqrt(max(fan_in, 1.0))
        return params

    def apply(self, params, state, x, ctx: LayerContext):
        return self.fn(params, x), state
