"""Input type system.

Analog of the reference's ``InputType`` (deeplearning4j-nn/.../nn/conf/inputs/
InputType.java), which drives shape inference and automatic insertion of
preprocessors between layer families (CNN→FF, FF→RNN, ...).

Convolutional activations are **NHWC** (channels-last), not the
reference's NCHW, exactly as the JAX package holds them, so weights and
activations carry across the two packages without a transpose. The fused
conv kernels (ops/fused_conv.py) read channels as the contiguous axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.utils.serde import register_serializable


class InputType:
    """Marker base. Shapes exclude the leading minibatch dimension."""

    def shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def arity(self) -> int:
        return len(self.shape())

    @staticmethod
    def feed_forward(size: int) -> "FeedForwardType":
        return FeedForwardType(size)

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "RecurrentType":
        return RecurrentType(size, timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "ConvolutionalType":
        return ConvolutionalType(height, width, channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "ConvolutionalFlatType":
        return ConvolutionalFlatType(height, width, channels)


@register_serializable
@dataclasses.dataclass(frozen=True)
class FeedForwardType(InputType):
    size: int

    def shape(self):
        return (self.size,)


@register_serializable
@dataclasses.dataclass(frozen=True)
class RecurrentType(InputType):
    """(time, features) — time-major-within-example, batch-leading overall.

    The reference uses (batch, features, time); we use (batch, time, features)
    which keeps the feature axis last and contiguous.
    """
    size: int
    timesteps: Optional[int] = None

    def shape(self):
        t = -1 if self.timesteps is None else self.timesteps
        return (t, self.size)


@register_serializable
@dataclasses.dataclass(frozen=True)
class ConvolutionalType(InputType):
    """NHWC activation layout: shape() = (height, width, channels)."""
    height: int
    width: int
    channels: int

    def shape(self):
        return (self.height, self.width, self.channels)


@register_serializable
@dataclasses.dataclass(frozen=True)
class ConvolutionalFlatType(InputType):
    """Flattened image input (e.g. MNIST 784-vectors) that a conv layer will
    reshape to NHWC. Mirrors the reference's ``InputType.convolutionalFlat``."""
    height: int
    width: int
    channels: int

    def shape(self):
        return (self.height * self.width * self.channels,)

    def unflatten(self) -> ConvolutionalType:
        return ConvolutionalType(self.height, self.width, self.channels)
