"""Input preprocessors — shape adapters between layer families.

Analog of the reference's ``nn/conf/preprocessor/`` package, with the
JAX package's auto-insertion rule: a convolutional map feeding a
dense/output layer is flattened, one feeding a recurrent layer (or a 1-D
convolution) becomes a sequence over its rows, a flat image input
feeding a conv-like layer is unflattened, and a flat input feeding a
recurrent layer becomes a one-step sequence. Layouts are NHWC and
(N, T, F), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.inputs import (ConvolutionalFlatType,
                                                ConvolutionalType,
                                                FeedForwardType, InputType,
                                                RecurrentType)
from deeplearning4j_tpu_torch.utils.serde import register_serializable


class Preprocessor:
    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@register_serializable
@dataclasses.dataclass(frozen=True)
class CnnToFeedForward(Preprocessor):
    height: int
    width: int
    channels: int

    def output_type(self, input_type):
        return FeedForwardType(self.height * self.width * self.channels)

    def apply(self, x):
        return x.reshape(x.shape[0], -1)


@register_serializable
@dataclasses.dataclass(frozen=True)
class FeedForwardToCnn(Preprocessor):
    """(N, H·W·C) → NHWC."""
    height: int
    width: int
    channels: int

    def output_type(self, input_type):
        return ConvolutionalType(self.height, self.width, self.channels)

    def apply(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)


@register_serializable
@dataclasses.dataclass(frozen=True)
class UnflattenToCnn(Preprocessor):
    """ConvolutionalFlat input (N, H*W*C) → NHWC."""
    height: int
    width: int
    channels: int

    def output_type(self, input_type):
        return ConvolutionalType(self.height, self.width, self.channels)

    def apply(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)


@register_serializable
@dataclasses.dataclass(frozen=True)
class FeedForwardToRnn(Preprocessor):
    """(N, F) → (N, 1, F): the model keeps the batch dim, so a flat input
    to a recurrent layer is one timestep."""
    size: int

    def output_type(self, input_type):
        return RecurrentType(self.size, None)

    def apply(self, x):
        if x.ndim == 2:
            return x[:, None, :]
        return x


@register_serializable
@dataclasses.dataclass(frozen=True)
class RnnToFeedForward(Preprocessor):
    """(N, T, F) → (N·T, F): time into the batch axis, for a strictly
    2-D layer after a recurrent one (reference:
    RnnToFeedForwardPreProcessor)."""
    size: int

    def output_type(self, input_type):
        return FeedForwardType(self.size)

    def apply(self, x):
        return x.reshape(-1, x.shape[-1])


@register_serializable
@dataclasses.dataclass(frozen=True)
class CnnToRnn(Preprocessor):
    """NHWC (N, H, W, C) → (N, H, W·C): the rows are the time steps
    (reference: CnnToRnnPreProcessor)."""
    height: int
    width: int
    channels: int

    def output_type(self, input_type):
        return RecurrentType(self.width * self.channels, self.height)

    def apply(self, x):
        n, h, w, c = x.shape
        return x.reshape(n, h, w * c)


@register_serializable
@dataclasses.dataclass(frozen=True)
class RnnToCnn(Preprocessor):
    """(N, T, F) → NHWC of the configured size."""
    height: int
    width: int
    channels: int

    def output_type(self, input_type):
        return ConvolutionalType(self.height, self.width, self.channels)

    def apply(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)


def infer_preprocessor(prev: InputType, layer) -> Preprocessor | None:
    """Auto-insert an adapter when the previous output family doesn't
    match what the next layer expects (the JAX package's rule)."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        Convolution1DLayer, ConvolutionLayer, Cropping2D, SpaceToBatchLayer,
        SpaceToDepthLayer, SubsamplingLayer, Upsampling2D, ZeroPaddingLayer)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        LSTM, Bidirectional, LastTimeStep, SimpleRnn)

    conv_like = (ConvolutionLayer, SubsamplingLayer, Upsampling2D,
                 ZeroPaddingLayer, Cropping2D, SpaceToDepthLayer,
                 SpaceToBatchLayer)
    rnn_like = (LSTM, SimpleRnn, Bidirectional, LastTimeStep,
                Convolution1DLayer)
    if isinstance(prev, ConvolutionalFlatType) and isinstance(layer,
                                                              conv_like):
        return UnflattenToCnn(prev.height, prev.width, prev.channels)
    if isinstance(prev, ConvolutionalType):
        if isinstance(layer, rnn_like):
            return CnnToRnn(prev.height, prev.width, prev.channels)
        if isinstance(layer, DenseLayer) and not isinstance(
                layer, RnnOutputLayer):
            return CnnToFeedForward(prev.height, prev.width, prev.channels)
    if isinstance(prev, FeedForwardType) and isinstance(layer, rnn_like):
        return FeedForwardToRnn(prev.size)
    return None
