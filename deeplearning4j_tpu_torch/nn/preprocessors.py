"""Input preprocessors — shape adapters between layer families.

Analog of the reference's ``nn/conf/preprocessor/`` package, with the
JAX package's auto-insertion rule for the layer families the port has:
a convolutional map feeding a dense/output layer is flattened, and a
flat image input feeding a conv-like layer is unflattened. Layouts are
NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.inputs import (ConvolutionalFlatType,
                                                ConvolutionalType,
                                                FeedForwardType, InputType)
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
class UnflattenToCnn(Preprocessor):
    """ConvolutionalFlat input (N, H*W*C) → NHWC."""
    height: int
    width: int
    channels: int

    def output_type(self, input_type):
        return ConvolutionalType(self.height, self.width, self.channels)

    def apply(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)


def infer_preprocessor(prev: InputType, layer) -> Preprocessor | None:
    """Auto-insert an adapter when the previous output family doesn't
    match what the next layer expects."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer, SpaceToDepthLayer, SubsamplingLayer,
        ZeroPaddingLayer)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer

    conv_like = (ConvolutionLayer, SubsamplingLayer, ZeroPaddingLayer,
                 SpaceToDepthLayer)
    if isinstance(prev, ConvolutionalFlatType) and isinstance(layer,
                                                              conv_like):
        return UnflattenToCnn(prev.height, prev.width, prev.channels)
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer

    if isinstance(prev, ConvolutionalType) and isinstance(
            layer, DenseLayer) and not isinstance(layer, RnnOutputLayer):
        return CnnToFeedForward(prev.height, prev.width, prev.channels)
    return None
