"""Output layers and global pooling.

Analogs of the reference's ``OutputLayer``, ``RnnOutputLayer`` and
``GlobalPoolingLayer``
(nn/conf/layers/). An output layer is a dense projection plus a loss;
models call ``compute_loss`` for training and ``apply`` for inference.
(SOFTMAX, MCXENT/NLL) and (SIGMOID, XENT) pairs take the loss on the
logits (``stable_mcxent_from_logits``, ``stable_xent_from_logits``), as
the JAX package does.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.inputs import (ConvolutionalType,
                                                FeedForwardType, InputType,
                                                RecurrentType)
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.convolution import PoolingType
from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
from deeplearning4j_tpu_torch.ops import losses as L
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.utils.serde import register_serializable


def _fused_loss(activation, loss_fn, labels, logits, mask):
    if activation is Activation.SOFTMAX and loss_fn in (
            LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
        return L.stable_mcxent_from_logits(labels, logits, mask)
    if activation is Activation.SIGMOID and loss_fn is LossFunction.XENT:
        return L.stable_xent_from_logits(labels, logits, mask)
    return None


@register_serializable
@dataclasses.dataclass(frozen=True)
class OutputLayer(DenseLayer):
    """Dense + loss (reference: nn/conf/layers/OutputLayer)."""
    loss: LossFunction = LossFunction.MCXENT
    activation: Activation = Activation.SOFTMAX

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, RecurrentType):
            return RecurrentType(self.n_out, input_type.timesteps)
        return FeedForwardType(self.n_out)

    def compute_loss(self, params, state, x, labels, ctx):
        x = self.maybe_dropout(x, ctx)
        logits = self.pre_output(params, x)
        fused = _fused_loss(self.activation, self.loss, labels, logits,
                            ctx.mask)
        if fused is not None:
            return fused
        return self.loss(labels, self.activation.apply(logits), ctx.mask)


@register_serializable
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(OutputLayer):
    """Per-timestep output (reference: RnnOutputLayer). Input (N, T, F),
    labels (N, T, n_out), mask (N, T); the loss is the mean over the
    (unmasked) N·T steps."""

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps if isinstance(input_type, RecurrentType) \
            else None
        return RecurrentType(self.n_out, t)


@register_serializable
@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial dims of an NHWC map, (N,H,W,C) →
    (N,C) (reference: nn/layers/pooling/GlobalPoolingLayer.java)."""
    pooling_type: PoolingType = PoolingType.MAX
    pnorm: int = 2

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, ConvolutionalType):
            return FeedForwardType(input_type.channels)
        if isinstance(input_type, RecurrentType):
            return FeedForwardType(input_type.size)
        return input_type

    def apply(self, params, state, x, ctx):
        if x.ndim != 4:
            raise NotImplementedError(
                "GlobalPoolingLayer: only NHWC (4-D) inputs are ported")
        dims = (1, 2)
        pt = self.pooling_type
        if pt is PoolingType.MAX:
            return torch.amax(x, dim=dims), state
        if pt is PoolingType.AVG:
            return torch.mean(x, dim=dims), state
        if pt is PoolingType.SUM:
            return torch.sum(x, dim=dims), state
        if pt is PoolingType.PNORM:
            pn = float(self.pnorm)
            return torch.sum(x.abs() ** pn, dim=dims) ** (1.0 / pn), state
        raise ValueError(pt)
