"""Output layers and global pooling.

Analogs of the reference's ``OutputLayer``, ``RnnOutputLayer``,
``LossLayer``, ``RnnLossLayer``, ``CnnLossLayer``,
``CenterLossOutputLayer`` and ``GlobalPoolingLayer`` (nn/conf/layers/). An output layer is a dense projection plus a loss;
models call ``compute_loss`` for training and ``apply`` for inference.
(SOFTMAX, MCXENT/NLL) and (SIGMOID, XENT) pairs take the loss on the
logits (``stable_mcxent_from_logits``, ``stable_xent_from_logits``), as
the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

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
class LossLayer(Layer):
    """A loss with no parameters (reference: nn/conf/layers/LossLayer):
    the activation on the input, then the loss against the labels."""
    loss: LossFunction = LossFunction.MCXENT
    activation: Activation = Activation.IDENTITY

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def apply(self, params, state, x, ctx):
        return self.activation.apply(x), state

    def compute_loss(self, params, state, x, labels, ctx):
        fused = _fused_loss(self.activation, self.loss, labels, x, ctx.mask)
        if fused is not None:
            return fused
        return self.loss(labels, self.activation.apply(x), ctx.mask)


@register_serializable
@dataclasses.dataclass(frozen=True)
class RnnLossLayer(LossLayer):
    """Per-timestep loss without a projection (reference:
    nn/conf/layers/RnnLossLayer.java): input and labels (N, T, F), the
    (N, T) mask weighting the steps as in ``RnnOutputLayer``."""

    def output_type(self, input_type: InputType) -> InputType:
        if not isinstance(input_type, RecurrentType):
            raise ValueError(
                "RnnLossLayer expects recurrent (N, T, F) input, got "
                f"{input_type}")
        return input_type


@register_serializable
@dataclasses.dataclass(frozen=True)
class CnnLossLayer(LossLayer):
    """Per-pixel loss over NHWC maps (reference: CnnLossLayer): labels of
    the same NHWC shape, an (N, H, W) mask weighting the pixels; the maps
    are flattened to (N, H·W, C) and scored as a sequence."""

    def compute_loss(self, params, state, x, labels, ctx):
        n = x.shape[0]
        x2 = x.reshape(n, -1, x.shape[-1])
        l2 = labels.reshape(n, -1, labels.shape[-1])
        mask = None if ctx.mask is None else ctx.mask.reshape(n, -1)
        fused = _fused_loss(self.activation, self.loss, l2, x2, mask)
        if fused is not None:
            return fused
        return self.loss(l2, self.activation.apply(x2), mask)


@register_serializable
@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial dims of an NHWC map, (N,H,W,C) →
    (N,C), or over time, (N,T,F) → (N,F) with the sequence mask
    (reference: nn/layers/pooling/GlobalPoolingLayer.java). With a mask,
    MAX fills masked steps with -inf (a fully masked row gives -inf) and
    AVG divides by the unmasked count (at least 1)."""
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
        dims = (1, 2) if x.ndim == 4 else (1,)
        mask = None if x.ndim == 4 else ctx.mask
        pt = self.pooling_type
        pn = float(self.pnorm)
        if mask is not None:
            m = mask[:, :, None].to(x.dtype)
            if pt is PoolingType.MAX:
                return torch.amax(x.masked_fill(m <= 0, -math.inf),
                                  dim=dims), state
            if pt is PoolingType.SUM:
                return torch.sum(x * m, dim=dims), state
            if pt is PoolingType.AVG:
                denom = torch.clamp(torch.sum(m, dim=dims), min=1.0)
                return torch.sum(x * m, dim=dims) / denom, state
            if pt is PoolingType.PNORM:
                return torch.sum((x.abs() * m) ** pn, dim=dims) ** (
                    1.0 / pn), state
            raise ValueError(pt)
        if pt is PoolingType.MAX:
            return torch.amax(x, dim=dims), state
        if pt is PoolingType.AVG:
            return torch.mean(x, dim=dims), state
        if pt is PoolingType.SUM:
            return torch.sum(x, dim=dims), state
        if pt is PoolingType.PNORM:
            return torch.sum(x.abs() ** pn, dim=dims) ** (1.0 / pn), state
        raise ValueError(pt)


@register_serializable
@dataclasses.dataclass(frozen=True)
class CenterLossOutputLayer(OutputLayer):
    """Softmax + center loss (reference: CenterLossOutputLayer): the
    output layer's loss plus ``lambda_/2 · mean ||x - c_y||²``, where the
    per-class centers ``centers`` (n_out, n_in) are a parameter that
    gradient descent learns, as in the JAX package (the reference's EMA
    update with rate ``alpha`` is SGD on the same term; ``alpha`` is kept
    for configuration parity)."""
    alpha: float = 0.05
    lambda_: float = 2e-4

    def initialize(self, generator, input_type):
        params = super().initialize(generator, input_type)
        params["centers"] = torch.zeros(
            (self.n_out, self.resolved_n_in(input_type)),
            dtype=self.param_dtype())
        return params

    def compute_loss(self, params, state, x, labels, ctx):
        x = self.maybe_dropout(x, ctx)
        logits = self.pre_output(params, x)
        fused = _fused_loss(self.activation, self.loss, labels, logits,
                            ctx.mask)
        base = fused if fused is not None else self.loss(
            labels, self.activation.apply(logits), ctx.mask)
        # the JAX package's einsum of f32 labels and centers in x's dtype
        # promotes, so the center term runs in promote(labels, x)
        dt = torch.promote_types(labels.dtype, x.dtype)
        assigned = torch.matmul(labels.to(dt),
                                params["centers"].to(x.dtype).to(dt))
        center = 0.5 * self.lambda_ * torch.mean(
            torch.sum(torch.square(x - assigned), dim=-1))
        return base + center
