"""Dense and activation layers.

Analogs of the reference's ``DenseLayer`` and ``ActivationLayer``
(nn/conf/layers/), the two of the JAX package's ``nn/layers/feedforward.py``
that the served ResNet50 runs (the output layer is a dense layer).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.inputs import (FeedForwardType, InputType,
                                                RecurrentType)
from deeplearning4j_tpu_torch.nn.layers.base import FeedForwardLayer, Layer
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.utils.serde import register_serializable


@register_serializable
@dataclasses.dataclass(frozen=True)
class DenseLayer(FeedForwardLayer):
    """y = act(x @ W + b), W (n_in, n_out); (N, F) and (N, T, F) inputs."""

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, RecurrentType):
            return RecurrentType(self.n_out, input_type.timesteps)
        return FeedForwardType(self.n_out)

    def initialize(self, generator, input_type):
        n_in = self.resolved_n_in(input_type)
        dt = self.param_dtype()
        params = {"W": self.weight_init.init(generator, (n_in, self.n_out),
                                             n_in, self.n_out, dt)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dt)
        return params

    def pre_output(self, params, x):
        y = torch.matmul(x, params["W"])
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params, state, x, ctx):
        x = self.maybe_dropout(x, ctx)
        return self.activation.apply(self.pre_output(params, x)), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class ActivationLayer(Layer):
    """Standalone activation (reference: nn/conf/layers/ActivationLayer).
    ``alpha`` parameterizes LEAKYRELU and ELU; None keeps each function's
    default (leaky 0.01, elu 1.0)."""
    activation: Activation = Activation.RELU
    alpha: Optional[float] = None

    @property
    def has_params(self):
        return False

    def output_type(self, input_type):
        return input_type

    def apply(self, params, state, x, ctx):
        if self.alpha is not None:
            if self.activation == Activation.LEAKYRELU:
                return F.leaky_relu(x, self.alpha), state
            if self.activation == Activation.ELU:
                return F.elu(x, self.alpha), state
        return self.activation.apply(x), state
