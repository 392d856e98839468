"""Dense, activation, dropout and embedding layers.

Analogs of the reference's ``DenseLayer``, ``ActivationLayer``,
``DropoutLayer``, ``EmbeddingLayer`` and ``EmbeddingSequenceLayer``
(nn/conf/layers/), the five of the JAX package's
``nn/layers/feedforward.py`` that the ported models run (the ResNet50's
output layer is a dense layer; the transformer stack and the sequence
models start with an embedding).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

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


@register_serializable
@dataclasses.dataclass(frozen=True)
class DropoutLayer(Layer):
    """Standalone dropout layer (reference: nn/conf/layers/DropoutLayer).
    The base config's ``dropout`` is the drop probability (or an
    ``IDropout``); the identity outside training."""
    dropout: Any = 0.5

    @property
    def has_params(self):
        return False

    def output_type(self, input_type):
        return input_type

    def apply(self, params, state, x, ctx):
        return self.maybe_dropout(x, ctx), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class EmbeddingLayer(FeedForwardLayer):
    """Index lookup (reference: EmbeddingLayer, a dense layer whose input
    is an index): (N,) or (N, 1) ids → act(W[id] + b), W (n_in, n_out).
    Ids go in as an integer tensor (or float32, exact below 2^24)."""

    def output_type(self, input_type: InputType) -> InputType:
        return FeedForwardType(self.n_out)

    def initialize(self, generator, input_type):
        if self.n_in is None:
            raise ValueError("EmbeddingLayer requires explicit n_in "
                             "(vocab size)")
        dt = self.param_dtype()
        params = {"W": self.weight_init.init(generator, (self.n_in,
                                                         self.n_out),
                                             self.n_in, self.n_out, dt)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dt)
        return params

    def apply(self, params, state, x, ctx):
        idx = _ids(x, "EmbeddingLayer")
        if idx.ndim > 1 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        y = params["W"][idx]
        if self.has_bias:
            y = y + params["b"]
        return self.activation.apply(y), state


def _ids(x: torch.Tensor, who: str) -> torch.Tensor:
    """Token ids as int64; a bf16/f16 feature tensor raises, since bf16
    rounds every id above 256."""
    if x.dtype in (torch.bfloat16, torch.float16):
        raise TypeError(
            f"{who}: token ids arrived as {x.dtype}, which rounds ids above "
            "256; pass them as an integer tensor (a float feature array is "
            "cast to the compute dtype)")
    return x.to(torch.long)


@register_serializable
@dataclasses.dataclass(frozen=True)
class EmbeddingSequenceLayer(FeedForwardLayer):
    """Sequence of indices (N, T) (or (N, T, 1)) → (N, T, n_out) rows of
    W (n_in, n_out) (reference: EmbeddingSequenceLayer). Ids are passed as
    an integer tensor (or float32, exact below 2^24); a bfloat16 feature
    tensor raises, since bf16 rounds every id above 256."""

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps if isinstance(input_type, RecurrentType) \
            else None
        return RecurrentType(self.n_out, t)

    def initialize(self, generator, input_type):
        if self.n_in is None:
            raise ValueError("EmbeddingSequenceLayer requires explicit n_in")
        dt = self.param_dtype()
        return {"W": self.weight_init.init(generator, (self.n_in, self.n_out),
                                           self.n_in, self.n_out, dt)}

    def apply(self, params, state, x, ctx):
        idx = _ids(x, "EmbeddingSequenceLayer")
        if idx.ndim == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        return params["W"][idx], state
