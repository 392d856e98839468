"""Dense, activation, dropout and embedding layers.

Analogs of the reference's ``DenseLayer``, ``ActivationLayer``,
``DropoutLayer``, ``EmbeddingLayer``, ``EmbeddingSequenceLayer``,
``ElementWiseMultiplicationLayer`` and ``AutoEncoder`` (nn/conf/layers/),
the JAX package's shape-only ``ReshapeLayer`` and ``PermuteLayer`` (the
Keras ``Reshape`` and ``Permute``), and its ``MixtureOfExperts`` (top-k
routed expert FFNs, parallel/moe.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.inputs import (ConvolutionalType,
                                                FeedForwardType, InputType,
                                                RecurrentType)
from deeplearning4j_tpu_torch.nn.layers.base import FeedForwardLayer, Layer
from deeplearning4j_tpu_torch.ops import tensor_split
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
        # under tensor parallelism W may be a column or a row slice
        # (ops/tensor_split.py); outside, the split points are identities
        y = torch.matmul(tensor_split.copy_in(x, "dense"), params["W"])
        y = tensor_split.reduce_out(y, "dense")
        if self.has_bias:
            y = y + params["b"]
        return tensor_split.gather_out(y, "dense")

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


def _type_for_trailing(shape):
    """Trailing (non-batch) dims → InputType (1 → feed-forward, 2 → (T, F)
    recurrent, 3 → NHWC), as ``ReshapeVertex`` maps them."""
    if len(shape) == 1:
        return FeedForwardType(shape[0])
    if len(shape) == 2:
        return RecurrentType(shape[1], shape[0])
    if len(shape) == 3:
        return ConvolutionalType(shape[0], shape[1], shape[2])
    raise ValueError(f"unsupported shape arity: {shape}")


def _known_shape(input_type: InputType, who: str):
    shape = input_type.shape()
    if any(d < 0 for d in shape):
        raise ValueError(f"{who} needs a fully-known input shape; got "
                         f"{shape} (unknown timesteps)")
    return shape


@register_serializable
@dataclasses.dataclass(frozen=True)
class ReshapeLayer(Layer):
    """Reshape the trailing (non-batch) dims to ``shape`` in row-major
    order (Keras ``Reshape``); one -1 is inferred."""
    shape: tuple = ()

    @property
    def has_params(self):
        return False

    def resolved_shape(self, input_type: InputType):
        total = 1
        for d in _known_shape(input_type, "ReshapeLayer"):
            total *= d
        s = [int(v) for v in self.shape]
        if s.count(-1) > 1:
            raise ValueError(f"ReshapeLayer shape {s} has multiple -1s")
        known = 1
        for v in s:
            if v != -1:
                known *= v
        if -1 in s:
            if known == 0 or total % known:
                raise ValueError(
                    f"cannot infer -1 in reshape {s} from {total} elements")
            s[s.index(-1)] = total // known
        elif known != total:
            raise ValueError(
                f"reshape {tuple(s)} incompatible with input "
                f"{input_type.shape()} ({total} elements)")
        return tuple(s)

    def output_type(self, input_type: InputType) -> InputType:
        return _type_for_trailing(self.resolved_shape(input_type))

    def apply(self, params, state, x, ctx):
        return x.reshape((x.shape[0],) + tuple(int(v) for v in
                                               self.shape)), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class PermuteLayer(Layer):
    """Transpose the trailing (non-batch) dims by the 1-indexed ``dims``
    (Keras ``Permute``: dims=(2, 1) swaps the first two non-batch
    axes)."""
    dims: tuple = ()

    @property
    def has_params(self):
        return False

    def _perm(self, rank: int):
        dims = tuple(int(d) for d in self.dims)
        if sorted(dims) != list(range(1, rank + 1)):
            raise ValueError(f"PermuteLayer dims {dims} is not a "
                             f"permutation of 1..{rank}")
        return dims

    def output_type(self, input_type: InputType) -> InputType:
        shape = _known_shape(input_type, "PermuteLayer")
        dims = self._perm(len(shape))
        return _type_for_trailing(tuple(shape[d - 1] for d in dims))

    def apply(self, params, state, x, ctx):
        return x.permute((0,) + self._perm(x.ndim - 1)), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class ElementWiseMultiplicationLayer(FeedForwardLayer):
    """y = act(x ⊙ W + b), W and b per feature (reference:
    ElementWiseMultiplicationLayer): n_in = n_out; W is drawn by the
    weight init with fan-in = fan-out = n."""

    def __post_init__(self):
        if self.n_in is not None and self.n_out and self.n_in != self.n_out:
            raise ValueError(
                "ElementWiseMultiplicationLayer must have the same input "
                f"and output size. Got n_in={self.n_in}, n_out={self.n_out}")

    def resolved_n_out(self, input_type):
        return self.n_out or self.resolved_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, RecurrentType):
            return RecurrentType(self.resolved_n_out(input_type),
                                 input_type.timesteps)
        return FeedForwardType(self.resolved_n_out(input_type))

    def initialize(self, generator, input_type):
        n = self.resolved_n_in(input_type)
        if self.n_out and self.n_out != n:
            raise ValueError(
                "ElementWiseMultiplicationLayer must have the same input "
                f"and output size. Got n_in={n}, n_out={self.n_out}")
        dt = self.param_dtype()
        params = {"W": self.weight_init.init(generator, (n,), n, n, dt)}
        if self.has_bias:
            params["b"] = torch.zeros((n,), dtype=dt)
        return params

    def apply(self, params, state, x, ctx):
        x = self.maybe_dropout(x, ctx)
        y = x * params["W"]
        if self.has_bias:
            y = y + params["b"]
        return self.activation.apply(y), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class AutoEncoder(FeedForwardLayer):
    """Denoising autoencoder layer (reference: nn/layers/feedforward/
    autoencoder/AutoEncoder.java). In a feed-forward stack it is a dense
    encoder; ``reconstruct`` and pretraining use the tied decoder
    (``W`` transposed, visible bias ``vb``)."""
    corruption_level: float = 0.3

    def output_type(self, input_type):
        return FeedForwardType(self.n_out)

    def initialize(self, generator, input_type):
        n_in = self.resolved_n_in(input_type)
        dt = self.param_dtype()
        return {
            "W": self.weight_init.init(generator, (n_in, self.n_out), n_in,
                                       self.n_out, dt),
            "b": torch.zeros((self.n_out,), dtype=dt),
            "vb": torch.zeros((n_in,), dtype=dt),
        }

    def apply(self, params, state, x, ctx):
        y = torch.matmul(x, params["W"]) + params["b"]
        return self.activation.apply(y), state

    def reconstruct(self, params, h):
        v = torch.matmul(h, params["W"].transpose(0, 1)) + params["vb"]
        return self.activation.apply(v)

    @property
    def supports_pretrain(self) -> bool:
        return True

    def pretrain_loss(self, params, x, generator=None, keep=None):
        """Denoising-reconstruction loss (reference: AutoEncoder
        .computeGradientAndScore: corrupt, encode, decode, squared
        error). The corruption keeps each input with probability
        ``1 - corruption_level``, drawn from ``generator``; ``keep`` (a
        0/1 mask of x's shape) injects it instead, so a test can feed
        two packages the same corruption. Without either, x is used
        uncorrupted, as the JAX package does without a key."""
        if keep is None and self.corruption_level > 0.0 \
                and generator is not None:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) < 1.0 - self.corruption_level
        xc = x if keep is None else torch.where(
            keep.to(torch.bool), x, torch.zeros_like(x))
        h = self.activation.apply(torch.matmul(xc, params["W"])
                                  + params["b"])
        v = self.activation.apply(
            torch.matmul(h, params["W"].transpose(0, 1)) + params["vb"])
        return torch.mean(torch.sum(torch.square(x - v), dim=-1))


@register_serializable
@dataclasses.dataclass(frozen=True)
class MixtureOfExperts(FeedForwardLayer):
    """Sparse MoE FFN (the JAX package's; the reference has no analog):
    top-k routed expert FFNs over the feature dim, with the expert
    weights stacked (E, ...). The load-balancing and router-z losses
    come out through the layer state (``moe_aux_loss``), which both model
    types add to the training loss. A sequence input's (N, T) mask
    reaches the router: padded tokens are not routed, take no capacity,
    do not skew the aux loss, and come out as 0."""

    num_experts: int = 4
    hidden: int = 0              # d_ff; 0 -> 4 * n_out
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    z_weight: float = 0.001

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, RecurrentType):
            return RecurrentType(self.n_out, input_type.timesteps)
        return FeedForwardType(self.n_out)

    def initialize(self, generator, input_type):
        n_in = self.resolved_n_in(input_type)
        d_ff = self.hidden or 4 * self.n_out
        dt = self.param_dtype()
        e = self.num_experts
        return {
            "gate": self.weight_init.init(generator, (n_in, e), n_in, e,
                                          dt),
            "w_in": self.weight_init.init(generator, (e, n_in, d_ff), n_in,
                                          d_ff, dt),
            "b_in": torch.zeros((e, d_ff), dtype=dt),
            "w_out": self.weight_init.init(generator, (e, d_ff, self.n_out),
                                           d_ff, self.n_out, dt),
            "b_out": torch.zeros((e, self.n_out), dtype=dt),
        }

    def init_state(self, input_type):
        return {"moe_aux_loss": torch.zeros((), dtype=torch.float32)}

    def apply(self, params, state, x, ctx):
        from deeplearning4j_tpu_torch.parallel.moe import moe_ffn
        x = self.maybe_dropout(x, ctx)
        tmask = ctx.mask if (ctx.mask is not None and x.ndim == 3) else None
        out = moe_ffn(x, params["gate"], params["w_in"], params["b_in"],
                      params["w_out"], params["b_out"], top_k=self.top_k,
                      capacity_factor=self.capacity_factor,
                      activation=self.activation.apply, token_mask=tmask)
        aux = (self.aux_weight * out.aux_loss
               + self.z_weight * out.router_z_loss)
        return out.y, {"moe_aux_loss": aux}
