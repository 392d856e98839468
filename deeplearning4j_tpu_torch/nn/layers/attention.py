"""Attention and transformer layers.

The port of the JAX package's ``nn/layers/attention.py`` (the reference has
no attention layers): the building blocks of the BERT-class stack.

- one packed QKV projection, its columns head-major ((head, which, dh)),
  so q, k and v are strided views of one tensor that the flash kernels
  read in place;
- softmax in (at least) float32 whatever the compute dtype;
- masks are (N, T) sequence masks as everywhere else in the framework;
  padding stays in the sequence, masked out.

``SelfAttentionLayer`` attends through ``ops.flash_attention.flash_attention``:
the hand-written kernels for CUDA tensors, their plain versions for CPU
tensors. ``scaled_dot_product_attention`` is the plain full-softmax path.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType, RecurrentType
from deeplearning4j_tpu_torch.nn.layers.base import (FeedForwardLayer, Layer,
                                                     LayerContext)
from deeplearning4j_tpu_torch.nn.layers.normalization import \
    LayerNormalization
from deeplearning4j_tpu_torch.ops import flash_attention
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.initializers import WeightInit
from deeplearning4j_tpu_torch.utils.serde import register_serializable


def scaled_dot_product_attention(q, k, v, mask=None, causal=False):
    """Plain attention on (N, T, H, Dh) tensors, softmax in f32 (f64 for
    f64 inputs); ``mask`` is the (N, T_k) key-validity mask. Scores are
    formed in the inputs' dtype and then widened, as the JAX package forms
    them; masked scores take the large-finite ``finfo.min / 2`` and a
    fully masked row gives exact zeros."""
    dh = q.shape[-1]
    sdt = torch.promote_types(torch.float32, q.dtype)
    s = torch.einsum("nqhd,nkhd->nqkh", q, k).to(sdt)
    s = s / float(dh) ** 0.5
    neg = torch.finfo(sdt).min / 2
    if causal:
        tq, tk = s.shape[1], s.shape[2]
        qpos = torch.arange(tq, device=s.device)[:, None, None]
        kpos = torch.arange(tk, device=s.device)[None, :, None]
        s = torch.where((kpos <= qpos)[None], s, neg)
    valid = None
    if mask is not None:
        valid = mask[:, None, :, None].to(torch.bool)
        s = torch.where(valid, s, neg)
    p = torch.softmax(s, dim=2)
    if valid is not None:
        # fully masked rows: uniform softmax garbage -> exact zeros
        p = torch.where(valid.any(dim=2, keepdim=True), p, 0.0)
    return torch.einsum("nqkh,nkhd->nqhd", p.to(v.dtype), v)


@register_serializable
@dataclasses.dataclass(frozen=True)
class SelfAttentionLayer(FeedForwardLayer):
    """Multi-head self-attention over (N, T, F) with a residual-free
    output projection: y = Attn(xWq, xWk, xWv) Wo; n_out = model width."""
    n_heads: int = 4
    causal: bool = False

    def __post_init__(self):
        if self.n_out and self.n_out % self.n_heads != 0:
            raise ValueError(
                f"n_out={self.n_out} not divisible by n_heads={self.n_heads}")

    def output_type(self, input_type: InputType) -> InputType:
        t = (input_type.timesteps
             if isinstance(input_type, RecurrentType) else None)
        return RecurrentType(self.n_out, t)

    def initialize(self, generator, input_type):
        n_in = self.resolved_n_in(input_type)
        dt = self.param_dtype()
        params = {
            # packed QKV, head-major columns ((head, which, dh))
            "Wqkv": self.weight_init.init(generator, (n_in, 3 * self.n_out),
                                          n_in, self.n_out, dt),
            "Wo": self.weight_init.init(generator, (self.n_out, self.n_out),
                                        self.n_out, self.n_out, dt),
        }
        if self.has_bias:
            params["bqkv"] = torch.zeros((3 * self.n_out,), dtype=dt)
            params["bo"] = torch.zeros((self.n_out,), dtype=dt)
        return params

    def _qkv(self, params, x):
        """q, k, v (N, T, H, Dh): strided views of the packed projection."""
        qkv = torch.matmul(x, params["Wqkv"])
        if self.has_bias:
            qkv = qkv + params["bqkv"]
        n, t, _ = qkv.shape
        h, dh = self.n_heads, self.n_out // self.n_heads
        qkv = qkv.reshape(n, t, h, 3, dh)
        return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]

    def apply(self, params, state, x, ctx: LayerContext):
        x = self.maybe_dropout(x, ctx)
        q, k, v = self._qkv(params, x)
        o = flash_attention.flash_attention(q, k, v, mask=ctx.mask,
                                            causal=self.causal)
        n, t = o.shape[0], o.shape[1]
        y = torch.matmul(o.reshape(n, t, self.n_out), params["Wo"])
        if self.has_bias:
            y = y + params["bo"]
        if ctx.mask is not None:
            y = y * ctx.mask[:, :, None].to(y.dtype)
        return self.activation.apply(y), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class LearnedPositionalEmbedding(Layer):
    """Adds a learned position embedding to (N, T, F) inputs (BERT-style).
    ``max_len`` bounds the trainable table; sequences must be <= max_len."""
    max_len: int = 512
    weight_init: WeightInit = WeightInit.XAVIER

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def initialize(self, generator, input_type):
        f = input_type.shape()[-1]
        dt = self.param_dtype()
        if self.weight_init == WeightInit.XAVIER:
            # BERT-style truncated-scale init for position tables
            return {"P": (0.02 * torch.randn((self.max_len, f),
                                             generator=generator)).to(dt)}
        return {"P": self.weight_init.init(generator, (self.max_len, f),
                                           self.max_len, f, dt)}

    def apply(self, params, state, x, ctx):
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len "
                             f"{self.max_len}")
        return x + params["P"][:t].to(x.dtype), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class TransformerEncoderBlock(FeedForwardLayer):
    """Pre-LN transformer block: x + MHA(LN(x)); x + FFN(LN(x)). ``n_out``
    is the model width (it must equal the input width: residuals),
    ``ffn_mult`` the MLP expansion. Params nest: ``attn`` (the
    SelfAttentionLayer's), ``ln1``, ``ln2``, ``W1``, ``b1``, ``W2``,
    ``b2``."""
    n_heads: int = 4
    ffn_mult: int = 4
    causal: bool = False
    ffn_activation: Activation = Activation.GELU
    attn_dropout: float = 0.0

    def output_type(self, input_type: InputType) -> InputType:
        t = (input_type.timesteps
             if isinstance(input_type, RecurrentType) else None)
        return RecurrentType(self.n_out, t)

    def _parts(self):
        width = self.n_out
        attn = SelfAttentionLayer(
            n_in=width, n_out=width, n_heads=self.n_heads,
            causal=self.causal, weight_init=self.weight_init,
            dropout=self.attn_dropout, dtype=self.dtype,
            has_bias=self.has_bias)
        ln1 = LayerNormalization(dtype=self.dtype)
        ln2 = LayerNormalization(dtype=self.dtype)
        return attn, ln1, ln2

    def initialize(self, generator, input_type):
        width = self.resolved_n_in(input_type)
        if self.n_out and width != self.n_out:
            raise ValueError(
                f"TransformerEncoderBlock needs n_in == n_out "
                f"(residuals); got {width} vs {self.n_out}")
        attn, ln1, ln2 = self._parts()
        rt = RecurrentType(width, None)
        dt = self.param_dtype()
        hidden = self.ffn_mult * width
        params = {
            "attn": attn.initialize(generator, rt),
            "ln1": ln1.initialize(generator, rt),
            "ln2": ln2.initialize(generator, rt),
            "W1": self.weight_init.init(generator, (width, hidden), width,
                                        hidden, dt),
            "W2": self.weight_init.init(generator, (hidden, width), hidden,
                                        width, dt),
        }
        if self.has_bias:
            params["b1"] = torch.zeros((hidden,), dtype=dt)
            params["b2"] = torch.zeros((width,), dtype=dt)
        return params

    def apply(self, params, state, x, ctx: LayerContext):
        x = self.maybe_dropout(x, ctx)
        attn, ln1, ln2 = self._parts()
        h, _ = ln1.apply(params["ln1"], {}, x, ctx)
        a, _ = attn.apply(params["attn"], {}, h, ctx)
        x = x + a
        h, _ = ln2.apply(params["ln2"], {}, x, ctx)
        f = torch.matmul(h, params["W1"])
        if self.has_bias:
            f = f + params["b1"]
        f = self.ffn_activation.apply(f)
        f = torch.matmul(f, params["W2"])
        if self.has_bias:
            f = f + params["b2"]
        y = x + f
        if ctx.mask is not None:
            y = y * ctx.mask[:, :, None].to(y.dtype)
        return y, state
