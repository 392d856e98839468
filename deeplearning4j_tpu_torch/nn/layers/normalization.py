"""Batch, local response and layer normalization.

Analog of the reference's ``BatchNormalization``
(nn/layers/normalization/BatchNormalization.java:41) and
``LocalResponseNormalization``, and the JAX package's
``LayerNormalization`` (no reference analog; the transformer blocks need
it). Running statistics
live in the layer **state** dict (not params), as in the JAX package: in
training ``apply`` normalizes with the batch statistics (f32, biased
variance) and returns the running averages updated with ``decay`` as the
new state; in inference it normalizes with the running statistics.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops import batch_stats
from deeplearning4j_tpu_torch.utils.serde import register_serializable


@register_serializable
@dataclasses.dataclass(frozen=True)
class BatchNormalization(Layer):
    """Normalizes over all axes except the last (feature/channel) axis."""
    decay: float = 0.9
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0
    lock_gamma_beta: bool = False
    use_global_stats_in_train: bool = False

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def _nf(self, input_type: InputType) -> int:
        return input_type.shape()[-1]

    def initialize(self, generator, input_type):
        nf = self._nf(input_type)
        dt = self.param_dtype()
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((nf,), self.gamma_init, dtype=dt),
                "beta": torch.full((nf,), self.beta_init, dtype=dt)}

    def init_state(self, input_type):
        nf = self._nf(input_type)
        return {"mean": torch.zeros((nf,), dtype=torch.float32),
                "var": torch.ones((nf,), dtype=torch.float32)}

    def apply(self, params, state, x, ctx):
        # statistics and the inverse std in (at least) float32, then the
        # normalize in the activation dtype — the JAX package's roundings
        sdt = torch.promote_types(torch.float32, x.dtype)
        if ctx.train and not self.use_global_stats_in_train:
            dims = tuple(range(x.ndim - 1))
            xf = x.to(sdt)
            group = batch_stats.current()
            if group is not None:
                # the global batch's moments, two-pass as the local ones:
                # sums over the parallel wrapper's ranks (ops/batch_stats)
                n = xf.numel() // xf.shape[-1] * group.world
                mean = group.fn(xf.sum(dim=dims)) / n
                var = group.fn(((xf - mean) ** 2).sum(dim=dims)) / n
            else:
                mean = xf.mean(dim=dims)
                var = xf.var(dim=dims, unbiased=False)
            d = self.decay
            new_state = {
                "mean": (d * state["mean"] + (1 - d) * mean.detach()).float(),
                "var": (d * state["var"] + (1 - d) * var.detach()).float()}
        else:
            mean, var, new_state = state["mean"], state["var"], state
        inv = 1.0 / torch.sqrt(var.to(sdt) + self.eps)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        if not self.lock_gamma_beta:
            y = y * params["gamma"] + params["beta"]
        return y, new_state


@register_serializable
@dataclasses.dataclass(frozen=True)
class LocalResponseNormalization(Layer):
    """Cross-channel LRN on the last (NHWC channel) axis (reference:
    LocalResponseNormalization): y = x / (k + alpha·Σ x²)^beta, the sum
    over a zero-padded window of ``n`` channels centred on each channel.
    ``alpha`` multiplies the window's sum as it is (``F.local_response_norm``
    would divide it by ``n`` and wants NCHW, so it is not used)."""
    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def apply(self, params, state, x, ctx):
        half = self.n // 2
        c = x.shape[-1]
        sq = torch.nn.functional.pad(x * x, (half, half))
        ssum = sum(sq[..., i:i + c] for i in range(self.n))
        return x / torch.pow(self.k + self.alpha * ssum, self.beta), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class LayerNormalization(Layer):
    """Per-example normalization over the feature axis: single-pass
    moments E[x²] − E[x]² in (at least) f32, clamped at 0, the normalized
    value rounded back to x's dtype before the affine ``gamma``/``beta``,
    as in the JAX package."""
    eps: float = 1e-5

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def initialize(self, generator, input_type):
        nf = input_type.shape()[-1]
        dt = self.param_dtype()
        return {"gamma": torch.ones((nf,), dtype=dt),
                "beta": torch.zeros((nf,), dtype=dt)}

    def apply(self, params, state, x, ctx):
        xf = x.to(torch.promote_types(torch.float32, x.dtype))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True)
                              - mean * mean, 0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return y * params["gamma"] + params["beta"], state
