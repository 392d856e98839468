"""Batch normalization.

Analog of the reference's ``BatchNormalization``
(nn/layers/normalization/BatchNormalization.java:41). Running statistics
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
