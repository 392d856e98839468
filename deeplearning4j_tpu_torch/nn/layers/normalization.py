"""Batch normalization (inference).

Analog of the reference's ``BatchNormalization``
(nn/layers/normalization/BatchNormalization.java:41). Running statistics
live in the layer **state** dict (not params), as in the JAX package. The
port serves, so ``apply`` normalizes with the running statistics; the
batch-statistics forward comes with the training slice.
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
        if ctx.train and not self.use_global_stats_in_train:
            self.check_inference(ctx)
        # the inverse std in (at least) float32, then the normalize in the
        # activation dtype — the JAX package's order of roundings
        sdt = torch.promote_types(torch.float32, x.dtype)
        inv = 1.0 / torch.sqrt(state["var"].to(sdt) + self.eps)
        y = (x - state["mean"].to(x.dtype)) * inv.to(x.dtype)
        if not self.lock_gamma_beta:
            y = y * params["gamma"] + params["beta"]
        return y, state
