"""Activation functions.

Analog of the ND4J activation registry the reference consumes
(``org.nd4j.linalg.activations.Activation``), with the same member names
as the JAX package's enum so configurations round-trip between the two.
Each activation is plain torch math on a tensor.
"""

from __future__ import annotations

import enum

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.utils.serde import register_enum


@register_enum
class Activation(enum.Enum):
    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    TANH = "tanh"
    HARDTANH = "hardtanh"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    SOFTMAX = "softmax"
    LOGSOFTMAX = "logsoftmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    SWISH = "swish"
    MISH = "mish"
    CUBE = "cube"
    THRESHOLDEDRELU = "thresholdedrelu"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return _FNS[self](x)


def _rational_tanh(x):
    # rational approximation of 1.7159 * tanh(2x/3), kept for parity with
    # the reference's RationalTanh
    a = torch.clamp(x * (2.0 / 3.0), -3.0, 3.0)
    p = a * (27.0 + a * a) / (27.0 + 9.0 * a * a)
    return 1.7159 * p


_FNS = {
    Activation.IDENTITY: lambda x: x,
    Activation.RELU: torch.relu,
    Activation.RELU6: F.relu6,
    Activation.LEAKYRELU: lambda x: F.leaky_relu(x, 0.01),
    Activation.ELU: F.elu,
    Activation.SELU: F.selu,
    # exact (erf) GELU, as in the JAX package
    Activation.GELU: lambda x: F.gelu(x, approximate="none"),
    Activation.SIGMOID: torch.sigmoid,
    # jax.nn.hard_sigmoid: relu6(x + 3) / 6
    Activation.HARDSIGMOID: lambda x: F.relu6(x + 3.0) / 6.0,
    Activation.TANH: torch.tanh,
    Activation.HARDTANH: lambda x: torch.clamp(x, -1.0, 1.0),
    Activation.RATIONALTANH: _rational_tanh,
    Activation.RECTIFIEDTANH: lambda x: torch.clamp(torch.tanh(x), min=0.0),
    Activation.SOFTMAX: lambda x: torch.softmax(x, dim=-1),
    Activation.LOGSOFTMAX: lambda x: torch.log_softmax(x, dim=-1),
    Activation.SOFTPLUS: F.softplus,
    Activation.SOFTSIGN: F.softsign,
    Activation.SWISH: F.silu,
    Activation.MISH: F.mish,
    Activation.CUBE: lambda x: x ** 3,
    Activation.THRESHOLDEDRELU: lambda x: torch.where(
        x > 1.0, x, torch.zeros_like(x)),
}
