"""Weight initialization schemes.

Analog of the reference's ``WeightInit`` enum + ``WeightInitUtil``
(deeplearning4j-nn/.../nn/weights/WeightInit.java), with the JAX
package's member names and scale formulas. Draws come from an explicit
``torch.Generator``, so the numbers differ from the JAX package's for the
same seed; the distributions (scale by fan-in/fan-out) are the same.
Weights carried across from the JAX package go through
``models.serialization.params_from_jax`` instead.
"""

from __future__ import annotations

import enum
import math
from typing import Sequence

import torch

from deeplearning4j_tpu_torch.utils.serde import register_enum


@register_enum
class WeightInit(enum.Enum):
    ZERO = "zero"
    ONES = "ones"
    CONSTANT = "constant"
    NORMAL = "normal"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    RELU = "relu"            # He normal
    RELU_UNIFORM = "relu_uniform"
    HE_NORMAL = "he_normal"
    HE_UNIFORM = "he_uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    VAR_SCALING_NORMAL_FAN_AVG = "vs_normal_fan_avg"
    IDENTITY = "identity"

    def init(self, generator: torch.Generator, shape: Sequence[int],
             fan_in: int, fan_out: int, dtype=torch.float32,
             gain: float = 1.0) -> torch.Tensor:
        """A CPU tensor drawn from ``generator`` (the caller moves it to
        its device, so the draws do not depend on the device)."""
        return _init(self, generator, tuple(int(s) for s in shape),
                     fan_in, fan_out, gain).to(dtype)


def _normal(g, shape, std):
    return torch.randn(shape, generator=g, dtype=torch.float32) * std


def _uniform(g, shape, a):
    u = torch.rand(shape, generator=g, dtype=torch.float32)
    return (u * 2.0 - 1.0) * a


def _init(scheme, g, shape, fan_in, fan_out, gain):
    fi = max(int(fan_in), 1)
    fo = max(int(fan_out), 1)
    W = WeightInit
    if scheme is W.ZERO:
        return torch.zeros(shape)
    if scheme is W.ONES:
        return torch.ones(shape)
    if scheme is W.CONSTANT:
        return torch.full(shape, float(gain))
    if scheme in (W.NORMAL, W.XAVIER_FAN_IN, W.LECUN_NORMAL):
        return _normal(g, shape, gain / math.sqrt(fi))
    if scheme is W.UNIFORM:
        return _uniform(g, shape, gain / math.sqrt(fi))
    if scheme in (W.XAVIER, W.VAR_SCALING_NORMAL_FAN_AVG):
        return _normal(g, shape, gain * math.sqrt(2.0 / (fi + fo)))
    if scheme is W.XAVIER_UNIFORM:
        return _uniform(g, shape, gain * math.sqrt(6.0 / (fi + fo)))
    if scheme is W.LECUN_UNIFORM:
        return _uniform(g, shape, gain * math.sqrt(3.0 / fi))
    if scheme in (W.RELU, W.HE_NORMAL):
        return _normal(g, shape, gain * math.sqrt(2.0 / fi))
    if scheme in (W.RELU_UNIFORM, W.HE_UNIFORM):
        return _uniform(g, shape, gain * math.sqrt(6.0 / fi))
    if scheme is W.SIGMOID_UNIFORM:
        return _uniform(g, shape, gain * 4.0 * math.sqrt(6.0 / (fi + fo)))
    if scheme is W.IDENTITY:
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2D shape")
        return gain * torch.eye(shape[0])
    raise ValueError(f"unknown WeightInit: {scheme}")
