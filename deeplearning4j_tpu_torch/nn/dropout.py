"""Dropout family.

The JAX package's ``nn/dropout.py`` (reference: nn/conf/dropout/ —
IDropout.java, Dropout.java, AlphaDropout.java, GaussianDropout.java,
GaussianNoise.java) with the same names and fields, so a
``configuration.json`` carrying one loads in either package. Layers call
them on their INPUT during training.

Each kind splits into ``draw(x, generator)`` — the random mask or noise,
from a ``torch.Generator`` on ``x``'s device — and ``apply_draw(x, d)``,
the JAX package's formula on that draw; ``apply_dropout`` is the two in
turn. JAX's threefry and torch's Philox never give the same numbers, so
the packages agree in distribution, and exactly on an injected draw.

NOTE on probability convention: as in the JAX package, ``p`` is the DROP
probability (the reference's ``Dropout(p)`` takes the retain
probability).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.utils.serde import register_serializable

_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


@dataclasses.dataclass(frozen=True)
class IDropout:
    """SPI: conf/dropout/IDropout.java."""

    def draw(self, x: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        raise NotImplementedError

    def apply_draw(self, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_dropout(self, x: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        return self.apply_draw(x, self.draw(x, generator))


def _keep_mask(x, keep, generator):
    """Bernoulli(keep) booleans of ``x``'s shape."""
    return torch.rand(x.shape, generator=generator, device=x.device) < keep


def _normal(x, generator):
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


@register_serializable
@dataclasses.dataclass(frozen=True)
class Dropout(IDropout):
    """Inverted dropout; ``p`` = drop probability: x / (1 - p) where
    kept, else 0."""
    p: float = 0.5

    def draw(self, x, generator):
        return _keep_mask(x, 1.0 - self.p, generator)

    def apply_draw(self, x, d):
        return torch.where(d, x / (1.0 - self.p), 0.0).to(x.dtype)


@register_serializable
@dataclasses.dataclass(frozen=True)
class AlphaDropout(IDropout):
    """Self-normalizing dropout for SELU nets (conf/dropout/AlphaDropout
    .java): dropped units go to alpha' = -alpha·scale, then the affine
    a·x + b keeps the mean and variance."""
    p: float = 0.05

    def draw(self, x, generator):
        return _keep_mask(x, 1.0 - self.p, generator)

    def apply_draw(self, x, d):
        alpha_p = -_SELU_ALPHA * _SELU_SCALE
        keep = 1.0 - self.p
        a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        return (a * torch.where(d, x, alpha_p) + b).to(x.dtype)


@register_serializable
@dataclasses.dataclass(frozen=True)
class GaussianDropout(IDropout):
    """Multiplicative gaussian noise N(1, rate/(1-rate))
    (conf/dropout/GaussianDropout.java); the draw is the standard
    normal."""
    rate: float = 0.5

    def draw(self, x, generator):
        return _normal(x, generator)

    def apply_draw(self, x, d):
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + std * d)


@register_serializable
@dataclasses.dataclass(frozen=True)
class GaussianNoise(IDropout):
    """Additive gaussian noise (conf/dropout/GaussianNoise.java); the
    draw is the standard normal."""
    stddev: float = 0.1

    def draw(self, x, generator):
        return _normal(x, generator)

    def apply_draw(self, x, d):
        return x + self.stddev * d
