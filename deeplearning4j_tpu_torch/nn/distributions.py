"""Weight distributions.

The port of the JAX package's ``nn/distributions.py`` (reference:
deeplearning4j-nn/.../nn/conf/distribution/: NormalDistribution,
UniformDistribution, TruncatedNormalDistribution, LogNormalDistribution,
BinomialDistribution, ConstantDistribution, OrthogonalDistribution).
Each is both a sampler (weight noise, nn/weightnoise.py) and a weight
initializer: ``init(generator, shape, fan_in, fan_out, dtype, gain)``
has ``WeightInit.init``'s signature, so a distribution goes wherever a
``WeightInit`` does (the reference's ``WeightInit.DISTRIBUTION`` +
``dist(...)``). Draws come from an explicit ``torch.Generator`` on its
own device; they never equal the JAX package's threefry draws, only
their distribution does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from deeplearning4j_tpu_torch.utils.serde import register_serializable


def _randn(generator, shape, dtype=torch.float32):
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device)


def _rand(generator, shape, dtype=torch.float32):
    return torch.rand(tuple(shape), generator=generator, dtype=dtype,
                      device=generator.device)


@dataclasses.dataclass(frozen=True)
class Distribution:
    def sample(self, generator: torch.Generator, shape: Sequence[int],
               dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError

    # WeightInit-compatible signature
    def init(self, generator: torch.Generator, shape: Sequence[int],
             fan_in: int, fan_out: int, dtype=torch.float32,
             gain: float = 1.0) -> torch.Tensor:
        return gain * self.sample(generator, tuple(int(s) for s in shape),
                                  dtype)


@register_serializable
@dataclasses.dataclass(frozen=True)
class NormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0

    def sample(self, generator, shape, dtype=torch.float32):
        return (self.mean + self.std * _randn(generator, shape)).to(dtype)


@register_serializable
@dataclasses.dataclass(frozen=True)
class UniformDistribution(Distribution):
    lower: float = -1.0
    upper: float = 1.0

    def sample(self, generator, shape, dtype=torch.float32):
        u = _rand(generator, shape)
        return (self.lower + (self.upper - self.lower) * u).to(dtype)


@register_serializable
@dataclasses.dataclass(frozen=True)
class TruncatedNormalDistribution(Distribution):
    """Normal cut at two standard deviations (``jax.random.
    truncated_normal(-2, 2)``), drawn by the inverse CDF."""
    mean: float = 0.0
    std: float = 1.0

    def sample(self, generator, shape, dtype=torch.float32):
        cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
        lo, hi = cdf(-2.0), cdf(2.0)
        u = lo + (hi - lo) * _rand(generator, shape, torch.float64)
        z = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp(-2.0, 2.0)
        return (self.mean + self.std * z).to(dtype)


@register_serializable
@dataclasses.dataclass(frozen=True)
class LogNormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0

    def sample(self, generator, shape, dtype=torch.float32):
        return torch.exp(self.mean + self.std *
                         _randn(generator, shape)).to(dtype)


@register_serializable
@dataclasses.dataclass(frozen=True)
class BinomialDistribution(Distribution):
    trials: int = 1
    probability: float = 0.5

    def sample(self, generator, shape, dtype=torch.float32):
        u = _rand(generator, (self.trials,) + tuple(shape))
        return (u < self.probability).sum(0).to(dtype)


@register_serializable
@dataclasses.dataclass(frozen=True)
class ConstantDistribution(Distribution):
    value: float = 0.0

    def sample(self, generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), float(self.value), dtype=dtype,
                          device=generator.device)


@register_serializable
@dataclasses.dataclass(frozen=True)
class OrthogonalDistribution(Distribution):
    """(rows, prod(rest)) with orthonormal rows or columns (the QR of a
    normal matrix, signs fixed by R's diagonal), times ``gain``."""
    gain: float = 1.0

    def sample(self, generator, shape, dtype=torch.float32):
        if len(shape) < 2:
            raise ValueError("orthogonal init needs >= 2 dims")
        rows = int(shape[0])
        cols = math.prod(int(s) for s in shape[1:])
        a = _randn(generator, (max(rows, cols), min(rows, cols)))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)).to(dtype)
