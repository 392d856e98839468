"""Weight noise: parameter perturbation during the training forward pass.

The port of the JAX package's ``nn/weightnoise.py`` (reference:
deeplearning4j-nn/.../nn/conf/weightnoise/: IWeightNoise, WeightNoise,
DropConnect). A layer's parameters are perturbed just before its
``apply`` in training (``Layer.apply_weight_noise``); the noise is not
stored, so it is drawn anew each step and the gradients flow through the
noisy values to the stored ones. Draws come from the model's
``torch.Generator``, one leaf after another in parameter order; they
never equal the JAX package's threefry draws (the distributions do).
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.distributions import (Distribution,
                                                       NormalDistribution)
from deeplearning4j_tpu_torch.nn.param_keys import is_bias_key
from deeplearning4j_tpu_torch.utils.serde import register_serializable


def _map_leaves(params, fn):
    """``fn(key, leaf)`` over nested dicts, in insertion order."""
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in params.items()}


@dataclasses.dataclass(frozen=True)
class IWeightNoise:
    """SPI: conf/weightnoise/IWeightNoise.java."""

    def apply_noise(self, params, generator: torch.Generator):
        raise NotImplementedError


@register_serializable
@dataclasses.dataclass(frozen=True)
class WeightNoise(IWeightNoise):
    """Additive or multiplicative noise drawn from a distribution
    (conf/weightnoise/WeightNoise.java)."""
    distribution: Distribution = dataclasses.field(
        default_factory=lambda: NormalDistribution(0.0, 0.01))
    additive: bool = True
    apply_to_bias: bool = False

    def apply_noise(self, params, generator):
        def noisy(key, p):
            if not self.apply_to_bias and is_bias_key(key):
                return p
            noise = self.distribution.sample(generator, p.shape, p.dtype)
            return p + noise if self.additive else p * noise
        return _map_leaves(params, noisy)


@register_serializable
@dataclasses.dataclass(frozen=True)
class DropConnect(IWeightNoise):
    """Per-weight dropout (conf/weightnoise/DropConnect.java);
    ``p`` = drop probability, inverted scaling."""
    p: float = 0.5
    apply_to_bias: bool = False

    def apply_noise(self, params, generator):
        keep = 1.0 - self.p

        def drop(key, w):
            if not self.apply_to_bias and is_bias_key(key):
                return w
            u = torch.rand(w.shape, generator=generator,
                           device=generator.device)
            return torch.where(u < keep, w / keep,
                               torch.zeros_like(w)).to(w.dtype)
        return _map_leaves(params, drop)
