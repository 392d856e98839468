"""Parameter constraints, applied after each optimizer update.

The port of the JAX package's ``nn/constraints.py`` (reference:
deeplearning4j-nn/.../nn/conf/constraint/: MaxNormConstraint,
MinMaxNormConstraint, UnitNormConstraint, NonNegativeConstraint). The
train steps apply them to the new parameters right after the update
(optimize/solver.make_constrain_fn), as the reference does in
BaseMultiLayerUpdater.update. Weights are classified by their leaf key
(nn/param_keys.py): bias-like leaves are left alone unless
``apply_to_bias``, and statistics-like leaves always.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.nn.param_keys import is_bias_key, is_weight_key
from deeplearning4j_tpu_torch.utils.serde import register_serializable


def _weight_axes(w: torch.Tensor) -> Tuple[int, ...]:
    """Norm is taken over all axes except the last (output dim) —
    matching the reference's default dimensions for dense/conv weights."""
    return tuple(range(max(w.ndim - 1, 1)))


def _norm(w: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(w.square().sum(dim=_weight_axes(w), keepdim=True)
                      + 1e-12)


@dataclasses.dataclass(frozen=True)
class LayerConstraint:
    """SPI: conf/constraint/ BaseConstraint. ``apply_to_bias`` default off,
    like the reference (constraints apply to weights only by default)."""
    apply_to_bias: bool = False

    def project(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, params):
        """``params`` (nested dicts of tensors) with every weight-like leaf
        projected."""
        def go(tree):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = go(v)
                elif (not self.apply_to_bias and is_bias_key(k)) or \
                        (not is_weight_key(k) and not is_bias_key(k)):
                    out[k] = v       # statistics-like params: never
                else:
                    out[k] = self.project(v)
            return out
        return go(params)


@register_serializable
@dataclasses.dataclass(frozen=True)
class MaxNormConstraint(LayerConstraint):
    max_norm: float = 2.0

    def project(self, w):
        return w * torch.clamp(self.max_norm / _norm(w), max=1.0)


@register_serializable
@dataclasses.dataclass(frozen=True)
class MinMaxNormConstraint(LayerConstraint):
    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0  # interpolation rate toward the clipped norm

    def project(self, w):
        norm = _norm(w)
        clipped = torch.clamp(norm, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1.0 - self.rate) * norm
        return w * (target / norm)


@register_serializable
@dataclasses.dataclass(frozen=True)
class UnitNormConstraint(LayerConstraint):
    def project(self, w):
        return w / _norm(w)


@register_serializable
@dataclasses.dataclass(frozen=True)
class NonNegativeConstraint(LayerConstraint):
    def project(self, w):
        return torch.clamp(w, min=0.0)
