"""Learning-rate (and generally hyperparameter) schedules.

The JAX package's ``optimize/schedules.py`` (reference:
``org.nd4j.linalg.schedule.ISchedule``) with the same names and fields,
so a ``configuration.json`` holding a schedule loads in either package.
``value_at(count)`` takes the step count an updater keeps in its own
state (an int32 tensor, as optax's ``scale_by_schedule`` keeps it) and
returns a float32 tensor on the count's device, computed in float32 as
the JAX package computes it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from deeplearning4j_tpu_torch.utils.serde import register_serializable


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def _c(v, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a float32 scalar tensor beside ``like``."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


class Schedule:
    def value_at(self, iteration, epoch=0) -> torch.Tensor:
        raise NotImplementedError


@register_serializable
@dataclasses.dataclass(frozen=True)
class FixedSchedule(Schedule):
    value: float

    def value_at(self, iteration, epoch=0):
        return _c(self.value, _f32(iteration))


@register_serializable
@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(Schedule):
    initial_value: float
    gamma: float

    def value_at(self, iteration, epoch=0):
        it = _f32(iteration)
        return self.initial_value * torch.pow(_c(self.gamma, it), it)


@register_serializable
@dataclasses.dataclass(frozen=True)
class InverseSchedule(Schedule):
    initial_value: float
    gamma: float
    power: float

    def value_at(self, iteration, epoch=0):
        it = _f32(iteration)
        return self.initial_value / torch.pow(1.0 + self.gamma * it,
                                              self.power)


@register_serializable
@dataclasses.dataclass(frozen=True)
class PolySchedule(Schedule):
    initial_value: float
    power: float
    max_iter: int

    def value_at(self, iteration, epoch=0):
        it = _f32(iteration)
        frac = torch.clamp(it / float(self.max_iter), 0.0, 1.0)
        return self.initial_value * torch.pow(1.0 - frac, self.power)


@register_serializable
@dataclasses.dataclass(frozen=True)
class SigmoidSchedule(Schedule):
    initial_value: float
    gamma: float
    step_size: int

    def value_at(self, iteration, epoch=0):
        it = _f32(iteration)
        return self.initial_value / (
            1.0 + torch.exp(self.gamma * (it - self.step_size)))


@register_serializable
@dataclasses.dataclass(frozen=True)
class StepSchedule(Schedule):
    initial_value: float
    decay_rate: float
    step_size: int

    def value_at(self, iteration, epoch=0):
        it = _f32(iteration)
        return self.initial_value * torch.pow(
            _c(self.decay_rate, it), torch.floor(it / float(self.step_size)))


@register_serializable
@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule(Schedule):
    """Linear warmup then cosine decay."""
    peak_value: float
    warmup_iters: int
    total_iters: int
    end_value: float = 0.0

    def value_at(self, iteration, epoch=0):
        it = _f32(iteration)
        warm = self.peak_value * it / max(float(self.warmup_iters), 1.0)
        denom = max(float(self.total_iters - self.warmup_iters), 1.0)
        frac = torch.clamp((it - self.warmup_iters) / denom, 0.0, 1.0)
        cos = self.end_value + 0.5 * (self.peak_value - self.end_value) * (
            1.0 + torch.cos(math.pi * frac))
        return torch.where(it < self.warmup_iters, warm, cos)
