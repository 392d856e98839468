"""Graph vertices — DAG combinators for ComputationGraph.

The JAX package's ``GraphVertex`` contract and its ``MergeVertex``,
``ElementWiseVertex`` and three recurrent vertices (reference:
nn/conf/graph/, nn/conf/graph/rnn/). A vertex is a stateless function over
its input tensors; the graph hands ``LastTimeStepVertex`` the sequence
mask. The other vertices wait for a slice whose model uses them.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.inputs import (ConvolutionalType,
                                                FeedForwardType, InputType,
                                                RecurrentType)
from deeplearning4j_tpu_torch.utils.serde import register_serializable


class GraphVertex:
    def output_type(self, *input_types: InputType) -> InputType:
        raise NotImplementedError

    def apply(self, *xs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@register_serializable
@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertex):
    """Concatenate along the feature/channel (last) axis."""

    def output_type(self, *its):
        first = its[0]
        if isinstance(first, ConvolutionalType):
            return ConvolutionalType(first.height, first.width,
                                     sum(i.channels for i in its))
        if isinstance(first, RecurrentType):
            return RecurrentType(sum(i.size for i in its), first.timesteps)
        return FeedForwardType(sum(i.size for i in its))

    def apply(self, *xs):
        return torch.cat(xs, dim=-1)


@register_serializable
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    op: str = "add"  # add|subtract|product|average|max

    def output_type(self, *its):
        return its[0]

    def apply(self, *xs):
        if self.op == "add":
            return sum(xs[1:], xs[0])
        if self.op == "subtract":
            return xs[0] - xs[1]
        if self.op == "product":
            y = xs[0]
            for x in xs[1:]:
                y = y * x
            return y
        if self.op == "average":
            return sum(xs[1:], xs[0]) / len(xs)
        if self.op == "max":
            y = xs[0]
            for x in xs[1:]:
                y = torch.maximum(y, x)
            return y
        raise ValueError(self.op)


@register_serializable
@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(GraphVertex):
    """(N, T, F) → (N, F): each row's last unmasked step (reference:
    rnn/LastTimeStepVertex); the graph passes the sequence mask."""

    def output_type(self, *its):
        return FeedForwardType(its[0].size)

    def apply(self, x, mask=None):
        from deeplearning4j_tpu_torch.nn.layers.recurrent import last_step
        return last_step(x, mask)


@register_serializable
@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertex):
    """(N, F) → (N, T, F), T from the second input (reference:
    rnn/DuplicateToTimeSeriesVertex)."""

    def output_type(self, *its):
        t = its[1].timesteps if len(its) > 1 and isinstance(
            its[1], RecurrentType) else None
        return RecurrentType(its[0].size, t)

    def apply(self, x, time_ref):
        return x[:, None, :].expand(x.shape[0], time_ref.shape[1],
                                    x.shape[-1])


@register_serializable
@dataclasses.dataclass(frozen=True)
class ReverseTimeSeriesVertex(GraphVertex):
    """(N, T, F) reversed along time (reference:
    rnn/ReverseTimeSeriesVertex)."""

    def output_type(self, *its):
        return its[0]

    def apply(self, x):
        return torch.flip(x, (1,))
