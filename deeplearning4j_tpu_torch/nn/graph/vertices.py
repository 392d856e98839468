"""Graph vertices — DAG combinators for ComputationGraph.

The JAX package's ``GraphVertex`` contract and its vertex set (reference:
nn/conf/graph/, nn/conf/graph/rnn/): ``MergeVertex``,
``ElementWiseVertex``, ``StackVertex``/``UnstackVertex``,
``SubsetVertex``, ``ScaleVertex``, ``ShiftVertex``, ``L2NormalizeVertex``,
``L2Vertex``, ``ReshapeVertex``, ``PreprocessorVertex`` and the three
recurrent vertices. A vertex is a stateless function over its input
tensors; the graph hands ``LastTimeStepVertex`` the sequence mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.inputs import (ConvolutionalType,
                                                FeedForwardType, InputType,
                                                RecurrentType)
from deeplearning4j_tpu_torch.nn.preprocessors import Preprocessor
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
class StackVertex(GraphVertex):
    """Stack along the batch axis (reference: StackVertex)."""

    def output_type(self, *its):
        return its[0]

    def apply(self, *xs):
        return torch.cat(xs, dim=0)


@register_serializable
@dataclasses.dataclass(frozen=True)
class UnstackVertex(GraphVertex):
    """Rows [i·N/k, (i+1)·N/k) of a batch stacked from k (reference:
    UnstackVertex)."""
    from_index: int = 0
    stack_size: int = 1

    def output_type(self, *its):
        return its[0]

    def apply(self, x):
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step]


@register_serializable
@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertex):
    """Feature-axis slice [from, to], both ends included (reference:
    SubsetVertex)."""
    from_index: int = 0
    to_index: int = 0

    def output_type(self, *its):
        n = self.to_index - self.from_index + 1
        it = its[0]
        if isinstance(it, RecurrentType):
            return RecurrentType(n, it.timesteps)
        if isinstance(it, ConvolutionalType):
            return ConvolutionalType(it.height, it.width, n)
        return FeedForwardType(n)

    def apply(self, x):
        return x[..., self.from_index:self.to_index + 1]


@register_serializable
@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def output_type(self, *its):
        return its[0]

    def apply(self, x):
        return x * self.scale


@register_serializable
@dataclasses.dataclass(frozen=True)
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def output_type(self, *its):
        return its[0]

    def apply(self, x):
        return x + self.shift


@register_serializable
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(GraphVertex):
    """x / (||x|| + eps), the norm over every axis but the batch axis."""
    eps: float = 1e-8

    def output_type(self, *its):
        return its[0]

    def apply(self, x):
        norm = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)
        return x / (norm.reshape((-1,) + (1,) * (x.ndim - 1)) + self.eps)


@register_serializable
@dataclasses.dataclass(frozen=True)
class L2Vertex(GraphVertex):
    """Pairwise L2 distance of two inputs, sqrt(Σ (a - b)² + eps), as
    (N, 1)."""
    eps: float = 1e-8

    def output_type(self, *its):
        return FeedForwardType(1)

    def apply(self, a, b):
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + self.eps)


@register_serializable
@dataclasses.dataclass(frozen=True)
class ReshapeVertex(GraphVertex):
    """Reshape the trailing dims (the batch axis kept): 1 → feed-forward,
    2 → (T, F) recurrent, 3 → NHWC."""
    shape: Tuple[int, ...] = ()

    def output_type(self, *its):
        s = self.shape
        if len(s) == 1:
            return FeedForwardType(s[0])
        if len(s) == 2:
            return RecurrentType(s[1], s[0])
        if len(s) == 3:
            return ConvolutionalType(s[0], s[1], s[2])
        raise ValueError(f"unsupported reshape arity: {s}")

    def apply(self, x):
        return x.reshape((x.shape[0],) + tuple(self.shape))


@register_serializable
@dataclasses.dataclass(frozen=True)
class PreprocessorVertex(GraphVertex):
    """A preprocessor as a graph node (reference: PreprocessorVertex)."""
    preprocessor: Optional[Preprocessor] = None

    def output_type(self, *its):
        return self.preprocessor.output_type(its[0])

    def apply(self, x):
        return self.preprocessor.apply(x)


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
