"""Graph vertices — DAG combinators for ComputationGraph.

The JAX package's ``GraphVertex`` contract and its ``ElementWiseVertex``
(reference: nn/conf/graph/ElementWiseVertex). A vertex is a stateless
function over its input tensors; the other vertices wait for a slice
whose model uses them.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.utils.serde import register_serializable


class GraphVertex:
    def output_type(self, *input_types: InputType) -> InputType:
        raise NotImplementedError

    def apply(self, *xs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


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
