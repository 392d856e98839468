"""Layers split over the ranks of a tensor-parallel axis.

Under Megatron tensor parallelism (parallel/tensor_parallel.py) each rank
of the ``model`` axis holds a slice of a layer's weights: the columns of a
column-parallel product (whole heads of a packed QKV projection, a slice
of an FFN's hidden units, of an LSTM's hidden units with their four
gates, of a convolution's output channels) or the rows of a row-parallel
one. The layers run the same code on their slices and ask this module at
four points, each named by a *part* of the layer:

- ``gather_in(x, part)``: an activation sharded on its last dimension
  made whole (a convolution that contracts over every input channel; its
  ``copy_in`` follows);
- ``copy_in(x, part)``: the input of a column-parallel product (identity;
  its backward sums the cotangent over the axis);
- ``reduce_out(y, part)``: the partial output of a row-parallel product
  summed over the axis, before its bias;
- ``gather_out(y, part)``: a column-parallel output made whole (the
  logits of a class-sharded output layer).

Inside ``split(spec)``, which the model's forward opens around one
layer's ``apply`` for the parts the plan shards, each point runs the
spec's function for its part; outside, and for parts the spec does not
name, each is the identity, so a layer outside a plan runs as before.
The setting is a ``contextvars.ContextVar``: it holds only in the thread
that opened it. The layers never import ``parallel/``.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Callable, FrozenSet, NamedTuple, Optional

import torch


class SplitSpec(NamedTuple):
    parts: FrozenSet[str]
    copy_in: Callable[[torch.Tensor], torch.Tensor]
    reduce_out: Callable[[torch.Tensor], torch.Tensor]
    gather: Callable[[torch.Tensor], torch.Tensor]   # along the last dim


_SPEC: contextvars.ContextVar = contextvars.ContextVar("tensor_split",
                                                      default=None)


@contextmanager
def split(spec: Optional[SplitSpec]):
    """Inside, the layers' split points run ``spec`` (None: identity)."""
    token = _SPEC.set(spec)
    try:
        yield
    finally:
        _SPEC.reset(token)


def current() -> Optional[SplitSpec]:
    return _SPEC.get()


def active(part: str) -> bool:
    s = _SPEC.get()
    return s is not None and part in s.parts


def _at(part: str):
    s = _SPEC.get()
    return s if s is not None and part in s.parts else None


def gather_in(x: torch.Tensor, part: str) -> torch.Tensor:
    s = _at(part + ":gather_in")
    return x if s is None else s.gather(x)


def copy_in(x: torch.Tensor, part: str) -> torch.Tensor:
    s = _at(part + ":col")
    return x if s is None else s.copy_in(x)


def reduce_out(y: torch.Tensor, part: str) -> torch.Tensor:
    s = _at(part + ":row")
    return y if s is None else s.reduce_out(y)


def gather_out(y: torch.Tensor, part: str) -> torch.Tensor:
    s = _at(part + ":gather_out")
    return y if s is None else s.gather(y)
