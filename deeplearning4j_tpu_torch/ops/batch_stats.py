"""Batch statistics summed beyond this process's rows.

A BN layer in training normalizes by the statistics of its batch. Under
data parallelism over several processes (parallel/wrapper.py,
SHARED_GRADIENTS) that batch is the global one, so the layers' sums and
counts are summed over the process group. The layers ask this module:
inside ``summed(fn, world)``, which the wrapper opens around a step's
forward and backward (``parallel.mesh.global_batch_stats``),
``current()`` is a ``StatsSum``: ``fn`` sums a tensor over the ``world``
processes, and its backward sums the gradient in the same way. Outside,
``current()`` is None and the statistics are the local batch's.

The setting is a ``contextvars.ContextVar``: it holds only in the thread
(and context) that opened it, so another model trained or served on
another thread of the same process keeps its local statistics.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional

import torch


class StatsSum(NamedTuple):
    fn: Callable[[torch.Tensor], torch.Tensor]
    world: int


_SUM: contextvars.ContextVar = contextvars.ContextVar("batch_stats_sum",
                                                     default=None)


@contextmanager
def summed(fn: Callable[[torch.Tensor], torch.Tensor], world: int):
    """Inside, BN statistics are summed with ``fn`` over ``world``
    processes (local at one)."""
    token = _SUM.set(StatsSum(fn, int(world)) if world > 1 else None)
    try:
        yield
    finally:
        _SUM.reset(token)


def current() -> Optional[StatsSum]:
    """The open ``summed`` of this context, or None."""
    return _SUM.get()
