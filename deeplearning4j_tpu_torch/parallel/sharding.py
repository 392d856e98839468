"""Parameter and batch placement.

The port of the JAX package's ``parallel/sharding.py``. With one process
per device a placement is a partition spec: a tuple naming, for each
dimension of a leaf, the mesh axis it is split over (None: whole), as
the JAX package's ``PartitionSpec``; ``()`` (``REPLICATED``) is a full
copy in every rank. A global batch is split along its first axis in the
order of the ``data`` axis, as a ``PartitionSpec("data")`` splits it
over the JAX mesh (``batch_shardings`` gives the rank its row range).

``infer_param_shardings`` keeps the JAX package's round-1 column rules
over the ``model`` axis (the output columns of dense, conv and recurrent
weights, where they divide). The paired Megatron plan is
``parallel/tensor_parallel.plan_tp``, and ``tensor_parallel.shard_tree``
gives a rank its slice of each leaf under a spec tree.
"""

from __future__ import annotations

from typing import Any, Optional

from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                    Mesh)

REPLICATED = ()


class BatchSharding:
    """Rank ``index`` of ``parts``' share of a batch's first axis: rows
    ``[index * n // parts, (index + 1) * n // parts)`` of ``n`` (``n``
    a multiple of ``parts``; the wrapper pads to one)."""

    def __init__(self, index: int, parts: int):
        self.index = int(index)
        self.parts = int(parts)

    def rows(self, n: int) -> slice:
        if n % self.parts:
            raise ValueError(f"a batch of {n} rows does not split evenly "
                             f"over {self.parts} workers")
        per = n // self.parts
        return slice(self.index * per, (self.index + 1) * per)

    def __repr__(self):
        return f"BatchSharding({self.index} of {self.parts})"


def _rule(key: str, shape: tuple, m: int, model_axis: str,
          fallback: bool) -> tuple:
    if m <= 1 or not shape or shape[-1] % m:
        return REPLICATED
    n = len(shape)
    if fallback:
        split = ((key in ("W", "dW") and n == 4)
                 or (key in ("Wx", "Wh", "pW") and n == 2))
    else:
        split = ((key in ("W", "pW") and n >= 2) or (key == "dW" and n == 4)
                 or (key in ("Wx", "Wh") and n == 2))
    return (None,) * (n - 1) + (model_axis,) if split else REPLICATED


def infer_param_shardings(params: Any, mesh: Mesh,
                          model_axis: str = MODEL_AXIS, *,
                          fallback: bool = False) -> Any:
    """A tree of partition specs matching ``params`` (the JAX package's
    round-1 rules; all ``REPLICATED`` without a ``model`` axis).
    ``fallback=True`` gives instead the JAX tensor-parallel plan's
    column rule for layers it has no pairing rule for, which splits only
    4-D ``W``/``dW`` and 2-D ``Wx``/``Wh``/``pW``."""
    m = int(mesh.shape.get(model_axis, 1))

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, str(k)) for k, v in node.items()}
        return _rule(key, tuple(getattr(node, "shape", ())), m, model_axis,
                     fallback)
    return walk(params)


def batch_shardings(mesh: Mesh, axis: str = DATA_AXIS,
                    index: Optional[int] = None) -> BatchSharding:
    """This rank's (or the ``index``-th) share of a batch split over the
    mesh's ``axis``."""
    return BatchSharding(mesh.index(axis) if index is None else index,
                         int(mesh.shape[axis]))


def apply_shardings(tree: Any, shardings: Any) -> Any:
    """Data-parallel leaves are whole in every rank: nothing moves (split
    leaves: ``tensor_parallel.shard_tree``)."""
    return tree
