"""Parameter and batch placement for data parallelism.

The port of the JAX package's ``parallel/sharding.py``. With one process
per device, a data-parallel parameter is a full copy in every rank
(``infer_param_shardings`` gives ``"replicated"`` for every leaf), and a
global batch is split along its first axis in rank order, as a
``PartitionSpec("data")`` splits it over the JAX mesh
(``batch_shardings`` gives the rank its row range). ``apply_shardings``
has nothing to move and returns the tree as it is. The Megatron rules of
the JAX package (weights split over a ``model`` axis) belong to tensor
parallelism, the second half of ROADMAP.md item 15: a mesh with a
``model`` axis larger than 1 raises.
"""

from __future__ import annotations

from typing import Any, Optional

from deeplearning4j_tpu_torch.optimize.updaters import tree_map
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                    SECOND_HALF, Mesh, rank)

REPLICATED = "replicated"


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


def infer_param_shardings(params: Any, mesh: Mesh,
                          model_axis: str = MODEL_AXIS) -> Any:
    """A tree of ``"replicated"`` matching ``params``."""
    if int(mesh.shape.get(model_axis, 1)) > 1:
        raise NotImplementedError(f"parameter sharding over the "
                                  f"{model_axis!r} axis: {SECOND_HALF}")
    return tree_map(lambda _: REPLICATED, params)


def batch_shardings(mesh: Mesh, axis: str = DATA_AXIS,
                    index: Optional[int] = None) -> BatchSharding:
    """This rank's (or rank ``index``'s) share of a batch split over the
    mesh's ``axis``."""
    return BatchSharding(rank() if index is None else index,
                         int(mesh.shape[axis]))


def apply_shardings(tree: Any, shardings: Any) -> Any:
    """Data-parallel leaves are whole in every rank: nothing moves."""
    return tree
