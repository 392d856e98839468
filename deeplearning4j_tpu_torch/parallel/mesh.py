"""The device mesh and the process group under it.

The port of the JAX package's ``parallel/mesh.py``. There one process
drives every device and a ``jax.sharding.Mesh`` names the axes; here,
in PyTorch's idiom, each device has a process of its own, joined in one
``torch.distributed`` process group (NCCL serves the card, gloo the
CPU), and a ``Mesh`` names the axes over the group's ranks. The size of
the ``data`` axis is the number of data-parallel workers, which is the
world size.

- ``initialize_distributed`` joins the group with everything explicit:
  the backend, the rendezvous (a ``FileStore`` path or an
  ``init_method`` such as ``tcp://localhost:<port>``), the rank, the
  world size and a ``timeout``, so a hung collective raises instead of
  waiting forever.
- ``create_mesh`` keeps the JAX package's axis arithmetic and its
  ``ValueError``s; its devices default to the group's ranks (one rank,
  0, without a group).
- ``create_3d_mesh`` (tensor and pipeline axes) raises: tensor and
  pipeline parallelism are the second half of ROADMAP.md item 15.
- ``compat_shard_map`` has no counterpart: a rank runs its own part of
  the step in its own process, so there is no per-device function to
  map.

The collectives the port issues go through ``all_reduce_``: NCCL takes
the tensor where it lies; gloo takes CUDA tensors through host copies,
explicitly (several ranks on one card cannot use NCCL, which refuses two
ranks on one device, so they use gloo on the card's tensors).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from datetime import timedelta
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops import batch_stats

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"

SECOND_HALF = ("tensor and pipeline parallelism (ROADMAP.md item 15, its "
               "second half) are not ported yet")


class Mesh:
    """Named axes over ranks: ``devices`` is an array of ranks shaped by
    the axis sizes, ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape})"


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def create_mesh(axes: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh. Default: every rank on the data axis.

    ``axes`` values may include one -1 entry meaning "everything left",
    e.g. {"data": -1, "model": 4}.
    """
    devices = list(devices if devices is not None
                   else range(world_size()))
    n = len(devices)
    if not axes:
        axes = {DATA_AXIS: n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[sizes.index(-1)] = n // fixed
    total = math.prod(sizes)
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total}"
                         f" devices, have {n}")
    return Mesh(np.asarray(devices, dtype=object).reshape(sizes), names)


def create_3d_mesh(dp: int, tp: int, pp: int,
                   devices: Optional[Sequence] = None) -> Mesh:
    """The dp×tp×pp mesh of composed parallelism: not ported."""
    raise NotImplementedError(f"create_3d_mesh: {SECOND_HALF}")


def local_device_count() -> int:
    """Devices this process drives: one (one process per device)."""
    return 1


def initialize_distributed(backend: str, rank: int, world_size: int, *,
                           store_path: Optional[str] = None,
                           init_method: Optional[str] = None,
                           timeout_s: float = 120.0,
                           device: Optional[torch.device] = None):
    """Join the process group (the JAX package's
    ``jax.distributed.initialize``). ``backend`` is ``"nccl"`` (one rank
    per card) or ``"gloo"`` (the CPU, or several ranks on one card);
    exactly one of ``store_path`` (a ``FileStore`` file every rank
    names) and ``init_method`` gives the rendezvous. ``timeout_s``
    bounds every collective of the group. ``device`` (NCCL) is the
    card this rank drives."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if (store_path is None) == (init_method is None):
        raise ValueError("give exactly one of store_path and init_method")
    kw = dict(backend=backend, rank=int(rank), world_size=int(world_size),
              timeout=timedelta(seconds=float(timeout_s)))
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, int(world_size))
    else:
        kw["init_method"] = init_method
    if backend == "nccl" and device is not None:
        device = torch.device(device)
        torch.cuda.set_device(device if device.index is not None
                              else torch.cuda.current_device())
    dist.init_process_group(**kw)


def shutdown_distributed():
    """Leave the process group (no-op without one)."""
    if is_distributed():
        dist.destroy_process_group()


_CALLS = [None]


@contextmanager
def count_calls():
    """Inside, ``all_reduce_`` calls are counted into the yielded dict
    (``{"all_reduce": n}``), with or without a process group."""
    calls: Dict[str, int] = {}
    prev = _CALLS[0]
    _CALLS[0] = calls
    try:
        yield calls
    finally:
        _CALLS[0] = prev


def all_reduce_(t: torch.Tensor, op=None) -> torch.Tensor:
    """``t`` reduced in place over the group (``op`` default SUM) and
    returned. gloo takes a CUDA tensor through a host copy; NCCL and
    CPU tensors go as they are. Without a group, ``t`` as it is."""
    if _CALLS[0] is not None:
        _CALLS[0]["all_reduce"] = _CALLS[0].get("all_reduce", 0) + 1
    if not is_distributed():
        return t
    op = dist.ReduceOp.SUM if op is None else op
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op)
    return t


def barrier():
    """Every rank reaches this point before any leaves it."""
    if is_distributed():
        t = torch.zeros((1,), dtype=torch.float64, device=_group_device())
        all_reduce_(t)


def _group_device() -> torch.device:
    """Where the group's own small tensors live: the card under NCCL,
    the CPU under gloo."""
    if is_distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_device_value_range(value: float) -> tuple:
    """(min, max) of a per-process scalar over every rank. Every rank
    must call it: it doubles as a barrier."""
    dev = _group_device()
    lo = torch.full((1,), float(value), dtype=torch.float64, device=dev)
    hi = lo.clone()
    all_reduce_(lo, dist.ReduceOp.MIN if is_distributed() else None)
    all_reduce_(hi, dist.ReduceOp.MAX if is_distributed() else None)
    return float(lo.item()), float(hi.item())


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS):
    """Leading-dim (batch) split over ``axis``: this rank's rows."""
    from deeplearning4j_tpu_torch.parallel.sharding import batch_shardings
    return batch_shardings(mesh, axis=axis)


def replicated(mesh: Mesh) -> str:
    from deeplearning4j_tpu_torch.parallel.sharding import REPLICATED
    return REPLICATED


# ---- global batch statistics (SHARED_GRADIENTS over several ranks) --------
#
# Under SHARED_GRADIENTS the step is the step on the global batch, as the
# JAX package's jit over a sharded batch computes it: every batch
# statistic is the global one. While ``global_batch_stats(world)`` is
# open, the BN layers (nn/layers/normalization.py, the fused block's
# nn/layers/fused.py) sum their statistics over the group through
# ``ops.batch_stats``, with ``_GroupSum``, whose backward sums the
# statistics' gradients over the group in the same way.


class _GroupSum(torch.autograd.Function):
    """y = Σ over ranks of x; the backward is the same sum of dy."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone())


@contextmanager
def global_batch_stats(world: int):
    """Inside (in this thread), BN statistics are summed over ``world``
    ranks (nothing changes at one rank)."""
    with batch_stats.summed(_GroupSum.apply, world):
        yield
