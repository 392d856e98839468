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
- ``create_3d_mesh(dp, tp, pp)`` is the ``(data, model, pipe)`` mesh of
  composed parallelism, the pipe axis varying fastest, as in the JAX
  package.
- ``compat_shard_map`` has no counterpart: a rank runs its own part of
  the step in its own process, so there is no per-device function to
  map.

The JAX package leaves its collectives to GSPMD and ``shard_map``; the
port issues every one itself, and every one goes through this module
(``count_calls`` counts them by kind):

- ``all_reduce_`` (in place), ``all_gather``, ``all_to_all`` and
  ``ppermute`` (paired sends and receives around a ring, one
  ``batch_isend_irecv``), each over the whole group or over one axis of
  a mesh (``Mesh.axis(name)``: the ranks that differ from this one only
  along that axis, one ``dist.new_group`` each, made for every axis when
  the mesh is made, in the same order on every rank).
- NCCL takes a tensor where it lies; gloo takes CUDA tensors through host
  copies, explicitly, and its all-to-all is paired sends and receives
  (gloo has no alltoall in every build) (several ranks on one card cannot use NCCL, which
  refuses two ranks on one device, so they use gloo on the card's
  tensors).
- The autograd Functions of Megatron tensor parallelism and of the
  sequence, pipeline and expert schedules: ``copy_to_axis`` (identity,
  all-reduce backward), ``reduce_from_axis`` (all-reduce, identity
  backward), ``gather_from_axis`` (all-gather, own slice backward),
  ``gather_sum_from_axis`` (all-gather; the backward sums over the axis,
  then takes its own slice), ``all_to_all_chunks`` (the reverse
  all-to-all backward) and ``ppermute_chained`` (the reverse ring
  backward; a token ties each hop to the one before it, so the autograd
  engine runs every rank's backward hops in the same order and each
  backward send meets its receive).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops import batch_stats

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"



# the group of an axis of one rank: every collective over it is the
# identity (None would mean the whole group)
SOLO = "solo"


class Axis:
    """One axis of a mesh as this rank sees it: ``size`` ranks, this
    rank's ``index`` along it, their global ``ranks`` in axis order and
    the process group over them (None: the whole group; ``SOLO`` at size
    1, where every collective is the identity)."""

    def __init__(self, name: str, ranks: Sequence[int], index: int, group):
        self.name = name
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = int(index)
        self.group = group

    def __repr__(self):
        return f"Axis({self.name!r}, {self.index} of {self.size})"


# process groups by their ranks: every rank makes the same groups in the
# same order, so a group made once is reused by later meshes
_GROUPS: Dict[tuple, object] = {}


def _group_of(ranks: tuple):
    if not is_distributed() or len(ranks) == dist.get_world_size():
        return None
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


class Mesh:
    """Named axes over ranks: ``devices`` is an array of ranks shaped by
    the axis sizes, ``shape`` maps each axis name to its size.
    ``axis(name)`` is this rank's view of one axis (its index and its
    process group); a rank outside the mesh has none."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))
        self._axes: Dict[str, Axis] = {}
        me = rank()
        where = np.argwhere(devices == me) if devices.size else []
        coords = tuple(int(c) for c in where[0]) if len(where) else None
        # every rank makes every subgroup of every axis, in axis order
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(devices, i, -1).reshape(-1, devices.shape[i])
            for line in lines:
                ranks = tuple(int(r) for r in line)
                group = _group_of(ranks) if len(ranks) > 1 else SOLO
                if coords is not None and me in ranks:
                    self._axes[name] = Axis(name, ranks, ranks.index(me),
                                            group)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis(self, name: str) -> Axis:
        """This rank's view of ``name`` (size 1 for an axis the mesh does
        not have)."""
        if name not in self.shape:
            return Axis(name, (rank(),), 0, SOLO)
        return self._axes[name]

    def index(self, name: str) -> int:
        return self.axis(name).index

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
    """dp×tp×pp mesh with the canonical axis order ``(data, model,
    pipe)``, the layout ``PipelinedTransformerLM.param_shardings``
    expects. Ranks go in the order of ``devices`` (default: the group's
    ranks), so the pipe axis varies fastest: stage-major placement,
    matching the device-major stage stacking of ``restack_stages``."""
    return create_mesh({DATA_AXIS: dp, MODEL_AXIS: tp, PIPE_AXIS: pp},
                       devices)


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
        _GROUPS.clear()
        dist.destroy_process_group()


_CALLS = [None]


@contextmanager
def count_calls():
    """Inside, the collectives of this module are counted into the
    yielded dict by kind (``all_reduce``, ``all_gather``, ``all_to_all``,
    ``ppermute``), with or without a process group. The census names the
    messages, not their bytes."""
    calls: Dict[str, int] = {}
    prev = _CALLS[0]
    _CALLS[0] = calls
    try:
        yield calls
    finally:
        _CALLS[0] = prev


def _note(kind: str):
    if _CALLS[0] is not None:
        _CALLS[0][kind] = _CALLS[0].get(kind, 0) + 1


def _host(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through a host copy: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _group_size(group) -> int:
    if not is_distributed() or group == SOLO:
        return 1
    return dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, op=None, group=None) -> torch.Tensor:
    """``t`` reduced in place over the group (``op`` default SUM) and
    returned. gloo takes a CUDA tensor through a host copy; NCCL and
    CPU tensors go as they are. Without a group, ``t`` as it is."""
    _note("all_reduce")
    if not is_distributed() or group == SOLO:
        return t
    op = dist.ReduceOp.SUM if op is None else op
    if _host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    rank order; ``t`` itself at size 1."""
    _note("all_gather")
    n = _group_size(group)
    if n == 1:
        return t
    src = t.contiguous()
    via = src.cpu() if _host(src, group) else src
    parts = [torch.empty_like(via) for _ in range(n)]
    dist.all_gather(parts, via, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_to_all(chunks: Sequence[torch.Tensor], group=None
               ) -> List[torch.Tensor]:
    """Chunk ``j`` to the group's rank ``j``; returns the chunks received,
    by source rank (each shaped as the chunk this rank sent it)."""
    _note("all_to_all")
    n = _group_size(group)
    if n == 1:
        return [chunks[0]]
    if len(chunks) != n:
        raise ValueError(f"all_to_all: {len(chunks)} chunks for a group of "
                         f"{n}")
    dev = chunks[0].device
    host = _host(chunks[0], group)
    send = [c.contiguous().cpu() if host else c.contiguous()
            for c in chunks]
    recv = [torch.empty_like(c) for c in send]
    if dist.get_backend(group) == "gloo":
        # gloo has no alltoall in every build: paired sends and receives,
        # one batch_isend_irecv
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(dist.get_world_size())))
        me = ranks.index(dist.get_rank())
        recv[me] = send[me].clone()
        ops = []
        for j, peer in enumerate(ranks):
            if j != me:
                ops.append(dist.P2POp(dist.isend, send[j], peer, group=group))
                ops.append(dist.P2POp(dist.irecv, recv[j], peer,
                                      group=group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    else:
        dist.all_to_all(recv, send, group=group)
    return [r.to(dev) for r in recv] if host else recv


def ppermute(t: torch.Tensor, axis: Axis, shift: int = 1) -> torch.Tensor:
    """Each rank of ``axis`` sends ``t`` to the rank ``shift`` places on
    around the ring and returns what the rank ``shift`` places back sent
    (``lax.ppermute`` with ``(i, (i + shift) % n)``): one paired send
    and receive."""
    _note("ppermute")
    n = axis.size
    if n == 1 or shift % n == 0:
        return t
    src = t.contiguous()
    host = _host(src, axis.group)
    via = src.cpu() if host else src
    out = torch.empty_like(via)
    to = axis.ranks[(axis.index + shift) % n]
    frm = axis.ranks[(axis.index - shift) % n]
    ops = [dist.P2POp(dist.isend, via, to, group=axis.group),
           dist.P2POp(dist.irecv, out, frm, group=axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if host else out


# ---- the autograd Functions of the schedules ---------------------------------


class _CopyToAxis(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the axis (the input
    of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(), group=ctx.group), None


class _ReduceFromAxis(torch.autograd.Function):
    """Sum over the axis; identity backward (the output of a row-parallel
    product, or a value one rank of the axis holds)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group=group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromAxis(torch.autograd.Function):
    """All-gather along ``dim``; the backward takes this rank's slice of
    the cotangent (summed over the axis first when ``summed``: the
    gathered value's consumers differ between ranks)."""

    @staticmethod
    def forward(ctx, x, axis, dim, summed):
        ctx.axis, ctx.dim, ctx.summed = axis, dim, summed
        ctx.width = x.shape[dim]
        return all_gather(x, dim, axis.group)

    @staticmethod
    def backward(ctx, dy):
        if ctx.summed:
            dy = all_reduce_(dy.contiguous().clone(), group=ctx.axis.group)
        i = ctx.axis.index
        return (dy.narrow(ctx.dim, i * ctx.width, ctx.width).contiguous(),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of a chunk list; the backward sends each chunk's
    cotangent back to where the chunk came from."""

    @staticmethod
    def forward(ctx, group, *chunks):
        ctx.group = group
        return tuple(all_to_all(chunks, group))

    @staticmethod
    def backward(ctx, *dys):
        return (None,) + tuple(all_to_all(
            [d.contiguous() for d in dys], ctx.group))


class _Ppermute(torch.autograd.Function):
    """``ppermute`` of ``x`` with a token: the previous hop's output. The
    token is not read; it orders the hops, so that on every rank the
    autograd engine runs hop k's backward (the reverse ring, itself a
    paired send and receive) only after hop k + 1's."""

    @staticmethod
    def forward(ctx, x, token, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        ctx.token_shape = token.shape
        return ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, dy):
        dx = ppermute(dy, ctx.axis, -ctx.shift)
        return dx, torch.zeros(ctx.token_shape, dtype=dy.dtype,
                               device=dy.device), None, None


def copy_to_axis(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyToAxis.apply(x, axis.group)


def reduce_from_axis(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFromAxis.apply(x, axis.group)


def gather_from_axis(x: torch.Tensor, axis: Axis, dim: int = -1
                     ) -> torch.Tensor:
    """All-gather along ``dim`` for consumers that are the same on every
    rank of the axis (the backward takes this rank's slice)."""
    if axis.size == 1:
        return x
    return _GatherFromAxis.apply(x, axis, dim % x.dim(), False)


def gather_sum_from_axis(x: torch.Tensor, axis: Axis, dim: int = 0
                         ) -> torch.Tensor:
    """All-gather along ``dim`` for consumers that differ between ranks
    (each rank's loss uses other rows): the backward sums the cotangent
    over the axis, then takes this rank's slice."""
    if axis.size == 1:
        return x
    return _GatherFromAxis.apply(x, axis, dim % x.dim(), True)


def all_to_all_chunks(chunks: Sequence[torch.Tensor], axis: Axis
                      ) -> List[torch.Tensor]:
    """Differentiable ``all_to_all`` over ``axis``."""
    if axis.size == 1:
        return list(chunks)
    return list(_AllToAll.apply(axis.group, *chunks))


def ppermute_chained(x: torch.Tensor, token: torch.Tensor, axis: Axis,
                     shift: int = 1) -> torch.Tensor:
    """Differentiable ``ppermute`` over ``axis`` ordered after ``token``
    (the previous hop's output: pass ``x`` itself at the first hop)."""
    if axis.size == 1:
        return x
    return _Ppermute.apply(x, token, axis, shift)


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
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group=group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(), group=ctx.group), None


@contextmanager
def global_batch_stats(world: int, group=None):
    """Inside (in this thread), BN statistics are summed over ``world``
    ranks (nothing changes at one rank): the whole group, or ``group``
    (a mesh's data axis)."""
    with batch_stats.summed(lambda x: _GroupSum.apply(x, group), world):
        yield
