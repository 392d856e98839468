"""Pipeline parallelism: microbatched stage execution over the ``pipe`` axis.

The port of the JAX package's ``parallel/pipeline.py``. Each rank of the
``pipe`` axis holds R stages (``stacked_params`` with a leading dim R: its
block of the device-major stack ``stack_stage_params`` builds, or the
whole stack, of which it takes its block). A tick loop runs the schedule;
every tick each rank applies one stage to one microbatch (or idles
outside its wavefront) and hands the activation on with one paired send
and receive around the ring (``mesh.ppermute_chained``).

- **GPipe** (``repeats=1``): M microbatches through S stages, ``M + S -
  1`` ticks.
- **Circular** (``repeats=R > 1``, ``M == S``): rank d holds global
  stages d, S+d, 2S+d, …, and microbatches go around the ring R times,
  ``R*M + S - 1`` ticks.

In the JAX package the backward pipeline is the VJP of ``ppermute``. Here
each hop is an autograd Function whose backward is the reverse hop, and
each hop takes the previous hop's output as a token, so every rank's
backward runs its hops in exactly the reverse order of the forward: the
reverse schedule, with every backward send paired with its receive.
Every hop takes part in the backward (an idle tick sends zeros, the last
hop is tied to the output), so no rank waits on a hop another rank
skipped. The input is copied to the axis (its cotangent, nonzero at rank
0 only, is summed over the axis, so layers before the pipeline see the
same gradient on every rank) and the output, recorded at rank S-1, is
summed over the axis (identity backward): it is replicated.

``remat=True`` checkpoints each stage application
(``torch.utils.checkpoint``, recomputed in the backward). The
tensor-parallel split of a stage (3D) is opened inside the checkpointed
function, so the recomputation splits the same way.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.ops import tensor_split
from deeplearning4j_tpu_torch.ops.tensor_split import SplitSpec
from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves, tree_map
from deeplearning4j_tpu_torch.parallel.mesh import (Mesh, copy_to_axis,
                                                    gather_from_axis,
                                                    ppermute_chained,
                                                    reduce_from_axis)

PIPE_AXIS = "pipe"


def _device_major_order(n: int, num_devices: int) -> list:
    """The circular layout's stage storage order: position p holds
    global stage ``order[p]``, where device d's contiguous R-block
    carries global stages d, S+d, 2S+d, … (R = n // num_devices)."""
    if n % num_devices:
        raise ValueError(f"{n} stages not divisible over"
                         f" {num_devices} devices")
    r = n // num_devices
    return [rep * num_devices + d
            for d in range(num_devices) for rep in range(r)]


def _stack_trees(trees: Sequence[Any], order) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees], order)
                for k in first}
    return torch.stack([trees[i] for i in order], 0)


def stack_stage_params(params_per_stage: Sequence[Any],
                       num_devices: Optional[int] = None) -> Any:
    """Per-stage parameter trees (one structure) stacked into one tree
    with a leading ``num_stages`` dim; with ``num_devices`` and more
    stages than devices, in the circular layout's device-major order
    (device d's block holds global stages d, S+d, 2S+d, …)."""
    n = len(params_per_stage)
    order = (_device_major_order(n, num_devices)
             if num_devices and n > num_devices else list(range(n)))
    return _stack_trees(list(params_per_stage), order)


def restack_stages(stacked_params: Any, from_devices: int,
                   to_devices: int) -> Any:
    """The leading stage dim permuted from one circular layout's
    device-major order to another's (a checkpoint saved at pipeline size
    S1 restored onto S2)."""
    n = tree_leaves(stacked_params)[0].shape[0]
    src = _device_major_order(n, from_devices)
    dst = _device_major_order(n, to_devices)
    pos_of = {g: p for p, g in enumerate(src)}
    perm = [pos_of[g] for g in dst]
    return tree_map(lambda a: a[torch.as_tensor(perm, device=a.device)],
                    stacked_params)


def local_stages(stacked_params: Any, mesh: Mesh,
                 axis: str = PIPE_AXIS) -> Any:
    """This rank's block of a whole device-major stack."""
    ax = mesh.axis(axis)
    n = tree_leaves(stacked_params)[0].shape[0]
    r = n // ax.size
    return tree_map(lambda a: a[ax.index * r:(ax.index + 1) * r],
                    stacked_params)


class _Tie(torch.autograd.Function):
    """``y``, with ``t`` in its graph: the backward gives ``t`` a zero
    cotangent, so the hops that made ``t`` run their backward."""

    @staticmethod
    def forward(ctx, y, t):
        ctx.t_shape, ctx.t_dtype = t.shape, t.dtype
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        return dy, torch.zeros(ctx.t_shape, dtype=ctx.t_dtype,
                               device=dy.device)


def _microbatches(a: torch.Tensor, m: int) -> torch.Tensor:
    return a.reshape((m, a.shape[0] // m) + tuple(a.shape[1:]))


def pipeline_apply(stage_fn: Callable,
                   stacked_params: Any,
                   x: torch.Tensor,
                   mesh: Mesh,
                   *,
                   axis: str = PIPE_AXIS,
                   num_microbatches: Optional[int] = None,
                   consts: Any = None,
                   repeats: int = 1,
                   remat: bool = False,
                   split: Optional[SplitSpec] = None) -> torch.Tensor:
    """Run ``x`` through ``repeats * mesh[axis]`` stage applications
    pipelined over ``mesh[axis]``.

    stage_fn: ``(stage_params, activation (mb, ...)) -> activation`` or,
       with ``consts``, ``(stage_params, activation, consts_mb) ->
       activation``.
    stacked_params: this rank's R stages (leading dim ``repeats``), or
       the whole device-major stack (leading dim ``repeats * S``).
    x: (batch, ...) on every rank of the axis; split into
       ``num_microbatches`` (default S) equal microbatches along dim 0.
    consts: optional tree of per-example side inputs, leading dim
       ``batch`` (split like ``x``).
    repeats: R > 1 selects the circular schedule (``num_microbatches``
       must equal S).
    remat: checkpoint each stage application.
    split: the tensor-parallel split points a stage runs with (3D).

    Returns the composed stages applied to x, (batch, ...), the same on
    every rank of the axis."""
    ax = mesh.axis(axis)
    s_, d = ax.size, ax.index
    m = num_microbatches or s_
    if x.shape[0] % m != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible into {m}"
                         " microbatches")
    if repeats > 1 and m != s_:
        raise ValueError(
            f"circular schedule needs num_microbatches == num_stages"
            f" ({s_}); got {m} (injection would collide with"
            " recirculation)")
    r_ = repeats
    lead = tree_leaves(stacked_params)[0].shape[0]
    if lead == r_ * s_ and s_ > 1:
        stacked_params = local_stages(stacked_params, mesh, axis)
    elif lead != r_:
        raise ValueError(f"stacked_params hold {lead} stages: expected "
                         f"this rank's {r_} or all {r_ * s_}")
    takes_consts = consts is not None
    x_mb = _microbatches(copy_to_axis(x, ax), m)
    consts_mb = (tree_map(lambda a: _microbatches(a, m), consts)
                 if takes_consts else None)

    def run(p, xm, cst):
        with tensor_split.split(split):
            return stage_fn(p, xm, cst) if takes_consts else stage_fn(p, xm)

    def apply(p, xm, cst):
        if remat and torch.is_grad_enabled():
            return checkpoint(run, p, xm, cst, use_reentrant=False)
        return run(p, xm, cst)

    stages = [tree_map(lambda a, i=i: a[i], stacked_params)
              for i in range(r_)]
    mb_shape = tuple(x_mb.shape[1:])
    # the first hop's token: a leaf that asks for a gradient, so every
    # hop is in the backward graph on every rank, tied to the input's copy
    # to the axis, so that the copy's backward all-reduce runs after the
    # last backward hop on every rank (only rank 0 reads the input)
    recv = _Tie.apply(torch.zeros(mb_shape, dtype=x.dtype, device=x.device,
                                  requires_grad=torch.is_grad_enabled()),
                      x_mb)
    outs = [None] * m
    n_ticks = m * r_ + s_ - 1
    for t in range(n_ticks):
        k = t - d
        if 0 <= k < m * r_:
            mi = k % m
            x_in = x_mb[mi] if (d == 0 and t < m) else recv
            cst = (tree_map(lambda a: a[mi], consts_mb)
                   if takes_consts else None)
            y = apply(stages[min(k // s_, r_ - 1)], x_in, cst)
            if d == s_ - 1 and t >= (r_ - 1) * m + s_ - 1:
                outs[(t - (s_ - 1)) % m] = y
        else:
            y = torch.zeros(mb_shape, dtype=x.dtype, device=x.device)
        recv = ppermute_chained(y, recv, ax)
    if d == s_ - 1:
        out = torch.stack(outs)
    else:
        out = torch.zeros((m,) + mb_shape, dtype=x.dtype, device=x.device)
    if s_ > 1:
        out = _Tie.apply(reduce_from_axis(out, ax), recv)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))


class PipelinedTransformerLM:
    """Causal transformer LM: token embedding and learned positions
    (replicated), ``n_layers`` causal TransformerEncoderBlocks as the
    pipelined stages, then a final LayerNorm and the unembedding, outside
    the pipelined region. On a mesh with a ``model`` axis each stage runs
    Megatron-split (heads and FFN columns) and the head is split by
    vocabulary column, its logits gathered whole: the dp×tp×pp layout of
    ``param_shardings``. ``loss()`` with ``pipelined=False`` runs the
    sequential stack over the whole parameters in one process (the
    oracle)."""

    def __init__(self, vocab: int, width: int, n_heads: int, n_layers: int,
                 max_len: int, mesh: Mesh, *, axis: str = PIPE_AXIS,
                 ffn_mult: int = 4, num_microbatches: Optional[int] = None,
                 remat: bool = True, model_axis: str = "model"):
        from deeplearning4j_tpu_torch.nn.layers.attention import \
            TransformerEncoderBlock
        from deeplearning4j_tpu_torch.nn.layers.normalization import \
            LayerNormalization
        S = int(mesh.shape[axis])
        if n_layers % S:
            raise ValueError(f"n_layers={n_layers} not divisible by"
                             f" pipeline size {S}")
        self.vocab, self.width, self.max_len = vocab, width, max_len
        self.mesh, self.axis, self.model_axis = mesh, axis, model_axis
        self.repeats = n_layers // S
        self.num_microbatches = num_microbatches or S
        self.remat = remat
        self.n_layers = n_layers
        self.block = TransformerEncoderBlock(
            n_in=width, n_out=width, n_heads=n_heads, ffn_mult=ffn_mult,
            causal=True)
        self._ln_f = LayerNormalization()
        tp = int(mesh.shape.get(model_axis, 1))
        self._split = None
        if tp > 1:
            mx = mesh.axis(model_axis)
            self._split = SplitSpec(
                frozenset({"attn:col", "attn:row", "ffn:col", "ffn:row"}),
                lambda v: copy_to_axis(v, mx),
                lambda v: reduce_from_axis(v, mx),
                lambda v: gather_from_axis(v, mx, -1))

    def init(self, seed: int = 0, device=None) -> dict:
        """Whole parameters from a seed (the device-major stack), drawn on
        the CPU and moved to ``device`` (the card unless the caller passes
        ``"cpu"``)."""
        from deeplearning4j_tpu_torch.nn.inputs import RecurrentType
        from deeplearning4j_tpu_torch.utils.device import resolve_device
        device = resolve_device(device)
        g = torch.Generator().manual_seed(int(seed))
        rt = RecurrentType(self.width, None)
        S = int(self.mesh.shape[self.axis])
        per_stage = [self.block.initialize(g, rt)
                     for _ in range(self.n_layers)]
        p = {
            "embed": 0.02 * torch.randn((self.vocab, self.width),
                                        generator=g),
            "pos": 0.02 * torch.randn((self.max_len, self.width),
                                      generator=g),
            "blocks": stack_stage_params(per_stage, num_devices=S),
            "ln_f": self._ln_f.initialize(g, rt),
            "head": 0.02 * torch.randn((self.width, self.vocab),
                                       generator=g),
        }
        return tree_map(lambda a: a.to(device), p)

    def param_shardings(self, params=None, model_axis: Optional[str] = None):
        """Partition specs composing the stage dim with Megatron tensor
        parallelism (the JAX package's): Wqkv, W1 and their biases
        column-split, Wo and W2 row-split, everything of a block split by
        stage over the pipe axis; the head by vocabulary column. Without a
        model axis, stage-only."""
        model_axis = model_axis or self.model_axis
        has_tp = model_axis in self.mesh.shape
        ax = self.axis
        col3 = (ax, None, model_axis) if has_tp else (ax,)
        row3 = (ax, model_axis, None) if has_tp else (ax,)
        col2 = (ax, model_axis) if has_tp else (ax,)
        by_name = {"Wqkv": col3, "W1": col3, "bqkv": col2, "b1": col2,
                   "Wo": row3, "W2": row3}
        blocks = {"attn": {k: by_name.get(k, (ax,)) for k in
                           ("Wqkv", "Wo", "bqkv", "bo")},
                  "ln1": {"gamma": (ax,), "beta": (ax,)},
                  "ln2": {"gamma": (ax,), "beta": (ax,)},
                  "W1": col3, "b1": col2, "W2": row3, "b2": (ax,)}
        if params is not None:
            blocks = _prune(blocks, params["blocks"])
        return {"embed": (), "pos": (),
                "blocks": blocks,
                "ln_f": {"gamma": (), "beta": ()},
                "head": (None, model_axis) if has_tp else ()}

    def shard_params(self, params, model_axis: Optional[str] = None):
        """This rank's slices of whole ``params`` on the composed layout."""
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
            shard_tree
        return shard_tree(params, self.param_shardings(params, model_axis),
                          self.mesh)

    def _stage_fn(self):
        from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
        block = self.block

        def fn(p, h):
            y, _ = block.apply(p, {}, h, LayerContext(train=False))
            return y
        return fn

    def _trunk(self, params, tokens, pipelined: bool):
        from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
        x = params["embed"][tokens]
        x = x + params["pos"][: tokens.shape[1]][None]
        if pipelined:
            h = pipeline_apply(self._stage_fn(), params["blocks"], x,
                               self.mesh, axis=self.axis,
                               num_microbatches=self.num_microbatches,
                               repeats=self.repeats, remat=self.remat,
                               split=self._split)
        else:
            # device-major stack order: global stage r*S + d sits at
            # position d*R + r
            fn = self._stage_fn()
            S = int(self.mesh.shape[self.axis])
            h = x
            for r in range(self.repeats):
                for d in range(S):
                    h = fn(tree_map(lambda a: a[d * self.repeats + r],
                                    params["blocks"]), h)
        h, _ = self._ln_f.apply(params["ln_f"], {}, h,
                                LayerContext(train=False))
        return h

    def logits(self, params, tokens, *, pipelined: bool = True):
        h = self._trunk(params, tokens, pipelined)
        if pipelined and self._split is not None:
            # the head is split by vocabulary column: a column product
            return self._split.gather(self._split.copy_in(h)
                                      @ params["head"])
        return h @ params["head"]

    def loss(self, params, tokens, targets, *, pipelined: bool = True):
        """Mean next-token cross-entropy (of this rank's rows under a data
        axis); ``pipelined=False`` runs the sequential stack."""
        lg = self.logits(params, tokens, pipelined=pipelined)
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]).float(),
                               targets.reshape(-1))


def _prune(specs, params):
    """``specs`` restricted to the keys ``params`` has."""
    if isinstance(params, dict):
        return {k: _prune(specs.get(k, ()) if isinstance(specs, dict)
                          else specs, v) for k, v in params.items()}
    return specs
