"""Fused conv+BN kernels for ResNet bottleneck blocks, forward and backward.

The port of the JAX package's ``ops/fused_conv.py``. Two fusions per conv
layer ride the one pass the conv already pays:

  * prologue: the normalize+ReLU of the PRODUCER's BatchNorm (a per-channel
    scale+shift once the statistics are known) is applied to the input
    tile right after it is loaded, rounded to the input dtype, so the
    normalized activation never exists in device memory;
  * epilogue: per-channel (Σy, Σy²) of the conv output are taken from the
    f32 accumulator while the output tile is still on chip, so a BN
    statistics pass never re-reads y.

The backward recomputes the normalized input tile-wise (it was never
stored), folds the statistics cotangent into dy
(``dyc = dy + dΣ + 2·y·dΣ²``, rounded to dy's dtype) and runs the
BN/ReLU backward (mask, Σdpre·x, Σdpre, the input rescale) in the
bwd-input product's epilogue.

Six hand-written CUDA kernels (``csrc/``, sm_90a) do the work on the card:
``fused_mm`` / ``fused_c3`` (forward, 1×1 and 3×3; in bf16 both multiply on
the tensor cores, K cut into the slices of ``mm_slices`` / by K alone) and
``fused_mm_bwd`` (1×1 dx, dW and the BN sums in one call; bf16 on the
tensor cores, cut and laid out by ``mm_bwd_plan``), ``fused_c3_bwd`` (the
same for the 3×3; ``c3_bwd_plan``), ``fused_c3_bwd_in`` +
``fused_c3_bwd_w`` (the 3×3 work as two calls; ``fused_c3_bwd_in`` splits
its 9·Cout depth into the slices of ``dx_slices`` and multiplies bf16 on
the tensor cores).
Beside each is its plain PyTorch version (``*_reference``): the wrappers
use it for a tensor on the CPU and only there. A CUDA tensor launches the
kernel or raises; nothing falls back.

Each wrapper counts its launches in ``LAUNCHES`` (a plain integer per
kernel, incremented once per launch and nowhere else), so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import cuda_build

LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "fused_mm", "fused_c3", "fused_mm_bwd", "fused_c3_bwd", "fused_c3_bwd_in",
    "fused_c3_bwd_w")}
_launch_lock = threading.Lock()


def reset_launch_counts():
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str):
    with _launch_lock:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def _norm_in(x, scale, shift, relu_in: bool, norm_in: bool):
    """relu?(x·scale + shift) in f32, rounded back to x's dtype."""
    if not norm_in:
        return x
    e = x.float() * scale + shift
    if relu_in:
        e = torch.relu(e)
    return e.to(x.dtype)


def _stats(y32: torch.Tensor) -> torch.Tensor:
    """(2, C) f32 (Σy, Σy²) over every axis but the last."""
    flat = y32.reshape(-1, y32.shape[-1])
    return torch.stack([flat.sum(0), (flat * flat).sum(0)])


def fused_mm_reference(x, w, scale, shift, relu_in: bool = True,
                       norm_in: bool = True, stride: int = 1,
                       want_stats: bool = True):
    """1×1 conv: y = relu?(x·s+b)[::stride] @ W in f32, stored in x's
    dtype, with f32 (Σy, Σy²) of the accumulator (None unless
    ``want_stats``)."""
    e = _norm_in(x, scale, shift, relu_in, norm_in)
    if stride != 1:
        e = e[:, ::stride, ::stride, :]
    y = torch.matmul(e.float(), w.float())
    return y.to(x.dtype), (_stats(y) if want_stats else None)


def _taps(plane, h, wd):
    """The 9 shifted (N, H, W, C) views of a zero-padded plane, tap-major."""
    return [plane[:, di:di + h, dj:dj + wd, :]
            for di in range(3) for dj in range(3)]


def fused_c3_reference(x, w, scale, shift, relu_in: bool = True,
                       norm_in: bool = True, want_stats: bool = True):
    """3×3 SAME stride-1 conv as 9 shifted matmuls on the normalized,
    THEN zero-padded input (a border of relu(0·s+b) would be wrong)."""
    e = _norm_in(x, scale, shift, relu_in, norm_in).float()
    n, h, wd, cin = e.shape
    ep = F.pad(e, (0, 0, 1, 1, 1, 1))
    wf = w.float().reshape(9, cin, -1)
    acc = torch.zeros((n * h * wd, w.shape[3]), dtype=torch.float32,
                      device=x.device)
    for t, tap in enumerate(_taps(ep, h, wd)):
        acc = acc + tap.reshape(-1, cin) @ wf[t]
    y = acc.reshape(n, h, wd, -1)
    return y.to(x.dtype), (_stats(acc) if want_stats else None)


def _conv_reference(x, w, scale, shift, relu_in, norm_in, stride,
                    want_stats=True):
    """The plain version of ``fused_conv_bn_act``'s forward (either
    kernel)."""
    if w.ndim == 2:
        return fused_mm_reference(x, w, scale, shift, relu_in, norm_in,
                                  stride, want_stats)
    if stride != 1:
        raise ValueError("the fused 3×3 conv is stride-1 only")
    return fused_c3_reference(x, w, scale, shift, relu_in, norm_in,
                              want_stats)


def _dyc(dy, y, dstats):
    """Total output cotangent dy + dΣ + 2·y·dΣ² (the statistics' chain
    rule), summed in f32 and rounded to dy's dtype before the products."""
    return (dy.float() + dstats[0] + 2.0 * y.float() * dstats[1]).to(dy.dtype)


def _bn_backward(de, x, scale, shift, relu_in, norm_in):
    """BN/ReLU backward of the prologue from de = ∂L/∂e (f32, NHWC):
    dx in x's dtype, dscale = Σ dpre·x, dshift = Σ dpre (f32)."""
    if not norm_in:
        zeros = torch.zeros_like(scale)
        return de.to(x.dtype), zeros, zeros.clone()
    xf = x.float()
    pre = xf * scale + shift
    dpre = torch.where(pre > 0.0, de, 0.0) if relu_in else de
    flat = lambda t: t.reshape(-1, t.shape[-1])
    return ((dpre * scale).to(x.dtype), flat(dpre * xf).sum(0),
            flat(dpre).sum(0))


def fused_mm_bwd_reference(dy, y, x, w, dstats, scale, shift,
                           relu_in: bool = True, norm_in: bool = True,
                           stride: int = 1):
    """Backward of the 1×1 conv: (dx in x's dtype and full shape — zeros
    off the stride grid —, dW f32, dscale f32, dshift f32)."""
    xs = x[:, ::stride, ::stride, :] if stride != 1 else x
    cin, cout = w.shape
    dyc = _dyc(dy, y, dstats).reshape(-1, cout).float()
    de = (dyc @ w.float().t()).reshape(xs.shape)
    dxs, dscale, dshift = _bn_backward(de, xs, scale, shift, relu_in, norm_in)
    e = _norm_in(xs, scale, shift, relu_in, norm_in).reshape(-1, cin)
    dw = e.float().t() @ dyc
    if stride != 1:
        dx = torch.zeros_like(x)
        dx[:, ::stride, ::stride, :] = dxs
    else:
        dx = dxs
    return dx, dw, dscale, dshift


def fused_c3_bwd_in_reference(dy, y, x, w, dstats, scale, shift,
                              relu_in: bool = True, norm_in: bool = True):
    """3×3 backward-input: de = SAME conv of the zero-padded dyc with the
    flipped, IO-swapped filter, then the BN/ReLU backward:
    (dx, dscale, dshift)."""
    n, h, wd, cout = dy.shape
    cin = x.shape[3]
    dp = F.pad(_dyc(dy, y, dstats).float(), (0, 0, 1, 1, 1, 1))
    wt = w.float().flip(0, 1).transpose(2, 3).reshape(9, cout, cin)
    de = torch.zeros((n * h * wd, cin), dtype=torch.float32, device=x.device)
    for t, tap in enumerate(_taps(dp, h, wd)):
        de = de + tap.reshape(-1, cout) @ wt[t]
    return _bn_backward(de.reshape(x.shape), x, scale, shift, relu_in,
                        norm_in)


def fused_c3_bwd_w_reference(dy, y, x, dstats, scale, shift,
                             relu_in: bool = True, norm_in: bool = True):
    """3×3 backward-filter: dW[tap] = shifted(e)ᵀ·dyc in f32, with e
    zero-padded AFTER the normalize: (3, 3, Cin, Cout)."""
    n, h, wd, cout = dy.shape
    cin = x.shape[3]
    dyc = _dyc(dy, y, dstats).reshape(-1, cout).float()
    ep = F.pad(_norm_in(x, scale, shift, relu_in, norm_in).float(),
               (0, 0, 1, 1, 1, 1))
    dw = torch.stack([tap.reshape(-1, cin).t() @ dyc
                      for tap in _taps(ep, h, wd)])
    return dw.reshape(3, 3, cin, cout)


def fused_c3_bwd_reference(dy, y, x, w, dstats, scale, shift,
                           relu_in: bool = True, norm_in: bool = True):
    """The 3×3 backward in one call: (dx, dW f32, dscale, dshift)."""
    dx, dscale, dshift = fused_c3_bwd_in_reference(
        dy, y, x, w, dstats, scale, shift, relu_in, norm_in)
    dw = fused_c3_bwd_w_reference(dy, y, x, dstats, scale, shift, relu_in,
                                  norm_in)
    return dx, dw, dscale, dshift


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BWD_TILE = 64            # rows and columns of a backward kernel's tile
_DW_MIN_DEPTH = 256       # fewest rows one dW slice sums
_DW_TARGET_BLOCKS = 264   # two blocks per SM of an H100
_DX_MIN_DEPTH = 256       # shallowest K slice of fused_c3_bwd_in worth a block
DX_STEP = 32              # depth of one fused_c3_bwd_in step (two MMA k16s)
DX_SUM_ROWS = 16          # rows of one fused_c3_bwd_in partial-sum tile
MAX_CLUSTER = 8           # K slices one thread-block cluster adds (portable)
# about the depth of one bf16 fused_mm K slice: Cin 2048 gets 8 slices,
# 1024 four, 512 two, up to 256 one (chosen on an H100, PERF.md §6)
MM_SLICE_DEPTH = 256


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda_args(name, x, w, scale, shift, w_ndim):
    """Raise on what the kernel does not take; ``w`` None checks x,
    scale and shift alone (the 3×3 dW launch reads no weight). Each call
    of a wrapper on the card pays for these checks, so they read each
    attribute once."""
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be NHWC (4-D), got {tuple(x.shape)}")
    cin, dev, dt = x.shape[3], x.device, x.dtype
    if w is not None:
        shape = w.shape
        if len(shape) != w_ndim:
            raise ValueError(f"{name}: weight must be {w_ndim}-D, got "
                             f"{tuple(shape)}")
        if shape[-2] != cin:
            raise ValueError(f"{name}: weight {tuple(shape)} does not "
                             f"take {cin} input channels")
        if w_ndim == 4 and (shape[0] != 3 or shape[1] != 3):
            raise ValueError(f"{name}: weight must be (3, 3, Cin, Cout)")
    for t, what in ((w, "weight"), (scale, "scale"), (shift, "shift")):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {dev}")
    if dt not in _DTYPES or (w is not None and w.dtype != dt):
        raise TypeError(f"{name}: x and weight must share float32 or "
                        f"bfloat16, got {dt} / "
                        f"{None if w is None else w.dtype}")
    for t, what in ((scale, "scale"), (shift, "shift")):
        if t.dtype != torch.float32 or t.shape != (cin,):
            raise TypeError(f"{name}: {what} must be float32 ({cin},), got "
                            f"{t.dtype} {tuple(t.shape)}")
    for t, what in ((x, "x"), (w, "weight"), (scale, "scale"),
                    (shift, "shift")):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input")


def _check_grad_args(name, dy, y, dstats, x, out_shape):
    cout = out_shape[3]
    for t, what in ((dy, "dy"), (y, "y")):
        if tuple(t.shape) != tuple(out_shape) or t.dtype != x.dtype:
            raise ValueError(f"{name}: {what} must be {x.dtype} "
                             f"{tuple(out_shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if dstats.dtype != torch.float32 or tuple(dstats.shape) != (2, cout):
        raise TypeError(f"{name}: dstats must be float32 (2, {cout})")
    for t, what in ((dy, "dy"), (y, "y"), (dstats, "dstats")):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    _count(name)


def _launch(name, x, head, tail, planes, cout, m, want_stats):
    """Allocate the kernel's statistics buffer and, for ``planes`` above 1,
    its split-K scratch of that many f32 planes; launch it on the current
    stream with the pointers ``head``, those two buffers and the ints
    ``tail``; raise on a launch error; returns the stats."""
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = ws = None
    if want_stats:
        partial = torch.empty((-(-m // cuda_build.tile_m(name)), 2, cout),
                              **f32)
    if planes > 1:
        ws = torch.empty((planes, m, cout), **f32)
    err = cuda_build.kernel(name)(*head, _ptr(partial), _ptr(ws), *tail,
                                  int(want_stats), _DTYPES[x.dtype],
                                  cuda_build.current_stream(x.device))
    _raise_on(name, err)
    return partial.sum(0) if want_stats else None


@functools.lru_cache(maxsize=64)
def mm_slices(k: int) -> Tuple[int, int]:
    """(count, depth of each) of the K slices the bf16 ``fused_mm`` cuts its
    depth K = Cin into: about ``MM_SLICE_DEPTH`` deep, at most
    ``MAX_CLUSTER`` (they are added in one thread-block cluster), each a
    multiple of ``DX_STEP``, the last one shorter. A function of K alone, so
    a row's bits do not depend on how many rows the call has."""
    want = min(MAX_CLUSTER, -(-k // MM_SLICE_DEPTH))
    per = -(-(-(-k // want)) // DX_STEP) * DX_STEP
    return -(-k // per), per


@functools.lru_cache(maxsize=64)
def _mm_split(cin: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """(K slices, their depth, f32 scratch planes) of one ``fused_mm`` call:
    bf16 adds the slices of ``mm_slices`` in the shared memory of a
    thread-block cluster, with no scratch; f32 adds its FMA kernel's slices
    from f32 planes in device memory."""
    if dtype == torch.bfloat16:
        return mm_slices(cin) + (1,)
    return 0, 0, cuda_build.split_count("fused_mm", cin)


def fused_mm(x, w, scale, shift, relu_in: bool = True, norm_in: bool = True,
             stride: int = 1, want_stats: bool = True
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """1×1 conv + BN statistics: x (N, H, W, Cin), w (Cin, Cout) →
    y (N, ⌈H/s⌉, ⌈W/s⌉, Cout) in x's dtype, stats (2, Cout) f32 (None
    unless ``want_stats``)."""
    if x.device.type == "cpu":
        return fused_mm_reference(x, w, scale, shift, relu_in, norm_in,
                                  stride, want_stats)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mm: unsupported device {x.device}")
    _check_cuda_args("fused_mm", x, w, scale, shift, 2)
    if stride < 1:
        raise ValueError("fused_mm: stride must be >= 1")
    n, h, wd, cin = x.shape
    cout = w.shape[1]
    ho, wo = -(-h // stride), -(-wd // stride)
    slices, depth, planes = _mm_split(cin, x.dtype)
    with torch.cuda.device(x.device):
        y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
        stats = _launch(
            "fused_mm", x, (x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                            shift.data_ptr(), y.data_ptr()),
            (n, h, wd, cin, cout, stride, int(norm_in), int(relu_in), slices,
             depth), planes, cout, n * ho * wo, want_stats)
    return y, stats


def fused_c3(x, w, scale, shift, relu_in: bool = True, norm_in: bool = True,
             want_stats: bool = True
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """3×3 SAME stride-1 conv + BN statistics: x (N, H, W, Cin),
    w (3, 3, Cin, Cout) → y (N, H, W, Cout) in x's dtype, stats (2, Cout)
    (None unless ``want_stats``)."""
    if x.device.type == "cpu":
        return fused_c3_reference(x, w, scale, shift, relu_in, norm_in,
                                  want_stats)
    if x.device.type != "cuda":
        raise ValueError(f"fused_c3: unsupported device {x.device}")
    _check_cuda_args("fused_c3", x, w, scale, shift, 4)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    # f32 adds its K slices from f32 planes in device memory; bf16 in the
    # shared memory of a thread-block cluster, with no scratch
    slices = (cuda_build.split_count("fused_c3", 9 * cin)
              if x.dtype == torch.float32 else 1)
    with torch.cuda.device(x.device):
        y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
        stats = _launch(
            "fused_c3", x, (x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                            shift.data_ptr(), y.data_ptr()),
            (n, h, wd, cin, cout, int(norm_in), int(relu_in)), slices, cout,
            n * h * wd, want_stats)
    return y, stats


def dw_chunk(rows: int, cols: int, depth: int) -> int:
    """Rows of dy one dW block sums (a multiple of 16): the depth M is cut
    into slices until the dW grid has about two blocks per SM. A function
    of the shapes alone, so a call's bits do not vary from run to run."""
    tiles = -(-rows // _BWD_TILE) * -(-cols // _BWD_TILE)
    splits = max(1, min(-(-_DW_TARGET_BLOCKS // tiles),
                        -(-depth // _DW_MIN_DEPTH)))
    per = -(-depth // splits)
    return -(-per // 16) * 16


def dw_mma_slices(rows: int, cols: int, m: int) -> Tuple[int, int]:
    """(pixels each, count) of the bf16 tensor-core dW product's slices of
    its M pixels: ``dw_chunk``'s rows rounded up to a whole ``DX_STEP``."""
    chunk = -(-dw_chunk(rows, cols, m) // DX_STEP) * DX_STEP
    return chunk, -(-m // chunk)


def dx_slices(m: int, cin: int, depth: int,
              most: int = 0) -> Tuple[int, int]:
    """(count, depth of each) of the K slices ``fused_c3_bwd_in`` cuts its
    depth 9·Cout into (and the bf16 ``fused_mm_bwd`` its Cout, at ``most``
    ``MAX_CLUSTER``): slices are added until its grid of 64×64 (M, Cin)
    tiles × slices has about two blocks per SM, none shallower than about
    256, no more than ``most`` when given; each is a multiple of ``DX_STEP``
    deep, the last one shorter. A function of the shapes alone, so a call's
    bits do not vary from run to run."""
    tiles = -(-m // _BWD_TILE) * -(-cin // _BWD_TILE)
    want = max(1, min(-(-_DW_TARGET_BLOCKS // tiles),
                      -(-depth // _DX_MIN_DEPTH)))
    if most:
        want = min(want, most)
    per = -(-(-(-depth // want)) // DX_STEP) * DX_STEP
    return -(-depth // per), per


class DxPlan(NamedTuple):
    """How ``fused_c3_bwd_in`` cuts one call: its K slices and the offsets,
    in f32 elements, of its scratch in one f32 buffer (each 16-byte
    aligned), which starts with the (slices, M, Cin) f32 planes of de, one
    per K slice."""
    slices: int       # K slices
    depth: int        # depth of each (the last one shorter)
    row_tiles: int    # (Σdpre·x, Σdpre) tiles of DX_SUM_ROWS rows, or 0
    partial: int      # (row_tiles, 2, Cin) f32: the sums of each row tile
    sums: int         # (2, Cin) f32: partial added over the tiles in order
    dyc: int          # (M, Cout) bf16: dyc, for bf16 inputs
    size: int         # f32 elements in all


@functools.lru_cache(maxsize=256)
def dx_plan(m: int, cin: int, cout: int, norm_in: bool,
            bf16: bool) -> DxPlan:
    """The ``DxPlan`` of one ``fused_c3_bwd_in`` call; a function of the
    shapes alone."""
    slices, depth = dx_slices(m, cin, 9 * cout)
    tiles = -(-m // DX_SUM_ROWS) if norm_in else 0
    seg = lambda n: -(-n // 4) * 4                 # whole 16-byte units
    partial = seg(slices * m * cin)
    sums = partial + seg(tiles * 2 * cin)
    dyc = sums + seg(2 * cin)
    size = dyc + (seg(-(-m * cout // 2)) if bf16 else 0)
    return DxPlan(slices, depth, tiles, partial, sums, dyc, size)


class C3BwdPlan(NamedTuple):
    """How the bf16 ``fused_c3_bwd`` cuts one call: the dx product's K
    slices (as ``DxPlan``), the dW product's pixel slices, and the offsets,
    in f32 elements, of its scratch and outputs in one f32 buffer (each
    16-byte aligned), which starts with the (slices, M, Cin) f32 planes of
    de."""
    slices: int       # K slices of the dx product
    depth: int        # depth of each (the last one shorter)
    tile_rows: int    # rows of one (Σdpre·x, Σdpre) tile, a multiple of 16
    row_tiles: int    # those tiles, or 0 without the normalize
    dw_chunk: int     # pixels one dW slice sums, a multiple of DX_STEP
    dw_slices: int    # dW slices
    dw_ws: int        # (dw_slices, 9·Cin, Cout) f32 planes, when above 1
    dw: int           # (9·Cin, Cout) f32: dW
    partial: int      # (row_tiles, 2, Cin) f32
    sums: int         # (2, Cin) f32: (dscale, dshift)
    dyc: int          # (M, Cout) bf16
    size: int         # f32 elements in all


@functools.lru_cache(maxsize=256)
def c3_bwd_plan(m: int, cin: int, cout: int, norm_in: bool) -> C3BwdPlan:
    """The ``C3BwdPlan`` of one bf16 ``fused_c3_bwd`` call: the dx slices
    of ``dx_slices``; row tiles of the BN sums no more than about two per
    SM (each is added in order by one thread per channel, so their count
    bounds the sums' last pass; at least DX_SUM_ROWS rows); the dW slices
    of ``dw_mma_slices``. A function of the shapes alone."""
    slices, depth = dx_slices(m, cin, 9 * cout)
    rows = -(-m // _DW_TARGET_BLOCKS)
    rows = max(DX_SUM_ROWS, -(-rows // DX_SUM_ROWS) * DX_SUM_ROWS)
    chunk, dw_slices = dw_mma_slices(9 * cin, cout, m)
    tiles = -(-m // rows) if norm_in else 0
    seg = lambda n: -(-n // 4) * 4                 # whole 16-byte units
    dw_ws = seg(slices * m * cin)
    dw = dw_ws + (seg(dw_slices * 9 * cin * cout) if dw_slices > 1 else 0)
    partial = dw + seg(9 * cin * cout)
    sums = partial + seg(tiles * 2 * cin)
    dyc = sums + seg(2 * cin)
    size = dyc + seg(-(-m * cout // 2))
    return C3BwdPlan(slices, depth, rows, tiles, chunk, dw_slices, dw_ws,
                     dw, partial, sums, dyc, size)


class C3BwdWPlan(NamedTuple):
    """How the bf16 ``fused_c3_bwd_w`` cuts one call: the dW product's
    pixel slices (as ``C3BwdPlan``'s) and the offsets, in f32 elements, of
    its output and scratch in one f32 buffer (each 16-byte aligned), which
    starts with dW, (9·Cin, Cout) f32."""
    dw_chunk: int     # pixels one dW slice sums, a multiple of DX_STEP
    dw_slices: int    # dW slices
    dw_ws: int        # (dw_slices, 9·Cin, Cout) f32 planes, when above 1
    dyc: int          # (M, Cout) bf16
    size: int         # f32 elements in all


@functools.lru_cache(maxsize=256)
def c3_bwd_w_plan(m: int, cin: int, cout: int) -> C3BwdWPlan:
    """The ``C3BwdWPlan`` of one bf16 ``fused_c3_bwd_w`` call: the dW
    slices of ``dw_mma_slices``, as ``c3_bwd_plan``'s. A function of the
    shapes alone."""
    chunk, dw_slices = dw_mma_slices(9 * cin, cout, m)
    seg = lambda n: -(-n // 4) * 4                 # whole 16-byte units
    dw_ws = seg(9 * cin * cout)
    dyc = dw_ws + (seg(dw_slices * 9 * cin * cout) if dw_slices > 1 else 0)
    return C3BwdWPlan(chunk, dw_slices, dw_ws, dyc,
                      dyc + seg(-(-m * cout // 2)))


class MmBwdPlan(NamedTuple):
    """How the bf16 ``fused_mm_bwd`` cuts one call: the dx product's K
    slices of the Cout depth (added in a thread-block cluster), the dW
    product's pixel slices, and the offsets, in f32 elements, of its outputs
    and scratch in one f32 buffer (each 16-byte aligned), which starts with
    dW, (Cin, Cout) f32."""
    slices: int       # K slices of the dx product, at most MAX_CLUSTER
    depth: int        # depth of each (the last one shorter)
    row_tiles: int    # 64-row tiles of (Σdpre·x, Σdpre), or 0 without norm
    dw_chunk: int     # pixels one dW slice sums, a multiple of DX_STEP
    dw_slices: int    # dW slices
    dw_ws: int        # (dw_slices, Cin, Cout) f32 planes, when above 1
    partial: int      # (row_tiles, 2, Cin) f32
    sums: int         # (2, Cin) f32: (dscale, dshift)
    dyc: int          # (M, Cout) bf16
    size: int         # f32 elements in all


@functools.lru_cache(maxsize=256)
def mm_bwd_plan(m: int, cin: int, cout: int, norm_in: bool) -> MmBwdPlan:
    """The ``MmBwdPlan`` of one bf16 ``fused_mm_bwd`` call with M rows of
    dy: the dx slices of ``dx_slices`` (at most ``MAX_CLUSTER``); the dW
    slices of ``dw_mma_slices``. A function of the shapes alone."""
    slices, depth = dx_slices(m, cin, cout, MAX_CLUSTER)
    chunk, dw_slices = dw_mma_slices(cin, cout, m)
    tiles = -(-m // _BWD_TILE) if norm_in else 0
    seg = lambda n: -(-n // 4) * 4                 # whole 16-byte units
    dw_ws = seg(cin * cout)
    partial = dw_ws + (seg(dw_slices * cin * cout) if dw_slices > 1 else 0)
    sums = partial + seg(tiles * 2 * cin)
    dyc = sums + seg(2 * cin)
    size = dyc + seg(-(-m * cout // 2))
    return MmBwdPlan(slices, depth, tiles, chunk, dw_slices, dw_ws, partial,
                     sums, dyc, size)


class _Bwd:
    """Buffers and launch of one backward kernel call on the card."""

    def __init__(self, name, x, m, cin, cout, dw_rows, norm_in, want_dx,
                 want_dw):
        self.name, self.dev = name, x.device
        f32 = dict(dtype=torch.float32, device=x.device)
        self.partial = (torch.empty((-(-m // cuda_build.tile_m(name)), 2,
                                     cin), **f32)
                        if want_dx and norm_in else None)
        self.dw = self.ws = None
        self.chunk = 0
        if want_dw:
            self.chunk = dw_chunk(dw_rows, cout, m)
            self.dw = torch.empty((dw_rows, cout), **f32)
            splits = -(-m // self.chunk)
            if splits > 1:
                self.ws = torch.empty((splits, dw_rows, cout), **f32)

    def run(self, *args):
        _raise_on(self.name, cuda_build.kernel(self.name)(
            *args, cuda_build.current_stream(self.dev)))

    def sums(self, cin):
        if self.partial is None:
            z = torch.zeros((cin,), dtype=torch.float32, device=self.dev)
            return z, z.clone()
        st = self.partial.sum(0)
        return st[0], st[1]


def fused_mm_bwd(dy, y, x, w, dstats, scale, shift, relu_in: bool = True,
                 norm_in: bool = True, stride: int = 1):
    """Backward of ``fused_mm`` in one call: dy, y (N, Ho, Wo, Cout),
    x (N, H, W, Cin), w (Cin, Cout), dstats (2, Cout) f32 → (dx of x's
    shape and dtype, zeros off the stride grid; dW (Cin, Cout) f32;
    dscale, dshift (Cin,) f32). bf16 runs the products on the tensor cores
    (``mm_bwd_plan``; on the card dW, dscale and dshift are views of the
    call's f32 scratch), f32 the merged FMA kernel."""
    if x.device.type == "cpu":
        return fused_mm_bwd_reference(dy, y, x, w, dstats, scale, shift,
                                      relu_in, norm_in, stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mm_bwd: unsupported device {x.device}")
    name = "fused_mm_bwd"
    _check_cuda_args(name, x, w, scale, shift, 2)
    if stride < 1:
        raise ValueError(f"{name}: stride must be >= 1")
    n, h, wd, cin = x.shape
    cout = w.shape[1]
    ho, wo = -(-h // stride), -(-wd // stride)
    _check_grad_args(name, dy, y, dstats, x, (n, ho, wo, cout))
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:     # dx written whole by the kernel
            plan = mm_bwd_plan(n * ho * wo, cin, cout, bool(norm_in))
            dx = torch.empty_like(x)
            buf = torch.empty(plan.size, dtype=torch.float32,
                              device=x.device)
            at = buf.data_ptr()
            _raise_on(name, cuda_build.kernel(name)(
                dy.data_ptr(), y.data_ptr(), x.data_ptr(), w.data_ptr(),
                dstats.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                dx.data_ptr(), at,
                at + 4 * plan.dw_ws if plan.dw_slices > 1 else None,
                at + 4 * plan.partial if norm_in else None,
                at + 4 * plan.sums, at + 4 * plan.dyc, n, h, wd, cin, cout,
                stride, int(norm_in), int(relu_in), plan.dw_chunk,
                plan.slices, plan.depth, 1,
                cuda_build.current_stream(x.device)))
            dscale, dshift = buf[plan.sums:plan.sums + 2 * cin].view(
                2, cin).unbind(0)
            return dx, buf[:cin * cout].view(cin, cout), dscale, dshift
        dx = (torch.zeros_like(x) if stride != 1 else torch.empty_like(x))
        b = _Bwd(name, x, n * ho * wo, cin, cout, cin, norm_in, True,
                 True)
        b.run(dy.data_ptr(), y.data_ptr(), x.data_ptr(), w.data_ptr(),
              dstats.data_ptr(), scale.data_ptr(), shift.data_ptr(),
              dx.data_ptr(), b.dw.data_ptr(), _ptr(b.ws), _ptr(b.partial),
              None, None, n, h, wd, cin, cout, stride, int(norm_in),
              int(relu_in), b.chunk, 0, 0, 0)
        dscale, dshift = b.sums(cin)
    return dx, b.dw, dscale, dshift


def _c3_bwd_prep(name, dy, y, x, w, dstats, scale, shift):
    """Checks of a 3×3 backward launch; returns (N, H, W, Cin, Cout)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_cuda_args(name, x, w, scale, shift, 4)
    cout = dy.shape[3] if dy.ndim == 4 else -1
    if w is not None and w.shape[3] != cout:
        raise ValueError(f"{name}: dy has {cout} channels, weight "
                         f"{tuple(w.shape)}")
    _check_grad_args(name, dy, y, dstats, x, tuple(x.shape[:3]) + (cout,))
    return tuple(x.shape) + (cout,)


def fused_c3_bwd(dy, y, x, w, dstats, scale, shift, relu_in: bool = True,
                 norm_in: bool = True):
    """Backward of ``fused_c3`` in one call: (dx in x's dtype, dW (3, 3,
    Cin, Cout) f32, dscale, dshift (Cin,) f32). bf16 runs the split
    products on the tensor cores (``c3_bwd_plan``; on the card dW, dscale
    and dshift are views of the call's f32 scratch), f32 the merged FMA
    kernel (dx tiles and dW tiles in one grid)."""
    if x.device.type == "cpu":
        return fused_c3_bwd_reference(dy, y, x, w, dstats, scale, shift,
                                      relu_in, norm_in)
    name = "fused_c3_bwd"
    n, h, wd, cin, cout = _c3_bwd_prep(name, dy, y, x, w, dstats, scale,
                                       shift)
    m = n * h * wd
    flags = (int(norm_in), int(relu_in))
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        if x.dtype == torch.bfloat16:
            plan = c3_bwd_plan(m, cin, cout, bool(norm_in))
            buf = torch.empty(plan.size, dtype=torch.float32,
                              device=x.device)
            at = buf.data_ptr()
            _raise_on(name, cuda_build.kernel(name)(
                dy.data_ptr(), y.data_ptr(), x.data_ptr(), w.data_ptr(),
                dstats.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                dx.data_ptr(), at + 4 * plan.dw,
                at + 4 * plan.dw_ws if plan.dw_slices > 1 else None, at,
                at + 4 * plan.partial if norm_in else None,
                at + 4 * plan.sums, at + 4 * plan.dyc, n, h, wd, cin, cout,
                *flags, plan.dw_chunk, plan.slices, plan.depth,
                plan.tile_rows, 1, cuda_build.current_stream(x.device)))
            dw = buf[plan.dw:plan.dw + 9 * cin * cout]
            dscale, dshift = buf[plan.sums:plan.sums + 2 * cin].view(
                2, cin).unbind(0)
        else:
            b = _Bwd(name, x, m, cin, cout, 9 * cin, norm_in, True, True)
            b.run(dy.data_ptr(), y.data_ptr(), x.data_ptr(), w.data_ptr(),
                  dstats.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                  dx.data_ptr(), b.dw.data_ptr(), _ptr(b.ws), None,
                  _ptr(b.partial), None, None, n, h, wd, cin, cout, *flags,
                  b.chunk, 0, 0, 0, 0)
            dw = b.dw
            dscale, dshift = b.sums(cin)
    return dx, dw.view(3, 3, cin, cout), dscale, dshift


def fused_c3_bwd_in(dy, y, x, w, dstats, scale, shift, relu_in: bool = True,
                    norm_in: bool = True):
    """3×3 backward-input launch: (dx in x's dtype, dscale, dshift); on
    the card dscale and dshift are views of the call's f32 scratch
    (``dx_plan``)."""
    if x.device.type == "cpu":
        return fused_c3_bwd_in_reference(dy, y, x, w, dstats, scale, shift,
                                         relu_in, norm_in)
    name = "fused_c3_bwd_in"
    n, h, wd, cin, cout = _c3_bwd_prep(name, dy, y, x, w, dstats, scale,
                                       shift)
    bf16 = x.dtype == torch.bfloat16
    plan = dx_plan(n * h * wd, cin, cout, bool(norm_in), bf16)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        buf = torch.empty(plan.size, dtype=torch.float32, device=x.device)
        at = buf.data_ptr()
        _raise_on(name, cuda_build.kernel(name)(
            dy.data_ptr(), y.data_ptr(), x.data_ptr(), w.data_ptr(),
            dstats.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            dx.data_ptr(), at, at + 4 * plan.partial if norm_in else None,
            at + 4 * plan.sums, at + 4 * plan.dyc if bf16 else None, n, h,
            wd, cin, cout, int(norm_in), int(relu_in), plan.slices,
            plan.depth, DX_SUM_ROWS, _DTYPES[x.dtype],
            cuda_build.current_stream(x.device)))
    dscale, dshift = buf[plan.sums:plan.sums + 2 * cin].view(2, cin).unbind(0)
    return dx, dscale, dshift


def fused_c3_bwd_w(dy, y, x, dstats, scale, shift, relu_in: bool = True,
                   norm_in: bool = True):
    """3×3 backward-filter launch: dW (3, 3, Cin, Cout) f32. bf16 runs the
    tensor-core dW tiles (``c3_bwd_w_plan``; on the card dW is a view of
    the call's f32 scratch), f32 the FMA tiles."""
    if x.device.type == "cpu":
        return fused_c3_bwd_w_reference(dy, y, x, dstats, scale, shift,
                                        relu_in, norm_in)
    name = "fused_c3_bwd_w"
    n, h, wd, cin, cout = _c3_bwd_prep(name, dy, y, x, None, dstats, scale,
                                       shift)
    ptrs = (dy.data_ptr(), y.data_ptr(), x.data_ptr(), dstats.data_ptr(),
            scale.data_ptr(), shift.data_ptr())
    flags = (n, h, wd, cin, cout, int(norm_in), int(relu_in))
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            plan = c3_bwd_w_plan(n * h * wd, cin, cout)
            buf = torch.empty(plan.size, dtype=torch.float32,
                              device=x.device)
            at = buf.data_ptr()
            _raise_on(name, cuda_build.kernel(name)(
                *ptrs, at, at + 4 * plan.dw_ws if plan.dw_slices > 1
                else None, at + 4 * plan.dyc, *flags, plan.dw_chunk, 1,
                cuda_build.current_stream(x.device)))
            return buf[:9 * cin * cout].view(3, 3, cin, cout)
        b = _Bwd(name, x, n * h * wd, cin, cout, 9 * cin, norm_in, False,
                 True)
        b.run(*ptrs, b.dw.data_ptr(), _ptr(b.ws), None, *flags, b.chunk, 0)
    return b.dw.reshape(3, 3, cin, cout)


# ---------------------------------------------------------------------------
# the op: forward kernels, backward kernels, autograd between them
# ---------------------------------------------------------------------------

# 3×3 backward route, carried over from the JAX package's rule: one
# fused_c3_bwd call up to this many input channels (with the normalize),
# fused_c3_bwd_in + fused_c3_bwd_w above. The JAX package's threshold is a
# TPU VMEM budget. On an H100 the bf16 fused_c3_bwd is faster at every
# 3×3 shape of the ResNet50 path (PERF.md §6); the rule is kept so the two
# kernels of the JAX path's split route run on this path too.
C3_MERGED_MAX_CIN = 384


def _forward(x, w, scale, shift, relu_in, norm_in, stride, want_stats):
    if w.ndim == 2:
        return fused_mm(x, w, scale, shift, relu_in, norm_in, stride,
                        want_stats)
    if stride != 1:
        raise ValueError("the fused 3×3 conv is stride-1 only")
    return fused_c3(x, w, scale, shift, relu_in, norm_in, want_stats)


def _backward(dy, dstats, x, w, scale, shift, y, relu_in, norm_in, stride):
    """(dx, dW f32, dscale, dshift) through the route the JAX package's
    ``_fused_bwd_rule`` takes."""
    if w.ndim == 2:
        return fused_mm_bwd(dy, y, x, w, dstats, scale, shift, relu_in,
                            norm_in, stride)
    if x.shape[3] <= C3_MERGED_MAX_CIN and norm_in:
        return fused_c3_bwd(dy, y, x, w, dstats, scale, shift, relu_in,
                            norm_in)
    dx, dscale, dshift = fused_c3_bwd_in(dy, y, x, w, dstats, scale, shift,
                                         relu_in, norm_in)
    dw = fused_c3_bwd_w(dy, y, x, dstats, scale, shift, relu_in, norm_in)
    return dx, dw, dscale, dshift


class _FusedConvBnAct(torch.autograd.Function):
    """Differentiable in ``y`` and ``stats``; saves (x, w, scale, shift,
    y) like the JAX package's ``_fused_fwd_rule``: the normalized input
    is recomputed by the backward kernels, never stored."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, relu_in, norm_in, stride):
        y, stats = _forward(x, w, scale, shift, relu_in, norm_in, stride,
                            True)
        ctx.save_for_backward(x, w, scale, shift, y)
        ctx.flags = (relu_in, norm_in, stride)
        return y, stats

    @staticmethod
    def backward(ctx, dy, dstats):
        x, w, scale, shift, y = ctx.saved_tensors
        relu_in, norm_in, stride = ctx.flags
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        dstats = (torch.zeros((2, y.shape[-1]), dtype=torch.float32,
                              device=y.device) if dstats is None
                  else dstats.float().contiguous())
        dx, dw, dscale, dshift = _backward(dy, dstats, x, w, scale, shift,
                                           y, relu_in, norm_in, stride)
        return dx, dw.to(w.dtype), dscale, dshift, None, None, None


def fused_conv_bn_act(x, w, scale, shift, relu_in: bool = True,
                      norm_in: bool = True, stride: int = 1,
                      want_stats: bool = True):
    """y = conv(relu?(x·scale + shift)) ⊕ per-channel (Σy, Σy²).

    ``w`` (Cin, Cout) selects the 1×1 kernel (with optional spatial
    ``stride``); ``w`` (3, 3, Cin, Cout) the SAME 3×3 kernel. Returns
    ``(y, stats)`` with ``stats`` float32 (2, Cout); inference, which
    normalizes with running statistics, passes ``want_stats=False`` and
    gets None (the kernels then skip the statistics epilogue). When an
    input requires a gradient, both outputs are differentiable and the
    backward runs through the backward kernels."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, shift)):
        y, stats = _FusedConvBnAct.apply(x, w, scale, shift, relu_in,
                                         norm_in, stride)
        return y, (stats if want_stats else None)
    return _forward(x, w, scale, shift, relu_in, norm_in, stride,
                    want_stats)


# ---------------------------------------------------------------------------
# BN helpers shared by the fused block layer
# ---------------------------------------------------------------------------

def stats_to_scale_shift(stats, count, gamma, beta, eps):
    """(Σy, Σy²) → the (scale, shift) form of BN normalize+affine, plus
    (mean, var). Biased variance, as the JAX package computes it."""
    mean = stats[0].float() / count
    var = torch.clamp(stats[1].float() / count - mean * mean, min=0.0)
    inv = gamma.float() * torch.rsqrt(var + eps)
    return inv, beta.float() - mean * inv, mean, var


# ---------------------------------------------------------------------------
# the "xla" arm of the fused block: plain convolutions with the statistics
# taken beside them (the JAX package's conv_bn_stats_xla), no kernel
# ---------------------------------------------------------------------------

def _gram_product(e2: torch.Tensor) -> torch.Tensor:
    """eᵀe of an (M, C) matrix as f32, accumulated in f32 from e's dtype.
    A bf16 ``torch.matmul`` would return a bf16 Gram (Σy² rounded to 8
    bits breaks the batch-norm variance), so bf16 on the card asks
    ``torch.mm`` for an f32 result; on the CPU, which has no such ``mm``,
    the operands are upcast first (bf16 products are exact in f32, so
    the result is the same f32-accumulated sum)."""
    if e2.dtype == torch.bfloat16 and e2.is_cuda:
        return torch.mm(e2.t(), e2, out_dtype=torch.float32)
    e32 = e2.float()
    return torch.matmul(e32.t(), e32)


class _Gram(torch.autograd.Function):
    """G = eᵀe over all leading axes of e, f32; the backward is
    de = e·(dG + dGᵀ) in e's dtype (the JAX package's ``_gram`` custom
    VJP)."""

    @staticmethod
    def forward(ctx, e):
        ctx.save_for_backward(e)
        return _gram_product(e.reshape(-1, e.shape[-1]))

    @staticmethod
    def backward(ctx, dg):
        (e,) = ctx.saved_tensors
        d = (dg + dg.t()).to(e.dtype)
        return torch.matmul(e, d)


GRAM_MODES = ("auto", "always", "never")


def gram_route(mode: str = "auto") -> bool:
    """Whether a 1×1 conv of ``conv_bn_stats_xla`` takes its statistics
    from the Gram of its input (``always``) or from its output
    (``never``). ``auto`` is the rule an H100 set (chip_smoke.py's zoo
    phase times both routes, forward and backward, at every 1×1 call of
    the bench ResNet50 at batch 128 in bf16): in six runs the direct
    route won 13 to 16 of the 16 calls, expanding or not, by up to 3.5×;
    the Gram's few wins fell on other calls in each run and would have
    saved at most 2.8 of 49.6 ms a step; the Gram's extra
    products (eᵀe, and e·(dG + dGᵀ) in the backward) cost more on the
    card than the output bytes they save. So ``auto`` takes the direct
    route, whatever the widths."""
    if mode not in GRAM_MODES:
        raise ValueError(f"gram must be one of {GRAM_MODES}, got {mode!r}")
    return mode == "always"


def conv_bn_stats_xla(x, w, scale, shift, relu_in: bool = True,
                      norm_in: bool = True, stride: int = 1,
                      want_stats: bool = True, gram: str = "auto"):
    """The plain sibling of ``fused_conv_bn_act``: the same ``(y, (Σy,
    Σy²))`` contract by plain torch ops and autograd, no kernel (the JAX
    package's ``conv_bn_stats_xla``, which leaves the convs to XLA).

    ``w`` (Cin, Cout) is a 1×1 conv (``stride`` subsamples the normalized
    input BEFORE the product); ``w`` (3, 3, Cin, Cout) a 3×3 SAME,
    stride-1 conv. y is computed in the input's dtype. A 1×1 conv on the
    Gram route takes Σy = (Σe)·W and Σy² = diag(Wᵀ(eᵀe)W) from the
    unrounded input side in f32, so it never re-reads the Cout-wide
    output; the direct route (and every 3×3) sums the rounded y. The two
    round differently; ``gram`` picks the route (``gram_route``).
    ``want_stats=False`` (inference) skips the statistics."""
    e = _norm_in(x, scale, shift, relu_in, norm_in)
    w = w.to(e.dtype)
    if w.ndim == 2:
        if stride != 1:
            e = e[:, ::stride, ::stride, :]
        y = torch.matmul(e, w)
        if not want_stats:
            return y.to(x.dtype), None
        if gram_route(gram):
            wf = w.float()
            colsum = e.float().reshape(-1, e.shape[-1]).sum(0)
            s2 = ((_Gram.apply(e) @ wf) * wf).sum(0)
            return y.to(x.dtype), torch.stack([colsum @ wf, s2])
        return y.to(x.dtype), _stats(y.float())
    if stride != 1:
        raise ValueError("the 3×3 conv of conv_bn_stats_xla is stride-1 "
                         "only")
    y = F.conv2d(e.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).contiguous()
    return y.to(x.dtype), (_stats(y.float()) if want_stats else None)
