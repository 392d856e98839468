"""Fused LSTM recurrence, forward and backward.

The port of the JAX package's ``ops/pallas_lstm.py``: the whole
recurrence over pre-projected inputs ``zx = x@Wx + b`` (time-major,
gate-major ``[i|f|o|g]`` columns) runs as ONE kernel launch per layer
call, with Wh read from device memory once and the f32 (h, c) carry kept
on chip; the backward is a second launch walking time in reverse with
f32 (dh, dc, dWh). Per tick:

    z = zx[t] + round(h, Wh.dtype) @ Wh      (f32 accumulation)
    i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)
    c = f·c + i·g;  h = o·tanh(c)            (f32 carry)

and a masked tick keeps its carry. The forward also writes the residuals
the backward reads (post-activation gates, tanh(c), the carried c), all
rounded to zx's dtype, as the TPU kernel does.

Two hand-written CUDA kernels (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``,
sm_90a, one launch per call) do the work on the card, each cut by a plan
computed here from the shapes and the SM count alone (``lstm_fwd_plan``:
a thread-block cluster per row tile where one holds the tile's Wh, else a
cooperative grid; ``lstm_bwd_plan``: a cooperative grid). Beside
each is its plain PyTorch version (``lstm_fwd_reference``,
``lstm_bwd_reference``, Python loops over T with the TPU kernels'
roundings): the wrappers use it for a tensor on the CPU and only there.
A CUDA tensor launches the kernel or raises; nothing falls back. The JAX
package's dispatch (``choose_impl``, ``DL4J_LSTM_IMPL`` and its
TPU-measured table) is not carried over: every eligible LSTM on the card
runs the kernels.

Each wrapper counts its launches in ``LAUNCHES`` (a plain integer per
kernel, incremented once per launch and nowhere else).
"""

from __future__ import annotations

import functools
import threading
from collections import Counter
from typing import Dict, NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.ops import cuda_build

LAUNCHES: Dict[str, int] = {"lstm_fwd": 0, "lstm_bwd": 0}
# lstm_fwd's launches by (route, slices) of the plan they ran
FWD_ROUTES: Counter = Counter()
_launch_lock = threading.Lock()
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts():
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        FWD_ROUTES.clear()


def _count(name: str):
    with _launch_lock:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def lstm_fwd_reference(zx, h0, c0, wh, mask3=None):
    """The recurrence tick by tick: returns (ys, gates, tcs, ccs, hT, cT),
    ys/gates/tcs/ccs in zx's dtype, hT/cT in h0's/c0's. ``mask3`` is
    (T, N, 1) or None (every tick live)."""
    t_len, n, g4 = zx.shape
    nh = g4 // 4
    dt = zx.dtype
    acc = torch.promote_types(torch.float32, dt)   # f32 (f64 under checks)
    whf = wh.to(acc)
    h = h0.to(acc)
    c = c0.to(acc)
    ys, gates, tcs, ccs = [], [], [], []
    for t in range(t_len):
        # h rounded to Wh's dtype, the product summed in f32
        z = zx[t].to(acc) + h.to(wh.dtype).to(acc) @ whf
        i = torch.sigmoid(z[:, :nh])
        f = torch.sigmoid(z[:, nh:2 * nh])
        o = torch.sigmoid(z[:, 2 * nh:3 * nh])
        g = torch.tanh(z[:, 3 * nh:])
        c_raw = f * c + i * g
        tc = torch.tanh(c_raw)
        h_raw = o * tc
        if mask3 is None:
            h, c = h_raw, c_raw
        else:
            m = mask3[t].to(acc)
            h = m * h_raw + (1.0 - m) * h
            c = m * c_raw + (1.0 - m) * c
        ys.append(h.to(dt))
        gates.append(torch.cat([i, f, o, g], dim=1).to(dt))
        tcs.append(tc.to(dt))
        ccs.append(c.to(dt))
    return (torch.stack(ys), torch.stack(gates), torch.stack(tcs),
            torch.stack(ccs), h.to(h0.dtype), c.to(c0.dtype))


def lstm_bwd_reference(dys, dhT, dcT, gates, tcs, cprev, hprev, mask3, wh):
    """Reverse-time VJP of ``lstm_fwd_reference``: returns (dzx in dys's
    dtype, dWh f32 (f64 for f64 inputs), dh0 in dhT's dtype, dc0 in dcT's). dz is rounded to
    hprev's dtype for dWh and to Wh's dtype for dh, as the TPU kernel
    rounds it; a masked tick passes (dh, dc) through."""
    t_len, n, nh = dys.shape
    acc = torch.promote_types(torch.float32, dys.dtype)
    whf = wh.to(acc)
    dh = dhT.to(acc)
    dc = dcT.to(acc)
    dwh = torch.zeros((nh, 4 * nh), dtype=acc, device=dys.device)
    dzx = [None] * t_len
    for t in reversed(range(t_len)):
        m = (torch.ones((n, 1), dtype=acc, device=dys.device)
             if mask3 is None else mask3[t].to(acc))
        dh = dh + dys[t].to(acc)
        gt = gates[t].to(acc)
        i, f = gt[:, :nh], gt[:, nh:2 * nh]
        o, g = gt[:, 2 * nh:3 * nh], gt[:, 3 * nh:]
        tc = tcs[t].to(acc)
        cp = cprev[t].to(acc)
        dh_raw = m * dh
        do = dh_raw * tc
        dc_raw = m * dc + dh_raw * o * (1.0 - tc * tc)
        dz = torch.cat([dc_raw * g * i * (1.0 - i),
                        dc_raw * cp * f * (1.0 - f),
                        do * o * (1.0 - o),
                        dc_raw * i * (1.0 - g * g)], dim=1)
        dzx[t] = dz.to(dys.dtype)
        hp = hprev[t]
        dwh = dwh + hp.to(acc).t() @ dz.to(hp.dtype).to(acc)
        dh = (1.0 - m) * dh + dz.to(wh.dtype).to(acc) @ whf.t()
        dc = (1.0 - m) * dc + dc_raw * f
    return torch.stack(dzx), dwh, dh.to(dhT.dtype), dc.to(dcT.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, device, tensors, shapes):
    """Device, dtype, shape and contiguity of every kernel argument."""
    for what, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {what} is on {t.device}, expected "
                             f"{device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shapes[what]:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {shapes[what]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _raise_on(name, err, shape):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} at (T, N, H) = {shape} (a refused "
                           "cooperative launch names the grid it could not "
                           "make resident)")


def lstm_fwd(zx, h0, c0, wh, mask3=None):
    """``lstm_fwd_reference`` as one launch of ``csrc/lstm_fwd.cu`` for
    CUDA tensors, cut by ``lstm_fwd_plan``. zx (T, N, 4H) and wh (H, 4H)
    share float32 or bfloat16; h0, c0 (N, H) share either; mask3 (T, N, 1)
    in zx's dtype or None."""
    if zx.device.type == "cpu":
        return lstm_fwd_reference(zx, h0, c0, wh, mask3)
    if zx.device.type != "cuda":
        raise ValueError(f"lstm_fwd: unsupported device {zx.device}")
    t_len, n, g4 = zx.shape
    nh = g4 // 4
    _check("lstm_fwd", zx.device,
           dict(zx=zx, h0=h0, c0=c0, wh=wh, mask3=mask3),
           dict(zx=(t_len, n, 4 * nh), h0=(n, nh), c0=(n, nh),
                wh=(nh, 4 * nh), mask3=(t_len, n, 1)))
    if wh.dtype != zx.dtype or c0.dtype != h0.dtype or (
            mask3 is not None and mask3.dtype != zx.dtype):
        raise TypeError("lstm_fwd: wh and mask3 must be in zx's dtype, c0 in "
                        "h0's")
    if t_len == 0 or n == 0 or nh == 0 or g4 != 4 * nh:
        raise ValueError(f"lstm_fwd: bad shape zx {tuple(zx.shape)}")
    dt = zx.dtype
    plan = lstm_fwd_plan(t_len, n, nh, dt == torch.bfloat16,
                         _sm_count(zx.device.index or 0))
    ys = torch.empty((t_len, n, nh), dtype=dt, device=zx.device)
    gates = torch.empty_like(zx)
    tcs = torch.empty_like(ys)
    ccs = torch.empty_like(ys)
    h_t = torch.empty_like(h0)
    c_t = torch.empty_like(c0)
    # the grid route's ping-pong exchange of h (rounded to Wh's dtype)
    xbuf = (torch.empty(plan.xbuf, dtype=dt, device=zx.device)
            if plan.xbuf else None)
    stream = cuda_build.current_stream(zx.device)
    err = cuda_build.kernel("lstm_fwd")(
        _ptr(zx), _ptr(h0), _ptr(c0), _ptr(wh), _ptr(mask3), _ptr(ys),
        _ptr(gates), _ptr(tcs), _ptr(ccs), _ptr(h_t), _ptr(c_t), _ptr(xbuf),
        t_len, n, nh, int(dt == torch.bfloat16),
        int(h0.dtype == torch.bfloat16), int(plan.route == "cluster"),
        plan.slices, plan.units, plan.rows, plan.chunk, plan.groups,
        plan.stages, stream)
    _raise_on("lstm_fwd", err, (t_len, n, nh))
    _count("lstm_fwd")
    with _launch_lock:
        FWD_ROUTES[(plan.route, plan.slices)] += 1
    return ys, gates, tcs, ccs, h_t, c_t


LSTM_SMEM_BUDGET = 227 * 1024     # shared memory a block may opt into (H100)
_LSTM_THREADS = 256               # threads a block (lstm.cuh's kThreads)


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


# lstm_fwd's plan: what csrc/lstm_fwd.cu takes and checks
FWD_MAX_CLUSTER = 16    # blocks of one cluster (above 8: non-portable)
# SMs of each GPC (a cluster's blocks share one) on a 132-SM H100: the
# sizes that reproduce cudaOccupancyMaxActiveClusters for one block an SM
# on an H100 80GB HBM3 (clusters of 1, 2, 4, 7, 8, 13, 16 blocks: 132, 66,
# 30, 15, 15, 7, 7; chip_smoke.py's kernels phase prints the query beside
# each plan). Another SM count is taken as GPCs of 16.
_H100_GPCS = (18, 18, 18, 18, 18, 16, 16, 10)


class LstmFwdPlan(NamedTuple):
    """How ``lstm_fwd`` cuts one call. Block (s, r) of the ``slices`` ×
    ``row_tiles`` grid owns hidden units [s·U, s·U + U) and batch rows
    [r·RB, r·RB + RB). On the cluster route a row tile's ``slices`` blocks
    are one thread-block cluster and trade h in distributed shared memory;
    on the grid route all blocks are resident at once (one cooperative
    launch) and trade h through ``xbuf`` at a grid barrier a tick."""
    route: str        # "cluster" or "grid"
    slices: int       # ceil(H / U): the cluster size, or the grid's x
    units: int        # U: hidden units a block owns, a power of two >= 8
    rows: int         # RB: batch rows a block owns
    row_tiles: int    # ceil(N / RB): clusters, or the grid's y
    depth: int        # HP: slices·U rounded up to 32 (zeros past H)
    chunk: int        # depth of h staged at once (grid route: a multiple
    #                   of 16·groups in f32, of 32 in bf16; cluster: depth)
    stages: int       # grid route: chunk buffers, stages - 1 in flight
    groups: int       # depth ranges of the f32 product (bf16: 1)
    smem: int         # bytes of shared memory a block
    xbuf: int         # elements (zx's dtype) of the grid route's exchange


def lstm_fwd_smem(route: str, units: int, rows: int, depth: int, chunk: int,
                  stages: int, groups: int, itemsize: int) -> int:
    """Bytes of shared memory a block of ``lstm_fwd`` takes (the kernel's
    ``fwd_smem``): its columns of Wh (``depth`` × 4U, bf16 rows padded by
    16 bytes) in Wh's dtype, the h rows it multiplies (the whole depth on
    the cluster route, ``stages`` ``chunk``-deep buffers on the grid
    route; rows padded by 16 bytes), z (``groups`` planes of RBP × (4U + 4)
    f32, RBP = RB rounded up to 8), the cluster route's two slots of new
    h, the f32 (h, c) carry, one tick's zx tile and the mask rows."""
    a16 = lambda b: _up(b, 16)
    pad, u4, rbp = 16 // itemsize, 4 * units, _up(rows, 8)
    cluster = route == "cluster"
    h = rbp * (depth + pad) if cluster else stages * rbp * (chunk + pad)
    return (a16(itemsize * depth * (u4 + (8 if itemsize == 2 else 0)))
            + a16(itemsize * h) + a16(4 * groups * rbp * (u4 + 4))
            + (a16(itemsize * 2 * rows * units) if cluster else 0)
            + 2 * a16(4 * rows * units) + a16(itemsize * rows * u4)
            + a16(4 * rbp))


def _fwd_groups(units: int, rows: int, depth: int, bf16: bool) -> int:
    """Depth ranges of the f32 product: doubled while every range's thread
    items (U units × RBP/8 row tiles) still find a thread and each keeps
    at least 16 of the depth; bf16 warps take whole depths."""
    items = units * (_up(rows, 8) // 8)
    g = 1
    while not bf16 and 2 * g * items <= _LSTM_THREADS and \
            depth // (2 * g) >= 16:
        g *= 2
    return g


def _cluster_limit(c: int, sms: int) -> int:
    """Clusters of ``c`` blocks (one an SM, at most ``FWD_MAX_CLUSTER``)
    the card keeps resident at once: each GPC holds its SMs // c of them."""
    if c > FWD_MAX_CLUSTER:
        return 0
    gpcs = _H100_GPCS if sms == sum(_H100_GPCS) else (16,) * (sms // 16)
    return sum(g // c for g in gpcs)


def _grid_ring(units: int, rows: int, depth: int, step: int, groups: int,
               itemsize: int):
    """(chunk, stages) of the grid route's ring of h: the fewest depth
    chunks (of whole ``step``s), then the most buffers up to one more than
    the chunks, that fit ``LSTM_SMEM_BUDGET``; (0, 0) where none does."""
    fits = {}
    for stages in (2, 3, 4):
        chunk = _up(depth, step)
        while chunk >= step and lstm_fwd_smem(
                "grid", units, rows, depth, chunk, stages, groups,
                itemsize) > LSTM_SMEM_BUDGET:
            chunk -= step
        if chunk >= step:
            fits[stages] = -(-depth // chunk)
    if not fits:
        return 0, 0
    stages = min(fits, key=lambda s: (fits[s], -min(s, fits[s] + 1), s))
    return _up(-(-depth // fits[stages]), step), stages


def lstm_fwd_candidate(route: str, units: int, rows: int, n: int, h: int,
                       bf16: bool) -> Optional[LstmFwdPlan]:
    """The ``LstmFwdPlan`` of ``route`` with U = ``units`` and RB =
    ``rows`` at (N, H), or None where a block does not fit
    ``LSTM_SMEM_BUDGET``."""
    isz = 2 if bf16 else 4
    slices = -(-h // units)
    depth = _up(slices * units, 32)
    groups = _fwd_groups(units, rows, depth, bf16)
    chunk, stages = depth, 1
    if route == "grid":
        # a chunk is whole product steps in every depth range
        chunk, stages = _grid_ring(units, rows, depth,
                                   32 if bf16 else 16 * groups, groups, isz)
        if not chunk:
            return None
    smem = lstm_fwd_smem(route, units, rows, depth, chunk, stages, groups,
                         isz)
    if smem > LSTM_SMEM_BUDGET:
        return None
    return LstmFwdPlan(route, slices, units, rows, -(-n // rows), depth,
                       chunk, stages, groups, smem,
                       0 if route == "cluster" else 2 * n * slices * units)


@functools.lru_cache(maxsize=256)
def lstm_fwd_plan(t_len: int, n: int, h: int, bf16: bool,
                  sms: int) -> LstmFwdPlan:
    """The ``LstmFwdPlan`` of one call on a card with ``sms`` SMs.

    Each route's best: U a power of two (at least 8) and as many row tiles
    as the card keeps resident at once (the cluster route: clusters of at
    most ``FWD_MAX_CLUSTER`` blocks, a row tile's whole Wh in them), the
    least product a block (rows rounded up to the product's 8-row tiles ×
    units) first, then (cluster) the smaller cluster or (grid) the wider U
    (less of h crosses L2 each tick) and the fewer depth chunks. bf16 takes
    the cluster route wherever one fits: its product is cheap and the
    route has no grid barrier and no exchange through L2. f32 takes the
    route with the less product a block (the cluster route on a tie): its
    FMA product dominates its tick, and the card keeps too few clusters
    resident to give every SM one block of 8 rows (measured by
    ``tools/port_probe.py plans``). A function of the shapes and the SM
    count alone, so two calls on one card give the same bits."""
    if min(t_len, n, h, sms) < 1:
        raise ValueError(f"lstm_fwd_plan: bad shape T={t_len}, N={n}, H={h} "
                         f"or SM count {sms}")
    widest = max(8, 1 << (h - 1).bit_length())
    best = {}
    for route in ("cluster", "grid"):
        units = 8
        while units <= widest:
            slices = -(-h // units)
            tiles = (_cluster_limit(slices, sms) if route == "cluster"
                     else sms // slices)
            plan = None
            if tiles >= 1:
                rows = -(-n // min(tiles, n))
                plan = lstm_fwd_candidate(route, units, rows, n, h, bf16)
            if plan is not None:
                work = _up(rows, 8) * units
                key = ((work, slices) if route == "cluster" else
                       (work, -units, -(-plan.depth // plan.chunk)))
                if route not in best or key < best[route][0]:
                    best[route] = (key, plan)
            units *= 2
    if not best:
        raise ValueError(f"lstm_fwd_plan: no block fits H={h}, N={n} in "
                         f"{LSTM_SMEM_BUDGET} bytes on {sms} SMs")
    if "cluster" in best and (bf16 or "grid" not in best or
                              best["cluster"][0][0] <= best["grid"][0][0]):
        return best["cluster"][1]
    return best["grid"][1]


# lstm_bwd's plan: what csrc/lstm_bwd.cu takes and checks
_ROW_TILE = 8                     # rows of one thread's per-tick product tile
# dWh: the tile, the depth of one staged step (f32, bf16), the cp.async
# ring's stages and the step dw_chunk is a multiple of
_DW_TILE, _DW_DEPTH, _DW_STAGES, _DW_STEP = 128, (16, 32), 4, 32
_DW_MIN_DEPTH = 256               # fewest (T·N) rows one dWh slice sums


class LstmBwdPlan(NamedTuple):
    """How ``lstm_bwd`` cuts one call. The grid is ``slices`` × ``row_tiles``
    blocks, all resident at once (one cooperative launch): block (s, r)
    owns hidden units [s·U, s·U + U) and batch rows [r·RB, r·RB + RB)."""
    units: int        # U: hidden units a block owns, a power of two >= 4
    slices: int       # ceil(H / U): the grid's x
    rows: int         # RB: batch rows a block owns
    row_tiles: int    # ceil(N / RB): the grid's y
    groups: int       # thread groups the per-tick product's 4U depth is cut in
    dw_chunk: int     # (T·N) rows one dWh slice sums, a multiple of 32
    dw_splits: int    # dWh slices (f32 planes in the scratch when above 1)
    smem: int         # bytes of shared memory a block
    xbuf: int         # f32 elements of the exchange, (2, slices, N, HP)
    ws: int           # f32 elements of the dWh planes (0 for one slice)


def _lstm_bwd_groups(rows: int, h: int, units: int) -> int:
    """Thread groups the per-tick product's depth 4U is cut into: doubled
    while every group's (RB/8 × HP/4) register tiles still find a thread
    and each keeps at least 4 of the depth."""
    tiles = _up(rows, _ROW_TILE) // _ROW_TILE * (_up(h, 4) // 4)
    g = 1
    while 2 * g * tiles <= _LSTM_THREADS and 4 * units // (2 * g) >= 4:
        g *= 2
    return g


def lstm_bwd_smem(units: int, rows: int, h: int, groups: int,
                  itemsize: int) -> int:
    """Bytes of shared memory a block of ``lstm_bwd`` takes (the kernel's
    ``bwd_smem``): Wh's columns of its units transposed (4U × (HP + 4)
    f32), dz (4U × RBP), the (dh, dc) carry, the mask, two ticks of inputs
    in the input dtype, the product groups' partials; the dWh staging
    reuses the same memory."""
    a16 = lambda b: _up(b, 16)
    hp, rbp = _up(h, 4), _up(rows, _ROW_TILE)
    total = (a16(4 * 4 * units * (hp + 4)) + a16(4 * 4 * units * rbp)
             + 2 * a16(4 * rows * units) + a16(4 * 2 * rbp)
             + a16(itemsize * 2 * rows * 7 * units))
    if groups > 1:
        total += a16(4 * groups * rbp * hp)
    f32 = itemsize == 4
    staging = (itemsize * _DW_STAGES * 2 * _DW_DEPTH[not f32]
               * (_DW_TILE + (4 if f32 else 8)))
    return max(total, staging)


@functools.lru_cache(maxsize=256)
def lstm_bwd_plan(t_len: int, n: int, h: int, bf16: bool,
                  sms: int) -> LstmBwdPlan:
    """The ``LstmBwdPlan`` of one call on a card with ``sms`` SMs: the
    widest U (a power of two) whose block fits ``LSTM_SMEM_BUDGET``, with
    as many row tiles as give every SM at most one block (fewer slices mean
    fewer exchange planes a tick); dWh's (T·N) depth cut into slices until
    its 128 × 128 tiles about fill the blocks, none shallower than about
    256 rows. A function of the shapes and the SM count alone, so two calls on
    one card give the same bits."""
    if min(t_len, n, h, sms) < 1:
        raise ValueError(f"lstm_bwd_plan: bad shape T={t_len}, N={n}, H={h} "
                         f"or SM count {sms}")
    isz = 2 if bf16 else 4
    units = max(4, 1 << (h - 1).bit_length())
    while True:
        slices = -(-h // units)
        if slices <= sms:
            tiles = max(1, min(sms // slices, n))
            rows = -(-n // tiles)
            groups = _lstm_bwd_groups(rows, h, units)
            smem = lstm_bwd_smem(units, rows, h, groups, isz)
            if smem <= LSTM_SMEM_BUDGET:
                break
        if units == 4:
            raise ValueError(f"lstm_bwd_plan: no block fits H={h} in "
                             f"{LSTM_SMEM_BUDGET} bytes on {sms} SMs")
        units //= 2
    row_tiles = -(-n // rows)
    dw_tiles = -(-h // _DW_TILE) * -(-4 * h // _DW_TILE)
    depth = t_len * n
    splits = max(1, min(slices * row_tiles // dw_tiles,
                        -(-depth // _DW_MIN_DEPTH)))
    chunk = _up(-(-depth // splits), _DW_STEP)
    splits = -(-depth // chunk)
    return LstmBwdPlan(units, slices, rows, row_tiles, groups, chunk, splits,
                       smem, 2 * slices * n * _up(h, 4),
                       splits * h * 4 * h if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def lstm_bwd(dys, dhT, dcT, gates, tcs, cprev, hprev, mask3, wh):
    """``lstm_bwd_reference`` as one launch of ``csrc/lstm_bwd.cu`` for
    CUDA tensors. dys, gates, tcs, cprev, hprev, mask3 and wh share zx's
    dtype; dhT and dcT share h0's."""
    if dys.device.type == "cpu":
        return lstm_bwd_reference(dys, dhT, dcT, gates, tcs, cprev, hprev,
                                  mask3, wh)
    if dys.device.type != "cuda":
        raise ValueError(f"lstm_bwd: unsupported device {dys.device}")
    t_len, n, nh = dys.shape
    seq = (t_len, n, nh)
    _check("lstm_bwd", dys.device,
           dict(dys=dys, dhT=dhT, dcT=dcT, gates=gates, tcs=tcs, cprev=cprev,
                hprev=hprev, mask3=mask3, wh=wh),
           dict(dys=seq, dhT=(n, nh), dcT=(n, nh), gates=(t_len, n, 4 * nh),
                tcs=seq, cprev=seq, hprev=seq, mask3=(t_len, n, 1),
                wh=(nh, 4 * nh)))
    dt = dys.dtype
    if any(t is not None and t.dtype != dt
           for t in (gates, tcs, cprev, hprev, mask3, wh)) \
            or dcT.dtype != dhT.dtype:
        raise TypeError("lstm_bwd: gates, tcs, cprev, hprev, mask3 and wh "
                        "must be in dys's dtype, dcT in dhT's")
    if t_len == 0 or n == 0 or nh == 0:
        raise ValueError(f"lstm_bwd: empty shape {seq}")
    plan = lstm_bwd_plan(t_len, n, nh, dt == torch.bfloat16,
                         _sm_count(dys.device.index or 0))
    dzx = torch.empty((t_len, n, 4 * nh), dtype=dt, device=dys.device)
    dwh = torch.empty((nh, 4 * nh), dtype=torch.float32, device=dys.device)
    dh0 = torch.empty_like(dhT)
    dc0 = torch.empty_like(dcT)
    # the exchange of dh partials, then the dWh slices' planes
    buf = torch.empty(plan.xbuf + plan.ws, dtype=torch.float32,
                      device=dys.device)
    at = buf.data_ptr()
    stream = cuda_build.current_stream(dys.device)
    err = cuda_build.kernel("lstm_bwd")(
        _ptr(dys), _ptr(dhT), _ptr(dcT), _ptr(gates), _ptr(tcs), _ptr(cprev),
        _ptr(hprev), _ptr(mask3), _ptr(wh), _ptr(dzx), _ptr(dwh), _ptr(dh0),
        _ptr(dc0), at, at + 4 * plan.xbuf if plan.ws else None, t_len, n, nh,
        int(dt == torch.bfloat16), int(dhT.dtype == torch.bfloat16),
        plan.units, plan.rows, plan.groups, plan.dw_chunk, stream)
    _raise_on("lstm_bwd", err, seq)
    _count("lstm_bwd")
    return dzx, dwh, dh0, dc0


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

class _LSTMFused(torch.autograd.Function):
    """``_lstm_fused_core``'s custom VJP: the forward kernel saves its
    residuals, the backward kernel consumes them; the mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, zx, h0, c0, wh, mask3):
        ys, gates, tcs, ccs, h_t, c_t = lstm_fwd(zx, h0, c0, wh, mask3)
        ctx.save_for_backward(h0, c0, wh, mask3, ys, gates, tcs, ccs)
        return ys, h_t, c_t

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        h0, c0, wh, mask3, ys, gates, tcs, ccs = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None else dys.to(ys.dtype)
        dhT = torch.zeros_like(h0) if dhT is None else dhT.to(h0.dtype)
        dcT = torch.zeros_like(c0) if dcT is None else dcT.to(c0.dtype)
        # previous-tick carries: prev(0) is the initial state, prev(t) the
        # tick-(t-1) outputs
        hprev = torch.cat([h0[None].to(ys.dtype), ys[:-1]], dim=0)
        cprev = torch.cat([c0[None].to(ccs.dtype), ccs[:-1]], dim=0)
        dzx, dwh, dh0, dc0 = lstm_bwd(
            dys.contiguous(), dhT.contiguous(), dcT.contiguous(), gates, tcs,
            cprev, hprev, mask3, wh)
        return dzx, dh0, dc0, dwh.to(wh.dtype), None


def lstm_fused(zx, h0, c0, wh, mask: Optional[torch.Tensor] = None):
    """Run the fused recurrence over pre-projected inputs.

    zx: (T, N, 4H) time-major ``x@Wx + b`` with gate-major [i|f|o|g]
    columns; h0/c0: (N, H); wh: (H, 4H); mask: optional (T, N) (a masked
    tick keeps the previous carry). Returns (ys (T, N, H), hT, cT),
    differentiable in zx, h0, c0 and wh."""
    mask3 = None if mask is None else \
        mask[:, :, None].to(zx.dtype).contiguous()
    return _LSTMFused.apply(zx.contiguous(), h0.contiguous(),
                            c0.contiguous(), wh.contiguous(), mask3)
