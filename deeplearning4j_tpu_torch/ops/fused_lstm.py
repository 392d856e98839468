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
sm_90a, one cooperative launch per call) do the work on the card. Beside
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
from typing import Dict, NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.ops import cuda_build

LAUNCHES: Dict[str, int] = {"lstm_fwd": 0, "lstm_bwd": 0}
_launch_lock = threading.Lock()
_DTYPES = (torch.float32, torch.bfloat16)


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
    CUDA tensors. zx (T, N, 4H) and wh (H, 4H) share float32 or bfloat16;
    h0, c0 (N, H) share either; mask3 (T, N, 1) in zx's dtype or None."""
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
    ys = torch.empty((t_len, n, nh), dtype=dt, device=zx.device)
    gates = torch.empty_like(zx)
    tcs = torch.empty_like(ys)
    ccs = torch.empty_like(ys)
    h_t = torch.empty_like(h0)
    c_t = torch.empty_like(c0)
    # ping-pong exchange of h (rounded to Wh's dtype), read by every block
    xbuf = torch.empty((2, n, nh), dtype=torch.float32, device=zx.device)
    stream = cuda_build.current_stream(zx.device)
    err = cuda_build.kernel("lstm_fwd")(
        _ptr(zx), _ptr(h0), _ptr(c0), _ptr(wh), _ptr(mask3), _ptr(ys),
        _ptr(gates), _ptr(tcs), _ptr(ccs), _ptr(h_t), _ptr(c_t), _ptr(xbuf),
        t_len, n, nh, int(dt == torch.bfloat16),
        int(h0.dtype == torch.bfloat16), stream)
    _raise_on("lstm_fwd", err, (t_len, n, nh))
    _count("lstm_fwd")
    return ys, gates, tcs, ccs, h_t, c_t


# lstm_bwd's plan: what csrc/lstm_bwd.cu takes and checks
LSTM_SMEM_BUDGET = 227 * 1024     # shared memory a block may opt into (H100)
_LSTM_THREADS = 256               # threads a block (lstm.cuh's kThreads)
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


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


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
