"""Fused conv+BN kernels for ResNet bottleneck blocks (forward).

The port of the JAX package's ``ops/fused_conv.py`` forward. Two fusions
per conv layer ride the one pass the conv already pays:

  * prologue: the normalize+ReLU of the PRODUCER's BatchNorm (a per-channel
    scale+shift once the statistics are known) is applied to the input
    tile right after it is loaded, rounded to the input dtype, so the
    normalized activation never exists in device memory;
  * epilogue: per-channel (Σy, Σy²) of the conv output are taken from the
    f32 accumulator while the output tile is still on chip, so a BN
    statistics pass never re-reads y.

Two hand-written CUDA kernels (``csrc/``, sm_90a) do the work on the card:
``fused_mm`` for every 1×1 conv (a matmul over the flattened NHWC rows,
with the stride folded into the row addressing) and ``fused_c3`` for the
3×3 SAME conv (an implicit GEMM over the 9 taps, zero border applied
after the normalize). Beside each is its plain PyTorch version
(``fused_mm_reference``, ``fused_c3_reference``): the wrappers use it for
a tensor on the CPU and only there. A CUDA tensor launches the kernel or
raises; nothing falls back.

Each wrapper counts its launches in ``LAUNCHES`` (a plain integer per
kernel, incremented once per launch and nowhere else), so a run can show
that its main path went through the kernels.

The backward kernels (the JAX package's ``_bwd_merged_kernel``,
``_c3_bwd_*``) come with the training slice; until then the CUDA path
refuses inputs that require a gradient.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import cuda_build

LAUNCHES: Dict[str, int] = {"fused_mm": 0, "fused_c3": 0}
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


def fused_c3_reference(x, w, scale, shift, relu_in: bool = True,
                       norm_in: bool = True, want_stats: bool = True):
    """3×3 SAME stride-1 conv as 9 shifted matmuls on the normalized,
    THEN zero-padded input (a border of relu(0·s+b) would be wrong)."""
    e = _norm_in(x, scale, shift, relu_in, norm_in).float()
    n, h, wd, cin = e.shape
    ep = F.pad(e, (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((n * h * wd, w.shape[3]), dtype=torch.float32,
                      device=x.device)
    for di in range(3):
        for dj in range(3):
            tap = ep[:, di:di + h, dj:dj + wd, :].reshape(-1, cin)
            acc = acc + tap @ wf[di, dj]
    y = acc.reshape(n, h, wd, -1)
    return y.to(x.dtype), (_stats(acc) if want_stats else None)


def _conv_reference(x, w, scale, shift, relu_in, norm_in, stride,
                    want_stats=True):
    """The plain version of ``fused_conv_bn_act`` (either kernel)."""
    if w.ndim == 2:
        return fused_mm_reference(x, w, scale, shift, relu_in, norm_in,
                                  stride, want_stats)
    if stride != 1:
        raise ValueError("the fused 3×3 conv is stride-1 only")
    return fused_c3_reference(x, w, scale, shift, relu_in, norm_in,
                              want_stats)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda_args(name, x, w, scale, shift, w_ndim):
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be NHWC (4-D), got {tuple(x.shape)}")
    if w.ndim != w_ndim:
        raise ValueError(f"{name}: weight must be {w_ndim}-D, got "
                         f"{tuple(w.shape)}")
    cin = x.shape[3]
    if w.shape[-2] != cin:
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not take "
                         f"{cin} input channels")
    if w_ndim == 4 and tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"{name}: weight must be (3, 3, Cin, Cout)")
    for t, what in ((w, "weight"), (scale, "scale"), (shift, "shift")):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{name}: x and weight must share float32 or "
                        f"bfloat16, got {x.dtype} / {w.dtype}")
    for t, what in ((scale, "scale"), (shift, "shift")):
        if t.dtype != torch.float32 or tuple(t.shape) != (cin,):
            raise TypeError(f"{name}: {what} must be float32 ({cin},), got "
                            f"{t.dtype} {tuple(t.shape)}")
    for t, what in ((x, "x"), (w, "weight"), (scale, "scale"),
                    (shift, "shift")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, shift)):
        raise NotImplementedError(
            f"{name}: the backward kernel comes with the training slice; "
            "call under torch.no_grad()/inference_mode")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input")


def _launch(name, args, x, k, cout, m, want_stats):
    """Allocate the kernel's statistics and split-K buffers, launch it on
    the current stream, raise on a launch error; returns the stats."""
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = ws = None
    if want_stats:
        partial = torch.empty((-(-m // cuda_build.tile_m(name)), 2, cout),
                              **f32)
    splits = cuda_build.split_count(name, k)
    if splits > 1:
        ws = torch.empty((splits, m, cout), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = cuda_build.kernel(name)(*args(ptr(partial), ptr(ws)),
                                  int(want_stats), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    _count(name)
    return partial.sum(0) if want_stats else None


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
    with torch.cuda.device(x.device):
        y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
        stats = _launch("fused_mm", lambda p, ws: (
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), p, ws, n, h, wd, cin, cout, stride, int(norm_in),
            int(relu_in)), x, cin, cout, n * ho * wo, want_stats)
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
    with torch.cuda.device(x.device):
        y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
        stats = _launch("fused_c3", lambda p, ws: (
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), p, ws, n, h, wd, cin, cout, int(norm_in),
            int(relu_in)), x, 9 * cin, cout, n * h * wd, want_stats)
    return y, stats


def fused_conv_bn_act(x, w, scale, shift, relu_in: bool = True,
                      norm_in: bool = True, stride: int = 1,
                      want_stats: bool = True):
    """y = conv(relu?(x·scale + shift)) ⊕ per-channel (Σy, Σy²).

    ``w`` (Cin, Cout) selects the 1×1 kernel (with optional spatial
    ``stride``); ``w`` (3, 3, Cin, Cout) the SAME 3×3 kernel. Returns
    ``(y, stats)`` with ``stats`` float32 (2, Cout); inference, which
    normalizes with running statistics, passes ``want_stats=False`` and
    gets None (the kernels then skip the statistics epilogue)."""
    if w.ndim == 2:
        return fused_mm(x, w, scale, shift, relu_in, norm_in, stride,
                        want_stats)
    if stride != 1:
        raise ValueError("the fused 3×3 conv is stride-1 only")
    return fused_c3(x, w, scale, shift, relu_in, norm_in, want_stats)


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
