#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is passed over:

1. environment — card name and power limit, torch/CUDA versions; TF32 off.
2. build — ``nvcc`` builds every kernel of the path from ``csrc/`` (one
   process per source, all at once).
3. kernels — ``fused_mm`` and ``fused_c3`` at every distinct shape the
   ResNet50 gives them at batch 32, in float32 and bfloat16, held against
   their plain PyTorch versions on the card; kernel, plain and
   library-yardstick (cuDNN conv of the normalized input) times, by CUDA
   events around back-to-back calls as the path makes them, beside each
   call's bound. Then the backward kernels at the same shapes on random
   dy, y and dstats: ``fused_mm_bwd`` for every 1×1 call, and at every 3×3
   shape BOTH routes (``fused_c3_bwd`` in one launch, ``fused_c3_bwd_in``
   + ``fused_c3_bwd_w`` in two), each held against its plain version (dx,
   dW, dscale, dshift), run twice for bitwise-equal results, and timed
   beside its bound, its plain version and a library yardstick
   (``torch.matmul`` for 1×1, cuDNN's ``convolution_backward`` for 3×3).
4. slice — the full-width ResNet50 (64×64×3, 200 classes, s2d stem,
   fused blocks, bf16) built on the card from a seed, served through
   ``ServingEngine`` to four client threads; every answer is held against
   ``model.output`` on the same rows, the kernel launch counters against
   36 + 16 launches per dispatched batch, and the f32 model with kernels
   against the same model on the plain path.
5. train — the same model trained by Nesterovs(1e-2, 0.9) in bf16 on one
   fixed random batch of 128 through ``make_scan_train_step`` (K = 4
   steps per call): the launch counters of one call grow by exactly
   K × (36, 16, 36, 13, 3, 3) for (fused_mm, fused_c3, fused_mm_bwd,
   fused_c3_bwd, fused_c3_bwd_in, fused_c3_bwd_w); over 24 steps every
   loss is finite and the best after the first is below the first; step
   ms, images/s and peak memory; and the f32 model's gradients at batch 8
   through the kernels against the same step on the plain versions.

It prints the kernels' JSON line, then the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Without a card (or without the
rest of the repository beside it) it exits non-zero and prints no result.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
from unittest import mock

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
# kernel vs plain version on the card: y elementwise |Δ| <= atol + rtol·|ref|
# (f32: both sum in f32, in different orders; bf16: the same f32 sums,
# then one rounding to bf16 that a last-bit difference can flip);
# statistics (f32 sums over M rows) |Δ| <= 1e-4·max|ref| + 1e-3
Y_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
# the f32 model through the kernels vs through the plain versions:
# pooled features, |Δ| <= 1e-4·(1 + max|ref|)
SLICE_F32_RTOL = 1e-4
# backward kernel vs plain version: dx elementwise as y above, relative to
# max|ref| (|Δ| <= atol·max|ref| + rtol·|ref|); dW, dscale, dshift (f32
# sums over M of the same rounded factors, in another order)
# |Δ| <= 1e-4·max|ref| + 1e-5
DX_TOL = Y_TOL
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
# the f32 train step through the kernels vs through the plain versions:
# the loss within LOSS_RTOL; the gradients, per parameter and over all of
# them, within relative L2 error max(GRAD_RTOL, GRAD_NOISE x the larger
# of the two paths' own errors when the batch rows are summed in another
# order). A random-init 50-layer BN stack at batch 8 amplifies f32
# summation-order differences (ReLU masks and max-pool choices that flip
# on a last-bit change) to 1-4% relative in its gradients (measured on
# an H100 by this script: plain vs plain on permuted rows 1.1% over all,
# 1.6% worst; kernels vs kernels 2.9% and 4.0%), so a fixed 1e-3 cannot
# hold for any two f32 implementations; a wiring fault (a lost statistics
# cotangent, a wrong route) moves gradients by O(1).
GRAD_RTOL, GRAD_NOISE, LOSS_RTOL = 1e-3, 3.0, 1e-5
_CSRC = "deeplearning4j_tpu_torch/csrc/"
SOURCES = {"fused_mm": _CSRC + "fused_mm.cu",
           "fused_c3": _CSRC + "fused_c3.cu",
           "fused_mm_bwd": _CSRC + "fused_mm_bwd.cu",
           "fused_c3_bwd": _CSRC + "fused_c3_bwd.cu",
           "fused_c3_bwd_in": _CSRC + "fused_c3_bwd.cu",
           "fused_c3_bwd_w": _CSRC + "fused_c3_bwd.cu"}
_TPU = "deeplearning4j_tpu/ops/fused_conv.py:"
REPLACES = {"fused_mm": _TPU + "57", "fused_c3": _TPU + "156",
            "fused_mm_bwd": _TPU + "230", "fused_c3_bwd": _TPU + "379",
            "fused_c3_bwd_in": _TPU + "317", "fused_c3_bwd_w": _TPU + "348"}
FORWARD = ("fused_mm", "fused_c3")
BACKWARD = ("fused_mm_bwd", "fused_c3_bwd", "fused_c3_bwd_in",
            "fused_c3_bwd_w")
TRAIN_BATCH, TRAIN_K, TRAIN_CALLS = 128, 4, 6     # 24 steps
N_REQUESTS = 64          # requests of 1-48 rows from four client threads
SLICE = dict(num_classes=200, height=64, width=64, channels=3,
             fused_blocks=True, fused_impl="pallas", s2d_stem=True,
             compute_dtype="bfloat16")


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, iters=20, warmup=3):
    """Mean ms of ``fn()`` on the card (CUDA events around ``iters``)."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def path_calls(conf, batch):
    """{call: count} of the fused-conv launches of one forward."""
    from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneckBlock
    calls = {}
    for node in conf.nodes:
        if isinstance(node.layer, FusedBottleneckBlock):
            it = conf.layer_input_type(node.name)
            for c in node.layer.kernel_calls(it, batch):
                calls[c] = calls.get(c, 0) + 1
    return calls


def call_cost(call, dtype):
    """(flops, bytes) the call must do: each input read once (the rows a
    strided 1×1 needs), each output written once."""
    n, h, w, cin = call.x_shape
    cout = call.w_shape[-1]
    isz = 2 if dtype == "bfloat16" else 4
    ho, wo = -(-h // call.stride), -(-w // call.stride)
    m = n * ho * wo
    k = cin * (9 if call.kernel == "fused_c3" else 1)
    flops = 2.0 * m * k * cout
    x_bytes = (n * h * w * cin if call.kernel == "fused_c3" else m * cin)
    nbytes = isz * (x_bytes + k * cout + m * cout) + 4 * (2 * cin + 2 * cout)
    return flops, nbytes


def check_kernel_call(call, dtype, gen):
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    dt = getattr(torch, dtype)
    cin = call.x_shape[3]
    fan_in = cin * (9 if call.kernel == "fused_c3" else 1)
    x = torch.randn(call.x_shape, generator=gen, device="cuda").to(dt)
    w = (torch.randn(call.w_shape, generator=gen, device="cuda")
         * math.sqrt(2.0 / fan_in)).to(dt)
    s = 1.0 + 0.1 * torch.randn(cin, generator=gen, device="cuda")
    b = 0.1 * torch.randn(cin, generator=gen, device="cuda")
    args = (x, w, s, b, call.relu_in, call.norm_in, call.stride)

    with torch.inference_mode():
        y, st = fc.fused_conv_bn_act(*args)
        yr, str_ = fc._conv_reference(*args)
        torch.cuda.synchronize()
        rtol, atol = Y_TOL[dtype]
        dy = (y.float() - yr.float()).abs()
        y_ok = bool((dy <= atol + rtol * yr.float().abs()).all())
        ds = (st - str_).abs().max().item()
        s_ok = ds <= STATS_RTOL * str_.abs().max().item() + STATS_ATOL
        res = {"kernel": call.kernel, "dtype": dtype,
               "x": list(call.x_shape), "w": list(call.w_shape),
               "stride": call.stride, "norm_in": call.norm_in,
               "max_abs_err": dy.max().item(), "stats_max_abs_err": ds,
               "ok": y_ok and s_ok}

        e = fc._norm_in(x, s, b, call.relu_in, call.norm_in)
        e_nchw = e.permute(0, 3, 1, 2)              # channels_last view
        w_oihw = (w.reshape(1, 1, *w.shape) if w.ndim == 2 else w) \
            .permute(3, 2, 0, 1)
        pad = 1 if call.kernel == "fused_c3" else 0

        # timed as the served path calls it (inference: no statistics);
        # the library yardstick is cuDNN's conv of the normalized input
        path_args = args + (False,)
        res["ms"] = cuda_time(lambda: fc.fused_conv_bn_act(*path_args))
        res["ms_with_stats"] = cuda_time(lambda: fc.fused_conv_bn_act(*args))
        res["plain_ms"] = cuda_time(lambda: fc._conv_reference(*path_args))
        res["library_ms"] = cuda_time(lambda: F.conv2d(
            e_nchw, w_oihw, stride=call.stride, padding=pad))
    flops, nbytes = call_cost(call, dtype)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    res["bound_ms"] = 1e3 * max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return res


def bwd_cost(call, dtype, part="both"):
    """(flops, bytes) of a backward call: dx and dW products 2·M·K·Cout
    each; dy, y, x and W read once, dx (x's full shape) and the f32 dW
    written once, plus the per-channel vectors. ``part`` "dx" or "dw"
    counts one launch of the split route."""
    n, h, w, cin = call.x_shape
    cout = call.w_shape[-1]
    isz = 2 if dtype == "bfloat16" else 4
    ho, wo = -(-h // call.stride), -(-w // call.stride)
    m = n * ho * wo
    k = cin * (9 if call.kernel == "fused_c3" else 1)
    x_rows = n * h * w if call.kernel == "fused_c3" else m
    reads = isz * (2 * m * cout + x_rows * cin) + 4 * (2 * cout + 2 * cin)
    dx = isz * (n * h * w * cin + k * cout) + 4 * 2 * cin
    dw = 4 * k * cout
    flops = {"both": 4.0, "dx": 2.0, "dw": 2.0}[part] * m * k * cout
    nbytes = reads + {"both": dx + dw, "dx": dx, "dw": dw}[part]
    return flops, nbytes


def bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _max_err(got, ref):
    return max((a.float() - r.float()).abs().max().item()
               for a, r in zip(got, ref))


def _bwd_ok(got, ref, dtype, with_dx):
    """dx elementwise (DX_TOL), the f32 sums against their largest entry;
    ``with_dx`` False: every output is a sum (the dW launch)."""
    ok = True
    for i, (a, r) in enumerate(zip(got, ref)):
        a, r = a.float(), r.float()
        d, big = (a - r).abs(), r.abs().max().item()
        if i == 0 and with_dx:
            rtol, atol = DX_TOL[dtype]
            ok &= bool((d <= atol * big + rtol * r.abs()).all())
        else:
            ok &= d.max().item() <= SUM_RTOL * big + SUM_ATOL
    return ok


def check_backward_call(call, dtype, gen):
    """Rows for the backward of one path call: ``fused_mm_bwd`` for a 1×1
    call; ``fused_c3_bwd``, ``fused_c3_bwd_in`` and ``fused_c3_bwd_w`` for
    a 3×3 call (both routes)."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    dt = getattr(torch, dtype)
    n, h, w, cin = call.x_shape
    cout = call.w_shape[-1]
    fan_in = cin * (9 if call.kernel == "fused_c3" else 1)
    x = torch.randn(call.x_shape, generator=gen, device="cuda").to(dt)
    wt = (torch.randn(call.w_shape, generator=gen, device="cuda")
          * math.sqrt(2.0 / fan_in)).to(dt)
    s = 1.0 + 0.1 * torch.randn(cin, generator=gen, device="cuda")
    b = 0.1 * torch.randn(cin, generator=gen, device="cuda")
    ho, wo = -(-h // call.stride), -(-w // call.stride)
    dy = torch.randn((n, ho, wo, cout), generator=gen, device="cuda").to(dt)
    y = torch.randn((n, ho, wo, cout), generator=gen, device="cuda").to(dt)
    dst = 1e-3 * torch.randn((2, cout), generator=gen, device="cuda")
    flags = (call.relu_in, call.norm_in)

    # the library yardstick's inputs: dyc and the normalized input
    xs = x[:, ::call.stride, ::call.stride] if call.stride != 1 else x
    dyc = fc._dyc(dy, y, dst)
    e = fc._norm_in(xs, s, b, *flags)
    if call.kernel == "fused_mm":
        d2, e2, wtt = dyc.reshape(-1, cout), e.reshape(-1, cin), wt.t()
        library = {"both": lambda: (torch.matmul(d2, wtt),
                                    torch.matmul(e2.t(), d2))}
        runs = {"fused_mm_bwd": (
            "both", True, lambda: fc.fused_mm_bwd(dy, y, x, wt, dst, s, b,
                                                  *flags, call.stride),
            lambda: fc.fused_mm_bwd_reference(dy, y, x, wt, dst, s, b,
                                              *flags, call.stride))}
    else:
        dyc_c, e_c = (t.permute(0, 3, 1, 2) for t in (dyc, e))
        w_oihw = wt.permute(3, 2, 0, 1)
        conv_bwd = lambda mask: lambda: torch.ops.aten.convolution_backward(
            dyc_c, e_c, w_oihw, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
            1, mask)
        library = {"both": conv_bwd([True, True, False]),
                   "dx": conv_bwd([True, False, False]),
                   "dw": conv_bwd([False, True, False])}
        args = (dy, y, x, wt, dst, s, b, *flags)
        wargs = (dy, y, x, dst, s, b, *flags)
        runs = {
            "fused_c3_bwd": ("both", True, lambda: fc.fused_c3_bwd(*args),
                             lambda: fc.fused_c3_bwd_reference(*args)),
            "fused_c3_bwd_in": ("dx", True, lambda: fc.fused_c3_bwd_in(*args),
                                lambda: fc.fused_c3_bwd_in_reference(*args)),
            "fused_c3_bwd_w": ("dw", False,
                               lambda: (fc.fused_c3_bwd_w(*wargs),),
                               lambda: (fc.fused_c3_bwd_w_reference(*wargs),)),
        }
    rows = []
    for name, (part, with_dx, kern, plain) in runs.items():
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        row = {"kernel": name, "dtype": dtype, "x": list(call.x_shape),
               "w": list(call.w_shape), "stride": call.stride,
               "norm_in": call.norm_in, "max_abs_err": _max_err(got, ref),
               "ok": _bwd_ok(got, ref, dtype, with_dx),
               "bitwise_repeat": all(torch.equal(a, c)
                                     for a, c in zip(got, again))}
        row["ms"] = cuda_time(kern)
        row["plain_ms"] = cuda_time(plain)
        row["library_ms"] = cuda_time(library[part])
        row["bound_ms"], row["bound_by"] = bound(*bwd_cost(call, dtype, part),
                                                 dtype)
        rows.append(row)
    return rows


def _summary(name, rows, launches=None):
    """One kernel's line: per bf16 train step (or served forward) at batch
    32, the sum over the path's calls of (value per call x calls)."""
    rs = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"
          and r["on_path"]]
    tot = lambda key: sum(r[key] * r["per_step"] for r in rs)
    by_ops = sum(r["bound_ms"] * r["per_step"] for r in rs
                 if r["bound_by"] == "operations")
    out = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name],
           "per_step": sum(r["per_step"] for r in rs),
           "max_abs_err": max(r["max_abs_err"] for r in rows
                              if r["kernel"] == name),
           "ms": tot("ms"), "plain_ms": tot("plain_ms"),
           "bound_ms": tot("bound_ms"),
           "bound_by": ("operations" if by_ops >= tot("bound_ms") / 2
                        else "bytes"),
           "library_ms": tot("library_ms")}
    if name in FORWARD:
        out["ms_with_stats"] = tot("ms_with_stats")
    return out


def phase_kernels(report):
    import torch
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    calls = path_calls(ResNet50(**SLICE).conf(), 32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for call, count in calls.items():
        for dtype in ("float32", "bfloat16"):
            r = check_kernel_call(call, dtype, gen)
            r.update(per_step=count, on_path=True)
            rows.append(r)
            log(f"  {r['kernel']:15s} {dtype:8s} x={tuple(r['x'])} "
                f"w={tuple(r['w'])} s={r['stride']} norm={int(r['norm_in'])}"
                f" err={r['max_abs_err']:.3g} stats_err="
                f"{r['stats_max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"stats_ms={r['ms_with_stats']:.4f} "
                f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
                f"bound={r['bound_ms']:.4f} ({r['bound_by']})"
                f"{'' if r['ok'] else '  <-- DISAGREES'}")
    for call, count in calls.items():
        # the route the train path takes (fc._backward's rule)
        merged = call.x_shape[3] <= fc.C3_MERGED_MAX_CIN and call.norm_in
        for dtype in ("float32", "bfloat16"):
            for r in check_backward_call(call, dtype, gen):
                r["per_step"] = count
                r["on_path"] = (r["kernel"] == "fused_mm_bwd" or merged ==
                                (r["kernel"] == "fused_c3_bwd"))
                rows.append(r)
                log(f"  {r['kernel']:15s} {dtype:8s} x={tuple(r['x'])} "
                    f"w={tuple(r['w'])} s={r['stride']} "
                    f"norm={int(r['norm_in'])} path={int(r['on_path'])} "
                    f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                    f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
                    f"bound={r['bound_ms']:.4f} ({r['bound_by']})"
                    f"{'' if r['ok'] else '  <-- DISAGREES'}"
                    f"{'' if r['bitwise_repeat'] else '  <-- NOT BITWISE'}")
    report["kernel_calls"] = rows
    bad = [r for r in rows if not r["ok"] or not r.get("bitwise_repeat",
                                                        True)]
    if bad:
        raise AssertionError(f"{len(bad)} kernel calls disagree with the "
                             "plain version beyond tolerance or differ "
                             "between two runs")
    summary = {name: _summary(name, rows) for name in SOURCES}
    report["kernels"] = summary
    return summary


# ---------------------------------------------------------------------------
# phase 4: the served slice
# ---------------------------------------------------------------------------

def nontrivial_bn(model, seed=0):
    """Running statistics (and BN affine params) from numpy, so the
    random-weight network keeps O(1) activations: the residual branches'
    last BN (bn3, bnds) gets a small gamma."""
    import numpy as np
    rng = np.random.default_rng(seed)
    params = {ln: {k: v.float().cpu().numpy() for k, v in lp.items()}
              for ln, lp in model.params.items()}
    state = {ln: {k: v.cpu().numpy() for k, v in st.items()}
             for ln, st in model.model_state.items()}
    for st in state.values():
        for k, v in st.items():
            if k.endswith("mean"):
                st[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k.endswith("var"):
                st[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    for lp in params.values():
        for k, v in lp.items():
            if k in ("bn3_gamma", "bnds_gamma"):
                lp[k] = rng.uniform(0.2, 0.4, v.shape).astype(np.float32)
            elif k.endswith("gamma"):
                lp[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k.endswith("beta"):
                lp[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return params, state


def plain_kernels():
    """Every kernel wrapper of ops/fused_conv.py patched to its plain
    version (the forward and the backward of ``fused_conv_bn_act``)."""
    import contextlib
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    plain = {"fused_mm": fc.fused_mm_reference,
             "fused_c3": fc.fused_c3_reference,
             "fused_mm_bwd": fc.fused_mm_bwd_reference,
             "fused_c3_bwd": fc.fused_c3_bwd_reference,
             "fused_c3_bwd_in": fc.fused_c3_bwd_in_reference,
             "fused_c3_bwd_w": fc.fused_c3_bwd_w_reference}
    stack = contextlib.ExitStack()
    for name, ref in plain.items():
        stack.enter_context(mock.patch.object(fc, name, ref))
    return stack


def profile_calls(fn, card, what, n=10, warmup=3):
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler),
    beside their wall time: the device's busy share of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0 and ev.device_type.name == "CUDA":
            rows.append((ev.key, dev_us / n / 1e3, ev.count // n))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"  profile over {n} {what} [{card}]: wall {wall_ms:.3f} ms/call, "
        f"device kernels {busy:.3f} ms/call (busy "
        f"{100 * busy / wall_ms:.1f}%)")
    for key, ms, count in rows[:16]:
        log(f"    {ms:8.4f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy,
            "kernels": [{"name": k, "ms": m, "per_call": c}
                        for k, m, c in rows]}


def phase_slice(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    t0 = time.perf_counter()
    model = ResNet50(**SLICE).init()           # cuda, seeded generator
    params_np, state_np = nontrivial_bn(model)
    params_from_jax(params_np, state_np, model.device, model=model)
    calls = path_calls(model.conf, 1)
    per_fwd = {k: sum(n for c, n in calls.items() if c.kernel == k)
               for k in FORWARD}
    log(f"  model: {model.num_params()} params on {model.device}, "
        f"{per_fwd} launches per forward, init {time.perf_counter() - t0:.1f}s")

    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, batch_limit=32, feature_shape=(64, 64, 3),
                           precision="bf16")
    log(f"  engine: ladder {engine.ladder}, warmup "
        f"{engine.warmup_seconds:.2f}s")
    rng = np.random.default_rng(1)
    sizes = rng.integers(1, 49, N_REQUESTS)
    reqs = [rng.normal(0, 1, (int(k), 64, 64, 3)).astype(np.float32)
            for k in sizes]
    answers = [None] * len(reqs)

    def client(idx):
        futs = [(i, engine.submit(reqs[i])) for i in idx]
        for i, f in futs:
            answers[i] = f.result()

    batches0 = engine.dispatch_count
    fc.reset_launch_counts()
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(range(t, len(reqs), 4),))
               for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    t_serve = time.perf_counter() - t_start
    launches = dict(fc.LAUNCHES)
    batches = engine.dispatch_count - batches0
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()

    # steady state: full buckets back to back from one client
    full = rng.normal(0, 1, (32, 64, 64, 3)).astype(np.float32)
    n_full = 40
    t1 = time.perf_counter()
    futs = [engine.submit(full) for _ in range(n_full)]
    for f in futs:
        f.result()
    t_full = time.perf_counter() - t1

    # device time of the served forward at batch 32 (kernels and all)
    xb = torch.from_numpy(full).cuda()
    fwd_ms = cuda_time(lambda: engine.forward(xb), iters=10)
    log(f"  served forward at batch 32: {fwd_ms:.3f} ms [{card}]")
    if profile:
        with torch.inference_mode():
            report["profile"] = profile_calls(
                lambda: engine.forward(xb), card,
                "bf16 forwards at batch 32")
    engine.shutdown()

    rows = int(sizes.sum())
    log(f"  served {len(reqs)} requests / {rows} images in {t_serve:.3f}s "
        f"over {batches} batches: {len(reqs) / t_serve:.1f} req/s, "
        f"{rows / t_serve:.1f} img/s, p50 {stats['latency_ms']['p50']:.2f} "
        f"ms, p99 {stats['latency_ms']['p99']:.2f} ms, peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  full buckets: {n_full} x 32 images in {t_full:.3f}s: "
        f"{n_full * 32 / t_full:.1f} img/s [{card}]")
    log(f"  launches during traffic: {launches} for {batches} batches")
    for k in FORWARD:
        if launches[k] != per_fwd[k] * batches or launches[k] == 0:
            raise AssertionError(
                f"{k}: {launches[k]} launches for {batches} batches, "
                f"expected {per_fwd[k]} per batch")

    # every answer against model.output on the same rows
    n_bitwise, worst, worst_top = 0, 0.0, 0
    for x, a in zip(reqs, answers):
        ref = model.output(x).float().cpu().numpy()
        if a is None or a.shape != ref.shape or not np.isfinite(a).all():
            raise AssertionError("missing, misshapen or non-finite answer")
        if np.array_equal(a, ref):
            n_bitwise += 1
        worst = max(worst, float(np.abs(a - ref).max()))
        worst_top += int((a.argmax(1) != ref.argmax(1)).sum())
    log(f"  answers vs model.output: {n_bitwise}/{len(reqs)} bitwise, "
        f"max |diff| {worst:.3g}, top-1 disagreements {worst_top}")
    if worst > 5e-3:
        raise AssertionError(f"served answers differ from model.output by "
                             f"{worst} (> 5e-3)")

    # f32 model: kernels vs plain versions on the card
    m32 = ResNet50(**dict(SLICE, compute_dtype="float32")).init()
    m32.set_params(model.params, model.model_state)
    x = torch.from_numpy(reqs[0][:8].copy()).cuda()
    walk = lambda: m32._walk(m32.params, m32.model_state, {"in": x})[0]
    with torch.inference_mode():
        a_k = walk()
        with plain_kernels():
            a_p = walk()
    feat_err = (a_k["avgpool"] - a_p["avgpool"]).abs().max().item()
    feat_max = a_p["avgpool"].abs().max().item()
    prob_err = (a_k["out"] - a_p["out"]).abs().max().item()
    log(f"  f32 kernels vs plain: pooled features |diff| {feat_err:.3g} "
        f"(max |ref| {feat_max:.3g}), probabilities |diff| {prob_err:.3g}")
    if not feat_err <= SLICE_F32_RTOL * (1.0 + feat_max):
        raise AssertionError("f32 slice through the kernels disagrees with "
                             "the plain path")

    report["slice"] = {
        "requests": len(reqs), "images": rows, "batches": batches,
        "seconds": t_serve, "requests_per_s": len(reqs) / t_serve,
        "images_per_s": rows / t_serve, "latency_ms": stats["latency_ms"],
        "full_bucket_images_per_s": n_full * 32 / t_full,
        "forward_ms_b32": fwd_ms, "peak_memory_bytes": peak,
        "launches": launches, "launches_per_forward": per_fwd,
        "bitwise_answers": n_bitwise, "max_answer_diff": worst,
        "f32_feature_diff": feat_err, "f32_prob_diff": prob_err}
    return launches


# ---------------------------------------------------------------------------
# phase 5: training the slice
# ---------------------------------------------------------------------------

def grad_errors(got, ref):
    """Relative L2 errors of gradient dicts: per parameter (worst, its
    name, median) and over all parameters at once."""
    import numpy as np
    errs, num, den = {}, 0.0, 0.0
    for ln, lp in ref.items():
        for key, r in lp.items():
            d = (got[ln][key] - r).double()
            num += float((d * d).sum())
            den += float((r.double() ** 2).sum())
            errs[f"{ln}/{key}"] = (d.norm() / r.double().norm().clamp_min(
                1e-30)).item()
    name = max(errs, key=errs.get)
    return {"worst": errs[name], "name": name,
            "median": float(np.median(list(errs.values()))),
            "all": (num / max(den, 1e-300)) ** 0.5}


def phase_train(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    model = ResNet50(**SLICE).init()           # cuda, seeded generator
    params_np, state_np = nontrivial_bn(model)
    params_from_jax(params_np, state_np, model.device, model=model)
    per_step = {}
    for call, n in path_calls(model.conf, 1).items():
        per_step[call.kernel] = per_step.get(call.kernel, 0) + n
        if call.kernel == "fused_mm":
            bwd = ["fused_mm_bwd"]
        elif call.x_shape[3] <= fc.C3_MERGED_MAX_CIN and call.norm_in:
            bwd = ["fused_c3_bwd"]
        else:
            bwd = ["fused_c3_bwd_in", "fused_c3_bwd_w"]
        for k in bwd:
            per_step[k] = per_step.get(k, 0) + n
    log(f"  model: {model.num_params()} params, launches per step "
        f"{per_step}")

    rng = np.random.default_rng(3)
    b, k = TRAIN_BATCH, TRAIN_K
    x = torch.from_numpy(rng.normal(0, 1, (b, 64, 64, 3)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(np.eye(200, dtype=np.float32)[
        rng.integers(0, 200, b)]).cuda()
    xk = x.unsqueeze(0).expand(k, *x.shape).contiguous()
    yk = y.unsqueeze(0).expand(k, *y.shape).contiguous()
    scan = model._build_scan_train_step()

    def call():
        model.train_state, losses = scan(model.train_state, (xk,), (yk,))
        return losses

    fc.reset_launch_counts()
    losses = [call()]
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    log(f"  launches over one {k}-step call: {launches}")
    for name, n in per_step.items():
        if launches[name] != k * n:
            raise AssertionError(f"{name}: {launches[name]} launches in one "
                                 f"{k}-step call, expected {k} x {n}")
    losses.append(call())                     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(TRAIN_CALLS - 2):
        losses.append(call())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ((TRAIN_CALLS - 2) * k)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    log(f"  train step at batch {b}: {step_ms:.3f} ms, "
        f"{1e3 * b / step_ms:.1f} images/s, peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  losses over {len(losses)} steps: "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    if not np.isfinite(losses).all() or not losses[1:].min() < losses[0]:
        raise AssertionError("the train loss did not fall (or is not "
                             "finite)")
    if model.iteration != TRAIN_CALLS * k:
        raise AssertionError(f"iteration {model.iteration}")
    if profile:
        report["train_profile"] = profile_calls(
            call, card, f"{k}-step bf16 train calls at batch {b}", n=2,
            warmup=1)

    # f32 at batch 8: the step's gradients through the kernels against
    # the same step on the plain versions, beside each path's own
    # summation-order noise (the same batch with its rows permuted)
    m32 = ResNet50(**dict(SLICE, compute_dtype="float32")).init()
    params_from_jax(params_np, state_np, m32.device, model=m32)
    x8, y8 = x[:8], y[:8]
    perm = torch.from_numpy(rng.permutation(len(x8))).cuda()
    grads = lambda xx, yy: solver.value_and_grad(
        m32._loss, m32.train_state, (xx,), (yy,))
    loss_k, _, g_k = grads(x8, y8)
    _, _, g_kq = grads(x8[perm], y8[perm])
    fc.reset_launch_counts()
    with plain_kernels():
        loss_p, _, g_p = grads(x8, y8)
        _, _, g_q = grads(x8[perm], y8[perm])
    if any(fc.LAUNCHES.values()):
        raise AssertionError("the plain step launched a kernel")
    err_k = grad_errors(g_k, g_p)
    err_q, err_kq = grad_errors(g_q, g_p), grad_errors(g_kq, g_k)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"  f32 step at batch 8, kernels vs plain: loss rel {loss_err:.3g}, "
        f"gradients rel L2 worst {err_k['worst']:.3g} ({err_k['name']}), "
        f"median {err_k['median']:.3g}, all {err_k['all']:.3g}")
    for what, e in (("plain", err_q), ("kernels", err_kq)):
        log(f"  {what} vs {what} on permuted rows: worst {e['worst']:.3g}, "
            f"median {e['median']:.3g}, all {e['all']:.3g}")
    for key in ("worst", "all"):
        limit = max(GRAD_RTOL, GRAD_NOISE * max(err_q[key], err_kq[key]))
        if err_k[key] > limit:
            raise AssertionError(f"f32 gradients through the kernels "
                                 f"disagree with the plain path ({key}: "
                                 f"{err_k[key]:.3g} > {limit:.3g})")
    if loss_err > LOSS_RTOL:
        raise AssertionError("f32 loss through the kernels disagrees with "
                             "the plain path")
    report["train"] = {
        "batch": b, "k": k, "steps": len(losses),
        "losses": losses.tolist(), "step_ms": step_ms,
        "images_per_s": 1e3 * b / step_ms, "peak_memory_bytes": peak,
        "launches": launches, "launches_per_step": per_step,
        "f32_loss_rel_err": loss_err, "f32_grad_rel_l2": err_k,
        "f32_grad_rel_l2_plain_permuted": err_q,
        "f32_grad_rel_l2_kernels_permuted": err_kq}
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="env,build,kernels,slice,train",
                    help="comma-separated subset of the phases to run")
    ap.add_argument("--profile", action="store_true",
                    help="also trace the served forward and the train "
                    "steps with torch.profiler")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # the port itself (fails in a directory without the repository)
    from deeplearning4j_tpu_torch.ops import cuda_build

    report = {}
    card = card_line()
    log(f"[env] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report["card"] = card

    if "build" in phases:
        t0 = time.perf_counter()
        cuda_build.build()
        report["build_seconds"] = time.perf_counter() - t0
        log(f"[build] {report['build_seconds']:.1f}s")
        for name, (sec, text) in cuda_build.build_log.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    summary = {}
    if "kernels" in phases:
        log("[kernels] every path shape at batch 32, f32 and bf16")
        summary = phase_kernels(report)

    launches = {name: 0 for name in SOURCES}
    if "slice" in phases:
        log("[slice] ResNet50 64x64x3/200 bf16 served through ServingEngine")
        for name, n in phase_slice(report, card, args.profile).items():
            launches[name] += n
    if "train" in phases:
        log(f"[train] ResNet50 64x64x3/200 bf16, batch {TRAIN_BATCH}, "
            f"K={TRAIN_K} steps per call")
        for name, n in phase_train(report, card, args.profile).items():
            launches[name] += n

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    kernels = []
    for name, k in summary.items():
        entry = {key: k[key] for key in
                 ("name", "route", "source", "replaces")}
        # the served traffic's launches plus the train phase's K-step call
        entry["launches"] = launches[name]
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            entry[key] = k[key]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
