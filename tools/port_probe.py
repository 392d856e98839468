#!/usr/bin/env python3
"""Probes of the PyTorch/CUDA port's kernels on one NVIDIA GPU, beside
``chip_smoke.py``. Each runs against the tree in the working directory, so
one copy of this script measures a parent tree and its change alike (run
it from each tree's root):

    python3 tools/port_probe.py host [TAG]      # host cost of the wrappers
    python3 tools/port_probe.py bwd [TAG]       # fused_c3_bwd, bf16, timed
    python3 tools/port_probe.py slices [TAG]    # fused_mm's slice depth
    python3 tools/port_probe.py lstm [TAG]      # the LSTM kernels' ticks
    python3 tools/port_probe.py plans [TAG]     # lstm_fwd's plan candidates
    python3 tools/port_probe.py flash [TAG]     # the flash backward pair

``host``: host µs a call of ``fused_c3`` (served path, and with the
statistics) and ``fused_c3_bwd`` at the ResNet50's 3×3 shapes, and of
``fused_mm`` (the same two ways) and ``fused_mm_bwd`` at its 1×1 shapes,
bf16 at batch 32 and 128 (host clock over 100 back-to-back calls, then
with the synchronize; the least of five such runs); the host and
synchronized ms of a 4-step bf16 ResNet50 train call at batch 128, and
``torch.profiler``'s CPU table of one such call.

``bwd``: wall (CUDA events) and device (profiler) ms a call of the bf16
``fused_c3_bwd`` at the 3×3 shapes and of ``fused_mm_bwd`` at the 1×1
shapes, at batch 32 and 128, each with its error against the plain
version relative to the largest reference entry, and the 1×1 per-step
sums.

``slices``: device ms (profiler) of the served bf16 ``fused_mm`` at every
1×1 path shape with Cin above 128, at batch 32 and 128, for each candidate
``fused_conv.MM_SLICE_DEPTH`` (the depth its K slices are cut to), and the
per-step sum at each batch: the measurement that sets that constant.

``lstm``: wall (CUDA events) and device (profiler) ms a call of
``lstm_fwd`` and ``lstm_bwd`` at ``chip_smoke.LSTM_SHAPES``, f32 and bf16,
unmasked; then, in a child process, the ``clock64()`` breakdown of both
kernels by phase: ``csrc/`` is copied under ``build/probe/``, the
kernels' ``LSTM_PROBE(k)`` marks are defined to add the cycles since the
last mark to slot k, for thread 0 of block (0, 0), and ``lstm_fwd.cu`` and
``lstm_bwd.cu`` are built with them into libraries of their own, which the
tree's ``fused_lstm`` wrappers then call. Per tick phases are cycles a
tick, the others cycles a call, at the card's clock attribute. A tree
whose kernel source has no marks reads zeros.

``plans``: device ms (profiler) a call of ``lstm_fwd`` at
``chip_smoke.LSTM_SHAPES`` and at one generated char (T 1, N 1, H 256), f32
and bf16, unmasked, under each candidate plan
(``fused_lstm.lstm_fwd_candidate``): the cluster route at every U (a
power of two, a cluster of at most 16 blocks) and the grid route at every
U, each with as many row tiles as the card keeps resident; beside the plan
``fused_lstm.lstm_fwd_plan`` picks. The measurement behind the plan's
rule.

``flash``: wall (CUDA events) and device (profiler) ms a call of the bf16
``flash_bwd_dkv`` and ``flash_bwd_dq`` at ``FLASH_SHAPES`` (H 12, Dh 64,
unmasked; not causal, and causal at T 4096), on the strided views
``chip_smoke.attn_inputs`` cuts, beside the device ms of SDPA's autograd
backward (dq, dk and dv together) on the same tensors.
"""

from __future__ import annotations

import os
import sys
import time

SHAPES = ((16, 64), (8, 128), (4, 256), (2, 512))   # (H = W, Cin = Cout)
# (N, T) of the flash probe: bert_train's calls, twice that batch, and the
# longest sequence of chip_smoke.ATTN_LONG
FLASH_SHAPES = ((32, 128), (64, 128), (4, 4096))


def _tree():
    sys.path.insert(0, os.getcwd())
    import torch
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, fc


def _inputs(torch, g, n, h, c):
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    x, dy, y = (r(n, h, h, c).bfloat16() for _ in range(3))
    w = (0.05 * r(3, 3, c, c)).bfloat16()
    return (x, w, 1 + 0.1 * r(c), 0.1 * r(c), dy, y, 1e-3 * r(2, c))


def host(tag):
    torch, fc = _tree()
    import chip_smoke as cs
    g = torch.Generator(device="cuda").manual_seed(0)

    def host_us(fn, n=100, repeats=5):
        """(host µs, synchronized µs) a call: the least over ``repeats``
        runs of ``n`` back-to-back calls, since other work on a shared
        host only ever adds time."""
        for _ in range(5):
            fn()
        best = (float("inf"), float("inf"))
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            best = min(best, (1e6 * (t1 - t0) / n,
                              1e6 * (time.perf_counter() - t0) / n))
        return best

    for n in (32, 128):
        for h, c in SHAPES:
            x, w, s, b, dy, y, dst = _inputs(torch, g, n, h, c)
            with torch.inference_mode():
                served = host_us(lambda: fc.fused_conv_bn_act(
                    x, w, s, b, True, True, 1, False))
            stats = host_us(lambda: fc.fused_c3(x, w, s, b))
            bwd = host_us(lambda: fc.fused_c3_bwd(dy, y, x, w, dst, s, b))
            print(f"{tag} host x=({n},{h},{h},{c}) fused_c3 served "
                  f"{served[0]:.1f} us (synced {served[1]:.1f}), with "
                  f"stats {stats[0]:.1f} ({stats[1]:.1f}); fused_c3_bwd "
                  f"{bwd[0]:.1f} ({bwd[1]:.1f})", flush=True)
        for call in _mm_calls(cs, n):
            x, w, s, b, dy, y, dst = _mm_inputs(torch, g, call)
            flags = (call.relu_in, call.norm_in, call.stride)
            with torch.inference_mode():
                served = host_us(lambda: fc.fused_conv_bn_act(
                    x, w, s, b, *flags, False))
            stats = host_us(lambda: fc.fused_mm(x, w, s, b, *flags))
            bwd = host_us(lambda: fc.fused_mm_bwd(dy, y, x, w, dst, s, b,
                                                  *flags))
            print(f"{tag} host x={call.x_shape} w={call.w_shape} "
                  f"s={call.stride} fused_mm served {served[0]:.1f} us "
                  f"(synced {served[1]:.1f}), with stats {stats[0]:.1f} "
                  f"({stats[1]:.1f}); fused_mm_bwd {bwd[0]:.1f} "
                  f"({bwd[1]:.1f})", flush=True)

    import numpy as np
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    model = ResNet50(**cs.SLICE).init()
    params_np, state_np = cs.nontrivial_bn(model)
    params_from_jax(params_np, state_np, model.device, model=model)
    rng = np.random.default_rng(3)
    bsz, k = cs.TRAIN_BATCH, cs.TRAIN_K
    x = torch.from_numpy(rng.normal(0, 1, (bsz, 64, 64, 3)).astype(
        np.float32)).cuda()
    lab = torch.from_numpy(np.eye(200, dtype=np.float32)[
        rng.integers(0, 200, bsz)]).cuda()
    xk = x.unsqueeze(0).expand(k, *x.shape).contiguous()
    yk = lab.unsqueeze(0).expand(k, *lab.shape).contiguous()
    scan = model._build_scan_train_step()

    def call():
        model.train_state, _ = scan(model.train_state, (xk,), (yk,))

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"{tag} train call: host {1e3 * (t1 - t0):.1f} ms, synced "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=12, max_name_column_width=50))


def bwd(tag):
    torch, fc = _tree()
    import chip_smoke as cs
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in (32, 128):
        for h, c in SHAPES:
            x, w, s, b, dy, y, dst = _inputs(torch, g, n, h, c)
            kern = lambda: fc.fused_c3_bwd(dy, y, x, w, dst, s, b)
            got = kern()
            ref = fc.fused_c3_bwd_reference(dy, y, x, w, dst, s, b)
            err = max((a.float() - r.float()).abs().max().item()
                      / max(1e-30, r.float().abs().max().item())
                      for a, r in zip(got, ref))
            print(f"{tag} fused_c3_bwd bf16 x=({n},{h},{h},{c}) wall "
                  f"{cs.cuda_time(kern, iters=50):.4f} device "
                  f"{cs.device_ms(kern, n=20):.4f} ms, rel err {err:.3g}",
                  flush=True)
        step = 0.0
        for call, count in _mm_calls(cs, n).items():
            x, w, s, b, dy, y, dst = _mm_inputs(torch, g, call)
            flags = (call.relu_in, call.norm_in, call.stride)
            kern = lambda: fc.fused_mm_bwd(dy, y, x, w, dst, s, b, *flags)
            got = kern()
            ref = fc.fused_mm_bwd_reference(dy, y, x, w, dst, s, b, *flags)
            err = max((a.float() - r.float()).abs().max().item()
                      / max(1e-30, r.float().abs().max().item())
                      for a, r in zip(got, ref))
            dev = cs.device_ms(kern, n=20)
            step += dev * count
            print(f"{tag} fused_mm_bwd bf16 x={call.x_shape} "
                  f"w={call.w_shape} s={call.stride} wall "
                  f"{cs.cuda_time(kern, iters=50):.4f} device {dev:.4f} ms, "
                  f"rel err {err:.3g}", flush=True)
        print(f"{tag} fused_mm_bwd bf16 batch {n}: {step:.4f} ms of device "
              "time a step", flush=True)


def _mm_calls(cs, n):
    """{call: count a step} of the 1×1 calls of the ResNet50 path at batch
    ``n``."""
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    conf = ResNet50(**cs.SLICE).conf()
    return {c: count for c, count in cs.path_calls(conf, n).items()
            if c.kernel == "fused_mm"}


def _mm_inputs(torch, g, call):
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    n, h, w, cin = call.x_shape
    cout = call.w_shape[1]
    ho, wo = -(-h // call.stride), -(-w // call.stride)
    return (r(*call.x_shape).bfloat16(), (0.05 * r(cin, cout)).bfloat16(),
            1 + 0.1 * r(cin), 0.1 * r(cin), r(n, ho, wo, cout).bfloat16(),
            r(n, ho, wo, cout).bfloat16(), 1e-3 * r(2, cout))


def slices(tag):
    torch, fc = _tree()
    import chip_smoke as cs
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in (32, 128):
        calls = {c: count for c, count in _mm_calls(cs, n).items()
                 if c.x_shape[3] > 128}
        ins = {c: _mm_inputs(torch, g, c) for c in calls}
        for depth in (128, 256, 512, 1024):
            fc.MM_SLICE_DEPTH = depth
            fc.mm_slices.cache_clear()
            fc._mm_split.cache_clear()
            step = 0.0
            for c in calls:
                x, w, s, b = ins[c][:4]
                flags = (c.relu_in, c.norm_in, c.stride)
                with torch.inference_mode():
                    ms = cs.device_ms(lambda: fc.fused_conv_bn_act(
                        x, w, s, b, *flags, False), n=20)
                step += ms * calls[c]
                print(f"{tag} slices depth={depth} x={c.x_shape} "
                      f"w={c.w_shape} s={c.stride} K slices "
                      f"{fc.mm_slices(c.x_shape[3])[0]}: device {ms:.4f} ms",
                      flush=True)
            print(f"{tag} slices depth={depth} batch {n}: {step:.4f} ms of "
                  f"device time a step", flush=True)


def _lstm_inputs(torch, g, t, n, h, dtype):
    """lstm_bwd's arguments at (T, N, H), unmasked, from lstm_fwd's plain
    version (as chip_smoke.check_lstm_shape makes them)."""
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    zx = r(t, n, 4 * h).to(dtype)
    wh = (r(h, 4 * h) / h ** 0.5).to(dtype)
    h0, c0 = (0.5 * r(n, h)).to(dtype), (0.5 * r(n, h)).to(dtype)
    ys, gates, tcs, ccs, _, _ = fl.lstm_fwd_reference(zx, h0, c0, wh)
    fargs = (zx, h0, c0, wh, None)
    bargs = (r(t, n, h).to(dtype), r(n, h).to(dtype), r(n, h).to(dtype),
             gates, tcs, torch.cat([c0[None], ccs[:-1]]),
             torch.cat([h0[None], ys[:-1]]), None, wh)
    return fargs, bargs


def lstm(tag):
    torch, _ = _tree()
    import subprocess
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    g = torch.Generator(device="cuda").manual_seed(0)
    for t, n, h in cs.LSTM_SHAPES.values():
        for dtype in (torch.float32, torch.bfloat16):
            fargs, bargs = _lstm_inputs(torch, g, t, n, h, dtype)
            for name, args in (("lstm_fwd", fargs), ("lstm_bwd", bargs)):
                kern = lambda: getattr(fl, name)(*args)
                print(f"{tag} {name} {str(dtype)[6:]} T,N,H={t},{n},{h} "
                      f"wall {cs.cuda_time(kern, iters=10):.4f} device "
                      f"{cs.device_ms(kern, n=10):.4f} ms", flush=True)
    subprocess.run([sys.executable, os.path.abspath(__file__), "lstm-clock",
                    tag], check=True)


# The phases of each LSTM kernel by its LSTM_PROBE slots, and those of a
# tick (the forward's "inputs": the wait for the tick's zx tile and the
# block barrier after the product; on the grid route the product holds
# the staging of h's chunks).
_PROBE_SLOTS = {
    "lstm_fwd": {0: "setup", 1: "product", 6: "inputs", 2: "gate update",
                 3: "barrier", 7: "next inputs issued", 4: "exchange",
                 5: "hT, cT"},
    "lstm_bwd": {9: "setup", 6: "inputs", 1: "dz", 10: "dh product",
                 2: "dh groups summed", 3: "barrier", 4: "exchange",
                 8: "dh0, dc0", 5: "dWh", 7: "dWh slices summed"}}
_PROBE_TICK = {"lstm_fwd": {"product", "inputs", "gate update", "barrier",
                            "next inputs issued", "exchange"},
               "lstm_bwd": {"inputs", "dz", "dh product", "dh groups summed",
                            "barrier", "exchange"}}
# Every thread keeps its slots' cycles in registers (constant indices once
# unrolled); thread 0 of block (0, 0) adds them to the device array at the
# kernel's end.
_PROBE_HEADER = r"""#include <cuda_runtime.h>
__device__ long long dl4j_probe_acc[16];
#define LSTM_PROBE_START()                                             \
  long long probe_acc_[16] = {0};                                      \
  long long probe_last_ = clock64()
#define LSTM_PROBE(k)                                                  \
  do {                                                                 \
    const long long c_ = clock64();                                    \
    probe_acc_[k] += c_ - probe_last_;                                 \
    probe_last_ = c_;                                                  \
  } while (0)
#define LSTM_PROBE_END()                                               \
  do {                                                                 \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {      \
      _Pragma("unroll") for (int k_ = 0; k_ < 16; ++k_)                \
        dl4j_probe_acc[k_] += probe_acc_[k_];                          \
    }                                                                  \
  } while (0)
extern "C" int dl4j_probe_read(long long* out) {
  return cudaMemcpyFromSymbol(out, dl4j_probe_acc, sizeof(dl4j_probe_acc));
}
extern "C" int dl4j_probe_reset() {
  long long z[16] = {0};
  return cudaMemcpyToSymbol(dl4j_probe_acc, z, sizeof(z));
}
extern "C" int dl4j_probe_clock_khz() {
  int dev = 0, khz = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  return khz;
}
"""


def _probe_library(cuda_build, source):
    """csrc/<source>.cu built with its LSTM_PROBE marks as clock64()
    timers; returns the library's path."""
    import shutil
    import subprocess
    from pathlib import Path
    out = Path(cuda_build.BUILD_DIR).parent / "probe" / source
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, out / "csrc")
    (out / "probe.cuh").write_text(_PROBE_HEADER)
    lib = out / f"lib{source}_probe.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-include",
                    str(out / "probe.cuh"), "-o", str(lib),
                    str(out / "csrc" / f"{source}.cu")],
                   check=True, capture_output=True, text=True)
    return lib


def lstm_clock(tag):
    torch, _ = _tree()
    import ctypes
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    libs = {}
    for source in ("lstm_fwd", "lstm_bwd"):
        lib = ctypes.CDLL(str(_probe_library(cuda_build, source)))
        sym, argtypes = cuda_build.SIGNATURES[source]
        getattr(lib, sym).argtypes = argtypes
        getattr(lib, sym).restype = ctypes.c_int
        for helper, types in cuda_build._HELPERS.items():
            if hasattr(lib, helper):
                getattr(lib, helper).argtypes = types
                getattr(lib, helper).restype = ctypes.c_int
        cuda_build._libs[source] = libs[source] = lib
    khz = libs["lstm_bwd"].dl4j_probe_clock_khz()
    g = torch.Generator(device="cuda").manual_seed(0)
    calls = 5
    for t, n, h in cs.LSTM_SHAPES.values():
        for dtype in (torch.float32, torch.bfloat16):
            fargs, bargs = _lstm_inputs(torch, g, t, n, h, dtype)
            for name, args in (("lstm_fwd", fargs), ("lstm_bwd", bargs)):
                lib = libs[name]
                getattr(fl, name)(*args)
                torch.cuda.synchronize()
                lib.dl4j_probe_reset()
                for _ in range(calls):
                    getattr(fl, name)(*args)
                torch.cuda.synchronize()
                acc = (ctypes.c_longlong * 16)()
                lib.dl4j_probe_read(acc)
                parts = []
                tick = 0.0
                for slot, what in _PROBE_SLOTS[name].items():
                    in_tick = what in _PROBE_TICK[name]
                    per = acc[slot] / calls / (t if in_tick else 1)
                    tick += per if in_tick else 0.0
                    parts.append(f"{what} {per:.0f} cyc ({1e3 * per / khz:.2f}"
                                 f" us){' a tick' if in_tick else ''}")
                print(f"{tag} clock64 {name} {str(dtype)[6:]} T,N,H={t},{n},"
                      f"{h} at {khz / 1e3:.0f} MHz: " + "; ".join(parts) +
                      f"; tick {tick:.0f} cyc ({1e3 * tick / khz:.2f} us)",
                      flush=True)


def plans(tag):
    torch, _ = _tree()
    from unittest import mock
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = list(cs.LSTM_SHAPES.values()) + [(1, 1, 256)]
    for t, n, h in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            fargs, _ = _lstm_inputs(torch, g, t, n, h, dtype)
            chosen = fl.lstm_fwd_plan(t, n, h, bf16, sms)
            cands = []
            units = 8
            while units <= max(8, 1 << (h - 1).bit_length()):
                slices = -(-h // units)
                tiles = fl._cluster_limit(slices, sms)
                if tiles:
                    cands.append(("cluster", units, -(-n // min(tiles, n))))
                if slices <= sms:
                    cands.append(("grid", units,
                                  -(-n // min(sms // slices, n))))
                units *= 2
            for route, units, rows in cands:
                plan = fl.lstm_fwd_candidate(route, units, rows, n, h, bf16)
                if plan is None:
                    continue
                with mock.patch.object(fl, "lstm_fwd_plan",
                                       lambda *a, plan=plan: plan):
                    kern = lambda: fl.lstm_fwd(*fargs)
                    ms = cs.device_ms(kern, n=10)
                print(f"{tag} plans lstm_fwd {str(dtype)[6:]} T,N,H={t},{n},"
                      f"{h} {route} slices={plan.slices} U={units} "
                      f"RB={rows} row_tiles={plan.row_tiles} chunk="
                      f"{plan.chunk}x{plan.stages} groups={plan.groups} "
                      f"smem={plan.smem}: device {ms:.4f} ms"
                      f"{'  <- the plan' if plan == chosen else ''}",
                      flush=True)


def flash(tag):
    torch, _ = _tree()
    import torch.nn.functional as F
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(0)
    for n, t in FLASH_SHAPES:
        for mode in ("none", "causal") if t > 1024 else ("none",):
            q, k, v, do, mask, causal = cs.attn_inputs(n, t, 12, 64,
                                                       "bfloat16", mode, g)
            out, lse = fa.flash_fwd_reference(q, k, v, mask, causal)
            args = (q, k, v, mask, do, lse, fa.attention_delta(do, out),
                    causal)
            iters = 5 if t > 1024 else 50
            row = []
            for name in ("flash_bwd_dkv", "flash_bwd_dq"):
                kern = lambda: getattr(fa, name)(*args)
                row.append(f"{name} wall {cs.cuda_time(kern, iters=iters):.4f}"
                           f" device {cs.device_ms(kern, n=iters):.4f}")
            qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            lib = lambda: torch.autograd.grad(og, (qg, kg, vg),
                                              do.transpose(1, 2),
                                              retain_graph=True)
            print(f"{tag} bf16 N,T,H,Dh={n},{t},12,64 {mode}: "
                  + ", ".join(row) + f"; SDPA backward device "
                  f"{cs.device_ms(lib, n=iters):.4f} ms", flush=True)


def main(argv):
    runs = {"host": host, "bwd": bwd, "slices": slices, "lstm": lstm,
            "lstm-clock": lstm_clock, "plans": plans, "flash": flash}
    if len(argv) < 2 or argv[1] not in runs:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("port_probe: no CUDA device is available")
    tag = argv[2] if len(argv) > 2 else os.path.basename(os.getcwd())
    return runs[argv[1]](tag)


if __name__ == "__main__":
    main(sys.argv)
