#!/usr/bin/env python3
"""Probes of the PyTorch/CUDA port's conv kernels on one NVIDIA GPU, beside
``chip_smoke.py``. Each runs against the tree in the working directory, so
one copy of this script measures a parent tree and its change alike (run
it from each tree's root):

    python3 tools/port_probe.py host [TAG]      # host cost of the wrappers
    python3 tools/port_probe.py bwd [TAG]       # fused_c3_bwd, bf16, timed
    python3 tools/port_probe.py slices [TAG]    # fused_mm's slice depth

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
"""

from __future__ import annotations

import os
import sys
import time

SHAPES = ((16, 64), (8, 128), (4, 256), (2, 512))   # (H = W, Cin = Cout)


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


def main(argv):
    if len(argv) < 2 or argv[1] not in ("host", "bwd", "slices"):
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("port_probe: no CUDA device is available")
    tag = argv[2] if len(argv) > 2 else os.path.basename(os.getcwd())
    return {"host": host, "bwd": bwd, "slices": slices}[argv[1]](tag)


if __name__ == "__main__":
    main(sys.argv)
