#!/usr/bin/env python3
"""Probes of the PyTorch/CUDA port's 3×3 conv kernels on one NVIDIA GPU,
beside ``chip_smoke.py``. Each runs against the tree in the working
directory, so one copy of this script measures a parent tree and its
change alike (run it from each tree's root):

    python3 tools/port_probe.py host [TAG]      # host cost of the wrappers
    python3 tools/port_probe.py bwd [TAG]       # fused_c3_bwd, bf16, timed
    python3 tools/port_probe.py one-grid DIR    # write the one-grid variant

``host``: host µs a call of ``fused_c3`` (served path, and with the
statistics) and ``fused_c3_bwd`` at the ResNet50's 3×3 shapes (host clock
over back-to-back calls, then with the synchronize), the host and
synchronized ms of a 4-step bf16 ResNet50 train call at batch 128, and
``torch.profiler``'s CPU table of one such call.

``bwd``: wall (CUDA events) and device (profiler) ms a call of the bf16
``fused_c3_bwd`` at the 3×3 shapes at batch 32 and 128, and its error
against the plain version relative to the largest reference entry.

``one-grid DIR``: copy the tree into DIR with ``fused_c3_bwd``'s dx and
dW tiles in one grid (one kernel for both products, dyc first) in place
of two; a timing variant of ``csrc/c3_bwd.cuh``'s design, not part
of the port. Time it with ``bwd`` from DIR.
"""

from __future__ import annotations

import os
import re
import shutil
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

    def host_us(fn, n=200):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / n, 1e6 * (time.perf_counter() - t0) / n

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


def _sub(text, old, new):
    if old not in text:
        raise SystemExit(f"one-grid: the source no longer holds {old[:60]!r}")
    return text.replace(old, new)


def one_grid(dest):
    """The variant: dx_mma_kernel's body and dw_mma_kernel's become device
    functions of the tile's indices and shared memory, and one kernel runs
    both kinds of tile (dx tiles first)."""
    root = os.getcwd()
    # the source tree only: no git data, build outputs or run logs
    shutil.copytree(root, dest, ignore=shutil.ignore_patterns(
        ".git", "build", "*_out", "__pycache__"))
    csrc = os.path.join(dest, "deeplearning4j_tpu_torch", "csrc")
    p = os.path.join(csrc, "c3_bwd_in.cuh")
    s = open(p).read()
    head = ("__global__ void __launch_bounds__(kMmaThreads) "
            "dx_mma_kernel(InArgs a) {\n  __shared__ __align__(16) "
            "__nv_bfloat16 ring[kStages * kStageElems];")
    a = s.index(head)
    b = s.index("// f32: the same tile and slice with conv_bwd.cuh's")
    body = s[a:b].replace(head, (
        "__device__ __forceinline__ void dx_mma_tile(const InArgs& a, "
        "__nv_bfloat16* ring, int bx, int by, int bz) {"))
    body = re.sub(r"blockIdx\.([xyz])", r"b\1", body)
    body += ("__global__ void __launch_bounds__(kMmaThreads) dx_mma_kernel("
             "InArgs a) {\n  __shared__ __align__(16) __nv_bfloat16 "
             "ring[kStages * kStageElems];\n  dx_mma_tile(a, ring, "
             "blockIdx.x, blockIdx.y, blockIdx.z);\n}\n\n")
    open(p, "w").write(s[:a] + body + s[b:])

    p = os.path.join(csrc, "c3_bwd.cuh")
    s = open(p).read()
    s = _sub(s, """__global__ void __launch_bounds__(kMmaThreads) dw_mma_kernel(DwArgs d) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kDepth * kRow];
  __shared__ __align__(16) __nv_bfloat16 Bs[kStages][kDepth * kRow];
  const int r0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int kb = blockIdx.z * d.chunk;""", """__device__ __forceinline__ void dw_mma_tile(const DwArgs& d,
    __nv_bfloat16* smem, int bx, int by, int bz) {
  auto As = reinterpret_cast<__nv_bfloat16 (*)[kDepth * kRow]>(smem);
  auto Bs = As + 2;
  const int r0 = bx * kTile, n0 = by * kTile;
  const int kb = bz * d.chunk;""")
    s = _sub(s, "float* out = d.out + (long long)blockIdx.z * d.rows",
             "float* out = d.out + (long long)bz * d.rows")
    s = _sub(s, "// The whole bf16 backward on `stream`", """constexpr int kSmem =
    bwd_in::kStages * bwd_in::kStageElems > (2 + kStages) * kDepth * kRow
        ? bwd_in::kStages * bwd_in::kStageElems
        : (2 + kStages) * kDepth * kRow;

__global__ void __launch_bounds__(kMmaThreads) products_kernel(
    bwd_in::InArgs a, DwArgs d, int dx_mt, int dx_ct, int dx_blocks,
    int dw_rt, int dw_nt) {
  __shared__ __align__(16) __nv_bfloat16 smem[kSmem];
  int b = blockIdx.x;
  if (b < dx_blocks) {
    bwd_in::dx_mma_tile(a, smem, b % dx_mt, (b / dx_mt) % dx_ct,
                        b / dx_mt / dx_ct);
    return;
  }
  b -= dx_blocks;
  dw_mma_tile(d, smem, b % dw_rt, (b / dw_rt) % dw_nt, b / dw_rt / dw_nt);
}

// The whole bf16 backward on `stream`""")
    a = s.index("  err = bwd_in::launch_in_product<__nv_bfloat16>(a, stream);")
    b = s.index("  err = bwd_in::launch_in_epilogue<__nv_bfloat16>(a, stream);")
    s = s[:a] + """  {
    const BwdArgs& q = a.p;
    const long long chunks = ((long long)q.M * q.cout + 7) / 8;
    const long long eb = (chunks + bwd_in::kEpiThreads - 1) /
                         bwd_in::kEpiThreads;
    bwd_in::dyc_kernel<<<static_cast<unsigned>(eb < 1024 ? eb : 1024),
                         bwd_in::kEpiThreads, 0, stream>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int dx_mt = (q.M + 63) / 64, dx_ct = (q.cin + 63) / 64;
    const int dx_blocks = dx_mt * dx_ct * a.slices;
    products_kernel<<<static_cast<unsigned>(dx_blocks + rt * nt * dw_slices),
                      kMmaThreads, 0, stream>>>(
        a, d, dx_mt, dx_ct, dx_blocks, static_cast<int>(rt),
        static_cast<int>(nt));
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
""" + s[b:]
    open(p, "w").write(s)
    print(f"one-grid variant written to {dest}")


def main(argv):
    if len(argv) < 2 or argv[1] not in ("host", "bwd", "one-grid"):
        raise SystemExit(__doc__)
    if argv[1] == "one-grid":
        if len(argv) != 3:
            raise SystemExit("one-grid needs a destination directory")
        return one_grid(argv[2])
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("port_probe: no CUDA device is available")
    tag = argv[2] if len(argv) > 2 else os.path.basename(os.getcwd())
    return host(tag) if argv[1] == "host" else bwd(tag)


if __name__ == "__main__":
    main(sys.argv)
