#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is passed over:

1. environment — card name and power limit, torch/CUDA versions; TF32 off.
2. build — ``nvcc`` builds every kernel of the path from ``csrc/`` (one
   process per source, all at once); prints each kernel's registers and
   spills from ``-Xptxas -v`` and, by ``cuobjdump -sass``, the HMMA
   (tensor-core) instructions in the libraries of ``fused_mm``,
   ``fused_c3``, ``fused_mm_bwd``, ``fused_c3_bwd`` (with
   ``fused_c3_bwd_in`` and ``fused_c3_bwd_w``), ``lstm_fwd``,
   ``lstm_bwd``, ``flash_fwd`` and ``flash_bwd_dkv`` (with
   ``flash_bwd_dq``); it fails if one holds none.
3. kernels — ``fused_mm`` and ``fused_c3`` at every distinct shape the
   ResNet50 gives them at batch 32, in float32 and bfloat16, held against
   their plain PyTorch versions on the card and run twice for
   bitwise-equal results; kernel, plain and library-yardstick (cuDNN conv
   of the normalized input) times, by CUDA events around back-to-back calls
   as the path makes them, beside each call's bound. Then the backward
   kernels at the same shapes on random
   dy, y and dstats: ``fused_mm_bwd`` for every 1×1 call, and at every 3×3
   shape BOTH routes (``fused_c3_bwd`` in one call, ``fused_c3_bwd_in``
   + ``fused_c3_bwd_w`` in two), each held against its plain version (dx,
   dW, dscale, dshift), run twice for bitwise-equal results, and timed
   beside its bound, its plain version and a library yardstick
   (``torch.matmul`` for 1×1, cuDNN's ``convolution_backward`` for 3×3);
   all three 3×3 backward kernels also at the train phase's batch 128,
   where the two routes are compared per shape, and ``fused_mm`` and
   ``fused_mm_bwd`` at every 1×1 call of batch 128 in bf16. The rows of the
   six conv kernels and ``flash_fwd`` also carry their kernels' device time
   by ``torch.profiler`` beside their library's, and the CUDA launches
   (kernels and memsets on the card) one wrapper call makes.
   Then ``lstm_fwd`` and ``lstm_bwd`` at the LSTM slice shape (T 60, N 128,
   H 256) and the LSTM benchmark geometry (T 128, N 256, H 512), f32 and
   bf16, masked and unmasked: against their plain versions, bitwise on a
   second run, timed beside their bound, the latency floor (T × one
   barrier of the kernel's own kind on its own grid, measured: a cluster
   barrier for ``lstm_fwd``'s cluster route, else a grid barrier) and
   cuDNN's LSTM layer (unmasked), with ``lstm_fwd``'s plan and the
   clusters the card keeps resident for it. Then
   ``flash_fwd``, ``flash_bwd_dkv`` and ``flash_bwd_dq`` at the BERT-base
   slice shape (N 64, T 128, H 12, Dh 64; f32 and bf16; unmasked, a ragged
   key mask, causal), the long-sequence geometry (T 1024/2048/4096 at N
   16/8/4, bf16, causal or not) and one edge shape (T 37, Dh 16, f32 and
   bf16, causal, with fully masked rows), on strided views of one packed
   projection: against their plain versions, bitwise on a second run,
   timed beside their bound, the plain versions and
   ``F.scaled_dot_product_attention`` (whose backend is reported).
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

6. lstm_serve — the committed TextGenerationLSTM (f32) scores 128
   corpus windows of 60 chars through ``output()`` (probabilities against
   the plain path, cross-entropy < 2.5) and generates 200 chars greedily
   through ``rnn_time_step`` (each step held against the plain path
   teacher-forced on the same tokens); exactly 2 ``lstm_fwd`` launches per
   call; sequences/s, ms per call and ms per char.
7. lstm_train — the same model from seed 123, batch 128 × 60 corpus
   windows, Adam(2e-3) + clip 5, 24 steps in K = 4 step calls: exactly
   2 ``lstm_fwd`` + 2 ``lstm_bwd`` launches per step, the loss falls, and
   one f32 step matches the plain path (loss, gradients); step ms, chars/s
   and peak memory.
8. bert_serve — the BERT-base-geometry stack (embedding 30522 → 768,
   learned positions, 12 pre-LN blocks of width 768 with 12 heads,
   ``RnnOutputLayer(30522)``; benchmarks/baseline_suite.py:159-213) built
   on the card from seed 123 in bf16: ``output()`` on 64 × 128 integer
   ids and on a ragged batch with a features mask, exactly 12
   ``flash_fwd`` launches per call; the f32 stack through the kernels
   against the plain path (probabilities); tokens/s, ms per call, peak
   memory.
9. bert_train — the same stack, Adam(1e-4), bf16, one fixed random batch
   of 32 × 128, K = 4 steps per call, 24 steps: exactly K × 12 launches of
   each flash kernel per call, the loss starts near ln 30522 and falls, one
   f32 step matches the plain path (loss, gradients); step ms, tokens/s,
   peak memory.

10. digits_eval — the committed ``LeNet`` and ``SimpleCNN`` digit models
   (``init_pretrained(flavor="digits")``) restored on the card and
   evaluated on the held-out UCI digits (LeNet through
   ``DigitsDataSetIterator``, 320 images as ``drop_last`` gives them;
   SimpleCNN on all 360 as NHWC): accuracy at least 0.98 and 0.95; each
   model's card probabilities within DIGITS_PROB_TOL of each row's largest
   of the same port model on the CPU, with no argmax difference; images/s
   of ``evaluate``. This slice runs no TPU kernel: the convolutions are
   plain torch, as the JAX package leaves them to XLA.
11. digits_train — ``LeNet()`` (f32, Adam(1e-3), seed 123) trained from
   scratch on the card by ``fit(DigitsDataSetIterator(64, train=True),
   epochs=12)`` through the device feeder, then evaluated: held-out
   accuracy at least 0.98; one epoch with ``k_steps=4`` equals one with
   ``k_steps=1`` from the same init within DIGITS_PARAM_TOL of each
   array's largest; three steps under each of the ten updaters, the three
   L2 gradient normalizations and a ``StepSchedule``: the card's updater
   matches the CPU's on the card's gradients within DIGITS_PARAM_TOL, and
   whole steps on each device are reported beside it (cuDNN on and off);
   ``SimpleCNN`` (28×28×1, BN, dropout
   0.5) fitted two epochs on the NHWC digits lowers its training loss;
   step ms, images/s, epoch wall, the feeder's stall ms, peak memory and,
   with ``--profile``, the card's busy share over one epoch.

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
           "fused_c3_bwd_w": _CSRC + "fused_c3_bwd.cu",
           "lstm_fwd": _CSRC + "lstm_fwd.cu",
           "lstm_bwd": _CSRC + "lstm_bwd.cu",
           "flash_fwd": _CSRC + "flash_fwd.cu",
           "flash_bwd_dkv": _CSRC + "flash_bwd.cu",
           "flash_bwd_dq": _CSRC + "flash_bwd.cu"}
_TPU = "deeplearning4j_tpu/ops/fused_conv.py:"
REPLACES = {"fused_mm": _TPU + "57", "fused_c3": _TPU + "156",
            "fused_mm_bwd": _TPU + "230", "fused_c3_bwd": _TPU + "379",
            "fused_c3_bwd_in": _TPU + "317", "fused_c3_bwd_w": _TPU + "348",
            "lstm_fwd": "deeplearning4j_tpu/ops/pallas_lstm.py:109",
            "lstm_bwd": "deeplearning4j_tpu/ops/pallas_lstm.py:206",
            "flash_fwd": "deeplearning4j_tpu/ops/pallas_kernels.py:40",
            "flash_bwd_dkv": "deeplearning4j_tpu/ops/pallas_kernels.py:180",
            "flash_bwd_dq": "deeplearning4j_tpu/ops/pallas_kernels.py:230"}
# the kernels whose libraries' bf16 bodies multiply on the tensor cores
# (lstm_fwd: its per-tick product, f32 by 3xTF32 too; lstm_bwd: its dWh
# product; flash_bwd_dkv: the flash_bwd library, both backward passes),
# and the kernels whose rows also carry device times
# (every conv kernel: their walls at the path shapes are bound by the
# wrappers' host work; the flash kernels, beside SDPA's; the LSTM kernels'
# rows always carry them, beside cuDNN's layer)
MMA_SOURCES = ("fused_mm", "fused_c3", "fused_mm_bwd", "fused_c3_bwd",
               "lstm_fwd", "lstm_bwd", "flash_fwd", "flash_bwd_dkv")
DEVICE_TIMED = ("fused_mm", "fused_c3", "fused_mm_bwd", "fused_c3_bwd",
                "fused_c3_bwd_in", "fused_c3_bwd_w", "flash_fwd",
                "flash_bwd_dkv", "flash_bwd_dq")
FORWARD = ("fused_mm", "fused_c3")
BACKWARD = ("fused_mm_bwd", "fused_c3_bwd", "fused_c3_bwd_in",
            "fused_c3_bwd_w")
TRAIN_BATCH, TRAIN_K, TRAIN_CALLS = 128, 4, 6     # 24 steps
N_REQUESTS = 64          # requests of 1-48 rows from four client threads
SLICE = dict(num_classes=200, height=64, width=64, channels=3,
             fused_blocks=True, fused_impl="pallas", s2d_stem=True,
             compute_dtype="bfloat16")
# the LSTM kernels' shapes (T, N, H): the slice (TextGenerationLSTM at
# batch 128) and the repo's LSTM throughput geometry
# (benchmarks/baseline_suite.py:381-446)
LSTM_SHAPES = {"slice": (60, 128, 256), "benchmark": (128, 256, 512)}
# LSTM kernel vs plain version, |diff| relative to max(1, max|ref|) per
# output: f32 1e-4 (the same f32 products summed in another order, carried
# through T ticks); bf16 3e-2 (a sum-order difference can flip one bf16
# rounding of h, ~4e-3 at |h| < 1, and the flipped value feeds every later
# tick)
LSTM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the f32 pretrained model through the kernels vs the plain path: softmax
# probabilities |diff| <= 1e-4, in scoring and at every generation step;
# a differing argmax is allowed only where the plain top-2 gap is below it
LSTM_PROB_TOL = 1e-4
LSTM_SERVE_WINDOWS, GEN_PROMPT, GEN_CHARS = 128, 20, 200
# training: seed 123, batch 128 x 60, Adam(2e-3) + clip 5, K = 4 steps per
# call, 24 steps; one f32 step's gradients through the kernels vs the plain
# versions within relative L2 1e-3 per parameter (the same f32 products
# summed in other orders through 60 ticks, with no BN or ReLU to amplify
# them as in the ResNet check above; the loss within LOSS_RTOL)
LSTM_TRAIN_BATCH, LSTM_TRAIN_K, LSTM_TRAIN_CALLS = 128, 4, 6
LSTM_GRAD_RTOL = 1e-3
ATTN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# the flash kernels' shapes (N, T, H, Dh): the BERT-base slice at the
# serving batch (and, further down, at the train batch), the long-sequence
# geometry of benchmarks/attn_crossover.py:55-56 ((N, T), H 12, Dh 64) and
# one edge
ATTN_SLICE = (64, 128, 12, 64)
ATTN_LONG = ((16, 1024), (8, 2048), (4, 4096))
ATTN_EDGE = (2, 37, 3, 16)
# flash kernel vs plain version, |diff| relative to max(1, max|ref|):
# f32 2e-5 (tests/test_pallas_kernels.py's bound: the same f32 products
# summed in another order); bf16 2^-7, one bf16 ulp at the largest
# magnitude (the same f32 values, then one rounding that a last-bit
# difference can flip); lse (f32 in both) 2e-5
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
# the BERT-base geometry (benchmarks/baseline_suite.py:159-213, widths of
# modelimport/bert.py:27-28): 12 pre-LN blocks of width 768 with 12 heads,
# vocabulary 30522, sequence 128; random weights from seed 123
BERT = dict(vocab=30522, width=768, heads=12, blocks=12, seq=128)
BERT_SEED = 123
BERT_SERVE_BATCH = 64
BERT_TRAIN_BATCH, BERT_TRAIN_K, BERT_TRAIN_CALLS = 32, 4, 6   # 24 steps
# the f32 stack through the kernels vs the plain versions: each position's
# probabilities within BERT_PROB_TOL of that position's largest probability
# (an absolute limit would sit above the mean probability 1/30522, so it is
# relative to the row; 5e-5 is about 12x the 4.04e-06 measured on an H100,
# a forward that ignores the key mask reads 0.958); one train step's loss
# within LOSS_RTOL and each parameter's gradient within relative L2 1e-4
# (the same f32 products summed in other orders through 12 blocks; no ReLU
# masks or max-pool choices to amplify them, unlike the ResNet check)
BERT_PROB_TOL, BERT_GRAD_RTOL = 5e-5, 1e-4
# the digits slice (LeNet, SimpleCNN): card probabilities against the same
# port model on the CPU within DIGITS_PROB_TOL of each row's largest (f32
# convolutions summed in other orders by cuDNN and the CPU); parameters
# after the same steps (card vs CPU, or k_steps=4 vs 1 on the card) within
# DIGITS_PARAM_TOL of each array's largest (ROADMAP's f32 bound for
# post-step parameters)
DIGITS_PROB_TOL, DIGITS_PARAM_TOL = 1e-5, 1e-4
DIGITS_EPOCHS, DIGITS_BATCH = 12, 64
DIGITS_ACC = {"LeNet": 0.98, "SimpleCNN": 0.95}


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text):
    """[(entry function, registers, "stores/loads" spill bytes)] from the
    ``-Xptxas -v`` output of one build."""
    import re
    rows, fn, spills = [], "?", "?"
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            fn = entry.group(1)
        elif spill:
            spills = f"{spill.group(1)}/{spill.group(2)}"
        elif regs:
            rows.append((fn, int(regs.group(1)), spills))
            spills = "?"
    return rows


def hmma_counts(cuda_build, sources):
    """{kernel: {function: HMMA instructions}} in the SASS of the library
    that holds each kernel (``cuobjdump -sass``), the proof that its
    tensor-core kernels use the tensor cores; raises if a library has none.
    Logs "not measured" where the toolkit has no cuobjdump."""
    import shutil
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        log("  HMMA count: not measured (no cuobjdump)")
        return None
    out = {}
    for src in sources:
        sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(
            cuda_build.SOURCE_OF[src]))], capture_output=True, text=True,
            check=True, timeout=120).stdout
        counts, fn = {}, "?"
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif "HMMA" in line:
                counts[fn] = counts.get(fn, 0) + 1
        out[src] = counts
        log(f"  {src}: {sum(counts.values())} HMMA in SASS: " + ", ".join(
            f"{f[:48]} {n}" for f, n in counts.items()))
        if not counts:
            raise AssertionError(f"{src}: no HMMA instruction in its SASS")
    return out


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


def call_macs(call):
    """Multiply-adds of one product of the call (x·W, or dx or dW of its
    backward): a 3×3 SAME tap that falls outside the image multiplies a
    zero and is not counted, so an image row or column of h pixels has
    3h − 2 inside taps (all 9 taps per pixel only far from the border)."""
    n, h, w, cin = call.x_shape
    cout = call.w_shape[-1]
    if call.kernel == "fused_c3":              # stride 1
        return n * (3 * h - 2) * (3 * w - 2) * cin * cout
    return n * -(-h // call.stride) * -(-w // call.stride) * cin * cout


def call_cost(call, dtype):
    """(flops, bytes) the call must do: each input read once (the rows a
    strided 1×1 needs), each output written once."""
    n, h, w, cin = call.x_shape
    cout = call.w_shape[-1]
    isz = 2 if dtype == "bfloat16" else 4
    ho, wo = -(-h // call.stride), -(-w // call.stride)
    m = n * ho * wo
    k = cin * (9 if call.kernel == "fused_c3" else 1)
    flops = 2.0 * call_macs(call)
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
        again = fc.fused_conv_bn_act(*args)
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
               "ok": y_ok and s_ok,
               "bitwise_repeat": (torch.equal(y, again[0])
                                  and torch.equal(st, again[1]))}

        # the yardstick's operands in cuDNN's layout, made once outside
        # the timed call: x as a channels_last view, W copied to match
        e = fc._norm_in(x, s, b, call.relu_in, call.norm_in)
        e_nchw = e.permute(0, 3, 1, 2)
        w_oihw = (w.reshape(1, 1, *w.shape) if w.ndim == 2 else w) \
            .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        pad = 1 if call.kernel == "fused_c3" else 0

        # timed as the served path calls it (inference: no statistics);
        # the library yardstick is cuDNN's conv of the normalized input
        path_args = args + (False,)
        res["ms"] = cuda_time(lambda: fc.fused_conv_bn_act(*path_args))
        res["ms_with_stats"] = cuda_time(lambda: fc.fused_conv_bn_act(*args))
        res["plain_ms"] = cuda_time(lambda: fc._conv_reference(*path_args))
        library = lambda: F.conv2d(e_nchw, w_oihw, stride=call.stride,
                                   padding=pad)
        res["library_ms"] = cuda_time(library)
        if call.kernel in DEVICE_TIMED:
            res["device_ms"], res["launches_per_call"] = device_trace(
                lambda: fc.fused_conv_bn_act(*path_args))
            res["library_device_ms"] = device_ms(library)
    flops, nbytes = call_cost(call, dtype)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    res["bound_ms"] = 1e3 * max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return res


def bwd_cost(call, dtype, part="both"):
    """(flops, bytes) of a backward call: dx and dW products 2·macs each
    (``call_macs``: the taps inside the image); dy, y, x and W read once,
    dx (x's full shape) and the f32 dW written once, plus the per-channel
    vectors. ``part`` "dx" or "dw" counts one launch of the split route."""
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
    flops = {"both": 4.0, "dx": 2.0, "dw": 2.0}[part] * call_macs(call)
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

    # the library yardstick's inputs, made once outside the timed call:
    # dyc and the normalized input (channels_last views for cuDNN, W
    # copied to match, so the timed call holds no layout copy)
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
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
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
        if name in DEVICE_TIMED:
            row["device_ms"], row["launches_per_call"] = device_trace(kern)
            row["library_device_ms"] = device_ms(library[part])
        row["bound_ms"], row["bound_by"] = bound(*bwd_cost(call, dtype, part),
                                                 dtype)
        rows.append(row)
    return rows


def _device_note(row):
    return ("" if "device_ms" not in row else
            f" device={row['device_ms']:.4f} lib_device="
            f"{row['library_device_ms']:.4f} launches="
            f"{row['launches_per_call']:g}")


def _summary(name, rows, launches=None):
    """One kernel's line: per bf16 train step (or served forward) at batch
    32, the sum over the path's calls of (value per call x calls)."""
    rs = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"
          and r["on_path"] and r["batch"] == 32]
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
    if rs and all("device_ms" in r for r in rs):
        out["device_ms"] = tot("device_ms")
        out["library_device_ms"] = tot("library_device_ms")
    return out


def route_table(rows):
    """The two 3×3 backward routes per shape at batch 32 and the train
    batch: one call of ``fused_c3_bwd`` against ``fused_c3_bwd_in`` +
    ``fused_c3_bwd_w``, wall and device ms (logged; the route rule is
    ``fc._backward``'s)."""
    out = []
    by = {(r["kernel"], r["dtype"], tuple(r["x"])): r for r in rows
          if r["batch"] in (32, TRAIN_BATCH)}
    for (kern, dtype, x), r in by.items():
        if kern != "fused_c3_bwd":
            continue
        i, w = by[("fused_c3_bwd_in", dtype, x)], by[("fused_c3_bwd_w",
                                                       dtype, x)]
        row = {"dtype": dtype, "x": list(x), "merged_ms": r["ms"],
               "split_ms": i["ms"] + w["ms"],
               "merged_device_ms": r["device_ms"],
               "split_device_ms": i["device_ms"] + w["device_ms"],
               "on_path": "merged" if r["on_path"] else "split"}
        out.append(row)
        log(f"  route {dtype:8s} x={x}: merged {row['merged_ms']:.4f} ms "
            f"(device {row['merged_device_ms']:.4f}), split "
            f"{row['split_ms']:.4f} ms (device "
            f"{row['split_device_ms']:.4f}); the path takes {row['on_path']}")
    return out


def _merged(fc, call):
    """Whether the train path takes the one-call 3×3 backward route for
    ``call`` (fc._backward's rule)."""
    return call.x_shape[3] <= fc.C3_MERGED_MAX_CIN and call.norm_in


def phase_kernels(report):
    import torch
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    conf = ResNet50(**SLICE).conf()
    calls = path_calls(conf, 32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    # the train phase's own batch: every 3×3 call (both routes, f32 and
    # bf16) and every 1×1 call (bf16, forward and backward)
    train_calls = path_calls(conf, TRAIN_BATCH)
    forward = [(call, count, 32, dtype) for call, count in calls.items()
               for dtype in ("float32", "bfloat16")]
    forward += [(call, count, TRAIN_BATCH, "bfloat16")
                for call, count in train_calls.items()
                if call.kernel == "fused_mm"]
    for call, count, batch, dtype in forward:
        r = check_kernel_call(call, dtype, gen)
        r.update(per_step=count, on_path=True, batch=batch)
        rows.append(r)
        log(f"  {r['kernel']:15s} {dtype:8s} x={tuple(r['x'])} "
            f"w={tuple(r['w'])} s={r['stride']} norm={int(r['norm_in'])}"
            f" err={r['max_abs_err']:.3g} stats_err="
            f"{r['stats_max_abs_err']:.3g} ms={r['ms']:.4f} "
            f"stats_ms={r['ms_with_stats']:.4f} "
            f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
            f"bound={r['bound_ms']:.4f} ({r['bound_by']})"
            f"{_device_note(r)}"
            f"{'' if r['ok'] else '  <-- DISAGREES'}"
            f"{'' if r['bitwise_repeat'] else '  <-- NOT BITWISE'}")
    backward = [(call, count, 32) for call, count in calls.items()]
    backward += [(call, count, TRAIN_BATCH)
                 for call, count in train_calls.items()]
    for call, count, batch in backward:
        merged = _merged(fc, call)
        dtypes = (("bfloat16",) if batch == TRAIN_BATCH
                  and call.kernel == "fused_mm" else ("float32", "bfloat16"))
        for dtype in dtypes:
            for r in check_backward_call(call, dtype, gen):
                r["per_step"] = count
                r["batch"] = batch
                r["on_path"] = (r["kernel"] == "fused_mm_bwd" or merged ==
                                (r["kernel"] == "fused_c3_bwd"))
                rows.append(r)
                log(f"  {r['kernel']:15s} {dtype:8s} x={tuple(r['x'])} "
                    f"w={tuple(r['w'])} s={r['stride']} "
                    f"norm={int(r['norm_in'])} path={int(r['on_path'])} "
                    f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                    f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
                    f"bound={r['bound_ms']:.4f} ({r['bound_by']})"
                    f"{_device_note(r)}"
                    f"{'' if r['ok'] else '  <-- DISAGREES'}"
                    f"{'' if r['bitwise_repeat'] else '  <-- NOT BITWISE'}")
    report["kernel_calls"] = rows
    report["c3_routes"] = route_table(rows)
    bad = [r for r in rows if not r["ok"] or not r.get("bitwise_repeat",
                                                        True)]
    if bad:
        raise AssertionError(f"{len(bad)} kernel calls disagree with the "
                             "plain version beyond tolerance or differ "
                             "between two runs")
    summary = {name: _summary(name, rows) for name in FORWARD + BACKWARD}
    for name, k in summary.items():
        log(f"  {name:15s} per bf16 step at batch 32: {k['ms']:.4f} ms "
            f"(library {k['library_ms']:.4f}), device "
            f"{k.get('device_ms', math.nan):.4f} (library "
            f"{k.get('library_device_ms', math.nan):.4f}), bound "
            f"{k['bound_ms']:.4f}")
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
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    errs, num, den = {}, 0.0, 0.0
    got = flatten_paths(got)
    for path, r in flatten_paths(ref).items():
        d = (got[path] - r).double()
        num += float((d * d).sum())
        den += float((r.double() ** 2).sum())
        errs[path] = (d.norm() / r.double().norm().clamp_min(
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


# ---------------------------------------------------------------------------
# the LSTM slice (TPU kernels 7-8): kernels, scoring/generation, training
# ---------------------------------------------------------------------------

def plain_lstm():
    """Both fused-LSTM wrappers patched to their plain versions."""
    import contextlib
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fl, "lstm_fwd",
                                          fl.lstm_fwd_reference))
    stack.enter_context(mock.patch.object(fl, "lstm_bwd",
                                          fl.lstm_bwd_reference))
    return stack


def lstm_cost(t, n, h, dtype, masked, part):
    """(flops, bytes) of one call: every input read once, every output
    written once; the forward's product 2·T·N·H·4H, the backward's two."""
    isz = 2 if dtype == "bfloat16" else 4
    m = t * n if masked else 0
    state = isz * 4 * n * h                 # h0, c0 in; hT, cT out (or d*)
    if part == "lstm_fwd":
        nbytes = isz * (2 * t * n * 4 * h + 3 * t * n * h + h * 4 * h + m)
        return 2.0 * t * n * h * 4 * h, nbytes + state
    nbytes = (isz * (2 * t * n * 4 * h + 4 * t * n * h + h * 4 * h + m)
              + 4 * h * 4 * h)
    return 4.0 * t * n * h * 4 * h, nbytes + state


def barrier_ms(cluster, gx, gy, smem):
    """Mean ms of one barrier on a (gx, gy) grid of blocks with ``smem``
    bytes of shared memory each: a cluster barrier among ``cluster`` blocks
    (cluster > 0) or a grid barrier (a cooperative launch)."""
    import torch
    from deeplearning4j_tpu_torch.ops import cuda_build
    probe = cuda_build.helper("lstm_fwd", "dl4j_lstm_barrier_probe")

    def run(iters):
        err = probe(cluster, gx, gy, smem, iters,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"barrier probe failed with CUDA error {err}")
    return (cuda_time(lambda: run(1000), iters=5) -
            cuda_time(lambda: run(0), iters=5)) / 1000


def lstm_floors(t, n, h, dtype):
    """{kernel: (ms of one tick's barrier, what it is)} on each LSTM
    kernel's own grid at (T, N, H): lstm_fwd's plan (a cluster barrier on
    the cluster route) and lstm_bwd's grid barrier."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf16 = dtype == "bfloat16"
    fp = fl.lstm_fwd_plan(t, n, h, bf16, sms)
    bp = fl.lstm_bwd_plan(t, n, h, bf16, sms)
    cluster = fp.slices if fp.route == "cluster" else 0
    return {"lstm_fwd": (barrier_ms(cluster, fp.slices, fp.row_tiles,
                                    fp.smem), fp),
            "lstm_bwd": (barrier_ms(0, bp.slices, bp.row_tiles, bp.smem),
                         bp)}


def _lstm_err(got, ref):
    """Largest |kernel - plain| over the outputs, each relative to
    max(1, its largest reference magnitude)."""
    return max((a.float() - r.float()).abs().max().item() /
               max(1.0, r.float().abs().max().item())
               for a, r in zip(got, ref))


def check_lstm_shape(where, t, n, h, dtype, masked, gen, floors):
    """Rows of lstm_fwd and lstm_bwd at one shape: against the plain
    version, bitwise on a second run, timed beside the bound, the latency
    floor (T x the kernel's barrier in ``floors``) and (unmasked) cuDNN's
    LSTM layer."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    dt = getattr(torch, dtype)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    zx = r(t, n, 4 * h).to(dt)
    wh = (r(h, 4 * h) / math.sqrt(h)).to(dt)
    h0, c0 = (0.5 * r(n, h)).to(dt), (0.5 * r(n, h)).to(dt)
    mask3 = ((torch.rand(t, n, 1, generator=gen, device="cuda") > 0.2)
             .to(dt) if masked else None)
    fargs = (zx, h0, c0, wh, mask3)
    ys, gates, tcs, ccs, _, _ = fl.lstm_fwd_reference(*fargs)
    bargs = (r(t, n, h).to(dt), r(n, h).to(dt), r(n, h).to(dt), gates, tcs,
             torch.cat([c0[None], ccs[:-1]]), torch.cat([h0[None], ys[:-1]]),
             mask3, wh)
    rows = []
    for name, args, plain in (("lstm_fwd", fargs, fl.lstm_fwd_reference),
                              ("lstm_bwd", bargs, fl.lstm_bwd_reference)):
        kern = lambda: getattr(fl, name)(*args)
        got, again, ref = kern(), kern(), plain(*args)
        torch.cuda.synchronize()
        err = _lstm_err(got, ref)
        row = {"kernel": name, "where": where, "dtype": dtype,
               "shape": [t, n, h], "masked": masked, "max_abs_err": err,
               "ok": err <= LSTM_TOL[dtype],
               "bitwise_repeat": all(torch.equal(a, b)
                                     for a, b in zip(got, again)),
               "ms": cuda_time(kern, iters=10),
               "plain_ms": cuda_time(lambda: plain(*args), iters=3,
                                     warmup=1),
               "latency_floor_ms": t * floors[name][0],
               "barrier_ms": floors[name][0],
               "plan": floors[name][1]._asdict(), "library_ms": None,
               "library_device_ms": None}
        row["device_ms"], row["launches_per_call"] = device_trace(kern, n=5)
        row["bound_ms"], row["bound_by"] = bound(
            *lstm_cost(t, n, h, dtype, masked, name), dtype)
        rows.append(row)
    if not masked:
        _cudnn_yardstick(rows, t, n, h, dt, gen)
    return rows


def _cudnn_yardstick(rows, t, n, h, dt, gen):
    """cuDNN's LSTM layer (torch.nn.LSTM, weights permuted from [i|f|o|g]
    to its [i|f|g|o]) against the port's layer (torch.matmul projection +
    lstm_fwd), forward, and its backward alone against lstm_bwd's call:
    library_ms of the two rows. The port never calls cuDNN."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = r(t, n, h).to(dt)
    wx, wh = (r(h, 4 * h) / math.sqrt(h)).to(dt), \
        (r(h, 4 * h) / math.sqrt(h)).to(dt)
    b = (0.1 * r(4 * h)).to(dt)
    h0, c0 = (0.5 * r(n, h)).to(dt), (0.5 * r(n, h)).to(dt)
    perm = torch.cat([torch.arange(0, 2 * h), torch.arange(3 * h, 4 * h),
                      torch.arange(2 * h, 3 * h)]).cuda()
    lstm = torch.nn.LSTM(h, h).to(device="cuda", dtype=dt)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t()[perm])
        lstm.weight_hh_l0.copy_(wh.t()[perm])
        lstm.bias_ih_l0.copy_(b[perm])
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()       # cuDNN's packed weights, as it runs best
    state = (h0[None], c0[None])
    port = lambda: fl.lstm_fused(torch.matmul(x, wx) + b, h0, c0, wh)
    with torch.no_grad():
        ref = lstm(x, state)[0]
        got = port()[0]
        fwd_ms = cuda_time(lambda: lstm(x, state))
        layer_ms = cuda_time(port)
    xg = x.clone().requires_grad_()
    out = lstm(xg, state)[0]
    dy = r(t, n, h).to(dt)
    bwd = lambda: torch.autograd.grad(
        out, [xg] + list(lstm.parameters()), dy, retain_graph=True)
    bwd_ms = cuda_time(bwd)
    with torch.no_grad():
        fwd_dev = device_trace(lambda: lstm(x, state), n=5, per_call=True)[0]
    fwd_row, bwd_row = rows
    fwd_row.update(library_ms=fwd_ms, port_layer_ms=layer_ms,
                   library_device_ms=fwd_dev,
                   cudnn_max_abs_err=(got.float() - ref.float())
                   .abs().max().item())
    bwd_row.update(library_ms=bwd_ms, library_device_ms=device_trace(
        bwd, n=5, per_call=True)[0])


def phase_lstm_kernels(gen):
    """lstm_fwd and lstm_bwd at the slice shape and the benchmark
    geometry, f32 and bf16, masked and unmasked."""
    from deeplearning4j_tpu_torch.ops import cuda_build
    resident = cuda_build.helper("lstm_fwd", "dl4j_lstm_max_clusters")
    rows = []
    for where, (t, n, h) in LSTM_SHAPES.items():
        for dtype in ("float32", "bfloat16"):
            floors = lstm_floors(t, n, h, dtype)
            fp = floors["lstm_fwd"][1]
            clusters = (resident(fp.slices, fp.smem, int(dtype == "bfloat16"))
                        if fp.route == "cluster" else None)
            log(f"  {dtype} T,N,H={t},{n},{h}: lstm_fwd plan {fp.route}, "
                f"{fp.slices} x {fp.row_tiles} blocks of {fp.units} units x "
                f"{fp.rows} rows, {fp.smem} B"
                + ("" if clusters is None else
                   f", {clusters} clusters of {fp.slices} resident (needs "
                   f"{fp.row_tiles})") + "; barriers: "
                + ", ".join(f"{k} {1e3 * v[0]:.2f} us" for k, v in
                            floors.items()))
            for masked in (False, True):
                for r in check_lstm_shape(where, t, n, h, dtype, masked, gen,
                                          floors):
                    rows.append(r)
                    lib = ("-" if r["library_ms"] is None
                           else f"{r['library_ms']:.4f} (device "
                           f"{r['library_device_ms']:.4f})")
                    log(f"  {r['kernel']:15s} {dtype:8s} T,N,H={t},{n},{h} "
                        f"mask={int(masked)} err={r['max_abs_err']:.3g} "
                        f"ms={r['ms']:.4f} device={r['device_ms']:.4f} "
                        f"launches={r['launches_per_call']:g} "
                        f"plain={r['plain_ms']:.4f} "
                        f"lib={lib} bound={r['bound_ms']:.4f} "
                        f"({r['bound_by']}) floor={r['latency_floor_ms']:.4f}"
                        f"{'' if r['ok'] else '  <-- DISAGREES'}"
                        f"{'' if r['bitwise_repeat'] else '  <-- NOT BITWISE'}")
    return rows


def _lstm_summary(name, rows):
    """One LSTM kernel's line: per call at the slice shape in f32,
    unmasked, as the scoring and training paths call it."""
    r = next(r for r in rows if r["kernel"] == name and r["where"] ==
             "slice" and r["dtype"] == "float32" and not r["masked"])
    out = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name],
           "max_abs_err": max(x["max_abs_err"] for x in rows
                              if x["kernel"] == name)}
    out.update({k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "latency_floor_ms",
                                  "device_ms", "library_device_ms")})
    return out


def corpus_windows(n, t, rng=None):
    """(one-hot x (n, t, 77), next-char ids (n, t)) from the committed
    corpus: consecutive windows, or random starts with ``rng``."""
    import numpy as np
    from deeplearning4j_tpu_torch.generation.decode import Vocab
    corpus = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "resources", "pretrained", "corpus.txt")
    with open(corpus, encoding="utf-8") as f:
        ids = np.array(Vocab.load().encode(f.read()))
    starts = (np.arange(n) * t if rng is None
              else rng.integers(0, len(ids) - t - 1, n))
    x = np.eye(77, dtype=np.float32)[np.stack([ids[s:s + t]
                                               for s in starts])]
    return x, np.stack([ids[s + 1:s + t + 1] for s in starts]), ids


def phase_lstm_serve(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.generation.decode import Vocab
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM

    model = TextGenerationLSTM().init_pretrained()      # cuda, f32
    x_np, y, ids = corpus_windows(LSTM_SERVE_WINDOWS, 60)
    x = torch.from_numpy(x_np).cuda()
    eye = torch.eye(77, device="cuda")
    prompt = ids[:GEN_PROMPT].tolist()

    fl.reset_launch_counts()
    probs = model.output(x)
    torch.cuda.synchronize()
    after_score = dict(fl.LAUNCHES)
    # greedy generation through rnn_time_step: the prompt in one call,
    # then one call per generated char fed back
    t0 = time.perf_counter()
    out, carries = model.rnn_time_step(eye[prompt][None])
    step_probs, tokens = [out[0, -1]], []
    for i in range(GEN_CHARS):
        tokens.append(int(step_probs[-1].argmax()))
        if i + 1 < GEN_CHARS:
            out, carries = model.rnn_time_step(eye[tokens[-1]][None],
                                               carries)
            step_probs.append(out[0, -1])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(fl.LAUNCHES)
    log(f"  launches: {after_score} after one output() call, {launches} "
        f"after {GEN_CHARS} rnn_time_step calls more")
    if after_score != {"lstm_fwd": 2, "lstm_bwd": 0} or launches != {
            "lstm_fwd": 2 + 2 * GEN_CHARS, "lstm_bwd": 0}:
        raise AssertionError("lstm_fwd must launch exactly twice per "
                             "output() and per rnn_time_step call")

    with plain_lstm():
        probs_p = model.output(x)
        seq = prompt + tokens[:-1]
        forced, _ = model.rnn_time_step(eye[seq][None])
    prob_err = (probs - probs_p).abs().max().item()
    p_true = probs.cpu().numpy()[np.arange(len(y))[:, None],
                                 np.arange(60)[None, :], y]
    xent = float(-np.mean(np.log(np.maximum(p_true, 1e-9))))
    kern = torch.stack(step_probs)
    plain = forced[0, GEN_PROMPT - 1:]
    gen_err = (kern - plain).abs().max().item()
    top2 = plain.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    differ = (kern.argmax(-1) != plain.argmax(-1)).cpu().numpy()
    near = [int(i) for i in np.nonzero(gap < LSTM_PROB_TOL)[0]]
    bad = [int(i) for i in np.nonzero(differ & (gap >= LSTM_PROB_TOL))[0]]
    log(f"  output() on {len(y)} corpus windows: probabilities vs plain "
        f"|diff| {prob_err:.3g}, per-char cross-entropy {xent:.4f}")
    log(f"  {GEN_CHARS} greedy chars: {Vocab.load().decode(tokens)!r}")
    log(f"  generation vs plain teacher-forced on the same tokens: "
        f"|diff| {gen_err:.3g}, argmax differs at {int(differ.sum())} "
        f"steps, near ties (top-2 gap < {LSTM_PROB_TOL}) at {near}")
    if prob_err > LSTM_PROB_TOL or gen_err > LSTM_PROB_TOL or bad:
        raise AssertionError("the LSTM kernels disagree with the plain path "
                             "in scoring or generation")
    if not xent < 2.5:
        raise AssertionError(f"per-char cross-entropy {xent} >= 2.5")

    out_ms = cuda_time(lambda: model.output(x), iters=10)
    log(f"  output() at {len(y)} x 60: {out_ms:.3f} ms, "
        f"{1e3 * len(y) / out_ms:.1f} sequences/s; generation "
        f"{1e3 * gen_s / GEN_CHARS:.3f} ms per char [{card}]")
    if profile:
        with torch.inference_mode():
            report["lstm_serve_profile"] = profile_calls(
                lambda: model.output(x), card,
                f"f32 output() calls at {len(y)} x 60")
    report["lstm_serve"] = {
        "windows": len(y), "prob_diff": prob_err, "xent": xent,
        "gen_chars": GEN_CHARS, "gen_prob_diff": gen_err,
        "gen_argmax_differs": int(differ.sum()), "gen_near_ties": near,
        "output_ms": out_ms, "sequences_per_s": 1e3 * len(y) / out_ms,
        "ms_per_char": 1e3 * gen_s / GEN_CHARS, "launches": launches}
    return launches


def phase_lstm_train(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM

    b, k, t = LSTM_TRAIN_BATCH, LSTM_TRAIN_K, 60
    model = TextGenerationLSTM(seed=123).init()         # cuda, f32
    x_np, y_ids, _ = corpus_windows(b, t, np.random.default_rng(123))
    y_np = np.eye(77, dtype=np.float32)[y_ids]
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    xk = x.unsqueeze(0).expand(k, *x.shape).contiguous()
    yk = y.unsqueeze(0).expand(k, *y.shape).contiguous()
    scan = model._build_scan_train_step()

    def call():
        model.train_state, losses = scan(model.train_state, xk, yk)
        return losses

    fl.reset_launch_counts()
    losses = [call()]
    torch.cuda.synchronize()
    launches = dict(fl.LAUNCHES)
    log(f"  launches over one {k}-step call: {launches}")
    if launches != {"lstm_fwd": 2 * k, "lstm_bwd": 2 * k}:
        raise AssertionError(f"expected {2 * k} lstm_fwd and {2 * k} "
                             "lstm_bwd launches")
    losses.append(call())                     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(LSTM_TRAIN_CALLS - 2):
        losses.append(call())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ((LSTM_TRAIN_CALLS - 2) * k)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    log(f"  train step at batch {b} x {t}: {step_ms:.3f} ms, "
        f"{1e3 * b * t / step_ms:.1f} chars/s, peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  losses over {len(losses)} steps: "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    if not np.isfinite(losses).all() or not losses[1:].min() < losses[0]:
        raise AssertionError("the train loss did not fall (or is not "
                             "finite)")
    if profile:
        report["lstm_train_profile"] = profile_calls(
            call, card, f"{k}-step f32 train calls at batch {b}", n=2,
            warmup=1)

    # one f32 step through the kernels against the plain versions
    m32 = TextGenerationLSTM(seed=123).init()
    args = m32._step_args(DataSet(x_np, y_np))
    loss_k, _, g_k = solver.value_and_grad(m32._loss, m32.train_state, *args)
    with plain_lstm():
        loss_p, _, g_p = solver.value_and_grad(m32._loss, m32.train_state,
                                               *args)
    err = grad_errors(g_k, g_p)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"  f32 step, kernels vs plain: loss rel {loss_err:.3g}, gradients "
        f"rel L2 worst {err['worst']:.3g} ({err['name']}), median "
        f"{err['median']:.3g}, all {err['all']:.3g}")
    if loss_err > LOSS_RTOL or err["worst"] > LSTM_GRAD_RTOL:
        raise AssertionError("the f32 train step through the LSTM kernels "
                             "disagrees with the plain path")
    report["lstm_train"] = {
        "batch": b, "timesteps": t, "k": k, "steps": len(losses),
        "losses": losses.tolist(), "step_ms": step_ms,
        "chars_per_s": 1e3 * b * t / step_ms, "peak_memory_bytes": peak,
        "launches": launches, "f32_loss_rel_err": loss_err,
        "f32_grad_rel_l2": err}
    return launches


# ---------------------------------------------------------------------------
# the attention slice (TPU kernels 9-11): kernels, serving, training
# ---------------------------------------------------------------------------

def plain_flash():
    """The three flash wrappers patched to their plain versions."""
    import contextlib
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    stack = contextlib.ExitStack()
    for name in ATTN_KERNELS:
        stack.enter_context(mock.patch.object(
            fa, name, getattr(fa, name + "_reference")))
    return stack


def attn_inputs(n, t, h, dh, dtype, mode, gen):
    """q, k, v as the strided views of one packed (N, T, H, 3, Dh)
    projection (as SelfAttentionLayer cuts them), dO, the key mask and the
    causal flag of one ``mode``: "none", "masked" (ragged key lengths),
    "causal", or "edge" (causal, one fully masked batch row, and the first
    key of another masked so its first query sees no key)."""
    import torch
    dt = getattr(torch, dtype)
    qkv = torch.randn((n, t, h, 3, dh), generator=gen, device="cuda").to(dt)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    do = torch.randn((n, t, h, dh), generator=gen, device="cuda").to(dt)
    mask = None
    if mode in ("masked", "edge"):
        lengths = torch.randint(1, t + 1, (n,), generator=gen,
                                device="cuda")
        mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None]
                ).float()
        if mode == "edge":
            mask[0] = 0.0
            mask[1, 0] = 0.0
    return q, k, v, do, mask, mode in ("causal", "edge")


def attn_cost(kernel, q, mask, causal):
    """(flops, bytes) of one call: 4, 8 or 6 · H · Dh FLOP per live
    (query, key) pair (a valid key, and not after the query when causal),
    counted from this call's mask; q, k, v (and dO) read once, the mask,
    lse (and delta) read or written once, the outputs written once."""
    import torch
    n, t, h, dh = q.shape
    isz = q.element_size()
    valid = (torch.ones((n, t), device=q.device) if mask is None
             else (mask > 0).float())
    if causal:
        live = float((valid * (t - torch.arange(t, device=q.device))).sum())
    else:
        live = float(t * valid.sum())
    elem, rows = n * t * h * dh, 4 * n * h * t
    mbytes = 0 if mask is None else 4 * n * t
    flops = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}[kernel] \
        * h * dh * live
    nbytes = {"flash_fwd": isz * 4 * elem + rows,
              "flash_bwd_dkv": isz * 6 * elem + 2 * rows,
              "flash_bwd_dq": isz * 5 * elem + 2 * rows}[kernel]
    return flops, nbytes + mbytes


def sdpa_backend(fn):
    """The name of the longest device kernel of one call of ``fn``: which
    of F.scaled_dot_product_attention's backends ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(getattr(e, "device_time_total", 0.0), e.key)
            for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return max(rows)[1][:80] if rows else "not seen by the profiler"


def device_trace(fn, n=10, per_call=False):
    """(device ms, CUDA launches) of one call of ``fn`` by torch.profiler.
    The ms are the mean time of each kernel it launches, summed over its
    kernels (each launched once a call, as the device-timed wrappers' and
    their yardsticks' are; a mean per launch, because the trace can miss
    the first launch of its window); with ``per_call``, every kernel's
    total over the ``n`` calls divided by ``n``, for a call that launches
    one kernel many times (cuDNN's LSTM layer). Where a call's wall time
    (``cuda_time``) is bound by the host, this is what its kernels cost the
    card. The launches are the kernels and memsets the trace saw on the
    card, over ``n`` calls, rounded to a whole number a call. A trace that
    recorded no kernel at all is taken again, up to five times, and then
    reads NaN (not measured), never 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        # "Activity Buffer Request" is the tracer's own device activity
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"
                  and not e.key.startswith("Activity Buffer")]
        ms = sum(getattr(e, "device_time_total", 0.0) /
                 (n if per_call else max(1, e.count)) for e in events) / 1e3
        if ms > 0:
            return ms, round(sum(e.count for e in events) / n)
    return math.nan, math.nan


def device_ms(fn, n=10):
    """The device ms of ``device_trace``."""
    return device_trace(fn, n)[0]


def check_attn_shape(where, n, t, h, dh, dtype, mode, gen):
    """Rows of the three flash kernels at one shape: against their plain
    versions, bitwise on a second run, timed beside the bound, the plain
    version and F.scaled_dot_product_attention (forward; its autograd
    backward, which computes dq, dk and dv together, for both backward
    rows)."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    q, k, v, do, mask, causal = attn_inputs(n, t, h, dh, dtype, mode, gen)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, mask, causal)
    delta = fa.attention_delta(do, ref_out)
    bargs = (q, k, v, mask, do, ref_lse, delta, causal)
    runs = {"flash_fwd": (q, k, v, mask, causal), "flash_bwd_dkv": bargs,
            "flash_bwd_dq": bargs}

    # the library yardstick on (N, H, T, Dh) views of the same tensors
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    am = None
    if mask is not None:
        am = (mask > 0)[:, None, None, :]
        if causal:
            am = am & torch.ones((t, t), dtype=torch.bool,
                                 device="cuda").tril()
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, attn_mask=am, is_causal=causal and am is None)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))
    og = sdpa(qg, kg, vg)
    lib_bwd = lambda: torch.autograd.grad(og, (qg, kg, vg), doh,
                                          retain_graph=True)
    lib = {"flash_fwd": lambda: sdpa(qh, kh, vh),
           "flash_bwd_dkv": lib_bwd, "flash_bwd_dq": lib_bwd}
    long = t >= 1024
    iters, plain_iters = (5, 2) if long else (20, 3)
    rows = []
    for name, args in runs.items():
        kern = lambda: getattr(fa, name)(*args)
        plain = lambda: getattr(fa, name + "_reference")(*args)
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        if name == "flash_bwd_dq":
            got, again, ref = (got,), (again,), (ref,)
        errs = [(a.float() - r.float()).abs().max().item() /
                max(1.0, r.float().abs().max().item())
                for a, r in zip(got, ref)]
        tol = [2e-5 if name == "flash_fwd" and i == 1 else ATTN_TOL[dtype]
               for i in range(len(errs))]          # lse is f32
        row = {"kernel": name, "where": where, "dtype": dtype, "mode": mode,
               "shape": [n, t, h, dh], "max_abs_err": max(errs),
               "ok": all(e <= b for e, b in zip(errs, tol)),
               "bitwise_repeat": all(torch.equal(a, b)
                                     for a, b in zip(got, again)),
               "ms": cuda_time(kern, iters=iters, warmup=2),
               "plain_ms": cuda_time(plain, iters=plain_iters, warmup=1),
               "library_ms": cuda_time(lib[name], iters=iters, warmup=2)}
        row["bound_ms"], row["bound_by"] = bound(
            *attn_cost(name, q, mask, causal), dtype)
        if name in DEVICE_TIMED:
            row["device_ms"], row["launches_per_call"] = device_trace(
                kern, n=iters)
            row["library_device_ms"] = device_ms(lib[name], n=iters)
        rows.append(row)
    rows[0]["sdpa_backend"] = sdpa_backend(lib["flash_fwd"])
    rows[1]["sdpa_backend"] = rows[2]["sdpa_backend"] = sdpa_backend(lib_bwd)
    return rows


def phase_attn_kernels(gen):
    """The flash kernels at the BERT slice shape (f32 and bf16; unmasked,
    ragged key mask, causal), the long-sequence geometry (bf16, causal or
    not), one edge shape (f32 and bf16) and bert_train's shape."""
    shapes = [("slice", ATTN_SLICE, dtype, mode)
              for dtype in ("float32", "bfloat16")
              for mode in ("none", "masked", "causal")]
    shapes += [("long", (n, t, 12, 64), "bfloat16", mode)
               for n, t in ATTN_LONG for mode in ("none", "causal")]
    shapes += [("edge", ATTN_EDGE, dtype, "edge")
               for dtype in ("float32", "bfloat16")]
    # bert_train's calls: bf16, unmasked, at the train batch
    shapes.append(("train", (BERT_TRAIN_BATCH,) + ATTN_SLICE[1:], "bfloat16",
                   "none"))
    rows = []
    for where, (n, t, h, dh), dtype, mode in shapes:
        for r in check_attn_shape(where, n, t, h, dh, dtype, mode, gen):
            rows.append(r)
            log(f"  {r['kernel']:15s} {dtype:8s} N,T,H,Dh={n},{t},{h},{dh} "
                f"{mode:6s} err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"plain={r['plain_ms']:.4f} sdpa={r['library_ms']:.4f} "
                f"bound={r['bound_ms']:.4f} ({r['bound_by']})"
                f"{_device_note(r)} [{r['sdpa_backend']}]"
                f"{'' if r['ok'] else '  <-- DISAGREES'}"
                f"{'' if r['bitwise_repeat'] else '  <-- NOT BITWISE'}")
    return rows


def _attn_summary(name, rows):
    """One flash kernel's line: per call at the shape its main path gives
    it, bf16 and unmasked: the served full batch for flash_fwd, the train
    batch for the backward kernels, which only bert_train runs; the error
    is the largest over every call, relative to max(1, max|ref|)."""
    where = "slice" if name == "flash_fwd" else "train"
    r = next(r for r in rows if r["kernel"] == name and r["where"] == where
             and r["dtype"] == "bfloat16" and r["mode"] == "none")
    out = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name],
           "max_abs_err": max(x["max_abs_err"] for x in rows
                              if x["kernel"] == name)}
    out.update({k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")})
    if "device_ms" in r:
        out.update(device_ms=r["device_ms"],
                   library_device_ms=r["library_device_ms"])
    return out


def bert_model(compute_dtype, seed=BERT_SEED, device=None):
    """The BERT-base-geometry stack of benchmarks/baseline_suite.py:159-213
    (bert_train), built by the port on ``device`` (the card by default)
    from ``seed``."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        LearnedPositionalEmbedding, TransformerEncoderBlock)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import \
        EmbeddingSequenceLayer
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    c = BERT
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-4))
         .compute_dtype(compute_dtype).list()
         .layer(EmbeddingSequenceLayer(n_in=c["vocab"], n_out=c["width"]))
         .layer(LearnedPositionalEmbedding(max_len=c["seq"])))
    for _ in range(c["blocks"]):
        b = b.layer(TransformerEncoderBlock(n_out=c["width"],
                                            n_heads=c["heads"], ffn_mult=4))
    conf = (b.layer(RnnOutputLayer(n_out=c["vocab"]))
            .set_input_type(InputType.recurrent(1, c["seq"])).build())
    return MultiLayerNetwork(conf, device=device).init()


def ragged_mask(n, t, rng, min_len=16):
    import numpy as np
    lengths = rng.integers(min_len, t + 1, n)
    lengths[0] = t
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)


def row_rel_err(p, ref):
    """The largest |p - ref| of each position over that position's largest
    reference probability, maximised over positions."""
    return ((p - ref).abs().amax(-1) / ref.amax(-1)).max().item()


def _flash_launches(fa):
    return {k: fa.LAUNCHES[k] for k in ATTN_KERNELS}


def phase_bert_serve(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    c, b = BERT, BERT_SERVE_BATCH
    t0 = time.perf_counter()
    model = bert_model("bfloat16")
    log(f"  model: {model.num_params()} params on {model.device}, init "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, c["vocab"], (b, c["seq"]))).cuda()
    fmask = torch.from_numpy(ragged_mask(b, c["seq"], rng)).cuda()

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    probs = model.output(ids)
    torch.cuda.synchronize()
    after_full = _flash_launches(fa)
    probs_m = model.output(ids, mask=fmask)
    torch.cuda.synchronize()
    launches = _flash_launches(fa)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches: {after_full} after one output() call, {launches} "
        "after a second on a ragged batch with a features mask")
    per_call = c["blocks"]
    if after_full != {"flash_fwd": per_call, "flash_bwd_dkv": 0,
                      "flash_bwd_dq": 0} or launches["flash_fwd"] != \
            2 * per_call or launches["flash_bwd_dkv"] + \
            launches["flash_bwd_dq"]:
        raise AssertionError(f"expected exactly {per_call} flash_fwd "
                             "launches per output() call")
    for what, p in (("full", probs), ("masked", probs_m)):
        pf = p.float()
        if tuple(p.shape) != (b, c["seq"], c["vocab"]) or \
                not torch.isfinite(pf).all() or \
                (pf.sum(-1) - 1).abs().max().item() > 2e-2:
            raise AssertionError(f"{what} output: not finite probabilities "
                                 f"of shape {(b, c['seq'], c['vocab'])}")

    # the f32 model through the kernels against the plain versions; the
    # control is a forward that ignores the key mask, a fault the check
    # must see
    m32 = bert_model("float32")
    m32.set_params(model.params, model.model_state)
    small, small_mask = ids[:4], fmask[:4]
    no_mask = lambda q, k, v, mask=None, causal=False: \
        fa.flash_fwd_reference(q, k, v, None, causal)
    with torch.inference_mode():
        p_k = m32.output(small, mask=small_mask)
        with plain_flash():
            p_p = m32.output(small, mask=small_mask)
            with mock.patch.object(fa, "flash_fwd", no_mask):
                p_c = m32.output(small, mask=small_mask)
    prob_err, control = row_rel_err(p_k, p_p), row_rel_err(p_c, p_p)
    log(f"  f32 kernels vs plain on 4 x {c['seq']} (ragged): probabilities "
        f"|diff| / row max {prob_err:.3g} (absolute "
        f"{(p_k - p_p).abs().max().item():.3g}); control, the key mask "
        f"ignored: {control:.3g} (absolute "
        f"{(p_c - p_p).abs().max().item():.3g})")
    if not prob_err <= BERT_PROB_TOL:
        raise AssertionError("the f32 BERT stack through the flash kernels "
                             "disagrees with the plain path")
    if not control > BERT_PROB_TOL:
        raise AssertionError("the probability check cannot tell a forward "
                             "that ignores the key mask from the plain path")
    del m32, p_k, p_p, p_c

    out_ms = cuda_time(lambda: model.output(ids), iters=10)
    masked_ms = cuda_time(lambda: model.output(ids, mask=fmask), iters=10)
    log(f"  output() at {b} x {c['seq']}: {out_ms:.3f} ms, "
        f"{1e3 * b * c['seq'] / out_ms:.1f} tokens/s (ragged with mask "
        f"{masked_ms:.3f} ms), peak memory {peak / 2**20:.1f} MiB [{card}]")
    if profile:
        with torch.inference_mode():
            report["bert_serve_profile"] = profile_calls(
                lambda: model.output(ids), card,
                f"bf16 output() calls at {b} x {c['seq']}", n=5)
    report["bert_serve"] = {
        "batch": b, "seq": c["seq"], "params": model.num_params(),
        "output_ms": out_ms, "masked_output_ms": masked_ms,
        "tokens_per_s": 1e3 * b * c["seq"] / out_ms,
        "peak_memory_bytes": peak, "launches": launches,
        "f32_prob_row_rel_diff": prob_err,
        "control_prob_row_rel_diff": control}
    return launches


def phase_bert_train(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.optimize import solver
    c, b, k = BERT, BERT_TRAIN_BATCH, BERT_TRAIN_K
    model = bert_model("bfloat16")
    rng = np.random.default_rng(0)
    ids_np = rng.integers(0, c["vocab"], (b, c["seq"]))
    lab_np = rng.integers(0, c["vocab"], (b, c["seq"]))
    ids = torch.from_numpy(ids_np).cuda()
    y = torch.zeros((b, c["seq"], c["vocab"]), device="cuda")
    y.scatter_(2, torch.from_numpy(lab_np).cuda()[..., None], 1.0)
    xk = ids.unsqueeze(0).expand(k, *ids.shape)
    yk = y.unsqueeze(0).expand(k, *y.shape)
    scan = model._build_scan_train_step()

    def call():
        model.train_state, losses = scan(model.train_state, xk, yk)
        return losses

    fa.reset_launch_counts()
    losses = [call()]
    torch.cuda.synchronize()
    launches = _flash_launches(fa)
    log(f"  launches over one {k}-step call: {launches}")
    if launches != {name: k * c["blocks"] for name in ATTN_KERNELS}:
        raise AssertionError(f"expected {k} x {c['blocks']} launches of each "
                             "flash kernel")
    losses.append(call())                     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(BERT_TRAIN_CALLS - 2):
        losses.append(call())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ((BERT_TRAIN_CALLS - 2) * k)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    tokens = b * c["seq"]
    log(f"  train step at batch {b} x {c['seq']}: {step_ms:.3f} ms, "
        f"{1e3 * tokens / step_ms:.1f} tokens/s, peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  losses over {len(losses)} steps: "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    if not np.isfinite(losses).all() or not losses[1:].min() < losses[0] \
            or abs(losses[0] - math.log(c["vocab"])) > 1.0:
        raise AssertionError("the train loss did not start near ln(vocab) "
                             "and fall (or is not finite)")
    if profile:
        report["bert_train_profile"] = profile_calls(
            call, card, f"{k}-step bf16 train calls at batch {b}", n=2,
            warmup=1)
    del xk, yk, y

    # one f32 step at a small ragged batch: kernels against plain versions
    m32 = bert_model("float32")
    m32.set_params(model.params)
    fm = ragged_mask(4, c["seq"], rng)
    y4 = np.zeros((4, c["seq"], c["vocab"]), np.float32)
    y4[np.arange(4)[:, None], np.arange(c["seq"])[None, :],
       lab_np[:4]] = 1.0
    args = m32._step_args(DataSet(ids_np[:4], y4, fm))
    loss_k, _, g_k = solver.value_and_grad(m32._loss, m32.train_state, *args)
    with plain_flash():
        loss_p, _, g_p = solver.value_and_grad(m32._loss, m32.train_state,
                                               *args)
    err = grad_errors(g_k, g_p)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"  f32 step at 4 x {c['seq']} (ragged), kernels vs plain: loss rel "
        f"{loss_err:.3g}, gradients rel L2 worst {err['worst']:.3g} "
        f"({err['name']}), median {err['median']:.3g}, all "
        f"{err['all']:.3g}")
    if loss_err > LOSS_RTOL or err["worst"] > BERT_GRAD_RTOL:
        raise AssertionError("the f32 train step through the flash kernels "
                             "disagrees with the plain path")
    report["bert_train"] = {
        "batch": b, "seq": c["seq"], "k": k, "steps": len(losses),
        "losses": losses.tolist(), "step_ms": step_ms,
        "tokens_per_s": 1e3 * tokens / step_ms, "peak_memory_bytes": peak,
        "launches": launches, "f32_loss_rel_err": loss_err,
        "f32_grad_rel_l2": err}
    return launches


# ---------------------------------------------------------------------------
# the digits slice: LeNet and SimpleCNN through fit/evaluate (no TPU kernel)
# ---------------------------------------------------------------------------

def digits_test_nhwc():
    """The held-out digits as SimpleCNN takes them: a NHWC DataSet of all
    360 images (tests/test_pretrained_artifacts.py:48-51)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    x, y = DigitsDataSetIterator.fetch(train=False)
    return DataSet(x.reshape(-1, 28, 28, 1), np.eye(10, dtype=np.float32)[y])


def rel_param_err(a, b):
    """The largest |a - b| of each parameter array over that array's
    largest |b|, and the worst array's name."""
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    fa, fb = flatten_paths(a), flatten_paths(b)
    if not fb:
        return 0.0, "-"
    errs = {k: ((fa[k].float().cpu() - fb[k].float().cpu()).abs().max()
                / fb[k].float().abs().max().clamp(min=1e-30)).item()
            for k in fb}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def phase_digits_eval(report, card):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import \
        ArrayDataSetIterator
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.zoo.models import LeNet, SimpleCNN

    nhwc = digits_test_nhwc()
    out = {}
    for zoo in (LeNet(), SimpleCNN()):
        name = type(zoo).__name__
        model = zoo.init_pretrained(flavor="digits")        # cuda
        ref = zoo.init_pretrained(flavor="digits", device="cpu")
        if name == "LeNet":
            x = nhwc.features.reshape(-1, 28 * 28)
            make = lambda: DigitsDataSetIterator(DIGITS_BATCH, train=False,
                                                 shuffle=False)
        else:
            x = nhwc.features
            make = lambda: ArrayDataSetIterator(nhwc, DIGITS_BATCH)
        ev = model.evaluate(make())
        acc, n = ev.accuracy(), int(ev.confusion_matrix().sum())
        ev_cpu = ref.evaluate(make())
        p = model.output(x).cpu().numpy()
        q = ref.output(x).numpy()
        row_err = float((np.abs(p - q).max(1) / q.max(1)).max())
        flips = int((p.argmax(1) != q.argmax(1)).sum())
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            model.evaluate(make())
            times.append(time.perf_counter() - t0)
        ips = n / min(times)
        log(f"  {name}: accuracy {acc:.4f} on {n} held-out images (CPU "
            f"{ev_cpu.accuracy():.4f}); card vs CPU probabilities: worst "
            f"row {row_err:.3g} of its largest, {flips} argmax "
            f"differences; evaluate {1e3 * min(times):.2f} ms, "
            f"{ips:.0f} images/s [{card}]")
        if acc < DIGITS_ACC[name]:
            raise AssertionError(f"{name}: held-out accuracy {acc} < "
                                 f"{DIGITS_ACC[name]}")
        if row_err > DIGITS_PROB_TOL or flips:
            raise AssertionError(f"{name}: card probabilities disagree with "
                                 "the CPU's")
        out[name] = {"accuracy": acc, "images": n,
                     "cpu_accuracy": ev_cpu.accuracy(),
                     "prob_row_rel_err": row_err, "argmax_flips": flips,
                     "evaluate_ms": [1e3 * t for t in times],
                     "images_per_s": ips}
    report["digits_eval"] = out


def lenet_with(updater=None, grad_norm=None, device=None):
    """LeNet (seed 123) under ``updater`` and a gradient normalization."""
    import dataclasses
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.updaters import \
        GradientNormalizationConfig
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    conf = (LeNet() if updater is None else LeNet(updater=updater)).conf()
    if grad_norm is not None:
        conf.global_config = dataclasses.replace(
            conf.global_config,
            gradient_normalization=GradientNormalizationConfig(*grad_norm))
    return MultiLayerNetwork(conf, device=device).init()


def digits_updater_cases():
    """(name, updater, gradient normalization, whether its whole steps are
    gated) of the three-step check. The Adam family's whole steps are
    reported only: m / sqrt(v) turns f32 noise in a near-zero gradient
    into a step of up to lr, 1.2e-4 of the dense weight's largest after
    three steps with cuDNN off (measured on an H100)."""
    from deeplearning4j_tpu_torch.optimize import updaters as U
    from deeplearning4j_tpu_torch.optimize.schedules import StepSchedule
    return [
        ("Sgd", U.Sgd(0.05), None, True),
        ("Nesterovs", U.Nesterovs(0.01, 0.9), None, True),
        ("Adam", U.Adam(1e-3), None, False),
        ("AdamW", U.AdamW(1e-3), None, False),
        ("AdaMax", U.AdaMax(2e-3), None, False),
        ("Nadam", U.Nadam(1e-3), None, False),
        ("AMSGrad", U.AMSGrad(1e-3), None, False),
        ("RmsProp", U.RmsProp(1e-3), None, True),
        ("AdaGrad", U.AdaGrad(1e-2), None, True),
        ("AdaDelta", U.AdaDelta(), None, True),
        ("Adam+clip_l2_global", U.Adam(1e-3), ("clip_l2_global", 1.0), False),
        ("Adam+clip_l2_per_layer", U.Adam(1e-3), ("clip_l2_per_layer", 0.5),
         False),
        ("Adam+renormalize_l2", U.Adam(1e-3), ("renormalize_l2", 1.0), False),
        ("Sgd(StepSchedule)", U.Sgd(StepSchedule(0.05, 0.5, 2)), None, True)]


def phase_digits_train(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.optimize.updaters import tree_map
    from deeplearning4j_tpu_torch.zoo.models import LeNet, SimpleCNN

    out = {}
    # LeNet from scratch, 12 epochs through the feeder
    model = LeNet().init()                              # cuda, f32, seed 123
    # counted without a pass over the iterator: each pass advances its
    # epoch and with it the shuffle order that fit would start from
    n_train = (len(DigitsDataSetIterator.fetch(train=True)[1])
               // DIGITS_BATCH * DIGITS_BATCH)
    train = DigitsDataSetIterator(DIGITS_BATCH, train=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(train, epochs=DIGITS_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = model.iteration
    stalls = model.last_feeder.pass_stall_ms
    ev = model.evaluate(DigitsDataSetIterator(DIGITS_BATCH, train=False,
                                              shuffle=False))
    acc = ev.accuracy()
    step_ms = 1e3 * wall / steps
    log(f"  LeNet fit {DIGITS_EPOCHS} epochs x {steps // DIGITS_EPOCHS} "
        f"steps at batch {DIGITS_BATCH}: {wall:.2f} s ({1e3 * wall / DIGITS_EPOCHS:.1f} ms an "
        f"epoch, first epoch included), {step_ms:.3f} ms a step, "
        f"{n_train * DIGITS_EPOCHS / wall:.0f} images/s, feeder stall "
        f"{sum(stalls):.1f} ms in all (per epoch "
        f"{' '.join(f'{v:.1f}' for v in stalls)}), peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  held-out accuracy {acc:.4f}, last loss {model.score():.4f}")
    if acc < DIGITS_ACC["LeNet"] or model.epoch_count != DIGITS_EPOCHS:
        raise AssertionError(f"LeNet trained on the card: accuracy {acc} < "
                             f"{DIGITS_ACC['LeNet']}")
    out["lenet_fit"] = {
        "epochs": DIGITS_EPOCHS, "steps": steps, "wall_s": wall,
        "epoch_ms": 1e3 * wall / DIGITS_EPOCHS, "step_ms": step_ms,
        "images_per_s": n_train * DIGITS_EPOCHS / wall,
        "stall_ms_per_epoch": stalls, "peak_memory_bytes": peak,
        "accuracy": acc}
    if profile:
        ep = DigitsDataSetIterator(DIGITS_BATCH, train=True)
        out["lenet_fit_profile"] = profile_calls(
            lambda: model.fit(ep, epochs=1), card,
            f"LeNet fit epochs ({n_train // DIGITS_BATCH} steps)", n=2,
            warmup=1)

    # one epoch at k_steps=4 against k_steps=1 from one seeded init, with
    # cuDNN's deterministic algorithms: its default backward algorithms
    # differ from run to run in the last bits, and 22 Adam steps carry
    # that to 1e-4 of a weight's largest whatever k is (1.45e-4 on an
    # H100 in the first run of this check)
    fitted = {}
    torch.backends.cudnn.deterministic = True
    for k in (1, 4):
        m = LeNet().init()
        t0 = time.perf_counter()
        m.fit(DigitsDataSetIterator(DIGITS_BATCH, train=True), epochs=1,
              k_steps=k)
        torch.cuda.synchronize()
        fitted[k] = (m, time.perf_counter() - t0)
    torch.backends.cudnn.deterministic = False
    err, worst = rel_param_err(fitted[4][0].params, fitted[1][0].params)
    log(f"  one epoch k_steps=4 vs 1: worst parameter {err:.3g} of its "
        f"largest ({worst}); epoch wall {1e3 * fitted[1][1]:.1f} ms (k=1), "
        f"{1e3 * fitted[4][1]:.1f} ms (k=4)")
    if err > DIGITS_PARAM_TOL or fitted[4][0].iteration != \
            fitted[1][0].iteration:
        raise AssertionError("k_steps=4 and k_steps=1 disagree")
    out["k_steps"] = {"param_rel_err": err, "worst": worst,
                      "epoch_ms": {str(k): 1e3 * v[1]
                                   for k, v in fitted.items()}}

    # three steps under every updater, normalization and a schedule, held
    # to the CPU three ways. (1) The updater arithmetic: each step's
    # gradients come from the card's step and go through the updater on
    # the card and, copied, through the same updater on the CPU. (2) With
    # cuDNN off, the gradients of each of the card's three fit steps
    # against the CPU's at the same parameters and batch. (3) With cuDNN
    # off, whole fit steps on each device, for the updaters that do not
    # divide by sqrt(v) (see digits_updater_cases). Whole steps with cuDNN
    # on are reported only: cuDNN's convolution gives values of up to
    # 2.4e-7 where the CPU's sum is exactly 0 (49 of the 50 such conv2
    # pre-activations of the first batch, 24 of them positive, measured on
    # an H100), so ReLU opens there and the biases behind it move by 1-2%
    # of their largest in three steps
    batches = [b for _, b in zip(range(3), DigitsDataSetIterator(
        DIGITS_BATCH, train=True, shuffle=False))]
    to_cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)
    rows = []
    for name, upd, gn, gate_steps in digits_updater_cases():
        row = {"case": name}
        cuda_m, cpu_m = lenet_with(upd, gn), lenet_with(upd, gn, device="cpu")
        for b in batches:
            loss, new_ms, grads = solver.value_and_grad(
                cuda_m._loss, cuda_m.train_state, *cuda_m._step_args(b),
                cuda_m._generator)
            with torch.no_grad():
                for m, g in ((cuda_m, grads),
                             (cpu_m, tree_map(lambda t: t.cpu(), grads))):
                    u, m.opt_state = m._tx.update(g, m.opt_state, m.params)
                    m.params = solver.apply_updates(m.params, u)
            cuda_m.model_state = new_ms
        row["param_rel_err"], row["worst"] = rel_param_err(cuda_m.params,
                                                           cpu_m.params)
        row["state_rel_err"], _ = rel_param_err(cuda_m.opt_state,
                                                cpu_m.opt_state)
        row["grad_rel_err"] = (0.0, "-")
        for key, cudnn in (("steps_cudnn_off", False), ("steps", True)):
            torch.backends.cudnn.enabled = cudnn
            a, c = lenet_with(upd, gn), lenet_with(upd, gn, device="cpu")
            for b in batches:
                if not cudnn:
                    _, _, g_card = solver.value_and_grad(
                        a._loss, a.train_state, *a._step_args(b),
                        a._generator)
                    ts = a.train_state._replace(
                        params=to_cpu(a.params),
                        model_state=to_cpu(a.model_state))
                    _, _, g_cpu = solver.value_and_grad(
                        c._loss, ts, *c._step_args(b), c._generator)
                    row["grad_rel_err"] = max(row["grad_rel_err"],
                                              rel_param_err(g_card, g_cpu))
                a.fit(b)
                c.fit(b)
            torch.backends.cudnn.enabled = True
            row[key] = rel_param_err(a.params, c.params)
        row["steps_gated"] = gate_steps
        rows.append(row)
        log(f"  3 steps {name:<24} card updater vs CPU updater on the "
            f"card's gradients: parameters {row['param_rel_err']:.3g}, "
            f"state {row['state_rel_err']:.3g}; cuDNN off, gradients card "
            f"vs CPU {row['grad_rel_err'][0]:.3g} "
            f"({row['grad_rel_err'][1]}), whole steps "
            f"{row['steps_cudnn_off'][0]:.3g} ({row['steps_cudnn_off'][1]})"
            f"{'' if gate_steps else ' [reported]'}; cuDNN on, whole steps "
            f"{row['steps'][0]:.3g} ({row['steps'][1]}) [reported]")
    out["updaters"] = rows
    bad = [r["case"] for r in rows
           if r["param_rel_err"] > DIGITS_PARAM_TOL
           or r["state_rel_err"] > DIGITS_PARAM_TOL
           or r["grad_rel_err"][0] > DIGITS_PARAM_TOL
           or (r["steps_gated"]
               and r["steps_cudnn_off"][0] > DIGITS_PARAM_TOL)]
    if bad:
        raise AssertionError(f"LeNet's steps on the card disagree with the "
                             f"CPU's under {', '.join(bad)}")

    # SimpleCNN (BN, dropout 0.5) on the NHWC digits, two epochs
    x, y = DigitsDataSetIterator.fetch(train=True)
    data = DataSet(x.reshape(-1, 28, 28, 1), np.eye(10, dtype=np.float32)[y])
    scnn = SimpleCNN(height=28, width=28, channels=1).init()
    before = scnn.score(data)
    t0 = time.perf_counter()
    scnn.fit(ArrayDataSetIterator(data, DIGITS_BATCH, shuffle=True,
                                  seed=123), epochs=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = scnn.score(data)
    log(f"  SimpleCNN 28x28x1 two epochs: training loss {before:.4f} -> "
        f"{after:.4f}, {1e3 * wall / scnn.iteration:.3f} ms a step "
        f"[{card}]")
    if not (np.isfinite(after) and after < before):
        raise AssertionError("SimpleCNN's training loss did not fall")
    out["simplecnn_fit"] = {"loss_before": before, "loss_after": after,
                            "steps": scnn.iteration,
                            "step_ms": 1e3 * wall / scnn.iteration}
    report["digits_train"] = out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="env,build,kernels,slice,train,"
                    "lstm_serve,lstm_train,bert_serve,bert_train,"
                    "digits_eval,digits_train",
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
        report["ptxas"] = {}
        for name, (sec, text) in cuda_build.build_log.items():
            report["ptxas"][name] = ptxas_report(text)
            for fn, regs, spills in report["ptxas"][name]:
                log(f"  {name}: {fn[:60]} registers={regs} spills={spills}")
        report["hmma"] = hmma_counts(cuda_build, MMA_SOURCES)

    summary = {}
    if "kernels" in phases:
        log("[kernels] every path shape at batch 32, f32 and bf16")
        summary = phase_kernels(report)
        log("[kernels] lstm_fwd and lstm_bwd at (T, N, H) = "
            f"{list(LSTM_SHAPES.values())}, f32 and bf16, masked or not")
        rows = phase_lstm_kernels(torch.Generator(device="cuda")
                                  .manual_seed(0))
        report["lstm_kernel_calls"] = rows
        if not all(r["ok"] and r["bitwise_repeat"] for r in rows):
            raise AssertionError("an LSTM kernel disagrees with its plain "
                                 "version or differs between two runs")
        for name in ("lstm_fwd", "lstm_bwd"):
            summary[name] = _lstm_summary(name, rows)
        log("[kernels] flash_fwd, flash_bwd_dkv and flash_bwd_dq at "
            f"(N, T, H, Dh) = {ATTN_SLICE} (f32 and bf16; unmasked, ragged "
            f"key mask, causal), (N, T) = {list(ATTN_LONG)} bf16 causal or "
            f"not, {ATTN_EDGE} f32 and bf16 causal with masked rows, and "
            "batch "
            f"{BERT_TRAIN_BATCH} bf16 unmasked (bert_train's calls)")
        rows = phase_attn_kernels(torch.Generator(device="cuda")
                                  .manual_seed(0))
        report["attn_kernel_calls"] = rows
        if not all(r["ok"] and r["bitwise_repeat"] for r in rows):
            raise AssertionError("a flash kernel disagrees with its plain "
                                 "version or differs between two runs")
        for name in ATTN_KERNELS:
            summary[name] = _attn_summary(name, rows)

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
    if "lstm_serve" in phases:
        log(f"[lstm_serve] pretrained TextGenerationLSTM f32: output() on "
            f"{LSTM_SERVE_WINDOWS} windows of 60, {GEN_CHARS} greedy chars")
        for name, n in phase_lstm_serve(report, card, args.profile).items():
            launches[name] += n
    if "lstm_train" in phases:
        log(f"[lstm_train] TextGenerationLSTM f32, batch {LSTM_TRAIN_BATCH}"
            f" x 60, Adam(2e-3) + clip 5, K={LSTM_TRAIN_K} steps per call")
        for name, n in phase_lstm_train(report, card, args.profile).items():
            launches[name] += n
    bert = (f"{BERT['blocks']} x {BERT['width']}/{BERT['heads']} heads, "
            f"vocab {BERT['vocab']}, seq {BERT['seq']}")
    if "bert_serve" in phases:
        log(f"[bert_serve] BERT-base geometry ({bert}) bf16: output() on "
            f"{BERT_SERVE_BATCH} x {BERT['seq']} ids")
        for name, n in phase_bert_serve(report, card, args.profile).items():
            launches[name] += n
    if "bert_train" in phases:
        log(f"[bert_train] BERT-base geometry ({bert}) bf16, Adam(1e-4), "
            f"batch {BERT_TRAIN_BATCH} x {BERT['seq']}, K={BERT_TRAIN_K} "
            "steps per call")
        for name, n in phase_bert_train(report, card, args.profile).items():
            launches[name] += n
    # the digits slice runs no kernel of SOURCES (plain torch convolutions)
    if "digits_eval" in phases:
        log("[digits_eval] pretrained LeNet and SimpleCNN on the held-out "
            "UCI digits, card against CPU")
        phase_digits_eval(report, card)
    if "digits_train" in phases:
        log(f"[digits_train] LeNet f32 Adam(1e-3) from scratch, "
            f"fit(DigitsDataSetIterator({DIGITS_BATCH}), "
            f"epochs={DIGITS_EPOCHS}); updaters; SimpleCNN two epochs")
        phase_digits_train(report, card, args.profile)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    kernels = []
    for name, k in summary.items():
        entry = {key: k[key] for key in
                 ("name", "route", "source", "replaces")}
        # the main paths' launches: served traffic and the K-step train
        # call (conv kernels); scoring, generation and the K-step train
        # call (LSTM kernels); two output() calls and the K-step train
        # call (flash kernels)
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
