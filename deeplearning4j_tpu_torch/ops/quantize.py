"""Int8 post-training quantization primitives.

The port of the JAX package's ``ops/quantize.py``: per-channel symmetric
int8 weights and per-layer static activation scales, with the matmul
taking int8 x int8 -> int32 and a fused dequant-rescale back to f32.

Conventions (all symmetric, zero-point-free):

- **Weights** quantize per OUTPUT channel: scale[o] = absmax(W[..., o])
  / 127 so each channel uses the full int8 range regardless of the
  others. Dense kernels are (n_in, n_out) -> reduce axis 0.
- **Activations** quantize with ONE static scalar scale per layer.
- **Dequant** folds both scales into a single f32 multiply on the int32
  accumulator: y = (xq @ wq) * (x_scale * w_scale[o]).

Scale *computation* is host-side numpy (float32), a copy of the JAX
package's, so the scales and int8 weights are the same bytes in both.

The int8 products (``int8_dot``, ``int8_conv``) give the exact int32
accumulator without an integer matmul (CUDA has no int32 ``matmul``, and
``torch._int_mm`` needs more than 16 rows and K, N multiples of 8). The
contraction is cut into chunks of at most ``INT8_EXACT_K``: within one
chunk every product is an integer of magnitude <= 127² and every partial
sum stays below 2^24, so the chunk's f32 product is the integer itself in
any summation order. Each chunk is converted to int32 and the chunks are
added in int32, which is the accumulator ``preferred_element_type=
jnp.int32`` gives at any K. ``int8_conv`` forms its patches by
``F.unfold`` (im2col) and takes the same product per group; no cuDNN
convolution is involved, whose FFT and Winograd algorithms are not exact
on integer operands. On the card both raise while TF32 is on.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Q_MAX = 127  # symmetric int8: [-127, 127]; -128 unused (keeps |q| symmetric)

# the widest contraction whose f32 partial sums stay exact integers
INT8_EXACT_K = (1 << 24) // (Q_MAX * Q_MAX)


# ---- host-side scale computation (numpy, deterministic) ------------------

def per_channel_scales(w: np.ndarray,
                       reduce_axes: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
    """f32 scale per output channel (last axis): absmax / 127. Dead
    channels (all-zero) get scale 1.0 so dequant never divides by 0."""
    w = np.asarray(w, np.float32)  # host-sync-ok: quantization happens host-side once, before serving — numpy IS the point (bitwise-deterministic scales)
    if reduce_axes is None:
        reduce_axes = tuple(range(w.ndim - 1))
    amax = np.max(np.abs(w), axis=tuple(reduce_axes))
    amax = np.where(amax > 0, amax, np.float32(Q_MAX))
    return (amax / np.float32(Q_MAX)).astype(np.float32)


def quantize_weight(w: np.ndarray,
                    reduce_axes: Optional[Sequence[int]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 quantization of a weight
    tensor whose LAST axis is the output channel. Returns
    ``(w_q int8, scales f32[n_out])``; ``w ≈ w_q * scales``."""
    w = np.asarray(w, np.float32)  # host-sync-ok: one-time host-side weight quantization, not a serving hot path
    scales = per_channel_scales(w, reduce_axes)
    q = np.rint(w / scales)                     # broadcast over last axis
    q = np.clip(q, -Q_MAX, Q_MAX).astype(np.int8)
    return q, scales


def quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-ROW symmetric int8 quantization of a matrix of row vectors
    (a retrieval corpus shard, a batch of session carries): scale[i] =
    absmax(x[i, :]) / 127, dead rows scale 1.0. Returns ``(x_q int8
    [N, D], scales f32 [N])``; ``x ≈ x_q * scales[:, None]``. The
    row-major twin of :func:`quantize_weight` (which reduces all-but-
    last); scales stay host numpy so two processes quantizing the same
    corpus produce bitwise-identical shards."""
    x = np.asarray(x, np.float32)  # host-sync-ok: one-time host-side corpus quantization at index build, not a query hot path
    amax = np.max(np.abs(x), axis=1)
    amax = np.where(amax > 0, amax, np.float32(Q_MAX))
    scales = (amax / np.float32(Q_MAX)).astype(np.float32)
    q = np.rint(x / scales[:, None])
    q = np.clip(q, -Q_MAX, Q_MAX).astype(np.int8)
    return q, scales


def activation_scale(amax: float) -> np.float32:
    """Static per-layer activation scale from a calibrated absmax."""
    a = np.float32(amax)
    if not np.isfinite(a) or a <= 0:
        a = np.float32(Q_MAX)                   # degenerate: identity scale
    return np.float32(a / np.float32(Q_MAX))


# ---- device-side quantized compute (torch) -------------------------------

def quantize_act(x: torch.Tensor, x_scale) -> torch.Tensor:
    """f32 activation -> int8 with the layer's static scale (symmetric,
    saturating). ``torch.round`` rounds half to even, as ``jnp.round``
    does."""
    q = torch.round(x.to(torch.float32) / x_scale)
    return torch.clamp(q, -Q_MAX, Q_MAX).to(torch.int8)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of integer-valued f32 operands in [-127, 127] as the
    exact int32 accumulator: K in chunks of at most ``INT8_EXACT_K``,
    each exact in f32, added in int32."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("int8 product: TF32 is on, which rounds the "
                           "f32 products; set torch.backends.cuda.matmul."
                           "allow_tf32 = False")
    k = a.shape[-1]
    acc = None
    for lo in range(0, k, INT8_EXACT_K):
        part = torch.matmul(a[..., lo:lo + INT8_EXACT_K],
                            b[lo:lo + INT8_EXACT_K]).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def int8_dot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
             x_scale: torch.Tensor) -> torch.Tensor:
    """``act(x) @ w_q`` in int8 with an exact int32 accumulation and the
    fused dequant-rescale: works on (N, F) and (N, T, F) alike (contracts
    the last axis of x with axis 0 of w_q)."""
    xq = quantize_act(x, x_scale)
    y32 = _int_matmul(xq.to(torch.float32), w_q.to(torch.float32))
    return y32.to(torch.float32) * (x_scale * w_scale)


def _conv_pads(padding, hw, k, s, d):
    """((top, bottom), (left, right)) of XLA's padding argument: explicit
    pairs, "VALID", or "SAME" (output ceil(size / stride), the extra row
    or column at the end)."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding != "SAME":
            raise ValueError(f"padding must be SAME, VALID or pairs, got "
                             f"{padding!r}")
        out = []
        for ax in (0, 1):
            n_out = -(-hw[ax] // s[ax])
            eff_k = (k[ax] - 1) * d[ax] + 1
            total = max((n_out - 1) * s[ax] + eff_k - hw[ax], 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def int8_conv_accumulator(xq: torch.Tensor, w_q: torch.Tensor, *,
                          window_strides, padding, rhs_dilation,
                          feature_group_count: int = 1) -> torch.Tensor:
    """The exact int32 accumulator of an int8 convolution of quantized
    NHWC activations ``xq`` (int8) and HWIO weights ``w_q``: im2col by
    ``F.unfold``, then each group's exact product."""
    kh, kw, cig, cout = w_q.shape
    s = tuple(int(v) for v in window_strides)
    d = tuple(int(v) for v in rhs_dilation)
    g = int(feature_group_count)
    n, h, w, c = xq.shape
    if c != cig * g or cout % g:
        raise ValueError(f"int8_conv: {c} input channels and {cout} "
                         f"outputs do not split into {g} groups of a "
                         f"({kh}, {kw}, {cig}, {cout}) kernel")
    (t, b), (l, r) = _conv_pads(padding, (h, w), (kh, kw), s, d)
    xf = F.pad(xq.to(torch.float32).permute(0, 3, 1, 2), (l, r, t, b))
    ho = (h + t + b - (kh - 1) * d[0] - 1) // s[0] + 1
    wo = (w + l + r - (kw - 1) * d[1] - 1) // s[1] + 1
    # (N, C·kh·kw, L): rows ordered channel-major, then kernel row, column
    cols = F.unfold(xf, (kh, kw), dilation=d, stride=s)
    cols = cols.view(n, g, cig * kh * kw, ho * wo).transpose(2, 3)
    # HWIO -> per group (cig·kh·kw, cout/g), rows in unfold's order
    wf = w_q.to(torch.float32).permute(2, 0, 1, 3).reshape(
        cig * kh * kw, g, cout // g).transpose(0, 1)
    outs = [_int_matmul(cols[:, i], wf[i]) for i in range(g)]
    return torch.cat(outs, dim=-1).view(n, ho, wo, cout)


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              x_scale: torch.Tensor, *, window_strides, padding,
              rhs_dilation, feature_group_count: int = 1) -> torch.Tensor:
    """Int8 convolution with an exact int32 accumulation and the fused
    dequant, NHWC activations and HWIO weights: the f32 layer's geometry
    (strides, XLA padding, dilation, groups) forwarded verbatim, so the
    quantized op computes the same spatial map."""
    y32 = int8_conv_accumulator(
        quantize_act(x, x_scale), w_q, window_strides=window_strides,
        padding=padding, rhs_dilation=rhs_dilation,
        feature_group_count=feature_group_count)
    return y32.to(torch.float32) * (x_scale * w_scale)
