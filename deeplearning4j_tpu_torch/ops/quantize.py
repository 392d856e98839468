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

The int8 product (``int8_dot``) is exact without an integer matmul:
CUDA has no int32 ``matmul`` and ``torch._int_mm`` needs N divisible by
8. The int8 operands are cast to f32 and multiplied; every product is
an integer of magnitude <= 127², and every partial sum stays below 2^24
while K·127² < 2^24 (K <= 1040), so each f32 partial sum is the integer
itself, in any summation order: the f32 result equals the int32
accumulation bit for bit. The wrapper raises for a wider K, and on the
card while TF32 would round the operands. ``int8_conv`` is not ported
yet (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

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


def int8_dot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
             x_scale: torch.Tensor) -> torch.Tensor:
    """``act(x) @ w_q`` in int8 with an exact int32 accumulation and the
    fused dequant-rescale: works on (N, F) and (N, T, F) alike (contracts
    the last axis of x with axis 0 of w_q)."""
    k = w_q.shape[0]
    if k > INT8_EXACT_K:
        raise ValueError(
            f"int8_dot: contraction {k} > {INT8_EXACT_K}; the f32 route "
            "is exact only while K·127² < 2^24")
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("int8_dot: TF32 is on, which rounds the int8 "
                           "operands; set torch.backends.cuda.matmul."
                           "allow_tf32 = False")
    xq = quantize_act(x, x_scale)
    y32 = torch.matmul(xq.to(torch.float32), w_q.to(torch.float32))
    return y32 * (x_scale * w_scale)
