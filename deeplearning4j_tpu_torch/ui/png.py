"""Minimal dependency-free PNG encoding for the dashboard.

The reference's ConvolutionalListenerModule streams conv activations to
the UI as PNGs rendered with java.awt (deeplearning4j-play/.../
ConvolutionalListenerModule.java:1). Here: an 8-bit grayscale PNG writer
over zlib — enough for activation heat-maps, no imaging library needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png_gray(img: np.ndarray) -> bytes:
    """(H, W) array (any float/int range) → 8-bit grayscale PNG bytes.
    Floats are min-max scaled to [0, 255]."""
    a = np.asarray(img)
    if a.ndim != 2:
        raise ValueError(f"expected (H, W), got {a.shape}")
    if a.dtype != np.uint8:
        a = a.astype(np.float64)
        lo, hi = float(a.min()), float(a.max())
        a = ((a - lo) / (hi - lo or 1.0) * 255.0).astype(np.uint8)
    h, w = a.shape
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def activation_grid(act: np.ndarray, max_channels: int = 64) -> np.ndarray:
    """(H, W, C) activation → one (gridH, gridW) mosaic of per-channel
    heat-maps (the reference UI's channel tile layout)."""
    a = np.asarray(act, np.float64)
    if a.ndim == 1:        # (N_features,) dense activations → one row
        # image, ONE channel — per-pixel tiles would each min-max
        # normalize to a black 1x1 square
        a = a[None, :, None]
    if a.ndim == 2:        # (H, W) single-channel map
        a = a[:, :, None]
    h, w, c = a.shape
    c = min(c, max_channels)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    pad = 1
    grid = np.zeros((rows * (h + pad) + pad, cols * (w + pad) + pad))
    for i in range(c):
        r, col = divmod(i, cols)
        ch = a[:, :, i]
        lo, hi = ch.min(), ch.max()
        grid[pad + r * (h + pad): pad + r * (h + pad) + h,
             pad + col * (w + pad): pad + col * (w + pad) + w] = \
            (ch - lo) / ((hi - lo) or 1.0)
    return grid
