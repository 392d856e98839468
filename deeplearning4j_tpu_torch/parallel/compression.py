"""Threshold gradient compression (1-bit encoding with residual).

The port of the JAX package's ``parallel/compression.py`` (reference:
EncodedGradientsAccumulator.java:255-292, EncodingHandler.java:26). The
quantization (``grad + residual`` clipped to {-t, 0, +t}, the rest kept
in the residual) runs in torch on the gradient's device; the wire codecs
are host-side numpy, copied from the JAX package bit for bit (a message
from either package decodes in the other), and use the native C++ codec
(``utils/native.py``) when it is built. The adaptive threshold schedule
keeps the knobs of ``SharedTrainingMaster.java:72-107``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves, tree_map

FLEXIBLE_ENCODING = 0
BITMAP_ENCODING = 1

# bitmap when the sparse index list would cost more than 2 bits/element
_BITMAP_DENSITY_CUTOFF = 2.0 / 32.0


# ---- device-side quantization ----------------------------------------------

def quantize(grad: torch.Tensor, residual: torch.Tensor, threshold
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threshold-quantize ``grad + residual`` to int8 signs in {-1, 0, 1};
    returns ``(signs, new_residual)``. The decoded update is
    ``signs * threshold``; what was not sent stays in the residual."""
    acc = grad + residual
    one = torch.ones((), dtype=torch.int8, device=acc.device)
    signs = torch.where(acc >= threshold, one,
                        torch.where(acc <= -threshold, -one,
                                    torch.zeros_like(one)))
    new_residual = acc - signs.to(acc.dtype) * threshold
    return signs, new_residual


def dequantize(signs: torch.Tensor, threshold,
               dtype=torch.float32) -> torch.Tensor:
    return signs.to(dtype) * threshold


def quantize_pytree(grads, residuals, threshold):
    """:func:`quantize` over nested dicts; (signs tree, residual tree)."""
    pairs = tree_map(lambda g, r: quantize(g, r, threshold), grads,
                     residuals)
    return _split(pairs, 0), _split(pairs, 1)


def _split(tree, i):
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    return tree[i]


# ---- host-side wire codecs (bit for bit the JAX package's) -----------------

def encode_flexible(signs: np.ndarray) -> np.ndarray:
    """Sparse signed-index list: int32 header [FLEXIBLE, length, nnz]
    followed by one int32 per nonzero — (index+1) with sign."""
    flat = signs.reshape(-1)
    idx = np.nonzero(flat)[0]
    body = ((idx + 1) * flat[idx]).astype(np.int32)
    header = np.array([FLEXIBLE_ENCODING, flat.size, idx.size],
                      dtype=np.int32)
    return np.concatenate([header, body])


def encode_bitmap(signs: np.ndarray) -> np.ndarray:
    """2-bit/element codec: 00 zero, 01 plus, 10 minus; 16 elements per
    int32 word. Header [BITMAP, length, n_words]."""
    flat = signs.reshape(-1).astype(np.int64)
    codes = np.where(flat > 0, 1, np.where(flat < 0, 2, 0)).astype(np.uint64)
    pad = (-flat.size) % 16
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint64)])
    codes = codes.reshape(-1, 16)
    shifts = (2 * np.arange(16, dtype=np.uint64))
    words = np.bitwise_or.reduce(codes << shifts, axis=1).astype(np.uint32)
    header = np.array([BITMAP_ENCODING, flat.size, words.size],
                      dtype=np.int32)
    return np.concatenate([header, words.view(np.int32)])


def _host(signs) -> np.ndarray:
    if isinstance(signs, torch.Tensor):
        return signs.detach().cpu().numpy()
    return np.asarray(signs)


def encode(signs) -> np.ndarray:
    """FLEXIBLE or BITMAP by density, as the reference's native
    ThresholdCompression picks; the C++ codec when it is built."""
    signs = _host(signs)
    from deeplearning4j_tpu_torch.utils import native
    msg = native.encode(signs)
    if msg is not None:
        return msg
    nnz = int(np.count_nonzero(signs))
    density = nnz / max(signs.size, 1)
    if density > _BITMAP_DENSITY_CUTOFF:
        return encode_bitmap(signs)
    return encode_flexible(signs)


def decode(message: np.ndarray, shape=None) -> np.ndarray:
    """Either codec back to an int8 sign array."""
    message = np.asarray(message, dtype=np.int32)
    from deeplearning4j_tpu_torch.utils import native
    if native.available():
        out = native.decode(message)
        return out.reshape(shape) if shape is not None else out
    kind, length = int(message[0]), int(message[1])
    out = np.zeros(length, dtype=np.int8)
    if kind == FLEXIBLE_ENCODING:
        nnz = int(message[2])
        body = message[3:3 + nnz]
        idx = np.abs(body) - 1
        out[idx] = np.sign(body).astype(np.int8)
    elif kind == BITMAP_ENCODING:
        n_words = int(message[2])
        words = message[3:3 + n_words].view(np.uint32).astype(np.uint64)
        shifts = (2 * np.arange(16, dtype=np.uint64))
        codes = (words[:, None] >> shifts) & np.uint64(3)
        flat = np.where(codes == 1, 1, np.where(codes == 2, -1, 0))
        out = flat.reshape(-1)[:length].astype(np.int8)
    else:
        raise ValueError(f"unknown encoding kind {kind}")
    if shape is not None:
        out = out.reshape(shape)
    return out


def compression_ratio(message: np.ndarray, length: int,
                      dtype_bytes: int = 4) -> float:
    return (length * dtype_bytes) / max(message.nbytes, 1)


# ---- adaptive threshold schedule --------------------------------------------

@dataclass
class ThresholdSchedule:
    """Adaptive 1-bit threshold (``SharedTrainingMaster.java:72-107``).

    If fewer than ``step_trigger`` of the elements pass the threshold for
    ``step_delay`` consecutive iterations, the threshold is divided by
    ``threshold_step`` (never below ``min_threshold``). Every
    ``shake_frequency`` iterations a "shake" pass sends at
    ``threshold/2`` to flush stale residual.
    """
    threshold: float = 1e-3
    min_threshold: float = 1e-5
    threshold_step: float = 2.0          # divide by this on trigger
    step_trigger: float = 0.05           # fraction of elements, not permille
    step_delay: int = 50
    shake_frequency: int = 0

    _low_count: int = field(default=0, repr=False)
    _iteration: int = field(default=0, repr=False)

    def current(self) -> float:
        self._iteration += 1
        if self.shake_frequency and self._iteration % self.shake_frequency == 0:
            return self.threshold / 2.0
        return self.threshold

    def observe(self, density: float) -> None:
        """Feed back the fraction of elements that passed the threshold."""
        if density < self.step_trigger:
            self._low_count += 1
            if self._low_count >= self.step_delay:
                self.threshold = max(self.min_threshold,
                                     self.threshold / self.threshold_step)
                self._low_count = 0
        else:
            self._low_count = 0


# ---- accumulator (EncodedGradientsAccumulator) ------------------------------

class EncodedGradientsAccumulator:
    """N-worker broadcast accumulator over encoded updates
    (``EncodedGradientsAccumulator.java:33``): ``store_update`` quantizes
    one worker's gradient tree against its own residual and queues the
    encoded message for every other worker; ``apply_updates`` drains a
    worker's queue into a dense update tree (numpy leaves)."""

    def __init__(self, n_workers: int,
                 schedule: Optional[ThresholdSchedule] = None,
                 encode_wire: bool = True):
        self.n_workers = n_workers
        # one schedule per worker, as in the reference (each worker owns
        # an EncodingHandler with its own adaptive threshold)
        proto = schedule or ThresholdSchedule()
        self.schedules: List[ThresholdSchedule] = [
            ThresholdSchedule(threshold=proto.threshold,
                              min_threshold=proto.min_threshold,
                              threshold_step=proto.threshold_step,
                              step_trigger=proto.step_trigger,
                              step_delay=proto.step_delay,
                              shake_frequency=proto.shake_frequency)
            for _ in range(n_workers)]
        self.encode_wire = encode_wire
        self._queues: List[List[Tuple[np.ndarray, float]]] = [
            [] for _ in range(n_workers)]
        self._residuals: Dict[int, object] = {}
        self._template = None
        self._shapes: Optional[List[Tuple[int, ...]]] = None
        self._lock = threading.Lock()

    @property
    def schedule(self) -> ThresholdSchedule:
        return self.schedules[0]

    def store_update(self, worker: int, grads) -> None:
        with self._lock:
            if worker not in self._residuals:
                self._residuals[worker] = tree_map(torch.zeros_like, grads)
            threshold = self.schedules[worker].current()
            residual = self._residuals[worker]
        signs, new_res = quantize_pytree(grads, residual, threshold)
        flat_np = [_host(s) for s in tree_leaves(signs)]
        nnz = sum(int(np.count_nonzero(s)) for s in flat_np)
        total = sum(s.size for s in flat_np)
        concat = np.concatenate([s.reshape(-1) for s in flat_np])
        msg = encode(concat) if self.encode_wire else concat
        with self._lock:
            self._residuals[worker] = new_res
            if self._template is None:
                self._template = signs
                self._shapes = [s.shape for s in flat_np]
            self.schedules[worker].observe(nnz / max(total, 1))
            for peer in range(self.n_workers):
                if peer != worker:
                    self._queues[peer].append((msg, threshold))

    def apply_updates(self, worker: int, dtype=np.float32):
        """Drain ``worker``'s queue; a dense update tree or None."""
        with self._lock:
            pending, self._queues[worker] = self._queues[worker], []
        if not pending or self._template is None:
            return None
        total = sum(int(np.prod(s)) for s in self._shapes)
        acc = np.zeros(total, dtype=dtype)
        for msg, threshold in pending:
            signs = decode(msg) if self.encode_wire else msg
            acc += signs.astype(dtype) * threshold
        leaves, off = [], 0
        for shape in self._shapes:
            n = int(np.prod(shape))
            leaves.append(acc[off:off + n].reshape(shape))
            off += n
        it = iter(leaves)
        return tree_map(lambda _: next(it), self._template)
