"""ParallelInference: thread-safe serving facade.

The port of the JAX package's ``parallel/inference.py`` (analog of the
reference's ParallelInference.java:35): ``InferenceMode.BATCHED``
aggregates concurrent requests into one device batch through
``parallel/serving.py``'s ServingEngine; ``INPLACE`` runs the caller's
request directly, under one lock, with the same request validation and
the same clamp and split at ``batch_limit`` (a request is cut into
chunks of at most ``batch_limit`` rows, each padded to the pow2 ladder),
so it too only ever runs the ladder's batch shapes.

In INPLACE mode the caller's thread runs the forward on the card: it
does so on the facade's own CUDA stream and synchronizes that stream
before the result is copied to the host.
"""

from __future__ import annotations

import contextlib
import enum
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.observe.latency import LatencyRing
from deeplearning4j_tpu_torch.parallel.deadline import (Deadline,
                                                        DeadlineExceeded)
from deeplearning4j_tpu_torch.parallel.serving import (ServingEngine,
                                                       _concrete)


class InferenceMode(enum.Enum):
    INPLACE = "inplace"
    BATCHED = "batched"   # reference default (ParallelInference.java:55)


def _validate_request(x: np.ndarray) -> np.ndarray:
    if x.ndim == 0 or x.shape[0] == 0:
        raise ValueError(
            "features must be a non-empty batch (got shape "
            f"{x.shape}); a single example is shape (1, ...)")
    return x


class ParallelInference:
    """Facade over ServingEngine (BATCHED) / the model itself (INPLACE).

    Constructor keywords beyond the reference's four are forwarded to
    ServingEngine (``feature_shape=``, ``precision=``, ...) in BATCHED
    mode, as in the JAX package. INPLACE answers requests as float32
    numpy, like the engine.
    """

    def __init__(self, model, inference_mode: InferenceMode =
                 InferenceMode.BATCHED, batch_limit: int = 32,
                 queue_limit: int = 64, timeout_ms: float = 5.0,
                 **engine_kwargs):
        self.model = model
        self.mode = inference_mode
        self.batch_limit = batch_limit
        self.timeout_ms = timeout_ms
        self.dtype = np.dtype(engine_kwargs.get("dtype", np.float32))
        self._lock = threading.Lock()
        self.engine: Optional[ServingEngine] = None
        self._stream = None
        if self.mode == InferenceMode.BATCHED:
            self.engine = ServingEngine(
                model, batch_limit=batch_limit, queue_limit=queue_limit,
                timeout_ms=timeout_ms, **engine_kwargs)
            self.device = self.engine.device
        else:
            self.device = _concrete(getattr(model, "device", "cpu"))
            if self.device.type == "cuda":
                # the model's params were written on the current stream
                self._stream = torch.cuda.Stream(self.device)
                self._stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            self.latency = LatencyRing()

    # ---- public API ------------------------------------------------------
    def output(self, features,
               deadline: Optional[Deadline] = None) -> np.ndarray:
        """Blocking inference (reference: ParallelInference.output:113).
        An expired ``deadline`` raises ``DeadlineExceeded`` before the
        device is touched."""
        if self.mode == InferenceMode.BATCHED:
            return self.engine.output(features, deadline=deadline)
        x = _validate_request(np.asarray(features))
        if x.dtype != self.dtype:
            x = x.astype(self.dtype)
        t0 = time.perf_counter()
        with self._lock:
            if deadline is not None and deadline.expired:
                raise DeadlineExceeded("inplace: deadline expired")
            out = self._output_inplace(x)
        self.latency.record(time.perf_counter() - t0)
        return out

    def _output_inplace(self, x: np.ndarray) -> np.ndarray:
        """Direct call, clamped to the pow2 ladder <= batch_limit:
        oversized requests split across dispatches instead of padding
        past the limit."""
        outs = []
        for ofs in range(0, x.shape[0], self.batch_limit):
            chunk = x[ofs:ofs + self.batch_limit]
            n = chunk.shape[0]
            bucket = min(1 << (n - 1).bit_length(), self.batch_limit)
            if bucket > n:
                pad = np.repeat(chunk[-1:], bucket - n, axis=0)
                chunk = np.concatenate([chunk, pad], axis=0)
            with (torch.cuda.stream(self._stream)
                  if self._stream is not None
                  else contextlib.nullcontext()):
                y = self.model.output(chunk)
            if isinstance(y, torch.Tensor):
                if self._stream is not None:
                    self._stream.synchronize()
                y = y[:n].float().cpu().numpy()
            outs.append(np.asarray(y)[:n])
        if len(outs) == 1:
            return outs[0]
        return np.concatenate(outs, axis=0)

    def stats(self) -> Dict[str, Any]:
        """The engine's snapshot (BATCHED), or the direct path's."""
        if self.engine is not None:
            return self.engine.stats()
        return {"mode": self.mode.value, "device": str(self.device),
                "batch_limit": self.batch_limit,
                "requests": self.latency.count,
                "latency_ms": {f"p{int(k * 100)}": v * 1e3 for k, v in
                               self.latency.quantiles().items()}}

    def shutdown(self):
        if self.engine is not None:
            self.engine.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
