"""ServingEngine: pipelined batched inference over committed params.

The port of the JAX package's ``parallel/serving.py`` engine, for one
device:

1. **Bounded bucket ladder + request splitting.** Batches pad to the
   smallest power-of-two bucket in ``[min_bucket, batch_limit]`` (the
   limit included even when it is not a power of two); a request larger
   than ``batch_limit`` is split across dispatches at ``submit`` and
   reassembled, so the set of batch shapes the model ever sees is the
   ladder. A warmup runs one forward per bucket at start.
2. **Committed inference params.** Parameters and layer state are put on
   the device once at engine start, in float32 or cast to bf16
   (``precision="bf16"``), and each layer's inference constants (the
   fused blocks' BN scale/shift) are folded into the committed state once
   (``ComputationGraph.inference_state``); the model's own parameters and
   state are untouched.
3. **Pipelined dispatch.** The dispatcher thread forms a batch, launches
   the forward on the device stream, enqueues the device→host copy of the
   result into pinned memory and records an event; the completion thread
   waits on that event and answers the waiters. Launches return before
   the device finishes, so batch N+1 is formed and launched while batch N
   computes. The pipe between the threads holds ``depth`` batches; while
   it is full the dispatcher keeps coalescing arrivals up to
   ``timeout_ms``.
4. **Latency observability.** ``stats()`` reports streaming p50/p95/p99
   (observe/latency.py), dispatch and batch counts and queue depth.

Numerical contract: a request's rows are computed at the bucket shape
and sliced back; padded rows repeat the last real row. The fused conv
kernels compute each row independently of the batch, so a row's answer
does not depend on what it was batched with; the plain torch ops of the
stem and head (cuDNN/cuBLAS) may pick another algorithm per batch size,
which chip_smoke.py measures against ``model.output``.

Not ported yet: multi-replica fan-out, int8, the AOT cache, deadlines,
chaos sites, the Prometheus registry and span tracer.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.observe.latency import LatencyRing


class _Request(NamedTuple):
    """One enqueued chunk: host features, its waiter, arrival time."""
    x: np.ndarray
    future: Future
    t_enqueue: float


class _InFlight(NamedTuple):
    """A dispatched batch travelling dispatcher -> completion thread."""
    host: torch.Tensor                  # (pinned) host copy being filled
    done: Optional[torch.cuda.Event]    # None on the CPU (already done)
    requests: List[_Request]
    n_real: int
    bucket: int
    t_dispatched: float


class ServingEngine:
    """Thread-safe batched inference over one model's committed params.

    Parameters
    ----------
    model : a single-input single-output ``ComputationGraph`` (exposes
        ``build_inference_fn``); the engine serves on the model's device
    batch_limit : max examples per dispatch; also the ladder's top bucket
    queue_limit : bound on queued request chunks (producers block)
    timeout_ms : UPPER bound on batch aggregation; the pipelined engine
        only waits at all while the completion pipe is full
    depth : in-flight batches handed to the completion thread
    min_bucket : the ladder's smallest bucket
    feature_shape : per-example feature shape (no batch dim); providing
        it enables the warmup sweep at start
    dtype : feature dtype requests are cast to (default float32)
    precision : "f32" (default) or "bf16" (cast the committed copy of the
        float params to bfloat16; the BN running state stays float32)
    """

    def __init__(self, model, *, batch_limit: int = 32,
                 queue_limit: int = 128, timeout_ms: float = 5.0,
                 depth: int = 1, min_bucket: int = 1,
                 feature_shape: Optional[Tuple[int, ...]] = None,
                 dtype: Any = np.float32, precision: str = "f32",
                 warmup: Optional[bool] = None,
                 session_id: str = "serve"):
        if batch_limit < 1:
            raise ValueError("batch_limit must be >= 1")
        if not 1 <= min_bucket <= batch_limit:
            raise ValueError("need 1 <= min_bucket <= batch_limit")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', got "
                             f"{precision!r} (int8 is not ported yet)")
        self.model = model
        self.device = model.device
        self.batch_limit = int(batch_limit)
        self.timeout_ms = float(timeout_ms)
        self.depth = int(depth)
        self.session_id = session_id
        self.precision = precision
        self.dtype = np.dtype(dtype)
        self.feature_shape = (None if feature_shape is None
                              else tuple(feature_shape))
        self.latency = LatencyRing()

        ladder, b = [], 1 << (min_bucket - 1).bit_length()
        while b < self.batch_limit:
            ladder.append(b)
            b <<= 1
        ladder.append(self.batch_limit)
        self.ladder = ladder

        # ---- committed inference params ----------------------------------
        if model.params is None:
            model.init()
        cast = ((lambda t: t.to(torch.bfloat16) if t.is_floating_point()
                 else t) if precision == "bf16" else (lambda t: t))
        with torch.no_grad():
            self._params = {ln: {k: cast(v).to(self.device).clone()
                                 for k, v in lp.items()}
                            for ln, lp in model.params.items()}
            self._state = model.inference_state(self._params, {
                ln: {k: v.to(self.device).clone() for k, v in st.items()}
                for ln, st in model.model_state.items()})
        self._fwd = model.build_inference_fn()

        self.dispatch_count = 0
        self.device_ms_total = 0.0
        self._inflight_count = 0
        self._count_lock = threading.Lock()
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=queue_limit)
        self._carry: Optional[_Request] = None
        self._carry_lock = threading.Lock()
        self._completions: "queue.Queue[Optional[_InFlight]]" = \
            queue.Queue(maxsize=self.depth)
        self._shutdown = threading.Event()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"serving-dispatch-{session_id}")
        self._completer = threading.Thread(
            target=self._complete_loop, daemon=True,
            name=f"serving-complete-{session_id}")

        do_warmup = (self.feature_shape is not None if warmup is None
                     else bool(warmup))
        self.warmup_seconds = 0.0
        if do_warmup:
            if self.feature_shape is None:
                raise ValueError("warmup needs feature_shape (and dtype)")
            t0 = time.perf_counter()
            for bucket in self.ladder:
                self._run(np.zeros((bucket,) + self.feature_shape,
                                   self.dtype))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.warmup_seconds = time.perf_counter() - t0
        self._dispatcher.start()
        self._completer.start()

    # ---- bucket ladder ---------------------------------------------------
    def bucket_of(self, n: int) -> int:
        """Smallest ladder bucket >= n (n must be <= batch_limit)."""
        for b in self.ladder:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds batch_limit "
                         f"{self.batch_limit}")

    def _run(self, x: np.ndarray) -> torch.Tensor:
        """Launch the forward for one padded batch; returns the device
        result (not yet synchronized)."""
        xt = torch.from_numpy(np.ascontiguousarray(x, self.dtype))
        if self.device.type == "cuda":
            xt = xt.pin_memory().to(self.device, non_blocking=True)
        return self.forward(xt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The committed forward on one batch already on the device (no
        queueing, padding or splitting) — what every dispatch runs."""
        return self._fwd(self._params, self._state, x)

    # ---- public API ------------------------------------------------------
    def submit(self, features) -> Future:
        """Enqueue a request; the Future resolves to the (N, ...) host
        output as numpy. Oversized requests split across dispatches and
        reassemble transparently."""
        x = np.asarray(features)
        if x.ndim == 0 or x.shape[0] == 0:
            raise ValueError(
                "features must be a non-empty batch (got shape "
                f"{x.shape}); a single example is shape (1, ...)")
        if self.feature_shape is None:
            self.feature_shape = x.shape[1:]   # first request fixes it
        elif x.shape[1:] != self.feature_shape:
            raise ValueError(
                f"request feature shape {x.shape[1:]} does not match "
                f"the engine's {self.feature_shape}")
        if x.dtype != self.dtype:
            x = x.astype(self.dtype)
        if self._shutdown.is_set():
            raise RuntimeError("ServingEngine is shut down")
        chunks = [x[i:i + self.batch_limit]
                  for i in range(0, x.shape[0], self.batch_limit)]
        with self._count_lock:
            self._inflight_count += 1
        try:
            futures = [self._enqueue(c) for c in chunks]
        except BaseException:
            with self._count_lock:
                self._inflight_count -= 1
            raise
        if len(futures) == 1:
            self._track(futures[0])
            return futures[0]
        return self._join_futures(futures)

    def output(self, features) -> np.ndarray:
        """Blocking inference (reference: ParallelInference.output:113)."""
        return self.submit(features).result()

    def _enqueue(self, chunk: np.ndarray) -> Future:
        f: Future = Future()
        req = _Request(chunk, f, time.perf_counter())
        while True:
            if self._shutdown.is_set():
                raise RuntimeError("ServingEngine is shut down")
            try:
                self._queue.put(req, timeout=0.1)
                break
            except queue.Full:
                continue
        if self._shutdown.is_set():
            self._drain_queue()     # raced with shutdown()
        return f

    def _track(self, f: Future):
        def done(_):
            with self._count_lock:
                self._inflight_count -= 1
        f.add_done_callback(done)

    def _join_futures(self, parts: List[Future]) -> Future:
        """One Future over a split request: concatenated result in chunk
        order, or the first chunk failure."""
        outer: Future = Future()
        self._track(outer)
        remaining = [len(parts)]
        lock = threading.Lock()

        def on_done(_f):
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if not last or outer.done():
                return
            try:
                outer.set_result(
                    np.concatenate([p.result() for p in parts], axis=0))
            except Exception as e:
                outer.set_exception(e)
        for p in parts:
            p.add_done_callback(on_done)
        return outer

    @property
    def inflight(self) -> int:
        """Requests accepted but not yet answered."""
        return self._inflight_count

    def stats(self) -> Dict[str, Any]:
        """Point-in-time snapshot."""
        q = self.latency.quantiles()
        with self._carry_lock:
            carried = 1 if self._carry is not None else 0
        return {
            "session": self.session_id,
            "device": str(self.device),
            "ladder": list(self.ladder),
            "precision": self.precision,
            "batches": self.dispatch_count,
            "device_ms_total": self.device_ms_total,
            "requests": self.latency.count,
            "inflight": self._inflight_count,
            "queue_depth": self._queue.qsize() + carried,
            "warmup_s": self.warmup_seconds,
            "latency_ms": {f"p{int(k * 100)}": v * 1e3
                           for k, v in q.items()},
        }

    # ---- dispatcher ------------------------------------------------------
    def _form_batch(self) -> Optional[List[_Request]]:
        with self._carry_lock:
            first, self._carry = self._carry, None
        if first is None:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                return None
        batch = [first]
        total = first.x.shape[0]
        deadline = time.monotonic() + self.timeout_ms / 1000.0
        while total < self.batch_limit:
            # only wait for stragglers while the completion pipe is full
            # (device busy) — never idle a free device on the timer
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                rem = deadline - time.monotonic()
                if rem <= 0 or not self._completions.full():
                    break
                try:
                    item = self._queue.get(timeout=min(rem, 0.001))
                except queue.Empty:
                    continue
            if total + item.x.shape[0] > self.batch_limit:
                with self._carry_lock:
                    self._carry = item     # next batch takes it
                break
            batch.append(item)
            total += item.x.shape[0]
        return batch

    def _dispatch_loop(self):
        while not self._shutdown.is_set():
            batch = self._form_batch()
            if not batch:
                continue
            try:
                inflight = self._dispatch(batch)
            except Exception as e:
                # a failed batch must fail its waiters, not kill the
                # dispatcher (they would hang forever)
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
                continue
            while True:
                try:
                    self._completions.put(inflight, timeout=0.1)
                    break
                except queue.Full:
                    if not self._completer.is_alive():
                        err = RuntimeError("serving completion thread died")
                        for req in inflight.requests:
                            if not req.future.done():
                                req.future.set_exception(err)
                        break

    def _dispatch(self, batch: List[_Request]) -> _InFlight:
        n = sum(req.x.shape[0] for req in batch)
        bucket = self.bucket_of(n)
        x = np.empty((bucket,) + batch[0].x.shape[1:], self.dtype)
        ofs = 0
        for req in batch:
            k = req.x.shape[0]
            x[ofs:ofs + k] = req.x
            ofs += k
        if bucket > n:
            x[n:] = x[n - 1]     # finite padding rows, sliced off below
        t0 = time.perf_counter()
        out = self._run(x)
        done = None
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host = out
        self.dispatch_count += 1
        return _InFlight(host, done, batch, n, bucket, t0)

    # ---- completion ------------------------------------------------------
    def _complete_loop(self):
        while True:
            item = self._completions.get()
            if item is None:
                return
            self._complete(item)

    def _complete(self, inflight: _InFlight):
        try:
            if inflight.done is not None:
                inflight.done.synchronize()
            t_ready = time.perf_counter()
            self.device_ms_total += (t_ready - inflight.t_dispatched) * 1e3
            host = inflight.host
            if host.dtype == torch.bfloat16:
                host = host.float()
            host = host.numpy()
            ofs = 0
            for req in inflight.requests:
                k = req.x.shape[0]
                if not req.future.done():
                    req.future.set_result(host[ofs:ofs + k].copy())
                ofs += k
                self.latency.record(t_ready - req.t_enqueue)
        except Exception as e:    # propagate to every waiter
            for req in inflight.requests:
                if not req.future.done():
                    req.future.set_exception(e)

    # ---- lifecycle -------------------------------------------------------
    def shutdown(self):
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        self._dispatcher.join(timeout=5)
        # the completer drains in-flight batches (their results are
        # valid), then takes the sentinel
        while self._completer.is_alive():
            try:
                self._completions.put(None, timeout=0.1)
                break
            except queue.Full:
                continue
        self._completer.join(timeout=5)
        self._drain_queue()

    def _drain_queue(self):
        """Fail any still-queued request (post-shutdown)."""
        with self._carry_lock:
            carried, self._carry = self._carry, None
        if carried is not None and not carried.future.done():
            carried.future.set_exception(
                RuntimeError("ServingEngine shut down"))
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("ServingEngine shut down"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
