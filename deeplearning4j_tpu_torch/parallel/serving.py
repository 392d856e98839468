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
   (``precision="bf16"``), and, for a model that defines
   ``inference_state`` (``ComputationGraph``), each layer's inference
   constants (the fused blocks' BN scale/shift) are folded into the
   committed state once; the model's own parameters and state are
   untouched. Any model exposing ``build_inference_fn`` is served
   (``ComputationGraph``, ``MultiLayerNetwork``); a duck-typed model
   with only ``.output`` runs that call under the same batching.
   ``swap_params`` replaces the committed copy without a new warmup.
3. **Pipelined dispatch.** The dispatcher thread forms a batch, launches
   the forward on the engine's CUDA stream, enqueues the device→host
   copy of the result into pinned memory and records an event; the
   completion thread waits on that event and answers the waiters.
   Launches return before the device finishes, so batch N+1 is formed
   and launched while batch N computes. The pipe between the threads
   holds ``depth`` batches; while it is full the dispatcher keeps
   coalescing arrivals up to ``timeout_ms``.
4. **Deadlines.** ``submit``/``output(deadline=)``: an expired deadline
   sheds synchronously with ``DeadlineExceeded``; one that expires while
   queued sheds at batch forming, before the device.
5. **Observability.** ``stats()`` reports streaming p50/p95/p99
   (observe/latency.py), dispatch and batch counts and queue depth; the
   ``dl4j_serving_*`` series go to the metrics registry scraped at
   ``/metrics``, labelled by the engine's ``session`` so two engines (a
   swap's old and new version) never share a series. "Compile" in the
   port: a *compile* is the first dispatch of a bucket (an engine has
   one precision and one device); the warmup sweep makes each one, and a later one counts as
   ``phase="live"`` and fails ``assert_warm()``. The
   ``RecompileWatchdog`` keys each bucket on its own, so the sweep never
   reads as a recompile storm at ``/healthz``.

Numerical contract: a request's rows are computed at the bucket shape
and sliced back; padded rows repeat the last real row. The fused conv
kernels compute each row independently of the batch, so a row's answer
does not depend on what it was batched with; the plain torch ops of the
stem and head (cuDNN/cuBLAS) may pick another algorithm per batch size,
which chip_smoke.py measures against ``model.output``.

Precision: ``precision`` is a ``PrecisionPolicy`` (parallel/quant.py)
or its mode string. ``"int8"`` quantizes a MultiLayerNetwork through
``quantize_model`` at engine start (calibrated on the policy's samples)
and commits the quantized params and walk; ``stats()["quant"]`` reports
the calibration hash, the budget, the fallback layers and each layer's
error, which also goes to the ``dl4j_quant_layer_error{layer,
quantized}`` gauge. An int8 engine cannot ``swap_params`` (the weights
bake calibration scales): the fleet builds a new engine instead.

Tuned configs: ``batch_limit`` left at None takes ``tuned_config``'s
``serving.batch_limit``, else the installed process config's, else 32
(optimize/autotune.py).

Persisted kernel cache: with ``aot_cache_dir`` (and a ``feature_shape``)
the engine fingerprints its committed params and serving contract and
restores, before its warmup, the kernel libraries a matching entry holds
(parallel/aot_cache.py), so a warm process runs no ``nvcc``; a cold or
mismatched cache is filled after the warmup with the libraries the
warmup's forwards reached. ``dl4j_serving_aot_cache_total{event=hit|
miss|save}`` counts libraries, and ``stats()["aot_cache"]`` reports the
cache's state and the field a mismatch diverged on.

Not ported yet (raises ``NotImplementedError`` naming its ROADMAP queue
1 item): more than one replica (item 15, its second half).

Spans: with a ``tracer`` (observe/tracer.py) the engine records the JAX
engine's spans — ``serve_compile`` (an instant at a bucket's first
dispatch), ``serve_warmup``, and for every batch one ``queue_wait`` per
request, ``batch_form``, ``dispatch`` (the host's launch of the forward
and of the result's asynchronous copy to pinned memory), ``device``
(until the copy's event completes) and ``fetch`` (the pinned result to
numpy).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.chaos.hook import chaos_site
from deeplearning4j_tpu_torch.models.serialization import flatten_paths
from deeplearning4j_tpu_torch.observe.latency import LatencyRing
from deeplearning4j_tpu_torch.observe.recompile import RecompileWatchdog
from deeplearning4j_tpu_torch.observe.registry import default_registry
from deeplearning4j_tpu_torch.observe.tracer import NULL_TRACER
from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.optimize.autotune import resolve_tuned
from deeplearning4j_tpu_torch.optimize.updaters import tree_map
from deeplearning4j_tpu_torch.parallel.aot_cache import AOTExecutableCache
from deeplearning4j_tpu_torch.parallel.aot_cache import \
    fingerprint as aot_fingerprint
from deeplearning4j_tpu_torch.parallel.deadline import (Deadline,
                                                        DeadlineExceeded)
from deeplearning4j_tpu_torch.parallel.quant import (PrecisionPolicy,
                                                     params_nbytes,
                                                     quantize_model)

REPLICA = 0          # the one dispatch target (the JAX engine's replica 0)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServingEngine: {what} is not ported yet (ROADMAP.md, queue 1 "
        f"item {item})")


class _Request(NamedTuple):
    """One enqueued chunk: host features, its waiter, arrival time,
    and the caller's remaining-budget deadline (None = unbounded)."""
    x: np.ndarray
    future: Future
    t_enqueue: float
    deadline: Optional[Deadline] = None


class _InFlight(NamedTuple):
    """A dispatched batch travelling dispatcher -> completion thread."""
    host: Any                           # (pinned) host copy being filled
    done: Optional[torch.cuda.Event]    # None off the card (already done)
    requests: List[_Request]
    n_real: int
    bucket: int
    t_dispatched: float                 # before the forward's launch
    t_launched: float = 0.0             # after it (and the copy's)


def _concrete(device) -> torch.device:
    """``device`` with its card index filled in (``cuda`` -> ``cuda:0``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ServingEngine:
    """Thread-safe batched inference over one model's committed params.

    Parameters
    ----------
    model : a model exposing ``build_inference_fn`` (``ComputationGraph``
        with one input and one output, ``MultiLayerNetwork``), served on
        the model's device; or a duck-typed object with ``.output`` only
    batch_limit : max examples per dispatch; also the ladder's top bucket
        (default: the ``serving.batch_limit`` tunable's 32)
    queue_limit : bound on queued request chunks (producers block)
    timeout_ms : UPPER bound on batch aggregation; the pipelined engine
        only waits at all while the completion pipe is full
    depth : in-flight batches handed to the completion thread
    replicas : 1 or "auto" (every visible card); one card is ported
    min_bucket : the ladder's smallest bucket
    feature_shape : per-example feature shape (no batch dim); providing
        it enables the warmup sweep at start
    dtype : feature dtype requests are cast to (default float32)
    precision : a ``PrecisionPolicy`` or its mode: "f32" (default),
        "bf16" (cast the committed copy of the float params to bfloat16;
        the BN running state stays float32) or "int8" (a policy carrying
        calibration samples: ``PrecisionPolicy.int8(samples)``)
    aot_cache_dir : the persisted kernel cache's directory (module
        docstring); needs ``feature_shape``
    model_version : opaque version label (the fleet's swap path sets it),
        part of the cache's fingerprint
    tuned_config : a ``TunedConfig`` sizing ``batch_limit`` when it is
        left at None
    registry, watchdog : the metrics registry (default: the process one)
        and recompile watchdog (default: one over that registry)
    tracer : an ``observe.SpanTracer`` for the engine's spans (default:
        none)
    """

    def __init__(self, model, *, batch_limit: Optional[int] = None,
                 queue_limit: int = 128, timeout_ms: float = 5.0,
                 depth: int = 1, replicas: Union[int, str] = 1, min_bucket: int = 1,
                 feature_shape: Optional[Tuple[int, ...]] = None,
                 dtype: Any = np.float32, precision: Any = "f32",
                 warmup: Optional[bool] = None,
                 aot_cache_dir: Optional[str] = None,
                 model_version: Optional[str] = None,
                 tuned_config=None, tracer=None, registry=None,
                 watchdog=None, session_id: str = "serve"):
        batch_limit = int(resolve_tuned(batch_limit, tuned_config,
                                        "serving.batch_limit"))
        if batch_limit < 1:
            raise ValueError("batch_limit must be >= 1")
        if not 1 <= min_bucket <= batch_limit:
            raise ValueError("need 1 <= min_bucket <= batch_limit")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if isinstance(precision, str):
            precision = PrecisionPolicy(mode=precision)
        self.policy = precision
        precision = precision.tag
        self.model = model
        self.device = _concrete(getattr(model, "device", "cpu"))
        n_cards = (torch.cuda.device_count() if self.device.type == "cuda"
                   else 1)
        n = n_cards if replicas == "auto" else int(replicas)
        if n > 1:
            raise _not_ported(f"serving on {n} replicas (replicas="
                              f"{replicas!r})", "15, its second half")
        if n < 1:
            raise ValueError(f"replicas={replicas!r} must be >= 1")
        self.n_replicas = 1
        self.batch_limit = batch_limit
        self.timeout_ms = float(timeout_ms)
        self.depth = int(depth)
        self.session_id = session_id
        self.precision = precision
        self.model_version = model_version
        self.tuned_config = tuned_config
        self.dtype = np.dtype(dtype)
        self.feature_shape = (None if feature_shape is None
                              else tuple(feature_shape))
        self.latency = LatencyRing()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry if registry is not None \
            else default_registry()
        self.watchdog = watchdog if watchdog is not None else \
            RecompileWatchdog(self.registry, session_id=session_id)

        ladder, b = [], 1 << (min_bucket - 1).bit_length()
        while b < self.batch_limit:
            ladder.append(b)
            b <<= 1
        ladder.append(self.batch_limit)
        self.ladder = ladder

        # ---- metrics (the JAX engine's names and label sets) -------------
        reg, lab = self.registry, dict(session=session_id,
                                       precision=precision)
        self._lab = lab
        self._c_requests = reg.counter(
            "dl4j_serving_requests_total",
            "inference requests accepted by the serving engine")
        self._c_batches = reg.counter(
            "dl4j_serving_batches_total",
            "device batches dispatched by the serving engine")
        self._c_compiles = reg.counter(
            "dl4j_serving_compiles_total",
            "bucket executables compiled, by phase (warmup|live); a "
            "nonzero live count means a request paid a compile")
        self._g_inflight = reg.gauge(
            "dl4j_serving_inflight",
            "requests accepted but not yet answered")
        self._g_queue = reg.gauge(
            "dl4j_serving_queue_depth",
            "request chunks waiting for the dispatcher")
        self._g_occupancy = reg.gauge(
            "dl4j_serving_batch_occupancy",
            "real examples / bucket size of the last dispatched batch")
        self._g_latency = reg.gauge(
            "dl4j_serving_latency_ms",
            "streaming request latency quantiles over the last 4096 "
            "requests")
        self._c_replica_disp = reg.counter(
            "dl4j_serving_replica_dispatches_total",
            "batches dispatched per replica ('mesh' = sharded full "
            "buckets across all replicas)")
        self._c_replica_busy = reg.counter(
            "dl4j_serving_replica_busy_ms",
            "cumulative ms a replica spent computing dispatched batches")
        self._g_precision = reg.gauge(
            "dl4j_serving_precision",
            "1 for the engine's active precision label (f32|bf16|int8)")
        self._g_quant_err = reg.gauge(
            "dl4j_quant_layer_error",
            "per-layer relative L2 quantization error observed on the "
            "calibration probe batch (int8 engines only; layers over "
            "the policy budget fell back to f32)")
        self._c_deadline_shed = reg.counter(
            "dl4j_serving_deadline_shed_total",
            "requests shed because their deadline expired before "
            "device dispatch; stage=ingress|batch")
        self._c_requests.inc(0.0, **lab)
        self._c_batches.inc(0.0, **lab)
        self._c_compiles.inc(0.0, phase="live", **lab)
        self._g_inflight.set(0.0, **lab)
        self._g_precision.set(1.0, **lab)
        self.dispatch_count = 0
        self.device_ms_total = 0.0

        # the one CUDA stream all of the engine's device work runs on
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

        # ---- committed inference params ----------------------------------
        # (params, model_state as given, state with inference constants
        # folded in); None for a duck-typed .output-only model
        self._committed: Optional[Tuple[Any, Any, Any]] = None
        self._fwd = None
        self.quantized = None        # QuantizedModel of an int8 engine
        self._calib_hash: Optional[str] = None
        if hasattr(model, "build_inference_fn"):
            if model.params is None:
                model.init()
            params = model.params
            if precision == "int8":
                qm = quantize_model(model, self.policy,
                                    registry=self.registry,
                                    tracer=self.tracer)
                self.quantized = qm
                self._calib_hash = qm.calibration_hash()
                params = qm.params
                self._fwd = qm.build_inference_fn()
                for lname, rep in qm.report.items():
                    self._g_quant_err.set(
                        rep["error"], session=session_id, layer=lname,
                        quantized=str(rep["quantized"]).lower())
            else:
                self._fwd = model.build_inference_fn()
            self._committed = self._commit(params, model.model_state)
        elif precision != "f32":
            raise ValueError(
                f"precision={precision!r} needs a model exposing "
                "build_inference_fn (committed params); "
                f"{type(model).__name__} only has .output")

        # ---- persisted kernel cache --------------------------------------
        self.aot_cache = None
        self._cache_fp = None
        self._c_aot = reg.counter(
            "dl4j_serving_aot_cache_total",
            "persisted kernel cache events: hit = a kernel library "
            "restored from the cache, miss = one it could not supply "
            "(built live), save = a library persisted after warmup")
        if aot_cache_dir is not None and self._committed is not None \
                and self.feature_shape is not None:
            self._open_aot_cache(aot_cache_dir)

        # ---- dispatch machinery ------------------------------------------
        self._compiled: set = set()        # buckets dispatched at least once
        self._compile_lock = threading.Lock()
        self._chaos_dispatch = chaos_site("serve.dispatch")
        self._warmed = False
        self._post_warmup_compiles = 0
        self.param_swaps = 0
        self._inflight_count = 0
        self._count_lock = threading.Lock()
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=queue_limit)
        # aggregation overflow, shared between the dispatcher and caller
        # threads (shutdown race, stats): every touch holds _carry_lock
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
        # the kernel sources the warmup's forwards reached
        self._reached: set = set()
        if do_warmup:
            if self.feature_shape is None:
                raise ValueError("warmup needs feature_shape (and dtype)")
            t0 = time.perf_counter()
            with cuda_build.record_sources() as reached:
                for bucket in self.ladder:
                    out = self._run(np.zeros((bucket,) + self.feature_shape,
                                             self.dtype), bucket)
                    del out
            self._reached = reached
            if self._stream is not None:
                self._stream.synchronize()
            self.warmup_seconds = time.perf_counter() - t0
            self.tracer.add_span("serve_warmup", t0, time.perf_counter(),
                                 cat="serve", buckets=len(self.ladder),
                                 replicas=self.n_replicas)
            if (self.aot_cache is not None
                    and self.aot_cache.state in ("cold", "mismatch")):
                self.save_aot_cache()
        self._warmed = True
        self._dispatcher.start()
        self._completer.start()

    # ---- persisted kernel cache ------------------------------------------
    def _open_aot_cache(self, cache_dir: str):
        """Fingerprint the committed params and the serving contract and
        restore the kernel libraries of a matching cache entry (before
        the warmup, so that its first launches load them)."""
        params, state, _ = self._committed
        self.aot_cache = AOTExecutableCache(cache_dir,
                                            registry=self.registry)
        self._cache_fp = aot_fingerprint(
            params, state, feature_shape=self.feature_shape,
            dtype=self.dtype, ladder=self.ladder, precision=self.precision,
            calibration=self._calib_hash, model_version=self.model_version,
            device=self.device)
        self.aot_cache.try_load(self._cache_fp)
        for event, n in (("hit", self.aot_cache.hits),
                         ("miss", self.aot_cache.misses)):
            self._c_aot.inc(float(n), event=event, **self._lab)
        if self.aot_cache.state == "mismatch" and self.quantized is not None:
            # a rejected int8 entry's reason (stale calibration?) rides
            # into any later crash dump
            from deeplearning4j_tpu_torch.observe.flight_recorder import (
                default_flight_recorder)
            rec = default_flight_recorder()
            if rec is not None:
                rec.note(f"aot_cache_rejected_{self.session_id}", {
                    "dir": str(cache_dir), "precision": self.precision,
                    "calibration": self._calib_hash,
                    "reason": self.aot_cache.reason})

    def save_aot_cache(self) -> int:
        """Persist the kernel libraries the warmup reached under the
        engine's fingerprint (called after the warmup when the cache was
        cold or stale). Returns the number of libraries saved."""
        if self.aot_cache is None:
            return 0
        n = self.aot_cache.save(self._cache_fp, self._reached)
        if n:
            self._c_aot.inc(float(n), event="save", **self._lab)
        return n

    # ---- committed params ------------------------------------------------
    def _on_device(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _cast(self, t):
        t = torch.as_tensor(t)
        if self.precision == "bf16" and t.is_floating_point():
            return t.to(torch.bfloat16)
        return t

    def _commit(self, params, model_state) -> Tuple[Any, Any, Any]:
        """Copies of ``params`` (cast to the serving precision) and
        ``model_state`` on the engine's device and stream, plus the state
        with inference constants folded in."""
        with torch.no_grad(), self._on_device():
            p = tree_map(lambda t: self._cast(t).to(self.device).clone(),
                          params)
            s = tree_map(lambda t: torch.as_tensor(t).to(
                self.device).clone(), model_state)
            fold = getattr(self.model, "inference_state", None)
            folded = fold(p, s) if fold is not None else s
        if self._stream is not None:
            self._stream.synchronize()
        return p, s, folded

    @property
    def params_resident_bytes(self) -> int:
        """Bytes of the committed params copy."""
        if self._committed is None:
            return 0
        return params_nbytes(self._committed[0])

    def committed_host(self) -> Tuple[Any, Any]:
        """Host copies (CPU tensors, never views) of the committed
        ``(params, model_state)`` — the rollback standby snapshot."""
        if self._committed is None:
            raise ValueError(
                "legacy .output-only engines have no committed params")
        params, state, _ = self._committed
        if self._stream is not None:
            self._stream.synchronize()
        copy = lambda t: t.detach().to("cpu", copy=True)
        return tree_map(copy, params), tree_map(copy, state)

    def swap_params(self, params, model_state=None, *,
                    version: Optional[str] = None) -> None:
        """Atomically replace the committed inference params without a
        new warmup: the bucket ladder and its first dispatches stay, so
        a swap of same-structured weights adds no compile. Structure,
        shapes and dtypes (after the precision cast) are checked before
        anything is committed; the commit is one reference assignment, so
        a dispatch racing the swap sees the old set or the new one."""
        if self._committed is None:
            raise ValueError(
                "legacy .output-only model: no committed params to swap")
        if self.quantized is not None:
            raise ValueError(
                "int8 engines cannot hot-swap params (weights bake "
                "calibration scales); build a new engine and use the "
                "fleet swap path")
        old_p, old_s, _ = self._committed
        if model_state is None:
            model_state = old_s
        for what, old, new in (("params", old_p, params),
                               ("model_state", old_s, model_state)):
            lo, ln = flatten_paths(old), flatten_paths(new)
            if set(lo) != set(ln):
                raise ValueError(
                    f"swap_params: {what} tree structure differs from "
                    f"the committed one (missing {sorted(set(lo) - set(ln))}"
                    f", extra {sorted(set(ln) - set(lo))})")
            for k, o in lo.items():
                nl = self._cast(ln[k]) if what == "params" \
                    else torch.as_tensor(ln[k])
                if tuple(o.shape) != tuple(nl.shape) or o.dtype != nl.dtype:
                    raise ValueError(
                        f"swap_params: {what} leaf {k} is "
                        f"{tuple(nl.shape)}/{nl.dtype}, committed expects "
                        f"{tuple(o.shape)}/{o.dtype}")
        committed = self._commit(params, model_state)
        self._committed = committed          # the atomic commit point
        if version is not None:
            self.model_version = version
        self.param_swaps += 1

    # ---- bucket ladder ---------------------------------------------------
    def bucket_of(self, n: int) -> int:
        """Smallest ladder bucket >= n (n must be <= batch_limit)."""
        for b in self.ladder:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds batch_limit "
                         f"{self.batch_limit}")

    def _first_dispatch(self, bucket: int):
        """Count a bucket's first dispatch — the port's compile — by
        phase (an engine has one precision and one device)."""
        if bucket in self._compiled:
            return
        with self._compile_lock:
            if bucket in self._compiled:
                return
            self._compiled.add(bucket)
            phase = "live" if self._warmed else "warmup"
            if self._warmed:
                self._post_warmup_compiles += 1
            self._c_compiles.inc(1.0, phase=phase, **self._lab)
            self.tracer.instant("serve_compile", cat="serve", bucket=bucket,
                                where=str(REPLICA), phase=phase)

    def _run(self, x: np.ndarray, bucket: int):
        """Launch the forward for one padded batch on the engine's
        stream; returns the device result (not yet synchronized)."""
        self._first_dispatch(bucket)
        if self._fwd is None:                 # duck-typed .output model
            self.watchdog.observe(f"serve_fwd_{self.precision}_b{bucket}",
                                  x)
            return self.model.output(x)
        with self._on_device():
            xt = torch.from_numpy(np.ascontiguousarray(x, self.dtype))
            if self.device.type == "cuda":
                xt = xt.pin_memory().to(self.device, non_blocking=True)
            self.watchdog.observe(f"serve_fwd_{self.precision}_b{bucket}",
                                  xt)
            return self.forward(xt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The committed forward on one batch already on the device (no
        queueing, padding or splitting) — what every dispatch runs."""
        params, _, state = self._committed
        return self._fwd(params, state, x)

    # ---- public API ------------------------------------------------------
    def submit(self, features,
               deadline: Optional[Deadline] = None) -> Future:
        """Enqueue a request; the Future resolves to the (N, ...) host
        output as numpy. Oversized requests split across dispatches and
        reassemble transparently. An expired ``deadline`` sheds
        synchronously (``DeadlineExceeded``, never enqueued); one that
        expires while queued sheds at batch forming — either way the
        request never reaches the device."""
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
        if deadline is not None and deadline.expired:
            self._c_deadline_shed.inc(1.0, stage="ingress", **self._lab)
            raise DeadlineExceeded("serving: deadline expired at ingress")
        chunks = [x[i:i + self.batch_limit]
                  for i in range(0, x.shape[0], self.batch_limit)]
        self._c_requests.inc(1.0, **self._lab)
        with self._count_lock:
            self._inflight_count += 1
            self._g_inflight.set(self._inflight_count, **self._lab)
        try:
            futures = [self._enqueue(c, deadline) for c in chunks]
        except BaseException:
            # without this release least-loaded routing would starve
            # the engine forever after a shutdown race
            with self._count_lock:
                self._inflight_count -= 1
                self._g_inflight.set(self._inflight_count, **self._lab)
            raise
        if len(futures) == 1:
            self._track(futures[0])
            return futures[0]
        return self._join_futures(futures)

    def output(self, features,
               deadline: Optional[Deadline] = None) -> np.ndarray:
        """Blocking inference (reference: ParallelInference.output:113)."""
        return self.submit(features, deadline=deadline).result()

    def _enqueue(self, chunk: np.ndarray,
                 deadline: Optional[Deadline] = None) -> Future:
        f: Future = Future()
        req = _Request(chunk, f, time.perf_counter(), deadline)
        while True:
            if self._shutdown.is_set():
                raise RuntimeError("ServingEngine is shut down")
            try:
                self._queue.put(req, timeout=0.1)
                break
            except queue.Full:
                continue
        self._g_queue.set(self._queue.qsize(), **self._lab)
        if self._shutdown.is_set():
            self._drain_queue()     # raced with shutdown()
        return f

    def _track(self, f: Future):
        def done(_):
            with self._count_lock:
                self._inflight_count -= 1
                self._g_inflight.set(self._inflight_count, **self._lab)
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
        """Requests accepted but not yet answered (the fleet router's
        least-loaded dispatch key)."""
        return self._inflight_count

    @property
    def recompiles_after_warmup(self) -> int:
        return self._post_warmup_compiles

    def assert_warm(self):
        """Raise when a live request made a signature's first dispatch
        after the warmup sweep, or the watchdog saw a bucket's signature
        drift — the zero-recompile serving contract."""
        if self._post_warmup_compiles:
            raise AssertionError(
                f"{self._post_warmup_compiles} bucket signatures were "
                "first dispatched by live traffic after warmup; widen the "
                "warmup sweep (feature_shape/min_bucket/batch_limit)")
        if self.watchdog.count() > 0:
            raise AssertionError(
                "RecompileWatchdog saw new dispatch signatures after "
                f"first compile: {self.watchdog.events}")

    def stats(self) -> Dict[str, Any]:
        """Point-in-time snapshot for the CLI / UI module: the JAX
        engine's keys, plus the serving ``device``."""
        q = self.latency.quantiles()
        with self._carry_lock:
            carried = 1 if self._carry is not None else 0
        out = {
            "session": self.session_id,
            "device": str(self.device),
            "replicas": self.n_replicas,
            "ladder": list(self.ladder),
            "pipelined": True,        # the JAX engine's key; one dispatcher
            "precision": self.precision,
            "params_resident_bytes": self.params_resident_bytes,
            "batches": self.dispatch_count,
            "device_ms_total": self.device_ms_total,
            "requests": self.latency.count,
            "inflight": self._inflight_count,
            "queue_depth": self._queue.qsize() + carried,
            "recompiles_after_warmup": self._post_warmup_compiles,
            "warmup_s": self.warmup_seconds,
            "latency_ms": {f"p{int(k * 100)}": v * 1e3
                           for k, v in q.items()},
        }
        if self.aot_cache is not None:
            out["aot_cache"] = self.aot_cache.stats()
        if self.quantized is not None:
            out["quant"] = {
                "calibration": self._calib_hash,
                "error_budget": self.policy.error_budget,
                "fallback": list(self.quantized.fallback),
                "layers": {n: r["error"]
                           for n, r in self.quantized.report.items()},
            }
        return out

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

    def _shed_expired(self, batch: List[_Request]) -> List[_Request]:
        """Drop requests whose deadline expired while they queued — the
        last gate before the device."""
        live = []
        for req in batch:
            if req.deadline is not None and req.deadline.expired:
                self._c_deadline_shed.inc(1.0, stage="batch", **self._lab)
                if not req.future.done():
                    req.future.set_exception(DeadlineExceeded(
                        "serving: deadline expired while queued"))
            else:
                live.append(req)
        return live

    def _dispatch_loop(self):
        while not self._shutdown.is_set():
            t_form0 = time.perf_counter()
            batch = self._form_batch()
            if batch:
                batch = self._shed_expired(batch)
            if not batch:
                continue
            self._g_queue.set(self._queue.qsize(), **self._lab)
            try:
                inflight = self._dispatch(batch, t_form0)
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

    def _dispatch(self, batch: List[_Request],
                  t_form0: Optional[float] = None) -> _InFlight:
        tracer = self.tracer
        if t_form0 is None:
            t_form0 = time.perf_counter()
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
        t_formed = time.perf_counter()
        for req in batch:
            tracer.add_span("queue_wait", req.t_enqueue, t_form0,
                            cat="serve")
        tracer.add_span("batch_form", t_form0, t_formed, cat="serve", n=n,
                        bucket=bucket)
        if self._chaos_dispatch is not None:
            self._chaos_dispatch.fail(arg=str(REPLICA))
        t0 = time.perf_counter()
        out = self._run(x, bucket)
        done = None
        if isinstance(out, torch.Tensor) and out.device.type == "cuda":
            with self._on_device():
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        else:
            host = out
        t_launched = time.perf_counter()
        tracer.add_span("dispatch", t_formed, t_launched, cat="serve",
                        where=str(REPLICA))
        self._c_batches.inc(1.0, **self._lab)
        self.dispatch_count += 1
        self._c_replica_disp.inc(1.0, replica=str(REPLICA), **self._lab)
        self._g_occupancy.set(n / bucket, **self._lab)
        return _InFlight(host, done, batch, n, bucket, t0, t_launched)

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
            busy_ms = (t_ready - inflight.t_dispatched) * 1e3
            self.device_ms_total += busy_ms
            self._c_replica_busy.inc(busy_ms, replica=str(REPLICA),
                                     **self._lab)
            host = inflight.host
            if isinstance(host, torch.Tensor):
                if host.dtype == torch.bfloat16:
                    host = host.float()
                host = host.numpy()
            host = np.asarray(host)
            t_fetched = time.perf_counter()
            self.tracer.add_span("device", inflight.t_launched, t_ready,
                                 cat="serve", where=str(REPLICA))
            self.tracer.add_span("fetch", t_ready, t_fetched, cat="serve",
                                 bytes=host.nbytes)
            ofs = 0
            for req in inflight.requests:
                k = req.x.shape[0]
                if not req.future.done():
                    req.future.set_result(host[ofs:ofs + k].copy())
                ofs += k
                self.latency.record(t_ready - req.t_enqueue)
            for qq, v in self.latency.quantiles().items():
                self._g_latency.set(v * 1e3, quantile=f"p{int(qq * 100)}",
                                    **self._lab)
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
