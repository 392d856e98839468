"""GenerationEngine: continuous-batching decode scheduler.

The port of the JAX package's ``generation/engine.py``. A fixed array
of *slots* holds in-flight sequences; every scheduler iteration
dispatches ONE tick over the whole slot batch, then routes each active
slot's sampled token to its stream. Sequences join (taking the lowest
free slot, carries zeroed + key reseeded inside the tick via the reset
mask) and retire (stop token, max length, cancel) mid-flight without
ever draining the batch — the continuous-batching property that keeps
the device busy at high sequence turnover.

Device residency: the engine serves on the model's device (``cuda``
unless the model was built with ``device="cpu"``; without a card it
raises). The (h, c) carries and per-slot keys live on the device across
ticks and are never fetched. The scheduler thread does all device work
on one CUDA stream created at engine start. The per-tick host traffic
is the small control arrays in (pinned, copied without a wait) and the
sampled tokens out — the tokens *are* the streamed response payload
and the only per-tick fetch; nothing else synchronizes per tick.

"Compile" in the port: there is no compiler on this path (the tick,
the prefill and the verify are eager torch). A *compile* is the first
dispatch of a (kind, shape) signature: per slot-count bucket (pow2
ladder up to ``max_slots``) the tick or the verify step, each prefill
chunk, the session extract/restore pair, and the reachable bucket
resize pairs. ``_warmup_sweep`` dispatches each once before traffic,
so cuBLAS has picked its algorithms and the caching allocator holds
its blocks; after it, a first-time signature is a bug —
``assert_warm()`` raises on one (or on drift the ``RecompileWatchdog``
saw). CUDA graphs of the tick are not part of this port (ROADMAP).

Telemetry: the ``dl4j_gen_*`` family (tokens, per-token p50/p99,
time-to-first-token, active slots, retired sequences by outcome,
stream errors, compiles by phase), as the JAX package registers it.
``parallel/fleet.py``'s ``GenerationPool`` puts an engine behind
admission control (with session affinity), ``ui/generation_module.py``
streams it over HTTP as SSE, and ``python -m deeplearning4j_tpu_torch
serve --generate`` starts both.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.generation import decode as D
from deeplearning4j_tpu_torch.generation import speculative as SP
from deeplearning4j_tpu_torch.generation.session import CarrySnapshot
from deeplearning4j_tpu_torch.observe.latency import LatencyRing
from deeplearning4j_tpu_torch.observe.recompile import RecompileWatchdog
from deeplearning4j_tpu_torch.observe.registry import default_registry
from deeplearning4j_tpu_torch.parallel.deadline import (Deadline,
                                                        DeadlineExceeded)
from deeplearning4j_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

_QUANTILES = (0.5, 0.95, 0.99)

_TORCH_DTYPES = {np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(bool): torch.bool}


def _bucket_ladder(max_slots: int) -> List[int]:
    out, b = [], 1
    while b < max_slots:
        out.append(b)
        b <<= 1
    out.append(max_slots)
    return out


def _reachable_resize_pairs(ladder: List[int]) -> List[tuple]:
    """The (src, dst) resize pairs the scheduler can actually request,
    instead of the full quadratic ordered sweep. Grows jump to ANY
    higher rung (``_admit_locked`` targets the first rung covering
    demand, so a 1 -> 8 burst is one resize), but shrinks only ever
    step to the ADJACENT lower rung (``_maybe_shrink_locked``), so the
    downward pairs beyond distance one are unreachable dead warmup
    weight — roughly half the all-pairs sweep for real ladders."""
    pairs = [(src, dst)
             for i, src in enumerate(ladder) for dst in ladder[i + 1:]]
    pairs += [(ladder[i], ladder[i - 1])
              for i in range(1, len(ladder))]
    return pairs


class GenerationStream:
    """One sequence's token stream: the scheduler produces events, one
    consumer iterates them (the SSE writer, or ``result()``). Events
    are plain dicts so the UI layer can serialize them as-is:
    ``{"token": id, "text": ch, "i": n}`` per token, then a terminal
    ``{"done": True, "reason": ..., "n": ..., "ttft_ms": ...}`` or
    ``{"error": msg}``."""

    _END = object()

    def __init__(self, request: Dict[str, Any], buffer: int = 4096):
        self.request = request
        self.ids: List[int] = []
        self.reason: Optional[str] = None
        self.error: Optional[str] = None
        self.ttft_ms: Optional[float] = None
        self.session: Optional[str] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer)
        self._done = threading.Event()
        self._cancelled = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks: List[Any] = []

    # -- consumer side -------------------------------------------------

    def __iter__(self):
        while True:
            ev = self._q.get()
            if ev is self._END:
                return
            yield ev

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Drain the stream and return the completed sequence."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            left = None if deadline is None else deadline - time.time()
            if left is not None and left <= 0:
                raise TimeoutError("generation stream timed out")
            try:
                ev = self._q.get(timeout=left)
            except queue.Empty:
                raise TimeoutError("generation stream timed out")
            if ev is self._END:
                break
        if self.error is not None:
            raise RuntimeError(self.error)
        out = {"ids": list(self.ids), "reason": self.reason,
               "n": len(self.ids), "ttft_ms": self.ttft_ms}
        if self.session is not None:
            out["session"] = self.session
        return out

    def cancel(self):
        """Ask the scheduler to retire this sequence early (client went
        away mid-stream). Safe from any thread; idempotent."""
        self._cancelled.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def add_done_callback(self, fn):
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:
            log.exception("generation stream callback failed")

    # -- scheduler side ------------------------------------------------

    def _push(self, ev: Dict[str, Any]) -> bool:
        try:
            self._q.put_nowait(ev)
            return True
        except queue.Full:
            return False

    def _finish(self, reason: str):
        self.reason = reason
        ev = {"done": True, "reason": reason, "n": len(self.ids),
              "ttft_ms": self.ttft_ms}
        if self.session is not None:
            ev["session"] = self.session
        self._push(ev)
        self._seal()

    def _fail(self, msg: str):
        self.error = msg
        self.reason = "error"
        self._push({"error": msg})
        self._seal()

    def _seal(self):
        self._done.set()
        try:
            self._q.put_nowait(self._END)
        except queue.Full:
            # consumer is gone and the buffer is packed; drop one event
            # to guarantee the END marker lands, else iterators hang
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._q.put_nowait(self._END)
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:
                log.exception("generation stream callback failed")


class _Slot:
    """Scheduler-private per-slot state (host side only)."""

    __slots__ = ("stream", "prompt", "ppos", "next_input", "gen_count",
                 "max_new", "stop_id", "seed", "temperature", "top_k",
                 "greedy", "needs_reset", "t_join", "t_first",
                 "deadline", "session", "resume", "pos", "draft",
                 "prefill_mode")

    def __init__(self, stream: GenerationStream, prompt: List[int],
                 max_new: int, stop_id: Optional[int], seed: int,
                 temperature: float, top_k: int, greedy: bool,
                 deadline: Optional[Deadline] = None,
                 session: Optional[str] = None,
                 resume: Optional[CarrySnapshot] = None):
        self.stream = stream
        self.prompt = prompt
        self.ppos = 1
        self.next_input = prompt[0]
        self.gen_count = 0
        self.max_new = max_new
        self.stop_id = stop_id
        self.seed = seed
        self.temperature = temperature
        self.top_k = top_k
        self.greedy = greedy
        self.needs_reset = resume is None
        self.t_join = time.time()
        self.t_first: Optional[float] = None
        self.deadline = deadline
        self.session = session
        self.resume = resume
        # absolute sequence position = tokens fed so far, the counter
        # the splitmix64 sampling keys index (resumes continue it)
        self.pos = resume.pos if resume is not None else 0
        self.draft: Optional[SP.NGramDraft] = None
        self.prefill_mode = "tick"


class GenerationEngine:
    """Continuous-batching decode serving over one committed model.

    ``submit()`` returns a :class:`GenerationStream` immediately; the
    background scheduler thread packs waiting sequences into free
    slots, grows/shrinks the slot bucket along the warmed ladder, and
    pushes sampled tokens into each stream as they decode.
    """

    def __init__(self, model, *, max_slots: Optional[int] = None,
                 precision: Union[str, Any] = "f32",
                 vocab: Optional[D.Vocab] = None,
                 max_new_tokens: int = 256,
                 stop_text: Optional[str] = "\n",
                 queue_limit: int = 128,
                 stream_buffer: int = 4096,
                 int8_budget: float = 0.03,
                 calibration_text: str = "the quick brown fox jumps "
                                         "over the lazy dog\n",
                 registry=None, watchdog=None,
                 session_id: str = "generate",
                 prefill_chunk: Optional[int] = None,
                 speculative: int = 0,
                 sampling: Optional[str] = None,
                 session_store=None,
                 tuned_config=None):
        # explicit kwargs > tuned config (this engine's, else the
        # process-wide one) > committed defaults; the slot ladder, resize
        # pairs and chunk ladder of the warm set all derive from them
        from deeplearning4j_tpu_torch.optimize.autotune import resolve_tuned
        max_slots = int(resolve_tuned(max_slots, tuned_config,
                                      "generation.max_slots"))
        prefill_chunk = int(resolve_tuned(prefill_chunk, tuned_config,
                                          "generation.prefill_chunk"))
        self.tuned_config = tuned_config
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.model = model
        self.device = resolve_device(model.device)
        self.spec = D.extract_decode_spec(model)
        self.vocab = vocab if vocab is not None \
            else D.Vocab.default_for(self.spec.vocab_size)
        self.precision = getattr(precision, "mode", precision)
        if self.precision not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown precision {self.precision!r}")
        self.max_slots = int(max_slots)
        self.max_new_tokens = int(max_new_tokens)
        self.queue_limit = int(queue_limit)
        self.stream_buffer = int(stream_buffer)
        self.session_id = session_id
        # v2 serving modes: chunked prefill, speculative decode,
        # counter-based sampling keys, resumable sessions
        self._prefill_chunk = int(prefill_chunk)
        self._spec_k = int(speculative)
        if self._spec_k < 0 or self._prefill_chunk < 0:
            raise ValueError("prefill_chunk/speculative must be >= 0")
        # speculative acceptance needs position-addressable sampling
        # keys, so it defaults the engine into counter mode; chain is
        # the legacy split-chain default otherwise
        self.sampling = sampling if sampling is not None \
            else ("counter" if self._spec_k else "chain")
        if self.sampling not in ("chain", "counter"):
            raise ValueError(f"unknown sampling mode {self.sampling!r}")
        if (session_store is not None
                and session_store.device.type != self.device.type):
            raise ValueError(
                f"session_store holds its device tier on "
                f"{session_store.device}, the engine serves on "
                f"{self.device}")
        self.session_store = session_store
        self.chunk_ladder = (
            D.prefill_chunk_ladder(self._prefill_chunk)
            if self._prefill_chunk else [])
        self.stop_id: Optional[int] = None
        if stop_text:
            sid = self.vocab.stoi.get(stop_text)
            if sid is not None:
                self.stop_id = int(sid)

        self.registry = registry if registry is not None \
            else default_registry()
        self.watchdog = watchdog if watchdog is not None else \
            RecompileWatchdog(self.registry, session_id=session_id)

        # int8 head: calibrate + decode-level quant gate before commit
        self.gate_result = None
        x_scale = None
        if self.precision == "int8":
            probe = self.vocab.encode(calibration_text) or [0]
            x_scale, self.gate_result = D.int8_head_gate(
                model, self.spec, probe, top1_budget=int8_budget,
                model_name=session_id, registry=self.registry)
        # the one CUDA stream all of the engine's device work runs on
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_device():
            self._dp = D.commit_decode_params(
                model, self.spec, self.precision, x_scale=x_scale)

        self._fns: Dict[str, Any] = {"tick": D.build_tick(model, self.spec)}
        if self._prefill_chunk:
            self._fns["prefill"] = D.build_prefill(model, self.spec)
        if self._spec_k:
            self._fns["spec"] = SP.build_spec_tick(model, self.spec,
                                                   self._spec_k)
        if session_store is not None:
            self._fns["extract"] = D.build_slot_extract(self.spec)
            self._fns["restore"] = D.build_slot_restore(self.spec)
        self.ladder = _bucket_ladder(self.max_slots)

        # first-dispatched signatures: ("tick", S), ("spec", S),
        # ("prefill", S, C), ("extract", S), ("restore", S) and
        # ("resize", src, dst)
        self._exe: Dict[tuple, Any] = {}
        self._exe_lock = threading.Lock()
        self._warmed = False
        self._post_warmup_compiles = 0

        # scheduler state — slot objects + device-resident carry/rng
        self._cv = threading.Condition()
        self._waiting: List[_Slot] = []
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        self._bucket = self.ladder[0]
        with self._on_device():
            self._h, self._c, self._rng = D.zero_carries(
                self.spec, self._bucket, self.device)
        self._shrink_streak = 0
        self._stop = threading.Event()

        # accounting
        self.token_ring = LatencyRing()
        self.ttft_ring = LatencyRing()
        # TTFT split by prefill mode: chunked dispatches vs the legacy
        # one-tick-per-prompt-char path — the A/B the chunked ladder
        # has to win
        self.ttft_rings = {"chunked": LatencyRing(),
                           "tick": LatencyRing()}
        self._submitted = 0
        self._tokens_out = 0
        self._prefill_ticks = 0
        self._prefill_chunks = 0
        self._prefill_chunk_tokens = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_dispatches = 0
        self._flush_mark = 0
        self._max_active = 0
        self._outcomes: Dict[str, int] = {}
        self._stream_errors = 0

        r = self.registry
        self._c_tokens = r.counter(
            "dl4j_gen_tokens_total", "generated tokens streamed")
        self._c_seqs = r.counter(
            "dl4j_gen_sequences_total",
            "retired sequences by outcome "
            "(stop|length|cancelled|error|deadline)")
        self._c_compiles = r.counter(
            "dl4j_gen_compiles_total",
            "decode executable compiles by phase (warmup|live)")
        self._c_stream_err = r.counter(
            "dl4j_gen_stream_errors_total",
            "streams dropped mid-flight (slow consumer / transport)")
        self._c_deadline = r.counter(
            "dl4j_gen_deadline_shed_total",
            "sequences shed because their deadline expired; stage="
            "ingress (refused at submit) | queue (dropped while "
            "waiting for a slot) | decode (retired mid-decode)")
        self._c_disconnect = r.counter(
            "dl4j_gen_client_disconnect_total",
            "sequences cancelled because the streaming client "
            "disconnected mid-generation")
        self._g_active = r.gauge(
            "dl4j_gen_active_slots", "sequences currently decoding")
        self._g_bucket = r.gauge(
            "dl4j_gen_slot_bucket", "current slot-count bucket")
        self._g_queue = r.gauge(
            "dl4j_gen_queue_depth", "sequences waiting for a slot")
        self._g_token_ms = r.gauge(
            "dl4j_gen_token_ms", "per-token decode latency quantiles")
        self._g_ttft = r.gauge(
            "dl4j_gen_ttft_ms", "time-to-first-token quantiles")
        self._c_prefill_chunks = r.counter(
            "dl4j_gen_prefill_chunks_total",
            "chunked-prefill dispatches (one prefill loop consuming up "
            "to prefill_chunk prompt tokens per in-prefill slot)")
        self._c_prefill_tokens = r.counter(
            "dl4j_gen_prefill_tokens_total",
            "prompt tokens consumed, by prefill mode: chunked (scan "
            "dispatches) vs tick (one batched tick per char)")
        self._g_prefill_ttft = r.gauge(
            "dl4j_gen_prefill_ttft_ms",
            "time-to-first-token quantiles split by the prefill mode "
            "the sequence took")
        self._c_spec_proposed = r.counter(
            "dl4j_gen_spec_proposed_total",
            "draft tokens proposed by the n-gram table and attached "
            "to speculative verify dispatches")
        self._c_spec_accepted = r.counter(
            "dl4j_gen_spec_accepted_total",
            "draft tokens accepted (bitwise-equal to what plain decode "
            "would have emitted at their position)")
        # pre-register healthy series so /metrics shows the family at 0
        self._c_prefill_chunks.inc(0.0, session=session_id)
        for mode in ("chunked", "tick"):
            self._c_prefill_tokens.inc(0.0, session=session_id,
                                       mode=mode)
        self._c_spec_proposed.inc(0.0, session=session_id)
        self._c_spec_accepted.inc(0.0, session=session_id)
        self._c_tokens.inc(0.0, session=session_id)
        self._c_compiles.inc(0.0, session=session_id, phase="live")
        self._c_stream_err.inc(0.0, session=session_id)
        for oc in ("stop", "length", "cancelled", "error", "deadline"):
            self._c_seqs.inc(0.0, session=session_id, outcome=oc)
        for stage in ("ingress", "queue", "decode"):
            self._c_deadline.inc(0.0, session=session_id, stage=stage)
        self._c_disconnect.inc(0.0, session=session_id)
        self._g_active.set(0.0, session=session_id)
        self._g_bucket.set(float(self._bucket), session=session_id)
        self._g_queue.set(0.0, session=session_id)

        t0 = time.time()
        with self._on_device():
            self._warmup_sweep()
        if self._stream is not None:
            self._stream.synchronize()
        self.warmup_s = time.time() - t0
        self._warmed = True

        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"generation-scheduler-{session_id}")
        self._thread.start()

    # ---- device context and dispatch shapes -------------------------

    @contextlib.contextmanager
    def _on_device(self):
        """The engine's device context: its CUDA stream on the card, and
        no autograd (thread-local, so each thread that dispatches enters
        it)."""
        with torch.no_grad():
            if self._stream is None:
                yield
            else:
                with torch.cuda.stream(self._stream):
                    yield

    def _put(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host control arrays onto the decode device (integers as
        int64) in one copy: packed into one byte buffer at 8-byte
        offsets, pinned and copied without a wait on the card, and
        viewed back as tensors of their own dtypes and shapes there."""
        parts, metas, off = [], [], 0
        for a in arrays:
            a = np.ascontiguousarray(a)
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            raw = a.reshape(-1).view(np.uint8)
            pad = -raw.size % 8
            parts += [raw, np.zeros(pad, np.uint8)]
            metas.append((off, raw.size, a.dtype, a.shape))
            off += raw.size + pad
        buf = torch.from_numpy(np.concatenate(parts))
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        return [buf[o:o + n].view(_TORCH_DTYPES[dt]).view(shape)
                for o, n, dt, shape in metas]

    def _host_args(self, S: int):
        return (np.zeros(S, np.int32), np.zeros(S, bool),
                np.zeros(S, np.uint32), np.zeros(S, bool),
                np.ones(S, np.float32), np.zeros(S, np.int32),
                np.ones(S, bool), np.zeros((S, 2), np.uint32),
                np.zeros(S, bool))

    def _spec_args(self, S: int):
        K1 = self._spec_k + 1
        return (np.zeros((S, K1), np.int32), np.zeros(S, np.int32),
                np.zeros(S, bool), np.zeros(S, np.uint32),
                np.ones(S, bool), np.ones(S, np.float32),
                np.zeros(S, np.int32), np.ones(S, bool),
                np.zeros((S, K1, 2), np.uint32), np.zeros(S, bool))

    def _prefill_args(self, S: int, C: int):
        return (np.zeros((S, C), np.int32), np.zeros(S, np.int32),
                np.zeros(S, bool), np.zeros(S, np.uint32),
                np.ones(S, bool))

    def _compile(self, key: tuple):
        """Count the first dispatch of a signature (``warmup`` or
        ``live``) and return its function."""
        phase = "warmup" if not self._warmed else "live"
        if self._warmed:
            self._post_warmup_compiles += 1
            log.warning("generation: live compile for %s", key)
        self._c_compiles.inc(1.0, session=self.session_id, phase=phase)
        if key[0] == "resize":
            return D.build_resize(self.spec, key[1], key[2])
        return self._fns[key[0]]

    def _get_exe(self, key: tuple):
        exe = self._exe.get(key)
        if exe is None:
            with self._exe_lock:
                exe = self._exe.get(key)
                if exe is None:
                    exe = self._compile(key)
                    self._exe[key] = exe
        return exe

    def _warmup_sweep(self):
        """Dispatch every signature a live request can reach, per ladder
        bucket: the decode dispatch (the speculative verify step when
        drafts are on — it subsumes the plain tick, since ``n_draft=0``
        IS plain-tick semantics, so the tick itself never dispatches and
        never needs warming), the prefill chunk ladder, the session
        extract/restore pair, and the resize pairs the scheduler's
        policy can actually request (:func:`_reachable_resize_pairs` —
        grows jump rungs on demand bursts, shrinks only ever step to the
        adjacent lower rung)."""
        put = self._put
        for S in self.ladder:
            h, c, rng = D.zero_carries(self.spec, S, self.device)
            if self._spec_k:
                self._get_exe(("spec", S))(
                    self._dp, h, c, rng, *put(*self._spec_args(S)))
            else:
                self._get_exe(("tick", S))(
                    self._dp, h, c, rng, *put(*self._host_args(S)))
            for C in self.chunk_ladder:
                self._get_exe(("prefill", S, C))(
                    self._dp, h, c, rng, *put(*self._prefill_args(S, C)))
            if self.session_store is not None:
                self._get_exe(("extract", S))(h, c, rng, 0)
                zeros = [np.zeros(hd, np.float32)
                         for hd in self.spec.hidden_sizes]
                self._get_exe(("restore", S))(
                    h, c, rng, *self._restore_rows(zeros, zeros,
                                                   np.zeros(2, np.uint32)),
                    0)
        for src, dst in _reachable_resize_pairs(self.ladder):
            h, c, rng = D.zero_carries(self.spec, src, self.device)
            self._get_exe(("resize", src, dst))(h, c, rng)

    # ---- public API --------------------------------------------------

    def submit(self, prompt: Union[str, Sequence[int]], *,
               max_new_tokens: Optional[int] = None, greedy: bool = True,
               temperature: float = 1.0, top_k: int = 0, seed: int = 0,
               stop: Optional[Union[str, int]] = None,
               deadline: Optional[Deadline] = None,
               session: Optional[str] = None
               ) -> GenerationStream:
        """Queue one sequence; returns its stream immediately. Raises
        RuntimeError when the waiting queue is at ``queue_limit`` —
        FleetRouter admission turns that into a shed upstream. An
        already-expired ``deadline`` raises ``DeadlineExceeded``
        synchronously — the sequence never queues, never decodes.

        ``session`` names a resumable carry in the engine's
        :class:`~deeplearning4j_tpu_torch.generation.session.SessionStore`.
        On a hit the sequence continues from the stored (h, c)/PRNG
        state — the new prompt extends the old one without replaying
        the prefix, bitwise-equal to never having retired; on a miss it
        starts fresh. Either way the carry is re-captured when this
        sequence retires, so the token stays resumable turn after turn
        (and, via the write-through checkpoint, on other nodes)."""
        if self._stop.is_set():
            raise RuntimeError("generation engine is shut down")
        if session is not None and self.session_store is None:
            raise ValueError(
                "session= requires an engine with a session_store")
        if deadline is not None and deadline.expired:
            self._c_deadline.inc(1.0, session=self.session_id,
                                 stage="ingress")
            raise DeadlineExceeded(
                "generation: deadline expired at ingress")
        if isinstance(prompt, str):
            ids = self.vocab.encode(prompt)
        else:
            ids = [int(t) for t in prompt]
        resume = None
        if session is not None:
            resume = self.session_store.load(session)
        if resume is not None:
            # the resumed carry still owes the model its pending tokens
            # (last emitted, or the unconsumed prompt tail) — they lead
            # the new prompt through the normal prefill path
            ids = [int(t) for t in resume.pending] + ids
        elif not ids:
            ids = [self.stop_id if self.stop_id is not None else 0]
        if not ids:
            raise ValueError("resume produced an empty prompt")
        bad = [t for t in ids if not 0 <= t < self.spec.vocab_size]
        if bad:
            raise ValueError(f"prompt ids out of range: {bad[:5]}")
        stop_id = self.stop_id
        if isinstance(stop, str):
            stop_id = self.vocab.stoi.get(stop, stop_id)
        elif isinstance(stop, int):
            stop_id = stop
        req = {"prompt": list(ids), "greedy": bool(greedy),
               "temperature": float(temperature), "top_k": int(top_k),
               "seed": int(seed), "stop_id": stop_id,
               "max_new_tokens": int(max_new_tokens
                                     if max_new_tokens is not None
                                     else self.max_new_tokens)}
        if session is not None:
            req["session"] = session
        stream = GenerationStream(req, buffer=self.stream_buffer)
        stream.session = session
        slot = _Slot(stream, req["prompt"], req["max_new_tokens"],
                     stop_id, req["seed"], req["temperature"],
                     req["top_k"], req["greedy"], deadline=deadline,
                     session=session, resume=resume)
        if self._prefill_chunk and len(slot.prompt) > 1:
            slot.prefill_mode = "chunked"
        if self._spec_k:
            slot.draft = SP.NGramDraft()
            if resume is not None:
                slot.draft.observe_many(resume.history)
                slot.draft.observe_many(
                    slot.prompt[len(resume.pending):])
            else:
                slot.draft.observe_many(slot.prompt)
        with self._cv:
            if len(self._waiting) >= self.queue_limit:
                raise RuntimeError("generation queue full")
            self._waiting.append(slot)
            self._submitted += 1
            self._cv.notify()
        return stream

    def generate(self, prompt, **kw) -> Dict[str, Any]:
        """Blocking convenience: submit and wait for the result."""
        timeout = kw.pop("timeout", None)
        res = self.submit(prompt, **kw).result(timeout=timeout)
        res["text"] = self.vocab.decode(res["ids"])
        return res

    def cancel(self, stream: GenerationStream, *,
               disconnect: bool = False) -> bool:
        """Retire a submitted sequence early and free its slot. A
        sequence still in the waiting queue is finished ``cancelled``
        immediately; one decoding in a slot is flagged and the
        scheduler retires it on its next pass over the slot (prefill
        or decode — it never runs the sequence to completion first).
        ``disconnect=True`` marks the cancel as a client disconnect
        (the SSE writer's path) on
        ``dl4j_gen_client_disconnect_total``. Returns True when the
        sequence was still live."""
        if disconnect and not stream.done:
            self._c_disconnect.inc(1.0, session=self.session_id)
        stream.cancel()
        with self._cv:
            for idx, s in enumerate(self._waiting):
                if s.stream is stream:
                    self._waiting.pop(idx)
                    stream._finish("cancelled")
                    self._retired(s, "cancelled")
                    return True
            live = not stream.done
            self._cv.notify()
        return live

    def pending_depth(self) -> int:
        with self._cv:
            return len(self._waiting) + sum(
                1 for s in self._slots if s is not None)

    def assert_warm(self):
        """Raise if a signature was dispatched for the first time after
        the warmup sweep (a bucket, chunk or resize the sweep missed), or
        if the recompile watchdog saw a step key's signature drift."""
        if self._post_warmup_compiles:
            raise RuntimeError(
                f"{self._post_warmup_compiles} decode compile(s) after "
                "warmup — the bucket ladder missed a live shape")
        if self.watchdog.count() > 0:
            raise RuntimeError(
                "recompile watchdog observed signature drift in the "
                "decode loop")

    def stats(self) -> Dict[str, Any]:
        tq = self.token_ring.quantiles(_QUANTILES)    # {q: seconds}
        fq = self.ttft_ring.quantiles(_QUANTILES)
        with self._cv:
            active = sum(1 for s in self._slots if s is not None)
            waiting = len(self._waiting)
        out = {
            "session": self.session_id,
            "device": str(self.device),
            "precision": self.precision,
            "sampling": self.sampling,
            "slots": {"bucket": self._bucket, "max": self.max_slots,
                      "active": active, "waiting": waiting,
                      "max_active": self._max_active,
                      "ladder": list(self.ladder)},
            "sequences": {"submitted": self._submitted,
                          "retired": dict(self._outcomes)},
            "tokens": {"generated": self._tokens_out,
                       "prefill_ticks": self._prefill_ticks},
            "prefill": {"chunk": self._prefill_chunk,
                        "ladder": list(self.chunk_ladder),
                        "chunks": self._prefill_chunks,
                        "chunk_tokens": self._prefill_chunk_tokens,
                        "tick_tokens": self._prefill_ticks},
            "latency_ms": {
                "token": {f"p{int(q * 100)}": v * 1e3
                          for q, v in tq.items()},
                "ttft": {f"p{int(q * 100)}": v * 1e3
                         for q, v in fq.items()},
                "ttft_by_mode": {
                    mode: {f"p{int(q * 100)}": v * 1e3
                           for q, v in ring.quantiles(
                               _QUANTILES).items()}
                    for mode, ring in self.ttft_rings.items()}},
            "stream_errors": self._stream_errors,
            "recompiles_after_warmup": self._post_warmup_compiles,
            "warmup_s": round(self.warmup_s, 3),
            "head_agreement": (self.gate_result.top1_agreement
                               if self.gate_result else None),
        }
        if self._spec_k:
            prop = self._spec_proposed
            out["speculative"] = {
                "k": self._spec_k,
                "proposed": prop,
                "accepted": self._spec_accepted,
                "dispatches": self._spec_dispatches,
                "acceptance": (self._spec_accepted / prop
                               if prop else None)}
        if self.session_store is not None:
            out["session_store"] = self.session_store.stats()
        return out

    def shutdown(self, timeout: float = 5.0):
        """Stop the scheduler and join it (before the model can be
        freed), then checkpoint in-flight sessions and fail every open
        stream."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        with self._cv:
            in_flight = [(i, s) for i, s in enumerate(self._slots)
                         if s is not None]
            waiting = list(self._waiting)
            self._slots = [None] * self.max_slots
            self._waiting = []
        with self._on_device():
            for i, s in in_flight:
                # drain capture: between dispatches an in-flight slot's
                # device state is consistent, so a SIGTERM-style
                # shutdown checkpoints its session carry — the client
                # resumes the token on another node sharing the
                # artifact store
                self._capture_session(i, s)
                s.stream._fail("generation engine shut down")
                self._retired(s, "error", count_metrics=False)
        if self._stream is not None:
            self._stream.synchronize()
        for s in waiting:
            s.stream._fail("generation engine shut down")
            self._retired(s, "error", count_metrics=False)

    # ---- scheduler ----------------------------------------------------

    def _retired(self, slot: _Slot, outcome: str,
                 count_metrics: bool = True):
        self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
        if count_metrics:
            self._c_seqs.inc(1.0, session=self.session_id,
                             outcome=outcome)

    def _admit_locked(self):
        """Pack waiting sequences into free slots, growing the bucket
        along the ladder first when demand exceeds it. Expired or
        cancelled waiters are dropped here — they never take a slot,
        never touch the device. Called under ``_cv``."""
        if self._waiting:
            live: List[_Slot] = []
            for s in self._waiting:
                if s.stream._cancelled.is_set():
                    s.stream._finish("cancelled")
                    self._retired(s, "cancelled")
                elif s.deadline is not None and s.deadline.expired:
                    self._c_deadline.inc(1.0, session=self.session_id,
                                         stage="queue")
                    s.stream._finish("deadline")
                    self._retired(s, "deadline")
                else:
                    live.append(s)
            self._waiting = live
        active_idx = [i for i, s in enumerate(self._slots)
                      if s is not None]
        demand = len(active_idx) + len(self._waiting)
        if demand > self._bucket and self._bucket < self.max_slots:
            target = next((s for s in self.ladder
                           if s >= min(demand, self.max_slots)),
                          self.ladder[-1])
            self._resize(target)
        free = [i for i in range(self._bucket)
                if self._slots[i] is None]
        while self._waiting and free:
            i = free.pop(0)
            self._slots[i] = self._waiting.pop(0)
        self._shrink_streak = 0 if self._waiting else self._shrink_streak

    def _maybe_shrink_locked(self):
        """Drop to the previous ladder bucket after a streak of ticks
        where every active slot fits in it (hysteresis avoids thrash).
        Slots are pinned — a sequence never migrates — so we only
        shrink when the upper rows are empty."""
        idx = self.ladder.index(self._bucket)
        if idx == 0 or self._waiting:
            return
        prev = self.ladder[idx - 1]
        if any(self._slots[i] is not None
               for i in range(prev, self._bucket)):
            self._shrink_streak = 0
            return
        self._shrink_streak += 1
        if self._shrink_streak >= 16:
            self._resize(prev)
            self._shrink_streak = 0

    def _resize(self, target: int):
        if target == self._bucket:
            return
        exe = self._get_exe(("resize", self._bucket, target))
        self._h, self._c, self._rng = exe(self._h, self._c, self._rng)
        self._bucket = target
        self._g_bucket.set(float(target), session=self.session_id)

    def _loop(self):
        with self._on_device():
            self._serve()

    def _serve(self):
        while not self._stop.is_set():
            with self._cv:
                while (not self._stop.is_set()
                       and not self._waiting
                       and all(s is None for s in self._slots)):
                    self._cv.wait(timeout=0.25)
                if self._stop.is_set():
                    return
                self._admit_locked()
                S = self._bucket
                slots = list(self._slots[:S])
                self._g_queue.set(float(len(self._waiting)),
                                  session=self.session_id)
            try:
                self._tick_once(S, slots)
            except Exception as e:  # a broken tick must not kill serving
                log.exception("generation tick failed")
                with self._cv:
                    for i, s in enumerate(self._slots):
                        if s is not None:
                            s.stream._fail(f"decode tick failed: {e}")
                            self._retired(s, "error")
                            self._slots[i] = None

    def _capture_session(self, i: int, s: _Slot,
                         overrun: bool = False):
        """Checkpoint a retiring slot's carry into the session store.
        Skipped when the sequence has no session token, the engine no
        store, nothing was ever fed (``needs_reset`` still set), the
        loaded snapshot was never restored into a device slot (the
        store's copy is still the truth), or the device state overran
        the committed stream (a speculative dispatch that stopped
        before its last accepted position) — a resume must continue
        from exactly the state the client saw."""
        if (self.session_store is None or s.session is None
                or s.needs_reset or s.resume is not None or overrun):
            return
        exe = self._get_exe(("extract", self._bucket))
        hr, cr, rr = exe(self._h, self._c, self._rng, i)
        pending = [int(s.next_input)]
        pending += [int(t) for t in s.prompt[s.ppos:]]
        if s.draft is not None:
            history = list(s.draft.history)
        else:
            history = [int(t) for t in s.prompt] + list(s.stream.ids)
            history = history[-512:]
        snap = CarrySnapshot(
            [x.cpu().numpy() for x in hr], [x.cpu().numpy() for x in cr],
            rr.cpu().numpy().astype(np.uint32), pending, s.pos, history)
        try:
            self.session_store.save(s.session, snap)
        except Exception:
            log.exception("session capture failed for %s", s.session)

    def _restore_slot(self, S: int, i: int, s: _Slot):
        """Scatter a resumed session's carry rows into slot ``i``. Runs
        before the slot's first dispatch (its ``needs_reset`` is False,
        so without the scatter it would decode from stale rows)."""
        snap = s.resume
        s.resume = None
        hr = [np.asarray(x, np.float32) for x in snap.h]
        cr = [np.asarray(x, np.float32) for x in snap.c]
        rr = np.asarray(snap.rng, np.uint32)
        exe = self._get_exe(("restore", S))
        self.watchdog.observe(f"gen_restore_s{S}", hr, cr, rr)
        self._h, self._c, self._rng = exe(
            self._h, self._c, self._rng, *self._restore_rows(hr, cr, rr), i)

    def _restore_rows(self, hr, cr, rr):
        """Saved (h, c, key) rows on the device, in one copy."""
        rows = self._put(*hr, *cr, rr)
        n = len(hr)
        return rows[:n], rows[n:2 * n], rows[-1]

    def _retire_eligible(self, i: int, s: _Slot,
                         retire: List[tuple]) -> bool:
        """Cancel/deadline check between dispatches; True if the slot
        was retired. Running this BEFORE every dispatch — including
        between the chunked-prefill scans of one long prompt — is what
        closes the prefill blind spot: a client that hung up (or a
        budget that ran out) during prompt ingestion must not keep
        burning dispatches until sampling starts. Between dispatches
        the device state is consistent, so these retires are capture-
        safe (overrun=False)."""
        if s.stream._cancelled.is_set():
            retire.append((i, s, "cancelled", False))
            return True
        if s.deadline is not None and s.deadline.expired:
            self._c_deadline.inc(1.0, session=self.session_id,
                                 stage="decode")
            retire.append((i, s, "deadline", False))
            return True
        return False

    def _commit_retires_locked(self, retire: List[tuple]):
        for i, s, outcome, overrun in retire:
            if outcome != "error":
                # capture BEFORE the terminal stream event: a client
                # that fires its next turn the instant it sees "done"
                # must already find the carry resumable
                self._capture_session(i, s, overrun=overrun)
                s.stream._finish(outcome)
            self._retired(s, outcome)
            self._slots[i] = None

    def _prefill_pass(self, S: int, slots: List[Optional[_Slot]],
                      retire: List[tuple]):
        """Consume every chunked slot's remaining prompt — all but its
        LAST token, which the sampling dispatch feeds to emit the first
        token — in ladder-sized prefill dispatches. A 512-char prompt costs
        ~ceil(511/chunk) dispatches instead of 511 ticks; the key chain
        advances identically either way (one split per consumed token),
        so chunked and tick prefill are bitwise-interchangeable.
        """
        while True:
            for i, s in enumerate(slots):
                if s is not None and self._retire_eligible(i, s,
                                                           retire):
                    slots[i] = None
            rem = {i: len(s.prompt) - s.ppos
                   for i, s in enumerate(slots)
                   if s is not None and s.prefill_mode == "chunked"
                   and len(s.prompt) - s.ppos > 0}
            if not rem:
                return
            top = max(rem.values())
            C = self.chunk_ladder[-1]
            for c in self.chunk_ladder:
                if c >= top:
                    C = c
                    break
            chunk = np.zeros((S, C), np.int32)
            lens = np.zeros(S, np.int32)
            reset = np.zeros(S, bool)
            seeds = np.zeros(S, np.uint32)
            active = np.zeros(S, bool)
            consumed = 0
            for i, n in rem.items():
                s = slots[i]
                t = min(n, C)
                chunk[i, :t] = s.prompt[s.ppos - 1:s.ppos - 1 + t]
                lens[i] = t
                reset[i] = s.needs_reset
                seeds[i] = np.uint32(s.seed & 0xFFFFFFFF)
                active[i] = True
                consumed += t
            exe = self._get_exe(("prefill", S, C))
            self.watchdog.observe(
                f"gen_prefill_{self.precision}_s{S}_c{C}",
                chunk, lens, reset, seeds, active)
            self._h, self._c, self._rng = exe(
                self._dp, self._h, self._c, self._rng,
                *self._put(chunk, lens, reset, seeds, active))
            for i, n in rem.items():
                s = slots[i]
                t = min(n, C)
                s.ppos += t
                s.pos += t
                s.needs_reset = False
                if s.ppos >= len(s.prompt):
                    s.next_input = s.prompt[s.ppos - 1]
            self._prefill_chunks += 1
            self._prefill_chunk_tokens += consumed
            self._c_prefill_chunks.inc(1.0, session=self.session_id)
            self._c_prefill_tokens.inc(float(consumed),
                                       session=self.session_id,
                                       mode="chunked")

    def _tick_once(self, S: int, slots: List[Optional[_Slot]]):
        retire: List[tuple] = []      # (i, slot, outcome, overrun)

        # 0) session restore: scatter resumed carries into their slots
        #    before anything dispatches over them
        for i, s in enumerate(slots):
            if s is not None and s.resume is not None:
                self._restore_slot(S, i, s)

        # 1) chunked prefill (with mid-prefill retirement checks)
        if self._prefill_chunk:
            self._prefill_pass(S, slots, retire)

        # 2) build the decode dispatch's control arrays; cancel/expired
        #    slots retire here, BEFORE the dispatch, so their device
        #    state stays consistent for session capture
        tokens = np.zeros(S, np.int32)
        reset = np.zeros(S, bool)
        seeds = np.zeros(S, np.uint32)
        active = np.zeros(S, bool)
        temp = np.ones(S, np.float32)
        topk = np.zeros(S, np.int32)
        greedy = np.ones(S, bool)
        pos = np.zeros(S, np.uint64)
        in_prefill = [False] * S
        n_active = 0
        for i, s in enumerate(slots):
            if s is None:
                continue
            if self._retire_eligible(i, s, retire):
                slots[i] = None
                continue
            n_active += 1
            tokens[i] = s.next_input
            reset[i] = s.needs_reset
            seeds[i] = np.uint32(s.seed & 0xFFFFFFFF)
            active[i] = True
            temp[i] = s.temperature
            topk[i] = s.top_k
            greedy[i] = s.greedy
            pos[i] = s.pos
            in_prefill[i] = s.ppos < len(s.prompt)
        self._max_active = max(self._max_active, n_active)
        self._g_active.set(float(n_active), session=self.session_id)
        if n_active == 0:
            with self._cv:
                self._commit_retires_locked(retire)
                self._maybe_shrink_locked()
            return

        # 3) ONE decode dispatch: the speculative verify step when
        #    drafts are on (n_draft=0 degrades to plain-tick semantics,
        #    so prefilling/chain-mode co-residents are unaffected),
        #    else the plain tick
        use_ext = np.zeros(S, bool)
        if self._spec_k:
            K1 = self._spec_k + 1
            toks2 = np.zeros((S, K1), np.int32)
            toks2[:, 0] = tokens
            n_draft = np.zeros(S, np.int32)
            for i, s in enumerate(slots):
                if s is None or in_prefill[i] or s.draft is None:
                    continue
                if not (s.greedy or self.sampling == "counter"):
                    # chain-mode sampling has no position-addressable
                    # keys, so acceptance can't be verified — plain
                    # tick semantics for this slot
                    continue
                cap = min(self._spec_k, s.max_new - s.gen_count - 1)
                if cap <= 0:
                    continue
                d = s.draft.propose(cap)
                if d:
                    toks2[i, 1:1 + len(d)] = d
                    n_draft[i] = len(d)
                    self._spec_proposed += len(d)
                    self._c_spec_proposed.inc(float(len(d)),
                                              session=self.session_id)
            ext_keys = np.zeros((S, K1, 2), np.uint32)
            if self.sampling == "counter":
                ext_keys = SP.counter_keys(seeds, pos, K1)
                use_ext = active.copy()
            exe = self._get_exe(("spec", S))
            self.watchdog.observe(
                f"gen_spec_{self.precision}_s{S}", toks2, n_draft,
                reset, seeds, active, temp, topk, greedy, ext_keys,
                use_ext)
            t0 = time.time()
            self._h, self._c, self._rng, out, ne = exe(
                self._dp, self._h, self._c, self._rng,
                *self._put(toks2, n_draft, reset, seeds, active, temp,
                           topk, greedy, ext_keys, use_ext))
            # the one per-tick fetch: the tokens and their commit counts
            got = torch.cat([out, ne[:, None]], dim=1).cpu().numpy()
            emitted, n_emit = got[:, :-1], got[:, -1]
            self._spec_dispatches += 1
        else:
            ext_key = np.zeros((S, 2), np.uint32)
            if self.sampling == "counter":
                ext_key = SP.counter_keys(seeds, pos, 1)[:, 0]
                use_ext = active.copy()
            exe = self._get_exe(("tick", S))
            self.watchdog.observe(f"gen_tick_{self.precision}_s{S}",
                                  tokens, reset, seeds, active, temp,
                                  topk, greedy, ext_key, use_ext)
            t0 = time.time()
            self._h, self._c, self._rng, out = exe(
                self._dp, self._h, self._c, self._rng,
                *self._put(tokens, reset, seeds, active, temp, topk,
                           greedy, ext_key, use_ext))
            # the one per-tick fetch: the sampled tokens
            emitted = out.cpu().numpy()[:, None]
            n_emit = active.astype(np.int32)
        dt = time.time() - t0
        self.token_ring.record(dt)
        now = time.time()

        # 4) route emitted tokens (possibly several per slot)
        for i, s in enumerate(slots):
            if s is None:
                continue
            s.needs_reset = False
            if in_prefill[i]:            # tick prefill: force next char
                s.next_input = s.prompt[s.ppos]
                s.ppos += 1
                s.pos += 1
                self._prefill_ticks += 1
                self._c_prefill_tokens.inc(1.0,
                                           session=self.session_id,
                                           mode="tick")
                continue
            m = int(n_emit[i])
            outcome = None
            overrun = False
            for j in range(m):
                tok = int(emitted[i, j])
                s.gen_count += 1
                s.pos += 1
                s.next_input = tok
                s.stream.ids.append(tok)
                if s.draft is not None:
                    s.draft.observe(tok)
                if s.t_first is None:
                    s.t_first = now
                    s.stream.ttft_ms = (now - s.t_join) * 1e3
                    self.ttft_ring.record(now - s.t_join)
                    ring = self.ttft_rings.get(s.prefill_mode)
                    if ring is not None:
                        ring.record(now - s.t_join)
                ok = s.stream._push({"token": tok,
                                     "text": self.vocab.itos[tok]
                                     if tok < self.vocab.size else "�",
                                     "i": s.gen_count - 1})
                self._tokens_out += 1
                self._c_tokens.inc(1.0, session=self.session_id)
                if j >= 1:               # an accepted draft made it out
                    self._spec_accepted += 1
                    self._c_spec_accepted.inc(1.0,
                                              session=self.session_id)
                if not ok:
                    self._stream_errors += 1
                    self._c_stream_err.inc(1.0,
                                           session=self.session_id)
                    s.stream._fail("stream buffer overflow "
                                   "(consumer too slow)")
                    outcome = "error"
                elif s.stream._cancelled.is_set():
                    outcome = "cancelled"
                elif s.stop_id is not None and tok == s.stop_id:
                    outcome = "stop"
                elif s.gen_count >= s.max_new:
                    outcome = "length"
                if outcome is not None:
                    # retiring before the dispatch's last emitted token
                    # leaves the device state ahead of the committed
                    # stream — the capture path must know
                    overrun = j < m - 1
                    break
            if outcome is not None:
                retire.append((i, s, outcome, overrun))

        if self._tokens_out - self._flush_mark >= 64:
            self._flush_mark = self._tokens_out
            for q, v in self.token_ring.quantiles(_QUANTILES).items():
                self._g_token_ms.set(v * 1e3, session=self.session_id,
                                     quantile=str(q))
            for q, v in self.ttft_ring.quantiles(_QUANTILES).items():
                self._g_ttft.set(v * 1e3, session=self.session_id,
                                 quantile=str(q))
            for mode, ring in self.ttft_rings.items():
                for q, v in ring.quantiles(_QUANTILES).items():
                    self._g_prefill_ttft.set(
                        v * 1e3, session=self.session_id, mode=mode,
                        quantile=str(q))

        with self._cv:
            self._commit_retires_locked(retire)
            self._maybe_shrink_locked()
