"""Host-side span tracer with Chrome/Perfetto trace JSON export.

The port of the JAX package's ``observe/tracer.py``: named wall-clock
spans around the training loop's phases (etl, host→device transfer,
dispatch, telemetry flush, eval, checkpoint) and the serving engine's
(queue wait, batch forming, dispatch, device, fetch), written in the
Chrome Trace Event Format — load the file at https://ui.perfetto.dev or
chrome://tracing. With ``use_torch_profiler=True`` each span also opens
a ``torch.profiler.record_function`` range, so inside a
``torch.profiler`` capture the host spans line up against the CUDA
lanes.

A span around an asynchronous launch (a train step's ``dispatch``, a
feeder's ``host_to_device``) measures the enqueue on the host, not the
work on the card, exactly as the JAX package's spans around its
asynchronous dispatch do; the card's time is the profiler's.

Disabled tracers are free: ``span()`` returns before touching the
clock, so the default ``NULL_TRACER`` can stay wired into every loop.
At ``max_events`` further spans are dropped and counted
(``dropped_events``, exported under ``otherData``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional


class SpanTracer:
    def __init__(self, enabled: bool = True,
                 use_torch_profiler: bool = False,
                 max_events: int = 200_000):
        self.enabled = enabled
        self.use_torch_profiler = use_torch_profiler
        self.max_events = max_events
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._dropped = 0

    # ---- recording ------------------------------------------------------
    @contextmanager
    def span(self, name: str, cat: str = "train", **args):
        if not self.enabled:
            yield
            return
        rng = None
        if self.use_torch_profiler:
            try:
                import torch.profiler
                rng = torch.profiler.record_function(name)
                rng.__enter__()
            except Exception:
                rng = None
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            if rng is not None:
                rng.__exit__(None, None, None)
            self.add_span(name, start, end, cat=cat, **args)

    def add_span(self, name: str, start_s: float, end_s: float,
                 cat: str = "train", **args):
        """Record a span from endpoints measured elsewhere (the fit loop
        already times its ETL windows; measuring again would skew them)."""
        if not self.enabled:
            return
        ev = {
            "name": name, "cat": cat, "ph": "X",
            "ts": (start_s - self._t0) * 1e6,       # µs, trace-relative
            "dur": max(0.0, (end_s - start_s) * 1e6),
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(ev)

    def instant(self, name: str, cat: str = "train", **args):
        """Zero-duration marker (e.g. a serving bucket's first dispatch)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": (now - self._t0) * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(ev)

    # ---- export ---------------------------------------------------------
    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    @property
    def dropped_events(self) -> int:
        return self._dropped

    def clear(self):
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms",
                "otherData": {"tracer": "deeplearning4j_tpu_torch.observe",
                              "dropped_events": self._dropped}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


class _NullTracer(SpanTracer):
    """Shared always-off tracer; wiring it in costs one ``if``."""

    def __init__(self):
        super().__init__(enabled=False)


NULL_TRACER = _NullTracer()


def get_tracer(model=None) -> SpanTracer:
    """The tracer attached to a model, else the shared no-op."""
    t: Optional[SpanTracer] = getattr(model, "tracer", None)
    return t if t is not None else NULL_TRACER
