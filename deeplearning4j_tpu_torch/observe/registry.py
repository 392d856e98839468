"""Process-wide metrics registry with Prometheus text exposition.

The scrape side of the telemetry subsystem: collectors, watchdogs and
listeners publish here; ``ui/server.py`` renders ``render()`` at
``GET /metrics``. Dependency-free by design (the container has no
prometheus_client) — the text exposition format is simple enough to emit
directly: https://prometheus.io/docs/instrumenting/exposition_formats/.

Thread-safe: training threads publish while the HTTP server thread
scrapes.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label_value(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _format_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str, lock: threading.Lock):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        self.name = name
        self.help = help_text
        self._lock = lock
        # label tuple (sorted (k, v) pairs) -> value
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}

    @staticmethod
    def _key(labels: dict) -> Tuple[Tuple[str, str], ...]:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name: {k!r}")
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def get(self, **labels) -> Optional[float]:
        with self._lock:
            return self._series.get(self._key(labels))

    def series(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Snapshot of every label set -> value (health checks iterate
        this; the render path keeps its own copy-under-lock)."""
        with self._lock:
            return dict(self._series)

    def render(self) -> str:
        with self._lock:
            series = dict(self._series)
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, value in sorted(series.items()):
            if key:
                lbl = ",".join(f'{k}="{_escape_label_value(v)}"'
                               for k, v in key)
                lines.append(f"{self.name}{{{lbl}}} {_format_value(value)}")
            else:
                lines.append(f"{self.name} {_format_value(value)}")
        return "\n".join(lines)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._series[self._key(labels)] = float(value)


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(value)


class MetricsRegistry:
    """Create-or-get metric handles; render the whole registry as
    Prometheus text. ``counter``/``gauge`` are idempotent per name so
    independent components can share a series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help_text: str) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_text, threading.Lock())
                self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}")
        return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_text)

    def get_metric(self, name: str) -> Optional[_Metric]:
        """The registered metric, or None — read-only lookups (health
        checks) must not create empty series as a side effect."""
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        chunks = [m.render() for m in metrics]
        return "\n".join(chunks) + ("\n" if chunks else "")


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry served at ``/metrics``."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
