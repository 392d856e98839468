"""Observability: in-step telemetry on the card, the span tracer, the
flight recorder, the metrics registry, the recompile watchdog, latency
rings and the health verdict.

The port of the JAX package's ``observe/``:

- ``telemetry``: a metric spec (loss, global gradient norm, non-finite
  count, per-layer update:param ratios, optional histograms) recorded
  inside each train step into a fixed-size ring on the card and fetched
  in ONE transfer every N steps — between flushes, no sync;
- ``tracer``: host spans (etl, host→device, dispatch, flush, eval,
  checkpoint; the serving engine's) exported as Chrome/Perfetto trace
  JSON, optionally as ``torch.profiler`` ranges;
- ``flight_recorder``: always-on crash forensics — a non-finite row, an
  OOM or an exception leaving ``fit`` writes one post-mortem directory;
- ``registry``: the process-wide Prometheus registry scraped at
  ``/metrics``; ``recompile``: new dispatch signatures become a counter;
  ``latency``: streaming quantiles; ``health``: the ``/healthz`` verdict.
"""

from deeplearning4j_tpu_torch.observe.flight_recorder import (
    FlightRecorder,
    crash_dumps_enabled,
    default_flight_recorder,
)
from deeplearning4j_tpu_torch.observe.health import health_status
from deeplearning4j_tpu_torch.observe.latency import LatencyRing
from deeplearning4j_tpu_torch.observe.recompile import RecompileWatchdog
from deeplearning4j_tpu_torch.observe.registry import (
    MetricsRegistry,
    default_registry,
)
from deeplearning4j_tpu_torch.observe.telemetry import (
    HistRing,
    TelemetryBuffer,
    TelemetryCollector,
    TelemetrySpec,
)
from deeplearning4j_tpu_torch.observe.tracer import NULL_TRACER, SpanTracer

__all__ = [
    "MetricsRegistry",
    "default_registry",
    "FlightRecorder",
    "default_flight_recorder",
    "crash_dumps_enabled",
    "health_status",
    "LatencyRing",
    "RecompileWatchdog",
    "HistRing",
    "TelemetryBuffer",
    "TelemetryCollector",
    "TelemetrySpec",
    "SpanTracer",
    "NULL_TRACER",
]
