"""Observability: the metrics registry, the recompile watchdog, latency
rings and the health verdict.

The port of the JAX package's ``observe/``, for the names the serving
stack uses: ``registry`` (the process-wide Prometheus registry scraped
at ``/metrics``), ``recompile`` (new dispatch signatures become a
counter), ``latency`` (streaming quantiles) and ``health`` (the
``/healthz`` degradation verdict over the registry). The telemetry
ring, the span tracer and the flight recorder are not ported yet
(ROADMAP.md, queue 1 item 10).
"""

from deeplearning4j_tpu_torch.observe.health import health_status
from deeplearning4j_tpu_torch.observe.latency import LatencyRing
from deeplearning4j_tpu_torch.observe.recompile import RecompileWatchdog
from deeplearning4j_tpu_torch.observe.registry import (
    MetricsRegistry,
    default_registry,
)

__all__ = ["MetricsRegistry", "default_registry", "health_status",
           "LatencyRing", "RecompileWatchdog"]
