"""Health evaluation over the metrics registry.

``/healthz`` on the UI server used to be a bare liveness probe; a
process that is alive but training garbage (NaN storm, recompile storm,
desynced replicas) answered "ok". This module turns the registry's
already-published series into a degradation verdict so orchestrators and
probes see a 503 + reason while the run is still salvageable.

Conditions (each tunable via environment):

- any ``dl4j_nonfinite_values_total`` series > 0 — gradients or loss
  went NaN/Inf (the flight recorder has written a post-mortem by now)
- ``dl4j_recompiles_total`` >= ``DL4J_RECOMPILE_STORM`` (default 8) —
  a leaky input pipeline is retracing the step
- ``dl4j_replica_divergence`` > ``DL4J_DIVERGENCE_THRESHOLD`` (default
  2.0, i.e. the per-replica grad-norm spread exceeds 2x its mean
  magnitude) — a data-parallel replica has drifted from the pack
- any ``dl4j_elastic_peer_loss_total`` > 0 — the collective watchdog
  declared a peer dead; this process (or a peer) wrote an emergency
  checkpoint and a ``PEER_LOSS.json`` marker and should be relaunched
- ``dl4j_elastic_staleness`` > ``DL4J_ELASTIC_STALENESS_LIMIT``
  (default: the ASYNC_ELASTIC staleness bound, 3) — some worker has
  been dropped from so many consecutive rounds its contributions can
  no longer be merged
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observe.registry import (
    MetricsRegistry,
    default_registry,
)

DEFAULT_RECOMPILE_STORM = 8
DEFAULT_DIVERGENCE_THRESHOLD = 2.0
DEFAULT_STALENESS_LIMIT = 3.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _labels_str(key) -> str:
    return ",".join(f"{k}={v}" for k, v in key) or "-"


def health_status(registry: Optional[MetricsRegistry] = None) -> Dict:
    """``{"status": "ok"|"degraded", "reasons": [...]}`` from the
    registry's current series. Pure read: missing metrics (nothing
    trained yet) are healthy, and the check never creates series."""
    r = registry if registry is not None else default_registry()
    reasons: List[str] = []

    m = r.get_metric("dl4j_nonfinite_values_total")
    if m is not None:
        for key, v in sorted(m.series().items()):
            if v > 0:
                reasons.append(
                    f"nonfinite: {v:g} non-finite gradient/loss values "
                    f"({_labels_str(key)})")

    storm = _env_float("DL4J_RECOMPILE_STORM", DEFAULT_RECOMPILE_STORM)
    m = r.get_metric("dl4j_recompiles_total")
    if m is not None:
        for key, v in sorted(m.series().items()):
            if v >= storm:
                reasons.append(
                    f"recompile_storm: {v:g} recompiles >= threshold "
                    f"{storm:g} ({_labels_str(key)})")

    thresh = _env_float("DL4J_DIVERGENCE_THRESHOLD",
                        DEFAULT_DIVERGENCE_THRESHOLD)
    m = r.get_metric("dl4j_replica_divergence")
    if m is not None:
        for key, v in sorted(m.series().items()):
            if math.isnan(v) or v > thresh:
                reasons.append(
                    f"replica_divergence: spread {v:g} > threshold "
                    f"{thresh:g} ({_labels_str(key)})")

    m = r.get_metric("dl4j_elastic_peer_loss_total")
    if m is not None:
        for key, v in sorted(m.series().items()):
            if v > 0:
                reasons.append(
                    f"peer_loss: {v:g} dead-peer event(s) — emergency "
                    "checkpoint + PEER_LOSS marker written, relaunch to "
                    f"resume ({_labels_str(key)})")

    stale_limit = _env_float("DL4J_ELASTIC_STALENESS_LIMIT",
                             DEFAULT_STALENESS_LIMIT)
    m = r.get_metric("dl4j_elastic_staleness")
    if m is not None:
        for key, v in sorted(m.series().items()):
            if v > stale_limit:
                reasons.append(
                    f"elastic_staleness: a worker has drifted {v:g} "
                    f"rounds > limit {stale_limit:g} — its updates are "
                    f"being discarded ({_labels_str(key)})")

    return {"status": "degraded" if reasons else "ok",
            "reasons": reasons}
