"""Tunable defaults and their precedence.

From the JAX package's ``optimize/autotune.py``: the ``Tunable`` record,
the serving and generation entries of its registry
(``serving.batch_limit``, ``generation.max_slots``,
``generation.prefill_chunk``, ``retrieval.nprobe`` and
``retrieval.k_ladder``, with the JAX package's committed defaults)
and ``resolve_tuned``'s precedence, explicit argument > tuned config >
committed default. The port has no measured ``TunedConfig`` and no
process-wide one yet (ROADMAP, queue 1 item 16): a caller that passes a
tuned config gets ``NotImplementedError`` rather than a config silently
ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class Tunable:
    """One registered knob: its committed hand-tuned default, the
    candidate grid a sweep measures, and how to read the score."""
    name: str
    default: Any
    candidates: Tuple[Any, ...]
    unit: str
    description: str
    higher_is_better: bool = True
    constraint: Optional[str] = None


REGISTRY: Dict[str, Tunable] = {t.name: t for t in (
    Tunable("serving.batch_limit", 32, (8, 16, 32, 64), "req/s",
            "ServingEngine max examples per dispatch; also the top "
            "rung of the pow2 bucket ladder the warmup sweep compiles "
            "(the ladder is derived, so tuning this tunes both)"),
    Tunable("generation.max_slots", 8, (2, 4, 8, 16), "tok/s",
            "continuous-batching slot count; the AOT warmup sweeps "
            "the pow2 slot ladder and the reachable resize pairs up "
            "to it, so tuning this also sizes the warm set"),
    Tunable("generation.prefill_chunk", 0, (0, 16, 64), "ms TTFT",
            "chunked-prefill scan width (pow2 chunk ladder below it "
            "is warmed); 0 = one-tick-per-token prefill",
            higher_is_better=False),
    Tunable("retrieval.nprobe", 64, (4, 8, 16, 32, 64), "qps",
            "IVF clusters probed per query; the recall@k floor is a "
            "CONSTRAINT on the sweep, not a tunable — a candidate "
            "below the floor can never win, whatever its qps",
            constraint="recall@10 >= 0.95 vs the exact f32 oracle"),
    Tunable("retrieval.k_ladder", (1, 10, 100), ((1, 10, 100), (10, 100)),
            "qps",
            "warmed k rungs; a request's k pads up to the next rung"),
)}

# the ArtifactStore key and manifest of a measured TunedConfig, the JAX
# package's: what the serve CLI looks for before it refuses a store
# that holds one
TUNED_KEY = "tuned_config"
TUNED_MANIFEST = "tuned.json"

_NOT_PORTED = ("measured tuned configs (TunedConfig) are not ported yet "
               "(ROADMAP.md, queue 1 item 16)")


def tuned_value(name: str, tuned=None) -> Any:
    """The measured value for ``name``, or None when nothing tuned covers
    it. The port has no process config; a tuned config raises."""
    if tuned is not None:
        raise NotImplementedError(_NOT_PORTED)
    return None


def resolve_tuned(explicit: Any, tuned, name: str) -> Any:
    """Consumer-side precedence: explicit caller argument > measured
    tuned value (engine-local config, else the process config) >
    committed registry default. The port has no process config, and a
    tuned config raises, since the port cannot build one yet."""
    if tuned is not None:
        raise NotImplementedError(_NOT_PORTED)
    if explicit is not None:
        return explicit
    return REGISTRY[name].default
