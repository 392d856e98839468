"""Measured autotuning: one persisted TunedConfig artifact per machine.

The port of the JAX package's ``optimize/autotune.py``: the registry of
tunables with the JAX package's committed defaults, a
:class:`TunedConfig` holding measured winners, ``choose`` (the sweep's
decision rule) and a fingerprinted save/load path into the shared
:class:`~deeplearning4j_tpu_torch.parallel.aot_cache.ArtifactStore`, so
one tuning run on one node sizes the whole fleet.

The persistence discipline is the kernel cache's (parallel/aot_cache.py):

- the measured payload is a checksummed blob (``tuned_values.blob``),
  written through the same ``store.save`` chaos seam;
- the manifest (``tuned.json``) carries the fingerprint and the blob's
  sha256 and is written atomically LAST;
- the fingerprint is compared FIELD BY FIELD at load. In place of the
  JAX package's jax, jaxlib and backend it names torch, the CUDA
  version, the device name and the compute capability, under the port's
  own ``format_version``, so a config written by the JAX package (same
  store layout) loads as a ``format_version`` mismatch. ANY mismatch
  falls through to the committed defaults, with a flight-recorder note
  naming the field: a value measured on another backend never applies;
- a blob failing its checksum is quarantined (``.quarantine``) and the
  loader falls through to the defaults.

Consumers resolve values through :func:`resolve_tuned`: an explicit
constructor or CLI argument wins, then the engine's ``tuned_config=``,
then the process-wide config installed by :func:`set_process_tuned`
(the ``serve --tuned-config`` path), then the committed default. The
readers: ``ServingEngine`` (``serving.batch_limit``),
``GenerationEngine`` (``generation.max_slots``,
``generation.prefill_chunk``), ``RetrievalEngine``
(``retrieval.nprobe``, ``retrieval.k_ladder``), ``fit`` (``fit.k_steps``,
``feeder.depth``) and ``DeviceFeeder`` (``feeder.depth``).
``ops.lstm_dispatch`` stays registered, since a config carries it, but
no consumer reads it: every eligible LSTM on the card runs the port's
kernels (ops/fused_lstm.py). The sweeps that measure the values are not
ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.chaos.hook import chaos_site

TUNED_FORMAT_VERSION = "torch-1"
# bump when a tunable's NAME or value SEMANTICS change: a config tuned
# against an older registry must fall through to defaults, not apply
# a value whose meaning drifted
TUNED_REGISTRY_VERSION = 1

TUNED_KEY = "tuned_config"          # default ArtifactStore key
TUNED_MANIFEST = "tuned.json"       # fingerprint + checksum, atomic-LAST
TUNED_BLOB = "tuned_values.blob"    # measured values + decisions


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
    Tunable("fit.k_steps", 1, (1, 2, 4, 8), "steps/s",
            "optimizer steps fused into one device dispatch by the "
            "scanned train step (fit(k_steps=))"),
    Tunable("fit.batch", 256, (128, 256, 384), "examples/s",
            "training batch size the measured examples/s peaked at "
            "(advisory: the iterator owns the batch; readers query "
            "TunedConfig.get('fit.batch'))"),
    Tunable("feeder.depth", 2, (1, 2, 4), "steps/s",
            "DeviceFeeder prefetch depth: batches staged onto the "
            "device ahead of the step loop"),
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
    Tunable("ops.lstm_dispatch", (), ((),), "rules",
            "Pallas-LSTM fused-kernel crossover rules, tuples of "
            "(min_batch, min_hidden, min_seq); the fused path is "
            "taken when ANY rule matches. Empty = always the XLA "
            "scan. On a non-TPU backend the tuner records an explicit "
            "scan-fallback decision instead of leaving the table "
            "silently empty"),
)}


class TunedConfig:
    """Measured tunable values + the decision record behind each.

    ``values`` holds ONLY measured winners — :meth:`get` returns None
    for anything the sweep didn't cover, which is what lets the
    fall-through-to-defaults contract work per tunable rather than
    all-or-nothing. ``decisions`` keeps the full evidence per tunable
    (candidates, scores, exclusions, reason). ``load_outcome`` /
    ``load_reason`` record how this config came to be (``loaded``, or
    one of the fall-through outcomes ``absent``/``mismatch``/
    ``corrupt``)."""

    def __init__(self, values: Optional[Dict[str, Any]] = None,
                 decisions: Optional[Dict[str, Any]] = None,
                 fingerprint: Optional[Dict[str, Any]] = None,
                 source: str = "defaults"):
        self.values = dict(values or {})
        self.decisions = dict(decisions or {})
        self.fingerprint = fingerprint
        self.source = source
        self.load_outcome: Optional[str] = None
        self.load_reason: Optional[str] = None

    @classmethod
    def defaults(cls) -> "TunedConfig":
        """The committed hand-tuned defaults: an EMPTY value map, so
        every consumer resolves to its own constructor default."""
        return cls(source="defaults")

    def get(self, name: str, default: Any = None) -> Any:
        """The measured value for ``name``, or ``default`` when the
        sweep didn't cover it (or this config is the fall-through)."""
        v = self.values.get(name)
        return default if v is None else v

    def effective(self, name: str) -> Any:
        """Measured value if present, else the committed default."""
        return self.get(name, REGISTRY[name].default)

    def record(self, decision: Dict[str, Any]) -> None:
        """Fold one sweep decision (from :func:`choose`) in."""
        name = decision["tunable"]
        if name not in REGISTRY:
            raise KeyError(f"unknown tunable {name!r}")
        self.values[name] = decision["value"]
        self.decisions[name] = decision

    def summary_rows(self) -> List[Tuple[str, Any, Any, str]]:
        """(name, tuned, default, reason) per decided tunable."""
        out = []
        for name in sorted(self.decisions):
            d = self.decisions[name]
            out.append((name, d.get("value"),
                        REGISTRY[name].default, d.get("reason", "")))
        return out


# ---- process-wide config (the `serve --tuned-config` path) --------------

_process_tuned: Optional[TunedConfig] = None
_process_lock = threading.Lock()


def set_process_tuned(cfg: Optional[TunedConfig]) -> None:
    """Install ``cfg`` as the process-wide tuned config every consumer
    falls back to when not handed one explicitly. ``None`` uninstalls."""
    global _process_tuned
    with _process_lock:
        _process_tuned = cfg


def process_tuned() -> Optional[TunedConfig]:
    with _process_lock:
        return _process_tuned


def tuned_value(name: str, tuned: Optional[TunedConfig] = None) -> Any:
    """The measured value for ``name`` from ``tuned`` (or the installed
    process config), or None when nothing tuned covers it. Use this
    where the committed default is contextual (e.g. retrieval nprobe
    falls back to the index build's own hint, not a registry scalar)."""
    cfg = tuned if tuned is not None else process_tuned()
    if cfg is None:
        return None
    return cfg.get(name)


def resolve_tuned(explicit: Any, tuned: Optional[TunedConfig],
                  name: str) -> Any:
    """Consumer-side precedence: explicit caller argument > measured
    tuned value (engine-local config, else the process config) >
    committed registry default."""
    if explicit is not None:
        return explicit
    v = tuned_value(name, tuned)
    if v is not None:
        return v
    return REGISTRY[name].default


# ---- sweep-side decision helper -----------------------------------------

def choose(tunable: Tunable,
           measured: List[Tuple[Any, Any]],
           *, excluded: Optional[Dict[Any, str]] = None,
           note: str = "") -> Dict[str, Any]:
    """Pick the winner from ``measured`` [(candidate, score), ...].

    Best score wins in the tunable's direction; a tie prefers the
    committed default, then the earlier candidate (deterministic).
    ``excluded`` maps candidates that can NEVER win to the reason
    (e.g. a recall-floor miss) — the constraint-not-a-tunable rule.
    Returns the decision record :meth:`TunedConfig.record` consumes.
    """
    excluded = excluded or {}

    def _key(cand):
        return json.dumps(cand, sort_keys=True)

    banned = {_key(c) for c in excluded}
    eligible = [(c, s) for c, s in measured if _key(c) not in banned]
    if not eligible:
        # every candidate violated the constraint: keep the committed
        # default — a sweep can refuse to decide, never force a bad value
        best, best_score = tunable.default, None
        reason = "no candidate met the constraint; kept default"
    else:
        sign = 1.0 if tunable.higher_is_better else -1.0
        best, best_score = eligible[0]
        for cand, score in eligible[1:]:
            if sign * score > sign * best_score or (
                    score == best_score and cand == tunable.default
                    and best != tunable.default):
                best, best_score = cand, score
        reason = note or (f"best measured {tunable.unit} across "
                          f"{len(measured)} cells")
    return {
        "tunable": tunable.name,
        "value": best,
        "default": tunable.default,
        "unit": tunable.unit,
        "higher_is_better": tunable.higher_is_better,
        "score": best_score,
        "measured": [[c, s] for c, s in measured],
        "excluded": [[c, why] for c, why in excluded.items()],
        "reason": reason,
    }


# ---- fingerprint ---------------------------------------------------------

def fingerprint(params: Any = None, *,
                model_version: Optional[str] = None,
                device="cuda") -> Dict[str, Any]:
    """Everything a tuned value's validity depends on: the device the
    sweep ran on (a CPU container's constants must never reach the
    card), the torch and CUDA versions (dispatch overheads shift across
    releases), the tunable registry version, and — when the sweep was
    model-bound — the model weights sha256. ``params=None`` produces a
    machine-level fingerprint whose weights field is a wildcard at
    load."""
    import torch

    from deeplearning4j_tpu_torch.parallel.aot_cache import (
        backend_of, weights_digest)
    return {
        "format_version": TUNED_FORMAT_VERSION,
        "registry_version": TUNED_REGISTRY_VERSION,
        "model_version": model_version,
        "weights_sha256": (weights_digest(params)
                           if params is not None else None),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": backend_of(device),
    }


def _want_fields(expect: Dict[str, Any]) -> Dict[str, Any]:
    """The fields a loader actually pins: ``None``-valued optional
    bindings (weights_sha256, model_version) are wildcards — a
    machine-level consumer accepts any model's tuned artifact, but a
    model-bound expectation still rejects a foreign one. ``expect=None``
    pins nothing (every field a wildcard)."""
    want = dict(expect or {})
    for optional in ("weights_sha256", "model_version"):
        if want.get(optional) is None:
            want.pop(optional, None)
    return want


# ---- persistence ---------------------------------------------------------

def _loads_counter(registry):
    if registry is None:
        from deeplearning4j_tpu_torch.observe.registry import (
            default_registry)
        registry = default_registry()
    return registry.counter(
        "dl4j_autotune_artifact_loads_total",
        "TunedConfig artifact load attempts; outcome=loaded (applied) "
        "| absent (no artifact yet) | mismatch (fingerprint field "
        "diverged -> committed defaults) | corrupt (checksum/parse "
        "failure -> blob quarantined, committed defaults)")


def save_tuned(store, cfg: TunedConfig, *, key: str = TUNED_KEY) -> str:
    """Publish ``cfg`` into the shared ArtifactStore under ``key``.

    Blob first (checksummed, riding the ``store.save`` chaos seam),
    manifest atomically LAST — a crash or a concurrent reader mid-save
    sees either the previous artifact or a clean miss, never a
    half-written config. Returns the object dir."""
    if cfg.fingerprint is None:
        raise ValueError("save_tuned needs cfg.fingerprint (use "
                         "autotune.fingerprint())")
    d = Path(store.cache_dir(key))
    payload = json.dumps({"values": cfg.values,
                          "decisions": cfg.decisions},
                         indent=2, sort_keys=True).encode("utf-8")
    checksum = hashlib.sha256(payload).hexdigest()
    chaos = chaos_site("store.save")
    blob = payload
    if chaos is not None:
        blob, _ = chaos.mangle(blob, arg="blob")
    (d / TUNED_BLOB).write_bytes(blob)
    manifest = json.dumps({"format_version": TUNED_FORMAT_VERSION,
                           "fingerprint": cfg.fingerprint,
                           "sha256": checksum},
                          indent=2).encode("utf-8")
    if chaos is not None:
        manifest, _ = chaos.mangle(manifest, arg="manifest")
    tmp = d / (TUNED_MANIFEST + ".tmp")
    tmp.write_bytes(manifest)
    os.replace(tmp, d / TUNED_MANIFEST)
    return str(d)


def _quarantine(path: Path) -> None:
    try:
        os.replace(path, str(path) + ".quarantine")
    except OSError:
        pass


def load_tuned(store, *, expect: Optional[Dict[str, Any]],
               key: str = TUNED_KEY, registry=None,
               recorder=None) -> TunedConfig:
    """Load the tuned artifact under ``key``, validating its
    fingerprint field by field against ``expect`` (``None`` pins
    nothing — any artifact's fingerprint is accepted).

    Never raises. On any failure the returned config is the committed
    defaults with ``load_outcome`` / ``load_reason`` set:

    - ``absent``   no manifest published yet
    - ``mismatch`` a fingerprint field diverged (the reason names it)
    - ``corrupt``  unreadable manifest or a blob failing its checksum;
      the bad file is quarantined (``.quarantine``) so the failure is
      paid once
    - ``loaded``   fingerprint matched; measured values apply

    Every outcome increments ``dl4j_autotune_artifact_loads_total``
    and, with a ``recorder`` (a FlightRecorder), leaves a note that
    rides any later crash dump, so a node serving on fall-through
    defaults explains itself post-mortem."""
    counter = _loads_counter(registry)

    def _fall_through(outcome: str, reason: str) -> TunedConfig:
        cfg = TunedConfig.defaults()
        cfg.load_outcome = outcome
        cfg.load_reason = reason
        counter.inc(1.0, outcome=outcome)
        if recorder is not None:
            recorder.note("autotune.tuned_config",
                          {"outcome": outcome, "reason": reason,
                           "key": key})
        return cfg

    from deeplearning4j_tpu_torch.parallel.aot_cache import (
        _first_mismatch, _mismatch_reason)
    d = Path(store.cache_dir(key))
    mpath = d / TUNED_MANIFEST
    if not mpath.exists():
        return _fall_through("absent", f"no {TUNED_MANIFEST} under "
                             f"{key!r}")
    try:
        manifest = json.loads(mpath.read_text())
        got_fp = manifest.get("fingerprint", {})
    except (OSError, json.JSONDecodeError, UnicodeDecodeError,
            AttributeError) as e:
        _quarantine(mpath)
        return _fall_through(
            "corrupt", f"unreadable manifest ({type(e).__name__}); "
            "quarantined")
    diff = _first_mismatch(_want_fields(expect), got_fp)
    if diff is not None:
        return _fall_through(
            "mismatch", _mismatch_reason(expect, got_fp, diff))
    bpath = d / TUNED_BLOB
    try:
        raw = bpath.read_bytes()
    except OSError as e:
        return _fall_through(
            "corrupt", f"blob unreadable ({type(e).__name__})")
    want_sha = manifest.get("sha256")
    if want_sha is None \
            or hashlib.sha256(raw).hexdigest() != want_sha:
        _quarantine(bpath)
        return _fall_through(
            "corrupt", "blob checksum mismatch; quarantined")
    try:
        payload = json.loads(raw.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        _quarantine(bpath)
        return _fall_through(
            "corrupt", f"blob unparseable ({type(e).__name__}); "
            "quarantined")
    values = {k: v for k, v in (payload.get("values") or {}).items()
              if k in REGISTRY}
    cfg = TunedConfig(values, payload.get("decisions") or {},
                      fingerprint=got_fp, source=str(d))
    cfg.load_outcome = "loaded"
    counter.inc(1.0, outcome="loaded")
    if recorder is not None:
        recorder.note("autotune.tuned_config",
                      {"outcome": "loaded", "key": key,
                       "tunables": sorted(values)})
    return cfg
