"""Flight recorder: always-on black-box crash forensics for training.

The port of the JAX package's ``observe/flight_recorder.py`` (analog of
the reference's ``CrashReportingUtil``: an OOM during fit writes a
memory/config crash dump, on by default). When a run dies, the evidence
is the last N decoded telemetry rows, the per-layer histograms, the
memory report and the span tail — all already on the host
through the one-fetch telemetry design (observe/telemetry.py).

Triggers:

- **nonfinite** — a flushed telemetry row reports ``nonfinite_count > 0``
  or a non-finite loss (``poll()``, called after each flush)
- **oom** — an exception leaving ``fit`` that is a
  ``torch.OutOfMemoryError``, or whose text carries an out-of-memory
  marker
- **exception** — any other exception leaving ``fit``

Each trigger writes ONE directory (``dump_<reason>_<time>_<pid>``: the
JAX package's file names and sections, ``report.md`` first) and
announces it through the model's listeners' ``on_crash_dump`` hook. A
reason dumps at most once per recorder and at most ``max_dumps`` dumps
are written; ``record_crash`` never raises (a crash handler that crashes
masks the crash); ``DL4J_CRASH_DUMPS=0`` turns the default recorder off
and ``DL4J_CRASH_DUMP_DIR`` moves it.

The memory section reads ``torch.cuda.memory_stats`` and
``torch.cuda.mem_get_info`` of every card; the environment section
records torch, the CUDA version, the card's name and its power limit.
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)

_ENV_DISABLE = "DL4J_CRASH_DUMPS"
_ENV_DIR = "DL4J_CRASH_DUMP_DIR"

# substrings identifying an accelerator OOM in exception text (the JAX
# package's XLA markers and the CUDA caching allocator's message)
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM ", "Resource exhausted", "failed to allocate")


def crash_dumps_enabled() -> bool:
    return os.environ.get(_ENV_DISABLE, "1") != "0"


class FlightRecorder:
    """Black-box recorder bound to nothing until a terminal event fires.

    ``poll()`` inspects only records the telemetry collector has already
    decoded on the host, so arming the recorder makes no device fetch of
    its own."""

    def __init__(self, dump_dir: Optional[str] = None, last_n: int = 100,
                 enabled: Optional[bool] = None, max_dumps: int = 4):
        self.dump_dir = dump_dir or os.environ.get(_ENV_DIR) or \
            os.path.join(tempfile.gettempdir(), "dl4j_crash_dumps")
        self.last_n = int(last_n)
        self.enabled = crash_dumps_enabled() if enabled is None \
            else bool(enabled)
        self.max_dumps = int(max_dumps)
        self.dumps: List[str] = []          # paths written, in order
        self._notes: Dict[str, Any] = {}    # breadcrumbs (see note())
        self._dumped_reasons: set = set()
        self._seen_records = 0
        self._lock = threading.Lock()

    # ---- steady-state hook ----------------------------------------------
    def poll(self, model) -> Optional[str]:
        """Scan telemetry records decoded since the last poll for
        non-finite evidence; write a dump on the first hit."""
        if not self.enabled:
            return None
        tel = getattr(model, "telemetry", None)
        if tel is None:
            return None
        hit = False
        n = len(tel.history)
        if n > self._seen_records:
            for rec in tel.history[self._seen_records:n]:
                if (rec.get("nonfinite_count", 0.0) > 0
                        or not _finite(rec.get("loss"))):
                    hit = True
                    break
            self._seen_records = n
        if hit:
            return self.record_crash(model, reason="nonfinite")
        return None

    def note(self, key: str, value: Any):
        """A breadcrumb that rides along in ``context.json`` of every
        later dump (last write per key wins). Never raises."""
        try:
            with self._lock:
                self._notes[str(key)] = value
        except Exception:
            pass

    # ---- terminal events ------------------------------------------------
    def record_crash(self, model, reason: Optional[str] = None,
                     exc: Optional[BaseException] = None,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Optional[str]:
        """Write one post-mortem directory; returns its path, or None
        (disabled, this reason already dumped, ``max_dumps`` reached, or
        the write failed). Never raises. ``extra`` lands in
        ``context.json``."""
        try:
            if not self.enabled:
                return None
            if reason is None:
                reason = _classify(exc)
            with self._lock:
                if reason in self._dumped_reasons or \
                        len(self.dumps) >= self.max_dumps:
                    return None
                self._dumped_reasons.add(reason)
            path = self._write_dump(model, reason, exc, extra)
            if path is not None:
                self.dumps.append(path)
                log.error("flight recorder: %s — post-mortem dump "
                          "written to %s", reason, path)
                for lst in list(getattr(model, "listeners", ())):
                    try:
                        hook = getattr(lst, "on_crash_dump", None)
                        if hook is not None:
                            hook(model, path, reason)
                    except Exception:
                        pass        # a listener bug must not mask the dump
            return path
        except Exception:
            log.exception("flight recorder failed to write a crash dump")
            return None

    # ---- dump assembly --------------------------------------------------
    def _write_dump(self, model, reason: str,
                    exc: Optional[BaseException],
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Optional[str]:
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(self.dump_dir,
                            f"dump_{reason}_{stamp}_{os.getpid()}")
        os.makedirs(path, exist_ok=True)

        sections: Dict[str, bool] = {}

        def write(name: str, obj: Any) -> bool:
            try:
                with open(os.path.join(path, name), "w") as f:
                    json.dump(obj, f, indent=1, default=str)
                sections[name] = True
                return True
            except Exception:
                log.debug("flight recorder: section %s failed", name,
                          exc_info=True)
                sections[name] = False
                return False

        tel = getattr(model, "telemetry", None)
        if tel is not None:
            write("telemetry.json", {
                "metric_names": list(getattr(tel.spec, "metric_names",
                                             ()) if tel.spec else ()),
                "flush_interval": tel.flush_interval,
                "fetch_count": tel.fetch_count,
                "dropped_rows": tel.dropped_rows,
                "records": tel.history[-self.last_n:],
                "replica_metrics": list(getattr(tel.spec,
                                                "replica_metrics", ())
                                        if tel.spec else ()),
                "replica_records": tel.replica_history[-self.last_n:],
            })
            if tel.hist_history:
                write("histograms.json", {
                    "bins": tel.hist_bins,
                    "interval": tel.hist_interval,
                    "records": tel.hist_history[-self.hist_tail:],
                })
        write("memory.json", self._memory_section(model, reason))
        tracer = getattr(model, "tracer", None)
        if tracer is not None and getattr(tracer, "enabled", False):
            trace = tracer.to_chrome_trace()
            trace["traceEvents"] = trace["traceEvents"][-500:]
            write("spans.json", trace)
        with self._lock:
            context = dict(self._notes)
        if extra:
            context.update(extra)
        if context:
            write("context.json", context)
        write("environment.json", self._environment_section(model))
        self._write_report(path, model, reason, exc, sections)
        return path

    # hist tail kept small: each record is n_layers * 3 * bins floats
    hist_tail = 8

    def _memory_section(self, model, reason: str) -> Dict:
        """The caching allocator's numbers and CUDA's free/total
        bytes of every card, plus the parameter bytes of the model. No
        kernel runs and nothing is allocated on the card, so an OOM dump
        cannot become a second crash."""
        out: Dict[str, Any] = {}
        try:
            import torch
            devs = []
            if torch.cuda.is_available():
                for i in range(torch.cuda.device_count()):
                    entry: Dict[str, Any] = {
                        "id": i, "platform": "cuda",
                        "kind": torch.cuda.get_device_name(i)}
                    try:
                        stats = torch.cuda.memory_stats(i)
                        entry["bytes_in_use"] = stats.get(
                            "allocated_bytes.all.current")
                        entry["peak_bytes_in_use"] = stats.get(
                            "allocated_bytes.all.peak")
                        entry["bytes_reserved"] = stats.get(
                            "reserved_bytes.all.current")
                        entry["num_alloc_retries"] = stats.get(
                            "num_alloc_retries")
                        entry["num_ooms"] = stats.get("num_ooms")
                        free, total = torch.cuda.mem_get_info(i)
                        entry["bytes_free"] = int(free)
                        entry["bytes_limit"] = int(total)
                    except Exception:
                        pass
                    devs.append(entry)
            out["devices"] = devs
        except Exception:
            pass
        try:
            from deeplearning4j_tpu_torch.optimize.updaters import \
                tree_leaves
            params = getattr(model, "params", None) or {}
            out["analytic"] = {
                "param_bytes": int(sum(t.numel() * t.element_size()
                                       for t in tree_leaves(params))),
                "device": str(getattr(model, "device", "?"))}
        except Exception:
            pass
        try:
            from deeplearning4j_tpu_torch.nn.memory import memory_report
            conf = getattr(model, "conf", None)
            if conf is not None and hasattr(conf, "layers"):
                out.setdefault("analytic", {}).update(json.loads(
                    memory_report(conf, type(model).__name__).to_json()))
        except Exception:
            pass
        return out

    def _environment_section(self, model) -> Dict:
        out: Dict[str, Any] = {
            "python": sys.version,
            "argv": sys.argv,
            "model_class": type(model).__name__,
        }
        try:
            import torch
            out["torch_version"] = torch.__version__
            out["cuda_version"] = torch.version.cuda
            out["backend"] = ("cuda" if torch.cuda.is_available()
                              else "cpu")
            out["device_count"] = torch.cuda.device_count()
            if torch.cuda.is_available():
                out["device_name"] = torch.cuda.get_device_name(0)
                out["power_limit"] = _power_limit()
        except Exception:
            pass
        try:
            out["num_params"] = int(model.num_params())
            out["layer_names"] = list(getattr(model, "layer_names", ()))
        except Exception:
            pass
        try:
            conf = getattr(model, "conf", None)
            if conf is not None and hasattr(conf, "to_json"):
                out["model_config"] = json.loads(conf.to_json())
        except Exception:
            pass
        out["env"] = {k: v for k, v in sorted(os.environ.items())
                      if k.startswith(("CUDA_", "PYTORCH_", "TORCH_",
                                       "DL4J_", "NCCL_"))}
        return out

    def _write_report(self, path: str, model, reason: str,
                      exc: Optional[BaseException],
                      sections: Dict[str, bool]):
        """The human entry point (the CrashReportingUtil text analog):
        ``report.md`` summarizes the event and indexes the sections."""
        lines = [f"# Training post-mortem: {reason}", "",
                 f"- written: {time.strftime('%Y-%m-%d %H:%M:%S')}",
                 f"- model: {type(model).__name__}",
                 f"- pid: {os.getpid()}"]
        it = getattr(model, "iteration", None)
        if it is not None:
            lines.append(f"- host iteration: {it}")
        tel = getattr(model, "telemetry", None)
        if tel is not None and tel.last_record() is not None:
            last = tel.last_record()
            lines.append(f"- last flushed row: iteration "
                         f"{last.get('iteration')}, loss "
                         f"{last.get('loss')}, grad_norm "
                         f"{last.get('grad_norm')}, nonfinite_count "
                         f"{last.get('nonfinite_count')}")
        if exc is not None:
            lines += ["", "## Exception", "", "```",
                      "".join(traceback.format_exception(
                          type(exc), exc, exc.__traceback__))[-8000:],
                      "```"]
        lines += ["", "## Sections", ""]
        for name, ok in sorted(sections.items()):
            lines.append(f"- `{name}`: "
                         f"{'written' if ok else 'FAILED'}")
        lines += ["", "Disable these dumps with DL4J_CRASH_DUMPS=0; "
                  f"relocate them with {_ENV_DIR}=<dir>.", ""]
        try:
            with open(os.path.join(path, "report.md"), "w") as f:
                f.write("\n".join(lines))
        except Exception:
            pass


def _power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except Exception:
        return None


def _finite(v) -> bool:
    try:
        return v is None or math.isfinite(v)
    except TypeError:
        return True


def _classify(exc: Optional[BaseException]) -> str:
    if exc is None:
        return "exception"
    try:
        import torch
        if isinstance(exc, torch.OutOfMemoryError):
            return "oom"
    except (ImportError, AttributeError):
        pass
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _OOM_MARKERS):
        return "oom"
    return "exception"


_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def default_flight_recorder() -> Optional[FlightRecorder]:
    """The process-wide always-on recorder every model uses unless one
    was attached, or None when DL4J_CRASH_DUMPS=0."""
    if not crash_dumps_enabled():
        return None
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default
