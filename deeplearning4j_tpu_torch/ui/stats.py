"""StatsListener: per-iteration training statistics.

Analog of the reference's BaseStatsListener
(deeplearning4j-ui-model/.../stats/BaseStatsListener.java:43,
iterationDone:304; SURVEY §2.12, §5.5): collects score, timing
(samples/sec, minibatches/sec), per-layer parameter/update histograms and
mean-magnitude norms, plus device/runtime static info, and routes records
into a StatsStorageRouter. Where the reference polls JVM/GC/JITA
counters, this reads the CUDA caching allocator's statistics.

The port of the JAX package's ``ui/stats.py``. On a model with a
histogram-enabled ``TelemetryCollector`` the histograms come from the
last flush of the ring (no copy of the parameters); otherwise the
parameters are copied to the host for them, a sync each reported
iteration, as in the JAX package.
"""

from __future__ import annotations

import socket
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves, tree_map
from deeplearning4j_tpu_torch.ui.storage import StatsStorageRouter


def _host(t) -> np.ndarray:
    """A leaf as a host numpy array (bf16 leaves as float32)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _histogram(a: np.ndarray, bins: int = 20) -> dict:
    a = np.asarray(a, np.float64).ravel()
    if a.size == 0:
        return {"counts": [], "min": 0.0, "max": 0.0}
    lo, hi = float(a.min()), float(a.max())
    if lo == hi:
        hi = lo + 1e-12
    counts, _edges = np.histogram(a, bins=bins, range=(lo, hi))
    return {"counts": counts.tolist(), "min": lo, "max": hi}


class StatsListener(TrainingListener):
    """Attach to a model with ``model.set_listeners(StatsListener(storage))``
    then open the dashboard (ui/server.py)."""

    def __init__(self, router: StatsStorageRouter,
                 session_id: Optional[str] = None,
                 worker_id: str = "w0",
                 update_frequency: int = 1,
                 collect_histograms: bool = True,
                 histogram_bins: int = 20):
        self.router = router
        self.session_id = session_id or f"sess_{uuid.uuid4().hex[:10]}"
        self.worker_id = worker_id
        self.update_frequency = max(1, update_frequency)
        self.collect_histograms = collect_histograms
        self.histogram_bins = histogram_bins
        self._static_sent = False
        # seed timing from a start timestamp so the FIRST flushed record
        # carries real dt-based throughput instead of None (the record
        # used to be emitted with absent timing)
        self._start_time: float = time.time()
        self._last_time: Optional[float] = None
        self._prev_params: Optional[Dict] = None
        # accumulated across skipped iterations when update_frequency > 1
        self._acc_samples = 0
        self._acc_iters = 0

    # ---- TrainingListener hooks -----------------------------------------
    def on_epoch_start(self, model, epoch: int):
        # re-anchor the start stamp to when training actually begins
        # (construction can predate fit() by a long time); only until the
        # first record is out
        if self._last_time is None:
            self._start_time = time.time()

    def iteration_done(self, model, iteration: int, epoch: int, loss,
                       etl_ms: float, batch_size: int):
        if not self._static_sent:
            self._send_static(model)
        self._acc_samples += int(batch_size)
        self._acc_iters += 1
        if iteration % self.update_frequency != 0:
            return
        now = time.time()
        anchor = self._last_time if self._last_time is not None \
            else self._start_time
        dt = now - anchor
        self._last_time = now
        samples, iters = self._acc_samples, self._acc_iters
        self._acc_samples = 0
        self._acc_iters = 0

        tel = getattr(model, "telemetry", None)
        if tel is not None:
            # flushed from the on-device ring: no device sync here
            score = tel.last("loss")
        else:
            score = float(loss)
        record = {
            "session_id": self.session_id,
            "worker_id": self.worker_id,
            "timestamp": now,
            "iteration": iteration,
            "epoch": epoch,
            "score": score,
            "etl_ms": float(etl_ms),
            "batch_size": int(batch_size),
            # throughput over ALL iterations since the last report, not
            # just the reported one
            "samples_per_sec": (samples / dt) if dt > 0 else None,
            "minibatches_per_sec": (iters / dt) if dt > 0 else None,
        }
        if tel is not None and tel.last_record() is not None:
            # device-computed series (grad norm, update ratios, NaN
            # counts) ride along for the dashboard
            record["device_metrics"] = dict(tel.last_record())
        if self.collect_histograms:
            # histogram-enabled telemetry already computed fixed-bin
            # param/grad/update histograms INSIDE the train step and
            # flushed them in the ring's one fetch — consume those and
            # skip the device→host parameter copy entirely
            from_tel = (self._stats_from_telemetry(tel)
                        if tel is not None else None)
            if from_tel is not None:
                record["param_stats"] = from_tel["param"]
                if from_tel["update"]:
                    record["update_stats"] = from_tel["update"]
                if from_tel["grad"]:
                    record["grad_stats"] = from_tel["grad"]
            else:
                params = tree_map(_host, model.params)
                record["param_stats"] = self._layer_stats(params)
                if self._prev_params is not None:
                    record["update_stats"] = self._update_stats(
                        self._prev_params, params)
                # device→host param copy only when histograms consume it
                self._prev_params = params
        record["memory"] = self._memory_stats(model)
        self.router.put_update(record)

    # ---- payload assembly ------------------------------------------------
    def _send_static(self, model):
        dev = torch.device(getattr(model, "device", "cpu"))
        on_card = dev.type == "cuda"
        self.router.put_static_info({
            "session_id": self.session_id,
            "worker_id": self.worker_id,
            "timestamp": time.time(),
            "hostname": socket.gethostname(),
            "backend": dev.type,
            "device_count": torch.cuda.device_count() if on_card else 1,
            "device_kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
            "model_class": type(model).__name__,
            "num_params": int(model.num_params()),
            "layer_names": list(getattr(model, "layer_names", ())) or
            list(model.params.keys()),
            "model_graph": self._model_graph(model),
        })
        self._static_sent = True

    @staticmethod
    def _model_graph(model) -> List[dict]:
        """Network DAG for the dashboard's Model tab: one node per layer
        or vertex with its inputs (MLN = a chain; CG = the real DAG)."""
        def count(tree):
            return int(sum(l.numel() for l in tree_leaves(tree)))

        params = model.params
        nodes: List[dict] = []
        if hasattr(model, "layers"):           # MultiLayerNetwork
            prev = "input"
            for layer in model.layers:
                nodes.append({
                    "name": layer.name,
                    "type": type(layer).__name__,
                    "inputs": [prev],
                    "n_params": count(params.get(layer.name, {})),
                })
                prev = layer.name
        elif hasattr(model, "_nodes"):         # ComputationGraph
            for name in model._topo:
                node = model._nodes.get(name)
                if node is None:               # a network input
                    nodes.append({"name": name, "type": "Input",
                                  "inputs": [], "n_params": 0})
                    continue
                kind = (type(node.layer).__name__ if node.layer is not None
                        else type(node.vertex).__name__)
                nodes.append({
                    "name": name,
                    "type": kind,
                    "inputs": list(node.inputs),
                    "n_params": count(params.get(name, {})),
                })
        return nodes

    def _stats_from_telemetry(self, tel) -> Optional[Dict[str, dict]]:
        """param/update/grad stats rebuilt from the device-computed
        histograms the collector last flushed, or None when the ring has
        no histograms (collector not histogram-enabled, or nothing
        flushed yet). Moment estimates come from bin centers — a
        bounded-error approximation that is ample for dashboard charts
        and costs zero device transfers."""
        hist = getattr(tel, "last_histograms", lambda: None)()
        if not hist:
            return None
        kinds: Dict[str, Dict[str, dict]] = {
            "param": {}, "update": {}, "grad": {}}
        for lname, by_kind in hist.get("layers", {}).items():
            for kind, h in by_kind.items():
                if kind not in kinds:
                    continue
                counts = np.asarray(h.get("counts", ()), np.float64)
                total = counts.sum()
                if counts.size == 0 or total <= 0:
                    continue
                lo, hi = float(h["min"]), float(h["max"])
                centers = lo + (np.arange(counts.size) + 0.5) \
                    * (hi - lo) / counts.size
                mean = float((counts * centers).sum() / total)
                var = float((counts * (centers - mean) ** 2).sum()
                            / total)
                kinds[kind][lname] = {
                    "mean_magnitude": float(
                        (counts * np.abs(centers)).sum() / total),
                    "stdev": float(np.sqrt(max(var, 0.0))),
                    "histogram": {"counts": counts.tolist(),
                                  "min": lo, "max": hi},
                }
        return kinds if kinds["param"] else None

    def _layer_stats(self, params) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for lname, tree in params.items():
            leaves = tree_leaves(tree)
            if not leaves:
                continue
            flat = np.concatenate([np.asarray(l, np.float64).ravel()
                                   for l in leaves])
            out[lname] = {
                "mean_magnitude": float(np.mean(np.abs(flat))),
                "stdev": float(np.std(flat)),
                "histogram": _histogram(flat, self.histogram_bins),
            }
        return out

    def _update_stats(self, prev, cur) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for lname, tree in cur.items():
            pl = tree_leaves(prev.get(lname, {}))
            cl = tree_leaves(tree)
            if not cl or len(pl) != len(cl):
                continue
            diffs = np.concatenate([
                (np.asarray(c, np.float64) - np.asarray(p, np.float64))
                .ravel() for p, c in zip(pl, cl)])
            out[lname] = {
                "mean_magnitude": float(np.mean(np.abs(diffs))),
                "histogram": _histogram(diffs, self.histogram_bins),
            }
        return out

    @staticmethod
    def _memory_stats(model=None) -> dict:
        """The caching allocator's bytes in use and peak on the model's
        card, beside the card's memory size (no sync); {} on the CPU."""
        dev = torch.device(getattr(model, "device", "cpu"))
        if dev.type != "cuda":
            return {}
        try:
            stats = torch.cuda.memory_stats(dev)
            return {"bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "peak_bytes_in_use": stats.get(
                        "allocated_bytes.all.peak"),
                    "bytes_limit": torch.cuda.get_device_properties(
                        dev).total_memory}
        except Exception:
            return {}
