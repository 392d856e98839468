"""Training listeners.

The port of the JAX package's ``optimize/listeners.py``: analogs of the
reference's listener SPI (deeplearning4j-nn/.../optimize/api/
TrainingListener.java) and stock impls (optimize/listeners/):
ScoreIterationListener, PerformanceListener (samples/sec, batches/sec, ETL ms
— PerformanceListener.java:99-112), CollectScoresIterationListener,
TimeIterationListener, EvaluativeListener, CheckpointListener
(listeners/checkpoint/CheckpointListener.java:72).

Listeners run on the host, after a step is launched; reading the loss
(``float(loss)``) waits for the card, so score-reporting listeners honor
a ``frequency`` to avoid stalling the card every iteration.

When the model carries an ``observe.TelemetryCollector``
(``model.set_telemetry``), score-reporting listeners consume the
host-side values the collector flushed from the on-device ring buffer —
zero extra syncs, values lagging at most one flush interval — and only
fall back to ``float(loss)`` (a sync) on unmonitored models.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.observe.tracer import get_tracer

log = logging.getLogger(__name__)


def _telemetry_score(model, loss):
    """(score, available): the collector's last flushed loss when one is
    attached (never syncs; unavailable until the first flush), else
    ``float(loss)`` — a sync, paid by unmonitored models only."""
    tel = getattr(model, "telemetry", None)
    if tel is not None:
        return tel.last("loss"), tel.last_record() is not None
    return float(loss), True


class TrainingListener:
    def on_epoch_start(self, model, epoch: int):
        pass

    def on_epoch_end(self, model, epoch: int):
        pass

    def iteration_done(self, model, iteration: int, epoch: int,
                       loss, etl_ms: float, batch_size: int):
        pass

    def on_crash_dump(self, model, path: str, reason: str):
        """Fired by the flight recorder (observe/flight_recorder.py) right
        after a post-mortem dump directory is written — ``reason`` is one
        of ``nonfinite`` / ``oom`` / ``exception``. Default: no-op."""
        pass


class ScoreIterationListener(TrainingListener):
    """Logs the loss every N iterations (reference: ScoreIterationListener)."""

    def __init__(self, frequency: int = 10):
        self.frequency = max(1, frequency)
        self.scores: List[float] = []

    def iteration_done(self, model, iteration, epoch, loss, etl_ms, batch_size):
        if iteration % self.frequency == 0:
            score, ok = _telemetry_score(model, loss)
            if not ok:
                return  # monitored model, nothing flushed yet: no sync
            self.scores.append(score)
            log.info("Score at iteration %d is %.6f", iteration, score)


class PerformanceListener(TrainingListener):
    """Throughput reporting: samples/sec, batches/sec, ETL ms — the metric
    definitions come from the reference (PerformanceListener.java:99-112)
    and feed BENCH results."""

    def __init__(self, frequency: int = 1, report_score: bool = False):
        self.frequency = max(1, frequency)
        self.report_score = report_score
        self._last_time: Optional[float] = None
        self._last_iter: Optional[int] = None
        self._samples = 0
        # ETL accumulates over the whole reporting window: reporting only
        # the last iteration's ETL hid stalls on the skipped iterations
        self._etl_sum = 0.0
        self._etl_n = 0
        self.history: List[dict] = []

    def on_epoch_start(self, model, epoch: int):
        # seed the clock BEFORE the first batch runs, so its samples and
        # wall time both count (previously the first batch only set the
        # baseline and its samples were silently dropped)
        if self._last_time is None:
            self._last_time = time.perf_counter()

    def iteration_done(self, model, iteration, epoch, loss, etl_ms, batch_size):
        self._samples += batch_size
        self._etl_sum += float(etl_ms)
        self._etl_n += 1
        now = time.perf_counter()
        if self._last_iter is None:
            # attribute exactly this one batch to the window; without an
            # on_epoch_start seed (direct calls) fall back to `now` —
            # that window is empty and reports on the next iteration
            self._last_iter = iteration - 1
            if self._last_time is None:
                self._last_time = now
                self._samples = 0
                self._etl_sum = 0.0
                self._etl_n = 0
        if iteration % self.frequency == 0 and iteration > self._last_iter:
            dt = now - self._last_time
            if dt <= 0:
                return
            batches = iteration - self._last_iter
            rec = {
                "iteration": iteration,
                "samples_per_sec": self._samples / dt,
                "batches_per_sec": batches / dt,
                # mean over the window, not the last iteration's value
                "etl_ms": self._etl_sum / max(1, self._etl_n),
            }
            if self.report_score:
                score, ok = _telemetry_score(model, loss)
                if ok:
                    rec["score"] = score
            self.history.append(rec)
            log.info("iter %d: %.1f samples/sec, %.2f batches/sec, ETL %.2f ms",
                     iteration, rec["samples_per_sec"], rec["batches_per_sec"],
                     rec["etl_ms"])
            self._last_time = now
            self._last_iter = iteration
            self._samples = 0
            self._etl_sum = 0.0
            self._etl_n = 0


class CollectScoresIterationListener(TrainingListener):
    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, epoch, loss, etl_ms, batch_size):
        if iteration % self.frequency == 0:
            score, ok = _telemetry_score(model, loss)
            if ok:
                self.scores.append((iteration, score))


class TimeIterationListener(TrainingListener):
    """ETA logging (reference: TimeIterationListener)."""

    def __init__(self, total_iterations: int, frequency: int = 10):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self._start = None

    def iteration_done(self, model, iteration, epoch, loss, etl_ms, batch_size):
        if self._start is None:
            self._start = time.perf_counter()
            return
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self._start
            rate = iteration / elapsed
            remaining = (self.total - iteration) / max(rate, 1e-9)
            log.info("iteration %d/%d, ETA %.1fs", iteration, self.total,
                     remaining)


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator (reference:
    EvaluativeListener)."""

    def __init__(self, iterator, frequency_epochs: int = 1):
        self.iterator = iterator
        self.frequency = max(1, frequency_epochs)
        self.evaluations: List = []

    def on_epoch_end(self, model, epoch):
        if epoch % self.frequency == 0:
            with get_tracer(model).span("eval", cat="eval", epoch=epoch):
                e = model.evaluate(self.iterator)
            self.evaluations.append((epoch, e))
            log.info("epoch %d eval: accuracy=%.4f", epoch, e.accuracy())


class CheckpointListener(TrainingListener):
    """Periodic checkpoints with retention (reference: CheckpointListener
    — every N epochs/iterations, keepLast semantics). Each checkpoint is
    the port's model zip with its updater state
    (models/serialization.save_model), which the JAX package's
    ``restore_*`` reads too."""

    def __init__(self, directory: str, every_n_epochs: Optional[int] = None,
                 every_n_iterations: Optional[int] = None, keep_last: int = 3):
        self.dir = directory
        self.every_n_epochs = every_n_epochs
        self.every_n_iterations = every_n_iterations
        self.keep_last = keep_last
        self._saved: List[str] = []
        os.makedirs(directory, exist_ok=True)

    def _save(self, model, tag: str):
        from deeplearning4j_tpu_torch.models.serialization import \
            save_model
        path = os.path.join(self.dir, f"checkpoint_{tag}.zip")
        with get_tracer(model).span("checkpoint", cat="io", tag=tag):
            save_model(model, path, save_updater=True)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass

    def iteration_done(self, model, iteration, epoch, loss, etl_ms, batch_size):
        if (self.every_n_iterations and iteration > 0
                and iteration % self.every_n_iterations == 0):
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model, epoch):
        if self.every_n_epochs and (epoch + 1) % self.every_n_epochs == 0:
            self._save(model, f"epoch_{epoch}")


class SleepyTrainingListener(TrainingListener):
    """Sleeps for a configured time at training phases — a throttle for
    debugging/profiling or resource-sharing runs (reference:
    optimize/listeners/SleepyTrainingListener.java).

    ``time_mode="additive"`` always sleeps the full timer;
    ``"connected"`` subtracts the elapsed wall time since the phase last
    fired, sleeping only up to the target period (the reference's
    TimeMode.CONNECTED). The reference's SleepMode (park vs busy-spin) is
    a JVM-scheduler concern with no Python analog — time.sleep is used.
    """

    def __init__(self, timer_epoch_start_ms: float = 0.0,
                 timer_epoch_end_ms: float = 0.0,
                 timer_iteration_ms: float = 0.0,
                 time_mode: str = "additive"):
        if time_mode not in ("additive", "connected"):
            raise ValueError(f"unknown time_mode: {time_mode}")
        self.timer_es = timer_epoch_start_ms
        self.timer_ee = timer_epoch_end_ms
        self.timer_it = timer_iteration_ms
        self.time_mode = time_mode
        self._last = {}

    def _sleep(self, phase: str, timer_ms: float):
        if timer_ms <= 0:
            return
        if self.time_mode == "connected":
            last = self._last.get(phase)
            if last is not None:
                timer_ms -= (time.perf_counter() - last) * 1000.0
        if timer_ms >= 1.0:
            time.sleep(timer_ms / 1000.0)
        # record AFTER sleeping: the next period starts when this phase
        # releases, else elapsed would include our own sleep and the
        # throttle would fire every other call at double rate
        self._last[phase] = time.perf_counter()

    def on_epoch_start(self, model, epoch):
        self._sleep("es", self.timer_es)

    def on_epoch_end(self, model, epoch):
        self._sleep("ee", self.timer_ee)

    def iteration_done(self, model, iteration, epoch, loss, etl_ms,
                       batch_size):
        self._sleep("it", self.timer_it)


class ParamAndGradientIterationListener(TrainingListener):
    """Text-format per-iteration parameter/update statistics — the UI
    histogram information for SSH-only sessions (reference:
    optimize/listeners/ParamAndGradientIterationListener.java: mean,
    min/max and mean-absolute-value of each parameter and gradient,
    tab-delimited to console and/or file).

    "Gradient" here is the applied update (param delta between
    iterations): the functional train step consumes the raw gradients,
    so the observable quantity is the update — the convention of
    ui/stats.py's update statistics, and it includes the updater's
    transform. The parameters come to the host (a sync) only on the
    iterations that report or snapshot.
    """

    def __init__(self, iterations: int = 1, print_header: bool = True,
                 print_mean: bool = True, print_min_max: bool = True,
                 print_mean_abs_value: bool = True,
                 output_to_console: bool = True, file: str = None,
                 delimiter: str = "\t"):
        self.iterations = max(1, iterations)
        self.print_header = print_header
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.print_mean_abs = print_mean_abs_value
        self.output_to_console = output_to_console
        self.file = file
        self.delimiter = delimiter
        self._total = 0
        self._prev = None
        self._header_done = False
        if file:
            with open(file, "w"):
                pass

    @staticmethod
    def _flat(params):
        """(dotted path, host array) of every leaf, in the JAX package's
        order (its tree flattening sorts dict keys)."""
        out = []

        def walk(tree, prefix):
            for k in sorted(tree):
                v = tree[k]
                name = f"{prefix}.{k}" if prefix else str(k)
                if isinstance(v, dict):
                    walk(v, name)
                else:
                    out.append((name, v.detach().float().cpu().numpy()
                                if v.is_floating_point()
                                else v.detach().cpu().numpy()))
        walk(params, "")
        return out

    def _stats(self, arr):
        vals = []
        if self.print_mean:
            vals.append(float(arr.mean()))
        if self.print_min_max:
            vals.extend([float(arr.min()), float(arr.max())])
        if self.print_mean_abs:
            vals.append(float(np.abs(arr).mean()))
        return vals

    def _emit(self, line: str):
        if self.output_to_console:
            print(line)
        if self.file:
            try:
                with open(self.file, "a") as f:
                    f.write(line + "\n")
            except OSError:
                log.warning("ParamAndGradientIterationListener: write to "
                            "%s failed", self.file)

    def iteration_done(self, model, iteration, epoch, loss, etl_ms,
                       batch_size):
        self._total += 1
        report = self._total % self.iterations == 0
        # snapshot right before a reporting iteration, so the update
        # column is a single-step delta
        snapshot = (self.iterations > 1
                    and self._total % self.iterations
                    == self.iterations - 1)
        if not (report or snapshot):
            return          # no device→host param transfer on idle steps
        params = self._flat(model.params)
        if snapshot:
            self._prev = {n: a.copy() for n, a in params}
            return
        if self.print_header and not self._header_done:
            self._header_done = True
            cols = ["iteration", "score"]
            stat_names = ((["mean"] if self.print_mean else [])
                          + (["min", "max"] if self.print_min_max else [])
                          + (["meanAbs"] if self.print_mean_abs else []))
            for name, _ in params:
                cols += [f"param_{name}_{s}" for s in stat_names]
                cols += [f"update_{name}_{s}" for s in stat_names]
            self._emit(self.delimiter.join(cols))
        vals = [str(self._total), f"{float(loss):.6g}"]
        prev = self._prev or {}
        for name, arr in params:
            vals += [f"{v:.6g}" for v in self._stats(arr)]
            upd = arr - prev[name] if name in prev else np.zeros_like(arr)
            vals += [f"{v:.6g}" for v in self._stats(upd)]
        self._emit(self.delimiter.join(vals))
        self._prev = {n: a.copy() for n, a in params}
