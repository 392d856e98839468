"""Cluster-scale training: the training masters and the collective
watchdog.

The port of the JAX package's ``parallel/cluster.py`` (reference: the
Spark layer, dl4j-spark/.../api/TrainingMaster.java:28). Every process
joins one ``torch.distributed`` group (parallel/mesh.py) and the
masters are strategy objects over ``ParallelWrapper``:

- ``ParameterAveragingTrainingMaster`` (ParameterAveragingTrainingMaster
  .java:62): ``averaging_frequency`` local steps per worker, then the
  parameters and updater state averaged (the wrapper's AVERAGING);
  ``aggregation_depth`` is kept for configuration parity.
- ``SharedTrainingMaster`` (SharedTrainingMaster.java:57): a gradient
  all-reduce every step (SHARED_GRADIENTS); its threshold knobs configure
  the optional codec of parallel/compression.py.
- ``TrainingStats`` (collectTrainingStats): timed phase events with a
  JSON and HTML timeline export (StatsUtils.java).
- ``DistributedNetwork`` (SparkDl4jMultiLayer / SparkComputationGraph):
  fit through the master; ``evaluate`` runs the replicated network on
  this rank over every batch.
- ``CollectiveWatchdog``: heartbeat files, an in-flight window around
  each collective, and the dead-versus-slow classification
  (``classify_heartbeat_age``, the boundary the serving ``NodeRegistry``
  of parallel/node.py reads gossip through too). The clock and the sleep
  are injectable, so its classification is tested without wall-time
  margins.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSetIterator
from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation
from deeplearning4j_tpu_torch.parallel import mesh
from deeplearning4j_tpu_torch.parallel.compression import ThresholdSchedule
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, create_mesh


# ---- training stats and timeline ---------------------------------------------

@dataclass
class EventStats:
    """One timed phase event (dl4j-spark/.../stats/BaseEventStats.java)."""
    name: str
    start_ms: float
    duration_ms: float
    worker: int = 0


class TrainingStats:
    def __init__(self):
        self.events: List[EventStats] = []
        self._t0 = time.perf_counter()

    @contextmanager
    def time(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            now = time.perf_counter()
            self.events.append(EventStats(
                name, (start - self._t0) * 1000, (now - start) * 1000,
                mesh.rank()))

    def as_json(self) -> str:
        return json.dumps([e.__dict__ for e in self.events])

    def export_timeline_html(self, path: str):
        """Minimal HTML timeline (StatsUtils.exportStatsAsHtml)."""
        rows = []
        total = max((e.start_ms + e.duration_ms for e in self.events),
                    default=1.0)
        for e in self.events:
            left = 100.0 * e.start_ms / total
            width = max(0.2, 100.0 * e.duration_ms / total)
            rows.append(
                f'<div class="row"><span class="lbl">{e.name}'
                f' ({e.duration_ms:.1f} ms)</span>'
                f'<div class="bar" style="margin-left:{left:.2f}%;'
                f'width:{width:.2f}%"></div></div>')
        html = ("<html><head><style>.row{margin:2px;font:12px monospace}"
                ".bar{background:#4a90d9;height:10px;display:inline-block}"
                ".lbl{display:inline-block;width:340px}</style></head>"
                "<body><h3>Training timeline</h3>" + "".join(rows)
                + "</body></html>")
        with open(path, "w") as f:
            f.write(html)


# ---- the TrainingMaster SPI -------------------------------------------------

class TrainingMaster:
    """Strategy object owning the distributed fit loop
    (dl4j-spark/.../api/TrainingMaster.java:28). ``workers`` must be the
    process group's size (each rank is one worker)."""

    def __init__(self, workers: Optional[int] = None,
                 batch_size_per_worker: int = 16,
                 collect_training_stats: bool = False,
                 mesh=None):
        self.batch_size_per_worker = batch_size_per_worker
        self.mesh = mesh if mesh is not None else (
            create_mesh({DATA_AXIS: workers}) if workers
            else create_mesh())
        self.stats: Optional[TrainingStats] = (
            TrainingStats() if collect_training_stats else None)

    @property
    def num_workers(self) -> int:
        return int(self.mesh.shape[DATA_AXIS])

    def execute_training(self, net, iterator: DataSetIterator,
                         epochs: int = 1):
        raise NotImplementedError

    def delete_temp_files(self):
        """No export staging to clean (TrainingMaster.deleteTempFiles)."""

    def _run(self, wrapper, label, iterator, epochs):
        if self.stats is not None:
            with self.stats.time(label):
                wrapper.fit(iterator, epochs)
        else:
            wrapper.fit(iterator, epochs)


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous parameter averaging, the wrapper's AVERAGING: each
    worker fits ``averaging_frequency`` minibatches, then the parameters
    and updater state are averaged (ParameterAveragingTrainingMaster
    .java:287-298). ``aggregation_depth`` and ``repartition_strategy``
    are kept for configuration parity and change nothing."""

    def __init__(self, averaging_frequency: int = 5,
                 aggregation_depth: int = 2,
                 average_updaters: bool = True,
                 repartition_strategy: str = "balanced",
                 **kw):
        super().__init__(**kw)
        self.averaging_frequency = averaging_frequency
        self.aggregation_depth = aggregation_depth
        self.average_updaters = average_updaters
        self.repartition_strategy = repartition_strategy

    class Builder:
        def __init__(self, batch_size_per_worker: int = 16):
            self._kw = {"batch_size_per_worker": batch_size_per_worker}
            self._avg_freq = 5
            self._agg_depth = 2

        def averaging_frequency(self, k):
            self._avg_freq = k
            return self

        def aggregation_depth(self, d):
            self._agg_depth = d
            return self

        def workers(self, n):
            self._kw["workers"] = n
            return self

        def collect_training_stats(self, flag: bool):
            self._kw["collect_training_stats"] = flag
            return self

        def build(self):
            return ParameterAveragingTrainingMaster(
                averaging_frequency=self._avg_freq,
                aggregation_depth=self._agg_depth, **self._kw)

    def execute_training(self, net, iterator, epochs: int = 1):
        from deeplearning4j_tpu_torch.parallel.wrapper import (
            ParallelWrapper, TrainingMode)
        wrapper = ParallelWrapper(
            net, mesh=self.mesh, mode=TrainingMode.AVERAGING,
            averaging_frequency=self.averaging_frequency,
            average_updaters=self.average_updaters)
        self._run(wrapper, "ParameterAveragingMaster fit", iterator, epochs)
        return net


class SharedTrainingMaster(TrainingMaster):
    """Gradient sharing as a synchronous all-reduce every step (the
    wrapper's SHARED_GRADIENTS). The threshold-schedule knobs
    (SharedTrainingMaster.java:72-107) are kept and configure the
    optional codec (compression.EncodedGradientsAccumulator)."""

    def __init__(self, threshold: float = 1e-3, min_threshold: float = 1e-5,
                 threshold_step: float = 2.0, step_trigger: float = 0.05,
                 step_delay: int = 50, shake_frequency: int = 0, **kw):
        super().__init__(**kw)
        self.threshold_schedule = ThresholdSchedule(
            threshold=threshold, min_threshold=min_threshold,
            threshold_step=threshold_step, step_trigger=step_trigger,
            step_delay=step_delay, shake_frequency=shake_frequency)

    class Builder:
        def __init__(self, threshold: float = 1e-3):
            self._kw = {"threshold": threshold}

        def min_threshold(self, v):
            self._kw["min_threshold"] = v
            return self

        def threshold_step(self, v):
            self._kw["threshold_step"] = v
            return self

        def shake_frequency(self, v):
            self._kw["shake_frequency"] = v
            return self

        def workers(self, n):
            self._kw["workers"] = n
            return self

        def batch_size_per_worker(self, n):
            self._kw["batch_size_per_worker"] = n
            return self

        def collect_training_stats(self, flag: bool):
            self._kw["collect_training_stats"] = flag
            return self

        def build(self):
            return SharedTrainingMaster(**self._kw)

    def execute_training(self, net, iterator, epochs: int = 1):
        from deeplearning4j_tpu_torch.parallel.wrapper import (
            ParallelWrapper, TrainingMode)
        wrapper = ParallelWrapper(
            net, mesh=self.mesh, mode=TrainingMode.SHARED_GRADIENTS)
        self._run(wrapper, "SharedTrainingMaster fit", iterator, epochs)
        return net


class DistributedNetwork:
    """(network, TrainingMaster): the SparkDl4jMultiLayer /
    SparkComputationGraph surface (SparkDl4jMultiLayer.java:71)."""

    def __init__(self, network, training_master: TrainingMaster):
        self.network = network
        self.training_master = training_master
        if network.params is None:
            network.init()

    def fit(self, iterator: DataSetIterator, epochs: int = 1):
        return self.training_master.execute_training(
            self.network, iterator, epochs)

    def evaluate(self, iterator: DataSetIterator,
                 num_classes: Optional[int] = None) -> Evaluation:
        """Evaluation of the replicated network over every batch, in this
        rank (the same result in every rank)."""
        return self.network.evaluate(iterator, Evaluation(num_classes))

    def get_network(self):
        return self.network

    @property
    def stats(self) -> Optional[TrainingStats]:
        return self.training_master.stats


# the reference's entry-point names
SparkDl4jMultiLayer = DistributedNetwork
SparkComputationGraph = DistributedNetwork


# ---- collective failure detection (heartbeat watchdog) -----------------------

#: Exit status of a worker that abandons a hung collective after it found
#: a dead peer: the relauncher tells "peer died, resume me" from "I am
#: the bug".
PEER_LOSS_EXIT_CODE = 43

#: Marker file the watchdog drops next to the checkpoints on peer loss.
PEER_LOSS_MARKER = "PEER_LOSS.json"


def classify_heartbeat_age(age: Optional[float], dead_after_s: float,
                           slow_after_s: Optional[float] = None) -> str:
    """Classify a heartbeat's age: ``"alive"`` | ``"slow"`` | ``"dead"``.

    - ``age is None`` (file never appeared / unreadable) -> ``"dead"``;
    - ``age``  > ``dead_after_s``  (strictly past)        -> ``"dead"``;
    - ``age`` >= ``slow_after_s``  (at or past)           -> ``"slow"``;
    - otherwise                                           -> ``"alive"``.

    A heartbeat EXACTLY at a threshold is always given the less severe
    class: exactly at ``dead_after_s`` is slow, not dead — a beat is a
    point-in-time sample, so "age == horizon" means the peer beat
    exactly one horizon ago and may be about to beat again; only
    strictly-past evidence may kill it. ``slow_after_s`` defaults to
    ``dead_after_s`` (the single-threshold watchdog case).
    """
    if age is None or age > dead_after_s:
        return "dead"
    if age >= (dead_after_s if slow_after_s is None else slow_after_s):
        return "slow"
    return "alive"


class CollectiveWatchdog:
    """Heartbeat/deadline watchdog around the collective path.

    A collective whose peer died mid-all-reduce blocks the survivors until
    the process group's ``timeout`` (or a transport-level error) ends it,
    minutes later by default. The reference stack sidesteps this with
    Aeron session keepalives (PAPER.md §1 L5); here each process writes
    a small heartbeat file (``hb_{rank}.json``: rank, wall time, host
    iteration) to a shared directory every ``interval_s``, and a monitor
    thread watches any collective the caller marks in-flight via
    :meth:`guard`.

    Classification — the whole point is telling a *dead* peer from a
    *slow* one:

    - in-flight past ``deadline_s`` AND some peer's heartbeat is older
      than ``dead_after_s`` (or its file never appeared) -> **peer
      loss**: best-effort emergency checkpoint
      (:func:`~deeplearning4j_tpu_torch.parallel.checkpoint.save_sharded`
      with ``emergency=True`` — barrier-free, the dead peer can never
      join a barrier again), a flight-recorder dump with reason
      ``peer_loss`` (dead ranks + heartbeat ages in ``context.json``),
      a resumable ``PEER_LOSS.json`` marker next to the checkpoints,
      then ``os._exit(PEER_LOSS_EXIT_CODE)`` (unless
      ``exit_on_loss=False``).
    - in-flight past ``deadline_s`` but every peer is still beating ->
      **straggler**: warn once, bump
      ``dl4j_elastic_straggler_waits_total``, extend the deadline and
      keep waiting — killing a job because one host hit a GC pause is
      the failure mode this class exists to avoid.

    The same classifier is exposed as :meth:`on_collective_error` for
    transports that *do* raise (gloo, when a peer's socket closes): the
    training loop's except-path calls it to decide whether an exception is
    peer loss (handled: marker + dump + emergency save, returns True)
    or the caller's own bug (returns False).
    """

    def __init__(self, heartbeat_dir: str, *,
                 rank: Optional[int] = None,
                 n_ranks: Optional[int] = None,
                 interval_s: float = 0.25,
                 deadline_s: float = 60.0,
                 dead_after_s: float = 2.0,
                 model=None,
                 checkpoint_dir: Optional[str] = None,
                 on_peer_loss: Optional[Callable[[Dict], None]] = None,
                 exit_on_loss: bool = True,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep):
        self.heartbeat_dir = heartbeat_dir
        self.rank = mesh.rank() if rank is None else int(rank)
        self.n_ranks = (mesh.world_size() if n_ranks is None
                        else int(n_ranks))
        self.interval_s = float(interval_s)
        self.deadline_s = float(deadline_s)
        self.dead_after_s = float(dead_after_s)
        self.clock = clock
        self.sleep = sleep
        self.model = model
        self.checkpoint_dir = checkpoint_dir
        self.on_peer_loss = on_peer_loss
        self.exit_on_loss = exit_on_loss
        self.iteration = 0          # mirrored into the heartbeat file
        self.straggler_waits = 0
        self.peer_loss_event: Optional[Dict] = None
        self._inflight_since: Optional[float] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._beat_thread: Optional[threading.Thread] = None
        self._mon_thread: Optional[threading.Thread] = None
        self._warned_straggler = False
        os.makedirs(heartbeat_dir, exist_ok=True)

    # ---- lifecycle ------------------------------------------------------
    def start(self) -> "CollectiveWatchdog":
        if self._beat_thread is not None:
            return self
        self._stop.clear()
        self._beat()                # first beat before anyone waits on us
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name="dl4j-heartbeat", daemon=True)
        self._mon_thread = threading.Thread(
            target=self._monitor_loop, name="dl4j-collective-watchdog",
            daemon=True)
        self._beat_thread.start()
        self._mon_thread.start()
        return self

    def stop(self):
        self._stop.set()
        for t in (self._beat_thread, self._mon_thread):
            if t is not None:
                t.join(timeout=5 * self.interval_s + 1.0)
        self._beat_thread = self._mon_thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()

    # ---- heartbeat writer ----------------------------------------------
    def _beat_path(self, rank: int) -> str:
        return os.path.join(self.heartbeat_dir, f"hb_{rank}.json")

    def _beat(self):
        payload = json.dumps({"rank": self.rank, "time": self.clock(),
                              "iteration": self.iteration})
        try:
            fd, tmp = tempfile.mkstemp(dir=self.heartbeat_dir,
                                       prefix=f".hb_{self.rank}_")
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self._beat_path(self.rank))  # atomic
        except OSError:
            pass            # a full/slow disk must not kill the beat

    def _beat_loop(self):
        while not self._stop.wait(self.interval_s):
            self._beat()

    # ---- in-flight window ----------------------------------------------
    @contextmanager
    def guard(self, iteration: Optional[int] = None):
        """Mark a blocking collective in-flight; the monitor thread only
        arms while inside this window, so host-side work (ETL, logging)
        can take arbitrarily long without tripping the deadline."""
        if iteration is not None:
            self.iteration = int(iteration)
        with self._lock:
            self._inflight_since = self.clock()
            self._warned_straggler = False
        try:
            yield
        finally:
            with self._lock:
                self._inflight_since = None

    # ---- peer classification -------------------------------------------
    def _peer_ages(self) -> Dict[int, Optional[float]]:
        """Age of each peer's last heartbeat in seconds; None when the
        file never appeared (process died before its first beat, or a
        misconfigured heartbeat_dir)."""
        now = self.clock()
        ages: Dict[int, Optional[float]] = {}
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            try:
                with open(self._beat_path(r)) as f:
                    ages[r] = now - float(json.load(f)["time"])
            except (OSError, ValueError, KeyError):
                ages[r] = None
        return ages

    def dead_peers(self) -> Dict[int, Optional[float]]:
        """Peers whose heartbeat is stale STRICTLY past ``dead_after_s``
        (or missing entirely) — :func:`classify_heartbeat_age` owns the
        boundary; exactly-at-threshold is slow, not dead."""
        return {r: age for r, age in self._peer_ages().items()
                if classify_heartbeat_age(age, self.dead_after_s)
                == "dead"}

    # ---- monitor --------------------------------------------------------
    def _monitor_loop(self):
        while not self._stop.wait(self.interval_s):
            with self._lock:
                since = self._inflight_since
            if since is None:
                continue
            waited = self.clock() - since
            # A peer whose heartbeat WAS present and has gone stale is
            # conclusively dead — classify after a couple of beats
            # in-flight instead of waiting out the straggler deadline.
            # A transport error or the group's timeout races us here, so
            # late classification can mean no forensics at all. Peers with
            # NO heartbeat file keep the full deadline: that can be a
            # slow start, not a death.
            if waited >= 2 * self.interval_s:
                dead = {r: a for r, a in self.dead_peers().items()
                        if a is not None}
                if dead:
                    self._handle_peer_loss(dead)
                    return          # never reached when exit_on_loss
            if waited < self.deadline_s:
                continue
            dead = self.dead_peers()
            if dead:
                self._handle_peer_loss(dead)
                return              # never reached when exit_on_loss
            # Everyone is alive -> straggler. Extend the window rather
            # than spinning a warning per poll tick.
            with self._lock:
                self.straggler_waits += 1
                self._inflight_since = self.clock()
                warn = not self._warned_straggler
                self._warned_straggler = True
            self._bump_counter("dl4j_elastic_straggler_waits_total")
            if warn:
                print(f"[rank {self.rank}] collective watchdog: "
                      f"collective in-flight > {self.deadline_s:.1f}s "
                      "but all peers are beating — straggler, "
                      "extending deadline", flush=True)

    # ---- peer-loss handling --------------------------------------------
    def _handle_peer_loss(self, dead: Dict[int, Optional[float]],
                          exc: Optional[BaseException] = None,
                          exit_ok: bool = True):
        event = {
            "reason": "peer_loss",
            "rank": self.rank,
            "n_ranks": self.n_ranks,
            "iteration": self.iteration,
            "dead_ranks": sorted(dead),
            "heartbeat_age_s": {str(r): a for r, a in dead.items()},
            "time": self.clock(),
        }
        self.peer_loss_event = event
        self._bump_counter("dl4j_elastic_peer_loss_total")
        ckpt = self._emergency_checkpoint()
        if ckpt is not None:
            event["emergency_checkpoint"] = ckpt
        event["resume_from"] = self._latest_committed()
        self._write_marker(event)
        self._record_dump(event, exc)
        if self.on_peer_loss is not None:
            try:
                self.on_peer_loss(event)
            except Exception:
                pass        # a hook bug must not mask the peer loss
        will_exit = exit_ok and self.exit_on_loss
        print(f"[rank {self.rank}] collective watchdog: peer(s) "
              f"{sorted(dead)} lost (heartbeat stale) — emergency "
              f"checkpoint {'written to ' + ckpt if ckpt else 'skipped'}"
              + (f", exiting {PEER_LOSS_EXIT_CODE}" if will_exit
                 else ""), flush=True)
        if will_exit:
            os._exit(PEER_LOSS_EXIT_CODE)

    def _emergency_checkpoint(self) -> Optional[str]:
        if self.checkpoint_dir is None or self.model is None:
            return None
        ts = getattr(self.model, "train_state", None)
        if ts is None:
            return None
        try:
            from deeplearning4j_tpu_torch.parallel.checkpoint import \
                save_sharded
            return save_sharded(ts, self.checkpoint_dir, emergency=True)
        except BaseException:
            return None     # best-effort: state may be poisoned

    def _latest_committed(self) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        try:
            from deeplearning4j_tpu_torch.parallel.checkpoint import \
                latest_checkpoint
            return latest_checkpoint(self.checkpoint_dir)
        except Exception:
            return None

    def _write_marker(self, event: Dict):
        where = self.checkpoint_dir or self.heartbeat_dir
        try:
            os.makedirs(where, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=where, prefix=".peer_loss_")
            with os.fdopen(fd, "w") as f:
                json.dump(event, f, indent=1)
            os.replace(tmp, os.path.join(
                where, f"{PEER_LOSS_MARKER}.{self.rank}"))
        except OSError:
            pass

    def _record_dump(self, event: Dict,
                     exc: Optional[BaseException] = None):
        try:
            rec = None
            if self.model is not None and \
                    hasattr(self.model, "_recorder"):
                rec = self.model._recorder()
            if rec is None:
                from deeplearning4j_tpu_torch.observe.flight_recorder \
                    import default_flight_recorder
                rec = default_flight_recorder()
            if rec is not None:
                rec.record_crash(self.model, reason="peer_loss",
                                 exc=exc, extra=event)
        except Exception:
            pass

    @staticmethod
    def _bump_counter(name: str):
        try:
            from deeplearning4j_tpu_torch.observe.registry import \
                default_registry
            default_registry().counter(
                name, "collective watchdog events").inc()
        except Exception:
            pass

    # ---- exception-path classifier -------------------------------------
    def on_collective_error(self, exc: BaseException) -> bool:
        """Classify an exception raised *out of* a collective (backends
        like gloo on CPU fail fast instead of hanging). Returns True —
        and runs the full peer-loss path (marker, dump, emergency save)
        WITHOUT exiting, so the caller controls its exit code — when a
        peer's heartbeat is stale; False when everyone is alive (the
        error is the caller's own bug and should propagate untouched).
        """
        # Give a just-died peer's heartbeat time to go stale: the
        # transport error typically races the dead_after_s horizon.
        horizon = self.clock() + self.dead_after_s + 2 * self.interval_s
        while True:
            dead = self.dead_peers()
            if dead:
                self._handle_peer_loss(dead, exc=exc, exit_ok=False)
                return True
            if self.clock() >= horizon:
                return False
            self.sleep(self.interval_s)
