"""OnlineLearner: incremental fit() over an unbounded sample stream.

The learner owns the TRAINING model and a background thread running
``model.fit(stream, epochs=1)`` — one "epoch" is the whole stream
subscription, ended by the stream's stop event. The normal fit pipeline
applies unchanged: AsyncDataSetIterator prefetch, DeviceFeeder staging,
listeners, flight recorder.

Candidate snapshots are the promotion gate's input, and the one place
where thread discipline bites: the train step updates the parameters
and the model state IN PLACE, on the learner thread's CUDA stream.
``snapshot()`` therefore never reads them from the calling thread while
training is live: it posts a request that the learner thread itself
services BETWEEN steps (a TrainingListener hook), after that thread's
stream has finished the step, copying params and state (for a bf16
model, the f32 master weights and the BN running statistics) to fresh
CPU tensors — ``.detach().to("cpu", copy=True)``, never views, as the
serving engine's ``committed_host`` copies. Only when the learner thread
is not running does ``snapshot()`` copy inline.
"""

from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.optimize.updaters import tree_map


class Candidate(NamedTuple):
    """One promotable parameter snapshot (CPU tensor copies)."""
    params: Any
    model_state: Any
    iteration: int
    samples_seen: int
    walltime: float


def _host_copy(tree, device):
    """Deep CPU copy of a param tree, taken after the current stream of
    ``device`` (the one the step ran on) has finished writing it."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _candidate(model, iteration: int, samples_seen: int) -> Candidate:
    return Candidate(params=_host_copy(model.params, model.device),
                     model_state=_host_copy(model.model_state, model.device),
                     iteration=iteration, samples_seen=samples_seen,
                     walltime=time.time())


class _SnapshotListener(TrainingListener):
    """Services snapshot requests on the learner thread, between
    dispatched steps — the only point where the in-place updated params
    are stable."""

    def __init__(self, learner: "OnlineLearner"):
        self.learner = learner

    def iteration_done(self, model, iteration, epoch, loss, etl_ms,
                       batch_size):
        lr = self.learner
        lr._iterations = iteration
        if not lr._snap_req.is_set():
            return
        lr._snap_result = _candidate(model, iteration,
                                     lr.stream.samples_consumed)
        lr._snap_req.clear()
        lr._snap_done.set()


class OnlineLearner:
    """Drives incremental training off a SampleStreamIterator."""

    def __init__(self, model, stream, *, prefetch: Optional[int] = None,
                 k_steps: Optional[int] = None):
        self.model = model
        self.stream = stream
        self.prefetch = prefetch
        self.k_steps = k_steps
        self._thread: Optional[threading.Thread] = None
        self._iterations = 0
        self.error: Optional[BaseException] = None
        # snapshot handshake: one request in flight at a time
        self._snap_lock = threading.Lock()
        self._snap_req = threading.Event()
        self._snap_done = threading.Event()
        self._snap_result: Optional[Candidate] = None
        model.add_listeners(_SnapshotListener(self))

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "OnlineLearner":
        if self._thread is not None:
            raise RuntimeError("OnlineLearner already started")

        def run():
            try:
                self.model.fit(self.stream, epochs=1,
                               prefetch=self.prefetch,
                               k_steps=self.k_steps)
            except BaseException as e:
                self.error = e
            finally:
                # a blocked snapshot() must not hang on a dead learner
                if self._snap_req.is_set():
                    self._snap_req.clear()
                    self._snap_done.set()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="online-learner")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0):
        """End the stream's subscription, and with it the fit and its
        feeder threads, within ``timeout``; raises the learner's error."""
        self.stream.stop()
        t = self._thread
        if t is not None:
            t.join(timeout)
        if self.error is not None:
            raise self.error

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def iterations(self) -> int:
        return self._iterations

    # ---- candidate snapshots --------------------------------------------
    def snapshot(self, timeout: float = 5.0) -> Optional[Candidate]:
        """CPU-copied candidate params, taken between train steps.

        Returns None when the learner is live but no step completed
        within ``timeout`` (idle stream — nothing new to promote
        anyway). Raises the learner thread's error if training died."""
        if self.error is not None:
            raise self.error
        if not self.alive:
            # no concurrent stepper: safe to copy inline
            if self.model.params is None:
                return None
            return _candidate(self.model, self._iterations,
                              self.stream.samples_consumed)
        with self._snap_lock:
            self._snap_done.clear()
            self._snap_result = None
            self._snap_req.set()
            if not self._snap_done.wait(timeout):
                self._snap_req.clear()
                return None
            return self._snap_result
