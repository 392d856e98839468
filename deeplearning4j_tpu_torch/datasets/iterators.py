"""Utility dataset iterators.

A copy of the JAX package's ``datasets/iterators.py`` (threads and numpy
only). Analogs of deeplearning4j-data/deeplearning4j-utility-iterators
(SURVEY §2.3): AsyncDataSetIterator (background prefetch),
MultipleEpochsIterator, EarlyTerminationDataSetIterator,
DataSetIteratorSplitter, AsyncShieldDataSetIterator.

The async prefetcher overlaps host ETL with the card: a host thread
prepares the next minibatches while the current step runs (reference:
AsyncDataSetIterator wraps fit's iterator at
MultiLayerNetwork.java:1273); the device feeder (datasets/feeder.py)
stages them onto the card ahead of the step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, DataSetIterator


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded queue (reference:
    AsyncDataSetIterator, default queue size 8)."""

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, queue_size: int = 8):
        self.base = base
        self.queue_size = queue_size
        self._worker: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._q: Optional[queue.Queue] = None

    def __iter__(self) -> Iterator[DataSet]:
        # one pass at a time: an unfinished previous pass (early break)
        # must not keep filling the queue we are about to read
        self._shutdown_worker()
        q: queue.Queue = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        error = []

        def worker():
            try:
                for batch in self.base:
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.05)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagate to consumer
                error.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(self._SENTINEL, timeout=0.05)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        self._worker, self._stop, self._q = t, stop, q
        t.start()
        finished = False
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    finished = True
                    break
                yield item
        finally:
            if finished:
                t.join()
            else:
                # consumer abandoned the pass (break / exception / GC):
                # stop and reap the worker instead of leaving it blocked
                # on a full queue forever
                self._reap(t, stop, q)
            if self._worker is t:
                self._worker = self._stop = self._q = None
        if error:
            raise error[0]

    @staticmethod
    def _reap(t: threading.Thread, stop: threading.Event, q: queue.Queue):
        stop.set()
        while t.is_alive():
            try:          # drain so a put-blocked worker sees the stop
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)

    def _shutdown_worker(self):
        t, stop, q = self._worker, self._stop, self._q
        self._worker = self._stop = self._q = None
        if t is None or not t.is_alive():
            return
        self._reap(t, stop, q)

    def reset(self):
        # stop → drain → JOIN, and only then reset the base: resetting
        # first would let the still-running worker interleave stale
        # batches from the old pass (or race a non-reentrant base) into
        # the next one
        self._shutdown_worker()
        self.base.reset()

    @property
    def batch_size(self):
        return self.base.batch_size


class AsyncShieldDataSetIterator(DataSetIterator):
    """Marks an iterator as not-async-safe (reference:
    AsyncShieldDataSetIterator) — fit() will not wrap it."""

    def __init__(self, base: DataSetIterator):
        self.base = base

    def __iter__(self):
        return iter(self.base)

    def reset(self):
        self.base.reset()

    @property
    def async_supported(self):
        return False

    @property
    def batch_size(self):
        return self.base.batch_size


class MultipleEpochsIterator(DataSetIterator):
    """Replays the base iterator N times as one pass (reference:
    MultipleEpochsIterator)."""

    def __init__(self, base: DataSetIterator, epochs: int):
        self.base = base
        self.epochs = epochs

    def __iter__(self):
        for e in range(self.epochs):
            for batch in self.base:
                yield batch
            self.base.reset()

    def reset(self):
        self.base.reset()

    @property
    def batch_size(self):
        return self.base.batch_size


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Caps the number of minibatches per pass (reference:
    EarlyTerminationDataSetIterator)."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        self.base = base
        self.max_batches = max_batches

    def __iter__(self):
        for i, batch in enumerate(self.base):
            if i >= self.max_batches:
                break
            yield batch

    def reset(self):
        self.base.reset()

    @property
    def batch_size(self):
        return self.base.batch_size


class DataSetIteratorSplitter:
    """Splits one iterator into train/test partitions by batch count
    (reference: DataSetIteratorSplitter)."""

    def __init__(self, base: DataSetIterator, total_batches: int,
                 ratio: float):
        self.base = base
        self.n_train = int(total_batches * ratio)
        self.total = total_batches

    @property
    def train_iterator(self) -> DataSetIterator:
        return _SplitView(self.base, 0, self.n_train)

    @property
    def test_iterator(self) -> DataSetIterator:
        return _SplitView(self.base, self.n_train, self.total)


class _SplitView(DataSetIterator):
    def __init__(self, base, lo, hi):
        self.base, self.lo, self.hi = base, lo, hi

    def __iter__(self):
        for i, batch in enumerate(self.base):
            if i >= self.hi:
                break
            if i >= self.lo:
                yield batch
        self.base.reset()

    def reset(self):
        self.base.reset()

    @property
    def batch_size(self):
        return self.base.batch_size
