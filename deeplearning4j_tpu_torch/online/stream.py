"""Broker-fed sample stream for online learning.

One packed frame per micro-batch rides the streaming transport
(streaming/broker.py): features and labels flattened to 2D f32 and
concatenated column-wise, the per-example feature shape carried in the
message key (the JAX package's frames, byte for byte).
``SampleStreamIterator`` turns the topic back into an unbounded
``DataSetIterator`` that ``fit()`` can consume directly — the normal
AsyncDataSetIterator → DeviceFeeder pipeline stages the micro-batches,
whatever their sizes.

Every Nth consumed micro-batch is diverted into a rolling **holdout
reservoir** (never trained on), which backs the promotion gate's score
calculator via ``holdout_view()`` — a live iterator view that always
reads the current reservoir contents.

Malformed frames (truncated, wrong magic, shape/key disagreement) are
counted on ``dl4j_online_stream_malformed_total`` and skipped; a bad
peer cannot kill the training loop.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Iterator, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.streaming.broker import (
    NDArrayConsumer,
    NDArrayPublisher,
    Transport,
)


def pack_samples(features, labels) -> Tuple[np.ndarray, str]:
    """(features, labels) -> one 2D f32 frame + its shape key.

    Rows are examples; columns are flattened features followed by
    flattened labels. The key records the per-example feature shape
    (comma-joined), which is all the consumer needs to split and
    reshape the frame."""
    x = np.asarray(features, dtype=np.float32)
    y = np.asarray(labels, dtype=np.float32)
    if x.ndim < 1 or y.ndim < 1 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"features/labels batch mismatch: {x.shape} vs {y.shape}")
    n = x.shape[0]
    packed = np.concatenate(
        [x.reshape(n, -1), y.reshape(n, -1)], axis=1)
    key = ",".join(str(d) for d in x.shape[1:])
    return packed, key


def unpack_samples(packed: np.ndarray, key: str) -> DataSet:
    """Inverse of ``pack_samples``; raises ValueError on a frame whose
    key disagrees with its geometry."""
    arr = np.asarray(packed, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError(f"sample frame must be 2D, got {arr.shape}")
    try:
        feat_shape = tuple(int(d) for d in key.split(",") if d != "")
    except ValueError as e:
        raise ValueError(f"bad sample-frame key {key!r}") from e
    feat_cols = int(np.prod(feat_shape)) if feat_shape else 1
    if feat_cols <= 0 or feat_cols >= arr.shape[1]:
        raise ValueError(
            f"frame key {key!r} ({feat_cols} feature cols) does not "
            f"fit a {arr.shape[1]}-column frame")
    n = arr.shape[0]
    x = arr[:, :feat_cols].reshape((n,) + feat_shape)
    y = arr[:, feat_cols:]
    return DataSet(x, y)


def publish_samples(transport: Transport, topic: str, features,
                    labels) -> None:
    """Publish one micro-batch of training samples to the topic."""
    packed, key = pack_samples(features, labels)
    NDArrayPublisher(transport, topic).publish(packed, key=key)


class HoldoutIterator(DataSetIterator):
    """Live view over the stream's holdout reservoir: each pass merges
    the CURRENT reservoir and re-batches it, so a ScoreCalculator built
    once keeps scoring against fresh holdout data."""

    def __init__(self, stream: "SampleStreamIterator", batch_size: int):
        self.stream = stream
        self._bs = int(batch_size)

    def __iter__(self) -> Iterator[DataSet]:
        merged = self.stream.holdout_snapshot()
        if merged is None:
            return
        n = merged.num_examples()
        for lo in range(0, n, self._bs):
            hi = min(lo + self._bs, n)
            yield DataSet(merged.features[lo:hi], merged.labels[lo:hi])

    @property
    def batch_size(self):
        return self._bs


class SampleStreamIterator(DataSetIterator):
    """Unbounded DataSetIterator over a broker topic.

    ``__iter__`` yields micro-batches until ``stop_event`` is set (or
    ``max_batches`` consumed, when given) — one fit() "epoch" is one
    subscription. ``reset()`` is a no-op: a stream has no beginning to
    rewind to, and fit()'s per-epoch reset must not raise.

    Every ``holdout_every``-th consumed batch is diverted into the
    rolling holdout reservoir (bounded by ``holdout_max`` examples,
    oldest batches evicted) and is NOT yielded for training — the gate
    scores on data the candidate never saw.
    """

    def __init__(self, transport: Transport, topic: str, *,
                 stop_event: Optional[threading.Event] = None,
                 holdout_every: int = 8, holdout_max: int = 512,
                 poll_timeout_s: float = 0.25,
                 max_batches: Optional[int] = None,
                 registry=None):
        if holdout_every < 2:
            raise ValueError("holdout_every must be >= 2 (some batches "
                             "must remain for training)")
        self.consumer = NDArrayConsumer(transport, topic)
        self.topic = topic
        self.stop_event = stop_event if stop_event is not None \
            else threading.Event()
        self.holdout_every = int(holdout_every)
        self.holdout_max = int(holdout_max)
        self.poll_timeout_s = float(poll_timeout_s)
        self.max_batches = max_batches
        # counters below are written by the consuming (async worker)
        # thread and read by promoter/stats threads; plain int writes
        # under the GIL, single-writer
        self.batches_consumed = 0
        self.samples_consumed = 0
        self.malformed = 0
        self.last_sample_walltime: Optional[float] = None
        self._holdout: Deque[DataSet] = deque()
        self._holdout_examples = 0
        self._holdout_lock = threading.Lock()
        from deeplearning4j_tpu_torch.observe.registry import default_registry
        reg = registry if registry is not None else default_registry()
        self._c_samples = reg.counter(
            "dl4j_online_stream_samples_total",
            "training samples consumed off the stream, by topic and "
            "destination (train|holdout)")
        self._c_malformed = reg.counter(
            "dl4j_online_stream_malformed_total",
            "stream frames dropped as malformed (bad serde, key/shape "
            "disagreement), by topic")
        self._c_malformed.inc(0.0, topic=topic)

    # ---- holdout reservoir ----------------------------------------------
    def _add_holdout(self, ds: DataSet):
        with self._holdout_lock:
            self._holdout.append(ds)
            self._holdout_examples += ds.num_examples()
            while (len(self._holdout) > 1
                   and self._holdout_examples > self.holdout_max):
                old = self._holdout.popleft()
                self._holdout_examples -= old.num_examples()

    @property
    def holdout_examples(self) -> int:
        with self._holdout_lock:
            return self._holdout_examples

    def holdout_snapshot(self) -> Optional[DataSet]:
        """Merge the current reservoir into one DataSet (None when
        empty). Copies under the lock, so scoring never races
        eviction."""
        with self._holdout_lock:
            batches = list(self._holdout)
        if not batches:
            return None
        return DataSet.merge(batches)

    def holdout_view(self, batch_size: int = 64) -> HoldoutIterator:
        """A DataSetIterator the earlystopping score calculators can
        hold on to; each pass reads the live reservoir."""
        return HoldoutIterator(self, batch_size)

    # ---- DataSetIterator protocol ---------------------------------------
    def __iter__(self) -> Iterator[DataSet]:
        while not self.stop_event.is_set():
            if (self.max_batches is not None
                    and self.batches_consumed >= self.max_batches):
                return
            try:
                msg = self.consumer.poll(timeout=self.poll_timeout_s)
            except (ConnectionError, OSError):
                # transport retries are exhausted; back off and keep
                # the subscription alive (the broker may come back)
                if self.stop_event.wait(self.poll_timeout_s):
                    return
                continue
            if msg is None:
                continue
            try:
                ds = unpack_samples(msg.array, msg.key)
            except ValueError:
                self.malformed += 1
                self._c_malformed.inc(1.0, topic=self.topic)
                continue
            self.batches_consumed += 1
            self.samples_consumed += ds.num_examples()
            self.last_sample_walltime = time.time()
            if self.batches_consumed % self.holdout_every == 0:
                self._add_holdout(ds)
                self._c_samples.inc(float(ds.num_examples()),
                                    topic=self.topic, dest="holdout")
                continue
            self._c_samples.inc(float(ds.num_examples()),
                                topic=self.topic, dest="train")
            yield ds

    def reset(self):
        # unbounded stream: nothing to rewind; fit() calls this at
        # every epoch boundary and it must be a no-op
        pass

    def stop(self):
        self.stop_event.set()

    @property
    def batch_size(self):
        return None
