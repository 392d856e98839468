"""DeviceFeeder: input staging onto the card ahead of the step, and
K-step batch grouping.

The JAX package's ``datasets/feeder.py`` in torch (reference: the
AsyncDataSetIterator thread that stages minibatches into device
workspaces, MultiLayerNetwork.java:1273). The host side is copied:
ragged-batch normalization (``ones_labels_mask``, ``ensure_labels_mask``,
``pad_rows``, ``pad_to_bucket``: every batch gets an explicit labels mask
and a short tail is padded to the bucket with zero-weight rows, so the
masked loss ignores them), K-group stacking into (K, B, ...) arrays for
``make_scan_train_step``, and the ``split``/``pad`` remainder modes.

The device side is CUDA's: each batch is copied into a **pinned** host
staging slot and from there to the card with ``non_blocking=True`` on a
side ``torch.cuda.Stream``, while the step on the compute stream runs the
batch before it. When the fit loop takes a staged item, the compute
stream waits on the event recorded after its copies, and
``record_stream`` tells the caching allocator that the compute stream
uses each staged tensor (they were allocated on the side stream).

The slot ring is what keeps that safe: the copy that reads a pinned slot
runs asynchronously, so rewriting the slot before the copy finished would
corrupt a batch with no error. Each slot keeps the event of the last copy
that read it, and is rewritten only after that event has completed
(``StagingRing.stage`` waits on it). On a CPU model nothing is staged —
the arrays go to the step as tensors on the CPU, as the JAX package's
``StagingPool`` turns itself off on its CPU backend.

``stall_ms`` (the ms the step loop waited for data in the current or
last pass) and ``pass_stall_ms`` (one entry per finished pass) are read
by the caller; the JAX package's registry gauges, tracer spans and its
``prepare``/``group_prepare`` hooks (for the parallel wrapper) wait for
the modules that use them (ROADMAP).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_DEPTH = 2


# ---- ragged-batch normalization ------------------------------------------

def ones_labels_mask(batch: DataSet) -> np.ndarray:
    """The all-ones labels mask matching this batch's label rank — the
    identity element of the masked loss mean (ops/losses._masked_mean
    divides by sum(mask), so ones reproduce the plain mean bitwise)."""
    lab = np.asarray(batch.labels)
    n = batch.num_examples()
    if lab.ndim <= 2:
        # (N,) sparse or (N, C) dense labels → per-example weights
        return np.ones((n,), np.float32)
    if lab.ndim == 3 and batch.features_mask is not None:
        # variable-length sequences: the loss would have used the
        # features mask — keep those semantics explicit
        return np.asarray(batch.features_mask, np.float32)
    # (N, T, C) → (N, T); (N, H, W, C) → (N, H, W)
    return np.ones(lab.shape[:-1], np.float32)


def ensure_labels_mask(batch: DataSet) -> DataSet:
    """Attach an explicit (all-ones) labels mask when the batch carries
    none, so full and padded batches share one compile signature."""
    if batch.labels_mask is not None or batch.labels is None:
        return batch
    return DataSet(batch.features, batch.labels, batch.features_mask,
                   ones_labels_mask(batch))


def pad_rows(batch: DataSet, pad: int) -> DataSet:
    """Append ``pad`` zero-weight rows: features/labels/features-mask
    duplicate the last row (finite activations — a zeroed row could
    still NaN through log/normalization paths), the labels mask extends
    with zeros so the masked loss mean and its gradients ignore them.
    The one caveat is BatchNormalization batch statistics, which see the
    duplicated rows (mask-free batch moments) — same bounded
    perturbation the parallel wrapper's padding has always accepted."""
    if pad <= 0:
        return batch

    def rep(a):
        if a is None:
            return None
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)

    lmask = batch.labels_mask
    if lmask is None:
        lmask = ones_labels_mask(batch)
    lmask = np.asarray(lmask)
    zeros = np.zeros((pad,) + lmask.shape[1:], lmask.dtype)
    return DataSet(rep(batch.features), rep(batch.labels),
                   rep(batch.features_mask),
                   np.concatenate([lmask, zeros], axis=0))


def pad_to_bucket(batch: DataSet, bucket: int) -> DataSet:
    """Normalize one batch to exactly ``bucket`` examples with an
    explicit labels mask (see ``pad_rows``). Bitwise-neutral for masked
    losses; raises when the batch is LARGER than the bucket (a growing
    batch is a data-pipeline bug, not a ragged tail)."""
    n = batch.num_examples()
    if n > bucket:
        raise ValueError(
            f"batch of {n} examples exceeds the feed bucket size "
            f"{bucket}; ragged-batch padding only shrinks tails")
    return pad_rows(ensure_labels_mask(batch), bucket - n)


# ---- staged items ----------------------------------------------------------

class FeedItem(NamedTuple):
    """One staged hand-off from the feeder to the fit loop: tensors on the
    model's device (on the card, ready only after ``event``; the fit loop
    calls ``DeviceFeeder.hand_off`` first). ``k == 0`` marks a passthrough
    object the feeder does not understand (e.g. a MultiDataSet): ``raw``
    then holds it untouched and the fit loop takes its unfed path."""
    features: Any
    labels: Any
    features_mask: Any
    labels_mask: Any
    k: int                  # inner optimizer steps this item carries
    n_examples: int         # REAL examples (pre-padding)
    queue_wait_ms: float    # time the consumer stalled for this item
    nbytes: int
    raw: Any = None
    event: Any = None       # the copies' event (None: nothing pending)


class _HostItem(NamedTuple):
    """Host-side prepared arrays, pre-staging."""
    arrays: tuple           # (features, labels, fmask, lmask) numpy/None
    k: int
    n_examples: int
    raw: Any = None


class _Slot:
    """One pinned host buffer and the event of the last copy that read
    it (None: no copy pending)."""
    __slots__ = ("buf", "event")

    def __init__(self, buf):
        self.buf = buf
        self.event = None


class StagingRing:
    """A ring of ``slots`` pinned host buffers per (shape, dtype), made by
    ``alloc(shape, torch dtype)``. ``stage(a)`` takes the ring's next slot,
    first waiting (``event.synchronize()``) for the copy that last read it,
    then copies ``a`` into it; the caller sets ``slot.event`` once the copy
    out of it is issued."""

    def __init__(self, slots: int, alloc: Callable):
        self.slots = max(2, int(slots))
        self.alloc = alloc
        self._rings = {}
        self.waits = 0      # stage() calls that found a copy pending

    def stage(self, a: np.ndarray) -> _Slot:
        key = (a.shape, a.dtype.str)
        ring = self._rings.get(key)
        if ring is None:
            dt = torch.from_numpy(np.empty(0, a.dtype)).dtype
            ring = deque(_Slot(self.alloc(a.shape, dt))
                         for _ in range(self.slots))
            self._rings[key] = ring
        slot = ring[0]
        ring.rotate(-1)
        if slot.event is not None:
            self.waits += 1
            slot.event.synchronize()
            slot.event = None
        np.copyto(slot.buf.numpy(), a)
        return slot


class CudaTransport:
    """The card's side of staging: pinned buffers, a side stream for the
    copies, events, and the hand-off to the compute stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def alloc(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def copy(self, host: torch.Tensor) -> torch.Tensor:
        """An asynchronous host-to-card copy issued on the side stream."""
        with torch.cuda.stream(self.stream):
            return host.to(self.device, non_blocking=True)

    def record(self):
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def hand_off(self, tensors, event):
        """The compute stream waits for the copies; the allocator learns
        that it uses each tensor."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for t in tensors:
            t.record_stream(cur)


class DeviceFeeder:
    """Bounded prefetch queue of staged batches over an iterable of
    DataSets.

    Parameters
    ----------
    source : iterable of DataSet (foreign objects pass through unstaged)
    device : the model's device, resolved as every entry point resolves
        it (``None`` means ``cuda``, which needs a card); ``cuda`` stages
        through pinned slots and a side stream, ``cpu`` stages nothing
    depth : staged batches held ahead of the consumer (default 2)
    byte_budget : optional soft cap on staged bytes; refill stops above
        it (at least one item is always staged)
    k_steps : >1 groups K batches into one stacked (K, B, ...) item for
        the K-step call; an epoch's remainder that does not fill a group
        is yielded as per-batch items at the same bucket shape
    group_remainder : an epoch's short tail group is yielded "split"
        (per-batch items, the default) or "pad"ded to a full group by
        repeating its last batch
    transport : the card's staging primitives (default ``CudaTransport``
        on a CUDA device; tests pass a stand-in)
    """

    def __init__(self, source: Iterable, *, device: DeviceLike = None,
                 depth: Optional[int] = None,
                 byte_budget: Optional[int] = None, k_steps: int = 1,
                 group_remainder: str = "split", transport=None):
        depth = DEFAULT_DEPTH if depth is None else int(depth)
        if depth < 1:
            raise ValueError("feeder depth must be >= 1")
        if k_steps < 1:
            raise ValueError("k_steps must be >= 1")
        if group_remainder not in ("split", "pad"):
            raise ValueError("group_remainder must be 'split' or 'pad'")
        self.source = source
        self.device = resolve_device(device)
        self.depth = depth
        self.byte_budget = byte_budget
        self.k_steps = int(k_steps)
        self.group_remainder = group_remainder
        if transport is None and self.device.type == "cuda":
            transport = CudaTransport(self.device)
        self.transport = transport
        # a slot is read by at most one pending copy, and at most depth
        # items (plus the one the step runs) hold copies in flight
        self.ring = (StagingRing(self.depth + 2, transport.alloc)
                     if transport is not None else None)
        bs = getattr(source, "batch_size", None)
        self.bucket_size: Optional[int] = (int(bs) if isinstance(bs, int)
                                           and bs > 0 else None)
        self.stall_ms = 0.0
        self.pass_stall_ms: List[float] = []   # stall_ms of each pass
        self._staged_bytes = 0

    # ---- host-side production -------------------------------------------
    def _normalize(self, batch: DataSet) -> DataSet:
        if self.bucket_size is None:
            self.bucket_size = batch.num_examples()
        return pad_to_bucket(batch, self.bucket_size)

    def _arrays_of(self, batch: DataSet) -> tuple:
        return (batch.features, batch.labels, batch.features_mask,
                batch.labels_mask)

    def _make_group(self, group: List[DataSet]) -> _HostItem:
        """Stack a K-group of batches, each padded to the bucket, into
        (K, B, ...) host arrays; the real example count is kept."""
        n_real = sum(b.num_examples() for b in group)
        norm = [self._arrays_of(self._normalize(b)) for b in group]
        arrays = tuple(
            None if any(a[i] is None for a in norm)
            else np.stack([np.asarray(a[i]) for a in norm])
            for i in range(4))
        return _HostItem(arrays, len(group), n_real)

    def _make_single(self, batch: DataSet, normalize: bool) -> _HostItem:
        n_real = batch.num_examples()
        if normalize:
            batch = self._normalize(batch)
        return _HostItem(self._arrays_of(batch), 1, n_real)

    def _host_items(self):
        """Generator of host-prepared items: per-batch DataSets (k=1),
        stacked K-groups (k=K), or passthrough foreign objects (k=0)."""
        group: List[DataSet] = []
        for b in self.source:
            if not isinstance(b, DataSet):
                for item in self._flush_group(group):
                    yield item
                group = []
                yield _HostItem((None,) * 4, 0, 0, raw=b)
                continue
            if self.k_steps > 1:
                group.append(b)
                if len(group) == self.k_steps:
                    yield self._make_group(group)
                    group = []
            else:
                yield self._make_single(b, normalize=False)
        for item in self._flush_group(group):
            yield item

    def _flush_group(self, group: List[DataSet]):
        if not group:
            return
        if self.group_remainder == "pad" and len(group) < self.k_steps:
            # the round is the unit: repeat the tail batch to a full
            # group (the AVERAGING contract — ParallelWrapper has always
            # padded short rounds this way, counting the repeats)
            padded = group + [group[-1]] * (self.k_steps - len(group))
            yield self._make_group(padded)
            return
        if len(group) == self.k_steps:
            yield self._make_group(group)
            return
        # short tail, "split": per-batch items at the SAME bucket shape
        # the K-group members were padded to — the per-batch step keeps
        # its one signature and no dummy optimizer steps run
        for b in group:
            yield self._make_single(b, normalize=True)

    # ---- staging -----------------------------------------------------------
    def _stage(self, item: _HostItem) -> FeedItem:
        if item.k == 0:
            return FeedItem(None, None, None, None, 0, item.n_examples,
                            0.0, 0, raw=item.raw)
        arrays = [None if a is None else np.ascontiguousarray(a)
                  for a in item.arrays]
        nbytes = sum(a.nbytes for a in arrays if a is not None)
        if self.transport is None:
            staged = [None if a is None else torch.from_numpy(a)
                      for a in arrays]
            event = None
        else:
            staged, slots = [], []
            for a in arrays:
                if a is None:
                    staged.append(None)
                    continue
                slot = self.ring.stage(a)
                slots.append(slot)
                staged.append(self.transport.copy(slot.buf))
            event = self.transport.record()
            for slot in slots:
                slot.event = event
        self._staged_bytes += nbytes
        return FeedItem(staged[0], staged[1], staged[2], staged[3], item.k,
                        item.n_examples, 0.0, nbytes, event=event)

    def hand_off(self, item: FeedItem) -> FeedItem:
        """Make a staged item safe to use on the compute stream."""
        if item.event is not None:
            self.transport.hand_off(
                [t for t in item[:4] if t is not None], item.event)
        return item

    # ---- the prefetch loop -------------------------------------------------
    def __iter__(self):
        src = self._host_items()
        pending: deque = deque()
        exhausted = False
        self.stall_ms = 0.0
        self._staged_bytes = 0
        while True:
            wait_ms = 0.0
            while not exhausted and len(pending) < self.depth and (
                    not pending or self.byte_budget is None
                    or self._staged_bytes < self.byte_budget):
                t0 = time.perf_counter()
                try:
                    item = next(src)
                except StopIteration:
                    exhausted = True
                    break
                staged = self._stage(item)
                if not pending:
                    # the queue ran dry: the consumer waited for the host
                    # production and the staging issue of THIS item
                    stall = (time.perf_counter() - t0) * 1000.0
                    wait_ms += stall
                    self.stall_ms += stall
                pending.append(staged)
            if not pending:
                self.pass_stall_ms.append(self.stall_ms)
                break
            out = pending.popleft()
            self._staged_bytes -= out.nbytes
            yield out._replace(queue_wait_ms=wait_ms)
