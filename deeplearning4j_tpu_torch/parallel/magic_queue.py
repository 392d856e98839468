"""MagicQueue: batches fanned out to per-device buckets.

The port of the JAX package's ``parallel/magic_queue.py`` (reference:
MagicQueue.java). ``add`` places each batch on its bucket's device with
an asynchronous copy (``non_blocking``), so a worker dequeues tensors
already on its card; SEQUENTIAL hands batches to the devices in turn,
THROUGHPUT gives every device every batch.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.utils.device import resolve_device


class MagicQueue:
    """Round-robin per-device buckets with asynchronous placement.
    ``devices`` defaults to every card (raises without one; pass
    ``[torch.device("cpu")]`` on the CPU)."""

    SEQUENTIAL = "sequential"
    THROUGHPUT = "throughput"

    def __init__(self, devices: Optional[Sequence] = None,
                 mode: str = SEQUENTIAL, capacity: int = 8):
        if devices:
            self.devices = [torch.device(d) for d in devices]
        else:
            first = resolve_device(None)
            self.devices = [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())] \
                or [first]
        if mode not in (self.SEQUENTIAL, self.THROUGHPUT):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self._buckets: List[queue.Queue] = [
            queue.Queue(maxsize=capacity) for _ in self.devices]
        self._next = 0
        self._lock = threading.Lock()

    def _place(self, batch: DataSet, device) -> DataSet:
        def put(a):
            if a is None:
                return None
            t = a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.asarray(a))
            return t.to(device, non_blocking=True)
        return DataSet(put(batch.features), put(batch.labels),
                       put(batch.features_mask), put(batch.labels_mask))

    def add(self, batch: DataSet) -> None:
        """Producer side: place, then enqueue."""
        if self.mode == self.THROUGHPUT:
            for i, dev in enumerate(self.devices):
                self._buckets[i].put(self._place(batch, dev))
            return
        with self._lock:
            i = self._next
            self._next = (self._next + 1) % len(self.devices)
        self._buckets[i].put(self._place(batch, self.devices[i]))

    def poll(self, device_index: int, timeout: float = 1.0
             ) -> Optional[DataSet]:
        """Worker side: the next batch on this device, or None."""
        try:
            return self._buckets[device_index].get(timeout=timeout)
        except queue.Empty:
            return None

    def size(self, device_index: Optional[int] = None) -> int:
        if device_index is not None:
            return self._buckets[device_index].qsize()
        return sum(b.qsize() for b in self._buckets)
