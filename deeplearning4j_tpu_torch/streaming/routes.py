"""Camel-style routes: source topic → transforms → sink.

Analog of the reference's Camel route builders in dl4j-streaming
(SURVEY §2.11): declarative pipelines that move NDArray records between
topics with per-hop transforms — e.g. raw records in, model scores out.
A route runs on a background thread; transforms are host-side Python
(decode/reshape) or model calls (the inference hop).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.streaming.broker import (
    NDArrayConsumer,
    NDArrayPublisher,
    Transport,
)
from deeplearning4j_tpu_torch.streaming.serde import NDArrayMessage

StreamStep = Callable[[np.ndarray], np.ndarray]


class Route:
    """``Route(t).from_topic("in").process(f).to_topic("out").start()``"""

    def __init__(self, transport: Transport):
        self.transport = transport
        self._source: Optional[str] = None
        self._sink: Optional[str] = None
        self._steps: List[StreamStep] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.processed = 0
        self.errors = 0
        self.last_error: Optional[BaseException] = None

    def from_topic(self, topic: str) -> "Route":
        self._source = topic
        return self

    def process(self, fn: StreamStep) -> "Route":
        self._steps.append(fn)
        return self

    def to_topic(self, topic: str) -> "Route":
        self._sink = topic
        return self

    def start(self) -> "Route":
        if self._source is None:
            raise ValueError("route needs from_topic(...)")
        consumer = NDArrayConsumer(self.transport, self._source)
        publisher = (None if self._sink is None
                     else NDArrayPublisher(self.transport, self._sink))

        def run():
            while not self._stop.is_set():
                try:
                    # poll inside the try: a transport error (broker
                    # restart beyond the transport's own retries) must
                    # not kill the route thread for good
                    msg = consumer.poll(timeout=0.1)
                    if msg is None:
                        continue
                    arr = msg.array
                    for step in self._steps:
                        arr = step(arr)
                    if publisher is not None:
                        publisher.publish(np.asarray(arr), key=msg.key)
                    self.processed += 1
                except Exception as e:  # bad message: record, keep going
                    self.errors += 1
                    self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
