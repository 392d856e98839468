"""Streaming ingestion. The port has the NDArray wire format only
(``serde.py``, a copy: the UI's binary stats codec uses it); the
broker, its transports and the routes are not ported yet (ROADMAP.md,
queue 1 item 16)."""

from deeplearning4j_tpu_torch.streaming.serde import (
    NDArrayMessage,
    deserialize_ndarray,
    serialize_ndarray,
)

__all__ = ["NDArrayMessage", "serialize_ndarray", "deserialize_ndarray"]
