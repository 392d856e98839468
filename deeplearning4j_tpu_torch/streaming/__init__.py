"""Streaming ingestion — NDArray pub-sub over pluggable transports.

Analog of the reference's ``dl4j-streaming`` module (SURVEY §2.11):
``NDArrayKafkaClient`` + Camel routes publish/consume serialized NDArrays
so training/inference can ride a message bus. Kafka itself is an external
service; here the client API is transport-agnostic — an in-process broker
for tests/single-host pipelines and a TCP transport for cross-process —
with the same publish/subscribe surface, so a Kafka transport is a
drop-in (implement ``Transport``).
"""

from deeplearning4j_tpu_torch.streaming.serde import (
    NDArrayMessage,
    deserialize_ndarray,
    serialize_ndarray,
)
from deeplearning4j_tpu_torch.streaming.broker import (
    InProcessTransport,
    NDArrayConsumer,
    NDArrayPublisher,
    NDArrayStreamingClient,
    TcpTransport,
    Transport,
)
from deeplearning4j_tpu_torch.streaming.routes import Route, StreamStep

__all__ = [
    "NDArrayMessage", "serialize_ndarray", "deserialize_ndarray",
    "Transport", "InProcessTransport", "TcpTransport",
    "NDArrayPublisher", "NDArrayConsumer", "NDArrayStreamingClient",
    "Route", "StreamStep",
]
