"""Transports + publisher/consumer client (a copy of the JAX package's
module: the TCP framing is a wire format, kept byte for byte, so either
package's client talks to either package's broker).

Analog of ``NDArrayKafkaClient`` (dl4j-streaming, SURVEY §2.11) with the
broker abstracted: ``InProcessTransport`` (queue per topic — the test/
single-host path, like the reference's Camel direct: routes) and
``TcpTransport`` (length-prefixed frames over a socket — cross-process).
A Kafka/PubSub transport is the same interface against a real broker.

``TcpTransport`` survives peer drops: a broken/timed-out socket is torn
down and the frame retried over a fresh connection with bounded
exponential backoff (a mid-exchange failure desyncs the framed
protocol, so reconnect is the only safe resync). Every reconnect
attempt is surfaced on the ``dl4j_stream_reconnects_total`` Prometheus
counter — before this, one dropped connection killed the consumer
thread for good (the online learner's input just stopped).
"""

from __future__ import annotations

import queue
import socket
import socketserver
import struct
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.chaos.hook import chaos_site
from deeplearning4j_tpu_torch.streaming.serde import NDArrayMessage


class Transport:
    """publish/poll on named topics."""

    def publish(self, topic: str, payload: bytes) -> None:
        raise NotImplementedError

    def poll(self, topic: str, timeout: float = 1.0) -> Optional[bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcessTransport(Transport):
    """Thread-safe per-topic queues; every subscriber pool shares one
    stream (competing consumers, like one Kafka consumer group).

    ``publish`` is BOUNDED: it waits up to ``put_timeout_s`` for a slot,
    then sheds the message and increments
    ``dl4j_stream_dropped_total{topic}`` — a slow (or dead) consumer
    must never wedge the publisher. Before this, a full topic queue
    blocked ``publish`` forever, which through the TCP broker's handler
    thread also wedged every other client on that connection."""

    def __init__(self, max_queue: int = 1024,
                 put_timeout_s: float = 1.0, registry=None):
        self._queues: Dict[str, queue.Queue] = defaultdict(
            lambda: queue.Queue(maxsize=max_queue))
        self._lock = threading.Lock()
        self.put_timeout_s = float(put_timeout_s)
        self.dropped = 0
        from deeplearning4j_tpu_torch.observe.registry import default_registry
        reg = registry if registry is not None else default_registry()
        self._c_dropped = reg.counter(
            "dl4j_stream_dropped_total",
            "messages shed by a full bounded topic queue (slow "
            "consumer), by topic")

    def _q(self, topic: str) -> queue.Queue:
        with self._lock:
            return self._queues[topic]

    def publish(self, topic: str, payload: bytes) -> None:
        try:
            self._q(topic).put(payload, timeout=self.put_timeout_s)
        except queue.Full:
            self.dropped += 1
            self._c_dropped.inc(1.0, topic=topic)

    def poll(self, topic: str, timeout: float = 1.0) -> Optional[bytes]:
        try:
            return self._q(topic).get(timeout=timeout)
        except queue.Empty:
            return None


class _FrameHandler(socketserver.BaseRequestHandler):
    def handle(self):
        broker: InProcessTransport = self.server.broker  # type: ignore
        try:
            while True:
                hdr = self._recv_exact(9)
                if hdr is None:
                    return
                op, tlen, plen = struct.unpack("<BII", hdr)
                tbytes = self._recv_exact(tlen)
                if tbytes is None:
                    return
                topic = tbytes.decode("utf-8")
                if op == 0:  # publish
                    payload = self._recv_exact(plen)
                    if payload is None:
                        return
                    broker.publish(topic, payload)
                elif op == 1:  # poll
                    payload = broker.poll(topic, timeout=float(plen) / 1000)
                    body = payload or b""
                    self.request.sendall(
                        struct.pack("<I", len(body)) + body)
        except (ConnectionError, OSError):
            return

    def _recv_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = self.request.recv(n - len(buf))
            if not chunk:
                return None  # disconnect (mid-frame partials discarded)
            buf += chunk
        return buf


class _BrokerServer(socketserver.ThreadingTCPServer):
    # SO_REUSEADDR: a restarted broker must be able to rebind its port
    # while old connections sit in TIME_WAIT (the reconnect story
    # depends on it)
    allow_reuse_address = True
    daemon_threads = True


class TcpTransport(Transport):
    """Client side of the socket broker; ``serve()`` starts the broker
    (an InProcessTransport behind a threaded TCP server).

    ``reconnect=True`` (default) makes ``publish``/``poll`` retry over a
    fresh connection when the peer drops mid-exchange: up to
    ``max_retries`` attempts with exponential backoff
    ``backoff_base_s * 2**attempt`` capped at ``backoff_max_s``. A
    publish retried after a send-side failure may be delivered twice
    (at-least-once, like any reconnecting producer); polls are
    idempotent. Retries exhausted -> the original error propagates."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 reconnect: bool = True, max_retries: int = 5,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0, registry=None):
        self.host = host
        self.port = port
        self.reconnect = bool(reconnect)
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.reconnects = 0
        self._sock: Optional[socket.socket] = None
        self._server = None
        self._lock = threading.Lock()
        # chaos faults here surface as ConnectionError so the reconnect
        # machinery under test treats them exactly like a dropped peer
        self._chaos_pub = chaos_site("broker.publish")
        self._chaos_poll = chaos_site("broker.poll")
        from deeplearning4j_tpu_torch.observe.registry import default_registry
        reg = registry if registry is not None else default_registry()
        self._c_reconnects = reg.counter(
            "dl4j_stream_reconnects_total",
            "streaming transport reconnect attempts after a dropped/"
            "failed broker connection, by endpoint and operation")

    def serve(self) -> "TcpTransport":
        srv = _BrokerServer((self.host, self.port), _FrameHandler)
        srv.broker = InProcessTransport()  # type: ignore
        self.port = srv.server_address[1]
        self._server = srv
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return self

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection((self.host, self.port),
                                                  timeout=10)
        return self._sock

    def _drop_conn(self):
        """Tear down the (possibly desynced) connection so the next
        attempt starts from a clean frame boundary."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _with_retry(self, op: str, fn):
        """Run ``fn`` holding the connection lock; on a transport error
        drop the connection and retry with bounded exponential backoff.
        The lock is held across the whole retry loop so interleaved
        callers can never split a frame."""
        with self._lock:
            attempt = 0
            while True:
                try:
                    return fn()
                except (ConnectionError, OSError) as e:
                    self._drop_conn()
                    if not self.reconnect or attempt >= self.max_retries:
                        raise ConnectionError(
                            f"broker {self.host}:{self.port} {op} failed "
                            f"after {attempt} reconnect attempt(s): {e}"
                        ) from e
                    delay = min(self.backoff_max_s,
                                self.backoff_base_s * (2 ** attempt))
                    attempt += 1
                    self.reconnects += 1
                    self._c_reconnects.inc(
                        1.0, endpoint=f"{self.host}:{self.port}", op=op)
                    time.sleep(delay)

    def publish(self, topic: str, payload: bytes) -> None:
        tb = topic.encode("utf-8")
        frame = struct.pack("<BII", 0, len(tb), len(payload)) + tb + payload

        def send():
            if self._chaos_pub is not None:
                self._chaos_pub.fail(arg=topic, raise_as=ConnectionError)
            self._conn().sendall(frame)
        self._with_retry("publish", send)

    def poll(self, topic: str, timeout: float = 1.0) -> Optional[bytes]:
        tb = topic.encode("utf-8")

        def exchange():
            if self._chaos_poll is not None:
                self._chaos_poll.fail(arg=topic,
                                      raise_as=ConnectionError)
            s = self._conn()
            # socket deadline must outlast the server-side poll wait, or a
            # mid-exchange timeout desyncs the framed protocol
            s.settimeout(timeout + 10)
            s.sendall(struct.pack("<BII", 1, len(tb),
                                  int(timeout * 1000)) + tb)
            hdr = self._recv_exact(s, 4)
            (plen,) = struct.unpack("<I", hdr)
            if plen == 0:
                return None
            return self._recv_exact(s, plen)
        return self._with_retry("poll", exchange)

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("broker closed connection")
            buf += chunk
        return buf

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        if self._server is not None:
            self._server.shutdown()
            # release the listening socket too, so a restarted broker
            # can rebind the same port immediately
            self._server.server_close()
            self._server = None


class NDArrayPublisher:
    """Pushes arrays to a topic (reference: NDArrayPublisher)."""

    def __init__(self, transport: Transport, topic: str):
        self.transport = transport
        self.topic = topic

    def publish(self, array: np.ndarray, key: str = "") -> None:
        self.transport.publish(
            self.topic, NDArrayMessage(np.asarray(array), key).to_bytes())


class NDArrayConsumer:
    """Pulls arrays from a topic (reference: NDArrayConsumer)."""

    def __init__(self, transport: Transport, topic: str):
        self.transport = transport
        self.topic = topic

    def poll(self, timeout: float = 1.0) -> Optional[NDArrayMessage]:
        payload = self.transport.poll(self.topic, timeout)
        return None if payload is None else NDArrayMessage.from_bytes(payload)

    def poll_batch(self, n: int, timeout: float = 1.0
                   ) -> List[NDArrayMessage]:
        out = []
        for _ in range(n):
            msg = self.poll(timeout)
            if msg is None:
                break
            out.append(msg)
        return out


class NDArrayStreamingClient:
    """Facade bundling both directions on one transport (reference:
    NDArrayKafkaClient)."""

    def __init__(self, transport: Optional[Transport] = None):
        self.transport = transport or InProcessTransport()

    def publisher(self, topic: str) -> NDArrayPublisher:
        return NDArrayPublisher(self.transport, topic)

    def consumer(self, topic: str) -> NDArrayConsumer:
        return NDArrayConsumer(self.transport, topic)
