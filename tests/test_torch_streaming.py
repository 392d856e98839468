"""The port's streaming tier (streaming/broker.py, routes.py and the
online sample frames of online/stream.py) on the CPU, against the JAX
package's.

- **Wire.** The TCP framing is a wire format: frames published by the
  JAX package's ``publish_samples`` through its ``TcpTransport`` server
  are read by the port's client, and the other way round, with arrays
  and keys bitwise equal; raw frames too.
- **Stream.** The same published sequence (ragged batches, a malformed
  frame) gives the same train batches, holdout reservoir and malformed
  count in both packages.
- **Transport behaviour.** The bounded in-process publish sheds and
  counts; a client reconnects with bounded backoff after a broker
  restart and gives up with a clear error when nothing listens; routes
  move arrays between topics and survive a bad message.

Every threaded test bounds its waits with a deadline in the code.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.online import (SampleStreamIterator,
                                             pack_samples, publish_samples,
                                             unpack_samples)
from deeplearning4j_tpu_torch.streaming import (InProcessTransport,
                                                NDArrayConsumer,
                                                NDArrayPublisher,
                                                NDArrayStreamingClient,
                                                Route, TcpTransport)

N_IN, N_OUT = 5, 3


def _batch(rng, n, shape=(N_IN,)):
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, size=n)]
    return x, y


def _jax():
    from deeplearning4j_tpu.observe.registry import MetricsRegistry as R
    from deeplearning4j_tpu.online import stream as S
    from deeplearning4j_tpu.streaming import broker as B
    return B, S, R


# ---- the wire ----------------------------------------------------------------

@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_sample_frames_cross_the_tcp_broker_both_ways(server_side):
    """Each package publishes through a client of the other's broker;
    each package's consumer reads every frame, bitwise."""
    B, S, R = _jax()
    server = (B.TcpTransport(registry=R()) if server_side == "jax"
              else TcpTransport(registry=MetricsRegistry())).serve()
    clients = {"jax": B.TcpTransport(port=server.port, registry=R()),
               "port": TcpTransport(port=server.port,
                                    registry=MetricsRegistry())}
    rng = np.random.default_rng(0)
    sent = [_batch(rng, 3), _batch(rng, 2, (4, 4, 2)), _batch(rng, 5)]
    try:
        for writer, reader, pub, unpack in (
                ("jax", "port", S.publish_samples, unpack_samples),
                ("port", "jax", publish_samples, S.unpack_samples)):
            for x, y in sent:
                pub(clients[writer], f"t-{writer}", x, y)
            consumer = (NDArrayConsumer if reader == "port"
                        else B.NDArrayConsumer)(clients[reader],
                                                f"t-{writer}")
            for x, y in sent:
                msg = consumer.poll(timeout=5)
                assert msg is not None
                assert msg.key == pack_samples(x, y)[1]
                ds = unpack(msg.array, msg.key)
                np.testing.assert_array_equal(ds.features, x)
                np.testing.assert_array_equal(ds.labels, y)
                assert ds.features.dtype == np.float32
            assert consumer.poll(timeout=0.05) is None
    finally:
        for c in clients.values():
            c.close()
        server.close()


def test_raw_payloads_and_idle_polls_match_jax():
    """Arbitrary payload bytes pass through either broker unchanged, and
    an idle poll returns None after its timeout in both."""
    B, _, R = _jax()
    payloads = [b"", b"x", bytes(range(256)) * 40]
    for server in (B.TcpTransport(registry=R()).serve(),
                   TcpTransport(registry=MetricsRegistry()).serve()):
        try:
            port_c = TcpTransport(port=server.port,
                                  registry=MetricsRegistry())
            jax_c = B.TcpTransport(port=server.port, registry=R())
            for p in payloads[1:]:
                port_c.publish("raw", p)
            got = [jax_c.poll("raw", timeout=5) for _ in payloads[1:]]
            assert got == payloads[1:]
            t0 = time.perf_counter()
            assert port_c.poll("raw", timeout=0.1) is None
            assert time.perf_counter() - t0 < 5
            port_c.close()
            jax_c.close()
        finally:
            server.close()


def test_frames_are_the_jax_package_bytes():
    from deeplearning4j_tpu.streaming.serde import NDArrayMessage as JMsg
    from deeplearning4j_tpu_torch.streaming import NDArrayMessage
    _, S, _ = _jax()
    x, y = _batch(np.random.default_rng(1), 4, (2, 3))
    packed, key = pack_samples(x, y)
    jpacked, jkey = S.pack_samples(x, y)
    assert key == jkey == "2,3"
    np.testing.assert_array_equal(packed, jpacked)
    ts = 1_700_000_000_000_000_000          # the header's timestamp
    assert NDArrayMessage(packed, key, ts).to_bytes() == \
        JMsg(jpacked, jkey, ts).to_bytes()


# ---- the stream --------------------------------------------------------------

def _publish_sequence(publish, malformed, transport):
    rng = np.random.default_rng(2)
    for i in range(11):
        publish(transport, "t", *_batch(rng, int(rng.integers(1, 6))))
        if i == 4:
            malformed(transport)


def test_stream_batches_holdout_and_malformed_match_jax():
    B, S, R = _jax()
    runs = []
    for pub, Transport, Stream, Reg, Pub in (
            (publish_samples, InProcessTransport, SampleStreamIterator,
             MetricsRegistry, NDArrayPublisher),
            (S.publish_samples, B.InProcessTransport,
             S.SampleStreamIterator, R, B.NDArrayPublisher)):
        transport = Transport(registry=Reg())

        def malformed(t, Pub=Pub):
            Pub(t, "t").publish(np.zeros((2, 4), np.float32), key="999")
            Pub(t, "t").publish(np.zeros((2, 4), np.float32), key="x,y")
        _publish_sequence(pub, malformed, transport)
        reg = Reg()
        stream = Stream(transport, "t", holdout_every=3, holdout_max=7,
                        max_batches=11, poll_timeout_s=0.05, registry=reg)
        trained = list(stream)
        snap = stream.holdout_snapshot()
        view = list(stream.holdout_view(batch_size=2))
        runs.append((trained, snap, view, stream.malformed,
                     stream.batches_consumed, stream.samples_consumed,
                     stream.holdout_examples,
                     reg.get_metric("dl4j_online_stream_malformed_total")
                     .get(topic="t")))
    (t_tr, t_snap, t_view, *t_counts), (j_tr, j_snap, j_view, *j_counts) \
        = runs
    assert t_counts == j_counts and t_counts[0] == 2
    assert len(t_tr) == len(j_tr) == 11 - 11 // 3
    for a, b in zip(t_tr + t_view + [t_snap], j_tr + j_view + [j_snap]):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert t_snap.num_examples() == t_counts[-2] > 0


def test_unpack_refuses_a_key_that_disagrees():
    packed, _ = pack_samples(np.zeros((2, N_IN), np.float32),
                             np.zeros((2, 3), np.float32))
    for key in (str(N_IN + 3), "not-a-shape", "0"):
        with pytest.raises(ValueError):
            unpack_samples(packed, key)
    with pytest.raises(ValueError):
        unpack_samples(np.zeros(4, np.float32), "2")
    with pytest.raises(ValueError):
        SampleStreamIterator(InProcessTransport(), "t", holdout_every=1)


def test_stream_reset_is_a_no_op_and_stop_ends_iteration():
    transport = InProcessTransport()
    stream = SampleStreamIterator(transport, "t", poll_timeout_s=0.02,
                                  registry=MetricsRegistry())
    stream.reset()
    got = []

    def consume():
        for ds in stream:
            got.append(ds)
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    publish_samples(transport, "t", *_batch(np.random.default_rng(0), 2))
    deadline = time.time() + 10
    while not got and time.time() < deadline:
        time.sleep(0.01)
    stream.stop()
    t.join(5)
    assert not t.is_alive() and len(got) == 1
    assert stream.batch_size is None


# ---- transports --------------------------------------------------------------

def test_bounded_publish_sheds_and_counts():
    reg = MetricsRegistry()
    t = InProcessTransport(max_queue=2, put_timeout_s=0.01, registry=reg)
    for i in range(5):
        t.publish("q", bytes([i]))
    assert t.dropped == 3
    assert reg.get_metric("dl4j_stream_dropped_total").get(topic="q") == 3.0
    assert [t.poll("q", timeout=0.1) for _ in range(3)] == \
        [b"\x00", b"\x01", None]


def test_reconnect_after_broker_restart():
    srv = TcpTransport().serve()
    port = srv.port
    reg = MetricsRegistry()
    client = TcpTransport(port=port, backoff_base_s=0.01,
                          backoff_max_s=0.05, registry=reg)
    a = np.arange(4, dtype=np.float32)
    NDArrayPublisher(client, "x").publish(a, key="k")
    consumer = TcpTransport(port=port)
    assert NDArrayConsumer(consumer, "x").poll(timeout=2) is not None
    consumer.close()
    srv.close()
    srv2 = TcpTransport(port=port).serve()
    client._sock.close()
    try:
        NDArrayPublisher(client, "x").publish(a, key="k2")
        consumer2 = TcpTransport(port=port)
        msg = NDArrayConsumer(consumer2, "x").poll(timeout=2)
        assert msg is not None and msg.key == "k2"
        consumer2.close()
        assert client.reconnects >= 1
        assert reg.get_metric("dl4j_stream_reconnects_total").get(
            endpoint=f"127.0.0.1:{port}", op="publish") >= 1.0
    finally:
        client.close()
        srv2.close()


@pytest.mark.parametrize("reconnect", [True, False])
def test_nothing_listening_raises_connection_error(reconnect):
    client = TcpTransport(port=1, reconnect=reconnect, max_retries=2,
                          backoff_base_s=0.005, backoff_max_s=0.01,
                          registry=MetricsRegistry())
    t0 = time.perf_counter()
    with pytest.raises(ConnectionError,
                       match="2 reconnect" if reconnect else "0 reconnect"):
        client.publish("x", b"payload")
    assert time.perf_counter() - t0 < 5.0
    assert client.reconnects == (2 if reconnect else 0)


def test_route_moves_arrays_and_survives_a_bad_message():
    client = NDArrayStreamingClient()
    route = (Route(client.transport).from_topic("in")
             .process(lambda a: a * 2).process(lambda a: a + 1)
             .to_topic("out").start())
    try:
        pub, out = client.publisher("in"), client.consumer("out")
        pub.publish(np.arange(3, dtype=np.float32), key="a")
        client.transport.publish("in", b"not a frame")
        pub.publish(np.ones(2, np.float32), key="b")
        got = [out.poll(timeout=5) for _ in range(2)]
        assert [m.key for m in got] == ["a", "b"]
        np.testing.assert_array_equal(got[0].array, [1, 3, 5])
        np.testing.assert_array_equal(got[1].array, [3, 3])
        deadline = time.time() + 5
        while route.errors < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert route.processed == 2 and route.errors == 1
        assert out.poll_batch(3, timeout=0.02) == []
    finally:
        route.stop()
    with pytest.raises(ValueError):
        Route(client.transport).start()
