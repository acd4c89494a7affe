"""The port's socket broker against the JAX package's, both ways on the
same wire: a port SocketClient on a JAX BrokerServer and a JAX
SocketClient on a port BrokerServer (produce, the raw and chunk lanes,
acks, nacks, crash takeover), the fused pipeline and the bridge over the
socket transport, and two port bridge processes competing on one
subscription. Every comparison is exact.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.pipeline import codec as jcodec
from attendance_tpu.pipeline.bridge import JsonBinaryBridge as JaxBridge
from attendance_tpu.transport import memory_broker as jbroker
from attendance_tpu.transport import socket_broker as jsock
from attendance_tpu.transport.memory_broker import (
    ReceiveTimeout as JaxReceiveTimeout)
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline import codec as tcodec
from attendance_tpu_torch.pipeline.bridge import JsonBinaryBridge
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.lanes import JsonChunkConsumer
from attendance_tpu_torch.transport import (
    BrokerUnavailable, ReceiveTimeout, make_client)
from attendance_tpu_torch.transport import socket_broker as tsock
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)

PKGS = {"jax": jsock, "torch": tsock}
PAIRS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
REPO = Path(__file__).resolve().parent.parent


def _payloads(n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10_000, 12_000, n)
    days = 20_260_701 + rng.integers(0, 4, n)
    secs = rng.integers(0, 86_400, n)
    return [json.dumps({
        "student_id": int(ids[i]),
        "timestamp": f"2026-07-14T{secs[i] // 3600:02d}:"
                     f"{secs[i] // 60 % 60:02d}:{secs[i] % 60:02d}",
        "lecture_id": f"LECTURE_{int(days[i])}",
        "is_valid": bool(i % 9), "event_type": "entry"}).encode()
        for i in range(n)]


@pytest.fixture(params=PAIRS, ids=[f"{s}-server-{c}-client"
                                   for s, c in PAIRS])
def pair(request):
    server_pkg, client_pkg = request.param
    server = PKGS[server_pkg].BrokerServer().start()
    clients = []

    def client():
        c = PKGS[client_pkg].SocketClient(server.address)
        clients.append(c)
        return c

    yield server, client
    for c in clients:
        c.close()
    server.stop()


def test_produce_receive_ack_nack_across_packages(pair):
    server, client = pair
    c = client()
    producer = c.create_producer("t")
    consumer = c.subscribe("t", "sub")
    mids = [producer.send(b"m%d" % i, {"i": str(i)} if i % 2 else None)
            for i in range(5)]
    assert mids == list(range(5))
    got = consumer.receive_many(3, timeout_millis=2000)
    assert [m.data() for m in got] == [b"m0", b"m1", b"m2"]
    assert [m.properties() for m in got] == [{}, {"i": "1"}, {}]
    consumer.acknowledge(got[0])
    consumer.negative_acknowledge(got[1])
    consumer.acknowledge_many(got[2:])
    rest = consumer.receive_many_raw(10, timeout_millis=2000)
    assert [(t[1], t[2]) for t in rest] == [(b"m3", 0), (b"m4", 0),
                                            (b"m1", 1)]
    assert consumer.backlog() == 3
    consumer.acknowledge_ids([t[0] for t in rest])
    assert consumer.backlog() == 0
    with pytest.raises((ReceiveTimeout, JaxReceiveTimeout)):
        consumer.receive(timeout_millis=50)


def test_chunk_lane_and_send_many_across_packages(pair):
    server, client = pair
    c = client()
    consumer = c.subscribe("t", "sub")
    first = c.create_producer("t").send_many(
        [b"x%d" % i for i in range(10)], [None] * 9 + [{"k": "v"}])
    assert first == 0
    cid, toks = consumer.receive_chunk(6, timeout_millis=2000)
    assert [t[1] for t in toks] == [b"x%d" % i for i in range(6)]
    consumer.nack_chunk(cid)
    cid2, toks2 = consumer.receive_chunk(10, timeout_millis=2000)
    assert [t[1] for t in toks2] == [b"x6", b"x7", b"x8", b"x9"] + [
        b"x%d" % i for i in range(6)]
    assert toks2[3][3] == {"k": "v"} and toks2[4][2] == 1
    consumer.explode_chunk(cid2)
    consumer.acknowledge_ids([t[0] for t in toks2[:-1]])
    assert consumer.backlog() == 1
    consumer.close()  # the last one returns to the subscription
    other = client().subscribe("t", "sub")
    cid3, toks3 = other.receive_chunk(10, timeout_millis=2000)
    assert [(t[1], t[2]) for t in toks3] == [(b"x5", 2)]
    other.acknowledge_chunk(cid3)
    assert other.backlog() == 0


def test_crash_takeover_across_packages(pair):
    server, client = pair
    victim, survivor = client(), client()
    producer = survivor.create_producer("t")
    cv = victim.subscribe("t", "shared")
    cs = survivor.subscribe("t", "shared")
    for i in range(4):
        producer.send(b"m%d" % i)
    assert len(cv.receive_many(2, timeout_millis=2000)) == 2
    cv._rpc.close()  # a dropped connection, as a crash drops it
    got, deadline = [], time.monotonic() + 5
    while len(got) < 4 and time.monotonic() < deadline:
        try:
            for m in cs.receive_many(4, timeout_millis=300):
                got.append(m.data())
                cs.acknowledge(m)
        except (ReceiveTimeout, JaxReceiveTimeout):
            pass
    assert sorted(got) == [b"m%d" % i for i in range(4)]
    assert server.consumer_count("t", "shared") == 1


def test_session_resumes_after_a_severed_connection():
    server = tsock.BrokerServer().start()
    client = tsock.SocketClient(server.address)
    try:
        consumer = client.subscribe("t", "s")
        producer = client.create_producer("t")
        producer.send(b"a")
        first = consumer.receive(timeout_millis=2000)
        consumer._rpc._sever_locked()  # the next call reconnects
        producer.send(b"b")
        # The old connection's thread requeues `a` on its own schedule,
        # so `b` may come first: collect until both or the deadline.
        got, deadline = [], time.monotonic() + 10
        while len(got) < 2 and time.monotonic() < deadline:
            try:
                got.extend(consumer.receive_many(5, timeout_millis=500))
            except ReceiveTimeout:
                pass
        assert consumer.resubscribes == 1
        assert sorted(m.data() for m in got) == [b"a", b"b"]
        assert first.data() == b"a"
        consumer.acknowledge_many(got)
        assert consumer.backlog() == 0
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_fused_pipeline_over_socket_equals_memory(server_pkg):
    """The fused pipeline fed per-event JSON through a socket broker
    (chunk consumer over the socket raw lane) lands in the state of the
    same stream through the in-process broker."""
    server = PKGS[server_pkg].BrokerServer().start()
    payloads = _payloads(900, seed=3)
    roster = np.arange(10_000, 11_500, dtype=np.uint32)
    pipes = []
    try:
        for backend in ("socket", "memory"):
            cfg = Config(bloom_filter_capacity=5000, batch_size=200,
                         transport_backend=backend,
                         socket_broker=server.address)
            pipe = FusedPipeline(
                cfg, num_banks=8, device="cpu",
                client=None if backend == "socket"
                else MemoryClient(MemoryBroker()))
            pipes.append(pipe)
            assert isinstance(pipe.consumer, JsonChunkConsumer)
            pipe.preload(roster)
            pipe.client.create_producer(cfg.pulsar_topic).send_many(
                payloads)
            pipe.run(max_events=len(payloads), idle_timeout_s=0.3)
            assert pipe.metrics.events == len(payloads)
            assert pipe.metrics.batches < len(payloads) / 4
        a, b = pipes
        assert a._bank_of == b._bank_of
        assert a.validity_counts() == b.validity_counts()
        assert a.count_all() == b.count_all()
        assert bool((a.state.hll_regs == b.state.hll_regs).all())
        assert a.consumer.backlog() == 0
    finally:
        for pipe in pipes:
            pipe.cleanup()
        server.stop()


def test_bridge_over_socket_equals_bridge_in_memory():
    """The port's bridge over the socket transport publishes the frames
    of the port's bridge and of the JAX bridge in memory."""
    server = tsock.BrokerServer().start()
    payloads = _payloads(700, seed=5)
    frames = {}
    try:
        for backend in ("socket", "memory", "jax"):
            if backend == "jax":
                cfg = JaxConfig(batch_size=128, transport_backend="memory")
                client = jbroker.MemoryClient(jbroker.MemoryBroker())
                bridge = JaxBridge(cfg, client=client)
            else:
                cfg = Config(batch_size=128, transport_backend=backend,
                             socket_broker=server.address)
                client = (make_client(cfg) if backend == "socket"
                          else MemoryClient(MemoryBroker()))
                bridge = JsonBinaryBridge(cfg, client=client)
            out = client.subscribe(bridge.out_topic, "probe")
            client.create_producer(cfg.pulsar_topic).send_many(payloads)
            bridge.run(idle_timeout_s=0.3)
            assert bridge.metrics.events == 700
            assert bridge.consumer.backlog() == 0
            got = out.receive_many(100, timeout_millis=2000)
            frames[backend] = tcodec.merge_columns(
                [tcodec.decode_frame(m.data()) for m in got])
            bridge.cleanup()
        assert set(frames["socket"]) == set(frames["jax"])
        for k in frames["jax"]:
            np.testing.assert_array_equal(frames["socket"][k],
                                          frames["memory"][k])
            np.testing.assert_array_equal(frames["socket"][k],
                                          frames["jax"][k])
    finally:
        server.stop()


def test_broker_process_then_broker_unavailable_when_it_dies():
    """``python -m attendance_tpu_torch.transport.socket_broker`` serves
    a client; once the process is gone, a publish retries for the
    configured budget and raises BrokerUnavailable."""
    proc, addr = tsock.spawn_broker(cwd=REPO)
    try:
        client = make_client(Config(transport_backend="socket",
                                    socket_broker=addr,
                                    retry_budget_s=0.3))
        consumer = client.subscribe("t", "s")
        producer = client.create_producer("t")
        producer.send(b"hello")
        assert consumer.receive(timeout_millis=5000).data() == b"hello"
    finally:
        proc.kill()
        proc.wait(timeout=10)
    t0 = time.monotonic()
    with pytest.raises(BrokerUnavailable):
        producer.send(b"lost")
    assert time.monotonic() - t0 < 5
    client.close()
    with pytest.raises(ValueError):
        Config(retry_budget_s=0)


def test_two_process_bridge_scaleout(tmp_path):
    """Two ``python -m attendance_tpu_torch bridge`` processes (torch and
    the port only) compete on one subscription of a port BrokerServer.
    Each stops after half the stream's events, so neither can take it
    all: both do work, every JSON message is converted exactly once,
    none is dead-lettered and the subscription drains.

    The subscription exists and holds the whole stream before either
    process starts, so neither's idle clock can run out while the other
    is still importing torch: each finds its half waiting."""
    server = tsock.BrokerServer().start()
    topic = Config().pulsar_topic
    n, batch = 1200, 50
    outs = [tmp_path / f"bridge{i}.jsonl" for i in range(2)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("ATP_NATIVE", None)
    procs = []
    try:
        probe = MemoryClient(server.broker).subscribe(topic + "-binary",
                                                      "probe")
        server.broker.topic(topic).subscription("attendance_bridge")
        payloads = _payloads(n, seed=41)
        server.broker.topic(topic).publish_many(payloads)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "attendance_tpu_torch", "bridge",
             "--transport-backend", "socket", "--socket-broker",
             server.address, "--batch-size", str(batch),
             "--max-events", str(n // 2), "--idle-timeout-s", "10",
             "--metrics-json", str(out)],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for out in outs]
        for p in procs:
            log = p.communicate(timeout=120)[0]
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    accounting = [json.loads(o.read_text()) for o in outs]
    assert sum(a["events"] for a in accounting) == n
    assert all(a["events"] > 0 for a in accounting), accounting
    assert all(a["dead_lettered"] == 0 for a in accounting)
    sub = server.broker.topic(topic).subscription("attendance_bridge")
    assert sub.backlog() == 0
    got = probe.receive_many(1000, timeout_millis=500)
    cols = tcodec.merge_columns([tcodec.decode_frame(m.data())
                                 for m in got])
    want = jcodec.get_codec("json").decode(payloads)
    order = np.lexsort((cols["micros"], cols["student_id"]))
    worder = np.lexsort((want["micros"], want["student_id"]))
    for k in want:
        np.testing.assert_array_equal(cols[k][order], want[k][worder])
