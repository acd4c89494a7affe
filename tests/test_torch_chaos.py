"""The port's fault-injection plane and the persist sink's circuit
breaker, on the CPU, held against the JAX package.

The spec grammar accepts and rejects what JAX's does; one spec and seed
give both injectors the same schedule draw for draw, and the same
``corrupt_transform`` bytes. Then the cases of ``tests/test_chaos.py``
on the port: the socket transport
heals injected and real severs (reconnect, session resume, requeued
in-flight, ``BrokerUnavailable`` after the budget), the breaker's state
machine and its durable spill (in order, adopted across a restart,
drained by ``close``), ``wrap_store``'s layers, the shm ring's
``torn_slot`` and ``writer_stall``, the snapshot writer's bounded backoff
under ``snap_fail``, a persist failure with no spill (nacked, then
dead-lettered, as in JAX), the chaos chokepoints of ``make_client``, the
bridge, the processor and the federation worker, the doctor's quarantine,
reconnect and circuit rows, and a small soak under each JAX soak spec,
its doctor step included. Tolerance 0 throughout.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from attendance_tpu import chaos as jchaos
from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.obs import slo as jslo
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.storage import resilient as jresilient
from attendance_tpu.transport.memory_broker import (
    MemoryBroker as JaxBroker, MemoryClient as JaxClient)
from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.chaos import soak
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs.slo import doctor_report, parse_slo
from attendance_tpu_torch.pipeline.events import decode_binary_batch
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.storage import resilient, wrap_store
from attendance_tpu_torch.storage.resilient import (
    CLOSED, HALF_OPEN, OPEN, CircuitBreaker, ResilientEventStore)
from attendance_tpu_torch.transport import make_client
from attendance_tpu_torch.transport import socket_broker as tsock
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.transport.resilience import (
    BrokerUnavailable, RetryPolicy)
from attendance_tpu_torch.transport.shm_ring import (
    ShmClient, ShmRingConsumer, ShmRingProducer)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

SPECS = [
    "drop=0.01,delay=5ms:0.05,dup=0.005,conn_reset=0.002,"
    "persist_fail=0.01,writer_stall=200ms:0.01,corrupt=0.001",
    "snap_fail=0.01,disk_corrupt=0.01,torn_write=0.01,enospc=0.01,"
    "partition=2s:0.005,torn_slot=0.01",
    soak.DEFAULT_SPEC, soak.ROT_SPEC, "off", "",
    " drop = 0.5 , delay=250us:1", "writer_stall=1.5:0.3,,",
]
BAD = ["bogus=0.1", "drop=1.5", "drop", "delay=0.05",
       "writer_stall=abc:0.1", "drop=-0.1", "drop=x", "delay=5ms:2",
       "partition=5 ms:0.1"]


@pytest.fixture(autouse=True)
def _reset_globals():
    for pkg in (chaos, obs, jchaos, jobs):
        pkg.disable()
    yield
    for pkg in (chaos, obs, jchaos, jobs):
        pkg.disable()


@pytest.fixture
def server():
    s = tsock.BrokerServer().start()
    yield s
    s.stop()


# -- spec grammar and the seeded schedule -------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_equal_to_jax(spec):
    got = dataclasses.asdict(chaos.ChaosSpec.parse(spec))
    assert got == dataclasses.asdict(jchaos.ChaosSpec.parse(spec))
    assert Config(chaos=spec).chaos == spec


@pytest.mark.parametrize("bad", BAD)
def test_spec_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as jerr:
        jchaos.ChaosSpec.parse(bad)
    with pytest.raises(ValueError) as err:
        chaos.ChaosSpec.parse(bad)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError):
        Config(chaos=bad)


def test_spec_off_and_empty():
    off = chaos.ChaosSpec.parse("off")
    assert not any(off.active(f) for f in (
        "drop", "dup", "conn_reset", "persist_fail", "corrupt",
        "snap_fail", "delay", "writer_stall", "partition", "torn_slot"))
    assert chaos.ChaosSpec.parse("") == off
    assert chaos.ensure(Config()) is None
    inj = chaos.ensure(Config(chaos="off", chaos_seed=3))
    assert inj is not None and inj.seed == 3 and chaos.get() is inj
    assert chaos.ensure(Config(chaos="drop=1.0")) is inj  # process-global
    chaos.disable()
    assert chaos.get() is None


def _draws(inj, site, fault, n=400):
    """The injector's answers at one (site, fault), one call kind a
    fault: what the fault points ask."""
    if fault == "delay":
        return [inj.delay_s(site) for _ in range(n)]
    if fault == "writer_stall":
        return [inj.stall_s(site) for _ in range(n)]
    if fault == "coin":
        return [inj.coin(site, "conn_reset") for _ in range(n)]
    return [inj.roll(site, fault) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 7, 101, 2**31 + 5])
def test_schedule_equals_jax_draw_for_draw(seed):
    spec = ("drop=0.3,delay=3ms:0.2,dup=0.1,conn_reset=0.25,"
            "persist_fail=0.15,writer_stall=30ms:0.1,snap_fail=0.1,"
            "corrupt=0.05,disk_corrupt=0.08,torn_write=0.04,enospc=0.5,"
            "torn_slot=0.3")
    inj = chaos.ChaosInjector(chaos.ChaosSpec.parse(spec), seed)
    jinj = jchaos.ChaosInjector(jchaos.ChaosSpec.parse(spec), seed)
    # Interleaved over sites and faults: each pair's stream is its own.
    for site, fault in [("socket.produce", "drop"),
                        ("socket.consume", "conn_reset"),
                        ("socket.consume", "coin"),
                        ("socket.consume.lane3", "drop"),
                        ("transport.produce", "dup"),
                        ("transport.consume", "corrupt"),
                        ("transport.consume", "delay"),
                        ("persist.insert", "persist_fail"),
                        ("snapshot.writer", "writer_stall"),
                        ("snapshot.writer", "snap_fail"),
                        ("disk.chain", "disk_corrupt"),
                        ("disk.manifest", "torn_write"),
                        ("disk.chain", "enospc"), ("shm.slot", "torn_slot"),
                        ("socket.produce", "drop")]:
        assert _draws(inj, site, fault) == _draws(jinj, site, fault), (
            site, fault)
    assert inj.injected == jinj.injected
    assert inj.injected_total() == jinj.injected_total() > 0


def test_streams_deterministic_and_independent():
    spec = chaos.ChaosSpec.parse("drop=0.1,conn_reset=0.1")
    a = chaos.ChaosInjector(spec, seed=7)
    b = chaos.ChaosInjector(spec, seed=7)
    c = chaos.ChaosInjector(spec, seed=8)
    seq_a = [a.roll("socket.produce", "drop") for _ in range(500)]
    assert seq_a == [b.roll("socket.produce", "drop") for _ in range(500)]
    assert sum(seq_a) > 10
    assert [b.roll("socket.consume", "drop") for _ in range(500)] != seq_a
    assert [c.roll("socket.produce", "drop") for _ in range(500)] != seq_a
    assert a.injected[("socket.produce", "drop")] == sum(seq_a)


def test_partition_windows_equal_jax():
    inj = chaos.ChaosInjector(chaos.ChaosSpec.parse("partition=80ms:1.0"),
                              seed=7)
    jinj = jchaos.ChaosInjector(
        jchaos.ChaosSpec.parse("partition=80ms:1.0"), seed=7)
    for x in (inj, jinj):
        assert x.blackhole("fed.gossip") and x.blackhole("fed.gossip")
        assert x.in_blackhole("fed.gossip")
        assert not x.in_blackhole("transport.consume")
    time.sleep(0.1)
    assert not inj.in_blackhole("fed.gossip")
    assert inj.blackhole("fed.gossip") and jinj.blackhole("fed.gossip")
    assert inj.injected == jinj.injected == {("fed.gossip", "partition"): 2}
    quiet = chaos.ChaosInjector(chaos.ChaosSpec.parse("drop=0.5"), 7)
    assert not quiet.blackhole("fed.gossip")


def test_corrupt_bytes_equal_jax_and_undecodable():
    _, frames = generate_frames(512, 512, roster_size=64, num_lectures=2,
                                seed=0)
    frame = next(iter(frames))
    for data in (frame, b'{"a": 1}', b"12345678", b"123456789", b"x"):
        assert (chaos.ChaosInjector.corrupt_transform(data)
                == jchaos.ChaosInjector.corrupt_transform(data))
        # Involutive: a soak recognizes a corrupted poison frame.
        assert chaos.ChaosInjector.corrupt_transform(
            chaos.ChaosInjector.corrupt_transform(data)) == data
    inj = chaos.ChaosInjector(chaos.ChaosSpec.parse("corrupt=1.0"), 3)
    bad = inj.corrupt_bytes("transport.consume", frame)
    assert bad != frame
    with pytest.raises(Exception):
        decode_binary_batch(bad)
    quiet = chaos.ChaosInjector(chaos.ChaosSpec.parse("off"), 3)
    assert quiet.corrupt_bytes("transport.consume", frame) is frame


def test_proxy_mirrors_the_consumers_capabilities():
    """hasattr feature detection answers for the real backend: the
    port's consumers read the chunk lane, a bare consumer has none."""
    inj = chaos.ChaosInjector(chaos.ChaosSpec.parse("off"), 0)

    class Bare:
        def receive(self, timeout_millis=None):
            raise NotImplementedError

    wrapped = chaos.ChaosConsumer(Bare(), inj)
    assert hasattr(wrapped, "receive")
    assert not hasattr(wrapped, "receive_chunk")
    assert not hasattr(wrapped, "receive_many_raw")
    client = chaos.ChaosClient(MemoryClient(MemoryBroker()), inj)
    consumer = client.subscribe("t", "s")
    lane = client.subscribe_lane("t", "s", 1)  # memory: no lane API
    for c in (consumer, lane):
        assert isinstance(c, chaos.ChaosConsumer)
        for name in ("receive_chunk", "receive_many", "receive_many_raw",
                     "acknowledge_chunk", "explode_chunk"):
            assert hasattr(c, name), name
    client.create_producer("t").send(b"m")
    cid, toks = consumer.receive_chunk(4, timeout_millis=500)
    assert [bytes(t[1]) for t in toks] == [b"m"]
    consumer.acknowledge_chunk(cid)


def test_producer_dup_and_consumer_corrupt_through_the_proxies():
    broker = MemoryBroker()
    inj = chaos.ChaosInjector(chaos.ChaosSpec.parse("dup=1.0,corrupt=1.0"),
                              seed=5)
    wrapped = chaos.ChaosClient(MemoryClient(broker), inj)
    producer = wrapped.create_producer("t")
    consumer = wrapped.subscribe("t", "s")
    producer.send(b"payload-1")
    producer.send_many([b"payload-2"])
    got = consumer.receive_many(8, timeout_millis=500)
    want = chaos.ChaosInjector.corrupt_transform
    assert sorted(m.data() for m in got) == sorted(
        [want(b"payload-1")] * 2 + [want(b"payload-2")] * 2)
    # The broker kept the clean bytes: a nack redelivers them clean.
    clean = MemoryClient(broker).subscribe("t", "s2")
    assert sorted(m.data() for m in clean.receive_many(
        8, timeout_millis=500)) == sorted([b"payload-1"] * 2
                                          + [b"payload-2"] * 2)


def test_consume_side_partition_is_silence_not_loss():
    from attendance_tpu_torch.transport.memory_broker import ReceiveTimeout

    client = MemoryClient(MemoryBroker())
    inj = chaos.ChaosInjector(chaos.ChaosSpec.parse("partition=150ms:1.0"),
                              seed=5)
    wrapped = chaos.ChaosClient(client, inj)
    producer = wrapped.create_producer("t")
    consumer = wrapped.subscribe("t", "s")
    producer.send(b"payload")
    with pytest.raises(ReceiveTimeout):
        consumer.receive(timeout_millis=50)  # inside the window
    with pytest.raises(ReceiveTimeout):
        consumer.receive_chunk(4, timeout_millis=50)
    # Healed: the blackholed message was never lost, only unseen.
    consumer._inj = chaos.ChaosInjector(chaos.ChaosSpec.parse("off"), 5)
    assert bytes(consumer.receive(timeout_millis=1000).data()) == b"payload"


# -- the self-healing socket transport ----------------------------------------

def _socket_pair(server, **client_kwargs):
    client = tsock.SocketClient(server.address, **client_kwargs)
    return client, client.create_producer("t"), client.subscribe("t", "s")


def test_transient_reset_is_invisible(server):
    """Both channels severed mid-stream: the producer reconnects, the
    consumer resumes its session, every message arrives, the backlog
    settles and no caller sees an error."""
    client, producer, consumer = _socket_pair(server)
    got = []
    for i in range(40):
        producer.send(b"m%d" % i)
        if i in (10, 25):
            producer._rpc._sever_locked()
            consumer._rpc._sever_locked()
        msg = consumer.receive(timeout_millis=5000)
        got.append(msg.data())
        consumer.acknowledge(msg)
    assert {b"m%d" % i for i in range(40)} <= set(got)
    assert producer._rpc.reconnects >= 1
    assert consumer.resubscribes >= 1
    deadline = time.monotonic() + 5
    while consumer.backlog() and time.monotonic() < deadline:
        try:
            consumer.acknowledge(consumer.receive(timeout_millis=200))
        except Exception:  # noqa: BLE001 — drained
            break
    assert consumer.backlog() == 0
    client.close()


def test_reconnect_requeues_inflight_for_the_resumed_session(server):
    client, producer, consumer = _socket_pair(server)
    for i in range(8):
        producer.send(b"x%d" % i)
    first = consumer.receive(timeout_millis=5000)  # prefetches the rest
    assert consumer._buffered
    consumer.acknowledge(first)
    consumer._rpc._sever_locked()  # the connection drops, 7 in flight
    got = set()
    deadline = time.monotonic() + 10
    while len(got) < 7 and time.monotonic() < deadline:
        msg = consumer.receive(timeout_millis=5000)
        got.add(msg.data())
        consumer.acknowledge(msg)
    assert got == {b"x%d" % i for i in range(1, 8)}
    assert consumer.resubscribes >= 1
    client.close()


def test_broker_unavailable_after_the_budget(server, monkeypatch):
    client, producer, _ = _socket_pair(
        server, policy=RetryPolicy(budget_s=0.6, base_s=0.02))
    producer.send(b"ok")

    def refuse(self):
        raise ConnectionRefusedError("broker is gone")

    monkeypatch.setattr(tsock._Rpc, "reconnect", refuse)
    producer._rpc._sever_locked()
    t0 = time.monotonic()
    with pytest.raises(BrokerUnavailable) as ei:
        producer.send(b"never")
    assert isinstance(ei.value, ConnectionError)
    assert 0.3 <= time.monotonic() - t0 < 10.0
    client.close()


def test_injected_conn_reset_and_drop_self_heal(server):
    """Injected conn_reset (both directions) and drop at the socket
    seams: every message survives and the channels reconnected."""
    obs.enable(Config(metrics_port=-1))
    inj = chaos.ChaosInjector(
        chaos.ChaosSpec.parse("conn_reset=0.05,drop=0.05,delay=1ms:0.05"),
        seed=11)
    client = tsock.SocketClient(server.address, chaos=inj)
    producer = client.create_producer("t2")
    consumer = client.subscribe("t2", "s2")
    n = 120
    for i in range(n):
        producer.send(b"p%d" % i)
    got = set()
    deadline = time.monotonic() + 30
    while len(got) < n and time.monotonic() < deadline:
        try:
            msg = consumer.receive(timeout_millis=1000)
        except Exception:  # noqa: BLE001 — a timeout between faults
            continue
        got.add(msg.data())
        consumer.acknowledge(msg)
    assert got == {b"p%d" % i for i in range(n)}
    sites = {site for site, _ in inj.injected}
    assert {"socket.produce", "socket.consume"} <= sites
    assert inj.injected_total("conn_reset") > 0
    assert inj.injected_total("drop") > 0
    assert soak.counter_total(obs.get().registry,
                              "attendance_reconnects_total") > 0
    client.close()


def test_query_client_heals_injected_faults_at_serve_query(tmp_path):
    """``QueryClient(chaos=)``: drop, delay and conn_reset (both wire
    directions) at ``serve.query`` are retried on the query's retry
    seam, and every answer equals the in-process engine's."""
    from attendance_tpu_torch.serve.rpc import QueryClient

    roster, frames = _frames()
    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(
        Config(bloom_filter_capacity=5000, serve_port=-1,
               snapshot_dir=str(tmp_path / "s")),
        client=client, num_banks=4, device="cpu")
    try:
        pipe.preload(roster)
        producer = client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=8192, idle_timeout_s=0.3)
        engine = pipe.query_engine
        inj = chaos.ChaosInjector(chaos.ChaosSpec.parse(
            "conn_reset=0.2,drop=0.2,delay=1ms:0.2"), seed=5)
        qc = QueryClient(pipe.query_server.address, chaos=inj,
                         batch_max=500)
        days = pipe.lecture_days()
        probes = np.concatenate([roster[:1500], np.arange(
            1 << 31, (1 << 31) + 1500, dtype=np.uint32)])
        for _ in range(5):
            np.testing.assert_array_equal(qc.bf_exists(probes),
                                          engine.bf_exists(probes))
            assert qc.pfcount(days).tolist() == \
                engine.pfcount(days).tolist()
        assert {site for site, _ in inj.injected} == {"serve.query"}
        assert inj.injected_total("conn_reset") > 0
        assert inj.injected_total("drop") > 0
        qc.close()
    finally:
        pipe.cleanup()


def test_maybe_wrap_follows_the_installed_injector():
    inner = MemoryClient(MemoryBroker())
    assert chaos.maybe_wrap(inner) is inner
    inj = chaos.ensure(Config(chaos="off"))
    wrapped = chaos.maybe_wrap(inner)
    assert isinstance(wrapped, chaos.ChaosClient)
    assert wrapped._inner is inner and wrapped._inj is inj


def test_make_client_is_the_chaos_chokepoint(server, tmp_path):
    assert isinstance(make_client(Config()), MemoryClient)
    cfg = Config(chaos="off", transport_backend="socket",
                 socket_broker=server.address)
    client = make_client(cfg)
    inj = chaos.get()
    assert isinstance(client, chaos.ChaosClient)
    assert isinstance(client._inner, tsock.SocketClient)
    assert client._inner._rpc._chaos is inj
    lane = client.subscribe_lane("t", "s", 2)
    assert isinstance(lane, chaos.ChaosConsumer)
    assert lane._inner._rpc._site == "socket.consume.lane2"
    assert lane._inner._rpc._chaos is inj
    client.close()
    assert isinstance(make_client(Config(chaos="off")), chaos.ChaosClient)
    # The shm ring carries its faults in the producer, unwrapped.
    shm = make_client(Config(chaos="off", ingress_wire="shm",
                             shm_dir=str(tmp_path)))
    assert isinstance(shm, ShmClient) and shm._chaos is inj
    prod = shm.create_producer("t")
    assert prod._chaos is inj
    shm.close()


# -- the shm ring's fault sites -----------------------------------------------

def _ring_pair(tmp_path, inj, *, nslots=4, slot_bytes=8192):
    path = tmp_path / "t.lane0.ring"
    return (ShmRingProducer(path, nslots=nslots, slot_bytes=slot_bytes,
                            chaos=inj),
            ShmRingConsumer(path, nslots=nslots, slot_bytes=slot_bytes))


def test_torn_slot_is_retried_and_never_delivered(tmp_path):
    """torn_slot=1.0: every publish leaves its slot visibly mid-write
    for a beat; the concurrent reader retries and delivers every frame
    whole."""
    inj = chaos.ChaosInjector(chaos.ChaosSpec.parse("torn_slot=1.0"), 7)
    prod, cons = _ring_pair(tmp_path, inj)
    n = 24
    got = []

    def consume():
        for _ in range(n):
            m = cons.receive(timeout_millis=2000)
            got.append(bytes(m.data()))
            cons.acknowledge(m)

    t = threading.Thread(target=consume)
    t.start()
    want = []
    for i in range(n):
        body = bytes([i % 251]) * 4000
        want.append(body)
        prod.send(body)
    t.join(timeout=30)
    assert got == want
    assert inj.injected_total("torn_slot") == n
    assert cons.torn_reads > 0
    prod.close()
    cons.close()


def test_writer_stall_stalls_and_never_corrupts(tmp_path):
    inj = chaos.ChaosInjector(chaos.ChaosSpec.parse("writer_stall=30ms:1.0"),
                              seed=7)
    prod, cons = _ring_pair(tmp_path, inj, nslots=8, slot_bytes=4096)
    t0 = time.monotonic()
    for i in range(3):
        prod.send(b"stalled-%d" % i)
    assert time.monotonic() - t0 >= 0.09
    got = []
    for _ in range(3):
        m = cons.receive(timeout_millis=2000)
        got.append(bytes(m.data()))
        cons.acknowledge(m)
    assert got == [b"stalled-%d" % i for i in range(3)]
    assert inj.injected_total("writer_stall") == 3
    prod.close()
    cons.close()


# -- the circuit breaker and its spill ----------------------------------------

class _FlakySink:
    """insert_* fails while self.down; records committed batches."""

    def __init__(self):
        self.down = False
        self.columns = []
        self.rows = []

    def insert_columns(self, cols):
        if self.down:
            raise RuntimeError("sink down")
        self.columns.append(cols)

    def insert_batch(self, rows):
        if self.down:
            raise RuntimeError("sink down")
        self.rows.append(rows)

    def close(self):
        pass


def _cols(tag):
    return {"student_id": np.array([tag]), "lecture_day": np.array([1]),
            "micros": np.array([tag]), "is_valid": np.array([True]),
            "event_type": np.array([0])}


def test_breaker_state_machine_equals_jax():
    clock = [0.0]
    b = CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                       clock=lambda: clock[0])
    jb = jresilient.CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                                   clock=lambda: clock[0])
    seen, jseen = [], []
    b.on_transition(seen.append)
    jb.on_transition(jseen.append)
    steps = [("allow", 0.0), ("fail", 0.0), ("fail", 0.0), ("allow", 0.5),
             ("allow", 1.5), ("fail", 1.5), ("allow", 2.0), ("allow", 3.1),
             ("ok", 3.1), ("allow", 3.1), ("fail", 3.2), ("ok", 3.2),
             ("fail", 4.0), ("fail", 4.0), ("allow", 4.5), ("allow", 5.0)]
    for op, now in steps:
        clock[0] = now
        out = []
        for x in (b, jb):
            if op == "allow":
                out.append(x.allow())
            elif op == "fail":
                x.record_failure()
            else:
                x.record_success()
            out.append((x.state, x.opened_total))
        assert out[:len(out) // 2] == out[len(out) // 2:], (op, now)
    assert seen == jseen == [OPEN, HALF_OPEN, OPEN, HALF_OPEN, CLOSED,
                             OPEN, HALF_OPEN]
    assert (CLOSED, OPEN, HALF_OPEN) == (jresilient.CLOSED, jresilient.OPEN,
                                         jresilient.HALF_OPEN)


def test_spill_and_drain_in_order(tmp_path):
    sink = _FlakySink()
    store = ResilientEventStore(
        sink, tmp_path / "spill",
        breaker=CircuitBreaker(failure_threshold=2, cooldown_s=0.05))
    store.insert_columns(_cols(0))
    sink.down = True
    for tag in (1, 2, 3):  # 1, 2 fail (open after 2), 3 short-circuits
        store.insert_columns(_cols(tag))
    assert store.breaker.state == "open"
    assert store.spill_pending == 3
    assert len(list((tmp_path / "spill").glob("spill-*.pkl"))) == 3
    sink.down = False
    time.sleep(0.06)  # the cooldown: the next write is the probe
    store.insert_columns(_cols(4))
    assert store.breaker.state == "closed" and store.spill_pending == 0
    assert [int(c["micros"][0]) for c in sink.columns] == [0, 1, 2, 3, 4]
    assert store.spilled_total == 3 and store.drained_total == 3


def test_spill_is_adopted_across_a_restart(tmp_path):
    sink = _FlakySink()
    sink.down = True
    store = ResilientEventStore(
        sink, tmp_path / "spill",
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=30.0))
    store.insert_columns(_cols(1))
    store.insert_columns(_cols(2))
    assert store.spill_pending == 2
    sink2 = _FlakySink()
    store2 = ResilientEventStore(sink2, tmp_path / "spill")
    assert store2.spill_pending == 2
    store2.insert_columns(_cols(3))
    assert [int(c["micros"][0]) for c in sink2.columns] == [1, 2, 3]
    assert store2.spill_pending == 0


def test_close_drains_the_spill_with_probes(tmp_path):
    sink = _FlakySink()
    sink.down = True
    store = ResilientEventStore(
        sink, tmp_path / "spill",
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=0.02))
    store.insert_batch(["row1"])
    assert store.spill_pending == 1
    assert not store.flush_spill(budget_s=0.1)  # still down: bounded
    sink.down = False
    store.close()
    assert sink.rows == [["row1"]] and store.spill_pending == 0


def test_spill_materializes_device_and_lazy_columns(tmp_path):
    """A fused frame's validity is a tensor (or the narrow wires' lazy
    view of one): the spill copies it to the host."""
    import torch

    from attendance_tpu_torch.pipeline.fast_path import _ScatterValidity

    sink = _FlakySink()
    sink.down = True
    store = ResilientEventStore(
        sink, tmp_path / "spill",
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=0.01))
    valid = torch.tensor([True, False, True, True])
    lazy = _ScatterValidity(valid, np.array([2, 0, 1]), 3)
    store.insert_columns({**_cols(1), "is_valid": valid})
    store.insert_columns({"student_id": np.arange(3), "is_valid": lazy})
    sink.down = False
    time.sleep(0.02)
    assert store.flush_spill(budget_s=5.0)
    assert [type(c["is_valid"]) for c in sink.columns] == [np.ndarray] * 2
    np.testing.assert_array_equal(sink.columns[0]["is_valid"],
                                  [True, False, True, True])
    np.testing.assert_array_equal(sink.columns[1]["is_valid"],
                                  [False, True, True])


def test_wrap_store_layers(tmp_path):
    sink = _FlakySink()
    assert wrap_store(sink, Config()) is sink
    chaos.ensure(Config(chaos="persist_fail=1.0", chaos_seed=1))
    cfg = Config(chaos="persist_fail=1.0", chaos_seed=1,
                 persist_spill_dir=str(tmp_path / "spill"),
                 persist_breaker_failures=1,
                 persist_breaker_cooldown_s=30.0)
    store = wrap_store(sink, cfg, sink="test")
    assert isinstance(store, ResilientEventStore)
    assert isinstance(store._inner, chaos.ChaosEventStore)
    assert store.breaker.failure_threshold == 1
    assert store.breaker.cooldown_s == 30.0
    store.insert_columns(_cols(1))  # injected failure -> spill, no raise
    assert store.spill_pending == 1 and sink.columns == []
    chaos.disable()
    # Chaos without persist_fail: no injection layer; no spill dir: raw.
    chaos.ensure(Config(chaos="drop=1.0"))
    assert wrap_store(sink, Config(chaos="drop=1.0")) is sink


def test_breaker_series_in_the_registry(tmp_path):
    t = obs.enable(Config(metrics_port=-1))
    sink = _FlakySink()
    store = ResilientEventStore(
        sink, tmp_path / "spill", sink="columnar",
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=0.01))
    sink.down = True
    store.insert_columns(_cols(1))
    sink.down = False
    time.sleep(0.02)
    store.insert_columns(_cols(2))
    samples = {(m.name, m.labels): m.value
               for _n, _k, _h, members in t.registry.collect()
               for m in members}
    assert samples[("attendance_circuit_state", (("sink", "columnar"),))] \
        == 0.0
    trans = {dict(labels)["to"]: v for (name, labels), v in samples.items()
             if name == "attendance_circuit_transitions_total"}
    assert trans == {"closed": 1.0, "open": 1.0, "half_open": 1.0}
    assert samples[("attendance_persist_spilled_batches_total",
                    (("sink", "columnar"),))] == 1.0


# -- the fused pipeline's seams -----------------------------------------------

def _frames(n=8192, batch=1024, seed=3):
    roster, frames = generate_frames(n, batch, roster_size=2000,
                                     num_lectures=4, seed=seed)
    return roster, list(frames)


def test_persist_fail_without_a_spill_follows_jax(tmp_path):
    """persist_fail with no spill dir: the insert's PersistFault reaches
    the run loop, which nacks the frame and dead-letters it after
    max_redeliveries, as JAX's does; both packages end equal."""
    roster, frames = _frames()
    results = []
    for pkg, cfg_cls, pipe_cls, client in (
            ("torch", Config, FusedPipeline, MemoryClient(MemoryBroker())),
            ("jax", JaxConfig, JaxPipeline, JaxClient(JaxBroker()))):
        (chaos if pkg == "torch" else jchaos).disable()
        cfg = cfg_cls(bloom_filter_capacity=5000, chaos="persist_fail=1.0",
                      chaos_seed=4, max_redeliveries=1,
                      quarantine_dir=str(tmp_path / pkg))
        kw = {"device": "cpu"} if pkg == "torch" else {}
        pipe = pipe_cls(cfg, client=client, num_banks=4, **kw)
        pipe.preload(roster)
        producer = client.create_producer(cfg.pulsar_topic)
        for f in frames[:3]:
            producer.send(f)
        pipe.run(idle_timeout_s=0.5)
        inj = (chaos if pkg == "torch" else jchaos).get()
        results.append((pipe.metrics.dead_lettered, pipe.metrics.events,
                        pipe.metrics.nacked_batches,
                        inj.injected_total("persist_fail"),
                        len(pipe.store.to_columns()["student_id"])
                        if pkg == "torch" else len(pipe.store.to_dataframe()),
                        sorted(pipe.count_all().items())))
        pipe.cleanup()
        (chaos if pkg == "torch" else jchaos).disable()
    assert results[0] == results[1]
    assert results[0][0] == 3 and results[0][4] == 0


def test_snapshot_writer_backoff_bounded_under_snap_fail(tmp_path):
    t = obs.enable(Config(metrics_port=-1))
    roster, frames = _frames()
    cfg = Config(bloom_filter_capacity=5000, chaos="snap_fail=1.0",
                 snapshot_dir=str(tmp_path / "snaps"),
                 snapshot_mode="delta", snapshot_every_batches=1,
                 metrics_port=-1)
    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(cfg, client=client, num_banks=4, device="cpu")
    try:
        pipe.preload(roster)
        assert pipe._writer_backoff_s() == 0.0
        job = dict(kind="base", msgs=[], events=0, bank_of={}, upto=None,
                   ready=None)
        for streak in (1, 2, 3):
            with pipe._snap_cv:
                pipe._snap_pending += 1
            pipe._run_snap_job_logged(dict(job))
            assert pipe._snap_fail_streak == streak
        assert pipe._base_stale and not pipe._writer_base_ok
        backs = []
        for streak in range(1, 20):
            pipe._snap_fail_streak = streak
            backs.append(pipe._writer_backoff_s())
        assert backs == sorted(backs) and backs[-1] == 5.0
        assert chaos.get().injected_total("snap_fail") == 3
        assert soak.counter_total(
            t.registry, "attendance_snapshot_write_failures_total") == 3
        # The fault healed: the next job runs, the streak resets.
        chaos.disable()
        pipe._chaos = None
        pipe._snap_fail_streak = 3
        pipe._run_snap_job = lambda job: None
        with pipe._snap_cv:
            pipe._snap_pending += 1
        pipe._run_snap_job_logged(dict(job))
        assert pipe._snap_fail_streak == 0
    finally:
        del pipe._run_snap_job
        pipe.cleanup()


def test_writer_stall_at_the_snapshot_writer(tmp_path):
    roster, frames = _frames()
    cfg = Config(bloom_filter_capacity=5000,
                 chaos="writer_stall=20ms:1.0",
                 snapshot_dir=str(tmp_path / "snaps"),
                 snapshot_every_batches=2)
    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(cfg, client=client, num_banks=4, device="cpu")
    pipe.preload(roster)
    producer = client.create_producer(cfg.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=len(frames) * 1024, idle_timeout_s=0.5)
    pipe.cleanup()
    # One stall a writer job, every job of the run.
    n = chaos.get().injected_total("writer_stall")
    assert n == len(pipe.metrics.snapshot_stalls) >= 2
    assert min(pipe.metrics.snapshot_stalls) >= 0.02
    restored = FusedPipeline(Config(bloom_filter_capacity=5000,
                                    snapshot_dir=cfg.snapshot_dir),
                             client=MemoryClient(MemoryBroker()),
                             num_banks=4, device="cpu")
    assert restored.count_all() == pipe.count_all()
    restored.cleanup()


def test_bridge_and_processor_install_the_plane(tmp_path):
    from attendance_tpu_torch.pipeline.bridge import JsonBinaryBridge
    from attendance_tpu_torch.pipeline.processor import AttendanceProcessor

    cfg = Config(chaos="delay=1ms:1.0,persist_fail=0.0", chaos_seed=2,
                 sketch_backend="memory",
                 persist_spill_dir=str(tmp_path / "spill"))
    bridge = JsonBinaryBridge(cfg)
    assert bridge._chaos is chaos.get() is not None
    assert isinstance(bridge.client, chaos.ChaosClient)
    bridge._forward([(1, b'{"student_id": 1}', 0, None)], [])
    assert chaos.get().injected[("bridge.forward", "delay")] == 1
    bridge.cleanup()
    proc = AttendanceProcessor(cfg, device="cpu")
    assert isinstance(proc.store, ResilientEventStore)
    assert proc.store._sink == "memory"
    proc.cleanup()


def test_worker_takes_chaos_flags():
    from attendance_tpu_torch.federation import worker

    args = worker.build_parser().parse_args(
        ["--worker", "w0", "--shard", "0", "--num-shards", "1", "--broker",
         "127.0.0.1:1", "--workdir", "w", "--chaos",
         "partition=1500ms:0.05", "--chaos-seed", "9"])
    assert (args.chaos, args.chaos_seed) == ("partition=1500ms:0.05", 9)
    cfg = worker.make_worker_config("w0", 0, 1, "127.0.0.1:1", "w",
                                    base_topic="t", chaos=args.chaos,
                                    chaos_seed=args.chaos_seed)
    assert (cfg.chaos, cfg.chaos_seed) == (args.chaos, 9)
    # The fleet pusher is ported too (it was refused before item 11d2).
    args = worker.build_parser().parse_args(
        ["--worker", "w0", "--shard", "0", "--num-shards", "1",
         "--broker", "b", "--workdir", "w", "--fleet-push", "x"])
    assert args.fleet_push == "x"


def test_gossip_blackhole_is_silent_and_the_full_frame_converges():
    from attendance_tpu_torch.federation.gossip import (
        Aggregator, FenceGossip)

    broker = MemoryBroker()
    agg = Aggregator(client=MemoryClient(broker), topic="g", num_shards=1,
                     dead_after_s=60, precision=14)
    cfg = Config(fed_worker="w0", fed_shard=0, fed_shards=1,
                 fed_gossip_topic="g", fed_heartbeat_s=0)
    fg = FenceGossip(cfg, client=MemoryClient(broker), m_bits=512, k=3)
    chaos.INJECTOR = chaos.ChaosInjector(
        chaos.ChaosSpec.parse("partition=10s:1.0"), seed=3)
    regs = np.ones((1, 1 << 14), np.uint8)
    counts = np.zeros((2, 2), np.uint32)
    # Blackholed: the publisher believes it sent, nothing arrives.
    assert fg.publish_delta(np.asarray([0], np.int32), regs, counts,
                            {5: 0}, 10, 1)
    assert agg.poll(timeout_ms=200) == 0
    assert chaos.get().injected_total("partition") == 1
    chaos.disable()
    assert fg.publish_full(np.arange(16, dtype=np.uint32), regs, counts,
                           {5: 0}, 10)
    assert agg.poll(timeout_ms=500) == 1
    assert 5 in agg.view.bank_of
    agg.stop()
    fg.close()


# -- the soak, small, on the CPU ----------------------------------------------

@pytest.mark.parametrize("spec", ["DEFAULT_SPEC", "ROT_SPEC", "SCRUB_SPEC"])
def test_soak_seeds_fire_every_gated_fault_early(spec):
    """The card phase's seed of each spec fires each fault its gates
    read within the draws any 128-frame soak makes at that site, so no
    gate passes with nothing to check; the streams are JAX's."""
    seed = soak.SEEDS[spec]
    jinj = jchaos.ChaosInjector(jchaos.ChaosSpec.parse(getattr(soak, spec)),
                                seed)
    for site, fault, run, draws in soak.GATED[spec]:
        at = soak.first_hit(getattr(soak, spec), seed, site, fault, run)
        assert at is not None and at < draws, (site, fault, at)
        hits = [jinj.roll(site, fault) for _ in range(at + 1)]
        assert hits[at - run + 1:] == [True] * run
        assert run > 1 or not any(hits[:at])


def _jax_no_fault(seed, cap, **shape):
    """The JAX package's FusedPipeline on the soak's frames, no faults:
    per-day PFCOUNTs, deduplicated and valid rows, filter words and
    each day's register row, as ``soak.sketch_state`` gives them."""
    roster, frames = soak.soak_frames(seed, shape["num_events"],
                                      shape["batch"], shape["roster_size"],
                                      shape["lectures"])
    client = JaxClient(JaxBroker())
    pipe = JaxPipeline(JaxConfig(bloom_filter_capacity=cap,
                                 transport_backend="memory"),
                       client=client, num_banks=shape["lectures"])
    try:
        pipe.preload(roster)
        producer = client.create_producer(pipe.config.pulsar_topic)
        for frame in frames:
            producer.send(frame)
        pipe.run(max_events=shape["num_events"], idle_timeout_s=2.0)
        days = sorted(int(d) for d in pipe.lecture_days())
        cols = pipe.store.to_columns()
        return {"counts": {d: pipe.count(d) for d in days},
                "rows": int(len(cols["student_id"])),
                "valid": int(np.asarray(cols["is_valid"]).sum()),
                # The port keeps the words as int32: the same bits.
                "bloom": np.asarray(pipe.state.bloom_bits).view(np.int32),
                "regs": {d: np.asarray(pipe.state.hll_regs[pipe._bank_of[d]])
                         for d in days}}
    finally:
        pipe.cleanup()


@pytest.mark.parametrize("spec,seed,restore", [
    ("DEFAULT_SPEC", soak.SEEDS["DEFAULT_SPEC"], False),
    ("ROT_SPEC", soak.SEEDS["ROT_SPEC"], True)])
def test_small_soak_ends_in_the_no_fault_state(tmp_path, spec, seed,
                                               restore):
    # 128 frames, as on the card, at the card's seeds: every fault a gate
    # reads fires (test_soak_seeds_fire_every_gated_fault_early). The
    # soak's own idle window: under ROT_SPEC an ENOSPC parks the writer
    # for the capped 5 s backoff, with the frames behind it unacked, and
    # a shorter window can end the run with the backlog still queued.
    shape = dict(num_events=8192, batch=64, roster_size=2000, lectures=4)
    want = soak.no_fault_state(seed, device="cpu", capacity=5000, **shape)
    # The ground truth is the JAX package's too, on the same frames.
    jax_want = _jax_no_fault(seed, 5000, **shape)
    assert soak.state_diff(jax_want, want) == []
    jchaos.disable()
    jobs.disable()
    report = soak.run_soak(
        seed, spec=getattr(soak, spec), workdir=tmp_path, device="cpu",
        capacity=5000, max_seconds=90.0, restore_check=restore, want=want,
        **shape)
    assert report["ok"], report["failures"]
    assert report["doctor_ok"] is True  # step 4: the run's own artifacts
    assert report["fault_run"] == report["no_fault"] == soak.summary(want)
    assert report["bloom_false_negatives"] == 0
    assert report["quarantined"] >= soak.POISON_FRAMES
    assert report["run_launches"]["fused_step"] == 0  # plain on the CPU
    if spec == "DEFAULT_SPEC":
        assert report["reconnects"] > 0 and report["circuit_opened"] > 0
        assert report["drained"] == report["spilled"] > 0
    else:
        # Whether any rot survives depends on where the writer's last
        # base falls (a base heals the rot before it): scrub must flag
        # all that does, and test_small_soak_rot_always_survives holds
        # the case where some always survives.
        assert report["disk_faults_injected"] > 0
        assert report["disk_rot_surviving"] == report["scrub_accounted"]
        assert report["partition_windows"] > 0
        assert report["enospc_hits"] > 0
        assert report["restored"] == report["no_fault"]
    assert chaos.get() is None and obs.get() is None


def test_small_soak_rot_always_survives(tmp_path):
    """``SCRUB_SPEC`` rots every chain write, so the last base, the
    deltas after it and the manifest are rotted whenever the run ends:
    scrub flags each, the repair ladder quarantines the rotted chain and
    rebuilds from the peer, and the restored state equals the no-fault
    run's."""
    shape = dict(num_events=8192, batch=64, roster_size=2000, lectures=4)
    seed = soak.SEEDS["SCRUB_SPEC"]
    want = soak.no_fault_state(seed, device="cpu", capacity=5000, **shape)
    # No transport fault and no ENOSPC park: the whole backlog is queued
    # before the run starts, so a 1 s idle window ends it.
    report = soak.run_soak(
        seed, spec=soak.SCRUB_SPEC, workdir=tmp_path, device="cpu",
        capacity=5000, max_seconds=90.0, idle_s=1.0, restore_check=True,
        want=want, **shape)
    assert report["ok"], report["failures"]
    assert report["doctor_ok"] is True
    assert report["fault_run"] == report["restored"] == soak.summary(want)
    assert report["disk_rot_surviving"] == report["scrub_accounted"] > 0
    assert report["chain_files_quarantined"] > 0
    assert chaos.get() is None and obs.get() is None


# -- the doctor over the fault plane's artifacts --------------------------------

def test_doctor_lists_and_replays_quarantine(tmp_path, capsys):
    """tests/test_chaos.py's quarantine listing and replay through the
    doctor verb, on the port: the same listing as JAX's verb, and the
    replayed frame on the memory transport's topic."""
    from attendance_tpu.cli import main as jax_main
    from attendance_tpu_torch import cli
    from attendance_tpu_torch.transport.quarantine import Quarantine

    qdir = tmp_path / "q"
    Quarantine(qdir).put(b"bad-frame", reason="poison-frame")
    cli.main(["doctor", "--quarantine", str(qdir)])
    out = capsys.readouterr().out
    assert "quarantined frames" in out and "poison-frame" in out
    jax_main(["doctor", "--quarantine", str(qdir)])
    assert capsys.readouterr().out == out
    MemoryBroker.reset_shared()
    cli.main(["doctor", "--quarantine", str(qdir), "--replay-quarantine",
              "--transport-backend", "memory", "--pulsar-topic",
              "replay-topic", "--purge-replayed"])
    assert "replayed 1 quarantined frame" in capsys.readouterr().out
    consumer = MemoryClient(MemoryBroker.shared()).subscribe(
        "replay-topic", "v")
    assert consumer.receive(timeout_millis=1000).data() == b"bad-frame"
    assert not list(qdir.glob("*.frame"))  # purged after the publish
    with pytest.raises(SystemExit) as e:
        cli.main(["doctor", "--replay-quarantine"])
    assert e.value.code == 2


def test_slo_alias_snapshot_failures():
    s = parse_slo("snapshot_failures<=0")
    assert s.metric == "attendance_snapshot_write_failures_total"
    assert s.kind == "counter" and s.threshold == 0.0
    assert s.__dict__ == jslo.parse_slo("snapshot_failures<=0").__dict__


def test_doctor_reconnect_and_circuit_rows(tmp_path):
    prom = tmp_path / "m.prom"
    prom.write_text(
        "# TYPE attendance_reconnects_total counter\n"
        "attendance_reconnects_total 4\n"
        "# TYPE attendance_circuit_state gauge\n"
        'attendance_circuit_state{sink="columnar"} 0\n')
    text, ok = doctor_report([str(prom)])
    assert (text, ok) == jslo.doctor_report([str(prom)])
    assert ok and "broker reconnects" in text and "info" in text
    assert "persist circuit state" in text
    # Gated: 4 reconnects > 2 fails.
    assert not doctor_report([str(prom)], max_reconnects=2)[1]
    # An open circuit at the last scrape is a breach.
    prom.write_text('attendance_circuit_state{sink="columnar"} 1\n')
    text, ok = doctor_report([str(prom)])
    assert not ok and (text, ok) == jslo.doctor_report([str(prom)])


@pytest.mark.parametrize("verb,chaos_flags,persist_flags", [
    ("fused", True, True), ("process", True, True),
    ("pipeline", True, True), ("generate", True, False),
    ("bridge", True, False), ("federate", True, False),
    ("serve", False, False), ("analyze", False, False)])
def test_fault_flags_only_on_verbs_that_read_them(verb, chaos_flags,
                                                  persist_flags):
    """``--chaos`` on the verbs that open a broker client, the persist
    sink's flags on those with a sink; elsewhere argparse refuses them."""
    from attendance_tpu_torch import cli

    parser = cli.build_parser()
    for flags, accepted in (
            (["--chaos", "drop=0.1", "--chaos-seed", "3"], chaos_flags),
            (["--persist-spill-dir", "sp", "--persist-breaker-failures",
              "2", "--persist-breaker-cooldown-s", "0.5"], persist_flags)):
        if accepted:
            args = parser.parse_args([verb] + flags)
            config = cli._transport_config(args)
            assert (config.get("chaos") == "drop=0.1"
                    or config.get("persist_spill_dir") == "sp")
        else:
            with pytest.raises(SystemExit):
                parser.parse_args([verb] + flags)


def test_fused_verb_under_chaos_with_a_spill(tmp_path, capsys):
    """``fused --chaos ... --persist-spill-dir ...``: the run ends with
    every event counted and the spill drained, equal to a run without
    faults; the verb's summary line is its last."""
    from attendance_tpu_torch import cli

    base = ["fused", "--device", "cpu", "--num-events", "32768",
            "--frame-size", "1024", "--num-lectures", "4",
            "--bloom-capacity", "20000"]
    cli.main(base)
    want = capsys.readouterr().out.splitlines()
    spill = tmp_path / "spill"
    # No dup: the verb stops at --num-events processed, and duplicates
    # would count toward it.
    cli.main(base + ["--chaos", "persist_fail=0.3,delay=1ms:0.1",
                     "--chaos-seed", "5", "--persist-spill-dir", str(spill),
                     "--persist-breaker-failures", "1",
                     "--persist-breaker-cooldown-s", "0.01"])
    got = capsys.readouterr().out.splitlines()
    assert [l for l in got if l.startswith("LECTURE_")] == [
        l for l in want if l.startswith("LECTURE_")]
    import json
    summary = json.loads(got[-1])
    assert summary["valid"] + summary["invalid"] == 32768
    assert not list(spill.glob("spill-*.pkl"))
    assert chaos.get() is not None  # the verb's process-global injector


@pytest.mark.parametrize("verb,accepted", [
    ("fused", True), ("process", True), ("pipeline", True),
    ("bridge", False), ("serve", False), ("federate", False),
    ("generate", False), ("analyze", False)])
def test_profile_dir_only_on_verbs_that_read_it(verb, accepted):
    """``--profile-dir`` on the verbs whose run is traced (the fused
    pipeline and the processor); elsewhere argparse refuses it, though
    those verbs take the other telemetry flags."""
    from attendance_tpu_torch import cli

    parser = cli.build_parser()
    flags = ["--profile-dir", "pd"]
    if accepted:
        args = parser.parse_args([verb] + flags)
        assert cli._telemetry_config(args)["profile_dir"] == "pd"
    else:
        with pytest.raises(SystemExit):
            parser.parse_args([verb] + flags)
    if verb in ("bridge", "serve", "federate"):
        args = parser.parse_args([verb, "--profile-hz", "97"])
        assert cli._telemetry_config(args)["profile_dir"] == ""
