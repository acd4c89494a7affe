"""The Pulsar transport on the CPU: the port's adapter and its per-message
receive paths against the JAX package, over ``tests/torch_fake_pulsar.py``
(the pulsar-client 3.x surface, installed as ``sys.modules["pulsar"]``).

Every compared value is equal (tolerance 0): registers, counters,
PFCOUNTs and stored rows. The ``fused`` runs of both packages go over the
faithful fake, with every frame published before ``run(max_events=...)``
so that neither loop meets an idle receive. JAX's bridge and processor
fill micro-batches with ``collect_batch``, whose last partial batch ends
on a receive timeout that JAX catches only as its memory broker's
``ReceiveTimeout`` (the first departure below): their JAX references run
JAX's adapter over a memory-broker-backed fake instead (the construction
of ``tests/test_adapters.py``).

The departures, each with the smallest input that splits the packages:
(1) pulsar-client raises its own ``Timeout`` from ``receive``: the port's
adapter raises ``ReceiveTimeout`` and its runs end by idle, JAX's raise;
(2) a pulsar ``Message`` gives its id as a method, a new bound method
each delivery: the port keys poison attempts by ``MessageId.serialize()``
and dead-letters after ``max_redeliveries`` nacks, JAX only at its
backstop; (3) ``--chaos`` with the pulsar transport: the port's
``Config`` refuses it, JAX turns the fault plane off with a warning.
"""

import importlib
import logging
import sys
import types
from datetime import datetime

import numpy as np
import pytest

import attendance_tpu.transport.pulsar_client as jax_pc
import torch_fake_pulsar as fake_mod
from attendance_tpu import chaos as jchaos, obs as jobs
from attendance_tpu.config import Config as JConfig
from attendance_tpu.pipeline.bridge import (
    BINARY_TOPIC_SUFFIX as J_SUFFIX, JsonBinaryBridge as JBridge)
from attendance_tpu.pipeline.fast_path import FusedPipeline as JPipeline
from attendance_tpu.pipeline.processor import (
    AttendanceProcessor as JProcessor)
from attendance_tpu.transport import (
    PoisonTracker as JTracker, collect_batch as jcollect_batch,
    handle_poison as jhandle_poison, make_client as jmake_client)
from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.cli import main as cli_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models.fused import state_to_numpy
from attendance_tpu_torch.pipeline.bridge import (
    BINARY_TOPIC_SUFFIX, JsonBinaryBridge)
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.generator import generate_student_data
from attendance_tpu_torch.pipeline.lanes import StripedConsumer
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.pipeline.processor import AttendanceProcessor
from attendance_tpu_torch.transport import (
    PoisonTracker, acknowledge_all, collect_batch, handle_poison,
    make_client, message_id)
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient, ReceiveTimeout)
from attendance_tpu_torch.transport.pulsar_client import PulsarConsumer
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

NOW = datetime(2026, 3, 4, 12, 0, 0)
PORT_URL = "pulsar://port:6650"
JAX_URL = "pulsar://jax:6650"
POISON = b"\x00 not a frame"


@pytest.fixture(autouse=True)
def _reset_globals():
    for pkg in (chaos, obs, jchaos, jobs):
        pkg.disable()
    yield
    for pkg in (chaos, obs, jchaos, jobs):
        pkg.disable()


@pytest.fixture
def fake(monkeypatch):
    """The faithful fake as ``pulsar`` (a 10 ms nack delay), and JAX's
    adapter module reloaded over it."""
    monkeypatch.setitem(sys.modules, "pulsar", fake_mod)
    monkeypatch.setattr(fake_mod, "NACK_DELAY_MS", 10)
    fake_mod.reset()
    importlib.reload(jax_pc)
    assert jax_pc.HAVE_PULSAR
    yield fake_mod
    fake_mod.reset()
    monkeypatch.delitem(sys.modules, "pulsar")
    importlib.reload(jax_pc)


def _memory_backed_pulsar():
    """``tests/test_adapters.py``'s fake: pulsar's module shape over a
    JAX memory broker (its consumers keep the broker's batch calls and
    attribute-shaped messages)."""
    from attendance_tpu.transport.memory_broker import (
        MemoryBroker as JBroker, MemoryClient as JClient)

    mod = types.ModuleType("pulsar")

    class ConsumerType:
        Exclusive = "Exclusive"
        Shared = "Shared"
        Failover = "Failover"

    class Client:
        def __init__(self, service_url):
            self._inner = JClient(JBroker())

        def create_producer(self, topic):
            return self._inner.create_producer(topic)

        def subscribe(self, topic, subscription_name, consumer_type=None):
            return self._inner.subscribe(topic, subscription_name)

        def close(self):
            self._inner.close()

    mod.ConsumerType = ConsumerType
    mod.Client = Client
    return mod


@pytest.fixture
def jax_memory_adapter(fake):
    """A factory of JAX's adapter over the memory-backed fake (its
    reference where the faithful fake stops a JAX run, departure 1),
    while ``pulsar`` stays the faithful fake for the port."""
    def make():
        saved = jax_pc._pulsar
        jax_pc._pulsar = _memory_backed_pulsar()
        try:
            return jax_pc.PulsarClient(JConfig().pulsar_host)
        finally:
            jax_pc._pulsar = saved
    return make


def _port_client():
    return make_client(Config(transport_backend="pulsar",
                              pulsar_host=PORT_URL))


def _frames(num_events=12_000, frame=3000, **kw):
    kw = dict(dict(roster_size=2000, num_lectures=6, invalid_fraction=0.2,
                   seed=17), **kw)
    roster, frames = generate_frames(num_events, frame, **kw)
    return roster, list(frames)


def _json_stream(num_students=60, seed=9):
    """The reference generator's per-event JSON wire: (roster, payloads)."""
    sent = []

    class Sink:
        def send(self, data, properties=None):
            sent.append(bytes(data))

    report = generate_student_data(producer=Sink(), num_students=num_students,
                                   num_invalid=6, seed=seed, now=NOW,
                                   keep_events=False)
    return np.array(sorted(report.valid_student_ids), np.uint32), sent


# -- the state a run leaves ---------------------------------------------------

def _state(pipe, jax=False):
    """Counters, PFCOUNTs, registers by day and stored rows sorted by
    (day, micros, student): comparable across bank orders."""
    regs = np.asarray(pipe.state.hll_regs) if jax else \
        state_to_numpy(pipe.state)[1]
    by_day = {d: regs[b].tobytes() for d, b in pipe._bank_of.items()}
    cols = pipe.store.to_columns(deduplicate=False)
    cols = {k: np.asarray(cols[k]) for k in
            ("student_id", "lecture_day", "micros", "is_valid")}
    order = np.lexsort((cols["student_id"], cols["micros"],
                        cols["lecture_day"]))
    rows = {k: v[order].tolist() for k, v in cols.items()}
    return (tuple(pipe.validity_counts()), pipe.count_all(), by_day, rows)


def _exact_state(pipe, jax=False):
    """The whole state in bank order (same-order runs): filter words,
    registers, counters, the bank map and the stored rows in order."""
    if jax:
        arrays = [np.asarray(a) for a in (
            pipe.state.bloom_bits, pipe.state.hll_regs, pipe.state.counts)]
    else:
        arrays = list(state_to_numpy(pipe.state))
    cols = pipe.store.to_columns(deduplicate=False)
    rows = [np.asarray(cols[k]).tolist() for k in
            ("student_id", "lecture_day", "micros", "is_valid")]
    return ([a.tobytes() for a in arrays], dict(pipe._bank_of),
            tuple(pipe.validity_counts()), pipe.count_all(), rows)


def _drive(pipe, roster, payloads, **run_kw):
    pipe.preload(roster)
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    for p in payloads:
        producer.send(p)
    pipe.run(**run_kw)
    return pipe


# -- the adapter -------------------------------------------------------------

def test_adapter_shared_default_forwarding_and_close_equal_jax(fake):
    """``make_client(Config(transport_backend="pulsar"))`` in both
    packages: the service URL, the Shared default, send/receive, a nack
    redelivered with its count raised, and close."""
    seen = {}
    for name, client in (("port", make_client(Config(
            transport_backend="pulsar"))), ("jax", jmake_client(
                JConfig(transport_backend="pulsar")))):
        topic = f"t-{name}"
        cons = client.subscribe(topic, "sub")
        prod = client.create_producer(topic)
        assert fake.subscription_type(topic, "sub",
                                      Config().pulsar_host) == "Shared"
        prod.send(b"hello", properties={"k": "v"})
        msg = cons.receive(timeout_millis=100)
        first = (msg.data(), msg.properties(), msg.redelivery_count())
        cons.negative_acknowledge(msg)
        again = cons.receive(timeout_millis=2000)
        second = (again.data(), again.redelivery_count(),
                  again.message_id() == msg.message_id())
        assert fake.pending(topic, "sub") == 1
        cons.acknowledge(again)
        assert fake.pending(topic, "sub") == 0
        client.close()
        with pytest.raises(fake.AlreadyClosed):
            cons.receive(timeout_millis=10)
        seen[name] = (first, second)
    assert seen["port"] == seen["jax"] == (
        (b"hello", {"k": "v"}, 0), (b"hello", 1, True))
    assert JConfig().pulsar_host == Config().pulsar_host


def test_the_adapter_keeps_the_per_message_surface(fake):
    cons = _port_client().subscribe("t", "s")
    assert isinstance(cons, PulsarConsumer)
    for name in ("receive_many", "receive_many_raw", "receive_chunk",
                 "acknowledge_many", "backlog"):
        assert not hasattr(cons, name), name
    assert cons.subscription_name() == "s"  # passed through


def test_without_pulsar_both_raise_the_same_runtime_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "pulsar", None)  # import fails
    importlib.reload(jax_pc)
    try:
        with pytest.raises(RuntimeError) as jexc:
            jmake_client(JConfig(transport_backend="pulsar"))
        with pytest.raises(RuntimeError) as texc:
            make_client(Config(transport_backend="pulsar"))
        assert str(texc.value) == str(jexc.value) == (
            "transport_backend='pulsar' requires the pulsar-client package")
        with pytest.raises(RuntimeError, match="pulsar-client"):
            cli_main(["fused", "--transport-backend", "pulsar", "--device",
                      "cpu", "--num-events", "4096"])
    finally:
        monkeypatch.delitem(sys.modules, "pulsar")
        importlib.reload(jax_pc)


def test_pulsar_flags_reach_the_config(fake):
    from attendance_tpu_torch.cli import build_parser
    from attendance_tpu_torch.cli import _transport_config
    for verb in ("fused", "generate", "process", "pipeline", "bridge",
                 "federate"):
        args = build_parser().parse_args(
            [verb, "--transport-backend", "pulsar", "--pulsar-host",
             "pulsar://h:1"])
        cfg = Config(**_transport_config(args))
        assert (cfg.transport_backend, cfg.pulsar_host) == (
            "pulsar", "pulsar://h:1"), verb


def test_helpers_fall_back_to_per_message_calls(fake):
    client = _port_client()
    cons = client.subscribe("t", "s")
    prod = client.create_producer("t")
    for i in range(5):
        prod.send(b"%d" % i)
    msgs = collect_batch(cons, 3, 1.0)
    assert [m.data() for m in msgs] == [b"0", b"1", b"2"]
    # A redelivery keeps its id: keyed by MessageId.serialize().
    ids = [message_id(m) for m in msgs]
    assert all(isinstance(i, bytes) for i in ids) and len(set(ids)) == 3
    with pytest.raises(TypeError):
        hash(msgs[0].message_id())  # MessageId is not hashable
    cons.negative_acknowledge(msgs[0])
    # The nacked message comes back after its delay, behind what was
    # queued: a new Message object with the same id.
    rest = collect_batch(cons, 3, 2.0)
    assert [m.data() for m in rest] == [b"3", b"4", b"0"]
    again = rest[-1]
    assert again is not msgs[0] and again.redelivery_count() == 1
    assert message_id(again) == ids[0]
    acknowledge_all(cons, msgs[1:] + rest)
    assert fake.pending("t", "s") == 0
    assert collect_batch(cons, 8, 0.02) == []  # quiet: ends on the timeout


def test_memory_consumers_keep_their_batch_calls():
    """A consumer with the batch calls is served by them alone."""
    client = MemoryClient(MemoryBroker())
    inner = client.subscribe("t", "s")
    client.create_producer("t").send(b"x")
    calls = []

    class Batching:
        def receive_many(self, n, timeout_millis=None):
            calls.append("receive_many")
            return inner.receive_many(n, timeout_millis=timeout_millis)

        def acknowledge_many(self, msgs):
            calls.append("acknowledge_many")
            inner.acknowledge_many(msgs)

    got = collect_batch(Batching(), 4, 0.02)
    acknowledge_all(Batching(), got)
    assert [m.data() for m in got] == [b"x"]
    assert set(calls) == {"receive_many", "acknowledge_many"}
    assert inner.backlog() == 0
    assert message_id(got[0]) == got[0].message_id


# -- fused -------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["word", "bytes"])
def test_fused_over_the_adapter_equals_jax_and_the_memory_broker(
        fake, wire, monkeypatch):
    """The fused path's per-message receive over pulsar-client's surface
    (no chunk consumer), equal to JAX's ``fused`` over the same fake and
    to the port over its memory broker."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    roster, frames = _frames()
    n = 12_000
    jpipe = JPipeline(JConfig(bloom_filter_capacity=3000, wire_format=wire,
                              transport_backend="pulsar", pulsar_host=JAX_URL),
                      num_banks=8)
    tpipe = FusedPipeline(Config(bloom_filter_capacity=3000, wire_format=wire,
                                 transport_backend="pulsar",
                                 pulsar_host=PORT_URL),
                          num_banks=8, device="cpu")
    mpipe = FusedPipeline(Config(bloom_filter_capacity=3000, wire_format=wire),
                          client=MemoryClient(MemoryBroker()), num_banks=8,
                          device="cpu")
    try:
        assert isinstance(tpipe.consumer, PulsarConsumer)
        for pipe in (jpipe, tpipe, mpipe):
            _drive(pipe, roster, frames, max_events=n, idle_timeout_s=0.3)
        topic, sub = Config().pulsar_topic, FusedPipeline.SUBSCRIPTION
        assert fake.pending(topic, sub, PORT_URL) == 0
        assert fake.pending(topic, sub, JAX_URL) == 0
        assert tpipe.metrics.wire_dwell == {wire: 4} \
            == jpipe.metrics.wire_dwell
        ours = _exact_state(tpipe)
        assert ours == _exact_state(jpipe, jax=True)
        assert ours == _exact_state(mpipe)
        assert sum(ours[2]) == n
    finally:
        for pipe in (jpipe, tpipe, mpipe):
            pipe.cleanup()


@pytest.mark.parametrize("stream", ["frames", "json"])
def test_lanes_over_the_adapter_equal_the_one_consumer_run(fake, stream):
    """``--ingress-lanes 2`` over pulsar-client's surface (the lanes'
    Message path) equals the one-consumer run; on the JSON wire a poison
    payload dead-letters in both, after ``max_redeliveries`` nacks."""
    if stream == "frames":
        roster, payloads = _frames()
    else:
        roster, payloads = _json_stream()
        payloads.insert(7, POISON)
    states = []
    for i, lanes in enumerate((0, 2)):
        url = f"pulsar://lanes-{i}:6650"
        pipe = FusedPipeline(Config(bloom_filter_capacity=3000,
                                    transport_backend="pulsar",
                                    pulsar_host=url, ingress_lanes=lanes,
                                    max_redeliveries=2, batch_size=512),
                             num_banks=8, device="cpu")
        try:
            _drive(pipe, roster, payloads, idle_timeout_s=1.0)
            assert isinstance(pipe.consumer, StripedConsumer) == bool(lanes)
            if lanes:
                totals = pipe.consumer.lane_event_totals()
                assert sum(totals) == sum(states[0][0])
                with pytest.raises(NotImplementedError):
                    pipe.consumer.backlog()
            else:
                assert pipe.metrics.dead_lettered == (stream == "json")
            states.append(_state(pipe))
        finally:
            pipe.cleanup()
        assert fake.pending(Config().pulsar_topic, FusedPipeline.SUBSCRIPTION,
                            url) == 0
    assert states[0] == states[1]


def test_bridge_then_fused_over_the_adapter_equals_jax(
        fake, jax_memory_adapter):
    """The bridge's Message path (per-message payloads, acks and poison
    probe) then ``fused`` on ``<topic>-binary``, all over the adapter,
    equal to JAX's bridge and ``fused`` over its adapter on the
    memory-backed fake (JAX's bridge ends its last partial batch on a
    receive timeout, which over the faithful fake it does not catch)."""
    roster, payloads = _json_stream(num_students=80)
    payloads.insert(11, POISON)
    good = len(payloads) - 1
    results = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            client = _port_client()
            topic = Config().pulsar_topic
            pipe = FusedPipeline(Config(pulsar_topic=topic
                                        + BINARY_TOPIC_SUFFIX),
                                 client=client, num_banks=8, device="cpu")
            bridge = JsonBinaryBridge(Config(batch_size=64,
                                             max_redeliveries=2),
                                      client=client)
        else:
            client = jax_memory_adapter()
            topic = JConfig().pulsar_topic
            pipe = JPipeline(JConfig(pulsar_topic=topic + J_SUFFIX),
                             client=client, num_banks=8)
            bridge = JBridge(JConfig(batch_size=64, max_redeliveries=2),
                             client=client)
        try:
            producer = client.create_producer(topic)
            for p in payloads:
                producer.send(p)
            bridge.run(idle_timeout_s=1.0)
            pipe.preload(roster)
            pipe.run(max_events=good, idle_timeout_s=1.0)
            results.append((bridge.metrics.events,
                            bridge.metrics.dead_lettered,
                            _state(pipe, jax=pkg == "jax")))
        finally:
            pipe.cleanup()
            bridge.cleanup()
    assert results[0] == results[1]
    assert results[0][:2] == (good, 1)
    assert fake.pending(Config().pulsar_topic, JsonBinaryBridge.SUBSCRIPTION,
                        Config().pulsar_host) == 0


def _sketch_by_key(sketch):
    """Roster filter bytes and each key's registers (bank order aside)."""
    blooms = {k: [np.asarray(getattr(f, "cpu", lambda: f)()).tobytes()
                  for f in c.filters] for k, c in sketch._blooms.items()}
    if hasattr(sketch, "_hll"):
        regs = np.asarray(getattr(sketch._hll.regs, "cpu",
                                  lambda: sketch._hll.regs)())
        hll = {k: regs[b].tobytes() for k, b in sketch._hll._bank_of.items()}
    else:
        hll = {k: np.asarray(v).tobytes()
               for k, v in sketch._hll_regs.items()}
    return blooms, hll


@pytest.mark.parametrize("sketch", ["memory", "tpu"])
def test_process_over_the_adapter_equals_jax(fake, jax_memory_adapter,
                                             sketch):
    """The processor's micro-batches by per-message receives over the
    adapter, equal to JAX's processor over its adapter on the
    memory-backed fake: rows, PFCOUNTs, BF.INFO, filters and registers."""
    out = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            cfg = Config(sketch_backend=sketch, bloom_filter_capacity=400,
                         batch_size=128, transport_backend="pulsar")
            proc = AttendanceProcessor(cfg, client=_port_client(),
                                       device="cpu")
            gen = generate_student_data
        else:
            from attendance_tpu.pipeline.generator import (
                generate_student_data as gen)
            cfg = JConfig(sketch_backend=sketch, bloom_filter_capacity=400,
                          batch_size=128)
            proc = JProcessor(cfg, client=jax_memory_adapter())
        try:
            proc.setup_bloom_filter()
            report = gen(producer=proc.client.create_producer(
                cfg.pulsar_topic), sketch_store=proc.sketch,
                num_students=150, num_invalid=15, seed=9, now=NOW,
                keep_events=False)
            proc.process_attendance(max_events=report.message_count,
                                    idle_timeout_s=0.3)
            m = proc.metrics
            rows = [(r.student_id, r.timestamp, r.lecture_id, r.is_valid,
                     r.event_type) for r in proc.store.scan_all()]
            lids = proc.store.distinct_lecture_ids()
            out.append(((m.events, m.valid_events, m.invalid_events,
                         m.dead_lettered), rows,
                        {lid: proc.get_attendance_stats(lid)[
                            "unique_attendees"] for lid in lids},
                        proc.sketch.execute_command("BF.INFO",
                                                    cfg.bloom_filter_key),
                        _sketch_by_key(proc.sketch)))
        finally:
            proc.cleanup()
    assert out[0] == out[1]
    assert out[0][0][0] > 1000 and len(out[0][2]) > 1
    assert fake.pending(Config().pulsar_topic,
                        AttendanceProcessor.SUBSCRIPTION,
                        Config().pulsar_host) == 0


def test_pipeline_verb_runs_over_the_adapter(fake, caplog):
    caplog.set_level(logging.INFO)
    cli_main(["pipeline", "--transport-backend", "pulsar", "--device",
              "cpu", "--num-students", "60", "--seed", "0",
              "--sketch-backend", "memory"])
    assert any("unique attendees" in r.getMessage() for r in caplog.records)


# -- the departures ----------------------------------------------------------

def test_departure_timeout_quiet_stream(fake, monkeypatch):
    """(1) A consumer that goes quiet: the port's ``collect_batch`` ends
    the batch and its ``fused`` run ends by ``idle_timeout_s`` with the
    memory broker's state; JAX's raise the fake's ``Timeout``."""
    quiet = _port_client().subscribe("quiet", "s")
    assert collect_batch(quiet, 4, 0.02) == []
    with pytest.raises(ReceiveTimeout):
        quiet.receive(timeout_millis=5)
    jquiet = jmake_client(JConfig(transport_backend="pulsar",
                                  pulsar_host=JAX_URL)).subscribe("quiet", "s")
    with pytest.raises(fake.Timeout):
        jcollect_batch(jquiet, 4, 0.02)

    monkeypatch.setenv("ATP_NATIVE", "0")
    roster, frames = _frames(6000, 3000)
    tpipe = FusedPipeline(Config(bloom_filter_capacity=3000,
                                 transport_backend="pulsar",
                                 pulsar_host=PORT_URL), num_banks=8,
                          device="cpu")
    mpipe = FusedPipeline(Config(bloom_filter_capacity=3000),
                          client=MemoryClient(MemoryBroker()), num_banks=8,
                          device="cpu")
    jpipe = JPipeline(JConfig(bloom_filter_capacity=3000,
                              transport_backend="pulsar",
                              pulsar_host=JAX_URL), num_banks=8)
    try:
        _drive(tpipe, roster, frames, idle_timeout_s=0.2)
        _drive(mpipe, roster, frames, idle_timeout_s=0.2)
        assert _exact_state(tpipe) == _exact_state(mpipe)
        assert tpipe.metrics.events == 6000
        with pytest.raises(fake.Timeout):
            _drive(jpipe, roster, frames, idle_timeout_s=0.2)
        assert jpipe.metrics.events == 6000  # the stream went through
    finally:
        for pipe in (tpipe, mpipe, jpipe):
            pipe.cleanup()


def test_departure_message_id_poison_bound(fake, monkeypatch):
    """(2) One undecodable frame among good ones, ``max_redeliveries=2``:
    the port's ``fused`` run nacks it exactly twice and dead-letters it
    (its good frames' state equals a clean run's). JAX's
    ``handle_poison`` keys its tracker by ``msg.message_id``, a new bound
    method each delivery, and over the same fake dead-letters only at its
    backstop: after 8 nacks (measured here)."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    roster, frames = _frames(6000, 2000)
    tpipe = FusedPipeline(Config(bloom_filter_capacity=3000,
                                 transport_backend="pulsar",
                                 pulsar_host=PORT_URL, max_redeliveries=2),
                          num_banks=8, device="cpu")
    clean = FusedPipeline(Config(bloom_filter_capacity=3000),
                          client=MemoryClient(MemoryBroker()), num_banks=8,
                          device="cpu")
    try:
        _drive(tpipe, roster, frames[:1] + [POISON] + frames[1:],
               idle_timeout_s=1.0)
        _drive(clean, roster, frames, max_events=6000, idle_timeout_s=0.3)
        m = tpipe.metrics
        assert (m.nacked_batches, m.dead_lettered) == (2, 1)
        assert fake.pending(Config().pulsar_topic, FusedPipeline.SUBSCRIPTION,
                            PORT_URL) == 0
        assert _exact_state(tpipe) == _exact_state(clean)
    finally:
        tpipe.cleanup()
        clean.cleanup()

    log = logging.getLogger("pulsar-departure")
    nacks = {}
    for pkg, client, policy, tracker, cfg in (
            ("port", _port_client(), handle_poison, PoisonTracker(),
             Config(max_redeliveries=2)),
            ("jax", jmake_client(JConfig(transport_backend="pulsar",
                                         pulsar_host=JAX_URL)),
             jhandle_poison, JTracker(), JConfig(max_redeliveries=2))):
        cons = client.subscribe("poison", "s")
        client.create_producer("poison").send(POISON)
        metrics = types.SimpleNamespace(nacked_batches=0, dead_lettered=0)
        while not metrics.dead_lettered:
            policy(cons.receive(timeout_millis=2000), cons, metrics, cfg,
                   log, tracker=tracker)
        nacks[pkg] = metrics.nacked_batches
        client.close()
    assert nacks == {"port": 2, "jax": 8}


def test_departure_chaos_with_pulsar(fake, caplog):
    """(3) ``--chaos`` with the pulsar transport: the port refuses it at
    ``Config``; JAX's ``make_client`` returns the bare client and turns
    the fault plane off with a warning."""
    with pytest.raises(ValueError, match="pulsar"):
        Config(chaos="drop=0.1", transport_backend="pulsar")
    with pytest.raises(ValueError, match="pulsar"):
        Config(chaos="off", transport_backend="pulsar")
    # The shm ring carries its own faults whatever the broker backend.
    Config(chaos="drop=0.1", transport_backend="pulsar", ingress_wire="shm",
           shm_dir="/nonexistent")
    caplog.set_level(logging.WARNING)
    jclient = jmake_client(JConfig(chaos="drop=0.1",
                                   transport_backend="pulsar"))
    assert isinstance(jclient, jax_pc.PulsarClient)
    assert any("--chaos is not supported on the pulsar backend"
               in r.getMessage() for r in caplog.records)
    # An injector another config installed in this process is refused too.
    chaos.ensure(Config(chaos="drop=0.1"))
    with pytest.raises(RuntimeError, match="fault plane"):
        make_client(Config(transport_backend="pulsar"))


def test_gossip_aggregator_polls_a_per_message_consumer(fake):
    """The federation aggregator's receive round over pulsar-client's
    surface: per-message receives, a quiet round folds nothing."""
    from attendance_tpu_torch.federation.gossip import Aggregator

    client = _port_client()
    agg = Aggregator(client=client, topic="gossip", num_shards=1)
    try:
        assert agg.poll(timeout_ms=20) == 0
        client.create_producer("gossip").send(b"\x00rotten")
        assert agg.poll(timeout_ms=200) == 0  # never folded
    finally:
        agg.stop()
        client.close()
