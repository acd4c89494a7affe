"""The port's striped ingress lanes against the JAX package's
(``tests/test_lanes.py``'s cases without its obs and chaos planes): the
reference JSON wire through 1, 2 and 4 lanes equal to the JAX striped
run and to the JAX one-consumer run, the binary and COLW wires, acks
held until their barrier is durable across lanes (and the port's
failed-write departure), lane poison, timeout and close, the decode
engines, and ``subscribe_lane`` with the port's lanes on a JAX
``BrokerServer`` and the JAX lanes on the port's. The state compared is
the counters, every lecture's registers (the bank numbering follows the
dispatch order, which lanes change), the PFCOUNTs and the stored rows
with their validity: tolerance 0.
"""

import functools
import json
import sys
import time

import numpy as np
import pytest

from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.transport import memory_broker as jbroker
from attendance_tpu.transport import socket_broker as jsock
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models.fused import state_to_numpy
from attendance_tpu_torch.pipeline import codec as tcodec
from attendance_tpu_torch.pipeline.events import decode_planar_batch
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.lanes import LaneMessage, StripedConsumer
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport import socket_broker as tsock
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient, ReceiveTimeout)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

ROSTER = np.random.default_rng(0).choice(
    np.arange(10_000, 60_000, dtype=np.uint32), 800, replace=False)
NJSON = 3000


def _json_payloads(n, roster, seed):
    """The reference wire: ``json.dumps`` of the generator's dict."""
    rng = np.random.default_rng(seed)
    ids = roster[rng.integers(0, len(roster), n)]
    ids[rng.random(n) < 0.1] += 100_000  # not on the roster
    days = 20_260_701 + rng.integers(0, 4, n)
    secs = rng.integers(0, 86_400, n)
    return [json.dumps({
        "student_id": int(ids[i]),
        "timestamp": f"2026-07-14T{secs[i] // 3600:02d}:"
                     f"{secs[i] // 60 % 60:02d}:{secs[i] % 60:02d}",
        "lecture_id": f"LECTURE_{int(days[i])}",
        "is_valid": bool(i % 7), "event_type": "entry"}).encode()
        for i in range(n)]


PAYLOADS = _json_payloads(NJSON, ROSTER, seed=1)


def _state(pipe):
    """Counters, PFCOUNTs, registers by lecture, the raw counters and the
    stored rows in a canonical order, of a port or a JAX pipeline."""
    if isinstance(pipe, FusedPipeline):
        _, regs, counts = state_to_numpy(pipe.state)
    else:
        regs, counts = (np.asarray(pipe.state.hll_regs),
                        np.asarray(pipe.state.counts))
    cols = pipe.store.to_columns(deduplicate=False)
    cols = {k: np.asarray(cols[k]) for k in
            ("student_id", "lecture_day", "micros", "is_valid")}
    order = np.lexsort((cols["student_id"], cols["micros"],
                        cols["lecture_day"]))
    return dict(valid=pipe.validity_counts(), pf=pipe.count_all(),
                regs={d: regs[b] for d, b in pipe._bank_of.items()},
                counts=np.asarray(counts),
                store={k: v[order] for k, v in cols.items()})


def _assert_same(got, want):
    assert got["valid"] == want["valid"]
    assert got["pf"] == want["pf"]
    assert got["regs"].keys() == want["regs"].keys()
    for d in want["regs"]:
        np.testing.assert_array_equal(got["regs"][d], want["regs"][d],
                                      err_msg=f"day {d}")
    np.testing.assert_array_equal(got["counts"], want["counts"])
    for k in want["store"]:
        np.testing.assert_array_equal(got["store"][k], want["store"][k],
                                      err_msg=k)


def _feed(pipe, roster, payloads=(), frames=(), max_events=None):
    """Preload, publish, run. A run bounded by ``max_events`` ends when
    they are in, so its idle clock only guards a hang: it gets 10 s, as
    lane threads under a loaded host can take more than 0.5 s to hand
    over their first decoded block."""
    pipe.preload(roster)
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    if payloads:
        producer.send_many(payloads)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=max_events,
             idle_timeout_s=0.5 if max_events is None else 10.0)
    return pipe


def _jax(payloads=(), frames=(), roster=ROSTER, client=None, **cfg):
    """The JAX pipeline's state on a stream (then cleaned up)."""
    pipe = JaxPipeline(JaxConfig(bloom_filter_capacity=10_000,
                                 transport_backend="memory", **cfg),
                       client=client or jbroker.MemoryClient(
                           jbroker.MemoryBroker()), num_banks=8)
    try:
        _feed(pipe, roster, payloads, frames)
        return _state(pipe)
    finally:
        pipe.cleanup()


@functools.lru_cache(maxsize=None)
def _jax_oracle_json():
    """The JAX one-consumer run (chunk decode) of PAYLOADS."""
    return _jax(PAYLOADS, batch_size=512)


def _port(**cfg):
    return FusedPipeline(Config(bloom_filter_capacity=10_000, **cfg),
                         client=MemoryClient(MemoryBroker()), num_banks=8,
                         device="cpu")


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_striped_json_equals_jax(lanes):
    """The reference JSON wire through N lanes: every event lands once,
    on every lane, and the state equals the JAX striped run at N lanes
    and the JAX one-consumer run."""
    want = _jax_oracle_json()
    _assert_same(_jax(PAYLOADS, batch_size=512, ingress_lanes=lanes), want)
    pipe = _port(batch_size=512, ingress_lanes=lanes)
    try:
        assert isinstance(pipe.consumer, StripedConsumer)
        _feed(pipe, ROSTER, PAYLOADS, max_events=NJSON)
        assert pipe.metrics.events == NJSON
        totals = pipe.consumer.lane_event_totals()
        assert sum(totals) == NJSON and len(totals) == lanes
        assert pipe.metrics.dead_lettered == 0
        _assert_same(_state(pipe), want)
    finally:
        pipe.cleanup()
    assert pipe.consumer.backlog() == 0  # the close sent the queued acks


@functools.lru_cache(maxsize=None)
def _bulk_stream(wire):
    roster, frames = generate_frames(8 * 1024, 1024, roster_size=500,
                                     num_lectures=4, seed=3)
    frames = list(frames)
    if wire == "columnar":
        frames = [tcodec.encode_columnar_batch(decode_planar_batch(f))
                  for f in frames]
    return roster, frames


@pytest.mark.parametrize("wire", ["binary", "columnar"])
def test_striped_bulk_wires_equal_jax(wire):
    """ATB2 frames (a lone frame passes through raw) and COLW frames
    (decoded in the lane) through 4 lanes equal the JAX one-consumer
    run of the same frames."""
    roster, frames = _bulk_stream(wire)
    want = _jax(frames=frames, roster=roster, batch_size=1024)
    pipe = _port(batch_size=1024, ingress_lanes=4)
    try:
        _feed(pipe, roster, frames=frames, max_events=8 * 1024)
        assert pipe.metrics.events == 8 * 1024
        _assert_same(_state(pipe), want)
    finally:
        pipe.cleanup()


def _redelivered(broker, topic, seconds=0.5):
    """Events a fresh one-consumer pipeline gets from ``broker``."""
    fresh = FusedPipeline(Config(bloom_filter_capacity=10_000,
                                 pulsar_topic=topic),
                          client=MemoryClient(broker), num_banks=8,
                          device="cpu")
    try:
        fresh.run(idle_timeout_s=seconds)
        return fresh.metrics.events
    finally:
        fresh.cleanup()


@pytest.mark.parametrize("fail", ["never", "always", "first_base"])
def test_acks_gated_on_barrier_durability(fail, tmp_path):
    """Group commit across 3 lanes: with every snapshot write failing no
    frame is acked (a fresh consumer gets the whole stream again); with
    healthy writes every frame is acked. The port's departure (ROADMAP
    Queue C, PR 8): when the run's first base write fails, the next
    durable base acks the failed jobs' frames, each on its own lane."""
    roster, frames = generate_frames(6 * 512, 512, roster_size=300,
                                     num_lectures=4, seed=4)
    frames = list(frames)
    broker = MemoryBroker()
    pipe = FusedPipeline(
        Config(bloom_filter_capacity=10_000, batch_size=512,
               ingress_lanes=3, snapshot_dir=str(tmp_path),
               snapshot_every_batches=2, pulsar_topic="lanes-barrier"),
        client=MemoryClient(broker), num_banks=8, device="cpu")
    calls = {"n": 0}
    orig_base, orig_delta = (pipe._write_snapshot_files,
                             pipe._write_delta_files)

    def failing(orig):
        def write(*args, **kwargs):
            calls["n"] += 1
            if fail == "always" or (fail == "first_base"
                                    and calls["n"] == 1):
                raise OSError("simulated snapshot write failure")
            return orig(*args, **kwargs)
        return write

    pipe._write_snapshot_files = failing(orig_base)
    pipe._write_delta_files = failing(orig_delta)
    _feed(pipe, roster, frames=frames, max_events=6 * 512)
    assert pipe.metrics.events == 6 * 512
    if fail == "first_base":
        assert calls["n"] >= 2 and not pipe._snap_unacked
    pipe.cleanup()
    assert _redelivered(broker, "lanes-barrier") == (
        6 * 512 if fail == "always" else 0)


def test_lane_poison_dead_letters_only_bad_payloads():
    """A broken payload inside a lane's chunk: only it dead-letters (the
    good events of the chunk land), nothing redelivers afterwards, and
    the state equals the JAX one-consumer run of the same stream."""
    good = _json_payloads(900, ROSTER, seed=2)
    stream = good[:400] + [b"{broken json"] + good[400:]
    want = _jax(stream, batch_size=256, max_redeliveries=2)
    broker = MemoryBroker()
    pipe = FusedPipeline(Config(bloom_filter_capacity=10_000, batch_size=256,
                                ingress_lanes=2, max_redeliveries=2,
                                pulsar_topic="lanes-poison"),
                         client=MemoryClient(broker), num_banks=8,
                         device="cpu")
    try:
        _feed(pipe, ROSTER, stream)
        assert pipe.metrics.events == len(good)
        _assert_same(_state(pipe), want)
    finally:
        pipe.cleanup()
    assert _redelivered(broker, "lanes-poison", 0.3) == 0


def test_striped_consumer_timeout_knobs_and_close():
    config = Config(ingress_lanes=2, batch_size=64, pulsar_topic="idle")
    broker = MemoryBroker()
    cons = StripedConsumer(config, MemoryClient(broker), "idle", "sub")
    t0 = time.monotonic()
    with pytest.raises(ReceiveTimeout):
        cons.receive(timeout_millis=80)
    assert time.monotonic() - t0 < 5.0
    cons.set_active_lanes(1)
    assert cons.active_lanes == 1 and cons.lanes[1].paused
    cons.set_active_lanes(99)
    assert cons.active_lanes == 2
    cons.set_dispatch_size(128)
    producer = MemoryClient(broker).create_producer("idle")
    producer.send_many(_json_payloads(300, ROSTER, seed=6))
    got = 0
    while got < 300:
        msg = cons.receive(timeout_millis=2000)
        assert isinstance(msg, LaneMessage)
        got += len(decode_planar_batch(msg.data())["student_id"])
        cons.acknowledge(msg)
    assert got == 300
    cons.close()
    for lane in cons.lanes:
        assert not lane.thread.is_alive()
    assert cons.backlog() == 0
    with pytest.raises(RuntimeError, match="closed"):
        cons.receive(timeout_millis=10)


def test_lane_decode_engines(monkeypatch):
    """``vector`` (the numpy scan) and ``native`` (the CPython list scan,
    item 4) land on the JAX oracle's state, as ``auto`` does. ``native``
    is the list scan and nothing else: with a library built without it
    (no ``Python.h``) or with ``ATP_NATIVE=0`` it raises instead of
    taking another engine, and ``auto`` is then the buffer scan."""
    import importlib

    from attendance_tpu_torch import native as tnative
    # The package exports the function `build`; the module by name.
    tbuild = importlib.import_module("attendance_tpu_torch.native.build")
    want = _jax_oracle_json()
    for engine in ("vector", "native"):
        pipe = _port(batch_size=512, ingress_lanes=2, lane_decode=engine)
        try:
            _feed(pipe, ROSTER, PAYLOADS, max_events=NJSON)
            _assert_same(_state(pipe), want)
        finally:
            pipe.cleanup()
    assert tnative.load().has_list_scan
    monkeypatch.setattr(tnative, "_cached", None)
    monkeypatch.setattr(tnative, "python_include", lambda: None)
    monkeypatch.setattr(tbuild, "python_include", lambda: None)
    assert not tnative.load().has_list_scan
    with pytest.raises(RuntimeError, match="Python.h"):
        _port(ingress_lanes=2, lane_decode="native")
    monkeypatch.setenv("ATP_NATIVE", "0")
    with pytest.raises(RuntimeError, match="ATP_NATIVE=0"):
        _port(ingress_lanes=2, lane_decode="native")
    with pytest.raises(ValueError, match="lane decode"):
        Config(lane_decode="python")


def test_subscribe_lane_gives_each_lane_its_own_connection():
    server = tsock.BrokerServer().start()
    client = tsock.SocketClient(server.address)
    try:
        lanes = [client.subscribe_lane("t", "sub", i) for i in range(3)]
        assert [c.lane for c in lanes] == [0, 1, 2]
        assert len({id(c._rpc) for c in lanes}) == 3
        assert len({c._rpc._sock.getsockname() for c in lanes}) == 3
        deadline = time.monotonic() + 10
        while server.consumer_count("t", "sub") < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        # One lane's session going away leaves its siblings serving.
        producer = client.create_producer("t")
        producer.send_many([b"a", b"b"])
        lanes[0].close()
        _, toks = lanes[1].receive_chunk(2, timeout_millis=2000)
        assert [t[1] for t in toks] == [b"a", b"b"]
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_striped_socket_lanes_across_packages(server_pkg):
    """Two lanes over the socket transport, each on its own connection:
    the port's lanes on a JAX BrokerServer, the JAX lanes on the
    port's; both equal the JAX one-consumer run."""
    want = _jax_oracle_json()
    server = {"jax": jsock, "torch": tsock}[server_pkg].BrokerServer().start()
    try:
        cfg = dict(batch_size=512, ingress_lanes=2,
                   transport_backend="socket", socket_broker=server.address)
        if server_pkg == "jax":
            pipe = FusedPipeline(Config(bloom_filter_capacity=10_000, **cfg),
                                 num_banks=8, device="cpu")
        else:
            pipe = JaxPipeline(JaxConfig(bloom_filter_capacity=10_000,
                                         **cfg), num_banks=8)
        try:
            assert len(pipe.consumer.lanes) == 2
            assert server.consumer_count(pipe.config.pulsar_topic,
                                         pipe.SUBSCRIPTION) == 2
            _feed(pipe, ROSTER, PAYLOADS, max_events=NJSON)
            assert pipe.metrics.events == NJSON
            _assert_same(_state(pipe), want)
        finally:
            pipe.cleanup()
    finally:
        server.stop()


def test_lane_stress_more_lanes_than_cores():
    """16 lanes (more than this host's cores) over one backlog with a
    short switch interval: every event lands exactly once and every
    chunk is acked (a lost settlement or a double delivery would break
    the totals or the backlog)."""
    payloads = _json_payloads(4000, ROSTER, seed=8)
    broker = MemoryBroker()
    MemoryClient(broker).create_producer("stress").send_many(payloads)
    cons = StripedConsumer(Config(ingress_lanes=16, batch_size=97,
                                  batch_timeout_s=0.01),
                           MemoryClient(broker), "stress", "sub")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got, deadline = 0, time.monotonic() + 60
        while got < len(payloads) and time.monotonic() < deadline:
            msg = cons.receive(timeout_millis=2000)
            got += len(decode_planar_batch(msg.data())["student_id"])
            cons.acknowledge(msg)
    finally:
        sys.setswitchinterval(interval)
        cons.close()
    assert got == len(payloads) == sum(cons.lane_event_totals())
    assert all(not lane.thread.is_alive() for lane in cons.lanes)
    assert broker.topic("stress").subscription("sub").backlog() == 0
