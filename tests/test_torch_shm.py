"""The port's shared-memory ring against the JAX package's
(``tests/test_shm_ring.py``'s cases, chaos faults excepted): the file
layout, round trip and ack cursor, wraparound, backpressure, an
oversized frame, a geometry mismatch, nack redelivery, crash resume in a
subprocess, out-of-order acks, the seqlock hammer, the chunk lane, lane
striping, a producer killed between its stamp and its head bump, ring
files crossing between the packages both ways, and the fused pipeline
fed through the ring (one consumer and striped lanes) equal to the JAX
pipeline on a memory broker. Every comparison is exact.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.transport import memory_broker as jbroker
from attendance_tpu.transport import shm_ring as jshm
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models.fused import state_to_numpy
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.lanes import (
    JsonChunkConsumer, StripedConsumer)
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport import make_client
from attendance_tpu_torch.transport import shm_ring as tshm
from attendance_tpu_torch.transport.memory_broker import ReceiveTimeout
from attendance_tpu_torch.transport.shm_ring import (
    ShmClient, ShmRingConsumer, ShmRingFull, ShmRingProducer, ring_path)

REPO = Path(__file__).resolve().parent.parent
PKGS = {"jax": jshm, "torch": tshm}


def _ring_pair(tmp_path, *, nslots=8, slot_bytes=4096):
    path = tmp_path / "t.lane0.ring"
    return (path, ShmRingProducer(path, nslots=nslots, slot_bytes=slot_bytes),
            ShmRingConsumer(path, nslots=nslots, slot_bytes=slot_bytes))


def test_ring_layout_constants_equal_jax():
    for name in ("RING_MAGIC", "RING_VERSION", "_OFF_HEAD", "_OFF_ACK",
                 "_OFF_RED", "_SLOT_HDR", "DEFAULT_SLOTS",
                 "DEFAULT_SLOT_BYTES"):
        assert getattr(tshm, name) == getattr(jshm, name), name
    assert tshm._HDR.format == jshm._HDR.format
    for n in (2, 8, 64, 1000, 1024):
        assert tshm._header_bytes(n) == jshm._header_bytes(n)
    assert tshm.ring_path("d", "a/b c", 3) == jshm.ring_path("d", "a/b c", 3)


def test_roundtrip_and_ack_cursor(tmp_path):
    path, prod, cons = _ring_pair(tmp_path)
    for i in range(5):
        prod.send(b"frame-%d" % i)
    msgs = [cons.receive(timeout_millis=200) for _ in range(5)]
    assert [bytes(m.data()) for m in msgs] == [b"frame-%d" % i
                                               for i in range(5)]
    assert [m.redelivery_count for m in msgs] == [0] * 5
    cons.acknowledge_many(msgs)
    with pytest.raises(ReceiveTimeout):
        cons.receive(timeout_millis=20)
    assert cons.backlog() == 0
    cons.close()
    cons2 = ShmRingConsumer(path, nslots=8, slot_bytes=4096)
    with pytest.raises(ReceiveTimeout):  # everything acked: nothing back
        cons2.receive(timeout_millis=20)
    cons2.close()
    prod.close()


def test_wraparound_many_times_over(tmp_path):
    _, prod, cons = _ring_pair(tmp_path, nslots=4)
    got = []

    def consume():
        while len(got) < 64:
            m = cons.receive(timeout_millis=500)
            got.append(bytes(m.data()))
            cons.acknowledge(m)

    t = threading.Thread(target=consume)
    t.start()
    for i in range(64):
        prod.send(b"wrap-%03d" % i)
    t.join(timeout=10)
    assert not t.is_alive()
    assert got == [b"wrap-%03d" % i for i in range(64)]
    prod.close()
    cons.close()


def test_full_ring_backpressure(tmp_path):
    """An unacked ring blocks the producer (ShmRingFull on timeout),
    never overwrites; one ack frees exactly one slot."""
    _, prod, cons = _ring_pair(tmp_path, nslots=4)
    for i in range(4):
        prod.send(b"x%d" % i)
    with pytest.raises(ShmRingFull):
        prod.send(b"overflow", timeout_s=0.1)
    cons.acknowledge(cons.receive(timeout_millis=100))
    prod.send(b"now-fits", timeout_s=1.0)
    with pytest.raises(ShmRingFull):
        prod.send(b"overflow-again", timeout_s=0.1)
    prod.close()
    cons.close()


def test_oversized_frame_and_geometry_mismatch_fail_loudly(tmp_path):
    path, prod, cons = _ring_pair(tmp_path, slot_bytes=256)
    with pytest.raises(ValueError, match="slot"):
        prod.send(b"z" * 300)
    with pytest.raises(ValueError, match="geometry"):
        ShmRingConsumer(path, nslots=16, slot_bytes=256)
    with pytest.raises(ValueError, match="multiple of 8"):
        ShmRingConsumer(tmp_path / "odd.ring", nslots=4, slot_bytes=100)
    prod.close()
    cons.close()


def test_nack_redelivers_with_bumped_count(tmp_path):
    _, prod, cons = _ring_pair(tmp_path)
    prod.send(b"poisonish")
    m = cons.receive(timeout_millis=100)
    assert m.redelivery_count == 0
    cons.negative_acknowledge(m)
    m2 = cons.receive(timeout_millis=100)
    assert bytes(m2.data()) == b"poisonish"
    assert m2.message_id == m.message_id  # stable identity (tracker)
    assert m2.redelivery_count == 1
    cons.acknowledge(m2)
    prod.close()
    cons.close()


_CRASHING_CONSUMER = """
import os, sys
from attendance_tpu_torch.transport.shm_ring import ShmRingConsumer
cons = ShmRingConsumer(sys.argv[1], nslots=8, slot_bytes=4096)
msgs = [cons.receive(timeout_millis=2000) for _ in range(6)]
cons.acknowledge_many(msgs[:2])  # a group commit covered 0-1 only
os._exit(0)  # killed holding 2-5: nothing flushed past the acks
"""


def test_crash_resume_in_a_subprocess_redelivers_unacked_tail(tmp_path):
    path, prod, cons = _ring_pair(tmp_path)
    cons.close()
    for i in range(6):
        prod.send(b"r%d" % i)
    subprocess.run([sys.executable, "-c", _CRASHING_CONSUMER, str(path)],
                   check=True, timeout=60,
                   env=dict(os.environ, PYTHONPATH=str(REPO)))
    cons2 = ShmRingConsumer(path, nslots=8, slot_bytes=4096)
    back = [cons2.receive(timeout_millis=100) for _ in range(4)]
    assert [bytes(m.data()) for m in back] == [b"r%d" % i
                                               for i in range(2, 6)]
    assert all(m.redelivery_count == 1 for m in back)
    cons2.acknowledge_many(back)
    with pytest.raises(ReceiveTimeout):
        cons2.receive(timeout_millis=20)
    cons2.close()
    prod.close()


def test_out_of_order_acks_hold_cursor(tmp_path):
    path, prod, cons = _ring_pair(tmp_path)
    for i in range(4):
        prod.send(b"h%d" % i)
    msgs = [cons.receive(timeout_millis=100) for _ in range(4)]
    for i in (0, 2, 3):  # a hole at seq 1
        cons.acknowledge(msgs[i])
    cons.close()
    cons2 = ShmRingConsumer(path, nslots=8, slot_bytes=4096)
    back = [cons2.receive(timeout_millis=100) for _ in range(3)]
    assert [bytes(m.data()) for m in back] == [b"h1", b"h2", b"h3"]
    cons2.close()
    prod.close()


def test_seqlock_hammer_zero_torn_deliveries(tmp_path):
    """A writer races the reader over a 4-slot ring for many wraps:
    every delivered payload is whole (one repeated byte + its
    sequence)."""
    _, prod, cons = _ring_pair(tmp_path, nslots=4, slot_bytes=8192)
    n_msgs, payload_len = 300, 4096
    errors = []

    def consume():
        for i in range(n_msgs):
            m = cons.receive(timeout_millis=2000)
            buf = np.frombuffer(m.data(), np.uint8)
            seq = int.from_bytes(bytes(buf[:8]), "little")
            if seq != i or not (buf[8:] == buf[8]).all() \
                    or buf[8] != seq % 251:
                errors.append((i, seq, int(buf[8])))
            cons.acknowledge(m)

    t = threading.Thread(target=consume)
    t.start()
    for i in range(n_msgs):
        prod.send(i.to_bytes(8, "little")
                  + bytes([i % 251]) * (payload_len - 8))
    t.join(timeout=30)
    assert not t.is_alive(), "consumer wedged"
    assert errors == [], f"torn deliveries: {errors[:5]}"
    prod.close()
    cons.close()


def test_torn_slot_is_retried_never_delivered(tmp_path):
    """A slot left mid-write (odd word) is counted as a torn read and not
    delivered; once stamped it arrives whole."""
    _, prod, cons = _ring_pair(tmp_path)
    ring = prod._ring
    ring.set_seqword(0, tshm._Ring.stable_word(0) | 1)
    with pytest.raises(ReceiveTimeout):
        cons.receive(timeout_millis=10)
    assert cons.torn_reads > 0
    prod.send(b"whole")
    assert bytes(cons.receive(timeout_millis=100).data()) == b"whole"
    prod.close()
    cons.close()


def test_chunk_lane_settlement(tmp_path):
    _, prod, cons = _ring_pair(tmp_path)
    for i in range(4):
        prod.send(b"c%d" % i)
    cid, toks = cons.receive_chunk(4, timeout_millis=200)
    assert [bytes(t[1]) for t in toks] == [b"c%d" % i for i in range(4)]
    cons.nack_chunk(cid)
    cid2, toks2 = cons.receive_chunk(4, timeout_millis=200)
    assert [t[2] for t in toks2] == [1, 1, 1, 1]
    cons.acknowledge_chunk(cid2)
    with pytest.raises(ReceiveTimeout):
        cons.receive_chunk(4, timeout_millis=20)
    prod.close()
    cons.close()


def test_shm_client_lane_striping(tmp_path):
    client = ShmClient(tmp_path, lanes=2, nslots=8, slot_bytes=4096)
    prod = client.create_producer("topic-x")
    for i in range(6):
        prod.send(b"s%d" % i)
    c0 = client.subscribe_lane("topic-x", "sub", 0)
    c1 = client.subscribe_lane("topic-x", "sub", 1)
    assert [bytes(c0.receive(timeout_millis=100).data())
            for _ in range(3)] == [b"s0", b"s2", b"s4"]
    assert [bytes(c1.receive(timeout_millis=100).data())
            for _ in range(3)] == [b"s1", b"s3", b"s5"]
    assert ring_path(tmp_path, "topic-x", 1).exists()
    client.close()
    with pytest.raises(ValueError, match="shm-dir"):
        ShmClient("")


def test_producer_crash_between_stamp_and_head_bump_never_overwrites(
        tmp_path):
    path, prod, cons = _ring_pair(tmp_path)
    prod.send(b"published-0")
    prod.send(b"published-1")
    prod._ring.set_head(1)  # the dead producer never recorded seq 1
    prod.close()
    prod2 = ShmRingProducer(path, nslots=8, slot_bytes=4096)
    assert prod2._head == 2
    prod2.send(b"published-2")
    assert [bytes(cons.receive(timeout_millis=200).data())
            for _ in range(3)] == [b"published-0", b"published-1",
                                   b"published-2"]
    prod2.close()
    cons.close()


@pytest.mark.parametrize("producer_pkg,consumer_pkg",
                         [("jax", "torch"), ("torch", "jax")])
def test_ring_files_cross_between_packages(producer_pkg, consumer_pkg,
                                           tmp_path):
    """One package's producer writes, the other's consumer reads, acks
    part, nacks one, and a fresh attach of the writer's own package
    resumes at the shared cursor: the bytes on disk are one format."""
    path = tmp_path / "x.lane0.ring"
    prod = PKGS[producer_pkg].ShmRingProducer(path, nslots=4,
                                              slot_bytes=1024)
    cons = PKGS[consumer_pkg].ShmRingConsumer(path, nslots=4,
                                              slot_bytes=1024)
    frames = [bytes([i]) * (100 + i) for i in range(4)]
    for f in frames:
        prod.send(f)
    msgs = [cons.receive(timeout_millis=200) for _ in range(4)]
    assert [bytes(m.data()) for m in msgs] == frames
    cons.acknowledge_many(msgs[:2])
    cons.negative_acknowledge(msgs[2])
    again = cons.receive(timeout_millis=200)
    assert bytes(again.data()) == frames[2] and again.redelivery_count == 1
    cons.close()
    for extra in (b"five", b"six"):  # the slots of the two acked frames
        prod.send(extra, timeout_s=1.0)
    with pytest.raises(PKGS[producer_pkg].ShmRingFull):
        prod.send(b"full", timeout_s=0.05)
    other = PKGS[producer_pkg].ShmRingConsumer(path, nslots=4,
                                               slot_bytes=1024)
    back = [other.receive(timeout_millis=200) for _ in range(4)]
    assert [bytes(m.data()) for m in back] == frames[2:] + [b"five",
                                                            b"six"]
    assert [m.redelivery_count for m in back] == [2, 1, 0, 0]
    other.close()
    prod.close()


# -- the fused pipeline fed through the ring ---------------------------------------

NEV, BATCH = 8 * 2048, 2048


def _frames():
    roster, frames = generate_frames(NEV, BATCH, roster_size=6_000,
                                     num_lectures=6, seed=5)
    return roster, list(frames)


def _jax_state(roster, frames):
    client = jbroker.MemoryClient(jbroker.MemoryBroker())
    pipe = JaxPipeline(JaxConfig(bloom_filter_capacity=20_000,
                                 transport_backend="memory"),
                       client=client, num_banks=8)
    pipe.preload(roster)
    producer = client.create_producer(pipe.config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=NEV, idle_timeout_s=0.3)
    regs = np.asarray(pipe.state.hll_regs)
    state = (pipe.validity_counts(), pipe.count_all(),
             {d: regs[b] for d, b in pipe._bank_of.items()},
             np.asarray(pipe.state.counts),
             _sorted_store(pipe.store.to_columns()))
    pipe.cleanup()
    return state


def _sorted_store(cols):
    order = np.lexsort((np.asarray(cols["student_id"]),
                        np.asarray(cols["micros"]),
                        np.asarray(cols["lecture_day"])))
    return {k: np.asarray(cols[k])[order]
            for k in ("student_id", "lecture_day", "micros", "is_valid")}


def _assert_state_equals(pipe, want):
    _, regs, counts = state_to_numpy(pipe.state)
    assert pipe.validity_counts() == want[0]
    assert pipe.count_all() == want[1]
    assert set(pipe._bank_of) == set(want[2])
    for d, b in pipe._bank_of.items():
        np.testing.assert_array_equal(regs[b], want[2][d])
    np.testing.assert_array_equal(counts, want[3])
    got = _sorted_store(pipe.store.to_columns())
    for k, v in want[4].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


_PRODUCER = """
import sys
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport import make_client
config = Config(ingress_wire="shm", shm_dir=sys.argv[1], ingress_lanes=2,
                shm_slots=4, shm_slot_bytes=1 << 16)
_, frames = generate_frames(8 * 2048, 2048, roster_size=6_000,
                            num_lectures=6, seed=5)
producer = make_client(config).create_producer(config.pulsar_topic)
for f in frames:
    producer.send(f)
"""


@pytest.mark.parametrize("lanes", [0, 2])
def test_fused_pipeline_over_the_ring_equals_jax(lanes, tmp_path):
    """The ring as the wire: one consumer (no chunk wrapper), and two
    lanes with one ring each fed by a producer in another process over
    a ring shallower than the stream (backpressure); the state equals
    the JAX pipeline on a memory broker, and every frame is acked."""
    roster, frames = _frames()
    want = _jax_state(roster, frames)
    config = Config(bloom_filter_capacity=20_000, ingress_wire="shm",
                    shm_dir=str(tmp_path), ingress_lanes=lanes,
                    shm_slots=4, shm_slot_bytes=1 << 16)
    pipe = FusedPipeline(config, num_banks=8, device="cpu")
    try:
        if lanes:
            assert isinstance(pipe.consumer, StripedConsumer)
            pipe.preload(roster)
            proc = subprocess.Popen(
                [sys.executable, "-c", _PRODUCER, str(tmp_path)],
                env=dict(os.environ, PYTHONPATH=str(REPO)))
            # The idle budget covers the producer process's start; the
            # run ends at max_events.
            pipe.run(max_events=NEV, idle_timeout_s=60.0)
            assert proc.wait(timeout=60) == 0
            totals = pipe.consumer.lane_event_totals()
            assert sum(totals) == NEV and all(totals)
        else:
            assert not isinstance(pipe.consumer, JsonChunkConsumer)
            pipe.preload(roster)
            producer = pipe.client.create_producer(config.pulsar_topic)
            for f in frames[:4]:
                producer.send(f)
            pipe.run(max_events=NEV // 2, idle_timeout_s=0.5)
            for f in frames[4:]:  # into the slots the run's acks freed
                producer.send(f)
            pipe.run(max_events=NEV, idle_timeout_s=0.5)  # cumulative
        _assert_state_equals(pipe, want)
    finally:
        pipe.cleanup()
    # Every frame was acked: a fresh consumer of each ring gets nothing.
    for lane in range(max(1, lanes)):
        cons = ShmRingConsumer(ring_path(tmp_path, config.pulsar_topic, lane),
                               nslots=4, slot_bytes=1 << 16)
        assert cons.backlog() == 0
        cons.close()


def test_ring_resume_after_a_consumer_closed_mid_run(tmp_path):
    """A checkpointing pipeline on the ring dies before its last acks
    (its delta writes fail, then ``consumer.close()``); a fresh pipeline
    on the same directories restores the durable base, resumes at the
    ring's ``ack_cursor`` (the unacked frames redeliver) and ends equal
    to the uninterrupted run."""
    roster, frames = _frames()
    want = _jax_state(roster, frames)
    config = Config(bloom_filter_capacity=20_000, ingress_wire="shm",
                    shm_dir=str(tmp_path / "ring"), shm_slots=16,
                    shm_slot_bytes=1 << 16,
                    snapshot_dir=str(tmp_path / "snap"),
                    snapshot_every_batches=3)
    a = FusedPipeline(config, num_banks=8, device="cpu")

    def disk_died(*args, **kwargs):
        raise OSError("simulated delta write failure")

    a._write_delta_files = disk_died
    a.preload(roster)
    producer = make_client(config).create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    a.run(max_events=5 * BATCH, idle_timeout_s=0.3)
    a.consumer.close()  # the crash: frames 4-5 delivered, never acked
    ring = tshm._Ring(ring_path(tmp_path / "ring", config.pulsar_topic, 0),
                      16, 1 << 16)
    assert ring.ack_cursor() == 3
    b = FusedPipeline(config, num_banks=8, device="cpu")
    try:
        assert b._events_restored == 3 * BATCH
        b.run(max_events=NEV - 3 * BATCH, idle_timeout_s=0.3)
        _assert_state_equals(b, want)
        assert ring.delivery_count(3) == 2  # redelivered once
    finally:
        b.cleanup()
        a.cleanup()
