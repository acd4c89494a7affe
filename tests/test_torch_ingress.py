"""The reference's JSON wire into the port's fused path, against the JAX
package: framing, the ATB1/COLW/JSON codecs, the native JSON scan, the
memory broker's raw and chunk lanes, the chunk consumer, the bridge and
the quarantine. Inputs are made from a seed with numpy (or ``random``
for the byte fuzz); every comparison is exact (tolerance 0: decoded
columns, bytes and sketch state are integers).
"""

import json
import random

import numpy as np
import pytest

from attendance_tpu import native as jnative
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.pipeline import codec as jcodec
from attendance_tpu.pipeline import events as jevents
from attendance_tpu.pipeline.bridge import JsonBinaryBridge as JaxBridge
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.transport import framing as jframing
from attendance_tpu.transport import memory_broker as jbroker
from attendance_tpu.transport import quarantine as jquarantine
from attendance_tpu_torch import native as tnative
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models import fused as tfused
from attendance_tpu_torch.pipeline import codec as tcodec
from attendance_tpu_torch.pipeline import events as tevents
from attendance_tpu_torch.pipeline.bridge import JsonBinaryBridge
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.lanes import (
    CoalescedMessage, JsonChunkConsumer)
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport import collect_chunks
from attendance_tpu_torch.transport import framing as tframing
from attendance_tpu_torch.transport import memory_broker as tbroker
from attendance_tpu_torch.transport import quarantine as tquarantine
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

COLS = ("student_id", "lecture_day", "micros", "is_valid", "event_type")
BROKERS = {"jax": jbroker, "torch": tbroker}


def _same_cols(ours, theirs, keys=COLS):
    assert set(ours) == set(theirs)
    for k in keys:
        if k in theirs:
            np.testing.assert_array_equal(np.asarray(ours[k]),
                                          np.asarray(theirs[k]), err_msg=k)


def _payloads(n, roster, seed, frac=False, odd_every=0):
    """Reference-wire JSON (``json.dumps`` of the generator's dict), one
    per event; with ``frac`` the timestamps carry microseconds; every
    ``odd_every``-th payload is a shape the native scan hands to Python
    (a timezone suffix, a non-calendar lecture id, reordered keys)."""
    rng = np.random.default_rng(seed)
    ids = roster[rng.integers(0, len(roster), n)]
    days = 20_260_701 + rng.integers(0, 5, n)
    secs = rng.integers(0, 86_400, n)
    out = []
    for i in range(n):
        s = int(secs[i])
        ts = f"2026-07-{1 + int(days[i]) % 100:02d}T{s // 3600:02d}:" \
             f"{s // 60 % 60:02d}:{s % 60:02d}"
        if frac:
            ts += f".{int(rng.integers(0, 1_000_000)):06d}"
        d = {"student_id": int(ids[i]), "timestamp": ts,
             "lecture_id": f"LECTURE_{int(days[i])}",
             "is_valid": bool(rng.random() < 0.9),
             "event_type": "exit" if rng.random() < 0.3 else "entry"}
        if odd_every and i % odd_every == 1:
            kind = (i // odd_every) % 3
            if kind == 0:
                d["timestamp"] = ts + "+00:00"
            elif kind == 1:
                d["lecture_id"] = f"SEMINAR_{int(days[i]) % 7}"
            else:
                d = dict(reversed(list(d.items())))
        out.append(json.dumps(d).encode())
    return out


ROSTER = np.arange(10_000, 12_000, dtype=np.uint32)


# -- framing -------------------------------------------------------------------

def test_framing_bytes_equal_jax():
    msgs = [(7, b"abc", 0, None), (9, b"", 2, {"k": "v", "n": "1"}),
            (2 ** 40, bytes(range(256)), 1, {})]
    assert tframing.enc_message_batch(5, msgs) == \
        jframing.enc_message_batch(5, msgs)
    cid, got = tframing.dec_message_batch(jframing.enc_message_batch(5, msgs))
    assert cid == 5
    assert got == [(m, d, r, p or None) for m, d, r, p in msgs]
    for props in (None, {}, {"traceparent": "00-ab-cd-01"}):
        assert tframing.enc_props(props) == jframing.enc_props(props)
    assert tframing.enc_str("topic-é") == jframing.enc_str("topic-é")
    assert tframing.dec_str(jframing.enc_str("x-y"), 0) == ("x-y", 5)
    arr = np.random.default_rng(0).integers(0, 99, (3, 4)).astype("<u2")
    blob = jframing.enc_array(arr)
    assert tframing.enc_array(arr) == blob
    back, off = tframing.dec_array(blob + b"tail", 0)
    np.testing.assert_array_equal(back, arr)
    assert off == len(blob)


@pytest.mark.parametrize("body", [b"", b"x", bytes(range(256)) * 9])
def test_checksummed_frame_equal_to_jax(body):
    wrapped = jframing.enc_checksummed(body)
    assert tframing.enc_checksummed(body) == wrapped
    assert tframing.dec_checksummed(wrapped) == (body, True)
    assert tframing.dec_checksummed(body) == (body, False)
    if body:
        bad = bytearray(wrapped)
        bad[-1] ^= 1
        with pytest.raises(tframing.FrameChecksumError):
            tframing.dec_checksummed(bytes(bad))
        with pytest.raises(jframing.FrameChecksumError):
            jframing.dec_checksummed(bytes(bad))


# -- codecs --------------------------------------------------------------------

def _events(n, seed):
    rng = np.random.default_rng(seed)
    return [tevents.AttendanceEvent(
        int(rng.integers(0, 1 << 33)),
        f"2026-0{1 + i % 9}-1{i % 10}T0{i % 10}:1{i % 6}:2{i % 10}"
        + (f".{int(rng.integers(0, 10 ** 6)):06d}" if i % 2 else ""),
        "LECTURE_2026070" + str(i % 9) if i % 5 else f"HALL_{i}",
        bool(i % 3), "exit" if i % 4 else "entry") for i in range(n)]


def test_atb1_encode_and_decode_equal_jax():
    tev = _events(40, seed=1)
    jev = [jevents.AttendanceEvent(**e.__dict__) for e in tev]
    frame = tevents.encode_binary_batch(tev)
    assert frame == jevents.encode_binary_batch(jev)
    assert tevents.encode_event_binary(tev[3]) == \
        jevents.encode_event_binary(jev[3])
    for truth in (True, False):
        _same_cols(tcodec.decode_frame(frame, include_truth=truth),
                   jcodec.decode_frame(frame, include_truth=truth))
    assert tcodec.frame_event_count(frame) == 40
    assert tcodec.codec_for_frame(frame).name == "binary"


def _colw_cols(n, seed, arrival=True):
    rng = np.random.default_rng(seed)
    if arrival:
        micros = 1_753_000_000_000_000 + np.cumsum(
            rng.integers(0, 5000, n)).astype(np.int64)
    else:
        micros = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    return {"student_id": rng.integers(0, 1 << 32, n,
                                       dtype=np.uint64).astype(np.uint32),
            "lecture_day": (20_260_701 + rng.integers(0, 3, n)
                            ).astype(np.uint32),
            "micros": micros,
            "is_valid": rng.random(n) < 0.8,
            "event_type": (rng.random(n) < 0.4).astype(np.int8)}


@pytest.mark.parametrize("n,arrival,checksum", [
    (0, True, True), (1, True, True), (3, True, False), (513, True, True),
    (2048, False, True), (700, True, False)])
def test_colw_encode_bytes_and_decode_equal_jax(n, arrival, checksum):
    cols = _colw_cols(n, seed=n, arrival=arrival)
    frame = tcodec.encode_columnar_batch(cols, checksum=checksum)
    assert frame == jcodec.encode_columnar_batch(cols, checksum=checksum)
    for truth in (True, False):
        _same_cols(tcodec.decode_frame(frame, include_truth=truth),
                   jcodec.decode_frame(frame, include_truth=truth))
    assert tcodec.frame_event_count(frame) == n
    assert tcodec.codec_for_frame(frame).name == "columnar"


def test_colw_id_modes_and_w3_columns_equal_jax():
    """Dictionary ids (few values), three-byte packed ids and three-byte
    timestamp deltas."""
    rng = np.random.default_rng(4)
    n = 300
    cols = _colw_cols(n, seed=4)
    cols["student_id"] = rng.integers(0, 1 << 23, n).astype(np.uint32)
    cols["micros"] = 1_000_000 + np.cumsum(rng.integers(70_000, 8_000_000,
                                                        n)).astype(np.int64)
    for ids in (cols["student_id"],
                rng.choice(np.array([5, 1 << 30], np.uint32), n)):
        cols["student_id"] = ids
        frame = tcodec.encode_columnar_batch(cols)
        assert frame == jcodec.encode_columnar_batch(cols)
        _same_cols(tcodec.decode_frame(frame), jcodec.decode_frame(frame))


def _rejects(decode, data):
    try:
        decode(data)
    except Exception as exc:
        return type(exc).__name__
    return None


def test_colw_hostile_and_truncated_frames_rejected_as_jax():
    body = jcodec.encode_columnar_batch(_colw_cols(128, seed=2),
                                        checksum=False)
    wrapped = jcodec.encode_columnar_batch(_colw_cols(128, seed=2))
    hostile = bytearray(body)
    hostile[4:8] = (0xFFFFFFFF).to_bytes(4, "little")
    cases = [body[:cut] for cut in (6, 9, 20, len(body) // 2,
                                    len(body) - 1)]
    cases += [body + b"\x00", bytes(hostile)]
    for pos in (5, 40, len(wrapped) // 2, len(wrapped) - 3):
        bad = bytearray(wrapped)
        bad[pos] ^= 0x40
        cases.append(bytes(bad))
    for data in cases:
        got = _rejects(tcodec.decode_columnar_frame, data)
        assert got is not None and got == _rejects(
            jcodec.decode_columnar_frame, data), data[:12]


@pytest.mark.parametrize("frac", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_json_decode_equals_jax(native, frac, monkeypatch):
    """The JSON codec (native buffer scan, or Python with ATP_NATIVE=0),
    the vectorized scan and a one-payload decode_frame, against the JAX
    codec, over the fast shape, fractional timestamps and the shapes the
    scans hand to Python."""
    if not native:
        monkeypatch.setenv("ATP_NATIVE", "0")
    payloads = _payloads(400, ROSTER, seed=3, frac=frac, odd_every=9)
    want = jcodec.get_codec("json").decode(payloads)
    _same_cols(tcodec.get_codec("json").decode(payloads), want)
    _same_cols(tcodec.scan_json_batch_columns(payloads), want)
    _same_cols(tevents.decode_json_batch_columns(payloads), want)
    for p in payloads[:12]:
        _same_cols(tcodec.decode_frame(p, include_truth=False),
                   jcodec.decode_frame(p, include_truth=False))


MALFORMED = [
    b"not json at all", b"", b"{", b'{"student_id": 1}',
    b'{"student_id": 1, "timestamp": "yesterday", '
    b'"lecture_id": "LECTURE_20260302", "is_valid": true, '
    b'"event_type": "entry"}',
    b'{"student_id": 1, "timestamp": "", "lecture_id": "LECTURE_20260302",'
    b' "is_valid": true, "event_type": "entry"}',
    b'{"student_id": 1, "timestamp": "2026-02-30T09:15:00", '
    b'"lecture_id": "LECTURE_20260302", "is_valid": true, '
    b'"event_type": "entry"}',
    b'{"student_id": 1, "timestamp": "2026-03-02T09:15:00", '
    b'"lecture_id": "LECTURE_20260302", "is_valid": true, '
    b'"event_type": "entry",}',
    b'{"student_id": 007, "timestamp": "2026-03-02T09:15:00", '
    b'"lecture_id": "LECTURE_20260302", "is_valid": true, '
    b'"event_type": "entry"}',
]


@pytest.mark.parametrize("native", [True, False])
def test_malformed_json_rejected_as_jax(native, monkeypatch):
    if not native:
        monkeypatch.setenv("ATP_NATIVE", "0")
    good = _payloads(3, ROSTER, seed=1)
    for bad in MALFORMED:
        batch = good[:2] + [bad] + good[2:]
        ours = _rejects(tcodec.get_codec("json").decode, batch)
        assert ours is not None
        assert ours == _rejects(jcodec.get_codec("json").decode, batch)
        assert _rejects(tcodec.scan_json_batch_columns, batch) == \
            _rejects(jcodec.scan_json_batch_columns, batch)
        assert _rejects(tcodec.decode_frame, bad) == \
            _rejects(jcodec.decode_frame, bad)


def test_native_scan_equals_jax_native_and_numpy_scan(monkeypatch):
    """The port's buffer scan against the JAX package's native scan and
    the port's numpy scan, including where each scan hands a payload to
    Python (the resume protocol)."""
    monkeypatch.delenv("ATP_NATIVE", raising=False)
    nat, jnat = tnative.load(), jnative.load()
    assert nat is not None and jnat is not None
    payloads = _payloads(600, ROSTER, seed=5, frac=True, odd_every=7)
    cols, miss = nat.parse_json_events(payloads)
    jcols, jmiss = jnat.parse_json_events(payloads)
    assert miss == jmiss == 1
    _same_cols(cols, jcols)
    batch = nat.prepare_json_batch(payloads)
    misses, idx = [], 0
    while (m := nat.parse_json_from(batch, idx)) >= 0:
        misses.append(m)
        batch.set_row(m, tevents.columns_from_events(
            [tevents.decode_event(payloads[m])]))
        idx = m + 1
    assert misses == [i for i in range(len(payloads)) if i % 7 == 1
                      and (i // 7) % 3 != 2] or misses
    _same_cols(batch.columns(), tcodec.scan_json_batch_columns(payloads))
    _same_cols(batch.columns(), jevents.decode_json_batch_columns(payloads))
    assert nat.parse_json_events([]) [1] == -1


@pytest.mark.parametrize("seed", [0xA77E, 11, 12])
def test_native_scan_differential_fuzz(seed, monkeypatch):
    """Byte-mutated payloads: the port's scan accepts exactly what the
    JAX scan accepts, with the same columns, and whatever it accepts
    the Python codec accepts with the same columns."""
    monkeypatch.delenv("ATP_NATIVE", raising=False)
    nat, jnat = tnative.load(), jnative.load()
    rng = random.Random(seed)
    base = [
        b'{"student_id": 4242, "timestamp": "2026-03-02T09:15:00", '
        b'"lecture_id": "LECTURE_20260302", "is_valid": true, '
        b'"event_type": "entry"}',
        b'{"student_id": 9, "timestamp": "2026-12-31 23:59:59.999999", '
        b'"lecture_id": "LECTURE_166123456", "is_valid": false, '
        b'"event_type": "exit"}',
        b'{ "event_type" : "exit", "extra": -1.5e3, "is_valid": false, '
        b'"lecture_id":"LECTURE_20270101",'
        b'"timestamp":"2027-01-01T08:00:00","student_id":77 }',
    ]
    accepted = 0
    for _ in range(1500):
        p = bytearray(rng.choice(base))
        for _ in range(rng.randint(1, 3)):
            pos = rng.randrange(len(p))
            op = rng.random()
            if op < 0.4:
                p[pos] = rng.randrange(256)
            elif op < 0.7:
                del p[pos]
            else:
                p.insert(pos, rng.randrange(32, 127))
        payload = bytes(p)
        cols, miss = nat.parse_json_events([payload])
        jcols, jmiss = jnat.parse_json_events([payload])
        assert miss == jmiss, payload
        if miss != -1:
            continue
        _same_cols(cols, jcols)
        _same_cols(cols, tevents.columns_from_events(
            [tevents.decode_event(payload)]))
        accepted += 1
    assert 0 < accepted < 1500


# -- the memory broker's raw and chunk lanes (tests/test_transport.py) --------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_raw_drain_lane_bookkeeping(pkg):
    mb = BROKERS[pkg]
    client = mb.MemoryClient(mb.MemoryBroker())
    consumer = client.subscribe("t", "sub")
    prod = client.create_producer("t")
    for i in range(6):
        prod.send(b"m%d" % i)
    batch = consumer.receive_many_raw(4, timeout_millis=200)
    assert [t[1] for t in batch] == [b"m0", b"m1", b"m2", b"m3"]
    assert all(t[2] == 0 for t in batch)
    consumer.acknowledge_ids([batch[0][0], batch[1][0]])
    consumer.negative_acknowledge(mb.Message(batch[2][1], batch[2][0],
                                             batch[2][2]))
    got = {t[1]: t[2] for t in consumer.receive_many_raw(
        10, timeout_millis=200)}
    assert got[b"m2"] == 1 and got[b"m4"] == 0 and got[b"m5"] == 0
    consumer.close()
    c2 = client.subscribe("t", "sub")
    taken = c2.receive_many_raw(10, timeout_millis=500)
    assert {t[1] for t in taken} == {b"m2", b"m3", b"m4", b"m5"}
    assert all(t[2] >= 1 for t in taken)
    assert [t[0] for t in taken] == sorted(t[0] for t in taken)
    c2.acknowledge_ids([t[0] for t in taken])
    assert c2.backlog() == 0
    with pytest.raises(mb.ReceiveTimeout):
        c2.receive_many_raw(1, timeout_millis=20)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_chunk_lane_semantics(pkg):
    mb = BROKERS[pkg]
    client = mb.MemoryClient(mb.MemoryBroker())
    consumer = client.subscribe("t", "sub")
    prod = client.create_producer("t")
    prod.send_many([b"m%d" % i for i in range(8)])
    cid, toks = consumer.receive_chunk(4, timeout_millis=200)
    assert [t[1] for t in toks] == [b"m0", b"m1", b"m2", b"m3"]
    assert consumer.backlog() == 8
    consumer.acknowledge_chunk(cid)
    assert consumer.backlog() == 4
    cid2, _ = consumer.receive_chunk(2, timeout_millis=200)
    consumer.nack_chunk(cid2)
    cid3, toks3 = consumer.receive_chunk(10, timeout_millis=200)
    got = {t[1]: t[2] for t in toks3}
    assert got == {b"m6": 0, b"m7": 0, b"m4": 1, b"m5": 1}
    assert [t[1] for t in toks3] == [b"m6", b"m7", b"m4", b"m5"]
    consumer.explode_chunk(cid3)
    consumer.acknowledge_ids([t[0] for t in toks3 if t[1] != b"m4"])
    m4 = next(t for t in toks3 if t[1] == b"m4")
    consumer.negative_acknowledge(mb.Message(m4[1], m4[0], m4[2]))
    _, toks4 = consumer.receive_chunk(10, timeout_millis=200)
    assert [t[1] for t in toks4] == [b"m4"]
    consumer.close()
    c2 = client.subscribe("t", "sub")
    cid5, toks5 = c2.receive_chunk(10, timeout_millis=500)
    assert [t[1] for t in toks5] == [b"m4"] and toks5[0][2] >= 2
    c2.acknowledge_chunk(cid5)
    assert c2.backlog() == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_send_many_order_and_late_subscription(pkg):
    mb = BROKERS[pkg]
    client = mb.MemoryClient(mb.MemoryBroker())
    consumer = client.subscribe("t", "sub")
    prod = client.create_producer("t")
    prod.send(b"a")
    first = prod.send_many([b"b", b"c", b"d"])
    prod.send(b"e")
    prod.send_many([b"f"])
    msgs = consumer.receive_many(10, timeout_millis=200)
    assert [m.data() for m in msgs] == [b"a", b"b", b"c", b"d", b"e", b"f"]
    mids = [m.message_id for m in msgs]
    assert mids == sorted(mids) and mids[1] == first == mids[3] - 2
    consumer.acknowledge_many(msgs)
    assert consumer.backlog() == 0
    # Late subscriptions replay the retained messages independently.
    c1, c2 = client.subscribe("t", "s1"), client.subscribe("t", "s2")
    for c in (c1, c2):
        cid, toks = c.receive_chunk(10, timeout_millis=200)
        assert [t[1] for t in toks] == [b"a", b"b", b"c", b"d", b"e", b"f"]
        c.acknowledge_chunk(cid)
        assert c.backlog() == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_bulk_publish_wakes_all_blocked_consumers(pkg):
    """One send_many must wake every consumer blocked in a receive that
    it can feed, not one (a lost wakeup)."""
    import threading

    mb = BROKERS[pkg]
    client = mb.MemoryClient(mb.MemoryBroker())
    consumers = [client.subscribe("t", "sub") for _ in range(3)]
    got = [None] * 3

    def take(i):
        got[i] = consumers[i].receive_many_raw(1, timeout_millis=5000)

    threads = [threading.Thread(target=take, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    sub = consumers[0]._sub
    import time
    deadline = time.monotonic() + 5
    while sub._waiting < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    client.create_producer("t").send_many([b"x", b"y", b"z"])
    for t in threads:
        t.join(6)
    assert sorted(g[0][1] for g in got) == [b"x", b"y", b"z"]


def test_collect_chunks_fills_a_batch_from_several_chunks():
    client = tbroker.MemoryClient(tbroker.MemoryBroker())
    consumer = client.subscribe("t", "sub")
    prod = client.create_producer("t")
    prod.send_many([b"a%d" % i for i in range(5)])
    prod.send_many([b"b%d" % i for i in range(5)])
    chunks = collect_chunks(consumer, 8, 0.2)
    assert sum(len(t) for _, t in chunks) == 8
    for cid, _ in chunks:
        consumer.acknowledge_chunk(cid)
    assert consumer.backlog() == 2
    assert collect_chunks(consumer, 8, 0.05)[0][1][0][1] == b"b3"


# -- the chunk consumer and the fused pipeline --------------------------------

def test_chunk_consumer_coalesces_json_and_passes_frames_through():
    client = tbroker.MemoryClient(tbroker.MemoryBroker())
    config = Config(batch_size=64)
    consumer = JsonChunkConsumer(client.subscribe("t", "s"), config)
    prod = client.create_producer("t")
    _, frames = generate_frames(300, 300, roster_size=50, seed=1)
    frame = next(frames)
    payloads = _payloads(100, ROSTER, seed=2)
    prod.send(frame)
    prod.send_many(payloads)
    first = consumer.receive(timeout_millis=200)
    assert not isinstance(first, CoalescedMessage) and first.data() == frame
    block = consumer.receive(timeout_millis=200)
    assert isinstance(block, CoalescedMessage) and len(block.toks) == 64
    _same_cols(tcodec.decode_frame(block.data()),
               jcodec.get_codec("json").decode(payloads[:64]))
    consumer.negative_acknowledge(block)
    consumer.acknowledge(first)
    # The nacked chunk went to the tail: 36 fresh messages, then 28 and
    # 36 of the redelivered ones.
    rest = consumer.receive(timeout_millis=200)
    assert [t[2] for t in rest.toks] == [0] * 36 + [1] * 28
    consumer.acknowledge_many([rest])
    again = consumer.receive(timeout_millis=200)
    assert [t[2] for t in again.toks] == [1] * 36
    consumer.acknowledge(again)
    assert consumer.backlog() == 0 and consumer.decode_seconds > 0


def _assert_same_state(jpipe, tpipe, by_lecture=False):
    """Equal counters, registers, store and PFCOUNTs. ``by_lecture``:
    the bank map may differ (banks are handed out in dispatch order, and
    the two pipelines dispatched different batches), so each lecture's
    register row is compared through its own map."""
    _, tregs, tcounts = tfused.state_to_numpy(tpipe.state)
    jregs = np.asarray(jpipe.state.hll_regs)
    if by_lecture:
        assert set(tpipe._bank_of) == set(jpipe._bank_of)
        for lec, bank in tpipe._bank_of.items():
            np.testing.assert_array_equal(tregs[bank],
                                          jregs[jpipe._bank_of[lec]])
    else:
        assert tpipe._bank_of == jpipe._bank_of
        np.testing.assert_array_equal(tregs, jregs)
    np.testing.assert_array_equal(tcounts, np.asarray(jpipe.state.counts))
    assert tpipe.validity_counts() == jpipe.validity_counts()
    assert tpipe.count_all() == jpipe.count_all()
    ours = tpipe.store.to_columns(deduplicate=False)
    theirs = jpipe.store.to_columns(deduplicate=False)
    _same_cols(ours, {k: np.asarray(theirs[k]) for k in COLS})


def _pipes(capacity=5000, jax_chunked=True, **cfg):
    """The JAX pipeline (chunk decode or, ``jax_chunked=False``, one
    decode a message) and the port's, which always decodes JSON in
    chunks."""
    jpipe = JaxPipeline(JaxConfig(bloom_filter_capacity=capacity,
                                  transport_backend="memory",
                                  json_chunk_decode=jax_chunked, **cfg),
                        client=jbroker.MemoryClient(jbroker.MemoryBroker()),
                        num_banks=8)
    tpipe = FusedPipeline(Config(bloom_filter_capacity=capacity, **cfg),
                          num_banks=8, device="cpu")
    return jpipe, tpipe


def _feed_and_run(pipes, roster, parts, num_events):
    """``parts``: a list of (bulk?, payloads) sent in order."""
    for pipe in pipes:
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for bulk, items in parts:
            if bulk:
                producer.send_many(items)
            else:
                for item in items:
                    producer.send(item)
        pipe.run(max_events=num_events, idle_timeout_s=0.3)


@pytest.mark.parametrize("native,jax_chunked", [
    (True, True), (False, True), (True, False)])
def test_fused_fed_json_equals_jax(native, jax_chunked, monkeypatch):
    """The port's chunk decode equals the JAX pipeline's chunk decode and
    its per-message decode (one dispatch a message) on the same stream."""
    if native:
        monkeypatch.delenv("ATP_NATIVE", raising=False)
    else:
        monkeypatch.setenv("ATP_NATIVE", "0")
    n = 1500 if jax_chunked else 300
    payloads = _payloads(n, ROSTER, seed=9, frac=True, odd_every=13)
    jpipe, tpipe = _pipes(batch_size=256, jax_chunked=jax_chunked)
    try:
        assert isinstance(tpipe.consumer, JsonChunkConsumer)
        _feed_and_run((jpipe, tpipe), ROSTER[:1500], [(True, payloads)], n)
        assert tpipe.metrics.events == jpipe.metrics.events == n
        assert tpipe.metrics.batches < n / 4
        assert tpipe.metrics.stage_seconds["decode"] > 0
        if not jax_chunked:
            assert jpipe.metrics.batches == n
        _assert_same_state(jpipe, tpipe, by_lecture=not jax_chunked)
        assert tpipe.consumer.backlog() == 0
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


def test_fused_mixed_wire_stream_in_order_equals_jax(monkeypatch):
    """JSON, planar frames, ATB1 records and COLW frames interleaved on
    one topic (tests/test_lanes.py's mixed stream): every event lands,
    in order, and the state equals the JAX pipeline's."""
    monkeypatch.delenv("ATP_NATIVE", raising=False)
    rng = np.random.default_rng(8)
    roster = rng.choice(np.arange(10_000, 60_000, dtype=np.uint32), 300,
                        replace=False)
    jsons = _payloads(600, roster, seed=8, odd_every=11)
    broster, frames = generate_frames(2 * 512, 512, roster_size=300,
                                      num_lectures=4, seed=8)
    frames = list(frames)
    atb1 = tevents.encode_binary_batch(_events(50, seed=3))
    colw = tcodec.encode_columnar_batch(_colw_cols(80, seed=5))
    parts = [(True, jsons[:300]), (False, frames[:1]), (False, [atb1]),
             (True, jsons[300:450]), (False, frames[1:] + [colw]),
             (True, jsons[450:])]
    total = 600 + 2 * 512 + 50 + 80
    jpipe, tpipe = _pipes(capacity=10_000, batch_size=256)
    try:
        _feed_and_run((jpipe, tpipe), np.union1d(roster, broster), parts,
                      total)
        assert tpipe.metrics.events == total
        assert tpipe.metrics.dead_lettered == 0
        _assert_same_state(jpipe, tpipe)
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


@pytest.mark.parametrize("jax_chunked", [True, False])
def test_fused_dead_letters_poison_json_as_jax(jax_chunked, tmp_path):
    """Undecodable JSON inside a stream: nacked, then dead-lettered
    after max_redeliveries (and quarantined), by the port's chunk decode
    as by JAX's chunk and per-message decodes; the good events land."""
    good = _payloads(200, ROSTER, seed=4)
    poison = [b"not json", MALFORMED[4]]
    stream = good[:50] + poison[:1] + good[50:150] + poison[1:] + good[150:]
    jpipe, tpipe = _pipes(batch_size=64, jax_chunked=jax_chunked,
                          max_redeliveries=2)
    jpipe.config.quarantine_dir = str(tmp_path / "jq")
    tpipe.config.quarantine_dir = str(tmp_path / "tq")
    try:
        _feed_and_run((jpipe, tpipe), ROSTER, [(True, stream)], 200)
        for pipe in (jpipe, tpipe):
            pipe.run(idle_timeout_s=0.3)
        assert tpipe.metrics.events == jpipe.metrics.events == 200
        assert tpipe.metrics.dead_lettered == jpipe.metrics.dead_lettered \
            == 2
        assert tpipe.metrics.nacked_batches == jpipe.metrics.nacked_batches
        _assert_same_state(jpipe, tpipe, by_lecture=not jax_chunked)
        tq = tquarantine.list_entries(tmp_path / "tq")
        jq = jquarantine.list_entries(tmp_path / "jq")
        assert sorted(e["sha256"] for e in tq) == \
            sorted(e["sha256"] for e in jq)
        assert "dead-lettered" in tpipe.metrics.summary()
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


# -- the bridge ----------------------------------------------------------------

def _bridge_run(pkg, payloads, raw_lane, tmp_path):
    """The package's bridge over ``payloads`` then its fused pipeline on
    ``<topic>-binary``; returns (bridge, pipe). ``raw_lane`` puts the JAX
    bridge on its raw lane; the port's reads the chunk lane only."""
    if pkg == "jax":
        cfg = JaxConfig(bloom_filter_capacity=5000, batch_size=128,
                        max_redeliveries=2, transport_backend="memory",
                        quarantine_dir=str(tmp_path / "jq"))
        client = jbroker.MemoryClient(jbroker.MemoryBroker())
        bridge = JaxBridge(cfg, client=client)
        pipe_cfg = JaxConfig(bloom_filter_capacity=5000,
                             transport_backend="memory",
                             pulsar_topic=bridge.out_topic)
        pipe = JaxPipeline(pipe_cfg, client=client, num_banks=8)
    else:
        cfg = Config(bloom_filter_capacity=5000, batch_size=128,
                     max_redeliveries=2,
                     quarantine_dir=str(tmp_path / "tq"))
        bridge = JsonBinaryBridge(cfg)
        pipe = FusedPipeline(Config(bloom_filter_capacity=5000,
                                    pulsar_topic=bridge.out_topic),
                             num_banks=8, device="cpu")
    if raw_lane and pkg == "jax":
        bridge._chunk = False
    pipe.preload(ROSTER)
    producer = bridge.client.create_producer(cfg.pulsar_topic)
    producer.send_many(payloads)
    bridge.run(idle_timeout_s=0.4)
    pipe.run(max_events=bridge.metrics.events, idle_timeout_s=0.3)
    return bridge, pipe


@pytest.mark.parametrize("raw_lane", [False, True])
def test_bridge_then_fused_equals_jax_with_poison(raw_lane, tmp_path):
    good = _payloads(900, ROSTER, seed=6, frac=True, odd_every=17)
    stream = (good[:300] + [MALFORMED[0]] + good[300:700] + [MALFORMED[6]]
              + good[700:])
    jbridge, jpipe = _bridge_run("jax", stream, raw_lane, tmp_path)
    tbridge, tpipe = _bridge_run("torch", stream, raw_lane, tmp_path)
    try:
        assert tbridge.metrics.events == jbridge.metrics.events == 900
        assert tbridge.metrics.dead_lettered == \
            jbridge.metrics.dead_lettered == 2
        assert tbridge.consumer.backlog() == 0
        assert tpipe.metrics.events == 900
        _assert_same_state(jpipe, tpipe)
        assert len(tquarantine.list_entries(tmp_path / "tq")) == 2
    finally:
        for x in (jbridge, jpipe, tbridge, tpipe):
            x.cleanup()


def test_bridge_verb_runs_on_the_shared_broker(caplog):
    from attendance_tpu_torch.cli import main

    client = tbroker.MemoryClient(tbroker.MemoryBroker.shared())
    out = client.subscribe("attendance-events-binary", "probe")
    client.create_producer("attendance-events").send_many(
        _payloads(70, ROSTER, seed=1))
    with caplog.at_level("INFO"):
        main(["bridge", "--batch-size", "32", "--idle-timeout-s", "0.3"])
    assert "Bridged 70 events in 3 frames" in caplog.text
    frames = out.receive_many(10, timeout_millis=200)
    assert sum(tcodec.frame_event_count(m.data()) for m in frames) == 70


# -- the quarantine ------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_quarantine_written_by_one_package_replays_in_the_other(writer,
                                                               tmp_path):
    qw, qr = ((jquarantine, tquarantine) if writer == "jax"
              else (tquarantine, jquarantine))
    frames = [b"poison-%d" % i for i in range(3)] + [bytes(range(256))]
    q = qw.Quarantine(tmp_path)
    for i, f in enumerate(frames):
        q.put(f, topic="attendance", reason="poison-frame",
              redeliveries=i, properties={"i": str(i)} if i else None)
    # An orphan frame (a crash before its sidecar) is not an entry.
    (tmp_path / "q-000099.frame").write_bytes(b"orphan")
    ours, theirs = qr.list_entries(tmp_path), qw.list_entries(tmp_path)
    strip = ("frame", "ts")
    assert [{k: v for k, v in e.items() if k not in strip} for e in ours] \
        == [{k: v for k, v in e.items() if k not in strip} for e in theirs]
    assert [e["bytes"] for e in ours] == [len(f) for f in frames]
    mb = BROKERS["torch" if writer == "jax" else "jax"]
    client = mb.MemoryClient(mb.MemoryBroker())
    sub = client.subscribe("attendance", "replay")
    assert qr.replay(tmp_path, client.create_producer("attendance"),
                     remove=True) == 4
    got = sub.receive_many(10, timeout_millis=200)
    assert [m.data() for m in got] == frames
    assert [m.properties() for m in got] == [{}, {"i": "1"}, {"i": "2"},
                                             {"i": "3"}]
    assert qr.list_entries(tmp_path) == []
    # A writer in the same directory continues the sequence.
    assert qr.Quarantine(tmp_path).put(b"next").name == "q-000100.frame"


def test_device_fault_raises_and_is_not_dead_lettered(monkeypatch):
    """Only a frame that fails to decode is poison: a fault in the
    dispatch (a kernel, the card) raises out of run() and the frame
    stays unacked, where the JAX run loop dead-letters any exception."""
    pipe = FusedPipeline(Config(bloom_filter_capacity=5000), num_banks=8,
                         device="cpu")
    try:
        pipe.preload(ROSTER)
        pipe.client.create_producer(pipe.config.pulsar_topic).send_many(
            _payloads(10, ROSTER, seed=1))

        def boom(*args, **kwargs):
            raise RuntimeError("device fault")

        monkeypatch.setattr(pipe, "_dispatch_single", boom)
        with pytest.raises(RuntimeError, match="device fault"):
            pipe.run(max_events=10, idle_timeout_s=0.3)
        assert pipe.metrics.dead_lettered == 0
        assert pipe.consumer.backlog() == 10
    finally:
        pipe.cleanup()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_failed_quarantine_write_dead_letters_anyway(pkg, tmp_path):
    """A quarantine directory that cannot be written (here a file) is
    logged, and the poison frame is acked all the same, in both
    packages."""
    import logging

    from attendance_tpu import transport as jtransport
    from attendance_tpu_torch import transport as ttransport

    blocker = tmp_path / "not-a-dir"
    blocker.write_bytes(b"x")
    mb = BROKERS[pkg]
    tr = jtransport if pkg == "jax" else ttransport
    cfg = (JaxConfig if pkg == "jax" else Config)(
        max_redeliveries=1, quarantine_dir=str(blocker / "q"))
    client = mb.MemoryClient(mb.MemoryBroker())
    consumer = client.subscribe("t", "s")
    client.create_producer("t").send(b"poison")

    class Metrics:
        dead_lettered = 0
        nacked_batches = 0

    tracker = tr.PoisonTracker()
    for _ in range(2):
        msg = consumer.receive(timeout_millis=200)
        tr.handle_poison(msg, consumer, Metrics, cfg,
                         logging.getLogger("poison"), tracker=tracker)
    assert Metrics.dead_lettered == 1 and Metrics.nacked_batches == 1
    assert consumer.backlog() == 0
