"""The whole slice on the CPU: the port's fused pipeline against the JAX
``FusedPipeline`` on the same seeded frames.

The JAX pipeline runs its numpy pack path (``ATP_NATIVE=0``, where the
auto wire is the word wire); the port runs its kernels' plain versions
on ``device="cpu"``. Both are deterministic sketches: every compared
value must be equal.
"""

import json

import numpy as np
import pytest
import torch

from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.pipeline.events import (
    decode_planar_batch as jax_decode_planar)
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.pipeline.loadgen import generate_frames as jax_frames
from attendance_tpu.transport.memory_broker import (
    MemoryBroker as JaxBroker, MemoryClient as JaxClient)
from attendance_tpu_torch.cli import main as cli_main, run_fused
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models.fused import state_to_numpy
from attendance_tpu_torch.pipeline.codec import decode_frame
from attendance_tpu_torch.pipeline.events import (
    decode_planar_batch, encode_planar_batch, lecture_to_day)
from attendance_tpu_torch.pipeline.fast_path import STAGES, FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient, ReceiveTimeout)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401


@pytest.mark.parametrize("kwargs", [
    dict(num_events=10_000, batch=3000, roster_size=2000, num_lectures=5),
    dict(num_events=5000, batch=1024, roster_size=500, num_lectures=3,
         invalid_fraction=0.3, seed=11),
    dict(num_events=4000, batch=2000, roster_size=300, num_lectures=2,
         seed=5, disorder_frac=0.2, late_max_s=1.0)])
def test_generate_frames_byte_equal_to_jax(kwargs):
    batch = kwargs.pop("batch")
    num_events = kwargs.pop("num_events")
    roster, frames = generate_frames(num_events, batch, **kwargs)
    jroster, jframes = jax_frames(num_events, batch, **kwargs)
    np.testing.assert_array_equal(roster, jroster)
    ours, theirs = list(frames), list(jframes)
    assert len(ours) == len(theirs) == -(-num_events // batch)
    assert ours == theirs


def test_planar_codec_round_trip_matches_jax():
    _, frames = generate_frames(3000, 3000, roster_size=100, seed=2)
    frame = next(frames)
    ours, theirs = decode_planar_batch(frame), jax_decode_planar(frame)
    assert ours.keys() == theirs.keys()
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name])
    assert encode_planar_batch(ours) == frame
    assert "is_valid" not in decode_frame(frame, include_truth=False)
    # decode_frame takes every wire of the JAX seam: a one-record ATB1
    # frame decodes as the JAX package decodes it; a payload of no wire
    # raises.
    from attendance_tpu.pipeline.codec import decode_frame as jax_decode
    record = b"ATB1" + bytes(20)
    ours, theirs = decode_frame(record), jax_decode(record)
    assert ours.keys() == theirs.keys()
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name])
    with pytest.raises(ValueError):
        decode_frame(b"ATB9" + bytes(20))


def test_lecture_to_day():
    from attendance_tpu.pipeline.events import _lecture_to_day

    for lid in ("LECTURE_20260701", "LECTURE_101234567", "MATH_101",
                "LECTURE_abc"):
        assert lecture_to_day(lid) == _lecture_to_day(lid)


def test_config_wires():
    assert Config().wire_format == "auto"
    for wire in ("auto", "delta", "seg", "word", "bytes"):
        assert Config(wire_format=wire).wire_format == wire
        assert JaxConfig(wire_format=wire).validate().wire_format == wire
    with pytest.raises(ValueError):
        Config(wire_format="json")
    with pytest.raises(ValueError):
        Config(hll_precision=3)


def test_memory_broker_acks_and_timeout():
    client = MemoryClient(MemoryBroker())
    consumer = client.subscribe("t", "s")
    client.create_producer("t").send(b"x")
    msg = consumer.receive(timeout_millis=100)
    assert msg.data() == b"x" and consumer.backlog() == 1
    consumer.acknowledge(msg)
    assert consumer.backlog() == 0
    with pytest.raises(ReceiveTimeout):
        consumer.receive(timeout_millis=10)


def test_columnar_store_dedup_and_scan():
    store = ColumnarEventStore()
    base = {
        "student_id": np.array([1, 2], np.uint32),
        "lecture_day": np.array([20260101, 20260102], np.uint32),
        "micros": np.array([10, 20], np.int64),
        "is_valid": torch.tensor([True, True]),  # device-style validity
        "event_type": np.array([0, 0], np.int8),
    }
    store.insert_columns(base)
    store.insert_columns({**base, "is_valid": np.array([False, True])})
    cols = store.to_columns()
    assert cols["student_id"].tolist() == [1, 2]
    assert cols["is_valid"].tolist() == [False, True]  # last write wins
    assert len(store.to_columns(deduplicate=False)["student_id"]) == 4
    assert store.scan_lecture("LECTURE_20260102")["student_id"].tolist() \
        == [2]


def _run_both(wire_format: str, monkeypatch):
    """The same frames through both pipelines (8 banks, 12 lectures: the
    register array grows to 16 banks mid-run)."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    capacity, num_events, frame = 3000, 24_000, 4096
    kw = dict(roster_size=2000, num_lectures=12, invalid_fraction=0.2,
              seed=17)
    jpipe = JaxPipeline(
        JaxConfig(bloom_filter_capacity=capacity, wire_format=wire_format,
                  transport_backend="memory"),
        client=JaxClient(JaxBroker()), num_banks=8)
    tpipe = FusedPipeline(
        Config(bloom_filter_capacity=capacity, wire_format=wire_format),
        num_banks=8, device="cpu")
    for pipe, gen in ((jpipe, jax_frames), (tpipe, generate_frames)):
        roster, frames = gen(num_events, frame, **kw)
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=num_events, idle_timeout_s=0.3)
    return jpipe, tpipe


@pytest.mark.parametrize("wire_format", ["auto", "bytes"])
def test_whole_slice_equals_jax_pipeline(wire_format, monkeypatch):
    jpipe, tpipe = _run_both(wire_format, monkeypatch)
    try:
        wire = "word" if wire_format == "auto" else "bytes"
        assert tpipe.metrics.wire_dwell == {wire: 6}
        assert jpipe.metrics.wire_dwell == tpipe.metrics.wire_dwell
        assert tpipe._bank_of == jpipe._bank_of
        assert tpipe.state.hll_regs.shape[0] == 16  # grew from 8
        tb, tr, tc = state_to_numpy(tpipe.state)
        np.testing.assert_array_equal(tb, np.asarray(jpipe.state.bloom_bits))
        np.testing.assert_array_equal(tr, np.asarray(jpipe.state.hll_regs))
        np.testing.assert_array_equal(tc, np.asarray(jpipe.state.counts))
        assert tpipe.validity_counts() == jpipe.validity_counts()
        assert sum(tpipe.validity_counts()) == 24_000
        assert tpipe.count_all() == jpipe.count_all()
        assert tpipe.lecture_days() == jpipe.lecture_days()
        for day in tpipe.lecture_days()[:3] + [19990101]:
            assert tpipe.count(day) == jpipe.count(day)
        assert tpipe.count(f"LECTURE_{tpipe.lecture_days()[0]}") == \
            jpipe.count(tpipe.lecture_days()[0])
        ours = tpipe.store.to_columns(deduplicate=False)
        theirs = jpipe.store.to_columns(deduplicate=False)
        for name in ("student_id", "lecture_day", "micros", "is_valid"):
            np.testing.assert_array_equal(ours[name], theirs[name])
        assert tpipe.consumer.backlog() == 0  # every frame acked
        assert tpipe.estimated_fpr() == pytest.approx(
            jpipe.estimated_fpr(), rel=1e-5)
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


def test_count_all_histograms_only_the_live_rows(monkeypatch):
    """count_all() histograms the rows a day was ever given (12 of the
    16 rows the array grew to) and still equals the JAX pipeline's,
    which histograms every row."""
    from attendance_tpu_torch.pipeline import fast_path

    jpipe, tpipe = _run_both("auto", monkeypatch)
    seen = []
    real = fast_path.best_histogram

    def spy(regs, precision):
        seen.append(tuple(regs.shape))
        return real(regs, precision)

    monkeypatch.setattr(fast_path, "best_histogram", spy)
    try:
        assert tpipe.state.hll_regs.shape[0] == 16
        assert tpipe.count_all() == jpipe.count_all()
        assert seen == [(12, 1 << 14)] and tpipe._next_bank == 12
        day = tpipe.lecture_days()[-1]
        assert tpipe.count(day) == jpipe.count(day)
        assert seen[-1] == (1, 1 << 14)
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


def test_fused_verb_meets_ground_truth_on_cpu():
    """The fused verb's flow: zero false negatives against the frames'
    ground truth, and every lecture's count near its exact uniques."""
    config = Config(bloom_filter_capacity=20_000)
    pipe, summary = run_fused(config, 60_000, 8192, 6, seed=4,
                              device="cpu")
    try:
        _, frames = generate_frames(60_000, 8192, roster_size=20_000,
                                    num_lectures=6, seed=4)
        cols = [decode_planar_batch(f) for f in frames]
        truth = np.concatenate([c["is_valid"] for c in cols])
        sid = np.concatenate([c["student_id"] for c in cols])
        day = np.concatenate([c["lecture_day"] for c in cols])
        got = pipe.store.to_columns(deduplicate=False)["is_valid"]
        assert not (truth & ~got).any()                 # no false negatives
        assert (got & ~truth).sum() / (~truth).sum() <= 0.015
        assert summary["valid"] + summary["invalid"] == 60_000
        stages = summary["stage_seconds"]
        assert list(stages) == list(STAGES)
        assert 0 < sum(stages.values()) <= summary["wall_seconds"]
        assert stages["decode"] > 0 and stages["dispatch"] > 0
        for d, est in summary["unique_attendees"].items():
            exact = len(np.unique(sid[(day == int(d)) & truth]))
            assert abs(est - exact) / exact <= 0.03
    finally:
        pipe.cleanup()


def test_cli_fused_on_cpu(capsys):
    cli_main(["fused", "--device", "cpu", "--num-events", "20000",
              "--frame-size", "4096", "--num-lectures", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    # The analyzer's insights come first (the JAX verb's order), then
    # one line per lecture, then the JSON summary.
    assert lines[0] == "=== Habitual Latecomers ==="
    assert [ln.split(":")[0] for ln in lines[-4:-1]] == [
        "LECTURE_20260701", "LECTURE_20260702", "LECTURE_20260703"]
    summary = json.loads(lines[-1])
    assert summary["device"] == "cpu"
    assert summary["events"] == 20_000
    assert summary["valid"] + summary["invalid"] == 20_000
