"""Checkpoint and restore of the port's fused pipeline, on the CPU.

Chains written by the JAX ``FusedPipeline`` restore in the port, and the
port's in the JAX package, with exactly equal registers, counters, bank
map, Bloom words and deduped store (barrier mode; delta mode with bank
growth and a compaction; the temporal plane on). The JAX package's
checkpoint scenarios (``tests/test_checkpoint_resume.py``,
``tests/test_delta_snapshot.py``, the chain half of
``tests/test_integrity.py``) run on the port, with the validity counters
held too: they are plain sums, so a frame acked by one snapshot and
replayed onto it would show. Tolerance 0 throughout.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.pipeline.loadgen import generate_frames as jax_frames
from attendance_tpu.transport.memory_broker import (
    MemoryBroker as JaxBroker, MemoryClient as JaxClient)
from attendance_tpu.utils import integrity as jintegrity
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models.fused import (
    snapshot_capture_base, snapshot_capture_rows, state_to_numpy)
from attendance_tpu_torch.native import load as load_native
from attendance_tpu_torch.pipeline import fast_path
from attendance_tpu_torch.pipeline.events import encode_planar_batch
from attendance_tpu_torch.pipeline.fast_path import (
    CHAIN_MANIFEST, EVENTS_SEGMENTS, SKETCH_SNAPSHOT, FusedPipeline,
    read_chain_state)
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.utils import integrity
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

NUM_EVENTS, BATCH = 16_384, 2_048
_COLS = ("student_id", "lecture_day", "micros", "is_valid")


def _mkframes(gen=generate_frames, seed=61):
    """Eight 2,048-event frames: 3 lectures, then 6, so a pipeline that
    starts with 4 banks grows to 8 between two barriers."""
    roster, a = gen(NUM_EVENTS // 2, BATCH, roster_size=6_000,
                    num_lectures=3, invalid_fraction=0.15, seed=seed)
    _, b = gen(NUM_EVENTS // 2, BATCH, roster_size=6_000, num_lectures=6,
               invalid_fraction=0.15, seed=seed + 1)
    return roster, list(a) + list(b)


def _cfg(snap_dir="", every=2, **kw):
    return Config(bloom_filter_capacity=20_000, snapshot_dir=snap_dir,
                  snapshot_every_batches=every if snap_dir else 0, **kw)


def _run(config, frames, roster, client=None, num_banks=4,
         max_events=NUM_EVENTS):
    pipe = FusedPipeline(config, client=client, num_banks=num_banks,
                         device="cpu")
    pipe.preload(roster)
    producer = pipe.client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=max_events, idle_timeout_s=0.3)
    return pipe


def _state(pipe):
    """Registers, counters, Bloom words, bank map and deduped store of a
    port pipeline or a JAX one."""
    if isinstance(pipe, FusedPipeline):
        bits, regs, counts = state_to_numpy(pipe.state)
    else:
        bits, regs, counts = (np.asarray(pipe.state.bloom_bits),
                              np.asarray(pipe.state.hll_regs),
                              np.asarray(pipe.state.counts))
    cols = pipe.store.to_columns()
    return dict(bits=bits, regs=regs, counts=counts,
                bank_of=dict(pipe._bank_of),
                store={n: np.asarray(cols[n]) for n in _COLS})


def _assert_same(a, b):
    for name in ("bits", "regs", "counts"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert a["bank_of"] == b["bank_of"]
    for name in _COLS:
        np.testing.assert_array_equal(a["store"][name], b["store"][name],
                                      err_msg=name)


# -- across the two packages --------------------------------------------------

_CROSS = {
    "barrier": dict(snapshot_mode="barrier", snapshot_every_batches=2),
    # every barrier a delta, folded into a base every third
    "delta": dict(snapshot_mode="delta", snapshot_every_batches=1,
                  snapshot_compact_every=3),
    # 10 frames, barriers every 3, evictions from the 10-row ring
    "temporal": dict(snapshot_mode="delta", snapshot_every_batches=3,
                     temporal_period_s=1.0, allowed_lateness_s=0.6,
                     temporal_ring_banks=10, cms_depth=3, cms_width=512,
                     cms_topk=5),
}


def _cross_stream(gen, case):
    if case == "temporal":
        roster, frames = gen(20_000, BATCH, roster_size=2000,
                             num_lectures=3, seed=23, disorder_frac=0.3,
                             late_max_s=1.5)
        return roster, list(frames), 20_000
    roster, frames = _mkframes(gen)
    return roster, frames, NUM_EVENTS


def _feed(pipe, frames, n, case):
    """The frames through ``pipe``; in delta mode one run per frame, so
    each ends in a durable barrier (a base, then seven deltas folded at
    the third and the sixth: deterministic however fast the writer)."""
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    if case != "delta":
        for f in frames:
            producer.send(f)
        pipe.run(max_events=n, idle_timeout_s=0.3)
        return pipe
    for f in frames:
        producer.send(f)
        pipe.run(max_events=BATCH, idle_timeout_s=0.3)
    return pipe


def _write_jax(snap, case):
    roster, frames, n = _cross_stream(jax_frames, case)
    cfg = JaxConfig(bloom_filter_capacity=20_000, transport_backend="memory",
                    snapshot_dir=str(snap), **_CROSS[case]).validate()
    pipe = JaxPipeline(cfg, client=JaxClient(JaxBroker()), num_banks=4)
    pipe.preload(roster)
    return _feed(pipe, frames, n, case)


def _write_port(snap, case):
    roster, frames, n = _cross_stream(generate_frames, case)
    pipe = FusedPipeline(Config(bloom_filter_capacity=20_000,
                                snapshot_dir=str(snap), **_CROSS[case]),
                         num_banks=4, device="cpu")
    pipe.preload(roster)
    return _feed(pipe, frames, n, case)


def _check_chain(snap, case, writer, reader):
    chain = json.loads((snap / CHAIN_MANIFEST).read_text())
    assert chain["base_digest"]
    if case == "delta":
        assert writer._delta_seq == 7 and len(chain["deltas"]) == 1
    assert writer.state.hll_regs.shape[0] > 4  # grew
    _assert_same(_state(writer), _state(reader))
    assert reader._events_restored == writer.metrics.events
    assert reader.validity_counts() == writer.validity_counts()
    assert reader.count_all() == writer.count_all()
    if case == "temporal":
        wc = reader.window_counts()
        assert wc and wc == writer.window_counts()
        assert sorted(reader._temporal.ring.buckets.items()) == \
            sorted(writer._temporal.ring.buckets.items())
        assert reader._free_banks == writer._free_banks
        assert writer.temporal_stats()["evictions"] > 0


@pytest.mark.parametrize("case", sorted(_CROSS))
def test_jax_written_chain_restores_in_port(case, tmp_path, monkeypatch):
    monkeypatch.setenv("ATP_NATIVE", "0")
    jobs.disable()
    snap = tmp_path / "snaps"
    jpipe = _write_jax(snap, case)
    tpipe = FusedPipeline(Config(bloom_filter_capacity=20_000,
                                 snapshot_dir=str(snap), **_CROSS[case]),
                          num_banks=4, device="cpu")
    try:
        _check_chain(snap, case, jpipe, tpipe)
    finally:
        jpipe.cleanup()
        tpipe.cleanup()
        jobs.disable()


@pytest.mark.parametrize("case", sorted(_CROSS))
def test_port_written_chain_restores_in_jax(case, tmp_path, monkeypatch):
    monkeypatch.setenv("ATP_NATIVE", "0")
    jobs.disable()
    snap = tmp_path / "snaps"
    tpipe = _write_port(snap, case)
    # The JAX package verifies the port's digests and reads its files.
    jintegrity.verify_file(snap / SKETCH_SNAPSHOT, json.loads(
        (snap / CHAIN_MANIFEST).read_text())["base_digest"])
    jpipe = JaxPipeline(JaxConfig(
        bloom_filter_capacity=20_000, transport_backend="memory",
        snapshot_dir=str(snap), **_CROSS[case]).validate(),
        client=JaxClient(JaxBroker()), num_banks=4)
    try:
        _check_chain(snap, case, tpipe, jpipe)
    finally:
        jpipe.cleanup()
        tpipe.cleanup()
        jobs.disable()


# -- the JAX package's checkpoint scenarios, on the port -----------------------

@pytest.mark.parametrize("mode", ["barrier", "delta"])
def test_crash_replay_resume_matches_uninterrupted(mode, tmp_path):
    roster, frames = _mkframes(seed=29)
    ref = _run(_cfg(), frames, roster)
    snap = tmp_path / "snaps"
    config = _cfg(str(snap), every=3, snapshot_mode=mode)
    broker = MemoryBroker()
    a = _run(config, frames, roster, client=MemoryClient(broker),
             max_events=int(NUM_EVENTS * 0.6))
    with np.load(snap / SKETCH_SNAPSHOT) as data:
        base_events = json.loads(bytes(data["manifest"]).decode())["events"]
    assert base_events <= a.metrics.events < NUM_EVENTS
    a.consumer.close()  # crash: unacked frames redeliver
    b = FusedPipeline(config, client=MemoryClient(broker), num_banks=4,
                      device="cpu")
    # Restored on construction: the counters are the acked prefix's.
    assert b.metrics.events == 0 and b.store.count() > 0
    assert sum(b.validity_counts()) == b._events_restored == a.metrics.events
    assert b.validity_counts() == a.validity_counts()
    b.run(idle_timeout_s=0.3)
    assert b.consumer.backlog() == 0
    _assert_same(_state(b), _state(ref))
    assert b.count_all() == ref.count_all()
    assert b.validity_counts() == ref.validity_counts()
    for p in (ref, a, b):
        p.cleanup()


def test_restore_requires_matching_filter_geometry(tmp_path):
    snap = tmp_path / "snaps"
    pipe = FusedPipeline(Config(bloom_filter_capacity=10_000,
                                snapshot_dir=str(snap)), num_banks=8,
                         device="cpu")
    pipe.preload(np.arange(100, dtype=np.uint32))
    pipe.snapshot()
    with pytest.raises(ValueError, match="capacity"):
        FusedPipeline(Config(bloom_filter_capacity=99_000,
                             snapshot_dir=str(snap)), device="cpu")
    with pytest.raises(ValueError, match="precision"):
        FusedPipeline(Config(bloom_filter_capacity=10_000, hll_precision=12,
                             snapshot_dir=str(snap)), device="cpu")


def test_restore_rejects_inconsistent_bank_manifest(tmp_path):
    snap = tmp_path / "snaps"
    config = Config(bloom_filter_capacity=10_000, snapshot_dir=str(snap))
    pipe = FusedPipeline(config, num_banks=8, device="cpu")
    pipe.preload(np.arange(100, dtype=np.uint32))
    pipe.snapshot()
    path = snap / SKETCH_SNAPSHOT
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    manifest = json.loads(bytes(arrays["manifest"]).decode())

    def rewrite(bank_of):
        manifest["bank_of"] = bank_of
        arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                           dtype=np.uint8)
        # The edited base no longer matches its recorded digest but
        # parses clean: read as the crash window, it reaches the check.
        with open(path, "wb") as f:
            np.savez_compressed(f, **arrays)

    rewrite({"20990101": arrays["hll_regs"].shape[0] + 3})
    with pytest.raises(ValueError, match="register banks"):
        FusedPipeline(config, num_banks=8, device="cpu")
    rewrite({"20260101": 0, "20260102": 0})
    with pytest.raises(ValueError, match="corrupt"):
        FusedPipeline(config, num_banks=8, device="cpu")


def test_restore_across_bank_dtype_boundary(tmp_path):
    """Growth past the uint8 bank dtype before the snapshot: the restore
    widens the bytes wire's bank dtype with the restored bank count."""
    config = Config(bloom_filter_capacity=4_096, wire_format="bytes",
                    snapshot_dir=str(tmp_path / "snap"))
    roster = np.arange(10_000, 12_000, dtype=np.uint32)
    n = 300
    cols = {
        "student_id": np.resize(roster[:4], n).astype(np.uint32),
        "lecture_day": (20260101 + np.arange(n)).astype(np.uint32),
        "micros": np.full(n, 1_000_000, np.int64),
        "is_valid": np.ones(n, bool),
        "event_type": np.zeros(n, np.int8),
    }
    a = _run(config, [encode_planar_batch(cols)], roster, num_banks=8,
             max_events=n)
    assert a._bank_dtype is np.uint16
    day = int(cols["lecture_day"][-1])  # a bank >= 256
    count_before = a.count(day)
    a.cleanup()
    b = FusedPipeline(config, num_banks=8, device="cpu")
    assert b.state.hll_regs.shape[0] >= 300
    assert b._bank_dtype is np.uint16
    assert b.count(day) == count_before >= 1
    producer = b.client.create_producer(config.pulsar_topic)
    cols["student_id"] = np.arange(10_000, 10_000 + n, dtype=np.uint32)
    producer.send(encode_planar_batch(cols))
    b.run(max_events=n, idle_timeout_s=0.2)
    assert b.count(day) > count_before
    b.cleanup()


@pytest.mark.parametrize("mode", ["barrier", "delta"])
def test_async_writer_defers_barriers_and_stays_durable(mode, tmp_path):
    """A writer slower than the cadence: barriers are deferred, yet every
    frame is acked only once durable, and a restore reproduces the
    finished run."""
    roster, frames = _mkframes(seed=41)
    snap = tmp_path / "snaps"
    config = _cfg(str(snap), every=1, snapshot_mode=mode)
    pipe = FusedPipeline(config, num_banks=4, device="cpu")

    def slow(fn):
        def wrapper(*args, **kwargs):
            time.sleep(0.12)
            return fn(*args, **kwargs)
        return wrapper

    pipe._write_snapshot_files = slow(pipe._write_snapshot_files)
    pipe._write_delta_files = slow(pipe._write_delta_files)
    pipe.preload(roster)
    producer = pipe.client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=NUM_EVENTS, idle_timeout_s=0.3)
    assert pipe.metrics.events == NUM_EVENTS
    assert pipe.consumer.backlog() == 0
    stalls = pipe.metrics.snapshot_stalls
    assert 1 <= len(stalls) <= len(frames) + 1
    assert all(s >= 0.12 for s in stalls)
    pipe2 = FusedPipeline(_cfg(str(snap)), num_banks=4, device="cpu")
    _assert_same(_state(pipe), _state(pipe2))
    assert pipe2.validity_counts() == pipe.validity_counts()
    pipe.cleanup()
    pipe2.cleanup()


def test_orphaned_delta_is_ignored_on_restore(tmp_path):
    roster, frames = _mkframes()
    snap = tmp_path / "snaps"
    pipe = _run(_cfg(str(snap)), frames, roster)
    assert json.loads((snap / CHAIN_MANIFEST).read_text())["deltas"]
    # Saturated registers in every bank: applying this would explode
    # every PFCOUNT.
    poison = {
        "bank_idx": np.arange(8, dtype=np.int32),
        "regs_rows": np.full((8, 1 << 14), 31, np.uint8),
        "counts": np.zeros((2, 2), np.uint32),
        "manifest": np.frombuffer(json.dumps(
            {"bank_of": {str(d): b for d, b in pipe._bank_of.items()},
             "events": 10 ** 9, "num_banks": 8}).encode(), np.uint8),
    }
    with open(snap / "delta-9999.npz", "wb") as f:
        np.savez(f, **poison)
    pipe2 = FusedPipeline(_cfg(str(snap)), num_banks=4, device="cpu")
    _assert_same(_state(pipe), _state(pipe2))
    assert pipe2.validity_counts() == pipe.validity_counts()
    assert pipe2._delta_seq == 9999  # the next delta skips past it
    pipe.cleanup()
    pipe2.cleanup()


def test_writer_crash_before_manifest_rename_loses_nothing(tmp_path):
    """A power cut at the third manifest rename: that write and every
    later one fail. The restore equals the last complete manifest, its
    counters exactly the events that manifest covers, and draining the
    redelivered frames lands on the uninterrupted run."""
    roster, frames = _mkframes(seed=67)
    ref = _run(_cfg(), frames, roster)
    snap = tmp_path / "snaps"
    config = _cfg(str(snap))
    broker = MemoryBroker()
    a = FusedPipeline(config, client=MemoryClient(broker), num_banks=4,
                      device="cpu")
    calls = {"n": 0}
    orig = a._write_chain_manifest

    def crashing_manifest():
        calls["n"] += 1
        if calls["n"] >= 3:
            raise OSError("simulated crash before manifest rename")
        orig()

    def dead_after_cut(fn):
        def wrapper(*args, **kwargs):
            if calls["n"] >= 3:
                raise OSError("simulated power cut")
            return fn(*args, **kwargs)
        return wrapper

    a._write_chain_manifest = crashing_manifest
    a._write_snapshot_files = dead_after_cut(a._write_snapshot_files)
    a._write_delta_files = dead_after_cut(a._write_delta_files)
    a.preload(roster)
    producer = a.client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    a.run(max_events=NUM_EVENTS, idle_timeout_s=0.3)
    assert a.consumer.backlog() > 0  # the failed barriers acked nothing
    a.consumer.close()
    chain = json.loads((snap / CHAIN_MANIFEST).read_text())
    assert set(chain["deltas"]) < {p.name for p in snap.glob("delta-*.npz")}
    last = snap / (chain["deltas"][-1] if chain["deltas"]
                   else SKETCH_SNAPSHOT)
    with np.load(last) as d:
        events_at = json.loads(bytes(d["manifest"]).decode())["events"]
    b = FusedPipeline(config, client=MemoryClient(broker), num_banks=4,
                      device="cpu")
    assert sum(b.validity_counts()) == events_at < NUM_EVENTS
    b.run(idle_timeout_s=0.3)
    assert b.consumer.backlog() == 0
    _assert_same(_state(b), _state(ref))
    assert b.validity_counts() == ref.validity_counts()
    for p in (ref, a, b):
        p.cleanup()


@pytest.mark.parametrize("victim", ["base", "delta"])
def test_failed_write_fails_queued_deltas_and_self_heals(victim, tmp_path):
    """The run's first base write (or first delta write) fails: the jobs
    staged behind it fail too, the next barrier writes a fresh base,
    and that base acks the failed jobs' frames, whose effects it holds.
    The run ends with every frame acked, and a restore equals the
    uninterrupted run, counters included."""
    roster, frames = _mkframes(seed=79)
    ref = _run(_cfg(), frames, roster)
    snap = tmp_path / "snaps"
    config = _cfg(str(snap))
    a = FusedPipeline(config, num_banks=4, device="cpu")
    name = "_write_snapshot_files" if victim == "base" else \
        "_write_delta_files"
    orig = getattr(a, name)
    calls = {"n": 0}

    def failing(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(f"simulated {victim} write failure")
        return orig(*args, **kwargs)

    setattr(a, name, failing)
    a.preload(roster)
    producer = a.client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    a.run(max_events=NUM_EVENTS, idle_timeout_s=0.3)
    assert calls["n"] >= (2 if victim == "base" else 1)  # a base retried
    assert a.consumer.backlog() == 0 and not a._snap_unacked
    b = FusedPipeline(config, num_banks=4, device="cpu")
    _assert_same(_state(b), _state(ref))
    assert b.validity_counts() == ref.validity_counts()
    for p in (ref, a, b):
        p.cleanup()


def test_chain_compaction_folds_into_base(tmp_path):
    roster, frames = _mkframes(seed=71)
    snap = tmp_path / "snaps"
    config = _cfg(str(snap), every=1, snapshot_compact_every=3)
    pipe = FusedPipeline(config, num_banks=4, device="cpu")
    pipe.preload(roster)
    producer = pipe.client.create_producer(config.pulsar_topic)
    for f in frames:
        # One frame per run: one durable write per frame.
        producer.send(f)
        pipe.run(max_events=BATCH, idle_timeout_s=0.2)
    chain = json.loads((snap / CHAIN_MANIFEST).read_text())
    assert pipe._delta_seq >= 3 and len(chain["deltas"]) < 3
    assert {p.name for p in snap.glob("delta-*.npz")} == set(chain["deltas"])
    pipe2 = FusedPipeline(config, num_banks=4, device="cpu")
    _assert_same(_state(pipe), _state(pipe2))
    assert pipe2.validity_counts() == pipe.validity_counts()
    pipe.cleanup()
    pipe2.cleanup()


def test_compaction_persists_only_its_own_barriers_blocks(tmp_path):
    """The writer's compaction saves the event segments up to the
    delta's barrier, never the blocks appended after it (on the card a
    later block's validity may still be being written on the compute
    stream). Every save_segments call off the main thread carries the
    job's mark."""
    import threading

    roster, frames = _mkframes(seed=73)
    snap = tmp_path / "snaps"
    config = _cfg(str(snap), every=1, snapshot_compact_every=1)
    pipe = FusedPipeline(config, num_banks=4, device="cpu")
    calls = []
    real = pipe.store.save_segments

    def record(dir_path, upto=None):
        if threading.current_thread() is not threading.main_thread():
            calls.append(upto)
        return real(dir_path, upto=upto)

    pipe.store.save_segments = record
    pipe.preload(roster)
    producer = pipe.client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=NUM_EVENTS, idle_timeout_s=0.3)
    assert pipe._delta_seq >= 2  # compactions ran
    assert calls and None not in calls
    pipe2 = FusedPipeline(config, num_banks=4, device="cpu")
    _assert_same(_state(pipe), _state(pipe2))
    assert pipe2.validity_counts() == pipe.validity_counts()
    pipe.cleanup()
    pipe2.cleanup()


def test_restore_numbers_deltas_past_a_compacted_base(tmp_path):
    """A compaction deletes the deltas it folds and fences the base at
    their sequence number. A successor restored from it (no preload)
    numbers its deltas past that fence, so a second restore applies
    them and equals the uninterrupted run (numbered from the files
    alone, they would be skipped as stale and acked frames lost)."""
    roster, frames = _mkframes(seed=79)
    ref = _run(_cfg(), frames[:4], roster, max_events=4 * BATCH)
    snap = tmp_path / "snaps"
    config = _cfg(str(snap), every=1, snapshot_compact_every=2)
    a = FusedPipeline(config, num_banks=4, device="cpu")
    a.preload(roster)
    producer = a.client.create_producer(config.pulsar_topic)
    for f in frames[:3]:
        # One frame per run: a base, then two deltas folded by a
        # compaction.
        producer.send(f)
        a.run(max_events=BATCH, idle_timeout_s=0.2)
    a.cleanup()
    chain = json.loads((snap / CHAIN_MANIFEST).read_text())
    with np.load(snap / SKETCH_SNAPSHOT) as data:
        fence = json.loads(bytes(data["manifest"]).decode())["chain_seq"]
    assert chain["deltas"] == [] and not list(snap.glob("delta-*.npz"))
    assert fence >= 2
    b = FusedPipeline(config, num_banks=4, device="cpu")
    assert b._delta_seq == fence
    producer = b.client.create_producer(config.pulsar_topic)
    producer.send(frames[3])
    b.run(max_events=BATCH, idle_timeout_s=0.2)
    assert b.consumer.backlog() == 0
    assert json.loads((snap / CHAIN_MANIFEST).read_text())["deltas"] == [
        f"delta-{fence + 1:04d}.npz"]
    c = FusedPipeline(config, num_banks=4, device="cpu")
    _assert_same(_state(c), _state(ref))
    assert c.validity_counts() == ref.validity_counts()
    for p in (ref, b, c):
        p.cleanup()


def test_stale_deltas_after_base_replace_crash_are_skipped(tmp_path):
    roster, frames = _mkframes(seed=83)
    snap = tmp_path / "snaps"
    config = _cfg(str(snap))
    pipe = _run(config, frames, roster)
    assert json.loads((snap / CHAIN_MANIFEST).read_text())["deltas"]
    want = _state(pipe)

    def crash(*a, **kw):
        raise OSError("simulated crash before chain-manifest reset")

    pipe._write_chain_manifest = crash
    with pytest.raises(OSError):
        pipe.snapshot()  # the base is replaced, the old deltas stay named
    assert json.loads((snap / CHAIN_MANIFEST).read_text())["deltas"]
    pipe2 = FusedPipeline(config, num_banks=4, device="cpu")
    assert pipe2._snap_chain == []
    _assert_same(want, _state(pipe2))
    pipe.cleanup()
    pipe2.cleanup()


def test_delta_restores_across_bank_growth(tmp_path):
    """A job staged before growth carries the old bank count, the next
    one the new: the restore grows the registers before applying rows."""
    config = Config(bloom_filter_capacity=4_096,
                    snapshot_dir=str(tmp_path / "snap"),
                    snapshot_every_batches=1)
    a = FusedPipeline(config, num_banks=4, device="cpu")
    roster = np.arange(10_000, 12_000, dtype=np.uint32)
    a.preload(roster)
    producer = a.client.create_producer(config.pulsar_topic)

    def frame(days):
        n = len(days)
        return encode_planar_batch({
            "student_id": np.resize(roster[:4], n).astype(np.uint32),
            "lecture_day": np.asarray(days, np.uint32),
            "micros": 1_000_000 + np.arange(n, dtype=np.int64),
            "is_valid": np.ones(n, bool),
            "event_type": np.zeros(n, np.int8)})

    producer.send(frame([20260101, 20260102]))
    a.run(max_events=2, idle_timeout_s=0.2)  # barrier -> full base
    producer.send(frame([20260110 + i for i in range(12)]))  # 4 -> 16
    a.run(max_events=12, idle_timeout_s=0.2)  # barrier -> delta
    a.cleanup()
    assert a.state.hll_regs.shape[0] == 16
    chain = json.loads((tmp_path / "snap" / CHAIN_MANIFEST).read_text())
    assert len(chain["deltas"]) == 1
    b = FusedPipeline(config, num_banks=4, device="cpu")
    _assert_same(_state(a), _state(b))


def _chain_with_delta(tmp_path):
    """A chain with a base and deltas after it (the JAX integrity tests'
    ``_run_chain``): the run, an explicit base, two more frames."""
    roster, frames = _mkframes(seed=61)
    snap = tmp_path / "snaps"
    config = _cfg(str(snap))
    pipe = _run(config, frames, roster)
    pipe.snapshot()
    producer = pipe.client.create_producer(config.pulsar_topic)
    for f in frames[:2]:
        producer.send(f)
    pipe.run(max_events=2 * BATCH, idle_timeout_s=0.3)
    want = _state(pipe)
    pipe.cleanup()
    chain = json.loads((snap / CHAIN_MANIFEST).read_text())
    assert chain["deltas"] and chain["digests"]
    return snap, config, chain, want


def _flip_mid_byte(path):
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


def _truncate(path):
    path.write_bytes(path.read_bytes()[:path.stat().st_size // 2])


@pytest.mark.parametrize("corruption,kind", [
    ("flip", "digest_mismatch"), ("truncate", "digest_mismatch"),
    ("truncate_legacy", "unreadable"), ("torn_manifest", "torn_manifest"),
    ("missing", "missing")])
def test_corrupt_chain_is_classified_and_repaired(corruption, kind,
                                                  tmp_path):
    """Every corruption class raises its classified error from the chain
    reader (the JAX reader classifies it alike); the port's restore
    quarantines the artifact, truncates the chain to its good prefix and
    writes a fresh base that verifies end to end."""
    snap, config, chain, want = _chain_with_delta(tmp_path)
    victim = snap / chain["deltas"][-1]
    if corruption == "flip":
        _flip_mid_byte(victim)
    elif corruption.startswith("truncate"):
        if corruption == "truncate_legacy":  # a chain with no digests
            doc = json.loads((snap / CHAIN_MANIFEST).read_text())
            doc.pop("digests")
            doc.pop("base_digest")
            (snap / CHAIN_MANIFEST).write_text(json.dumps(doc))
        _truncate(victim)
    elif corruption == "torn_manifest":
        victim = snap / CHAIN_MANIFEST
        _truncate(victim)
    else:
        victim.unlink()
    with pytest.raises(integrity.ChainIntegrityError) as ours:
        read_chain_state(snap)
    assert ours.value.kind == kind and ours.value.path.name == victim.name
    from attendance_tpu.pipeline.fast_path import (
        read_chain_state as jax_read_chain_state)
    with pytest.raises(jintegrity.ChainIntegrityError) as theirs:
        jax_read_chain_state(snap)
    assert theirs.value.kind == kind

    pipe = FusedPipeline(config, num_banks=4, device="cpu")
    try:
        quarantined = snap / integrity.QUARANTINE_SUBDIR / victim.name
        assert quarantined.exists() == (corruption != "missing")
        if quarantined.exists():
            meta = json.loads(quarantined.with_name(
                victim.name + ".quarantine.json").read_text())
            assert meta["reason"] == kind
        man = json.loads((snap / CHAIN_MANIFEST).read_text())
        assert man["deltas"] == []  # a fresh base supersedes the chain
        assert not pipe._base_stale and pipe._writer_base_ok
        assert pipe._events_restored > 0
        state = read_chain_state(snap)  # verifies, must not raise
        assert state["applied"] == []
        # The restored state is the chain's good prefix: the registers
        # never exceed the full chain's.
        assert (state["regs"] <= want["regs"][:state["regs"].shape[0]]).all()
    finally:
        pipe.cleanup()


def test_corrupt_base_starts_empty_loudly(tmp_path):
    snap, config, _, _ = _chain_with_delta(tmp_path)
    _flip_mid_byte(snap / SKETCH_SNAPSHOT)
    pipe = FusedPipeline(config, num_banks=4, device="cpu")
    try:
        assert pipe._events_restored == 0
        assert (snap / integrity.QUARANTINE_SUBDIR / SKETCH_SNAPSHOT).exists()
    finally:
        pipe.cleanup()


def test_rotted_event_segment_is_quarantined(tmp_path):
    snap, config, _, want = _chain_with_delta(tmp_path)
    segs = sorted((snap / EVENTS_SEGMENTS).glob("segment-*.npz"))
    assert segs
    _flip_mid_byte(segs[0])
    pipe = FusedPipeline(config, num_banks=4, device="cpu")
    try:
        got = _state(pipe)
        for name in ("bits", "regs", "counts"):
            np.testing.assert_array_equal(got[name], want[name])
        qdir = snap / EVENTS_SEGMENTS / integrity.QUARANTINE_SUBDIR
        assert any(qdir.glob("segment-*.npz"))
        assert 0 < pipe.store.count() < len(want["store"]["student_id"])
    finally:
        pipe.cleanup()


def test_restored_free_bank_reallocates_clean(tmp_path):
    """An evicted bucket's row is a hole in the restored bank map while
    the chain still holds its registers: restore zeroes it, so a new day
    allocated into it counts only its own students."""
    config = Config(bloom_filter_capacity=50_000, temporal_period_s=2.0,
                    allowed_lateness_s=1.6, temporal_ring_banks=64,
                    snapshot_dir=str(tmp_path), snapshot_every_batches=4)
    roster, frames = generate_frames(20_000, BATCH, roster_size=5_000,
                                     num_lectures=4, seed=7)
    pipe = _run(config, list(frames), roster, num_banks=16,
                max_events=20_000)
    ring = pipe._temporal.ring
    key = next(iter(ring.buckets))
    bank = ring.buckets.pop(key)
    assert pipe.state.hll_regs[bank].any()
    pipe._free_temporal_buckets([key], [bank])
    pipe._checkpoint_async(force=True)
    pipe._flush_snapshots()
    pipe.cleanup()
    pipe2 = FusedPipeline(config, num_banks=16, device="cpu")
    assert bank in pipe2._free_banks
    new_day = 20_991_231
    sids = np.array(sorted(roster)[:3], np.uint32)
    producer = pipe2.client.create_producer(config.pulsar_topic)
    producer.send(encode_planar_batch({
        "student_id": sids, "lecture_day": np.full(3, new_day, np.uint32),
        "micros": np.array([10 ** 15] * 3, np.int64),
        "is_valid": np.ones(3, bool), "event_type": np.zeros(3, np.int8)}))
    holes = list(pipe2._free_banks)
    pipe2.run(max_events=3, idle_timeout_s=0.3)
    assert pipe2._bank_of[new_day] in holes
    assert pipe2.count(new_day) == 3
    pipe2.cleanup()


# -- the pieces ---------------------------------------------------------------

def test_snapshot_capture_rows_and_base():
    regs = torch.randint(0, 40, (8, 64), dtype=torch.uint8)
    counts = torch.tensor([[5, 0], [7, 1]], dtype=torch.int32)
    idx = torch.tensor([3, 1, 0, 0], dtype=torch.int64)
    rows, c = snapshot_capture_rows(regs, idx, counts)
    base, c2 = snapshot_capture_base(regs, counts)
    want_rows = regs[[3, 1, 0, 0]].clone()
    regs.add_(1)  # the steps update the state in place: copies stay
    counts.add_(1)
    assert torch.equal(rows, want_rows)
    assert torch.equal(c, c2) and c.tolist() == [[5, 0], [7, 1]]
    assert torch.equal(base + 1, regs)
    assert FusedPipeline._pad_bank_index(np.arange(9)).tolist() == \
        list(range(9)) + [0] * 7


@pytest.mark.parametrize("native", [True, False])
def test_dedup_native_and_numpy_keep_the_same_rows(native, monkeypatch):
    monkeypatch.setenv("ATP_NATIVE", "1" if native else "0")
    assert (load_native() is not None) == native
    rng = np.random.default_rng(3)
    n = 50_000
    cols = {"lecture_day": rng.integers(20260101, 20260105, n).astype(
                np.uint32),
            "student_id": rng.integers(0, 500, n).astype(np.uint32),
            "micros": rng.integers(0, 40, n).astype(np.int64)}
    keep = ColumnarEventStore._dedup_keep(cols)
    from attendance_tpu.storage.columnar_store import (
        ColumnarEventStore as JaxStore)
    monkeypatch.setenv("ATP_NATIVE", "0")
    want = JaxStore._dedup_keep(cols)
    np.testing.assert_array_equal(keep, want)
    assert 0 < len(keep) < n


def test_store_reads_and_segments_match_jax(tmp_path):
    from attendance_tpu.storage.columnar_store import (
        ColumnarEventStore as JaxStore)
    from attendance_tpu.pipeline.events import (
        decode_planar_batch as jax_decode)

    _, frames = _mkframes(seed=5)
    ours, theirs = ColumnarEventStore(), JaxStore()
    for f in frames:
        cols = jax_decode(f)
        ours.insert_columns(cols)
        theirs.insert_columns(cols)
        theirs.insert_columns(cols)  # replayed: the dedup folds it
        ours.insert_columns(cols)
    assert ours.count() == theirs.count()
    assert ours.distinct_lecture_days() == theirs.distinct_lecture_days()
    assert ours.distinct_lecture_ids() == theirs.distinct_lecture_ids()
    sid = int(ours.to_columns()["student_id"][7])
    for name in _COLS:
        np.testing.assert_array_equal(ours.scan_student(sid)[name],
                                      theirs.scan_student(sid)[name])
    # Segments and the one-shot save, read across the packages.
    ours.save_segments(tmp_path / "ours", upto=5)
    ours.save_segments(tmp_path / "ours")
    ours.save(tmp_path / "ours.npz")
    loaded_j, loaded_t = JaxStore(), ColumnarEventStore()
    loaded_j.load_segments(tmp_path / "ours")
    loaded_t.load(tmp_path / "ours.npz")
    assert ours.compact_segments(tmp_path / "ours", min_segments=2) == 2
    merged = ColumnarEventStore()
    merged.load_segments(tmp_path / "ours")
    want = theirs.to_columns()
    for store in (loaded_j, loaded_t, merged):
        got = store.to_columns()
        for name in _COLS:
            np.testing.assert_array_equal(np.asarray(got[name]), want[name])


def test_failed_segment_write_keeps_its_blocks_pending(tmp_path,
                                                       monkeypatch):
    """The port's departure from the JAX store: a failed segment write
    leaves its blocks for the next call instead of skipping them."""
    store = ColumnarEventStore()
    cols = {"student_id": np.arange(4, dtype=np.uint32),
            "lecture_day": np.full(4, 20260101, np.uint32),
            "micros": np.arange(4, dtype=np.int64),
            "is_valid": torch.ones(4, dtype=torch.bool),
            "event_type": np.zeros(4, np.int8)}
    store.insert_columns(cols)
    real = np.savez

    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(np, "savez", full_disk)
    with pytest.raises(OSError):
        store.save_segments(tmp_path)
    monkeypatch.setattr(np, "savez", real)
    store.insert_columns(dict(cols, micros=cols["micros"] + 10))
    assert store.save_segments(tmp_path) == 8
    again = ColumnarEventStore()
    assert again.load_segments(tmp_path) == 8
    assert [p.name for p in tmp_path.glob("segment-*.npz")] == \
        ["segment-00000001.npz"]


def test_save_segments_fsyncs_file_and_directory(tmp_path, monkeypatch):
    """A segment is durable before the caller's manifest rename acks its
    frames: the file is fsynced before its rename, the directory after
    it (the port's departure: the JAX store fsyncs neither)."""
    from attendance_tpu_torch.storage import columnar_store

    events = []
    real_fsync, real_replace = columnar_store.os.fsync, Path.replace
    monkeypatch.setattr(columnar_store.os, "fsync",
                        lambda fd: (events.append("fsync"), real_fsync(fd)))
    monkeypatch.setattr(Path, "replace",
                        lambda self, t: (events.append("rename"),
                                         real_replace(self, t))[1])
    monkeypatch.setattr(columnar_store, "fsync_dir",
                        lambda d: events.append(("dir", Path(d))))
    store = ColumnarEventStore()
    store.insert_columns({"student_id": np.arange(4, dtype=np.uint32),
                          "lecture_day": np.full(4, 20260101, np.uint32),
                          "micros": np.arange(4, dtype=np.int64),
                          "is_valid": np.ones(4, bool),
                          "event_type": np.zeros(4, np.int8)})
    assert store.save_segments(tmp_path) == 4
    assert events == ["fsync", "rename", ("dir", tmp_path)]


def test_consumer_close_requeues_unacked_in_order():
    broker = MemoryBroker()
    client = MemoryClient(broker)
    producer = client.create_producer("t")
    a = client.subscribe("t", "s")
    for i in range(5):
        producer.send(bytes([i]))
    got = [a.receive(timeout_millis=50) for _ in range(3)]
    a.acknowledge(got[1])
    a.close()
    with pytest.raises(RuntimeError):
        a.receive(timeout_millis=10)
    b = MemoryClient(broker).subscribe("t", "s")
    order = [b.receive(timeout_millis=50).data()[0] for _ in range(4)]
    assert order == [0, 2, 3, 4]  # the dead window first, in order
    assert b.backlog() == 4


def test_snapshot_config_matches_jax():
    ours, theirs = Config(), JaxConfig()
    for name in ("snapshot_dir", "snapshot_every_batches", "snapshot_mode",
                 "snapshot_compact_every", "integrity"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert fast_path.DEFAULT_SNAPSHOT_EVERY == 64
    for bad in (dict(snapshot_mode="full"), dict(snapshot_compact_every=0)):
        with pytest.raises(ValueError):
            Config(**bad)
        with pytest.raises(ValueError):
            JaxConfig(**bad).validate()


def test_integrity_off_writes_no_digests(tmp_path):
    roster, frames = _mkframes()
    snap = tmp_path / "snaps"
    pipe = _run(_cfg(str(snap), integrity=False), frames, roster)
    doc = json.loads((snap / CHAIN_MANIFEST).read_text())
    assert "digests" not in doc and "base_digest" not in doc
    pipe2 = FusedPipeline(_cfg(str(snap)), num_banks=4, device="cpu")
    _assert_same(_state(pipe), _state(pipe2))
    pipe.cleanup()
    pipe2.cleanup()
    assert integrity.bytes_digest(b"abc") == jintegrity.bytes_digest(b"abc")

