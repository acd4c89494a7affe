"""The port's federation plane (``attendance_tpu_torch/federation``)
against the JAX package's (``tests/test_federation.py`` and the peer
re-assert cases of ``tests/test_integrity.py``, without telemetry): the
CRDT joins and their numpy twins, the merge-frame wire byte for byte in
both directions, the shard map and the worker's workload, the merge core
folding the same payloads in both packages, fence gossip end to end
with port and JAX workers whose payloads each package folds, dead-peer
chain recovery, takeover, a failed gossip publish, the repair ladder's
peer rung, the ``federate`` verb and the worker entry point. Tolerance
0: every sketch and counter is an integer.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.federation import frames as jframes
from attendance_tpu.federation import gossip as jgossip
from attendance_tpu.federation import merge as jmerge
from attendance_tpu.federation import shard as jshard
from attendance_tpu.federation import worker as jworker
from attendance_tpu.models import bloom as jbloom
from attendance_tpu.models import hll as jhll
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.transport import memory_broker as jbroker
from attendance_tpu_torch import cli
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.federation import frames, gossip, merge, shard
from attendance_tpu_torch.federation import worker
from attendance_tpu_torch.federation.gossip import (
    Aggregator, claim_incarnation)
from attendance_tpu_torch.federation.merge import GeometryMismatch, MergedView
from attendance_tpu_torch.models import bloom, hll
from attendance_tpu_torch.pipeline.fast_path import (
    CHAIN_MANIFEST, SKETCH_SNAPSHOT, FusedPipeline)
from attendance_tpu_torch.pipeline.loadgen import (
    frame_from_columns, generate_frames, synth_columns)
from attendance_tpu_torch.serve.engine import QueryEngine
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.transport.socket_broker import BrokerServer
from attendance_tpu_torch.utils import integrity
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
M = 1 << 8  # register width of the property tests


@pytest.fixture(autouse=True)
def _no_jax_telemetry():
    jobs.disable()
    yield
    jobs.disable()


def _rand_words(rng, n=64):
    return rng.integers(0, 1 << 32, n, dtype=np.uint32)


def _rand_regs(rng, banks, m=M):
    return rng.integers(0, 51, (banks, m), dtype=np.uint8)


# -- CRDT joins ----------------------------------------------------------------

def test_bloom_or_words_equal_jax_and_crdt():
    rng = np.random.default_rng(0)
    a, b, c = (_rand_words(rng) for _ in range(3))
    ours = bloom.bloom_or_words_np(a, b)
    assert np.array_equal(ours, jbloom.bloom_or_words_np(a, b))
    as_t = [torch.from_numpy(x.view(np.int32)) for x in (a, b)]
    tensor = bloom.bloom_or_words(*as_t).numpy().view(np.uint32)
    assert np.array_equal(tensor, ours)
    assert np.array_equal(tensor, np.asarray(
        jbloom.bloom_or_words(jnp.asarray(a), jnp.asarray(b))))
    or_ = bloom.bloom_or_words_np
    assert np.array_equal(or_(a, b), or_(b, a))
    assert np.array_equal(or_(or_(a, b), c), or_(a, or_(b, c)))
    assert np.array_equal(or_(a, a), a)
    assert np.array_equal(or_(ours, b), ours)


def test_bloom_or_words_geometry_mismatch_raises_in_both():
    rng = np.random.default_rng(1)
    a, b = _rand_words(rng, 64), _rand_words(rng, 32)
    with pytest.raises(ValueError, match="shapes differ"):
        bloom.bloom_or_words_np(a, b)
    with pytest.raises(ValueError, match="shapes differ"):
        jbloom.bloom_or_words_np(a, b)
    with pytest.raises(ValueError, match="shapes differ"):
        bloom.bloom_or_words(torch.from_numpy(a.view(np.int32)),
                             torch.from_numpy(b.view(np.int32)))


@pytest.mark.parametrize("banks", [(4, 4), (2, 5)])
def test_hll_merge_np_equal_jax_and_crdt(banks):
    rng = np.random.default_rng(3 + banks[1])
    a, b, c = (_rand_regs(rng, n) for n in (banks[0], banks[1], banks[1]))
    ours = hll.hll_merge_np(a, b)
    assert np.array_equal(ours, jhll.hll_merge_np(a, b))
    assert ours.shape == (max(banks), M)
    assert np.array_equal(ours[:banks[0]], np.maximum(a, b[:banks[0]]))
    assert np.array_equal(ours, hll.hll_merge_np(b, a))
    assert np.array_equal(hll.hll_merge_np(ours, c),
                          hll.hll_merge_np(a, hll.hll_merge_np(b, c)))
    assert np.array_equal(hll.hll_merge_np(a, a), a)
    with pytest.raises(ValueError):
        hll.hll_merge_np(_rand_regs(rng, 2, 64), _rand_regs(rng, 2, 128))


# -- the merge-frame wire ----------------------------------------------------------

def _frame_kwargs(kind, rng):
    kw = dict(worker="w3", kind=kind, incarnation=1_760_000_000.25, seq=7,
              shard=2, fence_ts=1_760_000_001.5, events=123_456,
              bank_of={20260701: 1, 20260702: 0}, m_bits=1 << 12, k=5,
              precision=14, num_banks=2, roster_size=4_000,
              snapshot_dir="/chains/w3", traceparent="")
    if kind == "full":
        kw["arrays"] = {"regs": _rand_regs(rng, 2, 1 << 14),
                        "counts": np.array([[9, 1], [4, 0]], np.uint32),
                        "bloom": _rand_words(rng, 128)}
    elif kind == "delta":
        kw["arrays"] = {"bank_idx": np.array([1, 0], np.int32),
                        "rows": _rand_regs(rng, 2, 1 << 14),
                        "counts": np.array([[9, 1], [4, 0]], np.uint32)}
    return kw


@pytest.mark.parametrize("kind", frames.KINDS)
def test_encode_frame_bytes_equal_and_cross_decode(kind):
    kw = _frame_kwargs(kind, np.random.default_rng(7))
    ours = frames.encode_frame(**kw)
    theirs = jframes.encode_frame(**kw)
    assert ours == theirs
    for decode in (frames.decode_frame, jframes.decode_frame):
        got = decode(theirs if decode is frames.decode_frame else ours)
        assert got.kind == kind and got.worker == "w3"
        assert got.bank_of == kw["bank_of"]
        assert got.incarnation == kw["incarnation"] and got.seq == 7
        assert got.traceparent == ""
        assert sorted(got.arrays) == sorted(kw.get("arrays", {}))
        for name, arr in kw.get("arrays", {}).items():
            assert got.arrays[name].dtype == arr.dtype
            assert np.array_equal(got.arrays[name], arr)


def test_frame_version_gate_and_unknown_kind_match_jax():
    kw = _frame_kwargs("heartbeat", np.random.default_rng(8))
    payload = bytearray(frames.encode_frame(**kw))
    payload[0:2] = (frames.FRAME_VERSION + 1).to_bytes(2, "little")
    for decode in (frames.decode_frame, jframes.decode_frame):
        with pytest.raises(ValueError, match="version 2"):
            decode(bytes(payload))
    for encode in (frames.encode_frame, jframes.encode_frame):
        with pytest.raises(ValueError, match="unknown merge-frame kind"):
            encode(worker="w0", kind="gossip?", incarnation=1.0, seq=0,
                   shard=0, fence_ts=0.0, events=0)
    assert frames.FRAME_VERSION == jframes.FRAME_VERSION
    assert frames.KINDS == jframes.KINDS


# -- shard map and workload --------------------------------------------------------

def test_shard_of_keys_and_shard_map_equal_jax():
    keys = np.random.default_rng(9).integers(0, 1 << 32, 50_000,
                                             dtype=np.uint32)
    for k in (1, 2, 3, 4, 7):
        ours = shard.shard_of_keys(keys, k)
        assert ours.dtype == np.int64
        assert np.array_equal(ours, jshard.shard_of_keys(keys, k))
    counts = np.bincount(shard.shard_of_keys(keys, 4), minlength=4)
    assert counts.min() > len(keys) // 8
    assert shard.SHARD_SEED == jshard.SHARD_SEED
    assert shard.shard_topic("events", 2) == jshard.shard_topic("events", 2)
    maps = (shard.ShardMap(3), jshard.ShardMap(3))
    script = [("claim", 0, "w0"), ("claim", 1, "w1"), ("claim", 2, "w2"),
              ("claim", 0, "w0"), ("reassign", "w1", None),
              ("claim", 1, "w9"), ("claim", 2, "w9"),
              ("reassign", "w9", "w4"), ("reassign", "nobody", None)]
    for op, *args in script:
        assert getattr(maps[0], op)(*args) == getattr(maps[1], op)(*args)
        assert maps[0].to_dict() == maps[1].to_dict()
    assert maps[0].version == 4 and maps[0].shards_of("w4") == [1, 2]
    for m in maps:
        with pytest.raises(ValueError):
            m.claim(5, "w0")
    with pytest.raises(ValueError):
        shard.ShardMap(0)


@pytest.mark.parametrize("seed,num_shards", [(0, 1), (5, 3), (11, 4)])
def test_build_workload_equals_jax(seed, num_shards):
    for s in range(num_shards):
        ours = worker.build_workload(seed, s, num_shards, 3 * 1_000 + 17,
                                     roster_size=4_000, batch=1_000)
        theirs = jworker.build_workload(seed, s, num_shards, 3 * 1_000 + 17,
                                        roster_size=4_000, batch=1_000)
        assert np.array_equal(ours[0], theirs[0])
        assert np.array_equal(ours[1], theirs[1])
        assert ours[2] == theirs[2]
    assert np.array_equal(worker.full_roster(seed, 500),
                          jworker.full_roster(seed, 500))
    with pytest.raises(ValueError, match="empty roster slice"):
        worker.build_workload(seed, 0, 64, 10, roster_size=1)


# -- the merge core in both packages -------------------------------------------

def _worker_stream(rng, name, shard_id, days, n_frames=6, p=14):
    """One full frame, then deltas, with monotone counters and the
    worker's own day -> bank numbering (tests/test_federation.py's)."""
    m = 1 << p
    bank_of, regs = {}, np.zeros((0, m), np.uint8)
    words = rng.integers(0, 1 << 32, 128, dtype=np.uint32)
    payloads, events = [], 0
    for seq in range(n_frames):
        new_banks = []
        for day in rng.choice(days, rng.integers(1, len(days) + 1),
                              replace=False):
            if int(day) not in bank_of:
                bank_of[int(day)] = len(bank_of)
                new_banks.append(len(bank_of) - 1)
                regs = np.vstack([regs, np.zeros((1, m), np.uint8)])
        touched = rng.choice(list(bank_of.values()),
                             rng.integers(1, len(bank_of) + 1),
                             replace=False)
        touched = np.unique(np.concatenate(
            [touched, np.asarray(new_banks, touched.dtype)])).astype(np.int64)
        bump = np.zeros_like(regs)
        idx = (rng.integers(0, m, 64),)
        for b in touched:
            bump[b][idx] = rng.integers(1, 51, 64)
        regs = np.maximum(regs, bump)
        events += int(rng.integers(100, 1000))
        counts = np.zeros((2, 2), np.uint32)
        counts[0, 0] = events
        common = dict(worker=name, incarnation=1.0, seq=seq, shard=shard_id,
                      fence_ts=1_000.0 + seq, events=events,
                      bank_of=dict(bank_of), m_bits=1 << 12, k=5,
                      precision=p, num_banks=regs.shape[0])
        if seq == 0:
            payloads.append(frames.encode_frame(kind="full", arrays={
                "bloom": words, "regs": regs.copy(), "counts": counts},
                **common))
        else:
            payloads.append(frames.encode_frame(kind="delta", arrays={
                "bank_idx": touched.astype(np.int32),
                "rows": regs[touched].copy(), "counts": counts}, **common))
    return payloads, dict(bank_of=bank_of, regs=regs, bloom=words,
                          events=events)


def _fold_both(payloads, p=14):
    ours, theirs = MergedView(p), jmerge.MergedView(p)
    for payload in payloads:
        ours.fold(frames.decode_frame(payload), now=5_000.0)
        theirs.fold(jframes.decode_frame(payload), now=5_000.0)
    return ours, theirs


def _assert_views_equal(ours, theirs):
    """Equal Bloom words, registers by day, counters, ledgers and read
    epochs (the global bank numbering too: the same fold order)."""
    assert ours.events == theirs.events
    assert ours.roster_size == theirs.roster_size
    assert np.array_equal(ours.bloom_words, theirs.bloom_words)
    a, b = ours.regs_by_day(), theirs.regs_by_day()
    assert set(a) == set(b)
    for day in a:
        assert np.array_equal(a[day], b[day]), day
    assert np.array_equal(ours.counts_array(), theirs.counts_array())
    assert (ours.folded_deltas, ours.folded_fulls, ours.stale_frames) == (
        theirs.folded_deltas, theirs.folded_fulls, theirs.stale_frames)
    for w, led in ours.workers.items():
        jled = theirs.workers[w]
        for f in _LEDGER_FIELDS:
            assert getattr(led, f) == getattr(jled, f), (w, f)
    fo, ft = ours.epoch_fields(), theirs.epoch_fields()
    assert sorted(fo) == sorted(ft)
    for key in fo:
        if key == "params":
            assert (fo[key] is None) == (ft[key] is None)
            if fo[key] is not None:
                assert (fo[key].m_bits, fo[key].k, fo[key].layout) == (
                    ft[key].m_bits, ft[key].k, ft[key].layout)
        elif isinstance(fo[key], np.ndarray):
            assert np.array_equal(fo[key], ft[key]), key
        else:
            assert fo[key] == ft[key], key
    for w, ws in ours.worker_state.items():
        jws = theirs.worker_state[w]
        assert np.array_equal(ws["bloom"], jws["bloom"])
        assert sorted(ws["rows"]) == sorted(jws["rows"])
        for day, row in ws["rows"].items():
            assert np.array_equal(row, jws["rows"][day])


_LEDGER_FIELDS = ("incarnation", "seq", "events", "valid", "invalid",
                  "roster_size", "shard", "snapshot_dir", "last_seen")


def _oracle(finals):
    regs_by_day, words = {}, None
    for f in finals:
        for d, b in f["bank_of"].items():
            row = f["regs"][b]
            regs_by_day[d] = (np.maximum(regs_by_day[d], row)
                              if d in regs_by_day else row.copy())
        words = f["bloom"] if words is None else bloom.bloom_or_words_np(
            words, f["bloom"])
    return regs_by_day, words


def test_merge_of_deltas_equals_merge_of_fulls_in_both():
    rng = np.random.default_rng(8)
    payloads, final = _worker_stream(rng, "w0", 0,
                                     [20260701 + i for i in range(5)])
    by_deltas = _fold_both(payloads)
    counts = np.zeros((2, 2), np.uint32)
    counts[0, 0] = final["events"]
    full = frames.encode_frame(
        worker="w0", kind="full", incarnation=1.0, seq=99, shard=0,
        fence_ts=1_100.0, events=final["events"], bank_of=final["bank_of"],
        m_bits=1 << 12, k=5, precision=14,
        arrays={"bloom": final["bloom"], "regs": final["regs"],
                "counts": counts})
    by_full = _fold_both([full])
    for ours, theirs in (by_deltas, by_full):
        _assert_views_equal(ours, theirs)
    a, b = by_deltas[0].regs_by_day(), by_full[0].regs_by_day()
    assert set(a) == set(b)
    for day in a:
        assert np.array_equal(a[day], b[day])
    assert np.array_equal(by_deltas[0].bloom_words, by_full[0].bloom_words)
    assert by_deltas[0].events == by_full[0].events == final["events"]


@pytest.mark.parametrize("trial", range(3))
def test_kway_interleavings_converge_to_oracle_in_both(trial):
    rng = np.random.default_rng(100 + trial)
    days = [20260701 + i for i in range(4)]
    streams, finals = [], []
    for w in range(3):
        payloads, final = _worker_stream(rng, f"w{w}", w, days, n_frames=5)
        streams.append(payloads)
        finals.append(final)
    oracle_regs, oracle_bloom = _oracle(finals)
    flat = [p for s in streams for p in s]
    order = rng.permutation(len(flat))
    dup = [flat[i] for i in rng.choice(len(flat), 4, replace=False)]
    ours, theirs = _fold_both([flat[i] for i in order] + dup)
    _assert_views_equal(ours, theirs)
    assert ours.events == sum(f["events"] for f in finals)
    got = ours.regs_by_day()
    assert set(got) == set(oracle_regs)
    for day in got:
        assert np.array_equal(got[day], oracle_regs[day])
    assert np.array_equal(ours.bloom_words, oracle_bloom)


def _full(worker_id, inc, seq, events, regs, words, m_bits=64, k=3,
          precision=14, shard_id=0):
    header = dict(worker=worker_id, kind="full", incarnation=inc, seq=seq,
                  shard=shard_id, fence_ts=0.0, events=events,
                  roster_size=10, m_bits=m_bits, k=k, precision=precision,
                  bank_of={20260701: 0})
    arrays = dict(regs=regs, counts=np.zeros((2, 2), np.uint32))
    if words is not None:
        arrays["bloom"] = words
    return header, arrays


def test_stale_incarnation_counters_ignored_sketch_folded_in_both():
    m = 1 << 14
    regs2 = np.zeros((1, m), np.uint8)
    regs2[0, 7] = 9
    regs1 = np.zeros((1, m), np.uint8)
    regs1[0, 3] = 21
    views = []
    for fr, view in ((frames, MergedView(14)), (jframes, jmerge.MergedView(14))):
        view.fold(fr.MergeFrame(*_full("w0", 2.0, 0, 500, regs2,
                                       np.array([1, 0], np.uint32))),
                  now=10.0)
        # A late frame of the dead incarnation 1.0: more events claimed,
        # a register the takeover never saw.
        info = view.fold(fr.MergeFrame(*_full(
            "w0", 1.0, 9, 9_999, regs1, np.array([0, 2], np.uint32))),
            now=11.0)
        assert info == {"stale": True, "lag_s": 11.0}
        assert view.stale_frames == 1 and view.events == 500
        row = view.regs_by_day()[20260701]
        assert row[7] == 9 and row[3] == 21
        assert np.array_equal(view.bloom_words, np.array([1, 2], np.uint32))
        views.append(view)
    _assert_views_equal(*views)


def test_stale_frame_does_not_refresh_liveness_in_both():
    hdr = dict(worker="w0", kind="heartbeat", shard=0, fence_ts=0.0,
               events=1, roster_size=1, m_bits=0, k=0, precision=14,
               bank_of={})
    for fr, view in ((frames, MergedView(14)), (jframes, jmerge.MergedView(14))):
        assert view.fold(fr.MergeFrame(dict(hdr, incarnation=2.0, seq=0),
                                       {}), now=100.0)["lag_s"] is None
        assert view.workers["w0"].last_seen == 100.0
        info = view.fold(fr.MergeFrame(dict(hdr, incarnation=1.0, seq=9),
                                       {}), now=500.0)
        assert info["stale"] and view.workers["w0"].last_seen == 100.0
        view.fold(fr.MergeFrame(dict(hdr, incarnation=2.0, seq=1), {}),
                  now=600.0)
        assert view.workers["w0"].last_seen == 600.0


def test_frame_without_traceparent_folds_in_both():
    """A frame of a worker that predates the traceparent field folds in
    both views alike (the JAX aggregator also warns once; the port does
    not trace)."""
    rng = np.random.default_rng(21)
    kw = _frame_kwargs("full", rng)
    payload = frames.encode_frame(**kw)
    views = []
    for fr, view in ((frames, MergedView(14)), (jframes, jmerge.MergedView(14))):
        frame = fr.decode_frame(payload)
        del frame.header["traceparent"]
        view.fold(frame, now=2e9)
        views.append(view)
    _assert_views_equal(*views)
    assert views[0].events == kw["events"]
    jagg_frame = jframes.decode_frame(payload)
    del jagg_frame.header["traceparent"]
    brk = MemoryBroker()
    agg = Aggregator(client=MemoryClient(brk), topic="tp", num_shards=3,
                     dead_after_s=1e9)
    try:
        assert agg.fold_frame(jagg_frame, now=2e9)["stale"] is False
        assert agg.shard_map.owner_of(2) == "w3"
    finally:
        agg.stop()


def test_geometry_mismatch_fails_loudly_in_both():
    zero = np.zeros((1, 1 << 14), np.uint8)
    bad = [("w1", dict(m_bits=512), np.zeros(16, np.uint32)),
           ("w2", dict(precision=12), None),
           ("w3", dict(k=5), np.zeros(8, np.uint32))]
    for fr, view, exc in ((frames, MergedView(14), GeometryMismatch),
                          (jframes, jmerge.MergedView(14),
                           jmerge.GeometryMismatch)):
        view.fold(fr.MergeFrame(*_full("w0", 1.0, 0, 0, zero,
                                       np.zeros(8, np.uint32), m_bits=256)))
        for name, geo, words in bad:
            kw = dict(m_bits=256, k=3, precision=14)
            kw.update(geo)
            with pytest.raises(exc):
                view.fold(fr.MergeFrame(*_full(name, 1.0, 0, 0, zero, words,
                                               shard_id=1, **kw)))
    # A delta whose rows have another width.
    view = MergedView(14)
    with pytest.raises(GeometryMismatch, match="registers/bank"):
        view.fold(frames.decode_frame(frames.encode_frame(
            worker="w0", kind="delta", incarnation=1.0, seq=0, shard=0,
            fence_ts=0.0, events=1, bank_of={20260701: 0}, precision=14,
            arrays={"bank_idx": np.zeros(1, np.int32),
                    "rows": np.zeros((1, 64), np.uint8),
                    "counts": np.zeros((2, 2), np.uint32)})))


def _drain(agg, min_folds=0):
    folded = 0
    for _ in range(100):
        n = agg.poll(timeout_ms=50)
        folded += n
        if n == 0 and folded >= min_folds:
            break
    return folded


def test_aggregator_rejects_geometry_and_keeps_serving_in_both():
    counts = np.zeros((2, 2), np.uint32)
    common = dict(incarnation=1.0, seq=0, fence_ts=time.time(),
                  m_bits=256, precision=14, bank_of={},
                  arrays=dict(bloom=np.zeros(8, np.uint32),
                              regs=np.zeros((1, 1 << 14), np.uint8),
                              counts=counts))
    good = frames.encode_frame(worker="w0", kind="full", shard=0, events=10,
                               k=3, **common)
    bad = frames.encode_frame(worker="w1", kind="full", shard=1, events=7,
                              k=5, **common)
    for pkg, brk in ((gossip, MemoryBroker()),
                     (jgossip, jbroker.MemoryBroker())):
        client = (MemoryClient if pkg is gossip else jbroker.MemoryClient)
        agg = pkg.Aggregator(client=client(brk), topic="geo-gossip",
                             num_shards=2, dead_after_s=1e9, precision=14)
        producer = client(brk).create_producer("geo-gossip")
        for payload in (good, bad, good):
            producer.send(payload)
        try:
            assert _drain(agg, min_folds=2) == 2
            assert agg.geometry_rejects == 1
            stats = agg.stats()
            assert stats["geometry_rejects"] == 1 and stats["events"] == 10
            assert "w1" not in stats["workers"] or \
                stats["workers"]["w1"]["events"] == 0
            assert stats["shard_map"]["owners"] == ["w0", None]
        finally:
            agg.stop()


def test_aggregator_rejects_a_rotten_checksummed_frame():
    """In-flight rot fails the checksum at the fold: nacked for a clean
    redelivery three times, then dropped, never folded."""
    from attendance_tpu_torch.transport.framing import enc_checksummed
    brk = MemoryBroker()
    agg = Aggregator(client=MemoryClient(brk), topic="rot", num_shards=1,
                     dead_after_s=1e9)
    payload = bytearray(enc_checksummed(frames.encode_frame(
        **_frame_kwargs("full", np.random.default_rng(4)))))
    payload[-5] ^= 0xFF
    MemoryClient(brk).create_producer("rot").send(bytes(payload))
    try:
        assert sum(agg.poll(timeout_ms=20) for _ in range(8)) == 0
        assert agg.view.workers == {} and agg.consumer.backlog() == 0
    finally:
        agg.stop()


# -- fence gossip end to end ---------------------------------------------------

def _fed_config(pkg_config, tmp, K, s, topic="fed-gossip", **kw):
    return pkg_config(
        bloom_filter_capacity=20_000, transport_backend="memory",
        pulsar_topic=f"events.s{s}", snapshot_dir=str(tmp / f"w{s}"),
        snapshot_every_batches=2, fed_worker=f"w{s}", fed_shard=s,
        fed_shards=K, fed_gossip_topic=topic, fed_heartbeat_s=0.0, **kw)


def _port_pipes(broker, tmp, K, roster, topic="fed-gossip"):
    pipes = []
    for s in range(K):
        client = MemoryClient(broker)
        pipe = FusedPipeline(_fed_config(Config, tmp, K, s, topic),
                             client=client, num_banks=8, device="cpu")
        mine = roster[shard.shard_of_keys(roster, K) == s]
        pipe.preload(mine)
        pipes.append((pipe, client, mine))
    return pipes


def _feed(pipe, client, mine, rng, n_frames, batch=2_048):
    prod = client.create_producer(pipe.config.pulsar_topic)
    for _ in range(n_frames):
        prod.send(frame_from_columns(synth_columns(
            rng, batch, mine, 6, 0.1, invalid_base=200_000)))
    pipe.run(max_events=n_frames * batch, idle_timeout_s=0.3)
    return n_frames * batch


def _collect(consumer):
    """Every payload retained on a raw gossip subscription, in order."""
    out = []
    while True:
        try:
            msgs = consumer.receive_many(256, timeout_millis=20)
        except (gossip.ReceiveTimeout, jbroker.ReceiveTimeout):
            return out
        out.extend(bytes(m.data()) for m in msgs)
        consumer.acknowledge_many(msgs)


def _fold_payloads(view_cls, decode, payloads):
    from attendance_tpu_torch.transport.framing import dec_checksummed
    view = view_cls(14)
    for raw in payloads:
        body, verified = dec_checksummed(raw)
        assert verified
        frame = decode(body)
        if frame.kind != "repair_request":
            view.fold(frame, now=0.0)
    return view


def test_gossip_end_to_end_port_and_jax_workers_fold_across(tmp_path):
    """Two port workers and two JAX workers run the same shards'
    workloads, each package on its own broker. Each package's merged
    view folds the OTHER package's gossip payloads, and the views are
    equal; the port's aggregator view equals the per-worker oracle,
    answers BF.EXISTS for the whole roster, and learned both owners."""
    K = 2
    roster, _ = generate_frames(0, 1, roster_size=6_000, num_lectures=6,
                                seed=3)
    broker = MemoryBroker()
    tap = MemoryClient(broker).subscribe("fed-gossip", "tap")
    agg = Aggregator(client=MemoryClient(broker), topic="fed-gossip",
                     num_shards=K, dead_after_s=30.0, precision=14)
    pipes = _port_pipes(broker, tmp_path / "port", K, roster)
    jbrk = jbroker.MemoryBroker()
    jtap = jbroker.MemoryClient(jbrk).subscribe("fed-gossip", "tap")
    jpipes = []
    for s in range(K):
        jclient = jbroker.MemoryClient(jbrk)
        jp = JaxPipeline(_fed_config(JaxConfig, tmp_path / "jax", K, s),
                         client=jclient, num_banks=8)
        jp.preload(pipes[s][2])
        jpipes.append((jp, jclient))
    try:
        total = 0
        for s in range(K):
            pipe, client, mine = pipes[s]
            total += _feed(pipe, client, mine, np.random.default_rng(100 + s),
                           4)
            pipe.snapshot()
            pipe.fed_flush()
            jp, jclient = jpipes[s]
            _feed(jp, jclient, mine, np.random.default_rng(100 + s), 4)
            jp.snapshot()
            jp.fed_flush()
        _drain(agg, min_folds=K)
        assert agg.view.events == total
        assert agg.view.folded_deltas > 0  # the fences gossiped deltas
        assert QueryEngine(agg.mirror).bf_exists(roster).all()
        assert sorted(filter(None, agg.shard_map.to_dict()["owners"])) == [
            "w0", "w1"]
        oracle = {}
        for pipe, _, _ in pipes:
            regs = pipe.state.hll_regs.numpy()
            for day, bank in pipe._bank_of.items():
                oracle[day] = (np.maximum(oracle[day], regs[bank])
                               if day in oracle else regs[bank].copy())
        got = agg.view.regs_by_day()
        assert set(got) == set(oracle)
        for day in oracle:
            assert np.array_equal(got[day], oracle[day]), day
        ours_payloads, jax_payloads = _collect(tap), _collect(jtap)
        # Each package folds the other's frames.
        jax_view_of_port = _fold_payloads(jmerge.MergedView,
                                          jframes.decode_frame, ours_payloads)
        port_view_of_jax = _fold_payloads(MergedView, frames.decode_frame,
                                          jax_payloads)
        port_view_of_port = _fold_payloads(MergedView, frames.decode_frame,
                                           ours_payloads)
        for view in (jax_view_of_port, port_view_of_jax):
            assert view.events == total
            assert np.array_equal(view.bloom_words,
                                  port_view_of_port.bloom_words)
            assert np.array_equal(view.counts_array(),
                                  port_view_of_port.counts_array())
            a, b = view.regs_by_day(), port_view_of_port.regs_by_day()
            assert set(a) == set(b) == set(oracle)
            for day in a:
                assert np.array_equal(a[day], b[day]), day
        # The same kinds of frames in the same order from both packages.
        assert [frames.decode_frame(gossip.dec_checksummed(p)[0]).kind
                for p in ours_payloads] == [
            jframes.decode_frame(gossip.dec_checksummed(p)[0]).kind
            for p in jax_payloads]
    finally:
        for pipe, _, _ in pipes:
            pipe.cleanup()
        for jp, _ in jpipes:
            jp.cleanup()
        agg.stop()


def test_gossip_seq_order_is_wire_order_under_threads():
    """The writer thread's fences and the heartbeat race on one
    publisher: each frame's seq is allocated under the send lock, so the
    topic carries seqs 0..n-1 in order (a seq taken outside the lock
    would let a heartbeat overtake a fence and turn it stale)."""
    brk = MemoryBroker()
    tap = MemoryClient(brk).subscribe("seq-gossip", "tap")
    pub = gossip.FenceGossip(
        Config(fed_worker="w0", fed_gossip_topic="seq-gossip",
               fed_heartbeat_s=0.0), client=MemoryClient(brk))
    rows = np.zeros((1, 1 << 14), np.uint8)
    counts = np.zeros((2, 2), np.uint32)
    threads, per_thread = 8, 60
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(t):
            for i in range(per_thread):
                if t % 2:
                    pub.heartbeat()
                else:
                    pub.publish_delta([0], rows, counts, {20260701: 0}, i, 1)

        pool = [threading.Thread(target=work, args=(t,))
                for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
        pub.close()
    seqs = [frames.decode_frame(gossip.dec_checksummed(p)[0]).seq
            for p in _collect(tap)]
    assert seqs == list(range(threads * per_thread))


def test_dead_peer_chain_recovery(tmp_path):
    """A worker silent after making state durable is declared dead, its
    shard orphaned at a bumped map version, and its chain folded: the
    view keeps its durable events."""
    broker = MemoryBroker()
    roster, _ = generate_frames(0, 1, roster_size=4_000, num_lectures=4,
                                seed=5)
    pipes = _port_pipes(broker, tmp_path, 2, roster)
    agg = Aggregator(client=MemoryClient(broker), topic="fed-gossip",
                     num_shards=2, dead_after_s=0.4, precision=14)
    try:
        total = 0
        for s, (pipe, client, mine) in enumerate(pipes):
            total += _feed(pipe, client, mine, np.random.default_rng(40 + s),
                           3, batch=1_024)
            pipe.snapshot()
        _drain(agg, min_folds=2)
        assert agg.view.events == total
        v0 = agg.shard_map.version
        time.sleep(0.5)
        assert sorted(agg.check_liveness()) == ["w0", "w1"]
        assert agg.shard_map.version > v0
        assert agg.shard_map.owner_of(0) is None
        assert sorted(agg.recovered_chains) == ["w0", "w1"]
        assert agg.recovered_chains == {
            f"w{s}": pipes[s][0]._events_total for s in range(2)}
        assert agg.view.events == total
        assert not agg.stats()["workers"]["w0"]["up"]
        assert QueryEngine(agg.mirror).bf_exists(roster).all()
    finally:
        for pipe, _, _ in pipes:
            pipe.cleanup()
        agg.stop()


def test_takeover_incarnation_supersedes(tmp_path):
    """A takeover (same id, restored chain, higher incarnation) takes
    over the dead peer's counters; the dead peer's late frames are stale
    and never double-counted."""
    broker = MemoryBroker()
    roster, _ = generate_frames(0, 1, roster_size=4_000, num_lectures=4,
                                seed=6)
    mine = roster[shard.shard_of_keys(roster, 2) == 0]

    def mkpipe():
        client = MemoryClient(broker)
        return FusedPipeline(_fed_config(Config, tmp_path, 2, 0),
                             client=client, num_banks=8,
                             device="cpu"), client

    agg = Aggregator(client=MemoryClient(broker), topic="fed-gossip",
                     num_shards=2, dead_after_s=30.0, precision=14)
    pipe, client = mkpipe()
    rng = np.random.default_rng(7)
    _feed(pipe, client, mine, rng, 2, batch=1_024)
    pipe.snapshot()
    late = pipe._fed._encode("heartbeat", 999_999)  # an inflated claim
    inc1 = pipe._fed.incarnation
    pipe.cleanup()
    pipe2, client2 = mkpipe()
    try:
        assert pipe2.metrics.events == 0
        assert pipe2._events_restored == pipe2._events_total == 2_048
        assert pipe2._fed.incarnation > inc1
        _feed(pipe2, client2, mine, rng, 1, batch=1_024)
        pipe2.snapshot()
        pipe2.fed_flush()
        _drain(agg, min_folds=2)
        assert agg.view.events == 3_072
        inc2 = agg.view.workers["w0"].incarnation
        assert inc2 == pipe2._fed.incarnation
        agg.fold_frame(frames.decode_frame(late))
        assert agg.view.stale_frames >= 1
        assert agg.view.events == 3_072
        assert agg.view.workers["w0"].incarnation == inc2
    finally:
        pipe2.cleanup()
        agg.stop()


def _raise(*a, **kw):
    raise ConnectionError("injected gossip outage")


def test_gossip_failure_defers_to_full_frame(tmp_path):
    """A failed publish never fails the fence; the next publish is a
    full frame, so the banks the aggregator missed are re-asserted."""
    broker = MemoryBroker()
    roster, _ = generate_frames(0, 1, roster_size=3_000, num_lectures=4,
                                seed=8)
    agg = Aggregator(client=MemoryClient(broker), topic="fed-gossip",
                     num_shards=1, dead_after_s=30.0, precision=14)
    (pipe, client, mine), = _port_pipes(broker, tmp_path, 1, roster)
    try:
        rng = np.random.default_rng(9)
        real_send = pipe._fed._producer.send
        pipe._fed._producer.send = _raise
        _feed(pipe, client, mine, rng, 1, batch=1_024)
        pipe.snapshot()
        assert pipe._fed.full_due
        pipe._fed._producer.send = real_send
        _feed(pipe, client, mine, rng, 1, batch=1_024)
        # The run's barrier is a delta: its publish upgrades to a full
        # frame from the host mirror.
        assert not pipe._fed.full_due
        pipe.snapshot()
        _drain(agg, min_folds=1)
        assert agg.view.folded_fulls >= 2  # preload + the upgrade
        assert agg.view.events == 2_048
        regs = pipe.state.hll_regs.numpy()
        got = agg.view.regs_by_day()
        assert set(got) == set(pipe._bank_of)
        for day, bank in pipe._bank_of.items():
            assert np.array_equal(got[day], regs[bank])
    finally:
        pipe.cleanup()
        agg.stop()


def test_claim_incarnation_monotonic_and_shared_with_jax(tmp_path):
    """Claims on one chain directory strictly increase, even past a
    clock far ahead, and the mark is the JAX package's: a port takeover
    of a JAX worker's chain comes out newer, and the other way round."""
    d = str(tmp_path / "chain")
    inc1 = claim_incarnation(d)
    inc2 = claim_incarnation(d)
    assert inc2 > inc1
    (tmp_path / "chain" / "INCARNATION").write_text("9e9")
    inc3 = jgossip.claim_incarnation(d)
    assert inc3 > 9e9
    inc4 = claim_incarnation(d)
    assert inc4 > inc3
    assert jgossip.claim_incarnation(d) > inc4
    assert claim_incarnation("") > 0


def test_jax_chain_taken_over_by_a_port_worker(tmp_path):
    """A JAX worker's chain and INCARNATION mark, taken over by a port
    worker: the port restores the chain, its full frame is newer than
    every JAX frame, and the JAX aggregator folds it as current."""
    jbrk = jbroker.MemoryBroker()
    jagg = jgossip.Aggregator(client=jbroker.MemoryClient(jbrk),
                              topic="fed-gossip", num_shards=1,
                              dead_after_s=30.0, precision=14)
    roster, _ = generate_frames(0, 1, roster_size=3_000, num_lectures=4,
                                seed=12)
    jclient = jbroker.MemoryClient(jbrk)
    jp = JaxPipeline(_fed_config(JaxConfig, tmp_path, 1, 0), client=jclient,
                     num_banks=8)
    jp.preload(roster)
    _feed(jp, jclient, roster, np.random.default_rng(2), 2, batch=1_024)
    jp.snapshot()
    jax_inc = jp._fed.incarnation
    jp.cleanup()
    tap = MemoryBroker()
    pipe = FusedPipeline(_fed_config(Config, tmp_path, 1, 0),
                         client=MemoryClient(tap), num_banks=8, device="cpu")
    try:
        assert pipe._fed.incarnation > jax_inc
        assert pipe._events_restored == 2_048
        _drain(jagg, min_folds=1)
        assert jagg.view.workers["w0"].incarnation == jax_inc
        restored = _collect(MemoryClient(tap).subscribe("fed-gossip", "tap"))
        # The restore's full frame is retained on the port's broker
        # (topics retain for late subscribers): hand it to the JAX
        # aggregator.
        for raw in restored:
            jagg.fold_frame(jframes.decode_frame(
                gossip.dec_checksummed(raw)[0]))
        led = jagg.view.workers["w0"]
        assert led.incarnation == pipe._fed.incarnation and led.events == 2_048
        assert jagg.view.stale_frames == 0
    finally:
        pipe.cleanup()
        jagg.stop()


# -- the repair ladder's peer rung -----------------------------------------------

def _flip_mid_byte(path):
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


def _rotted_federated_chain(tmp_path, victim):
    """A federated worker's chain (a base, then a delta), every frame of
    it folded by an aggregator, then one file of it rotted. Returns the
    aggregator, broker, config and the pre-corruption state."""
    broker = MemoryBroker()
    agg = Aggregator(client=MemoryClient(broker),
                     topic="attendance-fed-gossip", num_shards=1,
                     dead_after_s=600, precision=14)
    roster, stream = generate_frames(16_384, 2_048, roster_size=6_000,
                                     num_lectures=6, invalid_fraction=0.15,
                                     seed=91)
    stream = list(stream)
    config = Config(bloom_filter_capacity=20_000,
                    snapshot_dir=str(tmp_path / "snaps"),
                    snapshot_every_batches=2, fed_worker="w0", fed_shard=0,
                    fed_shards=1, fed_heartbeat_s=0)
    client = MemoryClient(broker)
    pipe = FusedPipeline(config, client=client, num_banks=8, device="cpu")
    pipe.preload(roster)
    producer = client.create_producer(config.pulsar_topic)
    for f in stream:
        producer.send(f)
    pipe.run(max_events=16_384, idle_timeout_s=0.3)
    pipe.snapshot()
    for f in stream[:2]:
        producer.send(f)
    pipe.run(max_events=2 * 2_048, idle_timeout_s=0.3)
    want = dict(counts={d: pipe.count(d) for d in pipe.lecture_days()},
                events=pipe._events_total,
                words=pipe.state.bloom_bits.numpy().copy(),
                validity=pipe.validity_counts())
    pipe.cleanup()
    while agg.poll(timeout_ms=100) > 0:
        pass
    assert "w0" in agg.view.worker_state
    snap = Path(config.snapshot_dir)
    chain = json.loads((snap / CHAIN_MANIFEST).read_text())
    assert chain["deltas"]
    name = chain["deltas"][-1] if victim == "delta" else SKETCH_SNAPSHOT
    _flip_mid_byte(snap / name)
    return agg, broker, config, want, name


@pytest.mark.parametrize("victim", ["delta", "base"])
def test_peer_reassert_repairs_a_corrupt_chain(tmp_path, victim):
    """A rotten newest delta (or base): the restore quarantines it, asks
    the aggregator (serving from a thread: restore blocks on the round
    trip) to re-assert this worker's retained contribution, and comes
    out EQUAL to the pre-corruption chain; a lost base is rebuilt from
    the re-assert alone."""
    agg, broker, config, want, name = _rotted_federated_chain(tmp_path,
                                                               victim)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            agg.poll(timeout_ms=50)

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    try:
        pipe = FusedPipeline(config, client=MemoryClient(broker),
                             num_banks=8, device="cpu")
    finally:
        stop.set()
        server.join(timeout=5)
    assert not server.is_alive()
    try:
        assert {d: pipe.count(d) for d in pipe.lecture_days()} == \
            want["counts"]
        assert pipe._events_total == want["events"]
        assert pipe.validity_counts() == want["validity"]
        assert np.array_equal(pipe.state.bloom_bits.numpy(), want["words"])
        snap = Path(config.snapshot_dir)
        assert (snap / integrity.QUARANTINE_SUBDIR / name).exists()
        man = json.loads((snap / CHAIN_MANIFEST).read_text())
        assert name not in man["deltas"] and man["deltas"] == []
    finally:
        pipe.cleanup()
        agg.stop()


def test_reassert_fold_places_a_new_day_past_the_highest_bank():
    """A re-assert naming a day the surviving chain lacks: the day gets a
    bank past the highest in use. (The JAX fold takes len(bank_of), so a
    hole left by a temporal eviction aliases a live bank there.)"""
    m = 1 << 14
    pipe = FusedPipeline(Config(bloom_filter_capacity=20_000),
                         client=MemoryClient(MemoryBroker()), num_banks=4,
                         device="cpu")
    try:
        regs = np.zeros((4, m), np.uint8)
        regs[0, 1], regs[2, 2] = 5, 6
        state = dict(bits=np.zeros(pipe.params.m_bits // 32, np.uint32),
                     regs=regs, counts=np.zeros((2, 2), np.uint32),
                     bank_of={"20260701": 0, "20260703": 2}, events=10)
        f_regs = np.zeros((2, m), np.uint8)
        f_regs[0, 1], f_regs[1, 3] = 7, 9
        frame = frames.MergeFrame(
            dict(worker="w0", kind="full", m_bits=pipe.params.m_bits, k=3,
                 precision=14, events=12, bank_of={20260701: 0,
                                                    20260702: 1}),
            dict(regs=f_regs, counts=np.zeros((2, 2), np.uint32)))
        got, folded = pipe._fold_reassert_state(state, frame)
        assert folded and got["events"] == 12
        assert got["bank_of"] == {"20260701": 0, "20260703": 2,
                                  "20260702": 3}
        assert got["regs"][0, 1] == 7 and got["regs"][2, 2] == 6
        assert got["regs"][3, 3] == 9 and not got["regs"][1].any()
    finally:
        pipe.cleanup()


def test_corrupt_base_without_a_peer_starts_empty_in_both(tmp_path):
    """No federation peer: a corrupt base leaves nothing to restore; each
    package starts empty, loudly, the corrupt base quarantined."""
    roster, stream = generate_frames(8_192, 2_048, roster_size=6_000,
                                     num_lectures=6, seed=61)
    stream = list(stream)
    for pkg in ("port", "jax"):
        snap = tmp_path / pkg
        kw = dict(bloom_filter_capacity=20_000, snapshot_dir=str(snap),
                  snapshot_every_batches=2)
        if pkg == "port":
            config, client = Config(**kw), MemoryClient(MemoryBroker())
            mk = (lambda c, cl: FusedPipeline(c, client=cl, num_banks=8,
                                              device="cpu"))
        else:
            config = JaxConfig(transport_backend="memory", **kw)
            client = jbroker.MemoryClient(jbroker.MemoryBroker())
            mk = (lambda c, cl: JaxPipeline(c, client=cl, num_banks=8))
        pipe = mk(config, client)
        pipe.preload(roster)
        producer = client.create_producer(config.pulsar_topic)
        for f in stream:
            producer.send(f)
        pipe.run(max_events=8_192, idle_timeout_s=0.3)
        pipe.snapshot()
        pipe.cleanup()
        _flip_mid_byte(snap / SKETCH_SNAPSHOT)
        client = (MemoryClient(MemoryBroker()) if pkg == "port"
                  else jbroker.MemoryClient(jbroker.MemoryBroker()))
        pipe2 = mk(config, client)
        try:
            assert pipe2._events_restored == 0
            assert (snap / integrity.QUARANTINE_SUBDIR
                    / SKETCH_SNAPSHOT).exists()
        finally:
            pipe2.cleanup()


# -- the federate verb and the worker entry point ----------------------------------

def test_federate_cli_smoke(tmp_path, capsys):
    """The federate verb over a memory transport: starts, folds nothing,
    writes its stats file, exits by its deadline (the JAX verb's
    outcome)."""
    stats = tmp_path / "fed.json"
    cli.main(["federate", "--transport-backend", "memory",
              "--fed-shards", "2", "--serve-seconds", "0.3",
              "--stats-json", str(stats), "--stats-every-s", "0.1"])
    doc = json.loads(stats.read_text())
    assert doc["shard_map"]["num_shards"] == 2
    assert doc["events"] == 0 and doc["workers"] == {}
    assert "serve_address" in doc
    assert "federation aggregator folding" in capsys.readouterr().out


@pytest.mark.parametrize("precision", [12, 14])
def test_federate_hll_precision_equals_jax(precision, tmp_path):
    """``federate --hll-precision P`` folds the gossip of a ``fused
    --hll-precision 12 --fed-worker`` run: at 12 every frame folds, at
    the default 14 every frame is a geometry reject, in both packages
    (JAX's Aggregator reads the field, ``federation/gossip.py:342``)."""
    from attendance_tpu.cli import main as jax_main

    stats = {}
    for pkg, main, broker in (("jax", jax_main, jbroker.MemoryBroker),
                              ("port", cli.main, MemoryBroker)):
        broker.reset_shared()
        main(["fused", "--num-events", "8192", "--frame-size", "2048",
              "--num-lectures", "2", "--bloom-capacity", "8192",
              "--hll-precision", "12", "--snapshot-dir",
              str(tmp_path / f"{pkg}-snap"), "--snapshot-every-batches",
              "1", "--fed-worker", "w5", "--fed-shard", "0",
              "--fed-shards", "1", "--fed-gossip-topic", "pg",
              "--fed-heartbeat-s", "0"]
             + (["--device", "cpu"] if pkg == "port" else []))
        path = tmp_path / f"{pkg}.json"
        main(["federate", "--transport-backend", "memory",
              "--fed-gossip-topic", "pg", "--fed-shards", "1",
              "--hll-precision", str(precision), "--serve-seconds", "1.0",
              "--stats-json", str(path), "--stats-every-s", "0.1"])
        doc = json.loads(path.read_text())
        doc.pop("serve_address")
        for w in doc["workers"].values():
            w.pop("incarnation")
        stats[pkg] = doc
        broker.reset_shared()
    # How many deltas gossip depends on the writer's group commits: the
    # folded state is compared, not the frame counts.
    for key in ("events", "workers", "shard_map", "banks", "stale_frames",
                "recovered_chains"):
        assert stats["port"][key] == stats["jax"][key], key
    assert (stats["port"]["geometry_rejects"] > 0) == (
        stats["jax"]["geometry_rejects"] > 0)
    if precision == 12:
        assert stats["port"]["events"] == 8192
        assert stats["port"]["geometry_rejects"] == 0
    else:
        assert stats["port"]["events"] == 0
        assert stats["port"]["geometry_rejects"] > 0


def test_worker_without_a_device_raises_on_a_host_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--worker", "w0", "--shard", "0", "--num-shards", "1",
                     "--broker", "127.0.0.1:1", "--workdir", str(tmp_path),
                     "--data-plane", "memory", "--num-events", "1024",
                     "--roster-size", "1000"])
    base = ["--worker", "w0", "--shard", "0", "--num-shards", "1",
            "--broker", "b", "--workdir", "d"]
    # The telemetry, fault-injection and fleet flags are ported.
    args = worker.build_parser().parse_args(
        base + ["--metrics-prom", "x", "--chaos", "drop=0.1",
                "--chaos-seed", "3", "--fleet-push", "h:1"])
    assert (args.metrics_prom, args.chaos, args.chaos_seed,
            args.fleet_push) == ("x", "drop=0.1", 3, "h:1")


def test_worker_subprocess_gossips_to_an_aggregator(tmp_path):
    """``python -m attendance_tpu_torch.federation.worker --device cpu``
    on the memory data plane, gossiping to a socket broker: the
    aggregator holds its shard's whole workload, equal to the same
    frames through an in-process pipeline."""
    server = BrokerServer(port=0).start()
    agg = Aggregator(client=gossip.SocketClient(server.address),
                     topic="sub-gossip", num_shards=2, dead_after_s=1e9)
    try:
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        out = subprocess.run(
            [sys.executable, "-m", "attendance_tpu_torch.federation.worker",
             "--worker", "w1", "--shard", "1", "--num-shards", "2",
             "--broker", server.address, "--gossip-topic", "sub-gossip",
             "--workdir", str(tmp_path), "--data-plane", "memory",
             "--num-events", str(4 * 2_048), "--batch", "2048",
             "--roster-size", "4000", "--seed", "3", "--idle-timeout-s",
             "0.3", "--device", "cpu"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        report = json.loads(out.stdout.strip().splitlines()[-1])
        assert report["events"] == 4 * 2_048 and report["device"] == "cpu"
        _drain(agg, min_folds=2)
        assert agg.view.events == 4 * 2_048
        _, mine, wl = worker.build_workload(3, 1, 2, 4 * 2_048,
                                            roster_size=4_000, batch=2_048)
        pipe = FusedPipeline(Config(), client=MemoryClient(MemoryBroker()),
                             num_banks=16, device="cpu")
        try:
            pipe.preload(mine)
            producer = pipe.client.create_producer(pipe.config.pulsar_topic)
            for f in wl:
                producer.send(f)
            pipe.run(max_events=len(wl) * 2_048, idle_timeout_s=0.3)
            regs = pipe.state.hll_regs.numpy()
            got = agg.view.regs_by_day()
            assert set(got) == set(pipe._bank_of)
            for day, bank in pipe._bank_of.items():
                assert np.array_equal(got[day], regs[bank])
            assert np.array_equal(agg.view.bloom_words,
                                  pipe.state.bloom_bits.numpy().view(
                                      np.uint32))
            assert merge.encode_counts(*pipe.validity_counts()).tolist() == \
                agg.view.counts_array().tolist()
        finally:
            pipe.cleanup()
    finally:
        agg.stop()
        server.stop()


def test_fused_verb_as_a_federated_worker(tmp_path, capsys):
    """``fused --fed-worker``: the verb's run gossips its preload, fences
    and base on the shared broker's gossip topic; an aggregator folding
    them holds the run's events, counters and PFCOUNTs."""
    cli.main(["fused", "--device", "cpu", "--num-events", "8192",
              "--frame-size", "2048", "--num-lectures", "4",
              "--bloom-capacity", "20000", "--snapshot-dir",
              str(tmp_path / "snap"), "--snapshot-every-batches", "2",
              "--fed-worker", "w5", "--fed-shard", "1", "--fed-shards", "2",
              "--fed-gossip-topic", "verb-gossip", "--fed-heartbeat-s", "0"])
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    pfcount = {int(ln.split(":")[0][len("LECTURE_"):]): int(ln.split()[1])
               for ln in out if ln.startswith("LECTURE_")}
    assert len(pfcount) == 4
    agg = Aggregator(client=MemoryClient(MemoryBroker.shared()),
                     topic="verb-gossip", num_shards=2, dead_after_s=1e9)
    try:
        _drain(agg, min_folds=1)
        assert agg.view.events == summary["events"] == 8192
        assert agg.view.folded_deltas > 0
        assert agg.shard_map.to_dict()["owners"] == [None, "w5"]
        assert merge.encode_counts(
            summary["valid"], summary["invalid"]).tolist() == \
            agg.view.counts_array().tolist()
        days = sorted(pfcount)
        assert QueryEngine(agg.mirror).pfcount(days).tolist() == [
            pfcount[d] for d in days]
    finally:
        agg.stop()
