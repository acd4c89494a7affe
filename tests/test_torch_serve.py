"""The port's query-serving plane against the JAX package's
(``tests/test_serve.py``'s cases that need no telemetry): the numpy
probe twin, batched estimates, the mirror's pin, recycle and staleness,
every engine verb equal to the JAX engine's on the same epoch (temporal
included) and to the pipeline's own answers, the binary RPC (chunking,
and across the packages both ways), concurrent publish and read, the
epochs a fused pipeline publishes, the chain reader over a port chain
and over a JAX chain, a corrupt chain that keeps serving and
quarantines, and the ``serve`` verb in a subprocess. Tolerance 0 (rates
are the same float64 operations in both packages).
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.models import bloom as jbloom
from attendance_tpu.models import hll as jhll
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.serve import chain as jchain
from attendance_tpu.serve import engine as jengine
from attendance_tpu.serve import mirror as jmirror
from attendance_tpu.serve import rpc as jrpc
from attendance_tpu.transport import memory_broker as jbroker
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models import bloom, hll
from attendance_tpu_torch.pipeline.fast_path import (
    CHAIN_MANIFEST, FusedPipeline)
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.serve.chain import ChainEpochSource
from attendance_tpu_torch.serve.engine import (
    NoEpoch, QueryEngine, resolve_days)
from attendance_tpu_torch.serve.mirror import ReadMirror
from attendance_tpu_torch.serve.rpc import QueryClient
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.utils import integrity

REPO = Path(__file__).resolve().parent.parent
NUM_EVENTS, BATCH = 16_384, 2_048
TEMPORAL = dict(temporal_period_s=1.0, allowed_lateness_s=0.6,
                temporal_ring_banks=64)


def _cfg(snap_dir="", **kw):
    return dict(bloom_filter_capacity=20_000, snapshot_dir=str(snap_dir),
                snapshot_every_batches=2 if snap_dir else 0, **kw)


def _stream(seed, temporal):
    gen = dict(roster_size=6_000, num_lectures=6, invalid_fraction=0.15,
               seed=seed)
    if temporal:
        gen.update(num_lectures=3, disorder_frac=0.3, late_max_s=0.5)
    return generate_frames(NUM_EVENTS, BATCH, **gen)


def _run_port(seed=7, temporal=False, **cfg):
    pipe = FusedPipeline(Config(**_cfg(**cfg), **(TEMPORAL if temporal
                                                   else {})),
                         client=MemoryClient(MemoryBroker()), num_banks=8,
                         device="cpu")
    roster, frames = _stream(seed, temporal)
    pipe.preload(roster)
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=NUM_EVENTS, idle_timeout_s=0.3)
    return pipe, roster


def _probes(roster):
    return np.concatenate([roster[:1500], np.arange(
        1 << 31, (1 << 31) + 1500, dtype=np.uint32)])


def _jax_engine_on(epoch):
    """A JAX QueryEngine over the same epoch (numpy arrays passed
    across)."""
    mirror = jmirror.ReadMirror()
    mirror.publish(regs=epoch.hll_regs, events=epoch.events,
                   bank_of=epoch.bank_of,
                   params=jbloom.BloomParams(*epoch.params),
                   precision=epoch.precision,
                   bloom_words=epoch.bloom_words, counts=epoch.counts,
                   roster_size=epoch.roster_size)
    return jengine.QueryEngine(mirror)


_TIMELESS = ("published_at", "age_s", "epoch", "source")


def _answers(eng, roster, days):
    """Every verb's answer (stats without its clock and sequence)."""
    buckets = sorted(eng.window_occupancy())
    day = buckets[0][0] if buckets else None
    periods = sorted({p for _, p in buckets}) or [0]
    return dict(
        exists=np.asarray(eng.bf_exists(_probes(roster))).tolist(),
        pfcount=np.asarray(eng.pfcount(list(days) + [123])).tolist(),
        occupancy=eng.occupancy(), rate=eng.attendance_rate(),
        rate_given=eng.attendance_rate(1000),
        window_all=eng.window_pfcount(),
        window_day=eng.window_pfcount(day),
        window_range=eng.window_pfcount(day, periods[0],
                                        periods[len(periods) // 2]),
        window_occupancy=eng.window_occupancy(),
        series=eng.rate_series(), series_day=eng.rate_series(day, 500),
        stats={k: v for k, v in eng.stats().items() if k not in _TIMELESS})


# -- the numpy read kernels --------------------------------------------------------

@pytest.mark.parametrize("layout", ["blocked", "flat"])
def test_numpy_probe_equals_jax_and_the_k4_plain_version(layout):
    params = bloom.derive_bloom_params(5_000, 0.01, layout)
    words = bloom.bloom_packed_init(params, torch.device("cpu"))
    rng = np.random.default_rng(1)
    members = rng.choice(1 << 31, 3_000, replace=False).astype(np.uint32)
    bloom.bloom_add_packed_plain(words, torch.from_numpy(
        members.view(np.int32)), params)
    host = words.numpy().view(np.uint32)
    probes = np.concatenate([members[:500], rng.integers(
        1 << 31, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)])
    ours = bloom.bloom_contains_words_np(host, probes, params)
    assert ours[:500].all()  # no false negatives on members
    np.testing.assert_array_equal(ours, jbloom.bloom_contains_words_np(
        host, probes, jbloom.BloomParams(*params)))
    keys = torch.from_numpy(probes.view(np.int32))
    np.testing.assert_array_equal(
        ours, bloom.bloom_contains_words(words, keys, params).numpy())
    if layout == "blocked":  # K4's CPU path is its plain version
        np.testing.assert_array_equal(
            ours, bloom.bloom_contains_packed(words, keys, params).numpy())
    assert bloom.bloom_contains_words_np(host, probes[:0], params).shape \
        == (0,)


def test_batched_estimates_equal_scalar_and_jax():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 30, size=(5, 1 << 14)).astype(np.uint8)
    batched = hll.estimates_from_rows(rows, 14)
    np.testing.assert_array_equal(batched, jhll.estimates_from_rows(rows, 14))
    hists = hll.best_histogram(torch.from_numpy(rows), 14).numpy()
    for i in range(5):
        assert batched[i] == hll.estimate_from_histogram(hists[i], 14)


# -- the mirror ----------------------------------------------------------------------

def _params():
    return bloom.derive_bloom_params(1000, 0.01, "blocked")


def test_mirror_pin_survives_later_publishes():
    mirror = ReadMirror()
    mirror.publish(regs=np.full((4, 16), 1, np.uint8), events=1,
                   bank_of={1: 0}, params=_params(), precision=14,
                   bloom_words=np.zeros(4, np.uint32))
    pinned = mirror.pin()
    assert pinned.seq == 1 and (pinned.hll_regs == 1).all()
    for gen in (2, 3, 4, 5):
        mirror.publish(regs=np.full((4, 16), gen, np.uint8), events=gen,
                       bank_of={1: 0}, params=_params(), precision=14)
    assert (pinned.hll_regs == 1).all() and pinned.events == 1
    cur = mirror.pin()
    assert cur.seq == 5 and (cur.hll_regs == 5).all()
    assert cur.bloom_words is not None  # carried forward by reference


def test_mirror_recycles_unpinned_buffers():
    mirror = ReadMirror()
    for gen in range(6):
        mirror.publish(regs=np.full((4, 16), gen, np.uint8), events=gen,
                       bank_of={}, params=_params(), precision=14)
    seen = set()
    for gen in range(6, 12):
        mirror.publish(regs=np.full((4, 16), gen, np.uint8), events=gen,
                       bank_of={}, params=_params(), precision=14)
        seen.add(id(mirror.pin().hll_regs))
    assert len(seen) <= 2  # alternating between two buffers


def test_staleness_nan_and_no_epoch_before_the_first_publish():
    mirror = ReadMirror()
    assert np.isnan(mirror.staleness_s())
    engine = QueryEngine(mirror)
    assert np.isnan(engine.staleness_s())
    with pytest.raises(NoEpoch):
        engine.bf_exists(np.array([1], np.uint32))
    mirror.publish(regs=np.zeros((1, 16), np.uint8), events=0, bank_of={},
                   params=_params(), precision=14)
    assert 0.0 <= mirror.staleness_s() < 5.0
    with pytest.raises(NoEpoch, match="filter words"):
        engine.bf_exists(np.array([1], np.uint32))
    with pytest.raises(ValueError, match="batch"):
        QueryEngine(mirror, batch_max=2).pfcount([1, 2, 3])


def test_concurrent_publish_and_read():
    """Readers pinning while epochs publish only ever see whole epochs
    (every epoch's registers hold one value)."""
    mirror = ReadMirror()
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            epoch = mirror.pin()
            if epoch is None:
                continue
            lo, hi = int(epoch.hll_regs.min()), int(epoch.hll_regs.max())
            if lo != hi:
                torn.append((epoch.seq, lo, hi))
                return

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for gen in range(1, 40):
            mirror.publish(regs=np.full((4, 1 << 14), gen % 31, np.uint8),
                           events=gen, bank_of={1: 0, 2: 1},
                           params=_params(), precision=14)
    finally:
        stop.set()
    for t in threads:
        t.join(timeout=10.0)
    assert not torn, f"readers observed torn epochs: {torn[:3]}"


# -- the engine on a live pipeline's epochs ------------------------------------------

@pytest.mark.parametrize("temporal", [False, True],
                         ids=["days", "temporal"])
def test_engine_verbs_equal_jax_engine_and_the_pipeline(temporal, tmp_path):
    pipe, roster = _run_port(temporal=temporal, snap_dir=tmp_path / "s")
    try:
        engine = QueryEngine(pipe.read_mirror)
        epoch = engine.pin()
        assert epoch.events == NUM_EVENTS
        days = pipe.lecture_days()
        ours = _answers(engine, roster, days)
        assert ours == _answers(_jax_engine_on(epoch), roster, days)
        # ... and the pipeline's own answers from the card state.
        exact = pipe.count_all()
        assert ours["occupancy"] == exact
        assert ours["pfcount"] == [pipe.count(d) for d in days] + [0]
        assert all(ours["exists"][:1500]), "false negatives on the roster"
        assert (ours["stats"]["valid"], ours["stats"]["invalid"]) == \
            pipe.validity_counts()
        assert ours["stats"]["roster_size"] == len(roster)
        if temporal:
            windows = pipe.window_counts()
            assert len(ours["window_occupancy"]) == len(windows) > 1
            assert sorted(ours["window_occupancy"].values()) == \
                sorted(windows.values())
            assert ours["series"] and ours["window_all"] > 0
        for verb in ("occupancy", "window_occupancy"):
            assert engine.execute(verb) == getattr(engine, verb)()
        with pytest.raises(ValueError, match="verb"):
            engine.execute("nope")
    finally:
        pipe.cleanup()
    assert resolve_days(["LECTURE_20260714", 7]).tolist() == [20260714, 7]


def test_pipeline_publishes_at_preload_barriers_and_restore(tmp_path):
    """Epochs at preload (0 events), at every durable barrier (events
    never decrease, the last equals the run), at restore (a fresh
    pipeline on the same directory), and on ``publish_epoch()`` without
    checkpointing."""
    snap = tmp_path / "s"
    pipe = FusedPipeline(Config(**_cfg(snap)),
                         client=MemoryClient(MemoryBroker()), num_banks=8,
                         device="cpu")
    seen = []
    publish = pipe.read_mirror.publish

    def spy(**kw):
        epoch = publish(**kw)
        seen.append((epoch.seq, epoch.events))
        return epoch

    pipe.read_mirror.publish = spy
    roster, frames = _stream(3, False)
    pipe.preload(roster)
    assert seen == [(1, 0)]
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=NUM_EVENTS, idle_timeout_s=0.3)
    assert len(seen) >= 1 + NUM_EVENTS // BATCH // 2
    assert [e for _, e in seen] == sorted(e for _, e in seen)
    assert seen[-1][1] == NUM_EVENTS
    want = QueryEngine(pipe.read_mirror).occupancy()
    pipe.cleanup()
    again = FusedPipeline(Config(**_cfg(snap)),
                          client=MemoryClient(MemoryBroker()), num_banks=8,
                          device="cpu")
    try:
        epoch = again.read_mirror.pin()
        assert epoch.events == NUM_EVENTS and epoch.bloom_words is not None
        assert QueryEngine(again.read_mirror).occupancy() == want
    finally:
        again.cleanup()
    plain, _ = _run_port(seed=3)
    try:
        # Neither checkpointing nor serving: the preload read nothing.
        assert plain.read_mirror.pin() is None
        plain.publish_epoch()
        assert plain.read_mirror.pin().events == NUM_EVENTS
        assert QueryEngine(plain.read_mirror).occupancy() == want
    finally:
        plain.cleanup()


# -- the binary RPC --------------------------------------------------------------------

def _rpc_answers(client, roster, days):
    return dict(
        exists=client.bf_exists(_probes(roster)).tolist(),
        pfcount=client.pfcount(list(days) + [123]).tolist(),
        occupancy=client.occupancy(), rate=client.attendance_rate(),
        rate_given=client.attendance_rate(1000),
        window_all=client.window_pfcount(),
        window_occupancy=client.window_occupancy(),
        series=client.rate_series(), series_day=client.rate_series(
            days[0] if days else None, 500),
        stats={k: v for k, v in client.stats().items()
               if k not in _TIMELESS})


def test_rpc_roundtrip_and_chunking(tmp_path):
    pipe, roster = _run_port(seed=9, snap_dir=tmp_path / "s", serve_port=-1)
    try:
        assert pipe.query_server is not None
        engine = pipe.query_engine
        qc = QueryClient(pipe.query_server.address, batch_max=257)
        probes = _probes(roster)
        np.testing.assert_array_equal(qc.bf_exists(probes),
                                      engine.bf_exists(probes))
        days = pipe.lecture_days()
        assert qc.pfcount(days).tolist() == engine.pfcount(days).tolist()
        assert qc.occupancy() == engine.occupancy()
        assert qc.attendance_rate() == engine.attendance_rate()
        assert qc.stats()["events"] == NUM_EVENTS
        assert qc.bf_exists([]).shape == (0,)
        with pytest.raises(RuntimeError, match="batch"):
            QueryClient(pipe.query_server.address,
                        batch_max=1 << 20).bf_exists(
                np.zeros(pipe.config.query_batch_max + 1, np.uint32))
        qc.close()
    finally:
        pipe.cleanup()


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_rpc_across_packages(server_pkg, tmp_path):
    """A JAX QueryClient on the port's server and a port QueryClient on
    the JAX server (over a JAX engine on the same epoch): every op gives
    the answers of the in-process engine, temporal verbs included."""
    pipe, roster = _run_port(seed=11, temporal=True,
                             snap_dir=tmp_path / "s", serve_port=-1)
    try:
        days = pipe.lecture_days()
        want = _rpc_answers(pipe.query_engine, roster, days)
        if server_pkg == "torch":
            client = jrpc.QueryClient(pipe.query_server.address,
                                      batch_max=700)
            got = _rpc_answers(client, roster, days)
        else:
            server = jrpc.QueryServer(
                _jax_engine_on(pipe.read_mirror.pin())).start()
            client = QueryClient(server.address, batch_max=700)
            try:
                got = _rpc_answers(client, roster, days)
            finally:
                server.stop()
        client.close()
        got["exists"] = [bool(x) for x in got["exists"]]
        want["exists"] = [bool(x) for x in want["exists"]]
        assert got == want
    finally:
        pipe.cleanup()


# -- the chain reader ------------------------------------------------------------------

def test_chain_source_over_a_port_chain_equals_the_live_mirror(tmp_path):
    snap = tmp_path / "s"
    pipe, roster = _run_port(seed=13, temporal=True, snap_dir=snap)
    try:
        source = ChainEpochSource(snap)
        epoch = source.pin()
        assert epoch.source == "chain" and epoch.events == NUM_EVENTS
        assert epoch.published_at == pytest.approx(
            (snap / CHAIN_MANIFEST).stat().st_mtime, abs=5.0)
        live = _answers(QueryEngine(pipe.read_mirror), roster,
                        pipe.lecture_days())
        got = _answers(QueryEngine(source), roster, pipe.lecture_days())
        live["stats"].pop("roster_size")  # the chain records no roster
        got["stats"].pop("roster_size")
        for k in ("rate", "rate_given", "series", "series_day"):
            live.pop(k)
            got.pop(k)
        assert got == live
        assert not source.reload()  # nothing new on disk
        assert source.reload(force=True) and source.pin().seq == 2
    finally:
        pipe.cleanup()


def test_chain_source_over_a_jax_chain(tmp_path):
    """The port's reader over a chain the JAX pipeline wrote answers as
    the JAX reader does and as the JAX pipeline counted."""
    snap = tmp_path / "j"
    jpipe = JaxPipeline(JaxConfig(transport_backend="memory", **_cfg(snap)),
                        client=jbroker.MemoryClient(jbroker.MemoryBroker()),
                        num_banks=8)
    try:
        roster, frames = _stream(17, False)
        jpipe.preload(roster)
        producer = jpipe.client.create_producer(jpipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        jpipe.run(max_events=NUM_EVENTS, idle_timeout_s=0.3)
        counted = jpipe.count_all()
        days = jpipe.lecture_days()
    finally:
        jpipe.cleanup()
    ours = QueryEngine(ChainEpochSource(snap))
    theirs = jengine.QueryEngine(jchain.ChainEpochSource(snap))
    assert ours.occupancy() == theirs.occupancy() == counted
    a, b = _answers(ours, roster, days), _answers(theirs, roster, days)
    a["exists"] = [bool(x) for x in a["exists"]]
    b["exists"] = [bool(x) for x in b["exists"]]
    assert a == b


def test_corrupt_chain_keeps_serving_and_quarantines(tmp_path, monkeypatch):
    snap = tmp_path / "s"
    pipe, roster = _run_port(seed=19, snap_dir=snap,
                             snapshot_compact_every=100)
    pipe.cleanup()
    source = ChainEpochSource(snap)
    first = source.pin()
    want = QueryEngine(source).occupancy()
    # The compaction race: a named delta vanishes once, then reads.
    from attendance_tpu_torch.serve import chain as tchain
    real = tchain.read_chain_state
    raced = {"n": 0}

    def racing(snap_dir):
        raced["n"] += 1
        if raced["n"] == 1:
            raise integrity.ChainIntegrityError("missing", snap / "x.npz")
        return real(snap_dir)

    monkeypatch.setattr(tchain, "read_chain_state", racing)
    assert source.reload(force=True) and raced["n"] == 2
    monkeypatch.setattr(tchain, "read_chain_state", real)
    # Rot in a delta: quarantined and counted, the last epoch served.
    delta = sorted(snap.glob("delta-*.npz"))[-1]
    data = bytearray(delta.read_bytes())
    data[len(data) // 2] ^= 0xFF
    delta.write_bytes(bytes(data))
    before = integrity.corrupt_counts["digest_mismatch"]
    assert not source.reload(force=True)
    assert source.pin().seq == first.seq + 1  # still the good epoch
    assert QueryEngine(source).occupancy() == want
    assert not delta.exists()
    assert (snap / integrity.QUARANTINE_SUBDIR / delta.name).exists()
    assert integrity.corrupt_counts["digest_mismatch"] == before + 1
    assert not source.reload()  # the same rot is not counted twice
    assert integrity.corrupt_counts["digest_mismatch"] == before + 1
    # A reader starting on a rotten chain has nothing safe to serve.
    base = snap / "fused_sketch.npz"
    base.write_bytes(base.read_bytes()[:100])
    with pytest.raises(RuntimeError, match="corrupt"):
        ChainEpochSource(snap)


def test_serve_verb_in_a_subprocess(tmp_path):
    snap = tmp_path / "s"
    pipe, roster = _run_port(seed=23, temporal=True, snap_dir=snap)
    days = pipe.lecture_days()
    pipe.cleanup()
    want = _rpc_answers(QueryEngine(ChainEpochSource(snap)), roster, days)
    proc = subprocess.Popen(
        [sys.executable, "-m", "attendance_tpu_torch", "serve",
         "--snapshot-dir", str(snap), "--serve-port", "-1",
         "--serve-seconds", "60"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        line = ""
        deadline = time.monotonic() + 60
        while "serving" not in line:
            assert time.monotonic() < deadline and proc.poll() is None
            line = proc.stdout.readline()
        assert f"{NUM_EVENTS} events" in line
        client = QueryClient(line.split(" on ")[1].split()[0])
        got = _rpc_answers(client, roster, days)
        client.close()
        assert got == want
    finally:
        proc.kill()
        proc.wait(timeout=30)
    no_dir = subprocess.run(
        [sys.executable, "-m", "attendance_tpu_torch", "serve"],
        capture_output=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert no_dir.returncode == 2
