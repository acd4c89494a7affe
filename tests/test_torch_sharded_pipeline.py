"""The port's fused pipeline on a mesh (``--num-shards``/``--num-replicas``)
against the JAX package's, on the same seeded frames.

The JAX pipelines run on conftest's 8 virtual CPU devices, the port's on
``make_mesh(sp, dp, ["cpu"] * (sp * dp))``; both with the numpy host
path (``ATP_NATIVE=0``). Every compared value is equal (the fill
fraction at rel 1e-5: JAX sums popcounts in float32). Snapshot chains
cross mesh shapes, the single-card pipeline and the two packages.
"""

import numpy as np
import pytest
import torch

from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.parallel.sharded import (
    ShardedSketchEngine as JaxEngine, make_mesh as jax_mesh)
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.transport.memory_broker import (
    MemoryBroker as JaxBroker, MemoryClient as JaxClient)
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models.bloom import (
    bloom_packed_fill_fraction, bloom_packed_set_bits)
from attendance_tpu_torch.models.fused import state_to_numpy
from attendance_tpu_torch.parallel import ShardedSketchEngine, make_mesh
from attendance_tpu_torch.pipeline.analyzer import AttendanceAnalyzer
from attendance_tpu_torch.pipeline.events import decode_planar_batch
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401


@pytest.fixture(autouse=True)
def numpy_host_path(monkeypatch):
    monkeypatch.setenv("ATP_NATIVE", "0")


def port_pipe(sp=1, dp=1, broker=None, **cfg):
    """The port's pipeline: on a mesh of CPU cells, or on the CPU."""
    config = Config(num_shards=sp, num_replicas=dp, **cfg)
    client = MemoryClient(broker or MemoryBroker())
    if sp * dp > 1:
        return FusedPipeline(config, client=client, num_banks=8,
                             mesh=make_mesh(sp, dp, ["cpu"] * (sp * dp)))
    return FusedPipeline(config, client=client, num_banks=8, device="cpu")


def jax_pipe(sp=1, dp=1, **cfg):
    return JaxPipeline(JaxConfig(num_shards=sp, num_replicas=dp,
                                 transport_backend="memory", **cfg),
                       client=JaxClient(JaxBroker()), num_banks=8)


def feed(pipe, frames, roster=None, max_events=None):
    if roster is not None:
        pipe.preload(roster)
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=max_events, idle_timeout_s=0.3)


def state_of(pipe):
    """(bloom words, merged registers) of either package's pipeline."""
    if getattr(pipe, "engine", None) is not None:
        bits, regs = pipe.engine.get_state()
        return np.asarray(bits), np.asarray(regs)
    if isinstance(pipe, FusedPipeline):
        return state_to_numpy(pipe.state)[:2]
    return np.asarray(pipe.state.bloom_bits), np.asarray(pipe.state.hll_regs)


def stored(pipe, deduplicate=False):
    cols = pipe.store.to_columns(deduplicate=deduplicate)
    return {k: np.asarray(cols[k]) for k in ("student_id", "lecture_day",
                                              "micros", "is_valid")}


def assert_same_pipeline(a, b, rows=True):
    """Counters, PFCOUNTs, the bank map, the filter, the merged registers
    and (``rows``) the stored rows of two pipelines equal."""
    assert a.validity_counts() == b.validity_counts()
    assert a.count_all() == b.count_all()
    assert a._bank_of == b._bank_of
    for x, y in zip(state_of(a), state_of(b)):
        np.testing.assert_array_equal(x, y)
    if rows:
        sa, sb = stored(a), stored(b)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])


@pytest.mark.parametrize("sp,dp", [(4, 2), (2, 2), (8, 1)])
def test_sharded_pipeline_end_to_end(sp, dp):
    num_events, batch = 20_000, 4_096
    kw = dict(roster_size=10_000, num_lectures=8, invalid_fraction=0.2,
              seed=13)
    roster, frames = generate_frames(num_events, batch, **kw)
    frames = list(frames)
    port = port_pipe(sp, dp, bloom_filter_capacity=50_000)
    ref = jax_pipe(sp, dp, bloom_filter_capacity=50_000)
    try:
        assert port.engine.sp == sp and port.engine.dp == dp
        for pipe in (port, ref):
            feed(pipe, frames, roster, num_events)
        assert port.metrics.events == num_events
        assert port.consumer.backlog() == 0
        assert port.metrics.wire_dwell == ref.metrics.wire_dwell == {
            "word": 5}
        assert_same_pipeline(port, ref)
        assert port.estimated_fpr() == pytest.approx(ref.estimated_fpr(),
                                                     rel=1e-5)
        cols = stored(port)
        in_roster = np.isin(cols["student_id"], roster)
        assert cols["is_valid"][in_roster].all()  # no false negatives
        assert cols["is_valid"][~in_roster].mean() <= 0.02
        truth = np.concatenate([decode_planar_batch(f)["is_valid"]
                                for f in frames])
        assert not (truth & ~cols["is_valid"]).any()
        for day in port.lecture_days():
            sel = cols["is_valid"] & (cols["lecture_day"] == day)
            exact = len(np.unique(cols["student_id"][sel]))
            assert port.count(day) == pytest.approx(exact, rel=0.05, abs=3)
            assert port.count(day) == ref.count(day)
        insights = AttendanceAnalyzer(port.store).generate_insights()
        assert insights[0]["title"] == "Habitual Latecomers"
    finally:
        port.cleanup()
        ref.cleanup()


def test_sharded_matches_single_chip_answers():
    """The mesh pipeline stores the single-card pipeline's validity and
    holds its state, as the JAX mesh does."""
    num_events, batch = 8_192, 2_048
    roster, frames = generate_frames(num_events, batch, roster_size=5_000,
                                     num_lectures=4, seed=17)
    frames = list(frames)
    pipes = [port_pipe(1, 1, bloom_filter_capacity=20_000),
             port_pipe(4, 2, bloom_filter_capacity=20_000),
             jax_pipe(4, 2, bloom_filter_capacity=20_000)]
    try:
        for pipe in pipes:
            feed(pipe, frames, roster, num_events)
        single, mesh, ref = pipes
        assert single.engine is None
        assert_same_pipeline(single, mesh)
        assert_same_pipeline(mesh, ref)
    finally:
        for pipe in pipes:
            pipe.cleanup()


def test_sharded_fill_fraction_matches_host():
    """The mesh's fill (the slices' popcounts summed) is the host
    popcount of get_state's words, and JAX's at rel 1e-5."""
    roster = np.arange(50_000, 80_000, dtype=np.uint32)
    jax_eng = JaxEngine(jax_mesh(num_shards=4, num_replicas=2),
                        capacity=30_000, error_rate=0.01, num_banks=4)
    port = ShardedSketchEngine(make_mesh(4, 2, ["cpu"] * 8),
                               capacity=30_000, error_rate=0.01, num_banks=4)
    jax_eng.preload(roster)
    port.preload(roster)
    words, _ = port.get_state()
    host = torch.from_numpy(words.view(np.int32).copy())
    assert port.fill_fraction() == float(bloom_packed_fill_fraction(host))
    assert port.fill_fraction() == pytest.approx(jax_eng.fill_fraction(),
                                                 rel=1e-5)
    assert 0.0 < port.fill_fraction() < 1.0


def test_million_key_roster_sharded():
    """A 1M-student roster on a 4 x 2 mesh of CPU cells (the card runs
    BASELINE config #4's 10M, chip_smoke.py phase 10): no false
    negatives on a member sample, FPR at most 1.3% on a disjoint one,
    each cell a 1/sp slice of the packed filter, the fill equal to the
    host popcount, and the filter equal to the JAX engine's."""
    capacity = 1_000_000
    port = ShardedSketchEngine(make_mesh(4, 2, ["cpu"] * 8),
                               capacity=capacity, error_rate=0.01,
                               num_banks=4)
    assert {b.numel() * 4 for row in port.bits for b in row} == {
        port.m_alloc // 8 // port.sp}
    lo, hi = 1 << 20, (1 << 20) + capacity
    roster = np.arange(lo, hi, dtype=np.uint32)
    port.preload(roster)
    rng = np.random.default_rng(23)
    members = rng.integers(lo, hi, 100_000).astype(np.uint32)
    assert port.contains(members).all()
    outsiders = rng.integers(1 << 28, 1 << 29, 100_000).astype(np.uint32)
    assert port.contains(outsiders).mean() <= 0.013
    words, _ = port.get_state()
    set_bits = int(bloom_packed_set_bits(torch.from_numpy(
        words.view(np.int32).copy())))
    assert port.fill_fraction() == set_bits / port.params.m_bits
    jax_eng = JaxEngine(jax_mesh(num_shards=4, num_replicas=2),
                        capacity=capacity, error_rate=0.01, num_banks=4)
    jax_eng.preload(roster)
    np.testing.assert_array_equal(words, jax_eng.get_state()[0])
    keys = rng.integers(lo, hi, port.padded_size(8_192)).astype(np.uint32)
    banks = (keys & 1).astype(np.int32)
    port.step(keys, banks)
    ests = port.count_all()
    for b in (0, 1):
        exact = len(np.unique(keys[banks == b]))
        assert ests[b] == pytest.approx(exact, rel=0.05, abs=3)
    assert ests[2] == ests[3] == 0


def test_sharded_validity_counts_and_snapshot_counts(tmp_path):
    """A mesh chain's counters restore on another mesh shape, on the
    single-card port, and in the JAX package (mesh and single)."""
    num_events, batch = 4_096, 1_024
    roster, frames = generate_frames(num_events, batch, roster_size=4_000,
                                     num_lectures=4, seed=31)
    cfg = dict(bloom_filter_capacity=10_000, snapshot_dir=str(tmp_path))
    pipe = port_pipe(2, 2, snapshot_every_batches=2, **cfg)
    feed(pipe, frames, roster, num_events)
    vc = pipe.validity_counts()
    assert sum(vc) == num_events
    pipe.snapshot()
    restored = [port_pipe(4, 1, **cfg), port_pipe(1, 1, **cfg),
                jax_pipe(4, 1, **cfg), jax_pipe(1, 1, **cfg)]
    try:
        for other in restored:
            assert tuple(other.validity_counts()) == vc
            assert_same_pipeline(pipe, other, rows=False)
    finally:
        for p in [pipe] + restored:
            p.cleanup()


@pytest.mark.parametrize("mode", ["delta", "barrier"])
def test_jax_mesh_chain_restores_in_the_port_and_back(tmp_path, mode):
    """A JAX mesh run's chain (delta or barrier barriers) restores in the
    port's mesh of another shape and in its single-card pipeline; the
    port's mesh chain restores in JAX's mesh and single-card pipeline.
    State, counters and stored rows equal."""
    num_events, batch = 8_192, 1_024
    roster, frames = generate_frames(num_events, batch, roster_size=4_000,
                                     num_lectures=5, seed=43)
    frames = list(frames)
    cfg = dict(bloom_filter_capacity=10_000, snapshot_mode=mode,
               snapshot_every_batches=2)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    src_jax = jax_pipe(2, 4, snapshot_dir=str(jax_dir), **cfg)
    src_port = port_pipe(4, 2, snapshot_dir=str(port_dir), **cfg)
    opened = [src_jax, src_port]
    try:
        for pipe in (src_jax, src_port):
            feed(pipe, frames, roster, num_events)
        assert_same_pipeline(src_jax, src_port)
        chain = sorted(p.name for p in port_dir.iterdir())
        if mode == "delta":
            assert any(n.startswith("delta-") for n in chain), chain
        for make, snap, src in (
                (lambda d: port_pipe(2, 2, snapshot_dir=d, **cfg), jax_dir,
                 src_jax),
                (lambda d: port_pipe(1, 1, snapshot_dir=d, **cfg), jax_dir,
                 src_jax),
                (lambda d: jax_pipe(2, 4, snapshot_dir=d, **cfg), port_dir,
                 src_port),
                (lambda d: jax_pipe(1, 1, snapshot_dir=d, **cfg), port_dir,
                 src_port)):
            dst = make(str(snap))
            opened.append(dst)
            assert_same_pipeline(src, dst, rows=False)
            a = stored(src, deduplicate=True)
            b = stored(dst, deduplicate=True)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    finally:
        for p in opened:
            p.cleanup()


def test_sharded_crash_replay_resume_matches_uninterrupted(tmp_path):
    """A crash mid-stream on a 2 x 4 mesh (delta snapshots every 3
    frames), resumed on a 4 x 2 mesh that drains the redelivered frames:
    the same final counters, PFCOUNTs, state and deduplicated store as
    an uninterrupted run (tests/test_checkpoint_resume.py:252)."""
    num_events, batch = 24_576, 2_048
    roster, frames = generate_frames(num_events, batch, roster_size=8_000,
                                     num_lectures=6, invalid_fraction=0.15,
                                     seed=37)
    frames = list(frames)
    cfg = dict(bloom_filter_capacity=30_000)
    ref = port_pipe(2, 4, **cfg)
    broker = MemoryBroker()
    snap = dict(snapshot_dir=str(tmp_path / "snaps"),
                snapshot_every_batches=3)
    a = port_pipe(2, 4, broker=broker, **cfg, **snap)
    b = None
    try:
        feed(ref, frames, roster, num_events)
        feed(a, frames, roster, int(num_events * 0.6))
        a.consumer.close()  # crash: the unacked frames redeliver
        b = port_pipe(4, 2, broker=broker, **cfg, **snap)
        assert b.store.count() > 0  # restored on construction
        b.run(idle_timeout_s=0.3)
        assert b.consumer.backlog() == 0
        assert_same_pipeline(ref, b, rows=False)
        x, y = stored(ref, deduplicate=True), stored(b, deduplicate=True)
        order_x = np.lexsort((x["student_id"], x["micros"],
                              x["lecture_day"]))
        order_y = np.lexsort((y["student_id"], y["micros"],
                              y["lecture_day"]))
        for k in x:
            np.testing.assert_array_equal(x[k][order_x], y[k][order_y])
    finally:
        for p in (ref, a, b):
            if p is not None:
                p.cleanup()


@pytest.mark.parametrize("wire", ["seg", "delta"])
def test_sharded_narrow_wires_match_word_wire(wire):
    """tests/test_sharded_pipeline.py:151 on the port: a forced narrow
    wire on a (2, 2) mesh lands on the word wire's stored rows, PFCOUNTs
    and counters, every frame on that wire, and equals the JAX mesh
    pipeline on the same wire (state, counters, stored validity)."""
    num_events, batch = 8_192, 2_048
    roster, frames = generate_frames(num_events, batch, roster_size=5_000,
                                     num_lectures=6, seed=29)
    frames = list(frames)
    cfg = dict(bloom_filter_capacity=20_000)
    pipes = [port_pipe(2, 2, wire_format="auto", **cfg),
             port_pipe(2, 2, wire_format=wire, **cfg),
             jax_pipe(2, 2, wire_format=wire, **cfg)]
    try:
        for pipe in pipes:
            feed(pipe, frames, roster, num_events)
        word, narrow, ref = pipes
        assert word.metrics.wire_dwell == {"word": 4}
        assert narrow.metrics.wire_dwell == ref.metrics.wire_dwell == {
            wire: 4}
        assert narrow.consumer.backlog() == 0
        assert sum(narrow.validity_counts()) == num_events
        assert_same_pipeline(word, narrow)
        assert_same_pipeline(narrow, ref)
    finally:
        for pipe in pipes:
            pipe.cleanup()


@pytest.mark.parametrize("wire", ["seg", "delta"])
def test_sharded_narrow_native_pack_matches_numpy(wire, monkeypatch):
    """tests/test_sharded_pipeline.py:196 on the port: the mesh's
    per-replica packs by the native host pack and by numpy send
    identical buffers (mode, width, lanes and every word) and store the
    same rows."""
    monkeypatch.delenv("ATP_NATIVE")
    num_events, batch = 8_192, 2_048
    roster, frames = generate_frames(num_events, batch, roster_size=5_000,
                                     num_lectures=6, seed=37)
    frames = list(frames)
    results = []
    for force_numpy in (False, True):
        pipe = port_pipe(2, 2, bloom_filter_capacity=20_000,
                         wire_format=wire)
        if force_numpy:
            pipe._native = None
        else:
            assert pipe._native is not None
        sent = []
        step_narrow = pipe.engine.step_narrow

        def spy(bufs, mode, width, padded_local, _orig=step_narrow):
            sent.append((bufs.copy(), mode, width, padded_local))
            return _orig(bufs, mode, width, padded_local)

        pipe.engine.step_narrow = spy
        try:
            feed(pipe, frames, roster, num_events)
            results.append((sent, stored(pipe), pipe.validity_counts()))
        finally:
            pipe.cleanup()
    (sent_nat, rows_nat, vc_nat), (sent_np, rows_np, vc_np) = results
    assert len(sent_nat) == len(sent_np) == 4
    for (b_nat, *geo_nat), (b_np, *geo_np) in zip(sent_nat, sent_np):
        assert geo_nat == geo_np and geo_nat[0] == wire
        np.testing.assert_array_equal(b_nat, b_np)
    for k in rows_nat:
        np.testing.assert_array_equal(rows_nat[k], rows_np[k])
    assert vc_nat == vc_np


@pytest.mark.parametrize("level,wire", [(1, "seg"), (2, "delta")])
def test_sharded_auto_ladder_dispatches_narrow_under_pressure(level, wire):
    """tests/test_sharded_pipeline.py:308 on the port: ``auto`` on a mesh
    climbs the ladder as one card does (here set to its level, as if the
    climb signal fired) and dispatches the narrow wire, native pack or
    not; the state equals the word wire's run and the JAX mesh
    pipeline's on the same stream (whose ladder follows its own
    deque)."""
    num_events, batch = 4_096, 1_024
    roster, frames = generate_frames(num_events, batch, roster_size=4_000,
                                     num_lectures=4, seed=47)
    frames = list(frames)
    cfg = dict(bloom_filter_capacity=10_000, wire_format="auto")
    pipe, ref = port_pipe(2, 2, **cfg), port_pipe(2, 2, **cfg)
    jax_ref = jax_pipe(2, 2, **cfg)
    try:
        pipe.preload(roster)
        pipe._auto_level, pipe._auto_pressure = level, 0
        feed(pipe, frames, None, num_events)
        assert pipe.metrics.wire_dwell == {wire: 4}
        assert sum(pipe.validity_counts()) == num_events
        for other in (ref, jax_ref):
            feed(other, frames, roster, num_events)
            assert_same_pipeline(pipe, other)
        assert ref.metrics.wire_dwell == {"word": 4}
    finally:
        for p in (pipe, ref, jax_ref):
            p.cleanup()


def test_mesh_checkpoint_on_the_delta_wire_restores_equal(tmp_path):
    """A (2, 2) mesh run on the delta wire with delta snapshots every 2
    frames restores on a (4, 1) mesh, on one card and in the JAX mesh to
    the run's state, counters and stored rows: the state does not depend
    on the wire."""
    num_events, batch = 8_192, 1_024
    roster, frames = generate_frames(num_events, batch, roster_size=4_000,
                                     num_lectures=5, seed=53)
    cfg = dict(bloom_filter_capacity=10_000, snapshot_dir=str(tmp_path))
    src = port_pipe(2, 2, wire_format="delta", snapshot_every_batches=2,
                    **cfg)
    opened = [src]
    try:
        feed(src, frames, roster, num_events)
        assert src.metrics.wire_dwell == {"delta": 8}
        assert any(p.name.startswith("delta-") for p in tmp_path.iterdir())
        src.snapshot()
        for dst in (port_pipe(4, 1, **cfg), port_pipe(1, 1, **cfg),
                    jax_pipe(2, 2, **cfg)):
            opened.append(dst)
            assert_same_pipeline(src, dst, rows=False)
            a = stored(src, deduplicate=True)
            b = stored(dst, deduplicate=True)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    finally:
        for p in opened:
            p.cleanup()


def test_mesh_refusals():
    """The temporal plane is single-card (as the JAX config says), a mesh
    must match the config, and a mesh config with no card and no mesh
    raises (the port never drops to the CPU)."""
    mesh = make_mesh(2, 1, ["cpu"] * 2)
    with pytest.raises(ValueError, match="single-chip only"):
        Config(num_shards=2, temporal_period_s=60)
    with pytest.raises(ValueError, match="single-chip only"):
        JaxConfig(num_shards=2, temporal_period_s=60).validate()
    with pytest.raises(ValueError, match="unknown replica sync"):
        Config(replica_sync="never")
    with pytest.raises(ValueError, match="not the config"):
        FusedPipeline(Config(num_shards=4), mesh=mesh)
    with pytest.raises(ValueError, match="first cell"):
        FusedPipeline(Config(num_shards=2), mesh=mesh, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices"):
            FusedPipeline(Config(num_shards=2))


def test_bytes_wire_on_a_mesh_warns_and_carries_words(caplog):
    """As in JAX: --wire-format bytes has no effect on a mesh."""
    roster, frames = generate_frames(4_096, 2_048, roster_size=1_000,
                                     num_lectures=2, seed=3)
    pipe = port_pipe(2, 1, bloom_filter_capacity=5_000, wire_format="bytes")
    try:
        feed(pipe, frames, roster, 4_096)
        assert pipe.metrics.wire_dwell == {"word": 2}
        assert "no effect" in caplog.text
    finally:
        pipe.cleanup()


def test_mesh_serves_the_epochs_of_its_barriers(tmp_path):
    """The query plane on a mesh: epochs published at the mesh's
    barriers (its merged state, read by ``_host_state``) answer as the
    pipeline does, as JAX's mesh serves its ``_mirror_gather``."""
    roster, frames = generate_frames(8_192, 2_048, roster_size=3_000,
                                     num_lectures=4, seed=5)
    pipe = port_pipe(2, 2, bloom_filter_capacity=10_000, serve_port=-1,
                     snapshot_dir=str(tmp_path), snapshot_every_batches=1)
    try:
        feed(pipe, frames, roster, 8_192)
        engine = pipe.query_engine
        days = pipe.lecture_days()
        assert engine.pfcount(days).tolist() == [pipe.count(d) for d in days]
        assert engine.occupancy() == pipe.count_all()
        assert engine.bf_exists(roster).all()
        stats = engine.stats()
        assert (stats["valid"], stats["invalid"]) == pipe.validity_counts()
    finally:
        pipe.cleanup()


def test_fused_verb_takes_the_mesh_flags():
    """``fused --num-shards/--num-replicas/--replica-sync`` reach the
    config; with no card (and the CLI never builds a list of repeated
    devices) a mesh run raises instead of dropping to the CPU."""
    from attendance_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["fused", "--num-shards", "4", "--num-replicas", "2",
         "--replica-sync", "step"])
    assert (args.num_shards, args.num_replicas, args.replica_sync) == (
        4, 2, "step")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 8 devices"):
            cli.main(["fused", "--num-events", "4096", "--num-shards", "4",
                      "--num-replicas", "2"])
