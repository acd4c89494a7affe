"""The port's integrity plane against the JAX package's, on the CPU.

Digests, ``wrap_record`` and the checksummed wire frame give equal bytes
in both packages, and a spill record written by either drains in the
other. On the same rotted directories (the fused chain with a flipped,
truncated, stale-rewritten, missing or orphan delta, a torn manifest, a
stale base digest and a rotted event segment; the generic store chain's
classes; a spill with a rotted and a legacy record; a quarantine with a
rotted frame; an incident bundle) the port's ``scrub_report`` text and
verdict equal JAX's, and the ``scrub`` verb's output and exit codes
equal JAX's verb's. The disk fault hooks mangle the same bytes and keep
the same ledger, scrub accounts for every surviving injection, ENOSPC
skips the writer's backoff ladder and is counted, and the spill drops a
rotted record loudly while a legacy one drains. Tolerance 0.
"""

import json
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from attendance_tpu import chaos as jchaos
from attendance_tpu import cli as jcli
from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.sketch.memory_store import (
    MemorySketchStore as JaxMemoryStore)
from attendance_tpu.storage import resilient as jresilient
from attendance_tpu.transport import framing as jframing
from attendance_tpu.utils import integrity as jintegrity
from attendance_tpu.utils import snapshot as jsnapshot
from attendance_tpu_torch import chaos, cli, obs
from attendance_tpu_torch.chaos import soak
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.fast_path import (
    CHAIN_MANIFEST, EVENTS_SEGMENTS, SKETCH_SNAPSHOT, FusedPipeline)
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.sketch.memory_store import MemorySketchStore
from attendance_tpu_torch.storage.resilient import (
    CircuitBreaker, ResilientEventStore)
from attendance_tpu_torch.transport import framing
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.transport.quarantine import (
    Quarantine, list_entries)
from attendance_tpu_torch.utils import integrity, snapshot
from attendance_tpu_torch.utils.integrity import (
    IntegrityError, unwrap_record, wrap_record)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401


@pytest.fixture(autouse=True)
def _reset_globals():
    for pkg in (chaos, obs, jchaos, jobs):
        pkg.disable()
    yield
    for pkg in (chaos, obs, jchaos, jobs):
        pkg.disable()


def _flip_mid_byte(path):
    raw = bytearray(Path(path).read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    Path(path).write_bytes(bytes(raw))


def _truncate(path):
    raw = Path(path).read_bytes()
    Path(path).write_bytes(raw[:len(raw) // 2])


# -- digests and checksummed records ------------------------------------------

def test_digests_equal_jax(tmp_path):
    data = b"storage rot is silent until it is not" * 100
    p = tmp_path / "blob"
    p.write_bytes(data)
    assert integrity.bytes_digest(data) == jintegrity.bytes_digest(data)
    assert integrity.file_digest(p, chunk_size=7) == jintegrity.file_digest(p)


@pytest.mark.parametrize("magic", [integrity.RECORD_MAGIC, b"CKF1", b"X"])
def test_record_wrap_bytes_equal_jax_and_rot_raises(magic):
    blob = b"spill batch payload" * 50
    wrapped = wrap_record(blob, magic)
    assert wrapped == jintegrity.wrap_record(blob, magic)
    assert unwrap_record(wrapped, magic) == (blob, True)
    assert unwrap_record(blob, magic) == (blob, False)  # legacy
    rotten = bytearray(wrapped)
    rotten[len(rotten) // 2] ^= 0xFF
    with pytest.raises(IntegrityError) as err:
        unwrap_record(bytes(rotten), magic)
    with pytest.raises(jintegrity.IntegrityError) as jerr:
        jintegrity.unwrap_record(bytes(rotten), magic)
    assert str(err.value) == str(jerr.value)


def test_checksummed_frame_equals_jax():
    body = b"\x01\x00merge frame bytes" * 20
    wire = framing.enc_checksummed(body)
    assert wire == jframing.enc_checksummed(body)
    assert framing.dec_checksummed(wire) == (body, True)
    assert framing.dec_checksummed(body) == (body, False)
    rotten = bytearray(wire)
    rotten[-3] ^= 0xFF
    with pytest.raises(framing.FrameChecksumError) as err:
        framing.dec_checksummed(bytes(rotten))
    with pytest.raises(jframing.FrameChecksumError) as jerr:
        jframing.dec_checksummed(bytes(rotten))
    assert str(err.value) == str(jerr.value)


# -- the spill crosses packages -----------------------------------------------

class _Sink:
    def __init__(self, fail=False):
        self.fail = fail
        self.columns = []

    def insert_columns(self, cols):
        if self.fail:
            raise RuntimeError("sink down")
        self.columns.append(cols)

    def insert_batch(self, rows):
        if self.fail:
            raise RuntimeError("sink down")
        self.columns.append(rows)

    def close(self):
        pass


def _batches(n=3):
    rng = np.random.default_rng(5)
    return [{"student_id": rng.integers(0, 1 << 20, 64).astype(np.uint32),
             "lecture_day": np.full(64, 20_260_701 + i, np.uint32),
             "micros": np.arange(64, dtype=np.int64) + i,
             "is_valid": rng.random(64) < 0.9,
             "event_type": np.zeros(64, np.int8)} for i in range(n)]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_spill_written_by_one_package_drains_in_the_other(tmp_path, writer):
    mods = {"torch": (ResilientEventStore, CircuitBreaker),
            "jax": (jresilient.ResilientEventStore,
                    jresilient.CircuitBreaker)}
    reader = "jax" if writer == "torch" else "torch"
    store_cls, breaker_cls = mods[writer]
    spill = tmp_path / "spill"
    down = store_cls(_Sink(fail=True), spill, sink="columnar",
                     breaker=breaker_cls(failure_threshold=1,
                                         cooldown_s=60.0))
    batches = _batches()
    for cols in batches:
        down.insert_columns(cols)
    assert down.spill_pending == 3
    files = sorted(spill.glob("spill-*.pkl"))
    # The record is the JAX package's byte for byte.
    other = tmp_path / "other"
    mods[reader][0](_Sink(fail=True), other, sink="columnar",
                    breaker=mods[reader][1](failure_threshold=1,
                                            cooldown_s=60.0)
                    ).insert_columns(batches[0])
    assert (other / "spill-000001.pkl").read_bytes() == files[0].read_bytes()
    sink = _Sink()
    up = mods[reader][0](sink, spill, sink="columnar")
    assert up.spill_pending == 3
    assert up.flush_spill(budget_s=5.0)
    assert len(sink.columns) == 3
    for got, want in zip(sink.columns, batches):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert not list(spill.glob("spill-*.pkl"))


def test_corrupt_spill_record_dropped_mid_drain(tmp_path):
    obs.enable(Config(metrics_port=-1))
    sink = _Sink(fail=True)
    store = ResilientEventStore(
        sink, tmp_path / "spill", sink="events",
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=0.01))
    for i in range(3):
        store.insert_batch([(i, "a")])
    files = sorted((tmp_path / "spill").glob("spill-*.pkl"))
    assert len(files) == 3
    assert all(unwrap_record(f.read_bytes())[1] for f in files)
    _flip_mid_byte(files[1])
    rows, ok = integrity.scrub_paths([tmp_path / "spill"])
    assert not ok and sum(r.corrupt for r in rows) == 1
    sink.fail = False
    time.sleep(0.02)
    assert store.flush_spill(budget_s=5.0)
    assert sink.columns == [[(0, "a")], [(2, "a")]]
    assert soak.counter_total(obs.get().registry,
                              "attendance_spill_corrupt_records_total") == 1
    store.close()


def test_legacy_spill_record_still_drains(tmp_path):
    spill = tmp_path / "spill"
    spill.mkdir()
    (spill / "spill-000001.pkl").write_bytes(pickle.dumps(
        {"kind": "rows", "data": [(7, "legacy")]}))
    sink = _Sink()
    store = ResilientEventStore(sink, spill, sink="events")
    assert store.flush_spill(budget_s=5.0)
    assert sink.columns == [[(7, "legacy")]]
    store.close()


# -- scrub: the same verdict text as JAX's ------------------------------------

def _fused_chain(root: Path) -> Path:
    """A port fused chain with a base, deltas and event segments."""
    roster, frames = generate_frames(8192, 1024, roster_size=3000,
                                     num_lectures=4, seed=61)
    frames = list(frames)
    snap = root / "snaps"
    config = Config(bloom_filter_capacity=5000, snapshot_dir=str(snap),
                    snapshot_every_batches=1)
    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(config, client=client, num_banks=4, device="cpu")
    pipe.preload(roster)
    producer = client.create_producer(config.pulsar_topic)
    for f in frames[:4]:
        producer.send(f)
    pipe.run(max_events=4096, idle_timeout_s=0.3)
    pipe.snapshot()  # a full base
    for f in frames[4:]:
        producer.send(f)
    pipe.run(max_events=4096, idle_timeout_s=0.3)
    pipe.cleanup()
    chain = json.loads((snap / CHAIN_MANIFEST).read_text())
    assert chain["deltas"] and chain["digests"]
    return snap


def _stale_rewrite(path):
    with open(path, "wb") as f:
        np.savez(f, bank_idx=np.zeros(1, np.int32))


def _set_manifest(snap, **kw):
    man = json.loads((snap / CHAIN_MANIFEST).read_text())
    for k, v in kw.items():
        if v is None:
            man.pop(k, None)
        else:
            man[k] = v
    (snap / CHAIN_MANIFEST).write_text(json.dumps(man))


def _last_delta(snap):
    return snap / json.loads((snap / CHAIN_MANIFEST).read_text())["deltas"][-1]


FUSED_ROT = {
    "clean": lambda s: None,
    "flip": lambda s: _flip_mid_byte(_last_delta(s)),
    "truncate": lambda s: _truncate(_last_delta(s)),
    "torn_manifest": lambda s: _truncate(s / CHAIN_MANIFEST),
    "stale_rewrite": lambda s: _stale_rewrite(_last_delta(s)),
    "missing": lambda s: _last_delta(s).unlink(),
    "orphan": lambda s: _stale_rewrite(s / "delta-9999.npz"),
    "stale_base_digest": lambda s: _set_manifest(s, base_digest="0" * 64),
    "rotted_base": lambda s: _flip_mid_byte(s / SKETCH_SNAPSHOT),
    "legacy_truncate": lambda s: (_set_manifest(s, digests=None,
                                                base_digest=None),
                                  _truncate(_last_delta(s))),
    "no_manifest": lambda s: (s / CHAIN_MANIFEST).unlink(),
    "rotted_segment": lambda s: _flip_mid_byte(sorted(
        (s / EVENTS_SEGMENTS).glob("segment-*.npz"))[0]),
}


@pytest.fixture(scope="module")
def fused_chain(tmp_path_factory):
    return _fused_chain(tmp_path_factory.mktemp("chain"))


@pytest.mark.parametrize("rot", sorted(FUSED_ROT))
def test_scrub_of_a_rotted_fused_chain_equals_jax(tmp_path, fused_chain,
                                                  rot):
    snap = tmp_path / "snaps"
    shutil.copytree(fused_chain, snap)
    FUSED_ROT[rot](snap)
    text, ok = integrity.scrub_report([tmp_path])
    jtext, jok = jintegrity.scrub_report([tmp_path])
    assert (text, ok) == (jtext, jok)
    assert ok == (rot in ("clean", "orphan", "stale_base_digest",
                          "no_manifest")), text
    rows, _ = integrity.scrub_paths([tmp_path])
    jrows, _ = jintegrity.scrub_paths([tmp_path])
    assert [r.as_list() for r in rows] == [r.as_list() for r in jrows]


def _store_chain(d: Path):
    store = MemorySketchStore(Config())
    store.bf_reserve("bf:students", 0.01, 1000)
    store.bf_add_many("bf:students", np.arange(100, dtype=np.uint32))
    store.pfadd_many("hll:unique:1", np.arange(50, dtype=np.uint32))
    snapshot.snapshot_sketch_store_chain(store, d)  # base
    store.bf_add_many("bf:students", np.arange(100, 200, dtype=np.uint32))
    store.pfadd_many("hll:unique:1", np.arange(50, 80, dtype=np.uint32))
    snapshot.snapshot_sketch_store_chain(store, d)  # delta


@pytest.mark.parametrize("rot", ["clean", "flip", "truncate",
                                 "torn_manifest", "missing",
                                 "stale_rewrite"])
def test_scrub_of_a_rotted_store_chain_equals_jax(tmp_path, rot):
    d = tmp_path / "store-chain"
    _store_chain(d)
    victim = d / json.loads((d / "MANIFEST.json").read_text())["deltas"][0]
    if rot == "flip":
        _flip_mid_byte(victim)
    elif rot == "truncate":
        _truncate(victim)
    elif rot == "torn_manifest":
        _truncate(d / "MANIFEST.json")
    elif rot == "missing":
        victim.unlink()
    elif rot == "stale_rewrite":
        _stale_rewrite(victim)
    text, ok = integrity.scrub_report([d])
    assert (text, ok) == jintegrity.scrub_report([d])
    assert ok == (rot == "clean")


def test_scrub_of_spill_quarantine_and_incident_dirs_equals_jax(tmp_path):
    spill = tmp_path / "spill"
    store = ResilientEventStore(_Sink(fail=True), spill,
                                breaker=CircuitBreaker(failure_threshold=1,
                                                       cooldown_s=60.0))
    for cols in _batches():
        store.insert_columns(cols)
    _flip_mid_byte(sorted(spill.glob("spill-*.pkl"))[1])
    (spill / "spill-000009.pkl").write_bytes(pickle.dumps(
        {"kind": "rows", "data": [(1, "legacy")]}))
    (spill / "spill-000010.pkl").write_bytes(b"not a pickle")
    q = Quarantine(tmp_path / "q")
    q.put(b"poison frame", topic="t", reason="decode")
    q.put(b"another poison", topic="t", reason="decode")
    (entry, _) = list_entries(tmp_path / "q")
    _flip_mid_byte(Path(entry["frame"]))
    (tmp_path / "q" / "q-000077.json").write_text(json.dumps({"x": 1}))
    inc = tmp_path / "incident"
    inc.mkdir()
    (inc / "flight.json").write_text("{}")
    (inc / "prom.txt").write_text("a 1\n")
    (inc / "incident.json").write_text(json.dumps({
        "id": "inc-1", "evidence": {
            "flight.json": integrity.bytes_digest(b"{}"),
            "prom.txt": "0" * 64, "gone.txt": "1" * 64}}))
    text, ok = integrity.scrub_report([tmp_path])
    assert (text, ok) == jintegrity.scrub_report([tmp_path])
    assert not ok
    for kind in ("spill-record", "quarantine-frame", "incident-evidence"):
        assert kind in text


def test_scrub_verb_prints_and_exits_as_jax(tmp_path, fused_chain, capsys):
    snap = tmp_path / "snaps"
    shutil.copytree(fused_chain, snap)
    outs = []
    for main in (cli.main, jcli.main):
        main(["scrub", str(snap)])  # clean: exit 0 (no raise)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "PASS" in outs[0]
    _flip_mid_byte(_last_delta(snap))
    for argv, code in (([str(snap)], 1),
                       ([str(tmp_path / "no-such-dir")], 2)):
        outs = []
        for main in (cli.main, jcli.main):
            with pytest.raises(SystemExit) as exc_info:
                main(["scrub"] + argv)
            assert exc_info.value.code == code
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
    assert "digest_mismatch" in outs[0] or code == 2


# -- the disk fault hooks -----------------------------------------------------

def _store_writes(store_cls, cfg_cls, snap_mod, d: Path, seed: int):
    store = store_cls(cfg_cls())
    store.bf_reserve("bf", 0.01, 500)
    rng = np.random.default_rng(seed)
    for i in range(8):
        store.bf_add_many("bf", rng.integers(0, 10_000, 32,
                                             dtype=np.uint32))
        store.pfadd_many(f"hll:{i % 3}",
                         rng.integers(0, 10_000, 32, dtype=np.uint32))
        snap_mod.snapshot_sketch_store_chain(store, d)


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_disk_rot_ledger_equals_jax_and_scrub_finds_every_survivor(
        tmp_path, seed):
    spec = "disk_corrupt=0.5,torn_write=0.25"
    chaos.INJECTOR = inj = chaos.ChaosInjector(chaos.ChaosSpec.parse(spec),
                                               seed)
    _store_writes(MemorySketchStore, Config, snapshot, tmp_path / "t", seed)
    chaos.disable()
    jchaos.INJECTOR = jinj = jchaos.ChaosInjector(
        jchaos.ChaosSpec.parse(spec), seed)
    _store_writes(JaxMemoryStore, JaxConfig, jsnapshot, tmp_path / "j",
                  seed)
    jchaos.disable()
    assert inj.disk_faults, "the seeded spec never fired"
    assert ([(s, f, Path(p).name) for s, f, p, _ in inj.disk_faults]
            == [(s, f, Path(p).name) for s, f, p, _ in jinj.disk_faults])
    assert inj.injected == jinj.injected
    surviving = integrity.surviving_disk_faults(inj.disk_faults)
    assert surviving == jintegrity.surviving_disk_faults(inj.disk_faults)
    assert surviving, f"seed {seed}: every fault healed"
    rows, ok = integrity.scrub_paths([tmp_path / "t"])
    flagged = {r.path for r in rows if r.corrupt or r.status == "orphan"}
    assert not surviving - flagged
    if surviving & {r.path for r in rows if r.corrupt}:
        assert not ok


@pytest.mark.parametrize("fault", ["disk_corrupt", "torn_write"])
def test_post_publish_rot_mangles_the_bytes_jax_does(tmp_path, fault):
    data = bytes(range(256)) * 40 + b"tail"
    for pkg, mod in (("t", chaos), ("j", jchaos)):
        (tmp_path / pkg).write_bytes(data)
        mod.INJECTOR = mod.ChaosInjector(
            mod.ChaosSpec.parse(f"{fault}=1.0"), 1)
    integrity.chaos_post_publish("disk.chain", tmp_path / "t")
    jintegrity.chaos_post_publish("disk.chain", tmp_path / "j")
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert (tmp_path / "t").read_bytes() != data
    (entry,) = chaos.get().disk_faults
    (jentry,) = jchaos.get().disk_faults
    assert entry[:2] == jentry[:2] and entry[3] == jentry[3]


def test_enospc_before_a_write_lands_nothing(tmp_path):
    chaos.INJECTOR = chaos.ChaosInjector(chaos.ChaosSpec.parse("enospc=1.0"),
                                         1)
    with pytest.raises(OSError) as err:
        snapshot.fsync_write_npz(tmp_path / "x.npz", {"a": np.zeros(3)})
    import errno
    assert err.value.errno == errno.ENOSPC
    assert not list(tmp_path.iterdir())
    with pytest.raises(OSError):
        snapshot.write_manifest_atomic(tmp_path, {"base": "b"})
    assert not list(tmp_path.iterdir())


def test_enospc_skips_the_backoff_ladder_and_is_counted(tmp_path):
    t = obs.enable(Config(metrics_port=-1))
    roster, frames = generate_frames(8192, 1024, roster_size=3000,
                                     num_lectures=4, seed=61)
    frames = list(frames)
    config = Config(bloom_filter_capacity=5000, chaos="enospc=1.0",
                    snapshot_dir=str(tmp_path / "snaps"),
                    snapshot_every_batches=2)
    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(config, client=client, num_banks=4, device="cpu")
    try:
        pipe.preload(roster)
        producer = client.create_producer(config.pulsar_topic)
        for f in frames[:2]:
            producer.send(f)
        pipe.run(max_events=2048, idle_timeout_s=0.3)
        pipe._checkpoint_async(force=True)
        pipe._flush_snapshots()
        # One ENOSPC jumps straight to the capped cadence.
        assert pipe._snap_fail_streak >= 8
        assert pipe._writer_backoff_s() == 5.0
        assert soak.counter_total(
            t.registry, "attendance_snapshot_disk_full_total") >= 1
    finally:
        chaos.disable()  # cleanup's own writes must not fail
        pipe._chaos = None
        pipe._snap_fail_streak = 0
        pipe.cleanup()


def test_quarantine_sidecar_digest_and_scrub(tmp_path):
    q = Quarantine(tmp_path / "q")
    q.put(b"poison frame", topic="t", reason="decode")
    (entry,) = list_entries(tmp_path / "q")
    assert entry["sha256"] == integrity.bytes_digest(b"poison frame")
    assert integrity.scrub_paths([tmp_path / "q"])[1]
    _flip_mid_byte(Path(entry["frame"]))
    assert not integrity.scrub_paths([tmp_path / "q"])[1]


def test_count_corrupt_feeds_the_registry():
    before = integrity.corrupt_counts["digest_mismatch"]
    integrity.count_corrupt("digest_mismatch")  # telemetry off: a count
    t = obs.enable(Config(metrics_port=-1))
    integrity.count_corrupt("digest_mismatch")
    assert integrity.corrupt_counts["digest_mismatch"] == before + 2
    assert soak.counter_total(
        t.registry, "attendance_chain_corrupt_files_total") == 1
