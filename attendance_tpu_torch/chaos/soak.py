"""Chaos soak: producer -> socket broker -> fused pipeline under a seeded
fault schedule, judged against a run of the same frames with no faults.

Counterpart of ``run_soak`` in the JAX package's ``tools/chaos_soak.py``.
One soak:

1. the **no-fault run**: a memory broker, no injector, the frame backlog
   once; its per-day PFCOUNTs, deduplicated rows, valid rows, filter
   words and per-day register rows are the ground truth;
2. the **fault run**: the same backlog plus :data:`POISON_FRAMES`
   undecodable frames mid-backlog, published through the chaos-wrapped
   client into an in-process :class:`BrokerServer`, consumed by a
   checkpointing, audited pipeline with a spill directory and a
   quarantine, the whole fault plane armed from ``spec`` and ``seed``;
3. the gates (each failure is one line of ``report["failures"]``):

   * the run ends inside ``max_seconds`` and raises nothing;
   * its state equals the no-fault run's exactly;
   * the full-shadow audit counted no Bloom false negative, and its
     sampled roster (every roster key the stream carried) probes present
     in the pipeline's filter;
   * with ``conn_reset`` injected the transport reconnected; with
     ``persist_fail`` injected the circuit opened, ended closed, and no
     spilled batch is left;
   * every quarantined frame is a poison frame (or its ``corrupt``
     variant) and every poison frame reached the quarantine;
   * with disk rot injected, ``scrub`` flags (CORRUPT or orphan) every
     path whose rot survives on disk; with ``enospc`` injected the
     disk-full counter fired; with ``partition`` armed a window opened;
   * with ``restore_check``, a fresh pipeline restored from the fault
     run's chain, through the repair ladder (its peer rung: the fault run
     gossips as federated worker ``w0`` to an aggregator), then draining
     the frames the fault run left unacked, equals the no-fault state;

4. the ``doctor`` replay of the fault run's own telemetry: one last SLO
   tick, the reporter's last exposition block, then
   ``obs.slo.doctor_report`` over the prom file and the alert log, with
   the quarantine listed, must pass (``report["doctor_ok"]``).

``wire="columnar"`` ships the same events as COLW frames, with one more
poison frame: a COLW frame whose checksum no longer matches its body,
which must dead-letter and never fold.

Two crash soaks, counterparts of the JAX tool's ``--spec shm`` and
``--spec temporal``, SIGKILL a worker process (``python -m
attendance_tpu_torch.chaos.soak --shm-worker|--temporal-worker``, on
``cuda:0`` unless given ``--device cpu``) once its chain holds a delta,
restore in this process and drain:

* :func:`run_shm_soak`: a publisher thread fills the mmap ring with
  ``torn_slot`` and ``writer_stall`` armed at its publish seam; the
  resume re-attaches the ring, whose durable cursor must hold an unacked
  tail; the state must equal the no-fault run's, both faults fired;
* :func:`run_temporal_soak`: a disordered, ordered-clock stream with a
  super-late tail through a delta-checkpointing temporal pipeline on an
  in-process socket broker; the restored run's window estimates, day
  counts, rows and valid totals must equal the no-crash oracle's, the
  tail must be dropped as late, buckets must have rotated, and
  ``doctor`` must pass with a watermark-lag ceiling.

Run one from the shell: ``python -m attendance_tpu_torch.chaos.soak
--spec shm|temporal|rot|default [--wire columnar] [--device cpu]`` (the
JAX tool's sizes and seed by default).

The injector and the telemetry are process-global: the soak disables
both before it starts and in a ``finally``, so a later run finds
neither. Every wait on another thread or process waits for its
condition until a deadline.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.chaos import ChaosInjector, ChaosSpec
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.federation.gossip import Aggregator
from attendance_tpu_torch.federation.worker import final_full_frame
from attendance_tpu_torch.models.bloom import (
    bloom_contains_packed, keys_tensor)
from attendance_tpu_torch.obs.slo import doctor_report
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline.fast_path import (
    CHAIN_MANIFEST, FusedPipeline)
from attendance_tpu_torch.pipeline.codec import encode_columnar_batch
from attendance_tpu_torch.pipeline.events import decode_planar_batch
from attendance_tpu_torch.pipeline.loadgen import (
    frame_from_columns, generate_frames)
from attendance_tpu_torch.transport import make_client
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.transport.quarantine import list_entries
from attendance_tpu_torch.transport.shm_ring import ShmClient, ring_path
from attendance_tpu_torch.transport.socket_broker import (
    BrokerServer, SocketClient)
from attendance_tpu_torch.utils import integrity

# The JAX soak's specs, unchanged: the transport, sink and writer faults;
# and the storage-rot + partition spec (persist_fail off: rot inside the
# spill is detectable but lossy by contract).
DEFAULT_SPEC = ("drop=0.03,delay=2ms:0.03,dup=0.02,conn_reset=0.03,"
                "persist_fail=0.15,writer_stall=30ms:0.1,"
                "snap_fail=0.1,corrupt=0.02")
ROT_SPEC = ("drop=0.02,dup=0.02,conn_reset=0.02,corrupt=0.02,"
            "snap_fail=0.05,writer_stall=20ms:0.05,"
            "disk_corrupt=0.08,torn_write=0.04,enospc=0.02,"
            "partition=600ms:0.05")
# Every durable chain write (base, delta, manifest) rotted after its
# fsync: whatever the run's length, the last base, the deltas after it
# and the last manifest are rotted when it ends, so scrub's gate and the
# restore's repair ladder always have rot to find. (Under ROT_SPEC a
# later base or manifest heals earlier rot, and whether any survives
# the run depends on where the writer's last base falls.)
SCRUB_SPEC = "disk_corrupt=1.0"
POISON_FRAMES = 2
DATA_SEED_BASE = 7_000  # frame-content seed space, disjoint per soak seed
# The JAX soak's crash specs: torn slots and a stalled writer at the mmap
# ring's publish seam; snapshot-writer faults only under the temporal
# plane (a transport fault that reorders delivery would displace events
# past any fixed lateness), with the tool's period, lateness and
# super-late tail.
SHM_SPEC = "torn_slot=0.08,writer_stall=15ms:0.05"
TEMPORAL_SPEC = "snap_fail=0.05,writer_stall=20ms:0.05"
TEMPORAL_PERIOD_S = 4.0
TEMPORAL_LATENESS_S = 8.0
TEMPORAL_RING_BANKS = 128
TEMPORAL_TAIL = 64
# The JAX tool's seed, stream, filter capacity and shm ring.
TOOL_SEED = 1
TOOL_SHAPE = dict(num_events=32_768, batch=512, roster_size=10_000,
                  lectures=8)
TOOL_CAPACITY = 50_000
SHM_SLOTS, SHM_SLOT_BYTES = 16, 1 << 15
WIRES = ("binary", "columnar")
# The rotted COLW poison frame's event times (10**15 us on: 2001), which
# no soak stream carries: a stored row at one means the frame folded.
ROTTED_MICROS = 10 ** 15
REPO = Path(__file__).resolve().parents[2]
SOAK_MODULE = "attendance_tpu_torch.chaos.soak"  # the workers' entry point
GOSSIP_TOPIC = "soak-fed-gossip"
# One fixed seed per spec, chosen so that each fault a gate reads fires
# early in its stream (:func:`first_hit`). ``GATED`` names those faults
# as (site, fault, hits in a row, draws): a soak of 128 frames or more
# makes at least that many draws at the site (an insert and a receive
# per frame, a chain write per barrier), so the fault fires in it:
# DEFAULT_SPEC's persist_fail twice in a row (the circuit opens) and its
# conn_reset; ROT_SPEC's enospc at the first chain write, its torn_write
# at the first manifest write and its partition at the first receive;
# SCRUB_SPEC's rot at every write.
SEEDS = {"DEFAULT_SPEC": 101, "ROT_SPEC": 389, "SCRUB_SPEC": 389}
GATED = {"DEFAULT_SPEC": (("persist.insert", "persist_fail", 2, 128),
                          ("socket.consume", "conn_reset", 1, 128)),
         "ROT_SPEC": (("disk.chain", "enospc", 1, 1),
                      ("disk.manifest", "torn_write", 1, 1),
                      ("transport.consume", "partition", 1, 128)),
         "SCRUB_SPEC": (("disk.chain", "disk_corrupt", 1, 1),
                        ("disk.manifest", "disk_corrupt", 1, 1))}


def first_hit(spec: str, seed: int, site: str, fault: str, run: int = 1,
              draws: int = 1024) -> Optional[int]:
    """The index of the draw at (``site``, ``fault``) that completes the
    stream's first ``run`` hits in a row under ``spec`` and ``seed``
    (None within ``draws``). The stream is the injector's own: a pure
    function of the seed, whatever the threads interleave. A hit's
    uncounted ``coin`` draws come after it and never move the first."""
    inj = ChaosInjector(ChaosSpec.parse(spec), seed)
    p = getattr(inj.spec, fault)
    rng = inj._rng(site, fault)
    streak = 0
    for i in range(draws):
        streak = streak + 1 if rng.random() < p else 0
        if streak == run:
            return i
    return None


def soak_frames(seed: int, num_events: int, batch: int, roster_size: int,
                lectures: int, wire: str = "binary"):
    """(roster, frames) of a soak seed: the loadgen's planar frames, 10%
    invalid, from ``DATA_SEED_BASE + seed``; on the columnar wire each
    re-encoded as a COLW frame (the JAX soak's bytes on either wire)."""
    roster, frames = generate_frames(
        num_events, batch, roster_size=roster_size, num_lectures=lectures,
        invalid_fraction=0.1, seed=DATA_SEED_BASE + seed)
    if wire == "columnar":
        return roster, [encode_columnar_batch(decode_planar_batch(f))
                        for f in frames]
    return roster, list(frames)


def poison_frames(seed: int, wire: str = "binary") -> List[bytes]:
    """Undecodable frames, the same bytes as the JAX soak's: a bad magic
    and, on the columnar wire, a 64-event COLW frame whose byte
    ``len // 2`` is XORed with 0x55 (its checksum no longer matches)."""
    rng = np.random.default_rng(900_000 + seed)
    frames = [b"ATPX" + rng.bytes(64 + 32 * i) for i in range(POISON_FRAMES)]
    if wire == "columnar":
        rotted = bytearray(encode_columnar_batch({
            "student_id": rng.integers(10_000, 20_000, 64, dtype=np.uint32),
            "lecture_day": np.full(64, 20_260_701, np.uint32),
            "micros": np.arange(64, dtype=np.int64) + ROTTED_MICROS,
            "is_valid": np.ones(64, bool),
            "event_type": np.zeros(64, np.int8)}))
        rotted[len(rotted) // 2] ^= 0x55
        frames.append(bytes(rotted))
    return frames


def sketch_state(pipe) -> Dict:
    """What the soak compares: per-day PFCOUNTs, deduplicated rows,
    valid rows, the filter words and each day's register row. (The
    device counters are plain sums and count duplicates: not compared.)"""
    days = sorted(int(d) for d in pipe.lecture_days())
    cols = pipe.store.to_columns()
    return {
        "counts": {d: pipe.count(d) for d in days},
        "rows": int(len(cols["student_id"])),
        "valid": int(np.asarray(cols["is_valid"]).sum()),
        "bloom": pipe.state.bloom_bits.cpu().numpy(),
        "regs": {d: pipe.state.hll_regs[pipe._bank_of[d]].cpu().numpy()
                 for d in days},
    }


def state_diff(got: Dict, want: Dict) -> List[str]:
    """The keys on which two :func:`sketch_state` dicts differ."""
    out = [k for k in ("counts", "rows", "valid") if got[k] != want[k]]
    if not np.array_equal(got["bloom"], want["bloom"]):
        out.append("bloom")
    if (got["regs"].keys() != want["regs"].keys()
            or any(not np.array_equal(got["regs"][d], want["regs"][d])
                   for d in want["regs"])):
        out.append("regs")
    return out


def summary(state: Dict) -> Dict:
    """A printable digest of a :func:`sketch_state` dict."""
    return {"days": len(state["counts"]), "pfcounts": sum(
        state["counts"].values()), "rows": state["rows"],
        "valid": state["valid"],
        "bloom_sha256": hashlib.sha256(state["bloom"].tobytes()).hexdigest(),
        "regs_sha256": hashlib.sha256(b"".join(
            state["regs"][d].tobytes() for d in sorted(state["regs"]))
        ).hexdigest()}


def counter_total(registry, name: str) -> float:
    """Sum of every series of one metric."""
    return sum(float(m.value) for fam, _k, _h, members in registry.collect()
               if fam == name for m in members)


def no_fault_state(seed: int, *, device, num_events: int, batch: int,
                   roster_size: int, lectures: int,
                   capacity: Optional[int] = None,
                   wire: str = "binary") -> Dict:
    """The ground truth: the backlog once through a memory broker with
    no injector."""
    chaos.disable()
    client = MemoryClient(MemoryBroker())
    cap = capacity or Config().bloom_filter_capacity
    pipe = FusedPipeline(
        Config(bloom_filter_capacity=cap, transport_backend="memory"),
        client=client, num_banks=lectures, device=device)
    try:
        roster, frames = soak_frames(seed, num_events, batch, roster_size,
                                     lectures, wire)
        pipe.preload(roster)
        producer = client.create_producer(pipe.config.pulsar_topic)
        for frame in frames:
            producer.send(frame)
        pipe.run(max_events=num_events, idle_timeout_s=2.0)
        return sketch_state(pipe)
    finally:
        pipe.cleanup()


def _wait_thread(fn, timeout_s: float):
    """Run ``fn`` on a thread; -> (finished inside the deadline, the
    exception it raised or None)."""
    done = threading.Event()
    errors: list = []

    def body():
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 — reported, not hung
            errors.append(exc)
        finally:
            done.set()

    threading.Thread(target=body, name="soak-pipeline", daemon=True).start()
    finished = done.wait(timeout=timeout_s)
    return finished, (errors[0] if errors else None)


def _drain_aggregator(agg, quiet_s: float = 1.0,
                      deadline_s: float = 30.0) -> None:
    """Poll until no gossip frame arrived for ``quiet_s`` (or the
    deadline)."""
    deadline = time.monotonic() + deadline_s
    quiet_since = time.monotonic()
    while time.monotonic() < deadline:
        if agg.poll(timeout_ms=200):
            quiet_since = time.monotonic()
        elif time.monotonic() - quiet_since > quiet_s:
            return


def run_soak(seed: int, *, spec: str = DEFAULT_SPEC, workdir, device,
             num_events: int, batch: int, roster_size: int, lectures: int,
             capacity: Optional[int] = None, max_seconds: float = 120.0,
             idle_s: Optional[float] = None, restore_check: bool = False,
             want: Optional[Dict] = None, wire: str = "binary") -> Dict:
    """One seeded soak on ``device``; returns the report (``report["ok"]``
    is the verdict, ``report["failures"]`` its reasons). ``want`` is the
    no-fault state when the caller already has it. ``wire="columnar"``
    ships the same events as COLW frames: ``corrupt`` then reaches the
    checksum reject, and the rotted poison frame must dead-letter."""
    failures: List[str] = []

    def check(cond, label):
        if not cond:
            failures.append(label)

    t_start = time.monotonic()
    chaos.disable()
    obs.disable()
    cap = capacity or Config().bloom_filter_capacity
    if want is None:
        want = no_fault_state(seed, device=device, num_events=num_events,
                              batch=batch, roster_size=roster_size,
                              lectures=lectures, capacity=cap, wire=wire)
    work = Path(workdir) / f"seed-{seed}"
    work.mkdir(parents=True, exist_ok=True)
    qdir = work / "quarantine"
    snaps = work / "snaps"
    prom = work / "metrics.prom"
    alerts = work / "alerts.jsonl"
    report: Dict = {"seed": seed, "spec": spec, "wire": wire,
                    "no_fault": summary(want)}
    server = BrokerServer().start()
    agg = pipe = None
    cleaned = False
    fed = (dict(fed_worker="w0", fed_shard=0, fed_shards=1,
                fed_gossip_topic=GOSSIP_TOPIC, fed_heartbeat_s=0)
           if restore_check else {})
    try:
        config = Config(
            bloom_filter_capacity=cap,
            transport_backend="socket", socket_broker=server.address,
            chaos=spec, chaos_seed=seed, quarantine_dir=str(qdir),
            persist_spill_dir=str(work / "spill"),
            persist_breaker_failures=2, persist_breaker_cooldown_s=0.25,
            snapshot_dir=str(snaps), snapshot_mode="delta",
            snapshot_every_batches=4, max_redeliveries=3,
            retry_budget_s=10.0, audit_sample=1.0,
            metrics_prom=str(prom), alert_log=str(alerts),
            metrics_interval_s=0.2, **fed)
        # Telemetry from this thread, before any client exists (broker
        # queues register their gauges); the run thread only records.
        t = obs.enable(config)
        inj = chaos.ensure(config)
        if restore_check:
            # The peer of the repair ladder: it folds w0's gossip off the
            # broker directly, outside the fault plane.
            agg = Aggregator(client=MemoryClient(server.broker),
                             topic=GOSSIP_TOPIC, num_shards=1,
                             dead_after_s=600.0)
        pipe = FusedPipeline(config, num_banks=lectures, device=device)
        roster, frames = soak_frames(seed, num_events, batch, roster_size,
                                     lectures, wire)
        pipe.preload(roster)
        poisons = poison_frames(seed, wire)
        producer = make_client(config).create_producer(config.pulsar_topic)
        interval = max(1, len(frames) // (POISON_FRAMES + 1))
        remaining = list(poisons)
        for i, frame in enumerate(frames):
            producer.send(frame)
            if remaining and (i + 1) % interval == 0:
                producer.send(remaining.pop(0))  # poison mid-backlog
        for p in remaining:
            producer.send(p)
        # An ENOSPC hit parks the writer at the capped 5 s backoff, and
        # two consecutive disk failures chain two: the idle window must
        # outlast them, or the run ends with a healthy backlog queued.
        if idle_s is None:
            idle_s = 15.0 if inj.spec.enospc > 0 else 3.0
        t_run = time.monotonic()
        finished, error = _wait_thread(
            lambda: pipe.run(idle_timeout_s=idle_s), max_seconds)
        report["run_s"] = time.monotonic() - t_run
        # The launches of the fault run alone (preload and steps), read
        # before the gates' own reads launch anything.
        report["run_launches"] = dict(kernels.launches)
        check(finished, f"bounded termination (pipeline still running at "
                        f"{max_seconds:.0f}s)")
        check(error is None, f"pipeline raised: {error!r}")
        if not (finished and error is None):
            return report
        if restore_check:
            final_full_frame(pipe)
        cleaned = True
        pipe.cleanup()  # drains the spill through the breaker
        got = sketch_state(pipe)
        report["fault_run"] = summary(got)
        report["events"] = pipe.metrics.events
        diff = state_diff(got, want)
        check(not diff, f"fault-run state differs from the no-fault run "
                        f"in {diff}: {summary(got)} != {summary(want)}")

        # Zero Bloom false negatives: one more scrape re-queries the
        # audit shadow's sampled roster (every roster key the stream
        # carried, at sample 1.0), and the same keys probe the filter on
        # the pipeline's device (K4 on the card).
        t.render()
        fn = counter_total(t.registry,
                           "attendance_bloom_false_negatives_total")
        shadow, _ = t.auditor.fused_probe_sets()
        misses = int((~bloom_contains_packed(
            pipe.state.bloom_bits, keys_tensor(shadow, pipe.device),
            pipe.params)).sum()) if len(shadow) else 0
        report["audited_roster_keys"] = len(shadow)
        report["bloom_false_negatives"] = fn + misses
        check(fn == 0 and misses == 0,
              f"bloom false negatives: {fn} at the scrape, {misses} on "
              "the pipeline's filter")
        check(len(shadow) > 0, "the audit shadow holds no roster key")

        # Self-healing, injected against observed.
        report["injected"] = {f"{site}/{fault}": n for (site, fault), n
                              in sorted(inj.injected.items())}
        reconnects = counter_total(t.registry, "attendance_reconnects_total")
        report["reconnects"] = reconnects
        if inj.injected_total("conn_reset"):
            check(reconnects > 0,
                  "conn_reset injected but no reconnect recorded")
        store = pipe.store
        if inj.injected_total("persist_fail"):
            check(store.breaker.opened_total > 0,
                  "persist_fail injected but the circuit never opened")
            check(store.breaker.state == "closed",
                  f"circuit ended {store.breaker.state!r}, not closed")
            check(store.spill_pending == 0,
                  f"{store.spill_pending} spilled batches stranded")
            report["circuit_opened"] = store.breaker.opened_total
            report["spilled"] = store.spilled_total
            report["drained"] = store.drained_total

        # Poison frames: quarantined as received (a delivery that also
        # caught ``corrupt`` lands as its involutive variant), none
        # escaped, and no real frame among them.
        entries = list_entries(qdir)
        report["quarantined"] = len(entries)
        report["dead_lettered"] = pipe.metrics.dead_lettered
        check(pipe.metrics.dead_lettered >= len(poisons),
              f"dead_lettered={pipe.metrics.dead_lettered}, expected >= "
              f"{len(poisons)}")
        per_poison = [{hashlib.sha256(p).hexdigest(), hashlib.sha256(
            ChaosInjector.corrupt_transform(p)).hexdigest()}
            for p in poisons]
        acceptable = set().union(*per_poison)
        digests = [e["sha256"] for e in entries]
        check(all(d in acceptable for d in digests),
              f"a non-poison frame was quarantined: {digests}")
        check(all(any(d in digs for d in digests) for digs in per_poison),
              "a poison frame never reached the quarantine")
        stored = np.asarray(pipe.store.to_columns(deduplicate=False)["micros"])
        check(not ((stored >= ROTTED_MICROS)
                   & (stored < ROTTED_MICROS + 64)).any(),
              "the rotted COLW frame folded as events")

        # Storage rot: scrub accounts for every injection whose rot is
        # still on disk (CORRUPT, or an orphan restore never reads).
        if inj.injected_total("disk_corrupt") \
                or inj.injected_total("torn_write"):
            surviving = integrity.surviving_disk_faults(inj.disk_faults)
            rows, _ok = integrity.scrub_paths([work])
            flagged = {r.path for r in rows
                       if r.corrupt or r.status == "orphan"}
            missed = surviving - flagged
            check(not missed, f"scrub missed injected disk rot: "
                              f"{sorted(missed)}")
            report["disk_faults_injected"] = len(inj.disk_faults)
            report["disk_rot_surviving"] = len(surviving)
            report["scrub_accounted"] = len(surviving & flagged)
            report["scrub_corrupt"] = sum(r.corrupt for r in rows)
        if inj.spec.partition > 0:
            check(inj.injected_total("partition") > 0,
                  "partition armed but no blackhole window opened")
            report["partition_windows"] = inj.injected_total("partition")
        if inj.injected_total("enospc"):
            disk_full = counter_total(t.registry,
                                      "attendance_snapshot_disk_full_total")
            check(disk_full > 0, "enospc injected but the disk-full "
                                 "counter never fired")
            report["enospc_hits"] = disk_full

        # Doctor over the run's own artifacts: the SLOs judged once more,
        # the gauges that judgement set written in a last block.
        t.finalize_slo("soak-end")
        if t._reporter is not None:
            t._reporter._write_block()
        try:
            text, ok = doctor_report([str(prom), str(alerts)],
                                     quarantine_dir=str(qdir))
            report["doctor_ok"] = ok
            check(ok, "doctor verdict FAIL:\n" + text)
        except Exception as exc:  # noqa: BLE001
            check(False, f"doctor raised: {exc!r}")

        if restore_check:
            _restore_gate(report, check, agg, config, want, device,
                          lectures)
        return report
    finally:
        if pipe is not None and not cleaned:
            pipe.cleanup()
        obs.disable()
        chaos.disable()
        if agg is not None:
            agg.stop()
        server.stop()
        report["wall_s"] = time.monotonic() - t_start
        report["failures"] = failures
        report["ok"] = not failures


def _restore_gate(report: Dict, check, agg, config: Config, want: Dict,
                  device, lectures: int) -> None:
    """A fresh pipeline, no faults, restored from the fault run's chain
    through the repair ladder (the aggregator serves the peer rung from
    a thread while the constructor restores), then draining the frames
    the fault run left unacked: equal to the no-fault state."""
    chaos.disable()
    obs.disable()
    _drain_aggregator(agg)
    snaps = Path(config.snapshot_dir)
    quarantined = (len(list((snaps / integrity.QUARANTINE_SUBDIR).glob("*")))
                   if (snaps / integrity.QUARANTINE_SUBDIR).is_dir() else 0)
    rconfig = Config(
        bloom_filter_capacity=config.bloom_filter_capacity,
        transport_backend="socket", socket_broker=config.socket_broker,
        snapshot_dir=config.snapshot_dir, snapshot_mode="delta",
        snapshot_every_batches=config.snapshot_every_batches,
        max_redeliveries=config.max_redeliveries, fed_worker="w0",
        fed_shard=0, fed_shards=1, fed_gossip_topic=GOSSIP_TOPIC,
        fed_heartbeat_s=0)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            agg.poll(timeout_ms=100)

    server = threading.Thread(target=serve, name="soak-aggregator",
                              daemon=True)
    server.start()
    t0 = time.monotonic()
    try:
        pipe = FusedPipeline(rconfig, num_banks=lectures, device=device)
    finally:
        stop.set()
        server.join(timeout=5)
    try:
        report["restore_s"] = time.monotonic() - t0
        report["events_restored"] = pipe._events_restored
        report["chain_files_quarantined"] = (
            len(list((snaps / integrity.QUARANTINE_SUBDIR).glob("*")))
            - quarantined if (snaps / integrity.QUARANTINE_SUBDIR).is_dir()
            else 0)
        check(pipe._events_restored > 0, "the restore found no chain")
        pipe.run(idle_timeout_s=2.0)
        report["restore_drained_events"] = pipe.metrics.events
    finally:
        pipe.cleanup()
    got = sketch_state(pipe)
    report["restored"] = summary(got)
    diff = state_diff(got, want)
    check(not diff, f"restored state differs from the no-fault run in "
                    f"{diff}: {summary(got)} != {summary(want)}")
    check((snaps / CHAIN_MANIFEST).exists(),
          "the restore left no chain manifest")



# -- the crash soaks: a worker process SIGKILLed mid-stream ------------------

def launches_since(before: Dict) -> Dict:
    """The kernel launches counted since ``before`` (a copy of
    ``kernels.launches``), the kernels that launched."""
    return {k: v - before.get(k, 0) for k, v in kernels.launches.items()
            if v - before.get(k, 0)}


def _device_arg(device) -> str:
    return "cpu" if str(device) == "cpu" else "cuda:0"


def spawn_worker(module: str, args: List[str], device) -> subprocess.Popen:
    """``python -m module args`` in a process of its own, on ``device``'s
    kind (the card, ``cuda:0``, unless ``device`` is the CPU), with the
    checkout on its path and its standard output piped."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    return subprocess.Popen(
        [sys.executable, "-m", module, *args, "--device",
         _device_arg(device)],
        stdout=subprocess.PIPE, text=True, cwd=str(REPO), env=env)


def _shape_args(num_events, batch, roster_size, lectures, capacity,
                seed) -> List[str]:
    return ["--num-events", str(num_events), "--batch", str(batch),
            "--roster-size", str(roster_size), "--lectures", str(lectures),
            "--capacity", str(capacity), "--seed", str(seed)]


def await_ready(worker: subprocess.Popen, timeout_s: float) -> bool:
    """True once the worker printed ``worker ready`` (its preload done),
    False if it exited or stayed silent past the deadline."""
    box: list = []
    reader = threading.Thread(
        target=lambda: box.append(worker.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout_s)
    return bool(box) and box[0].strip() == "worker ready"


def kill_at_first_delta(worker: subprocess.Popen, snap_dir: Path,
                        timeout_s: float, what: str) -> Optional[str]:
    """SIGKILL ``worker`` the moment its chain manifest lists a delta:
    mid-stream by construction, as acks lag the barriers. -> None, or
    the failure line."""
    chain = Path(snap_dir) / CHAIN_MANIFEST
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if json.loads(chain.read_text()).get("deltas"):
                worker.send_signal(signal.SIGKILL)
                worker.wait()
                return None
        except (FileNotFoundError, ValueError):
            pass
        if worker.poll() is not None:
            return f"{what} worker exited before the kill"
        time.sleep(0.02)
    return "no delta snapshot within the deadline"


def reap(worker: Optional[subprocess.Popen]) -> None:
    if worker is not None and worker.poll() is None:
        worker.kill()
        worker.wait()


def _shm_config(shm_dir, snap_dir, capacity: int, slots: int,
                slot_bytes: int, **kw) -> Config:
    return Config(bloom_filter_capacity=capacity, ingress_wire="shm",
                  shm_dir=str(shm_dir), shm_slots=slots,
                  shm_slot_bytes=slot_bytes, snapshot_dir=str(snap_dir),
                  snapshot_mode="delta", snapshot_every_batches=4,
                  **kw)


def run_shm_soak(seed: int, *, workdir, device, num_events: int, batch: int,
                 roster_size: int, lectures: int,
                 capacity: Optional[int] = None, shm_slots: int = SHM_SLOTS,
                 shm_slot_bytes: int = SHM_SLOT_BYTES,
                 max_seconds: float = 120.0, idle_s: float = 3.0,
                 want: Optional[Dict] = None) -> Dict:
    """The shm-transport soak: a publisher thread, ``torn_slot`` and
    ``writer_stall`` armed at the ring's publish seam, feeds a consumer
    process that is SIGKILLed once its chain holds a delta; the resume
    restores the chain in this process and re-attaches the ring, whose
    durable cursor must redeliver an unacked tail; the drained state must
    equal the no-fault run's. ``idle_s`` ends the resumed run once the
    ring stays empty that long. Returns the report (``ok``,
    ``failures``)."""
    failures: List[str] = []

    def check(cond, label):
        if not cond:
            failures.append(label)

    t_start = time.monotonic()
    chaos.disable()
    obs.disable()
    cap = capacity or Config().bloom_filter_capacity
    shape = dict(num_events=num_events, batch=batch,
                 roster_size=roster_size, lectures=lectures)
    report: Dict = {"seed": seed, "spec": SHM_SPEC, "events": num_events}
    if want is None:
        before = dict(kernels.launches)
        want = no_fault_state(seed, device=device, capacity=cap, **shape)
        report["oracle_launches"] = launches_since(before)
    report["no_fault"] = summary(want)
    work = Path(workdir) / f"shm-seed-{seed}"
    work.mkdir(parents=True, exist_ok=True)
    shm_dir, snap = work / "rings", work / "snaps"
    config = _shm_config(shm_dir, snap, cap, shm_slots, shm_slot_bytes,
                         chaos=SHM_SPEC, chaos_seed=seed)
    inj = chaos.ensure(config)
    _roster, frames = soak_frames(seed, **shape)
    client = ShmClient.from_config(config)
    producer = client.create_producer(config.pulsar_topic)
    worker = pipe = None
    try:
        worker = spawn_worker(SOAK_MODULE, [
            "--shm-worker", "--shm-dir", str(shm_dir),
            "--snapshot-dir", str(snap),
            "--shm-slots", str(shm_slots),
            "--shm-slot-bytes", str(shm_slot_bytes),
            *_shape_args(num_events, batch, roster_size, lectures, cap,
                         seed)], device)
        if not await_ready(worker, max_seconds):
            check(False, "shm worker failed to start")
            return report
        # Publish with the fault plane armed; the ring's backpressure
        # paces the publisher against the consumer, and holds it while
        # the consumer is dead (bounded by the send timeout).
        pub_done = threading.Event()
        pub_errors: list = []

        def publish():
            try:
                for f in frames:
                    producer.send(f, timeout_s=max_seconds)
            except BaseException as exc:  # noqa: BLE001 — reported
                pub_errors.append(exc)
            finally:
                pub_done.set()

        threading.Thread(target=publish, name="soak-shm-publisher",
                         daemon=True).start()
        t_kill = time.monotonic()
        err = kill_at_first_delta(worker, snap, max_seconds, "shm")
        if err:
            check(False, err)
            return report
        report["kill_after_s"] = time.monotonic() - t_kill
        # Resume in this process: restore the chain, re-attach the ring;
        # the durable cursor redelivers exactly the unacked tail.
        check(ring_path(shm_dir, config.pulsar_topic, 0).exists(),
              "ring file vanished")
        before = dict(kernels.launches)
        t_resume = time.monotonic()
        pipe = FusedPipeline(config, num_banks=lectures, device=device)
        report["killed_at_events"] = int(sum(pipe.validity_counts()))
        backlog = pipe.consumer.backlog()
        report["resume_backlog"] = backlog
        check(backlog > 0, "no unacked tail to redeliver (the kill landed "
                           "after the drain)")
        pipe.run(idle_timeout_s=idle_s)
        check(pub_done.wait(timeout=max_seconds),
              "publisher never finished (ring stuck full)")
        check(not pub_errors, f"publisher raised: {pub_errors!r}")
        pipe.run(idle_timeout_s=idle_s)  # anything published late
        report["resume_s"] = time.monotonic() - t_resume
        report["restored_frames"] = pipe.metrics.batches
        got = sketch_state(pipe)
        report["restored_launches"] = launches_since(before)
        report["restored"] = summary(got)
        diff = state_diff(got, want)
        check(not diff, f"shm crash and resume differ from the no-fault run "
                        f"in {diff}: {summary(got)} != {summary(want)}")
        report["injected"] = {f"{site}/{fault}": n for (site, fault), n
                              in sorted(inj.injected.items())}
        check(inj.injected_total("torn_slot") > 0,
              "torn_slot armed but never fired")
        check(inj.injected_total("writer_stall") > 0,
              "writer_stall armed but never fired")
        return report
    finally:
        reap(worker)
        if pipe is not None:
            pipe.cleanup()
        client.close()
        chaos.disable()
        obs.disable()
        report["wall_s"] = time.monotonic() - t_start
        report["failures"] = failures
        report["ok"] = not failures


def _shm_worker_main(args) -> None:
    """The half of the shm soak that is SIGKILLed: consume the ring with
    delta checkpoints until the parent kills it."""
    config = _shm_config(args.shm_dir, args.snapshot_dir, args.capacity,
                         args.shm_slots, args.shm_slot_bytes)
    roster, _ = soak_frames(args.seed, args.num_events, args.batch,
                            args.roster_size, args.lectures)
    pipe = FusedPipeline(config, num_banks=args.lectures, device=args.device)
    pipe.preload(roster)
    print("worker ready", flush=True)
    pipe.run(idle_timeout_s=60.0)


def temporal_frames(seed: int, num_events: int, batch: int,
                    roster_size: int, lectures: int):
    """(roster, frames) of the temporal soak, the JAX tool's bytes: an
    ordered-clock stream, 25% of its events up to 2 s late (inside the
    8 s lateness), then a super-late tail frame re-sending the first
    frame's first :data:`TEMPORAL_TAIL` events, which every run must
    drop as late."""
    roster, frames = generate_frames(
        num_events, batch, roster_size=roster_size, num_lectures=lectures,
        invalid_fraction=0.1, seed=DATA_SEED_BASE + seed, disorder_frac=0.25,
        late_max_s=2.0, ordered=True)
    frames = list(frames)
    head = decode_planar_batch(frames[0])
    frames.append(frame_from_columns(
        {k: np.array(v[:TEMPORAL_TAIL]) for k, v in head.items()}))
    return roster, frames


def temporal_config(snap_dir, capacity: int,
                    ring_banks: int = TEMPORAL_RING_BANKS, **kw) -> Config:
    """The temporal soak's pipeline: the tool's period and lateness, a
    ring of ``ring_banks`` buckets (the tool's 128 by default), delta
    snapshots every 4 frames when ``snap_dir`` is given."""
    return Config(
        bloom_filter_capacity=capacity, temporal_period_s=TEMPORAL_PERIOD_S,
        allowed_lateness_s=TEMPORAL_LATENESS_S,
        temporal_ring_banks=ring_banks,
        snapshot_dir=str(snap_dir) if snap_dir else "", snapshot_mode="delta",
        snapshot_every_batches=4, **kw)


def temporal_state(pipe) -> Dict:
    """:func:`sketch_state` and the window estimates,
    ``{str(bucket key): estimate}``."""
    state = sketch_state(pipe)
    state["windows"] = {str(k): v for k, v in pipe.window_counts().items()}
    return state


def _temporal_stats(pipe) -> Dict:
    return {k: v for k, v in pipe.temporal_stats().items() if k != "topk"}


def temporal_oracle(seed: int, *, device, num_events: int, batch: int,
                    roster_size: int, lectures: int,
                    capacity: Optional[int] = None,
                    ring_banks: int = TEMPORAL_RING_BANKS) -> Dict:
    """The no-crash run: the temporal stream once through a memory broker,
    no chain (a chain directory would be restored into the oracle), its
    :func:`temporal_state` and ``state["stats"]``, the plane's counters
    but the top-K."""
    chaos.disable()
    cap = capacity or Config().bloom_filter_capacity
    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(temporal_config(None, cap, ring_banks,
                                         transport_backend="memory"),
                         client=client, num_banks=lectures, device=device)
    try:
        roster, frames = temporal_frames(seed, num_events, batch,
                                         roster_size, lectures)
        pipe.preload(roster)
        producer = client.create_producer(pipe.config.pulsar_topic)
        for frame in frames:
            producer.send(frame)
        pipe.run(max_events=num_events + TEMPORAL_TAIL, idle_timeout_s=2.0)
        state = temporal_state(pipe)
        state["stats"] = _temporal_stats(pipe)
        return state
    finally:
        pipe.cleanup()


def _write_ledger(inj, path: Path) -> None:
    """Keep ``path`` holding the injector's ledger, rewritten by rename
    every 50 ms, so that a parent can read what fired before a SIGKILL."""
    tmp = path.with_suffix(".tmp")
    while True:
        time.sleep(0.05)
        tmp.write_text(json.dumps({f"{site}/{fault}": n for (site, fault), n
                                   in sorted(inj.injected.items())}))
        os.replace(tmp, path)


def _temporal_worker_main(args) -> None:
    """The half of the temporal soak that is SIGKILLed: consume the socket
    broker with delta checkpoints and the temporal plane, the writer's
    faults armed, until the parent kills it."""
    config = temporal_config(
        args.snapshot_dir, args.capacity, args.ring_banks,
        transport_backend="socket", socket_broker=args.broker,
        chaos=TEMPORAL_SPEC, chaos_seed=args.seed)
    inj = chaos.ensure(config)
    threading.Thread(target=_write_ledger, args=(inj, Path(args.ledger)),
                     name="soak-ledger", daemon=True).start()
    roster, _ = temporal_frames(args.seed, args.num_events, args.batch,
                                args.roster_size, args.lectures)
    pipe = FusedPipeline(config, num_banks=args.lectures, device=args.device)
    pipe.preload(roster)
    print("worker ready", flush=True)
    pipe.run(idle_timeout_s=60.0)


def run_temporal_soak(seed: int, *, workdir, device, num_events: int,
                      batch: int, roster_size: int, lectures: int,
                      capacity: Optional[int] = None,
                      ring_banks: int = TEMPORAL_RING_BANKS,
                      max_seconds: float = 120.0, idle_s: float = 3.0,
                      want: Optional[Dict] = None) -> Dict:
    """The temporal soak: the disordered stream published to an in-process
    socket broker, a delta-checkpointing temporal worker process SIGKILLed
    once its chain holds a delta (mid-window), restored in this process
    and drained. Gates: the window estimates equal the no-crash oracle's
    exactly; the day counts, rows and valid totals too; the super-late
    tail dropped as late in both; rotations and buckets; ``doctor`` over
    the restored run's prom file with a watermark-lag ceiling of
    4 x the lateness. ``idle_s`` ends the restored run once the broker
    stays empty that long. The restore re-opens every bucket of the chain
    (the watermark restarts from the redelivered stream, as in the JAX
    package), so a ring the stream fills over-commits after it and keeps
    rotated buckets the no-crash run evicted: ``ring_banks`` must hold
    every bucket of the stream for the windows to compare. Returns the
    report (``ok``, ``failures``)."""
    failures: List[str] = []

    def check(cond, label):
        if not cond:
            failures.append(label)

    t_start = time.monotonic()
    chaos.disable()
    obs.disable()
    cap = capacity or Config().bloom_filter_capacity
    shape = dict(num_events=num_events, batch=batch,
                 roster_size=roster_size, lectures=lectures)
    report: Dict = {"seed": seed, "spec": TEMPORAL_SPEC,
                    "events": num_events}
    if want is None:
        before = dict(kernels.launches)
        want = temporal_oracle(seed, device=device, capacity=cap,
                               ring_banks=ring_banks, **shape)
        report["oracle_launches"] = launches_since(before)
    report["no_fault"] = summary(want)
    work = Path(workdir) / f"temporal-seed-{seed}"
    work.mkdir(parents=True, exist_ok=True)
    snap, prom, ledger = (work / "snaps", work / "metrics.prom",
                          work / "worker-faults.json")
    server = BrokerServer().start()
    pub_client = SocketClient(server.address)
    worker = pipe = None
    try:
        _roster, frames = temporal_frames(seed, **shape)
        producer = pub_client.create_producer(Config().pulsar_topic)
        for frame in frames:
            producer.send(frame)
        worker = spawn_worker(SOAK_MODULE, [
            "--temporal-worker", "--broker", server.address,
            "--snapshot-dir", str(snap),
            "--ledger", str(ledger), "--ring-banks", str(ring_banks),
            *_shape_args(num_events, batch, roster_size, lectures, cap,
                         seed)], device)
        if not await_ready(worker, max_seconds):
            check(False, "temporal worker failed to start")
            return report
        t_kill = time.monotonic()
        err = kill_at_first_delta(worker, snap, max_seconds, "temporal")
        if err:
            check(False, err)
            return report
        report["kill_after_s"] = time.monotonic() - t_kill
        report["injected"] = (json.loads(ledger.read_text())
                              if ledger.exists() else {})
        # The chain as the killed worker left it, before the restore
        # writes on: what another restore (or package) can be held to.
        report["chain_at_kill"] = str(shutil.copytree(
            snap, work / "chain-at-kill"))
        # Restore in this process: the chain re-seeds the bucket ring, the
        # broker's takeover redelivers the unacked tail (its event-time
        # displacement inside the lateness), and the stream drains to the
        # end, the super-late tail included.
        config = temporal_config(
            snap, cap, ring_banks, transport_backend="socket",
            socket_broker=server.address, metrics_prom=str(prom),
            metrics_interval_s=0.2)
        t = obs.enable(config)
        before = dict(kernels.launches)
        t_resume = time.monotonic()
        pipe = FusedPipeline(config, num_banks=lectures, device=device)
        report["killed_at_events"] = int(sum(pipe.validity_counts()))
        backlog = pipe.consumer.backlog()
        report["resume_backlog"] = backlog
        check(backlog > 0, "no unacked tail to redeliver (the kill landed "
                           "after the drain)")
        pipe.run(idle_timeout_s=idle_s)
        report["resume_s"] = time.monotonic() - t_resume
        report["restored_frames"] = pipe.metrics.batches
        got = temporal_state(pipe)
        stats = _temporal_stats(pipe)
        report["restored_launches"] = launches_since(before)
        report["restored"] = summary(got)
        report["windows"] = len(got["windows"])
        report["stats"] = stats
        report["oracle_stats"] = want["stats"]
        check(got["windows"] == want["windows"],
              "restored window estimates differ from the no-crash oracle's: "
              f"{got['windows']} != {want['windows']}")
        check(got["counts"] == want["counts"],
              f"day counts differ: {got['counts']} != {want['counts']}")
        check(got["rows"] == want["rows"] and got["valid"] == want["valid"],
              f"store rows/valid differ: {got['rows']}/{got['valid']} != "
              f"{want['rows']}/{want['valid']}")
        check(want["stats"]["late_dropped"] >= TEMPORAL_TAIL,
              "the oracle never dropped the super-late tail")
        check(stats["late_dropped"] >= TEMPORAL_TAIL,
              f"late-dropped counter never fired after the restore "
              f"({stats['late_dropped']})")
        check(stats["rotations"] > 0, "no bucket rotations observed")
        check(stats["buckets"] > 0, "no temporal buckets restored")
        pipe.cleanup()
        pipe = None
        # Doctor over the restored run's own prom file, with the
        # watermark-lag gate (at steady state the lag is the lateness).
        t.finalize_slo("soak-end")
        if t._reporter is not None:
            t._reporter._write_block()
        try:
            text, ok = doctor_report(
                [str(prom)], watermark_lag_ceiling=4 * TEMPORAL_LATENESS_S)
            report["doctor_ok"] = ok
            check(ok, "doctor verdict FAIL:\n" + text)
        except Exception as exc:  # noqa: BLE001
            check(False, f"doctor raised: {exc!r}")
        return report
    finally:
        reap(worker)
        if pipe is not None:
            pipe.cleanup()
        pub_client.close()
        server.stop()
        obs.disable()
        chaos.disable()
        report["wall_s"] = time.monotonic() - t_start
        report["failures"] = failures
        report["ok"] = not failures


# -- the command line ---------------------------------------------------------

# The JAX tool's ``--spec`` words (any other value is a spec string).
SPEC_WORDS = {"default": DEFAULT_SPEC, "rot": ROT_SPEC, "shm": SHM_SPEC,
              "temporal": TEMPORAL_SPEC}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m attendance_tpu_torch.chaos.soak",
        description="The chaos soaks on the port (counterpart of the JAX "
                    "package's tools/chaos_soak.py).")
    ap.add_argument("--spec", default="default",
                    help="default, rot (storage rot and partitions), shm "
                    "(the ring consumer SIGKILLed and resumed), temporal "
                    "(the temporal worker SIGKILLed and restored), or a "
                    "chaos spec string")
    ap.add_argument("--wire", choices=WIRES, default="binary",
                    help="the fault run's event wire (columnar: COLW "
                    "frames, a rotted one among the poison frames)")
    ap.add_argument("--seed", type=int, default=TOOL_SEED)
    ap.add_argument("--workdir", default="soak-work")
    ap.add_argument("--device", default="cuda:0",
                    help="the pipelines' device (cpu only for tests)")
    ap.add_argument("--max-seconds", type=float, default=120.0)
    ap.add_argument("--num-events", type=int,
                    default=TOOL_SHAPE["num_events"])
    ap.add_argument("--batch", type=int, default=TOOL_SHAPE["batch"])
    ap.add_argument("--roster-size", type=int,
                    default=TOOL_SHAPE["roster_size"])
    ap.add_argument("--lectures", type=int, default=TOOL_SHAPE["lectures"])
    ap.add_argument("--capacity", type=int, default=TOOL_CAPACITY)
    ap.add_argument("--shm-slots", type=int, default=SHM_SLOTS)
    ap.add_argument("--shm-slot-bytes", type=int, default=SHM_SLOT_BYTES)
    ap.add_argument("--ring-banks", type=int, default=TEMPORAL_RING_BANKS,
                    help="the temporal soak's bucket ring")
    # The workers' own entry points, started by the soaks.
    ap.add_argument("--shm-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--temporal-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--shm-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--broker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--snapshot-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--ledger", default="", help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.shm_worker:
        _shm_worker_main(args)
        return 0
    if args.temporal_worker:
        _temporal_worker_main(args)
        return 0
    shape = dict(num_events=args.num_events, batch=args.batch,
                 roster_size=args.roster_size, lectures=args.lectures,
                 capacity=args.capacity)
    common = dict(workdir=args.workdir, device=args.device,
                  max_seconds=args.max_seconds, **shape)
    if args.spec == "shm":
        report = run_shm_soak(args.seed, shm_slots=args.shm_slots,
                              shm_slot_bytes=args.shm_slot_bytes, **common)
    elif args.spec == "temporal":
        report = run_temporal_soak(args.seed, ring_banks=args.ring_banks,
                                   **common)
    else:
        report = run_soak(args.seed, spec=SPEC_WORDS.get(args.spec,
                                                         args.spec),
                          wire=args.wire, restore_check=args.spec == "rot",
                          **common)
    print(json.dumps({k: v for k, v in report.items() if k != "failures"},
                     default=str))
    for line in report["failures"]:
        print(f"FAIL seed={args.seed}: {line}")
    print(f"{'PASS' if report['ok'] else 'FAIL'} spec={args.spec} "
          f"wire={args.wire} seed={args.seed} ({report['wall_s']} s)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
