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

The injector and the telemetry are process-global: the soak disables
both before it starts and in a ``finally``, so a later run finds
neither. Every wait on another thread waits for its condition until a
deadline.
"""

from __future__ import annotations

import hashlib
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
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport import make_client
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.transport.quarantine import list_entries
from attendance_tpu_torch.transport.socket_broker import BrokerServer
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
                lectures: int):
    """(roster, frames) of a soak seed: the loadgen's planar frames, 10%
    invalid, from ``DATA_SEED_BASE + seed``."""
    roster, frames = generate_frames(
        num_events, batch, roster_size=roster_size, num_lectures=lectures,
        invalid_fraction=0.1, seed=DATA_SEED_BASE + seed)
    return roster, list(frames)


def poison_frames(seed: int) -> List[bytes]:
    """Undecodable frames (a bad magic), the same bytes as the JAX
    soak's on the binary wire."""
    rng = np.random.default_rng(900_000 + seed)
    return [b"ATPX" + rng.bytes(64 + 32 * i) for i in range(POISON_FRAMES)]


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
                   capacity: Optional[int] = None) -> Dict:
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
                                     lectures)
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
             want: Optional[Dict] = None) -> Dict:
    """One seeded soak on ``device``; returns the report (``report["ok"]``
    is the verdict, ``report["failures"]`` its reasons). ``want`` is the
    no-fault state when the caller already has it."""
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
                              lectures=lectures, capacity=cap)
    work = Path(workdir) / f"seed-{seed}"
    work.mkdir(parents=True, exist_ok=True)
    qdir = work / "quarantine"
    snaps = work / "snaps"
    prom = work / "metrics.prom"
    alerts = work / "alerts.jsonl"
    report: Dict = {"seed": seed, "spec": spec,
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
                                     lectures)
        pipe.preload(roster)
        poisons = poison_frames(seed)
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

