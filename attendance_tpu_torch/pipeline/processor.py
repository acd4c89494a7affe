"""Micro-batched stream processor: the reference's own loop, rebuilt.

Counterpart of ``attendance_tpu/pipeline/processor.py``. The fault plane and the persist sink's circuit
breaker wrap its store (``storage.wrap_store``). With telemetry on
it records the ``batch_assembly``, ``sketch`` and ``persist`` stages,
events and batches, a flight record a batch and, with tracing, a batch
span with ``bf_exists``, ``persist`` and ``pfadd`` children. With
``--profile-dir`` each run is a ``torch.profiler`` trace (CUDA activity
on the card store's device) whose sketch calls are ``bf_exists_batch``
and ``pfadd_batch`` ranges.
The reference costs three service round trips an event:
``receive()`` -> ``BF.EXISTS`` -> Cassandra INSERT -> ``PFADD`` -> ack.
This processor keeps its observable semantics (validity from the Bloom
filter, the generator's ``is_valid`` flag ignored and recomputed; every
event persisted with its computed validity; only valid events reach the
HLL; ack strictly after all writes; nack the batch on failure, so it is
redelivered) but amortizes them over micro-batches:

  receive() x B -> JSON decode -> ONE batched BF.EXISTS ->
  ONE batched store insert -> ONE batched PFADD per lecture ->
  ack the B messages.

With the card store (``--sketch-backend tpu``) BF.EXISTS is one K8
launch and each PFADD one K5 launch. Replaying a nacked batch is safe
because every sink is idempotent (set to 1, register max, upsert by
primary key).
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.events import (
    AttendanceEvent, decode_event, encode_event)
from attendance_tpu_torch.sketch import make_sketch_store
from attendance_tpu_torch.sketch.base import ResponseError
from attendance_tpu_torch.storage import make_event_store, wrap_store
from attendance_tpu_torch.storage.memory_store import AttendanceRow
from attendance_tpu_torch.transport import (
    PoisonTracker, acknowledge_all, collect_batch, handle_poison,
    make_client, redelivery_count)
from attendance_tpu_torch.utils.profiling import maybe_annotate, maybe_trace
from attendance_tpu_torch.utils.snapshot import (
    fsync_dir, restore_sketch_store, snapshot_sketch_store,
    snapshot_sketch_store_chain)

logger = logging.getLogger(__name__)


@dataclass
class ProcessorMetrics:
    """Per-run counters."""
    batches: int = 0
    events: int = 0
    valid_events: int = 0
    invalid_events: int = 0
    nacked_batches: int = 0
    dead_lettered: int = 0
    # Host wall seconds of the batched BF.EXISTS and PFADD calls (the
    # sketch store's share of the run, device work included).
    device_seconds: float = 0.0
    wall_seconds: float = 0.0
    batch_sizes: List[int] = field(default_factory=list)
    # Frames per host->device wire and checkpoint timings: fused-path
    # fields the JAX metrics line carries; the processor leaves them
    # empty.
    wire_dwell: Dict[str, int] = field(default_factory=dict)
    snapshot_stalls: List[float] = field(default_factory=list)
    snapshot_blocked_s: float = 0.0

    @property
    def events_per_second(self) -> float:
        """0.0 when no wall clock was measured (to_dict and summary
        report null / "n/a" instead)."""
        return self.events / self.wall_seconds if self.wall_seconds else 0.0

    def to_dict(self, estimated_fpr: Optional[float] = None,
                fpr_is_lower_bound: bool = False) -> Dict:
        """Machine-readable form of the metrics line, for the JSON-lines
        sink (config.metrics_json)."""
        return {
            "events": self.events,
            "batches": self.batches,
            # null, not 0.0, when no wall clock was measured: a zero
            # rate reads as a dead run.
            "events_per_second": round(self.events_per_second, 1)
            if self.wall_seconds else None,
            "mean_batch": round(sum(self.batch_sizes)
                                / len(self.batch_sizes), 1)
            if self.batch_sizes else 0.0,
            "device_seconds": round(self.device_seconds, 6),
            "wall_seconds": round(self.wall_seconds, 6),
            "valid_events": self.valid_events,
            "invalid_events": self.invalid_events,
            "nacked_batches": self.nacked_batches,
            "dead_lettered": self.dead_lettered,
            "estimated_fpr": estimated_fpr,
            "fpr_is_lower_bound": fpr_is_lower_bound,
            "wire_dwell": dict(self.wire_dwell),
            "snapshots": len(self.snapshot_stalls),
            "snapshot_write_s": round(sum(self.snapshot_stalls), 4),
            "snapshot_blocked_s": round(self.snapshot_blocked_s, 4),
        }

    def write_json_line(self, path: str, **to_dict_kwargs) -> None:
        """Append one JSON metrics line to ``path``."""
        with open(path, "a") as f:
            f.write(json.dumps(self.to_dict(**to_dict_kwargs)) + "\n")

    def summary(self, estimated_fpr: Optional[float] = None,
                include_validity: bool = True,
                fpr_is_lower_bound: bool = False) -> str:
        """One metrics line: batch size, device time and the FPR
        estimate beside the counters. ``fpr_is_lower_bound`` marks an
        estimate of the blocked layout, whose occupancy formula
        understates the true FPR (the line then prints ">=")."""
        mean_batch = (sum(self.batch_sizes) / len(self.batch_sizes)
                      if self.batch_sizes else 0.0)
        bound = ">= " if fpr_is_lower_bound else ""
        fpr = ("n/a" if estimated_fpr is None
               else f"{bound}{estimated_fpr:.4%}")
        validity = (f"{self.valid_events} valid, "
                    f"{self.invalid_events} invalid"
                    if include_validity
                    else "validity in store (async)")
        wires = ("" if not self.wire_dwell else "; wires " + ",".join(
            f"{k}:{v}" for k, v in sorted(self.wire_dwell.items())))
        rate = (f"{self.events_per_second:.0f}"
                if self.wall_seconds else "n/a")
        return (f"{self.events} events in {self.batches} batches "
                f"({rate} ev/s; mean batch "
                f"{mean_batch:.0f}; device {self.device_seconds:.3f}s; "
                f"est. bloom FPR {fpr}; {validity}, "
                f"{self.nacked_batches} nacked, {self.dead_lettered} "
                f"dead-lettered{wires})")


class AttendanceProcessor:
    """Competing consumer turning event frames into sketch and store
    updates.

    Construction wires the three backends from config (each injectable
    for tests); ``device`` places the card store (default: the CUDA
    card; the other backends ignore it). ``process_attendance`` is the
    long-running entry point, ``process_events`` the testable core.
    """

    SUBSCRIPTION = "attendance_processor"
    SKETCH_SNAPSHOT = "processor_sketch.npz"
    SKETCH_CHAIN = "processor_sketch_chain"
    EVENTS_SNAPSHOT = "processor_events.npz"

    def __init__(self, config: Optional[Config] = None, *,
                 client=None, sketch_store=None, event_store=None,
                 device=None):
        self.config = config or Config()
        # Live telemetry, created before the transport so broker queues
        # register their depth gauges; every handle is None when off.
        self._obs = obs.ensure(self.config)
        self._tracer = (self._obs.tracer if self._obs is not None
                        else None)
        self._h_assembly = self._h_sketch = self._h_persist = None
        if self._obs is not None:
            self._h_assembly = self._obs.stage("batch_assembly")
            self._h_sketch = self._obs.stage("sketch")
            self._h_persist = self._obs.stage("persist")
        # The fault plane before the transport and the store, whose
        # seams take it; one branch each when absent.
        chaos.ensure(self.config)
        self.client = client or make_client(self.config)
        self.consumer = self.client.subscribe(
            self.config.pulsar_topic, self.SUBSCRIPTION)
        self.sketch = sketch_store or make_sketch_store(self.config, device)
        self.store = wrap_store(
            event_store or make_event_store(self.config), self.config,
            sink=self.config.storage_backend)
        self.metrics = ProcessorMetrics()
        # Client-side poison-attempt bound (transport.PoisonTracker).
        self._poison = PoisonTracker()
        # --profile-dir: a torch.profiler trace of each run, with the
        # sketch calls as bf_exists_batch / pfadd_batch ranges.
        self._profiling = bool(self.config.profile_dir)
        # Optional side topic for computed-invalid events (the stored
        # row keeps is_valid=false either way).
        self._invalid_producer = (
            self.client.create_producer(self.config.invalid_topic)
            if self.config.invalid_topic else None)
        # Checkpoint/restore, when snapshot_dir is set: the consume loop
        # then acks only at snapshot barriers, so acknowledged events
        # are always durable. A set dir with no interval still
        # checkpoints (every 64 batches).
        self._snap_dir = (Path(self.config.snapshot_dir)
                          if self.config.snapshot_dir else None)
        self._snap_every = (self.config.snapshot_every_batches
                            if self.config.snapshot_every_batches > 0
                            else 64)
        self._batches_at_snap = 0
        if self._snap_dir is not None:
            self.restore()

    @property
    def checkpointing(self) -> bool:
        return self._snap_dir is not None

    def snapshot(self) -> None:
        """Persist sketch and store state to snapshot_dir (atomic files).
        In delta mode the sketch side appends to a base + delta chain
        (only the keys written since the last barrier)."""
        if self._snap_dir is None:
            return
        self._snap_dir.mkdir(parents=True, exist_ok=True)
        if hasattr(self.sketch, "_blooms"):  # redis keeps its own RDB/AOF
            if self.config.snapshot_mode == "delta":
                snapshot_sketch_store_chain(
                    self.sketch, self._snap_dir / self.SKETCH_CHAIN,
                    compact_every=self.config.snapshot_compact_every)
            else:
                snapshot_sketch_store(
                    self.sketch, self._snap_dir / self.SKETCH_SNAPSHOT)
                # A barrier-mode snapshot supersedes a delta chain an
                # earlier delta-mode run left here: restore prefers the
                # chain, so its manifest would shadow every event acked
                # from now on. The unlink is the durability point, so
                # the directory is fsynced.
                stale = (self._snap_dir / self.SKETCH_CHAIN
                         / "MANIFEST.json")
                if stale.exists():
                    stale.unlink()
                    fsync_dir(stale.parent)
        save = getattr(self.store, "save", None)
        if save is not None:
            save(self._snap_dir / self.EVENTS_SNAPSHOT)
        self._batches_at_snap = self.metrics.batches

    def restore(self) -> bool:
        """Load the latest snapshot from snapshot_dir, if present (the
        delta chain when one exists, else the one-shot npz)."""
        if self._snap_dir is None:
            return False
        restored = False
        chain_dir = self._snap_dir / self.SKETCH_CHAIN
        sketch_path = self._snap_dir / self.SKETCH_SNAPSHOT
        if hasattr(self.sketch, "_blooms"):
            if (chain_dir / "MANIFEST.json").exists():
                restore_sketch_store(self.sketch, chain_dir)
                restored = True
            elif sketch_path.exists():
                restore_sketch_store(self.sketch, sketch_path)
                restored = True
        events_path = self._snap_dir / self.EVENTS_SNAPSHOT
        load = getattr(self.store, "load", None)
        if events_path.exists() and load is not None:
            load(events_path)
            restored = True
        if restored:
            logger.info("Restored processor snapshot from %s",
                        self._snap_dir)
        return restored

    # -- setup --------------------------------------------------------------
    def setup_bloom_filter(self) -> None:
        """The reference's bootstrap: make sure a filter of the
        configured capacity exists before consuming. Probe (for the
        reference's log line), then always attempt the reserve and
        tolerate "item exists": on current Redis semantics the probe of
        a missing key returns 0 instead of raising, so a reserve gated
        on the probe would never run."""
        try:
            probe = self.sketch.execute_command(
                "BF.EXISTS", self.config.bloom_filter_key, "test")
        except ResponseError:  # old-RedisBloom missing-key semantics
            probe = None
        try:
            self.sketch.execute_command(
                "BF.RESERVE", self.config.bloom_filter_key,
                self.config.bloom_filter_error_rate,
                self.config.bloom_filter_capacity)
            logger.info("Created new Bloom Filter")
        except ResponseError as e:
            if "exists" not in str(e):
                raise
            logger.info("Bloom Filter already exists (probe=%s)", probe)

    # -- core batch step ----------------------------------------------------
    def process_events(self, events: List[AttendanceEvent]) -> np.ndarray:
        """Validate, persist, and count one micro-batch; returns the
        computed validity vector (bool[B])."""
        if not events:
            return np.zeros(0, dtype=bool)
        t0 = time.perf_counter()
        student_ids = np.array([e.student_id for e in events],
                               dtype=np.int64)

        # 1. Batched BF.EXISTS: validity is recomputed, the event's
        #    ground-truth flag is ignored.
        with maybe_annotate(self._profiling, "bf_exists_batch"):
            is_valid = np.asarray(self.sketch.bf_exists_many(
                self.config.bloom_filter_key, student_ids))
        d_bf = time.perf_counter() - t0
        self.metrics.device_seconds += d_bf

        # 2. Persist every event with its computed validity (valid and
        #    invalid alike).
        rows = [AttendanceRow(student_id=int(e.student_id),
                              timestamp=e.timestamp,
                              lecture_id=e.lecture_id,
                              is_valid=bool(v),
                              event_type=e.event_type)
                for e, v in zip(events, is_valid)]
        t_persist = time.perf_counter()
        self.store.insert_batch(rows)
        if self._obs is not None:
            self._h_persist.observe(time.perf_counter() - t_persist)

        # 3. Valid events only -> HLL, one PFADD per distinct lecture key.
        t1 = time.perf_counter()
        by_lecture: Dict[str, List[int]] = {}
        for e, v in zip(events, is_valid):
            if v:
                by_lecture.setdefault(e.lecture_id, []).append(e.student_id)
        with maybe_annotate(self._profiling, "pfadd_batch"):
            for lecture_id, members in by_lecture.items():
                self.sketch.pfadd_many(
                    f"{self.config.hll_key_prefix}{lecture_id}",
                    np.array(members, dtype=np.int64))
        d_pf = time.perf_counter() - t1
        self.metrics.device_seconds += d_pf
        if self._obs is not None:
            self._h_sketch.observe(d_bf + d_pf)

        # 4. Optional invalid routing: each computed-invalid event
        #    republished on the side topic in the reference's JSON wire.
        #    At least once like every sink: a batch nacked after this
        #    point republishes on redelivery, so side-topic consumers
        #    dedup by (lecture_id, timestamp, student_id).
        if self._invalid_producer is not None:
            for e, v in zip(events, is_valid):
                if not v:
                    self._invalid_producer.send(encode_event(e))

        nv = int(is_valid.sum())
        self.metrics.batches += 1
        self.metrics.events += len(events)
        self.metrics.valid_events += nv
        self.metrics.invalid_events += len(events) - nv
        self.metrics.batch_sizes.append(len(events))
        if self._obs is not None:
            self._observe_batch(len(events), nv, t0, d_bf, t_persist, t1,
                                d_pf, len(by_lecture))
        return is_valid

    def _observe_batch(self, n: int, nv: int, t0: float, d_bf: float,
                       t_persist: float, t1: float, d_pf: float,
                       lectures: int) -> None:
        """One batch's events, frame count, spans and flight record."""
        self._obs.events.inc(n)
        self._obs.frames.inc()
        rec = dict(ts=round(time.time(), 6), events=n, valid=nv,
                   invalid=n - nv, sketch_s=round(d_bf + d_pf, 6))
        tr = self._tracer
        if tr is not None:
            cur = tr.current()
            tid = cur.trace_id if cur is not None else tr.new_id()
            parent = cur.span_id if cur is not None else None
            role = "processor"
            tr.add_span("bf_exists", t0, t0 + d_bf, trace_id=tid,
                        parent_id=parent, role=role, args={"events": n})
            tr.add_span("persist", t_persist, t1, trace_id=tid,
                        parent_id=parent, role=role)
            tr.add_span("pfadd", t1, t1 + d_pf, trace_id=tid,
                        parent_id=parent, role=role,
                        args={"lectures": lectures})
            rec["trace"] = f"{tid:016x}"
        self._obs.record_batch(**rec)

    # -- streaming loop -----------------------------------------------------
    def _begin_batch_span(self, msg, t_asm: float, t_got: float,
                          n_msgs: int):
        """The batch span: a batch mixes many per-event traces and joins
        the first message's (a redelivered head becomes a ``retry``
        span under its original publish span)."""
        props = (msg.properties() if hasattr(msg, "properties")
                 else None)
        return self._tracer.begin_consume(
            props, redelivery_count(msg), role="processor",
            start=t_asm, got=t_got, wait_name="batch_assembly",
            args={"messages": n_msgs})

    def _consume_loop(self, max_events, idle_timeout_s, idle_since,
                      checkpoint_and_ack, pending_acks) -> None:
        consecutive_failures = 0
        while True:
            t_asm = time.perf_counter()
            msgs = collect_batch(self.consumer, self.config.batch_size,
                                 self.config.batch_timeout_s)
            t_got = time.perf_counter()
            if self._obs is not None:
                self._h_assembly.observe(t_got - t_asm)
            if not msgs:
                if pending_acks:
                    checkpoint_and_ack()
                if (idle_timeout_s is not None and
                        time.monotonic() - idle_since > idle_timeout_s):
                    break
                continue
            idle_since = time.monotonic()
            # Per-frame decode so one poison frame does not poison the
            # batch: an undecodable frame is nacked up to
            # max_redeliveries times, then dead-lettered (acked and
            # counted), where the reference nacks forever.
            good_msgs, events = [], []
            for m in msgs:
                try:
                    events.append(decode_event(m.data()))
                    good_msgs.append(m)
                except Exception:
                    handle_poison(m, self.consumer, self.metrics,
                                  self.config, logger, count_nack=False,
                                  tracker=self._poison)
            span = None
            if self._tracer is not None and good_msgs:
                span = self._begin_batch_span(good_msgs[0], t_asm, t_got,
                                              len(good_msgs))
            try:
                if span is None:
                    self.process_events(events)
                else:
                    with self._tracer.activate(span):
                        self.process_events(events)
                    self._tracer.end_span(span)
                consecutive_failures = 0
            except Exception:
                if span is not None:
                    self._tracer.end_span(span, error=True)
                # Whole-batch nack -> redelivery; the idempotent sinks
                # make the replay safe. Processing failures are usually
                # transient backend faults, so: exponential backoff
                # before the nack and no dead-lettering (well-formed
                # events are never dropped).
                logger.exception("Error processing batch; nacking")
                self.metrics.nacked_batches += 1
                consecutive_failures += 1
                time.sleep(min(0.05 * 2 ** min(consecutive_failures, 6),
                               2.0))
                for m in good_msgs:
                    self.consumer.negative_acknowledge(m)
                continue
            # Ack strictly after the sketch and store writes; when
            # checkpointing, hold the acks until the snapshot barrier so
            # acknowledged events are always durable.
            if self.checkpointing:
                pending_acks.extend(good_msgs)
                if (self.metrics.batches - self._batches_at_snap
                        >= self._snap_every):
                    checkpoint_and_ack()
            else:
                acknowledge_all(self.consumer, good_msgs)
            if max_events is not None and (
                    self.metrics.events >= max_events):
                break

    def process_attendance(self, max_events: Optional[int] = None,
                           idle_timeout_s: Optional[float] = None) -> None:
        """The long-running consume loop (the reference's entry point).

        max_events / idle_timeout_s bound the run for tests and batch
        jobs; both None = run until interrupted, like the reference.
        """
        logger.info("Starting attendance processing...")
        self.setup_bloom_filter()
        t_start = time.perf_counter()
        idle_since = time.monotonic()
        pending_acks: List = []  # held until the next snapshot barrier

        def checkpoint_and_ack():
            self.snapshot()
            acknowledge_all(self.consumer, pending_acks)
            pending_acks.clear()

        try:
            with maybe_trace(self.config.profile_dir,
                             getattr(self.sketch, "device", None)):
                self._consume_loop(max_events, idle_timeout_s, idle_since,
                                   checkpoint_and_ack, pending_acks)
        except KeyboardInterrupt:
            logger.info("Stopping attendance processing...")
        except Exception:
            # Crash forensics: dump the per-batch ring before unwinding.
            if self._obs is not None:
                self._obs.dump_flight("run-loop-exception")
            raise
        finally:
            if pending_acks:
                checkpoint_and_ack()
            self.metrics.wall_seconds = time.perf_counter() - t_start
            blocked = self.config.bloom_layout == "blocked"
            if logger.isEnabledFor(logging.INFO):
                logger.info("Metrics: %s", self.metrics.summary(
                    self.estimated_fpr(), fpr_is_lower_bound=blocked))
            if self.config.metrics_json:
                self.metrics.write_json_line(
                    self.config.metrics_json,
                    estimated_fpr=self.estimated_fpr(),
                    fpr_is_lower_bound=blocked)
            if self._obs is not None:
                self._obs.finalize_slo("run-end")
                self._obs.flush_trace("run-end")

    def estimated_fpr(self) -> Optional[float]:
        """Occupancy-based Bloom FPR estimate of the roster filter (None
        when the backend's state is not inspectable)."""
        return self.sketch.estimated_fpr(self.config.bloom_filter_key)

    # -- query path ---------------------------------------------------------
    def get_attendance_stats(self, lecture_id: str) -> Dict:
        """PFCOUNT and the lecture's partition scan."""
        unique = self.sketch.pfcount(
            f"{self.config.hll_key_prefix}{lecture_id}")
        records = self.store.scan_lecture(lecture_id)
        return {"unique_attendees": unique, "attendance_records": records}

    def cleanup(self) -> None:
        self.client.close()
        self.sketch.close()
        self.store.close()
