"""Command line of the port: ``python -m attendance_tpu_torch <verb>``.

Counterpart of ``attendance_tpu/cli.py``'s verbs:

* ``fused``: a hermetic run of the hot path in one process: bulk
  binary load generator -> in-process broker -> FusedPipeline (roster
  preload, one fused kernel per frame, with ``--temporal-period-s > 0``
  the temporal plane, with ``--snapshot-dir`` checkpoints and a restore
  on start) -> the metrics summary (logged), the analyzer's insights,
  one PFCOUNT line per lecture day, then one JSON line of the run's
  numbers;
* ``generate``, ``process``, ``pipeline``: the reference's generator
  and processor over the generic sketch store (``--sketch-backend``:
  ``tpu`` is the card store) and an event store
  (``--storage-backend``); ``pipeline`` runs generate -> process ->
  analyze in one process and logs each lecture's PFCOUNT;
* ``stats``: PFCOUNT and the partition scan of one lecture, or one
  student's records;
* ``analyze``: the insights over a saved store (``--events-file``: a
  snapshot directory, its event segments, a one-shot npz or a row
  store's JSONL);
* ``parity``: the card store against an oracle (``--oracle sim``, the
  hermetic simulation of Redis's algorithms; ``--oracle redis``, a live
  Redis Stack, exiting 2 when none is reachable);
* ``bridge``: the JSON -> binary ingress bridge: drain the reference's
  per-event JSON topic, republish micro-batches as planar frames on
  ``<topic>-binary`` for the fused pipeline, until idle;
* ``serve``: a query-serving reader over a snapshot directory's chain
  (``serve.chain``), answering BF.EXISTS, PFCOUNT, occupancy, attendance
  rate and the window verbs on the binary RPC of ``--serve-port``,
  refreshing as the ingest writer makes new state durable;
* ``federate``: the federation's aggregator (``federation.gossip``):
  folds the workers' merge frames from ``--fed-gossip-topic`` into one
  view, declares peers silent past ``--fed-dead-after-s`` dead
  (recovering their chains), serves the merged view on the binary RPC
  of ``--serve-port`` and keeps ``--stats-json`` current. The workers
  are ``python -m attendance_tpu_torch.federation.worker``;
* ``telemetry``: pretty-print a telemetry artifact (a flight-recorder
  dump, a ``--metrics-prom`` exposition file, or a ``--trace-out`` span
  trace, the format sniffed from the content; ``--follow`` tails a live
  one; ``--attribution`` renders the sampling profiler's
  ``attribution.json``, or a ``--profile-out`` directory holding one).
  The artifacts are the JAX package's formats: either package's verb
  reads either package's files;
* ``fleet``: the fleet dashboard, one row per pushing role@instance,
  live from a collector's ``/fleet/status`` (``--http HOST:PORT``) or
  offline from a collected ``--fleet-dir`` (``--dir``); ``--once``
  prints one table, ``--snapshot-json PATH`` writes the status document;
* ``doctor``: the offline SLO verdict over run artifacts (a prom file,
  an alert log, a flight dump, a span trace; ``--fleet DIR`` of
  ``<role>@<instance>.prom`` files; ``--scrub DIR``; ``--incident DIR``,
  incident evidence bundles, digest-verified and judged; ``--quarantine
  DIR``, ``--replay-quarantine``, ``--purge-replayed``): a verdict
  table, exit 0 when every check passes, 1 on a breach, 2 when an
  artifact is unreadable; ``--actuations FILE`` replays a control-plane
  actuation log (exit 1 on a schema or sequence problem, 2 when the file
  is missing);
* ``scrub``: the offline integrity scrub of snapshot chains, spill,
  quarantine and event directories (``utils.integrity.scrub_report``):
  a verdict table, exit 0 when nothing is corrupt, 1 when something is,
  2 when a path is unreadable.

``fused`` also takes ``--num-shards``/``--num-replicas`` (a mesh over
the process's CUDA devices, its dp axis over the processes of a torchrun
group), ``--replica-sync``, ``--ingress-lanes N`` (striped ingress lanes),
``--ingress-wire shm`` (the shared-memory ring under ``--shm-dir``),
``--serve-port`` (the in-process query plane over the read mirror) and
the ``--fed-*`` flags (a federated worker gossiping its fences).

``fused``, ``process``, ``pipeline``, ``bridge``, ``serve`` and
``federate`` take the telemetry flags: ``--metrics-prom FILE``,
``--metrics-port N`` (-1 = ephemeral; ``GET /metrics``),
``--metrics-interval-s``, ``--flight-recorder N`` and ``--flight-path``,
``--trace-out FILE``, ``--audit-sample F`` (the exact-shadow accuracy
audit over a hash-sampled fraction of the key space),
``--metric-series-max``, the SLO engine's ``--alert-log FILE``, ``--slo
SPEC`` (repeatable), ``--slo-fast-s`` and ``--slo-slow-s``, the host
sampling profiler's ``--profile-hz`` and ``--profile-out DIR``, the
incident engine's ``--incident-dir DIR`` and ``--incident-clear-ticks``,
and the fleet pusher's ``--fleet-push HOST:PORT``, ``--fleet-role``,
``--fleet-instance`` and ``--fleet-push-interval-s``. ``federate`` also
takes ``--fleet-port N`` (a fleet collector in the aggregator's process,
-1 = ephemeral, its views under ``/fleet/*`` on ``--metrics-port``) and
``--fleet-dir DIR`` (the collected artifacts).
``fused`` alone, whose run builds the fused pipeline a controller
attaches to, takes the control plane's ``--control-log FILE`` (the
actuation log; it turns telemetry on), ``--control-spill-dir DIR``,
``--control-dwell-s``, ``--control-clear-ticks`` and
``--control-flap-limit``. ``fused``, ``process`` and ``pipeline``, whose
runs read it, also take ``--profile-dir DIR`` (a ``torch.profiler`` trace of the fused or the
processor run, ``utils/profiling.TRACE_FILE`` under the directory).
With ``--metrics-port``, ``serve`` and a
``fused`` run with ``--serve-port`` also answer the query verbs as JSON
under ``/query/*`` (``serve/http.py``).

Every verb but ``serve`` takes ``--transport-backend
{memory,socket,pulsar}`` (``socket``: a BrokerServer at
``--socket-broker``, started with ``python -m
attendance_tpu_torch.transport.socket_broker``; ``pulsar``: a Pulsar
service at ``--pulsar-host`` through pulsar-client, which is
import-gated and raises when absent). The verbs that open a
broker client (``fused``, ``generate``, ``process``, ``pipeline``,
``bridge``, ``federate``) take the fault plane's ``--chaos SPEC`` and
``--chaos-seed N`` (``chaos/``); ``generate``, ``process`` and
``pipeline`` take ``--bloom-filter-key``; those with a persist sink (``fused``,
``process``, ``pipeline``) take ``--persist-spill-dir`` with
``--persist-breaker-failures`` and ``--persist-breaker-cooldown-s`` (the
sink's circuit breaker, ``storage/resilient.py``). Runs on the CUDA card
unless ``--device cpu`` is given (``bridge`` runs on the host only).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.analyzer import AttendanceAnalyzer
from attendance_tpu_torch.pipeline.bridge import JsonBinaryBridge
from attendance_tpu_torch.pipeline.fast_path import (
    EVENTS_SEGMENTS, EVENTS_SNAPSHOT, FusedPipeline)
from attendance_tpu_torch.parallel.multihost import init_distributed
from attendance_tpu_torch.parity import (
    RedisUnavailable, run_redis_parity, run_sim_parity)
from attendance_tpu_torch.pipeline.generator import generate_student_data
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.pipeline.processor import AttendanceProcessor
from attendance_tpu_torch.sketch import make_sketch_store
from attendance_tpu_torch.storage import MemoryEventStore, make_event_store
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore
from attendance_tpu_torch.transport import make_client

logger = logging.getLogger(__name__)


def run_fused(config: Config, num_events: int, frame_size: int,
              num_lectures: int, seed: int = 0, device=None,
              client=None) -> Tuple[FusedPipeline, dict]:
    """The fused verb's flow (on ``client``, else the transport of
    ``config``). Returns the pipeline (for further queries; the caller
    runs ``cleanup()``) and a summary of the run."""
    pipe = FusedPipeline(config, client=client, device=device)
    try:
        roster, frames = generate_frames(
            num_events, frame_size,
            roster_size=min(config.bloom_filter_capacity, num_events),
            num_lectures=num_lectures, seed=seed)
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for frame in frames:
            producer.send(frame)
        pipe.run(max_events=num_events, idle_timeout_s=1.0)
        m = pipe.metrics
        m.valid_events, m.invalid_events = pipe.validity_counts()
        summary = {
            "device": str(pipe.device),
            "events": m.events,
            "batches": m.batches,
            "valid": m.valid_events,
            "invalid": m.invalid_events,
            "wall_seconds": m.wall_seconds,
            "events_per_second": m.events_per_second,
            "wire_dwell": dict(m.wire_dwell),
            "stage_seconds": dict(m.stage_seconds),
            "snapshots": len(m.snapshot_stalls),
            "snapshot_write_s": sum(m.snapshot_stalls),
            "snapshot_blocked_s": m.snapshot_blocked_s,
            "estimated_fpr": pipe.estimated_fpr(),
            "unique_attendees": {str(day): n for day, n
                                 in sorted(pipe.count_all().items())},
        }
        if pipe.temporal_stats() is not None:
            summary["temporal"] = pipe.temporal_stats()
    except BaseException:
        pipe.cleanup()
        raise
    return pipe, summary


def _fused_config(args) -> Config:
    """The Config of the ``fused`` verb's flags."""
    return Config(bloom_filter_capacity=args.bloom_capacity,
                  bloom_filter_error_rate=args.bloom_error_rate,
                  hll_precision=args.hll_precision,
                  wire_format=args.wire_format,
                  temporal_period_s=args.temporal_period_s,
                  allowed_lateness_s=args.allowed_lateness_s,
                  watermark_idle_s=args.watermark_idle_s,
                  temporal_ring_banks=args.temporal_ring_banks,
                  cms_depth=args.cms_depth, cms_width=args.cms_width,
                  cms_topk=args.cms_topk,
                  snapshot_dir=args.snapshot_dir,
                  snapshot_every_batches=args.snapshot_every_batches,
                  snapshot_mode=args.snapshot_mode,
                  snapshot_compact_every=args.snapshot_compact_every,
                  integrity=not args.no_integrity,
                  num_shards=args.num_shards,
                  num_replicas=args.num_replicas,
                  replica_sync=args.replica_sync,
                  max_redeliveries=args.max_redeliveries,
                  metrics_json=args.metrics_json,
                  **_transport_config(args), **_ingress_config(args),
                  **_serve_config(args), **_fed_config(args),
                  **_telemetry_config(args), **_control_config(args))


def cmd_fused(args) -> None:
    config = _fused_config(args)
    own_telemetry = obs.get() is None
    pipe, summary = run_fused(config, args.num_events, args.frame_size,
                              args.num_lectures, args.seed, args.device)
    try:
        # The blocked layout's occupancy estimate is a lower bound.
        logger.info("Fused: %s", pipe.metrics.summary(
            summary["estimated_fpr"], include_validity=True,
            fpr_is_lower_bound=True))
        analyzer = AttendanceAnalyzer(pipe.store)
        analyzer.print_insights(analyzer.generate_insights())
    finally:
        pipe.cleanup()
        if own_telemetry:
            # Stop the verb's telemetry while the pipeline is alive: the
            # last prom block then carries the health and audit gauges,
            # which read the pipeline through a weak reference (a run
            # shorter than the reporter's interval has no other block).
            obs.disable()
    for day, n in summary.pop("unique_attendees").items():
        print(f"LECTURE_{day}: {n} unique attendees")
    print(json.dumps(summary))


def _store_for_events_file(config: Config, path: str):
    """An event store loaded from ``path``, its format sniffed: the
    fused pipeline's event segments (a snapshot directory, its segments
    directory, or the legacy ``fused_events.npz`` beside them, which
    never shadows them) and one-shot npz saves load into a columnar
    store, a row store's JSONL into a row store; the configured backend
    is swapped when the file disagrees with it."""
    p = Path(path)
    seg_dir = None
    if p.is_dir():
        if list(p.glob("segment-*.npz")):
            seg_dir = p
        elif (p / EVENTS_SEGMENTS).is_dir():
            seg_dir = p / EVENTS_SEGMENTS
        else:
            raise FileNotFoundError(f"no event segments in {p}")
    elif p.name == EVENTS_SNAPSHOT and (p.parent / EVENTS_SEGMENTS).is_dir():
        seg_dir = p.parent / EVENTS_SEGMENTS
    if seg_dir is not None:
        store = ColumnarEventStore()
        store.load_segments(seg_dir)
        return store
    store = make_event_store(config)
    with open(p, "rb") as f:
        is_npz = f.read(2) == b"PK"
    is_columnar = hasattr(store, "insert_columns")
    if is_npz and not is_columnar:
        logger.info("events file is columnar npz; using the columnar "
                    "store")
        store = ColumnarEventStore()
    elif not is_npz and is_columnar:
        logger.info("events file is row JSONL; using the row store")
        store = MemoryEventStore()
    store.load(p)
    return store


def _num_records(records) -> int:
    """Record count of a scan (column dicts or row lists)."""
    return (len(records["student_id"]) if isinstance(records, dict)
            else len(records))


def cmd_analyze(args) -> None:
    config = _config(args)
    store = (_store_for_events_file(config, args.events_file)
             if args.events_file else make_event_store(config))
    analyzer = AttendanceAnalyzer(store)
    try:
        analyzer.print_insights(analyzer.generate_insights())
    finally:
        analyzer.cleanup()


def _transport_config(args) -> dict:
    """Config fields of the transport flags (``_add_transport_flags``),
    with the fault plane's of a verb that has them."""
    return dict(transport_backend=args.transport_backend,
                socket_broker=args.socket_broker,
                pulsar_host=args.pulsar_host,
                pulsar_topic=args.pulsar_topic,
                quarantine_dir=args.quarantine_dir,
                retry_budget_s=args.retry_budget_s, **_chaos_config(args),
                **_persist_config(args))


def _chaos_config(args) -> dict:
    """Config fields of the chaos flags (``_add_chaos_flags``); none for
    a verb without them."""
    if not hasattr(args, "chaos"):
        return {}
    return dict(chaos=args.chaos, chaos_seed=args.chaos_seed)


def _persist_config(args) -> dict:
    """Config fields of the persist sink's flags (``_add_persist_flags``);
    none for a verb without them."""
    if not hasattr(args, "persist_spill_dir"):
        return {}
    return dict(persist_spill_dir=args.persist_spill_dir,
                persist_breaker_failures=args.persist_breaker_failures,
                persist_breaker_cooldown_s=args.persist_breaker_cooldown_s)


def _ingress_config(args) -> dict:
    """Config fields of the ingress flags (``_add_ingress_flags``)."""
    return dict(batch_size=args.batch_size,
                batch_timeout_s=args.batch_timeout_s,
                ingress_lanes=args.ingress_lanes,
                lane_queue_depth=args.lane_queue_depth,
                lane_decode=args.lane_decode,
                ingress_wire=args.ingress_wire, shm_dir=args.shm_dir,
                shm_slots=args.shm_slots, shm_slot_bytes=args.shm_slot_bytes)


def _serve_config(args) -> dict:
    """Config fields of the query-plane flags (``_add_serve_flags``)."""
    return dict(serve_port=args.serve_port,
                query_batch_max=args.query_batch_max,
                read_staleness_ceiling_s=args.read_staleness_ceiling_s)


def _fed_config(args) -> dict:
    """Config fields of the federation flags (``_add_fed_flags``)."""
    return dict(fed_worker=args.fed_worker, fed_shard=args.fed_shard,
                fed_shards=args.fed_shards,
                fed_gossip_topic=args.fed_gossip_topic,
                fed_gossip_broker=args.fed_gossip_broker,
                fed_heartbeat_s=args.fed_heartbeat_s,
                fed_dead_after_s=args.fed_dead_after_s)


def _telemetry_config(args) -> dict:
    """Config fields of the telemetry flags (``_add_telemetry_flags``);
    none for a verb without them."""
    if not hasattr(args, "metrics_prom"):
        return {}
    return dict(metrics_prom=args.metrics_prom,
                metrics_port=args.metrics_port,
                metrics_interval_s=args.metrics_interval_s,
                flight_recorder=args.flight_recorder,
                flight_path=args.flight_path, trace_out=args.trace_out,
                audit_sample=args.audit_sample,
                metric_series_max=args.metric_series_max,
                profile_dir=getattr(args, "profile_dir", ""),
                profile_hz=args.profile_hz,
                profile_out=args.profile_out, alert_log=args.alert_log,
                slo=list(args.slo or []), slo_fast_s=args.slo_fast_s,
                slo_slow_s=args.slo_slow_s, incident_dir=args.incident_dir,
                incident_clear_ticks=args.incident_clear_ticks,
                fleet_push=args.fleet_push, fleet_role=args.fleet_role,
                fleet_instance=args.fleet_instance,
                fleet_push_interval_s=args.fleet_push_interval_s,
                **_fleet_collector_config(args))


def _fleet_collector_config(args) -> dict:
    """Config fields of the collector's flags (``federate`` only)."""
    if not hasattr(args, "fleet_port"):
        return {}
    return dict(fleet_port=args.fleet_port, fleet_dir=args.fleet_dir)


def _config(args) -> Config:
    """The Config of a generic-store verb's flags."""
    return Config(
        **_transport_config(args),
        redis_host=args.redis_host, redis_port=args.redis_port,
        cassandra_hosts=args.cassandra_hosts.split(","),
        cassandra_keyspace=args.cassandra_keyspace,
        bloom_filter_error_rate=args.bloom_error_rate,
        bloom_filter_capacity=args.bloom_capacity,
        hll_key_prefix=args.hll_key_prefix,
        sketch_backend=args.sketch_backend,
        storage_backend=args.storage_backend,
        batch_size=args.batch_size, batch_timeout_s=args.batch_timeout_s,
        bloom_layout=args.bloom_layout, hll_precision=args.hll_precision,
        invalid_topic=args.invalid_topic,
        max_redeliveries=args.max_redeliveries,
        metrics_json=args.metrics_json,
        snapshot_dir=args.snapshot_dir,
        snapshot_every_batches=args.snapshot_every_batches,
        snapshot_mode=args.snapshot_mode,
        snapshot_compact_every=args.snapshot_compact_every,
        **_bloom_key_config(args), **_telemetry_config(args))


def _bloom_key_config(args) -> dict:
    """The roster filter's key (``_add_bloom_key_flag``); none for a verb
    without the flag."""
    if not hasattr(args, "bloom_filter_key"):
        return {}
    return dict(bloom_filter_key=args.bloom_filter_key)


def cmd_generate(args) -> None:
    config = _config(args)
    client = make_client(config)
    producer = client.create_producer(config.pulsar_topic)
    sketch = make_sketch_store(config, args.device)
    logger.info("Starting student attendance data generation...")
    report = generate_student_data(
        producer=producer, sketch_store=sketch,
        bloom_key=config.bloom_filter_key,
        num_students=args.num_students, num_invalid=args.num_invalid,
        seed=args.seed, throttle_s=args.throttle_s, keep_events=False,
        disorder_frac=args.disorder_frac, late_max_s=args.late_max_s)
    logger.info("Generated %d messages (%d invalid attempts)",
                report.message_count, report.invalid_attempts)
    client.close()


def cmd_process(args) -> None:
    processor = AttendanceProcessor(_config(args), device=args.device)
    try:
        processor.process_attendance(
            max_events=args.max_events,
            idle_timeout_s=args.idle_timeout_s)
    finally:
        m = processor.metrics
        logger.info(
            "Processed %d events in %d batches (%.0f ev/s; %d valid, "
            "%d invalid, %d nacked batches)", m.events, m.batches,
            m.events_per_second, m.valid_events, m.invalid_events,
            m.nacked_batches)
        processor.cleanup()


def run_pipeline(config: Config, num_students: int, num_invalid: int,
                 seed: Optional[int] = None, disorder_frac: float = 0.0,
                 late_max_s: float = 0.0, device=None, now=None):
    """The pipeline verb's flow up to the analyzer: the processor's
    Bloom setup, the generator publishing onto the processor's broker
    (and preloading its store), then the processor draining the topic.
    Returns (processor, generator report); the caller runs
    ``cleanup()``."""
    processor = AttendanceProcessor(config, device=device)
    processor.setup_bloom_filter()
    producer = processor.client.create_producer(config.pulsar_topic)
    report = generate_student_data(
        producer=producer, sketch_store=processor.sketch,
        bloom_key=config.bloom_filter_key,
        num_students=num_students, num_invalid=num_invalid,
        now=now, seed=seed, keep_events=False,
        disorder_frac=disorder_frac, late_max_s=late_max_s)
    processor.process_attendance(max_events=report.message_count,
                                 idle_timeout_s=1.0)
    return processor, report


def cmd_pipeline(args) -> None:
    """Hermetic end-to-end run: generate -> process -> analyze in one
    process."""
    processor, report = run_pipeline(
        _config(args), args.num_students, args.num_invalid, args.seed,
        args.disorder_frac, args.late_max_s, args.device)
    m = processor.metrics
    logger.info("Processed %d/%d events (%.0f ev/s)", m.events,
                report.message_count, m.events_per_second)
    analyzer = AttendanceAnalyzer(processor.store)
    analyzer.print_insights(analyzer.generate_insights())
    for lecture_id in processor.store.distinct_lecture_ids():
        stats = processor.get_attendance_stats(lecture_id)
        logger.info("%s: %d unique attendees, %d records", lecture_id,
                    stats["unique_attendees"],
                    _num_records(stats["attendance_records"]))
    processor.cleanup()


def cmd_stats(args) -> None:
    """PFCOUNT and the partition scan of one lecture (the reference's
    get_attendance_stats) against the configured backends, or with
    ``--student-id`` one student's records across every lecture."""
    config = _config(args)
    if args.student_id is None and not args.lecture_id:
        # Checked before any backend is opened.
        logger.error("stats needs a lecture_id or --student-id")
        sys.exit(2)
    if args.events_file:
        store = _store_for_events_file(config, args.events_file)
    else:
        store = make_event_store(config)
    if args.student_id is not None:
        # The per-student scan never reads the sketch store, so it is
        # not opened.
        if args.lecture_id:
            logger.warning(
                "--student-id given: lecture_id %r is ignored "
                "(per-student scan spans all lectures)",
                args.lecture_id)
        records = store.scan_student(args.student_id)
        if isinstance(records, dict):
            lectures = sorted(set(records["lecture_day"].tolist()))
            n, nv = (len(records["student_id"]),
                     int(sum(records["is_valid"])))
        else:
            lectures = sorted({r.lecture_id for r in records})
            n, nv = len(records), sum(1 for r in records if r.is_valid)
        print(f"Student {args.student_id}: {n} attendance records "
              f"({nv} valid) across {len(lectures)} lectures")
        return
    sketch = make_sketch_store(config, args.device)
    unique = sketch.pfcount(f"{config.hll_key_prefix}{args.lecture_id}")
    records = store.scan_lecture(args.lecture_id)
    num = _num_records(records)
    source = "HLL estimate"
    if unique == 0 and num > 0:
        # The tpu and memory sketch stores hold HLL state only in the
        # process that made it: answer exactly from the partition scan,
        # and say so on the line.
        sids = (records["student_id"] if isinstance(records, dict)
                else [r.student_id for r in records])
        unique = len(np.unique(np.asarray(sids)))
        source = "exact, from stored partition; no HLL state"
        logger.info("sketch backend holds no HLL state for this key; "
                    "unique count derived exactly from the stored "
                    "partition")
    print(f"Lecture {args.lecture_id}: {unique} unique attendees "
          f"({source}), {num} attendance records")


def cmd_parity(args) -> None:
    """Differential parity run of the card store against an oracle:
    ``--oracle sim`` (default, hermetic) or ``--oracle redis`` (exits 2
    when no Redis Stack is reachable)."""
    config = _config(args)
    kwargs = dict(num_events=args.num_events,
                  roster_size=args.roster_size,
                  num_lectures=args.num_lectures, seed=args.seed)
    if args.oracle == "redis":
        try:
            report = run_redis_parity(config, args.device, **kwargs)
        except RedisUnavailable as e:
            logger.error("parity run needs a Redis Stack server: %s", e)
            sys.exit(2)
    else:
        report = run_sim_parity(config, args.device, **kwargs)
    print(report.summary())
    if not report.ok:
        sys.exit(1)


def cmd_bridge(args) -> None:
    """Run the JSON -> binary ingress bridge until idle (or max events)."""
    config = Config(batch_size=args.batch_size,
                    batch_timeout_s=args.batch_timeout_s,
                    max_redeliveries=args.max_redeliveries,
                    metrics_json=args.metrics_json,
                    **_transport_config(args), **_telemetry_config(args))
    bridge = JsonBinaryBridge(config, out_topic=args.out_topic or None)
    try:
        bridge.run(max_events=args.max_events,
                   idle_timeout_s=args.idle_timeout_s)
        m = bridge.metrics
        logger.info("Bridged %d events in %d frames (%.0f ev/s; %d "
                    "dead-lettered)", m.events, m.batches,
                    m.events_per_second, m.dead_lettered)
    finally:
        bridge.cleanup()


def cmd_serve(args) -> None:
    """A query-serving reader: merge-on-read over a snapshot directory's
    base + delta chain (never joining the ingest process), publishing a
    fresh epoch whenever the writer made new state durable, and answering
    the query verbs over the binary batch RPC."""
    import time

    from attendance_tpu_torch.serve.chain import ChainEpochSource
    from attendance_tpu_torch.serve.engine import QueryEngine
    from attendance_tpu_torch.serve.rpc import QueryServer

    config = Config(snapshot_dir=args.snapshot_dir, **_serve_config(args),
                    **_telemetry_config(args))
    if not config.snapshot_dir:
        logger.error("serve needs --snapshot-dir (the chain to read)")
        sys.exit(2)
    if config.fleet_push and not config.fleet_role:
        config.fleet_role = "serve"
    telemetry = obs.ensure(config)
    try:
        source = ChainEpochSource(config.snapshot_dir,
                                  refresh_s=args.refresh_s,
                                  obs=telemetry).start()
    except FileNotFoundError as e:
        logger.error("no snapshot chain to serve: %s", e)
        sys.exit(2)
    engine = QueryEngine(
        source, obs=telemetry, batch_max=config.query_batch_max,
        staleness_ceiling_s=config.read_staleness_ceiling_s or None)
    port = config.serve_port
    server = QueryServer(engine, port=0 if port < 0 else port).start()
    if telemetry is not None and telemetry._server is not None:
        # The query verbs as JSON routes beside GET /metrics.
        from attendance_tpu_torch.serve import http as serve_http
        serve_http.attach(telemetry._server, engine)
    epoch = source.pin()
    print(f"query plane serving {config.snapshot_dir} on {server.address} "
          f"(epoch {epoch.seq}, {epoch.events} events)", flush=True)
    try:
        if args.serve_seconds is not None:
            time.sleep(args.serve_seconds)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        source.stop()


def cmd_federate(args) -> None:
    """The federation's aggregator: fold every worker's merge frames
    (Bloom word OR, HLL register max) into one view, declare peers
    silent past --fed-dead-after-s dead (orphaning their shards at a
    bumped map version and recovering their durable chains), and serve
    the merged view through the query plane on --serve-port.
    ``--stats-json PATH`` keeps the aggregator's state (worker ledgers,
    shard map, fold counters) there, replaced atomically."""
    import os
    import time

    from attendance_tpu_torch.federation.gossip import Aggregator
    from attendance_tpu_torch.serve.engine import QueryEngine
    from attendance_tpu_torch.serve.rpc import QueryServer

    config = Config(hll_precision=args.hll_precision,
                    **_transport_config(args), **_serve_config(args),
                    **_fed_config(args), **_telemetry_config(args))
    collector = None
    if config.fleet_port:
        # The aggregator hosts the fleet collector: it outlives the
        # workers. Made before the telemetry bundle, so the aggregator's
        # own pusher defaults to it and the pane of glass holds the
        # aggregator's row too.
        from attendance_tpu_torch.obs.fleet import FleetCollector

        collector = FleetCollector(
            directory=config.fleet_dir,
            port=0 if config.fleet_port < 0 else config.fleet_port,
            ).start()
        config.fleet_push = config.fleet_push or collector.address
        print(f"fleet collector on {collector.address}"
              + (f" (artifacts -> {config.fleet_dir})"
                 if config.fleet_dir else ""), flush=True)
    if config.fleet_push and not config.fleet_role:
        config.fleet_role = "aggregator"
    telemetry = obs.ensure(config)
    if collector is not None and telemetry is not None:
        collector.bind_obs(telemetry)
        if telemetry._server is not None:
            collector.attach(telemetry._server)
        if telemetry.incidents is not None:
            # The aggregator's bundles carry the fleet-wide status: a
            # dead worker's diagnosis needs the per-peer rows.
            telemetry.incidents.bind_collector(collector)
    agg = Aggregator(config, obs=telemetry).start()
    engine = QueryEngine(
        agg.mirror, obs=telemetry, batch_max=config.query_batch_max,
        staleness_ceiling_s=config.read_staleness_ceiling_s or None)
    port = config.serve_port
    server = QueryServer(engine, port=0 if port < 0 else port).start()

    def write_stats() -> None:
        if not args.stats_json:
            return
        doc = agg.stats()
        doc["serve_address"] = server.address
        tmp = args.stats_json + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, args.stats_json)  # readers never see a torn file

    print(f"federation aggregator folding {config.fed_gossip_topic!r} "
          f"({agg.shard_map.num_shards} shard(s)), serving on "
          f"{server.address}", flush=True)
    try:
        deadline = (time.time() + args.serve_seconds
                    if args.serve_seconds is not None else None)
        while deadline is None or time.time() < deadline:
            time.sleep(args.stats_every_s if deadline is None else
                       min(args.stats_every_s,
                           max(0.05, deadline - time.time())))
            write_stats()
    except KeyboardInterrupt:
        pass
    finally:
        try:
            agg.stop()
            write_stats()
        finally:
            if (collector is not None and telemetry is not None
                    and telemetry._server is not None):
                collector.detach(telemetry._server)
            # Telemetry stops before the collector: its pusher's final
            # drain lands while the collector still accepts, so FLEET.json
            # holds the aggregator's own row even for a run shorter than
            # the push interval.
            obs.disable()
            if collector is not None:
                collector.stop()  # flushes the fleet artifacts
            server.stop()


def cmd_telemetry(args) -> None:
    """Pretty-print a telemetry artifact: a flight-recorder JSON dump,
    a Prometheus exposition file (the last scrape block), or a
    Chrome-trace export (per-trace span trees with durations), the
    format sniffed from the content. ``--follow`` re-renders whenever
    the file grows or is replaced, until interrupted. ``--attribution``
    renders a sampling-profiler attribution document (or a
    ``--profile-out`` directory holding one) as the per-stage self-time
    table, with the launch-shape fingerprint ledger."""
    import os

    from attendance_tpu_torch.obs.exposition import format_file

    if args.attribution:
        from attendance_tpu_torch.obs.profiler import (
            ATTRIBUTION_FILE, format_attribution_table)

        path = args.path
        if os.path.isdir(path):
            path = os.path.join(path, ATTRIBUTION_FILE)
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if doc.get("kind") != "attribution":
                raise ValueError(
                    "not an attribution document (expected "
                    '"kind": "attribution" — the sampling '
                    "profiler's attribution.json)")
            print(format_attribution_table(doc))
        except FileNotFoundError:
            logger.error("no attribution artifact at %s (was the run "
                         "profiled with --profile-hz/--profile-out?)",
                         path)
            sys.exit(2)
        except Exception as e:
            logger.error("unreadable attribution artifact %s: %s",
                         path, e)
            sys.exit(2)
        return
    if args.follow:
        try:
            _follow_file(args.path, args.last, args.interval_s)
        except KeyboardInterrupt:
            pass
        return
    try:
        print(format_file(args.path, last=args.last))
    except FileNotFoundError:
        logger.error("no such telemetry artifact: %s", args.path)
        sys.exit(2)
    except Exception as e:
        # A truncated or hand-edited artifact gets a diagnostic, not a
        # traceback.
        logger.error("unreadable telemetry artifact %s: %s", args.path, e)
        sys.exit(2)


def _fleet_status(args) -> dict:
    """One status snapshot: live from the collector's /fleet/status
    route (--http), or offline from a collected directory's FLEET.json
    (--dir)."""
    import urllib.request

    if args.dir:
        from attendance_tpu_torch.obs.fleet import STATUS_FILE

        return json.loads((Path(args.dir) / STATUS_FILE).read_text())
    url = f"http://{args.http}/fleet/status"
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read())


def _fleet_table(doc: dict) -> str:
    from attendance_tpu_torch.obs.exposition import _table

    rows = []
    for key in sorted(doc.get("instances", {})):
        inst = doc["instances"][key]
        rows.append([
            key,
            f"{inst.get('age_s', 0.0):.1f}s",
            str(inst.get("pushes", 0)),
            str(inst.get("spans", 0)),
            str(inst.get("events", "-")),
            str(inst.get("series", "-")),
            str(inst.get("top_stage", "-")),
            str(inst.get("merge_lag_p99_s", "-")),
            str(inst.get("read_staleness_s", "-")),
            str(inst.get("slo_firing", 0)),
            str(inst.get("incidents", "-")),
        ])
    return _table(rows, ["role@instance", "age", "pushes", "spans",
                         "events", "series", "top_stage", "lag_p99",
                         "staleness", "firing", "incidents"])


def cmd_fleet(args) -> None:
    """Fleet dashboard over a live collector (or a collected artifact
    directory): one row per pushing role@instance, with push liveness,
    span and series volume, headline counters, merge lag, staleness and
    firing alerts. By default a top-style live loop; ``--once`` prints
    one table; ``--snapshot-json PATH`` writes the raw status document
    (``-`` = stdout) and exits."""
    import time

    if not args.http and not args.dir:
        logger.error("fleet needs --http HOST:PORT (live collector) "
                     "or --dir FLEET_DIR (collected artifacts)")
        sys.exit(2)
    try:
        doc = _fleet_status(args)
    except Exception as e:
        logger.error("no fleet status from %s: %s",
                     args.http or args.dir, e)
        sys.exit(2)
    if args.snapshot_json:
        out = json.dumps(doc, indent=2)
        if args.snapshot_json == "-":
            print(out)
        else:
            with open(args.snapshot_json, "w") as f:
                f.write(out + "\n")
            print(f"fleet snapshot -> {args.snapshot_json}")
        return
    if args.once or args.dir:
        print(_fleet_table(doc))
        return
    stale = ""
    try:
        while True:
            print("\x1b[2J\x1b[H"
                  + f"fleet @ {time.strftime('%H:%M:%S')} "
                  f"({args.http}){stale}\n" + _fleet_table(doc),
                  flush=True)
            time.sleep(args.interval_s)
            try:
                doc = _fleet_status(args)
                stale = ""
            except Exception as e:
                # A restarting collector or one slow scrape keeps the
                # last good snapshot on screen, marked stale.
                stale = f"  [stale: {e}]"
    except KeyboardInterrupt:
        pass


def cmd_doctor(args) -> None:
    """Offline SLO verdict over run artifacts: replay a --metrics-prom
    exposition file, an --alert-log JSONL, a flight-recorder dump and/or
    a --trace-out export, print a pass/fail verdict table, and exit
    non-zero on a breach: a run's own telemetry artifacts become a CI
    gate without rerunning anything. ``--fleet DIR`` judges a directory
    of ``<role>@<instance>.prom`` files (per-role rows, then fleet-wide
    rows over the merged data); ``--scrub DIR`` folds the offline
    integrity scrub into the verdict; ``--incident DIR`` replays incident
    evidence bundles (every part digest-verified against incident.json,
    an undiagnosed open incident a breach; with ``--actuations`` each
    diagnosed bundle says whether the controller's recorded actuation
    matched its top rule); ``--actuations FILE`` replays a control-plane
    actuation log (schema, sequence); ``--quarantine DIR`` lists the
    on-disk dead-letter quarantine, ``--replay-quarantine`` republishes
    its frames through the configured transport. Exit codes: 0 every
    check passes, 1 at least one breach, 2 unreadable artifacts."""
    from attendance_tpu_torch.obs.slo import doctor_report

    if args.replay_quarantine:
        if not args.quarantine:
            logger.error("--replay-quarantine needs --quarantine DIR")
            sys.exit(2)
        from attendance_tpu_torch.transport.quarantine import replay

        config = Config(**_transport_config(args))
        client = make_client(config)
        try:
            producer = client.create_producer(config.pulsar_topic)
            n = replay(args.quarantine, producer,
                       remove=args.purge_replayed)
        finally:
            client.close()
        print(f"replayed {n} quarantined frame(s) onto "
              f"{config.pulsar_topic}"
              + (" (entries purged)" if args.purge_replayed else ""))
        if not args.artifacts:
            return
    failed = False
    if args.fleet:
        # Every per-role artifact of the directory merged into ONE verdict
        # table; positional artifacts ride along in the report below.
        from attendance_tpu_torch.obs.slo import doctor_fleet_report

        try:
            text, ok = doctor_fleet_report(
                args.fleet, fpr_ceiling=args.fpr_ceiling,
                hll_error_ceiling=args.hll_error_ceiling,
                snapshot_stall_ceiling=args.snapshot_stall_ceiling,
                max_reconnects=args.max_reconnects,
                lane_skew_ceiling=args.lane_skew_ceiling,
                query_p99_ceiling=args.query_p99_ceiling,
                staleness_ceiling=args.staleness_ceiling,
                merge_lag_ceiling=args.merge_lag_ceiling,
                watermark_lag_ceiling=args.watermark_lag_ceiling,
                recompile_ceiling=args.recompile_ceiling)
        except FileNotFoundError as e:
            logger.error("no such fleet artifact dir: %s", e)
            sys.exit(2)
        except Exception as e:
            logger.error("unreadable fleet artifacts: %s", e)
            sys.exit(2)
        print(text)
        if (not args.artifacts and not args.quarantine and not args.scrub
                and not args.incident and not args.actuations):
            sys.exit(0 if ok else 1)
        failed = failed or not ok
    if args.scrub:
        # The run's own durable artifacts (chains, spill, quarantine)
        # must verify.
        from attendance_tpu_torch.utils.integrity import scrub_report

        try:
            text, ok = scrub_report(args.scrub)
        except FileNotFoundError as e:
            logger.error("no such scrub target: %s", e)
            sys.exit(2)
        print(text)
        if (not args.artifacts and not args.quarantine and not args.incident
                and not args.actuations):
            sys.exit(0 if ok and not failed else 1)
        failed = failed or not ok
    if args.incident:
        # The bundle must be complete, digest-verified and diagnosed.
        from attendance_tpu_torch.obs.incident import incident_report

        try:
            # With --actuations alongside, each diagnosed bundle also
            # reports whether the controller's recorded actuation matched
            # the top-ranked rule's action id.
            text, ok = incident_report(
                args.incident, actuation_log=args.actuations or None)
        except FileNotFoundError as e:
            logger.error("no such incident bundle: %s", e)
            sys.exit(2)
        except Exception as e:
            logger.error("unreadable incident bundle: %s", e)
            sys.exit(2)
        print(text)
        if not args.artifacts and not args.quarantine and not args.actuations:
            sys.exit(0 if ok and not failed else 1)
        failed = failed or not ok
    if args.actuations:
        # Every control-plane actuation must be schema-valid with
        # monotonic sequencing: a log that cannot be replayed cannot
        # explain the run.
        from attendance_tpu_torch.control.actuation import actuation_report

        if not Path(args.actuations).is_file():
            logger.error("no such actuation log: %s", args.actuations)
            sys.exit(2)
        text, ok = actuation_report(args.actuations)
        print(text)
        if not args.artifacts and not args.quarantine:
            sys.exit(0 if ok and not failed else 1)
        failed = failed or not ok
    if not args.artifacts and not args.quarantine:
        logger.error("doctor needs artifacts and/or --quarantine DIR")
        sys.exit(2)
    try:
        text, ok = doctor_report(
            args.artifacts, fpr_ceiling=args.fpr_ceiling,
            hll_error_ceiling=args.hll_error_ceiling,
            snapshot_stall_ceiling=args.snapshot_stall_ceiling,
            max_reconnects=args.max_reconnects,
            lane_skew_ceiling=args.lane_skew_ceiling,
            query_p99_ceiling=args.query_p99_ceiling,
            staleness_ceiling=args.staleness_ceiling,
            merge_lag_ceiling=args.merge_lag_ceiling,
            watermark_lag_ceiling=args.watermark_lag_ceiling,
            recompile_ceiling=args.recompile_ceiling,
            quarantine_dir=args.quarantine)
    except FileNotFoundError as e:
        logger.error("no such artifact: %s", e)
        sys.exit(2)
    except Exception as e:
        logger.error("unreadable artifacts: %s", e)
        sys.exit(2)
    print(text)
    if not ok or failed:
        sys.exit(1)


def cmd_scrub(args) -> None:
    """Offline integrity scrub: verify every durable artifact under the
    given directories against its recorded digest (structurally where
    none is recorded) and print the verdict table. Exit codes: 0 nothing
    corrupt (legacy and orphan rows are tolerated, as restore tolerates
    them), 1 at least one CORRUPT artifact, 2 an unreadable path."""
    from attendance_tpu_torch.utils.integrity import scrub_report

    try:
        text, ok = scrub_report(args.dirs)
    except FileNotFoundError as e:
        logger.error("no such scrub target: %s", e)
        sys.exit(2)
    print(text)
    if not ok:
        sys.exit(1)


def _follow_file(path: str, last: int, interval_s: float,
                 max_rounds=None) -> int:
    """Tail a telemetry artifact: re-render whenever the file grows or
    is atomically replaced (size and mtime change). Returns the number
    of renders; ``max_rounds`` bounds the loop (tests)."""
    import os
    import time

    from attendance_tpu_torch.obs.exposition import format_file

    renders = 0
    last_sig = None
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        rounds += 1
        try:
            st = os.stat(path)
            sig = (st.st_size, st.st_mtime_ns)
        except FileNotFoundError:
            sig = None
        if sig is not None and sig != last_sig:
            last_sig = sig
            try:
                body = format_file(path, last=last)
            except Exception as e:
                body = f"(unreadable mid-write: {e})"
            # Clear and home, then the fresh table: a live prom file
            # appends a block per interval, so this reads like `top`.
            print("\x1b[2J\x1b[H" + f"== {path} @ "
                  f"{time.strftime('%H:%M:%S')} ==\n" + body, flush=True)
            renders += 1
        if max_rounds is None or rounds < max_rounds:
            time.sleep(interval_s)
    return renders


def _add_telemetry_flags(p: argparse.ArgumentParser) -> None:
    d = Config()
    p.add_argument("--metrics-prom", default=d.metrics_prom,
                   help="append a Prometheus text-exposition block "
                   "per interval to this file (live telemetry)")
    p.add_argument("--metrics-port", type=int, default=d.metrics_port,
                   help="serve GET /metrics on this port "
                   "(0 = off, -1 = ephemeral)")
    p.add_argument("--metrics-interval-s", type=float,
                   default=d.metrics_interval_s,
                   help="reporter cadence for --metrics-prom")
    p.add_argument("--flight-recorder", type=int,
                   default=d.flight_recorder,
                   help="ring size of per-batch flight records "
                   "(0 = off); dumped on SIGUSR1 or run-loop crash")
    p.add_argument("--flight-path", default=d.flight_path,
                   help="JSON dump path for the flight recorder")
    p.add_argument("--trace-out", default=d.trace_out,
                   help="write per-batch spans as Chrome-trace/"
                   "Perfetto JSON here (empty = tracing off)")
    p.add_argument("--audit-sample", type=float, default=d.audit_sample,
                   help="exact-shadow accuracy audit over this hash-"
                   "sampled fraction of the key space (0 = off); "
                   "exports measured FPR / HLL-error gauges")
    p.add_argument("--metric-series-max", type=int,
                   default=d.metric_series_max,
                   help="label-cardinality cap per metric name "
                   "(<= 0 = no cap)")
    p.add_argument("--alert-log", default=d.alert_log,
                   help="enable the SLO burn-rate engine and append "
                   "one JSON line per alert transition here")
    p.add_argument("--slo", action="append", default=None,
                   metavar="SPEC",
                   help="extra/override SLO spec, repeatable (e.g. "
                   "'fpr<=0.01', 'throughput>=1e6', "
                   "'dequeue_p99<=0.05')")
    p.add_argument("--slo-fast-s", type=float, default=d.slo_fast_s,
                   help="fast burn-rate window (seconds)")
    p.add_argument("--slo-slow-s", type=float, default=d.slo_slow_s,
                   help="slow burn-rate window (seconds)")
    p.add_argument("--profile-hz", type=float, default=d.profile_hz,
                   help="host sampling-profiler rate (0 = off): "
                   "per-stage self-time attribution, collapsed-stack "
                   "flamegraph + Perfetto stage timeline under "
                   "--profile-out")
    p.add_argument("--profile-out", default=d.profile_out,
                   help="artifact dir for the sampling profiler "
                   "(profile.folded, profile_trace.json, "
                   "attribution.json)")
    p.add_argument("--incident-dir", default=d.incident_dir,
                   help="enable the incident engine and write one "
                   "checksummed evidence bundle per correlated breach "
                   "under this directory (empty = off)")
    p.add_argument("--incident-clear-ticks", type=int,
                   default=d.incident_clear_ticks,
                   help="consecutive clean ticks before an open "
                   "incident clears (hysteresis)")
    p.add_argument("--fleet-push", default=d.fleet_push,
                   help="push this process's telemetry (registry "
                   "snapshot + span batches) to a fleet collector at "
                   "HOST:PORT every --fleet-push-interval-s "
                   "(empty = off)")
    p.add_argument("--fleet-role", default=d.fleet_role,
                   help="role label for fleet pushes (default: the "
                   "CLI verb's role, else 'process')")
    p.add_argument("--fleet-instance", default=d.fleet_instance,
                   help="instance label for fleet pushes (default: "
                   "--fed-worker or pid<PID>)")
    p.add_argument("--fleet-push-interval-s", type=float,
                   default=d.fleet_push_interval_s,
                   help="fleet push cadence (seconds)")


def _add_fleet_collector_flags(p: argparse.ArgumentParser) -> None:
    """The collector's flags, only on ``federate`` (the verb that hosts
    one)."""
    d = Config()
    p.add_argument("--fleet-port", type=int, default=d.fleet_port,
                   help="run a fleet collector in this process on "
                   "this TCP port (0 = off, -1 = ephemeral); merged "
                   "views mount under /fleet/* on --metrics-port")
    p.add_argument("--fleet-dir", default=d.fleet_dir,
                   help="persist collected fleet artifacts (per-role "
                   "prom files, stitched trace, status snapshot) "
                   "here — the `doctor --fleet` input")


def _add_control_flags(p: argparse.ArgumentParser) -> None:
    """The control plane's flags, only on ``fused``: a controller
    attaches only to a fused pipeline built under the telemetry bundle,
    and ``fused`` is the one verb whose run builds one."""
    d = Config()
    p.add_argument("--control-log", default=d.control_log,
                   help="enable the self-driving control plane and "
                   "append its schema'd JSONL actuation log here "
                   "(replay with `doctor --actuations`)")
    p.add_argument("--control-spill-dir", default=d.control_spill_dir,
                   help="shed-rung admission spills raw ingress frames "
                   "durably here and acks them (empty = nack back to "
                   "the broker)")
    p.add_argument("--control-dwell-s", type=float,
                   default=d.control_dwell_s,
                   help="minimum seconds between controller moves on "
                   "the same knob / ladder rung")
    p.add_argument("--control-clear-ticks", type=int,
                   default=d.control_clear_ticks,
                   help="consecutive clean controller ticks before "
                   "de-escalation")
    p.add_argument("--control-flap-limit", type=int,
                   default=d.control_flap_limit,
                   help="max degradation-ladder transitions per "
                   "rolling minute before the controller holds")


def _control_config(args) -> dict:
    """Config fields of the control flags (``_add_control_flags``); none
    for a verb without them."""
    if not hasattr(args, "control_log"):
        return {}
    return dict(control_log=args.control_log,
                control_spill_dir=args.control_spill_dir,
                control_dwell_s=args.control_dwell_s,
                control_clear_ticks=args.control_clear_ticks,
                control_flap_limit=args.control_flap_limit)


def _add_profile_dir_flag(p: argparse.ArgumentParser) -> None:
    """``--profile-dir``, only on the verbs whose run reads it: ``fused``
    and the processor's ``process`` and ``pipeline``."""
    p.add_argument("--profile-dir", default=Config().profile_dir,
                   help="write a torch.profiler trace of the run here "
                   "(CUDA activity included on a card): "
                   "torch_trace.json")


def _add_fed_flags(p: argparse.ArgumentParser) -> None:
    d = Config()
    p.add_argument("--fed-worker", default=d.fed_worker,
                   help="federated worker id; empty = federation off "
                   "(attendance_tpu_torch/federation)")
    p.add_argument("--fed-shard", type=int, default=d.fed_shard,
                   help="hash shard of the key space this worker owns")
    p.add_argument("--fed-shards", type=int, default=d.fed_shards,
                   help="total shards in the federation")
    p.add_argument("--fed-gossip-topic", default=d.fed_gossip_topic,
                   help="broker topic carrying the fence-gossip merge "
                   "frames")
    p.add_argument("--fed-gossip-broker", default=d.fed_gossip_broker,
                   help="socket broker HOST:PORT for gossip (empty = "
                   "ride the configured transport)")
    p.add_argument("--fed-heartbeat-s", type=float,
                   default=d.fed_heartbeat_s,
                   help="gossip heartbeat cadence between fences "
                   "(0 = none)")
    p.add_argument("--fed-dead-after-s", type=float,
                   default=d.fed_dead_after_s,
                   help="silence budget before the aggregator declares "
                   "a peer dead and recovers its shard")


def _add_serve_flags(p: argparse.ArgumentParser) -> None:
    d = Config()
    p.add_argument("--serve-port", type=int, default=d.serve_port,
                   help="serve the query plane (BF.EXISTS/PFCOUNT/"
                   "occupancy/rate/window verbs from the epoch-pinned "
                   "read mirror) on this binary RPC port (0 = off, -1 = "
                   "ephemeral)")
    p.add_argument("--query-batch-max", type=int, default=d.query_batch_max,
                   help="largest key/day batch one query RPC may carry")
    p.add_argument("--read-staleness-ceiling-s", type=float,
                   default=d.read_staleness_ceiling_s,
                   help="objective on the published read epoch's age, "
                   "reported by the stats verb (0 = none)")


def _add_ingress_flags(p: argparse.ArgumentParser) -> None:
    d = Config()
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--batch-timeout-s", type=float,
                   default=d.batch_timeout_s)
    p.add_argument("--ingress-lanes", type=int, default=d.ingress_lanes,
                   help="striped ingress lanes feeding the fused pipeline "
                   "(0 = one consumer; N >= 1 runs N broker sessions with "
                   "a decode thread each)")
    p.add_argument("--lane-queue-depth", type=int,
                   default=d.lane_queue_depth,
                   help="decoded blocks buffered per ingress lane before "
                   "its thread backpressures the broker")
    p.add_argument("--lane-decode", choices=["auto", "native", "vector"],
                   default=d.lane_decode,
                   help="lane JSON decode engine (auto = the CPython list "
                   "scan, or the native buffer scan where the interpreter "
                   "has no Python.h, ATP_NATIVE=0 the numpy scan; native = "
                   "the list scan alone, which raises without Python.h; "
                   "vector = the numpy scan)")
    p.add_argument("--ingress-wire",
                   choices=["auto", "json", "binary", "columnar", "shm"],
                   default=d.ingress_wire,
                   help="auto sniffs each broker payload's wire; shm reads "
                   "the shared-memory ring under --shm-dir instead of a "
                   "broker (co-located producers)")
    p.add_argument("--shm-dir", default=d.shm_dir,
                   help="ring-file directory of --ingress-wire=shm (one "
                   "ring per ingress lane; /dev/shm for a memory-backed "
                   "ring)")
    p.add_argument("--shm-slots", type=int, default=d.shm_slots,
                   help="slots per shm ring (the published-but-unacked "
                   "backpressure window)")
    p.add_argument("--shm-slot-bytes", type=int, default=d.shm_slot_bytes,
                   help="bytes per shm ring slot (must fit one planar "
                   "frame: 20 B/event + 8)")


def _add_transport_flags(p: argparse.ArgumentParser) -> None:
    d = Config()
    p.add_argument("--transport-backend",
                   choices=["memory", "socket", "pulsar"],
                   default=d.transport_backend,
                   help="socket = a BrokerServer shared by processes "
                   "(python -m attendance_tpu_torch.transport."
                   "socket_broker); pulsar = a Pulsar service at "
                   "--pulsar-host (needs pulsar-client)")
    p.add_argument("--socket-broker", default=d.socket_broker,
                   help="BrokerServer address for --transport-backend "
                   "socket")
    p.add_argument("--pulsar-host", default=d.pulsar_host)
    p.add_argument("--pulsar-topic", default=d.pulsar_topic)
    p.add_argument("--quarantine-dir", default=d.quarantine_dir,
                   help="write dead-lettered frames here before the ack "
                   "(empty = drop)")
    p.add_argument("--retry-budget-s", type=float,
                   default=d.retry_budget_s,
                   help="reconnect and retry window of one broker RPC "
                   "before BrokerUnavailable")


def _add_chaos_flags(p: argparse.ArgumentParser) -> None:
    """The fault plane's flags, on a verb that opens a broker client."""
    d = Config()
    p.add_argument("--chaos", default=d.chaos,
                   help="deterministic fault-injection spec, e.g. "
                   "'drop=0.01,delay=5ms:0.05,conn_reset=0.002,"
                   "persist_fail=0.01,writer_stall=200ms:0.01,"
                   "corrupt=0.001' ('off' = plane installed, never "
                   "fires; empty = no plane)")
    p.add_argument("--chaos-seed", type=int, default=d.chaos_seed,
                   help="master seed of the per-(site, fault) fault "
                   "streams: a failing chaos run replays from its seed")


def _add_persist_flags(p: argparse.ArgumentParser) -> None:
    """The persist sink's circuit breaker, on a verb with a sink."""
    d = Config()
    p.add_argument("--persist-spill-dir", default=d.persist_spill_dir,
                   help="enable the persist sink's circuit breaker and "
                   "spill degraded writes to fsync'd files here")
    p.add_argument("--persist-breaker-failures", type=int,
                   default=d.persist_breaker_failures,
                   help="consecutive persist failures that open the "
                   "circuit")
    p.add_argument("--persist-breaker-cooldown-s", type=float,
                   default=d.persist_breaker_cooldown_s,
                   help="seconds an open circuit waits before the "
                   "half-open probe")


def _add_store_flags(p: argparse.ArgumentParser) -> None:
    """The flags of the generic-store verbs."""
    d = Config()
    _add_transport_flags(p)
    p.add_argument("--device", default=None,
                   help="torch device of the card store (default: the "
                   "CUDA card; 'cpu' runs the kernels' plain PyTorch "
                   "versions)")
    p.add_argument("--sketch-backend",
                   choices=["redis", "tpu", "memory", "redis-sim"],
                   default=d.sketch_backend,
                   help="backend of BF.*/PFADD/PFCOUNT: tpu = the card "
                   "store; redis-sim = the hermetic simulation of "
                   "Redis's algorithms, the server-free parity oracle")
    p.add_argument("--storage-backend",
                   choices=["memory", "columnar", "cassandra"],
                   default=d.storage_backend)
    p.add_argument("--redis-host", default=d.redis_host)
    p.add_argument("--redis-port", type=int, default=d.redis_port)
    p.add_argument("--cassandra-hosts", default=",".join(d.cassandra_hosts))
    p.add_argument("--cassandra-keyspace", default=d.cassandra_keyspace)
    p.add_argument("--bloom-error-rate", type=float,
                   default=d.bloom_filter_error_rate)
    p.add_argument("--bloom-capacity", type=int,
                   default=d.bloom_filter_capacity)
    p.add_argument("--bloom-layout", choices=["flat", "blocked"],
                   default=d.bloom_layout)
    p.add_argument("--hll-key-prefix", default=d.hll_key_prefix)
    p.add_argument("--hll-precision", type=int, default=d.hll_precision)
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--batch-timeout-s", type=float,
                   default=d.batch_timeout_s)
    p.add_argument("--snapshot-dir", default=d.snapshot_dir)
    p.add_argument("--snapshot-every-batches", type=int,
                   default=d.snapshot_every_batches)
    p.add_argument("--snapshot-mode", choices=["barrier", "delta"],
                   default=d.snapshot_mode)
    p.add_argument("--snapshot-compact-every", type=int,
                   default=d.snapshot_compact_every)
    p.add_argument("--invalid-topic", default=d.invalid_topic,
                   help="side topic the processor republishes computed-"
                   "invalid events to (empty = off)")
    p.add_argument("--max-redeliveries", type=int,
                   default=d.max_redeliveries)
    p.add_argument("--metrics-json", default=d.metrics_json,
                   help="append one JSON metrics line per processor run "
                   "to this file")


def _add_bloom_key_flag(p: argparse.ArgumentParser) -> None:
    """``--bloom-filter-key``, on the verbs whose runs read it: the
    generator preloads the roster under it, the processor validates
    against it."""
    p.add_argument("--bloom-filter-key", default=Config().bloom_filter_key,
                   help="sketch-store key of the roster's Bloom filter")


def _add_generate_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num-students", type=int, default=1000)
    p.add_argument("--num-invalid", type=int, default=50)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--throttle-s", type=float, default=0.0,
                   help="per-record sleep (reference behavior: 0.1-0.5)")
    p.add_argument("--disorder-frac", type=float, default=0.0,
                   help="fraction of events emitted out of order (arrival "
                   "delayed by up to --late-max-s of event time)")
    p.add_argument("--late-max-s", type=float, default=0.0,
                   help="max event-time lateness for --disorder-frac "
                   "events (seconds)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m attendance_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("fused", help="hermetic hot-path run: bulk binary "
                       "loadgen -> fused pipeline -> insights and PFCOUNT "
                       "per lecture")
    f.add_argument("--num-events", type=int, default=1 << 20)
    f.add_argument("--frame-size", type=int, default=1 << 17)
    f.add_argument("--num-lectures", type=int, default=16)
    f.add_argument("--seed", type=int, default=0)
    _add_transport_flags(f)
    _add_chaos_flags(f)
    _add_persist_flags(f)
    f.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                   "the kernels' plain PyTorch versions)")
    d = Config()
    f.add_argument("--bloom-capacity", type=int,
                   default=d.bloom_filter_capacity)
    f.add_argument("--bloom-error-rate", type=float,
                   default=d.bloom_filter_error_rate)
    f.add_argument("--hll-precision", type=int, default=d.hll_precision)
    f.add_argument("--wire-format", default=d.wire_format,
                   choices=("auto", "delta", "seg", "word", "bytes"),
                   help="host->device wire of the fused step: auto adapts "
                   "per frame (word -> seg -> delta on backpressure; on "
                   "one card with the native host pack); delta (db "
                   "bits/event) and seg (kb bits/event) are the narrow "
                   "wires, on a mesh one packed buffer a replica; word "
                   "packs the bank into the key's high bits; bytes is the "
                   "(4 + w) byte wire (no effect on a mesh). ATP_NATIVE=0 "
                   "selects the numpy host pack")
    f.add_argument("--temporal-period-s", type=float,
                   default=d.temporal_period_s,
                   help="bucket width of the temporal sketch plane in "
                   "seconds (>= 1; 0 = temporal plane off): windowed "
                   "HLL banks per (lecture day, period), watermarked "
                   "reorder, CMS gate-fraud detector")
    f.add_argument("--allowed-lateness-s", "--allowed-lateness",
                   type=float, default=d.allowed_lateness_s,
                   dest="allowed_lateness_s", metavar="SECONDS",
                   help="event-time lateness budget: the watermark "
                   "trails the stream head by this much")
    f.add_argument("--watermark-idle-s", type=float,
                   default=d.watermark_idle_s,
                   help="wall-clock silence after which the watermark "
                   "advances to the stream head (0 = only end-of-run)")
    f.add_argument("--temporal-ring-banks", type=int,
                   default=d.temporal_ring_banks,
                   help="bucket rows the temporal ring retains; "
                   "pressure evicts the oldest CLOSED bucket")
    f.add_argument("--cms-depth", type=int, default=d.cms_depth,
                   help="Count-Min rows (fraud detector)")
    f.add_argument("--cms-width", type=int, default=d.cms_width,
                   help="Count-Min buckets per row")
    f.add_argument("--cms-topk", type=int, default=d.cms_topk,
                   help="heavy-hitter candidates tracked")
    f.add_argument("--snapshot-dir", default=d.snapshot_dir,
                   help="checkpoint directory: restore from it on start, "
                   "snapshot into it at ack barriers (empty = off)")
    f.add_argument("--snapshot-every-batches", type=int,
                   default=d.snapshot_every_batches,
                   help="frames between barriers (<= 0: the default "
                   "cadence)")
    f.add_argument("--snapshot-mode", choices=("barrier", "delta"),
                   default=d.snapshot_mode,
                   help="delta = dirty-bank snapshots chained off a base "
                   "by an fsync'd manifest, acks group-committed per "
                   "durable delta; barrier = full sketch state per "
                   "snapshot")
    f.add_argument("--snapshot-compact-every", type=int,
                   default=d.snapshot_compact_every,
                   help="delta files per chain before the background "
                   "writer folds them into a full base snapshot")
    f.add_argument("--no-integrity", action="store_true",
                   help="skip payload-digest computation at the writer "
                   "(verification still runs where digests exist)")
    f.add_argument("--num-shards", type=int, default=d.num_shards,
                   help="sketch shards (sp) of the mesh: the filter and "
                   "the registers split by hash range")
    f.add_argument("--num-replicas", type=int, default=d.num_replicas,
                   help="data-parallel replicas (dp) of the mesh; over "
                   "processes under torchrun")
    f.add_argument("--replica-sync", choices=["step", "query"],
                   default=d.replica_sync,
                   help="HLL replica union cadence: per step, or "
                   "deferred to query/snapshot (the default)")
    f.add_argument("--max-redeliveries", type=int,
                   default=d.max_redeliveries)
    f.add_argument("--metrics-json", default=d.metrics_json,
                   help="append one JSON metrics line per run here")
    _add_ingress_flags(f)
    _add_serve_flags(f)
    _add_fed_flags(f)
    _add_telemetry_flags(f)
    _add_profile_dir_flag(f)
    _add_control_flags(f)
    f.set_defaults(fn=cmd_fused)
    a = sub.add_parser("analyze", help="batch insights over a saved store")
    _add_store_flags(a)
    a.add_argument("--events-file", default="",
                   help="snapshot directory, event segments directory, "
                   "one-shot npz or row-store JSONL to load first")
    a.set_defaults(fn=cmd_analyze)
    g = sub.add_parser("generate", help="produce synthetic swipe events")
    _add_store_flags(g)
    _add_bloom_key_flag(g)
    _add_chaos_flags(g)
    _add_generate_flags(g)
    g.set_defaults(fn=cmd_generate)
    pr = sub.add_parser("process", help="run the stream processor")
    _add_store_flags(pr)
    _add_bloom_key_flag(pr)
    _add_chaos_flags(pr)
    _add_persist_flags(pr)
    pr.add_argument("--max-events", type=int, default=None)
    pr.add_argument("--idle-timeout-s", type=float, default=None)
    _add_telemetry_flags(pr)
    _add_profile_dir_flag(pr)
    pr.set_defaults(fn=cmd_process)
    pl = sub.add_parser("pipeline", help="hermetic end-to-end run: "
                        "generate -> process -> analyze")
    _add_store_flags(pl)
    _add_bloom_key_flag(pl)
    _add_chaos_flags(pl)
    _add_persist_flags(pl)
    _add_generate_flags(pl)
    _add_telemetry_flags(pl)
    _add_profile_dir_flag(pl)
    pl.set_defaults(fn=cmd_pipeline)
    st = sub.add_parser(
        "stats", help="PFCOUNT + partition scan for one lecture, or a "
        "per-student record summary with --student-id")
    _add_store_flags(st)
    st.add_argument("lecture_id", nargs="?", default="",
                    help="lecture id, e.g. LECTURE_20260101")
    st.add_argument("--student-id", type=int, default=None,
                    help="per-student summary instead of a lecture scan")
    st.add_argument("--events-file", default="",
                    help="load events from a saved store file first")
    st.set_defaults(fn=cmd_stats)
    pa = sub.add_parser(
        "parity", help="differential card-store-vs-oracle accuracy check "
        "(--oracle sim is hermetic; --oracle redis needs a Redis Stack "
        "and exits 2 when none is reachable)")
    _add_store_flags(pa)
    pa.add_argument("--oracle", choices=["sim", "redis"], default="sim",
                    help="sim = hermetic Redis-algorithm simulation; "
                    "redis = live Redis Stack")
    pa.add_argument("--num-events", type=int, default=50_000)
    pa.add_argument("--roster-size", type=int, default=10_000)
    pa.add_argument("--num-lectures", type=int, default=4)
    pa.add_argument("--seed", type=int, default=0)
    pa.set_defaults(fn=cmd_parity)
    br = sub.add_parser(
        "bridge", help="JSON -> binary ingress bridge: drain the "
        "reference-wire JSON topic, repack micro-batches as planar frames "
        "on <topic>-binary for the fused pipeline")
    _add_transport_flags(br)
    _add_chaos_flags(br)
    br.add_argument("--out-topic", default="",
                    help="binary output topic (default <topic>-binary)")
    br.add_argument("--batch-size", type=int, default=d.batch_size)
    br.add_argument("--batch-timeout-s", type=float,
                    default=d.batch_timeout_s)
    br.add_argument("--max-redeliveries", type=int,
                    default=d.max_redeliveries)
    br.add_argument("--metrics-json", default=d.metrics_json)
    br.add_argument("--max-events", type=int, default=None)
    br.add_argument("--idle-timeout-s", type=float, default=1.0)
    _add_telemetry_flags(br)
    br.set_defaults(fn=cmd_bridge)
    sv = sub.add_parser(
        "serve", help="query-serving reader over a snapshot directory's "
        "base + delta chain: BF.EXISTS/PFCOUNT/occupancy/attendance-rate/"
        "window verbs on the --serve-port binary RPC, refreshing epochs "
        "as the ingest writer publishes")
    sv.add_argument("--snapshot-dir", default="",
                    help="the chain to serve (a fused pipeline's "
                    "--snapshot-dir)")
    _add_serve_flags(sv)
    sv.add_argument("--refresh-s", type=float, default=1.0,
                    help="chain-manifest poll cadence (read staleness = "
                    "barrier cadence + this)")
    sv.add_argument("--serve-seconds", type=float, default=None,
                    help="exit after this long (default: serve until "
                    "interrupted)")
    _add_telemetry_flags(sv)
    sv.set_defaults(fn=cmd_serve)
    fe = sub.add_parser(
        "federate", help="federation aggregator: fold the fence-gossip "
        "merge frames (Bloom OR / HLL max CRDT joins) into one view, fail "
        "over dead peers' shards, and serve federated BF.EXISTS/PFCOUNT/"
        "occupancy answers on --serve-port")
    _add_transport_flags(fe)
    _add_chaos_flags(fe)
    _add_serve_flags(fe)
    _add_fed_flags(fe)
    # The merged view's register width: the gossip of workers run with
    # the same --hll-precision.
    fe.add_argument("--hll-precision", type=int,
                    default=Config().hll_precision)
    fe.add_argument("--serve-seconds", type=float, default=None,
                    help="exit after this long (default: serve until "
                    "interrupted)")
    fe.add_argument("--stats-json", default="",
                    help="atomically publish the aggregator's state "
                    "(worker ledgers, shard map, fold counters) to this "
                    "JSON file every --stats-every-s")
    fe.add_argument("--stats-every-s", type=float, default=0.5,
                    help="cadence of --stats-json rewrites")
    _add_telemetry_flags(fe)
    _add_fleet_collector_flags(fe)
    fe.set_defaults(fn=cmd_federate)
    tel = sub.add_parser(
        "telemetry", help="pretty-print a flight-recorder dump, a "
        "--metrics-prom exposition file, or a --trace-out span trace "
        "as a live-style table / span tree")
    tel.add_argument("path", help="flight dump JSON, prom text, or "
                     "Chrome-trace JSON file")
    tel.add_argument("--last", type=int, default=32,
                     help="flight records / traces shown (most recent)")
    tel.add_argument("--attribution", action="store_true",
                     help="render a sampling-profiler attribution.json "
                     "(or a --profile-out dir) as the per-stage "
                     "self-time table")
    tel.add_argument("--follow", action="store_true",
                     help="tail a LIVE artifact: re-render the table "
                     "every time the file grows or is replaced, until "
                     "interrupted")
    tel.add_argument("--interval-s", type=float, default=0.5,
                     help="poll cadence for --follow")
    tel.set_defaults(fn=cmd_telemetry)
    fl = sub.add_parser(
        "fleet", help="fleet dashboard: per-role push liveness, "
        "headline counters, merge lag, staleness, firing alerts — "
        "live from a collector's /fleet/status (--http) or offline "
        "from a collected artifact dir (--dir); --snapshot-json "
        "writes the raw status document")
    fl.add_argument("--http", default="",
                    help="HOST:PORT of the collector process's "
                    "--metrics-port endpoint (the /fleet/* routes)")
    fl.add_argument("--dir", default="",
                    help="read a collected --fleet-dir offline instead "
                    "(FLEET.json)")
    fl.add_argument("--interval-s", type=float, default=2.0,
                    help="live refresh cadence")
    fl.add_argument("--once", action="store_true",
                    help="print one table and exit")
    fl.add_argument("--snapshot-json", default="", metavar="PATH",
                    help="write one raw status JSON snapshot ('-' = "
                    "stdout) and exit")
    fl.set_defaults(fn=cmd_fleet)
    _add_doctor_parser(sub)
    scr = sub.add_parser(
        "scrub", help="offline integrity scrub: walk snapshot-chain, "
        "spill, quarantine and event directories, verify every artifact "
        "against its recorded digest, and print a verdict table (exit 1 "
        "on any corruption, 2 on unreadable paths)")
    scr.add_argument("dirs", nargs="+", metavar="DIR",
                     help="directories to scrub (chain, spill, quarantine "
                     "or event directories, or workdirs holding several: "
                     "the artifact families are detected, subdirectories "
                     "included)")
    scr.set_defaults(fn=cmd_scrub)
    return p


def _add_doctor_parser(sub) -> None:
    """The ``doctor`` verb: the JAX package's parser."""
    doc = sub.add_parser(
        "doctor", help="offline SLO verdict over run artifacts "
        "(prom exposition / alert log / flight dump / trace export); "
        "lists/replays the dead-letter quarantine; "
        "exits 1 on breach, 2 on unreadable artifacts")
    _add_transport_flags(doc)  # they drive --replay-quarantine
    doc.add_argument("artifacts", nargs="*",
                     help="any mix of --metrics-prom, --alert-log, "
                     "flight-recorder, and --trace-out files")
    doc.add_argument("--fpr-ceiling", type=float, default=0.01,
                     help="measured Bloom FPR ceiling")
    doc.add_argument("--hll-error-ceiling", type=float, default=0.02,
                     help="measured HLL relative-error ceiling")
    doc.add_argument("--snapshot-stall-ceiling", type=float, default=None,
                     help="gate the snapshot_write/snapshot_blocked stage "
                     "p99 (seconds) recovered from the prom histograms; "
                     "omitted = informational only")
    doc.add_argument("--max-reconnects", type=int, default=None,
                     help="gate the broker-reconnect total from the prom "
                     "artifact; omitted = informational row")
    doc.add_argument("--lane-skew-ceiling", type=float, default=None,
                     help="gate the striped-ingress lane skew (worst lane "
                     "events / median lane events): 0.5 flags a lane "
                     "running under half the median; omitted = "
                     "informational row")
    doc.add_argument("--query-p99-ceiling", type=float, default=None,
                     help="gate the query-stage latency p99 (seconds) "
                     "recovered from the prom histograms; omitted = "
                     "informational row")
    doc.add_argument("--staleness-ceiling", type=float, default=None,
                     help="gate attendance_read_staleness_seconds (the "
                     "published read epoch's age at the last scrape); "
                     "omitted = informational row")
    doc.add_argument("--watermark-lag-ceiling-s", type=float, default=None,
                     dest="watermark_lag_ceiling",
                     help="gate attendance_watermark_lag_seconds; set only "
                     "for runs that ran the temporal plane (an absent "
                     "gauge fails loudly, never vacuously); omitted = "
                     "informational row")
    doc.add_argument("--recompile-ceiling", type=int, default=None,
                     help="gate attendance_recompiles_steady_total (new "
                     "kernel launch shapes AFTER the first completed run "
                     "loop: steady state must hold 0, a nonzero count "
                     "means unpadded shapes reach a kernel). Set only for "
                     "runs whose telemetry was on (an absent counter "
                     "fails loudly); omitted = informational row")
    doc.add_argument("--merge-lag-ceiling", type=float, default=None,
                     help="gate the federation merge-lag p99 (fence -> "
                     "folded-into-global-view seconds) recovered from the "
                     "prom histogram; omitted = informational row")
    doc.add_argument("--fleet", default="", metavar="DIR",
                     help="judge a directory of <role>@<instance>.prom "
                     "artifacts: per-role rows, plus fleet-wide merge-lag/"
                     "staleness gates over the merged data")
    doc.add_argument("--incident", default="", metavar="DIR",
                     help="replay an incident evidence bundle (or a "
                     "--incident-dir root of bundles) offline: verify "
                     "every evidence part against the digests in "
                     "incident.json and judge the diagnosis; exits 1 on "
                     "an undiagnosed open incident or a corrupt or "
                     "incomplete bundle")
    doc.add_argument("--actuations", default="", metavar="FILE",
                     help="replay a control-plane actuation log "
                     "(--control-log JSONL) offline: validate the schema "
                     "and sequencing of every recorded knob move and "
                     "print the actuation timeline; with --incident "
                     "alongside, also report whether the recorded "
                     "actuations matched each bundle's top-ranked "
                     "diagnosis action")
    doc.add_argument("--scrub", action="append", default=None,
                     metavar="DIR",
                     help="also run the offline integrity scrub over DIR "
                     "(repeatable) and fold its verdict into the exit "
                     "code: any CORRUPT artifact fails the run")
    doc.add_argument("--quarantine", default="",
                     help="list this on-disk dead-letter quarantine in the "
                     "verdict table")
    doc.add_argument("--replay-quarantine", action="store_true",
                     help="republish every quarantined frame onto the "
                     "configured --pulsar-topic via the configured "
                     "transport")
    doc.add_argument("--purge-replayed", action="store_true",
                     help="delete quarantine entries after a successful "
                     "replay publish")
    doc.set_defaults(fn=cmd_doctor)


def main(argv: Optional[list] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)
    if getattr(args, "num_shards", 1) * getattr(args, "num_replicas", 1) > 1:
        # Before any device access: a mesh's dp axis spans the processes
        # of a torchrun group. A no-op outside one.
        init_distributed()
    args.fn(args)
