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
  refreshing as the ingest writer makes new state durable.

``fused`` also takes ``--ingress-lanes N`` (striped ingress lanes),
``--ingress-wire shm`` (the shared-memory ring under ``--shm-dir``) and
``--serve-port`` (the in-process query plane over the read mirror).

Every verb takes ``--transport-backend {memory,socket}`` (``socket``: a
BrokerServer at ``--socket-broker``, started with ``python -m
attendance_tpu_torch.transport.socket_broker``). Runs on the CUDA card
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

from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.analyzer import AttendanceAnalyzer
from attendance_tpu_torch.pipeline.bridge import JsonBinaryBridge
from attendance_tpu_torch.pipeline.fast_path import (
    EVENTS_SEGMENTS, EVENTS_SNAPSHOT, FusedPipeline)
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


def cmd_fused(args) -> None:
    config = Config(bloom_filter_capacity=args.bloom_capacity,
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
                    **_transport_config(args), **_ingress_config(args),
                    **_serve_config(args))
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
    """Config fields of the transport flags (``_add_transport_flags``)."""
    return dict(transport_backend=args.transport_backend,
                socket_broker=args.socket_broker,
                pulsar_topic=args.pulsar_topic,
                quarantine_dir=args.quarantine_dir,
                retry_budget_s=args.retry_budget_s)


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
        snapshot_compact_every=args.snapshot_compact_every)


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
                    **_transport_config(args))
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

    config = Config(snapshot_dir=args.snapshot_dir, **_serve_config(args))
    if not config.snapshot_dir:
        logger.error("serve needs --snapshot-dir (the chain to read)")
        sys.exit(2)
    try:
        source = ChainEpochSource(config.snapshot_dir,
                                  refresh_s=args.refresh_s).start()
    except FileNotFoundError as e:
        logger.error("no snapshot chain to serve: %s", e)
        sys.exit(2)
    engine = QueryEngine(
        source, batch_max=config.query_batch_max,
        staleness_ceiling_s=config.read_staleness_ceiling_s or None)
    port = config.serve_port
    server = QueryServer(engine, port=0 if port < 0 else port).start()
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
                   help="lane JSON decode engine (auto = the native buffer "
                   "scan, ATP_NATIVE=0 the numpy scan; vector = the numpy "
                   "scan; native, the JAX package's list scan, is not in "
                   "the port and raises)")
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
    p.add_argument("--transport-backend", choices=["memory", "socket"],
                   default=d.transport_backend,
                   help="socket = a BrokerServer shared by processes "
                   "(python -m attendance_tpu_torch.transport."
                   "socket_broker)")
    p.add_argument("--socket-broker", default=d.socket_broker,
                   help="BrokerServer address for --transport-backend "
                   "socket")
    p.add_argument("--pulsar-topic", default=d.pulsar_topic)
    p.add_argument("--quarantine-dir", default=d.quarantine_dir,
                   help="write dead-lettered frames here before the ack "
                   "(empty = drop)")
    p.add_argument("--retry-budget-s", type=float,
                   default=d.retry_budget_s,
                   help="reconnect and retry window of one broker RPC "
                   "before BrokerUnavailable")


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
                   "per frame (word -> seg -> delta on backpressure, with "
                   "the native host pack); delta (db bits/event) and seg "
                   "(kb bits/event) are the narrow wires; word packs the "
                   "bank into the key's high bits; bytes is the (4 + w) "
                   "byte wire. ATP_NATIVE=0 selects the numpy host pack")
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
    _add_ingress_flags(f)
    _add_serve_flags(f)
    f.set_defaults(fn=cmd_fused)
    a = sub.add_parser("analyze", help="batch insights over a saved store")
    _add_store_flags(a)
    a.add_argument("--events-file", default="",
                   help="snapshot directory, event segments directory, "
                   "one-shot npz or row-store JSONL to load first")
    a.set_defaults(fn=cmd_analyze)
    g = sub.add_parser("generate", help="produce synthetic swipe events")
    _add_store_flags(g)
    _add_generate_flags(g)
    g.set_defaults(fn=cmd_generate)
    pr = sub.add_parser("process", help="run the stream processor")
    _add_store_flags(pr)
    pr.add_argument("--max-events", type=int, default=None)
    pr.add_argument("--idle-timeout-s", type=float, default=None)
    pr.set_defaults(fn=cmd_process)
    pl = sub.add_parser("pipeline", help="hermetic end-to-end run: "
                        "generate -> process -> analyze")
    _add_store_flags(pl)
    _add_generate_flags(pl)
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
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[list] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)
