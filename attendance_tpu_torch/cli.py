"""Command line of the port: ``python -m attendance_tpu_torch <verb>``.

Counterpart of ``attendance_tpu/cli.py``'s ``fused`` and ``analyze``
verbs. ``fused`` is a hermetic run of the hot path in one process: bulk
binary load generator -> in-process broker -> FusedPipeline (roster
preload, one fused kernel per frame, with ``--temporal-period-s > 0``
the temporal plane, with ``--snapshot-dir`` checkpoints and a restore
on start) -> the metrics summary (logged), the analyzer's insights, one
PFCOUNT line per lecture day, then one JSON line of the run's numbers.
``analyze`` prints the insights over a saved store (``--events-file``:
a snapshot directory, its event segments, or a one-shot npz). Runs on
the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Optional, Tuple

from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.analyzer import AttendanceAnalyzer
from attendance_tpu_torch.pipeline.fast_path import (
    EVENTS_SEGMENTS, EVENTS_SNAPSHOT, FusedPipeline)
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore

logger = logging.getLogger(__name__)


def run_fused(config: Config, num_events: int, frame_size: int,
              num_lectures: int, seed: int = 0,
              device=None) -> Tuple[FusedPipeline, dict]:
    """The fused verb's flow. Returns the pipeline (for further queries;
    the caller runs ``cleanup()``) and a summary of the run."""
    pipe = FusedPipeline(config, device=device)
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
                    integrity=not args.no_integrity)
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


def _store_for_events_file(path: str) -> ColumnarEventStore:
    """A columnar store loaded from ``path``: the fused pipeline's event
    segments (a snapshot directory, its segments directory, or the
    legacy ``fused_events.npz`` beside them, which never shadows them),
    or a one-shot npz from ``ColumnarEventStore.save``."""
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
    store = ColumnarEventStore()
    if seg_dir is not None:
        store.load_segments(seg_dir)
    else:
        store.load(p)
    return store


def cmd_analyze(args) -> None:
    store = (_store_for_events_file(args.events_file) if args.events_file
             else ColumnarEventStore())
    analyzer = AttendanceAnalyzer(store)
    try:
        analyzer.print_insights(analyzer.generate_insights())
    finally:
        analyzer.cleanup()


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
    f.set_defaults(fn=cmd_fused)
    a = sub.add_parser("analyze", help="batch insights over a saved store")
    a.add_argument("--events-file", default="",
                   help="snapshot directory, event segments directory or "
                   "one-shot npz to load first")
    a.set_defaults(fn=cmd_analyze)
    return p


def main(argv: Optional[list] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)
