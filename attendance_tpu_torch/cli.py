"""Command line of the port: ``python -m attendance_tpu_torch fused``.

Counterpart of ``attendance_tpu/cli.py:cmd_fused``: a hermetic run of the
hot path in one process — bulk binary load generator -> in-process
broker -> FusedPipeline (roster preload, one fused kernel per frame,
and with ``--temporal-period-s > 0`` the temporal plane) -> PFCOUNT of
every lecture day; ``--wire-format`` picks the host->device wire. Runs
on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Tuple

from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import generate_frames


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
    config = Config(wire_format=args.wire_format,
                    temporal_period_s=args.temporal_period_s,
                    allowed_lateness_s=args.allowed_lateness_s,
                    watermark_idle_s=args.watermark_idle_s,
                    temporal_ring_banks=args.temporal_ring_banks,
                    cms_depth=args.cms_depth, cms_width=args.cms_width,
                    cms_topk=args.cms_topk)
    pipe, summary = run_fused(config, args.num_events, args.frame_size,
                              args.num_lectures, args.seed, args.device)
    pipe.cleanup()
    for day, n in summary.pop("unique_attendees").items():
        print(f"LECTURE_{day}: {n} unique attendees")
    print(json.dumps(summary))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m attendance_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("fused", help="hermetic hot-path run: bulk binary "
                       "loadgen -> fused pipeline -> PFCOUNT per lecture")
    f.add_argument("--num-events", type=int, default=1 << 20)
    f.add_argument("--frame-size", type=int, default=1 << 17)
    f.add_argument("--num-lectures", type=int, default=16)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                   "the kernels' plain PyTorch versions)")
    d = Config()
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
    f.set_defaults(fn=cmd_fused)
    return p


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
