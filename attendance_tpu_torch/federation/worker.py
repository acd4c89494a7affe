"""Runnable federation ingest worker (one shard of the key space).

    python -m attendance_tpu_torch.federation.worker \
        --worker w0 --shard 0 --num-shards 3 --broker HOST:PORT \
        --workdir DIR --num-events N --seed S [--takeover] [--device cpu] \
        [--metrics-prom FILE] [--trace-out FILE] [--fleet-push HOST:PORT]
        [--chaos SPEC] [--chaos-seed N]

Counterpart of ``attendance_tpu/federation/worker.py``. One worker is one
fused pipeline on the card (``--device``, by default the CUDA card; with
no card and no device given it raises) over one shard's topic
(``<base>.s<shard>``), checkpointing in delta mode into its own snapshot
directory and gossiping every fence to the broker. The deterministic
workload (:func:`build_workload`) is the JAX package's frames byte for
byte, so a benchmark or an oracle regenerates exactly what a worker
consumed.

``--takeover`` starts the worker as the successor of a dead peer: the
SAME worker id, snapshot directory, shard topic and subscription (the
pipeline restores the dead peer's durable chain on construction, and the
broker has requeued every frame the peer left unacked), and the dead
peer's quarantine replayed onto the shard topic before consuming. Its
higher incarnation makes the aggregator take its counters over the dead
peer's; the old incarnation's late frames are stale and never counted.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

from attendance_tpu_torch import chaos as chaos_mod
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.federation.shard import shard_of_keys, shard_topic
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import (
    frame_from_columns, synth_columns)
from attendance_tpu_torch.transport.quarantine import list_entries, replay

DEFAULT_ROSTER = 20_000
DEFAULT_LECTURES = 6
DEFAULT_BATCH = 8_192


def full_roster(seed: int,
                roster_size: int = DEFAULT_ROSTER) -> np.ndarray:
    """The federation's whole roster, from ``seed`` alone: every shard,
    benchmark and oracle regenerates the same one (the id range of
    ``loadgen.generate_frames``)."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.arange(10_000, 10_000 + 4 * roster_size,
                                dtype=np.uint32),
                      size=roster_size, replace=False)


def build_workload(seed: int, shard: int, num_shards: int,
                   num_events: int, roster_size: int = DEFAULT_ROSTER,
                   num_lectures: int = DEFAULT_LECTURES,
                   batch: int = DEFAULT_BATCH
                   ) -> Tuple[np.ndarray, np.ndarray, List[bytes]]:
    """(full roster, the shard's roster, frames): the shard's workload.
    The shard's roster is the hash partition of the full one and its
    frames draw valid ids only from it, so the shards together are one
    run over the whole population."""
    full = full_roster(seed, roster_size)
    mine = full[shard_of_keys(full, num_shards) == shard]
    if not len(mine):
        raise ValueError(
            f"shard {shard}/{num_shards} drew an empty roster slice "
            f"from {roster_size} students — grow the roster")
    invalid_base = max(100_000, 10_000 + 4 * roster_size)
    srng = np.random.default_rng(seed * 1_000_003 + shard + 1)
    frames, left = [], num_events
    while left > 0:
        n = min(batch, left)
        frames.append(frame_from_columns(synth_columns(
            srng, n, mine, num_lectures, invalid_fraction=0.1,
            invalid_base=invalid_base)))
        left -= n
    return full, mine, frames


def make_worker_config(worker: str, shard: int, num_shards: int,
                       broker: str, workdir, *, base_topic: str,
                       data_plane: str = "socket",
                       snapshot_every: int = 4,
                       gossip_topic: str = "", metrics_prom: str = "",
                       trace_out: str = "", fleet_push: str = "",
                       chaos: str = "", chaos_seed: int = 0) -> Config:
    workdir = Path(workdir)
    kw = {"fed_gossip_topic": gossip_topic} if gossip_topic else {}
    return Config(
        transport_backend=("socket" if data_plane == "socket"
                           else "memory"),
        socket_broker=broker,
        pulsar_topic=shard_topic(base_topic, shard),
        snapshot_dir=str(workdir / f"chain-{shard}"),
        snapshot_every_batches=snapshot_every,
        snapshot_mode="delta",
        quarantine_dir=str(workdir / f"quarantine-{shard}"),
        fed_worker=worker, fed_shard=shard, fed_shards=num_shards,
        fed_gossip_broker=broker,
        # Each worker process gets its own seeded injector.
        chaos=chaos, chaos_seed=chaos_seed,
        metrics_prom=metrics_prom, trace_out=trace_out,
        # The worker pushes its registry and spans to the fleet
        # collector, so the aggregator's pane of glass and doctor --fleet
        # see every shard.
        fleet_push=fleet_push, fleet_role="worker", fleet_instance=worker,
        **kw)


def final_full_frame(pipe) -> None:
    """The worker's end-of-run full frame, the federation's convergence
    anchor. A chaos ``partition`` at ``fed.gossip`` swallows frames
    silently: while a window is open, wait it out and re-assert (full
    frames are idempotent joins)."""
    pipe.fed_flush()
    inj = chaos_mod.get()
    if inj is None or inj.spec.partition <= 0:
        return
    for _ in range(20):
        if not inj.in_blackhole("fed.gossip"):
            return
        time.sleep(inj.spec.partition_s + 0.05)
        pipe.fed_flush()


def run_worker(args) -> dict:
    config = make_worker_config(
        args.worker, args.shard, args.num_shards, args.broker,
        args.workdir, base_topic=args.topic,
        data_plane=args.data_plane,
        snapshot_every=args.snapshot_every,
        gossip_topic=args.gossip_topic, metrics_prom=args.metrics_prom,
        trace_out=args.trace_out, fleet_push=args.fleet_push,
        chaos=args.chaos,
        chaos_seed=args.chaos_seed)
    full, mine, frames = build_workload(
        args.seed, args.shard, args.num_shards, args.num_events,
        roster_size=args.roster_size, batch=args.batch)
    pipe = FusedPipeline(config, num_banks=16, device=args.device)
    try:
        if args.takeover:
            # The constructor restored the dead peer's chain (same
            # snapshot directory). Redelivery covers its unacked frames
            # and the chain its acked ones; the quarantine is the only
            # other place state can live: replay it onto the topic.
            qdir = config.quarantine_dir
            if qdir and list_entries(qdir):
                producer = pipe.client.create_producer(
                    config.pulsar_topic)
                n = replay(qdir, producer, remove=True)
                print(f"[{args.worker}] replayed {n} quarantined "
                      "frame(s)", file=sys.stderr, flush=True)
        else:
            pipe.preload(mine)
        warmup = 0
        if args.data_plane == "memory" and not args.takeover:
            # A memory-plane takeover must not re-feed the workload: the
            # restored chain carries everything durable, and an
            # in-process broker has no requeued remainder.
            producer = pipe.client.create_producer(config.pulsar_topic)
            if len(frames) > 1:
                # One frame before the go-gate: the first dispatch pays
                # the process's first-run costs, which must not be
                # charged to the window the go-file lines up across workers.
                producer.send(frames[0])
                warmup = min(args.batch, args.num_events)
                pipe.run(max_events=warmup, idle_timeout_s=5.0)
                frames = frames[1:]
            for f in frames:
                producer.send(f)
        if args.ready_file:
            Path(args.ready_file).touch()
        if args.go_file:
            deadline = time.time() + 120
            while not Path(args.go_file).exists():
                if time.time() > deadline:
                    raise RuntimeError("go-file never appeared")
                time.sleep(0.02)
        t0 = time.time()
        pipe.run(max_events=args.max_events or None,
                 idle_timeout_s=args.idle_timeout_s)
        wall = time.time() - t0
        # The final fence: everything durable (the last group commit
        # released), then one full frame, so the aggregator holds this
        # worker's final state before the process exits.
        pipe.snapshot()
        final_full_frame(pipe)
        measured = pipe.metrics.events - warmup
        return {
            "worker": args.worker, "shard": args.shard,
            "events": pipe.metrics.events,
            "measured_events": measured,
            "wall_s": round(wall, 4),
            "events_per_sec": round(measured / wall, 1)
            if wall > 0 else 0.0,
            "takeover": bool(args.takeover),
            "restore_s": pipe.metrics.restore_seconds,
            "device": str(pipe.device),
        }
    finally:
        pipe.cleanup()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="federation ingest worker")
    p.add_argument("--worker", required=True)
    p.add_argument("--shard", type=int, required=True)
    p.add_argument("--num-shards", type=int, required=True)
    p.add_argument("--broker", required=True,
                   help="socket broker HOST:PORT (data plane when "
                   "--data-plane=socket, gossip always)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--topic", default="attendance-events")
    p.add_argument("--gossip-topic", default="",
                   help="merge-frame gossip topic (default: the "
                   "config default)")
    p.add_argument("--num-events", type=int, default=1 << 18)
    p.add_argument("--max-events", type=int, default=0,
                   help="stop after this many processed events "
                   "(0 = run until idle)")
    p.add_argument("--idle-timeout-s", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--roster-size", type=int, default=DEFAULT_ROSTER)
    p.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    p.add_argument("--snapshot-every", type=int, default=4)
    p.add_argument("--data-plane", choices=["socket", "memory"],
                   default="socket",
                   help="socket = consume the shard topic from the "
                   "broker (failover semantics); memory = self-feed "
                   "frames in-process (the ingest-scaling shape; gossip "
                   "still rides the broker)")
    p.add_argument("--takeover", action="store_true",
                   help="start as the failover successor of a dead "
                   "peer (restore its chain, replay its quarantine, "
                   "drain its requeued frames)")
    p.add_argument("--ready-file", default="")
    p.add_argument("--go-file", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' "
                   "runs the kernels' plain PyTorch versions)")
    p.add_argument("--metrics-prom", default="",
                   help="append Prometheus exposition blocks of this "
                   "worker's telemetry here")
    p.add_argument("--trace-out", default="",
                   help="write this worker's spans here as Chrome-trace "
                   "JSON; its gossip frames then carry the fence span's "
                   "traceparent")
    p.add_argument("--fleet-push", default="",
                   help="fleet collector HOST:PORT to push telemetry "
                   "to (role=worker, instance=--worker)")
    p.add_argument("--chaos", default="",
                   help="chaos spec for this worker process (e.g. "
                   "'partition=1500ms:0.05')")
    p.add_argument("--chaos-seed", type=int, default=0)
    return p


def main(argv=None) -> None:
    report = run_worker(build_parser().parse_args(argv))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
