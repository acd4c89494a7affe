"""Cross-process delta-snapshot crash recovery, with a real SIGKILL.

Counterpart of the JAX package's ``tools/delta_crash_smoke.py``:

1. a socket broker in a process of its own (``spawn_broker``);
2. a worker process (``python -m attendance_tpu_torch.chaos.delta_crash
   --worker``, on ``cuda:0`` unless given ``--device cpu``) running the
   fused pipeline with delta snapshots every 2 frames and its telemetry
   written to a prom file and an alert log;
3. the backlog published, and the worker SIGKILLed once its chain holds
   a delta;
4. a fresh pipeline in this process restores the chain and drains the
   frames the broker requeued (crash takeover); its state must equal an
   uninterrupted memory-broker run over the same frames;
5. ``python -m attendance_tpu_torch doctor <prom> <alerts>
   --snapshot-stall-ceiling S`` over the worker's artifacts must exit 0.

``python -m attendance_tpu_torch.chaos.delta_crash [--device cpu]`` runs
it at the JAX tool's sizes (65,536 events in 2,048-event frames) and
exits 0 on a pass.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from attendance_tpu_torch.chaos.soak import (
    REPO, await_ready, kill_at_first_delta, launches_since, reap,
    sketch_state, spawn_worker, state_diff, summary)
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.transport.socket_broker import (
    SocketClient, spawn_broker)

# The JAX tool's stream, seed, filter and doctor gate.
NUM_EVENTS, BATCH = 65_536, 2_048
SEED = 83
ROSTER, LECTURES, CAPACITY = 10_000, 8, 50_000
STALL_CEILING_S = 5.0
SNAPSHOT_EVERY = 2
MODULE = "attendance_tpu_torch.chaos.delta_crash"


def crash_frames(num_events: int = NUM_EVENTS, batch: int = BATCH,
                 roster_size: int = ROSTER, lectures: int = LECTURES):
    """(roster, frames): the JAX tool's backlog at its sizes."""
    roster, frames = generate_frames(num_events, batch,
                                     roster_size=roster_size,
                                     num_lectures=lectures,
                                     invalid_fraction=0.1, seed=SEED)
    return roster, list(frames)


def _config(broker: str, snap_dir, capacity: int, **kw) -> Config:
    return Config(bloom_filter_capacity=capacity, transport_backend="socket",
                  socket_broker=broker, snapshot_dir=str(snap_dir),
                  snapshot_mode="delta",
                  snapshot_every_batches=SNAPSHOT_EVERY, **kw)


def worker_main(args) -> None:
    """The half that is SIGKILLed: consume the broker with delta
    snapshots and telemetry until the parent kills it."""
    config = _config(args.broker, args.snapshot_dir, args.capacity,
                     metrics_prom=args.metrics_prom, metrics_interval_s=0.2,
                     alert_log=args.alert_log)
    roster, _ = crash_frames(args.num_events, args.batch, args.roster_size,
                             args.lectures)
    pipe = FusedPipeline(config, client=SocketClient(args.broker),
                         num_banks=args.lectures, device=args.device)
    pipe.preload(roster)
    # Ready once the telemetry's first block is on disk, so that a kill
    # however early leaves doctor an artifact to read.
    prom = Path(args.metrics_prom)
    deadline = time.monotonic() + 30.0
    while not prom.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    print("worker ready", flush=True)
    pipe.run(idle_timeout_s=60.0)


def run_delta_crash(*, workdir, device, num_events: int = NUM_EVENTS,
                    batch: int = BATCH, roster_size: int = ROSTER,
                    lectures: int = LECTURES, capacity: int = CAPACITY,
                    stall_ceiling_s: float = STALL_CEILING_S,
                    max_seconds: float = 120.0, idle_s: float = 3.0) -> Dict:
    """One crash and recovery on ``device``; returns the report
    (``report["ok"]`` is the verdict, ``report["failures"]`` its
    reasons). ``idle_s`` ends the restored run once the broker stays
    empty that long."""
    failures: List[str] = []

    def check(cond, label):
        if not cond:
            failures.append(label)

    t_start = time.monotonic()
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    snap, prom, alerts = (work / "snaps", work / "metrics.prom",
                          work / "alerts.jsonl")
    report: Dict = {"events": num_events}
    roster, frames = crash_frames(num_events, batch, roster_size, lectures)
    broker, addr = spawn_broker(cwd=REPO)
    worker = pipe = client = None
    try:
        worker = spawn_worker(MODULE, [
            "--worker", "--broker", addr, "--snapshot-dir", str(snap),
            "--metrics-prom", str(prom), "--alert-log", str(alerts),
            "--num-events", str(num_events), "--batch", str(batch),
            "--roster-size", str(roster_size), "--lectures", str(lectures),
            "--capacity", str(capacity)], device)
        if not await_ready(worker, max_seconds):
            check(False, "worker failed to start")
            return report
        client = SocketClient(addr)
        producer = client.create_producer(Config().pulsar_topic)
        for f in frames:
            producer.send(f)
        t_kill = time.monotonic()
        err = kill_at_first_delta(worker, snap, max_seconds, "delta-crash")
        if err:
            check(False, err)
            return report
        report["kill_after_s"] = time.monotonic() - t_kill
        report["chain_at_kill"] = json.loads((snap / "CHAIN.json").read_text())

        # Recover: restore, then drain what the broker requeued when the
        # killed worker's connection dropped.
        before = dict(kernels.launches)
        t_resume = time.monotonic()
        pipe = FusedPipeline(_config(addr, snap, capacity),
                             client=SocketClient(addr), num_banks=lectures,
                             device=device)
        report["killed_at_events"] = int(sum(pipe.validity_counts()))
        backlog = pipe.consumer.backlog()
        report["resume_backlog"] = backlog
        check(backlog > 0, "no unacked tail to redeliver (the kill landed "
                           "after the drain)")
        pipe.run(idle_timeout_s=idle_s)
        report["resume_s"] = time.monotonic() - t_resume
        report["restored_frames"] = pipe.metrics.batches
        got = sketch_state(pipe)
        report["restored_launches"] = launches_since(before)
        report["restored"] = summary(got)
        pipe.cleanup()
        pipe = None

        # The uninterrupted run over the same frames.
        before = dict(kernels.launches)
        oclient = MemoryClient(MemoryBroker())
        oracle = FusedPipeline(
            Config(bloom_filter_capacity=capacity,
                   transport_backend="memory"),
            client=oclient, num_banks=lectures, device=device)
        try:
            oracle.preload(roster)
            oproducer = oclient.create_producer(oracle.config.pulsar_topic)
            for f in frames:
                oproducer.send(f)
            oracle.run(max_events=num_events, idle_timeout_s=2.0)
            want = sketch_state(oracle)
        finally:
            oracle.cleanup()
        report["oracle_launches"] = launches_since(before)
        report["no_fault"] = summary(want)
        diff = state_diff(got, want)
        check(not diff, f"crash and restore differ from the uninterrupted "
                        f"run in {diff} (acked events lost or counted "
                        f"twice): {summary(got)} != {summary(want)}")

        # Doctor over the killed worker's artifacts, as an operator runs it.
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
        doctor = subprocess.run(
            [sys.executable, "-m", "attendance_tpu_torch", "doctor",
             str(prom), str(alerts), "--snapshot-stall-ceiling",
             str(stall_ceiling_s)], cwd=str(REPO), env=env,
            capture_output=True, text=True, timeout=max_seconds)
        report["doctor_rc"] = doctor.returncode
        check(doctor.returncode == 0,
              f"doctor exited {doctor.returncode}:\n{doctor.stdout}"
              f"{doctor.stderr}")
        return report
    finally:
        reap(worker)
        if pipe is not None:
            pipe.cleanup()
        if client is not None:
            client.close()
        broker.kill()
        broker.wait()
        report["wall_s"] = time.monotonic() - t_start
        report["failures"] = failures
        report["ok"] = not failures


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog=f"python -m {MODULE}",
        description="Delta-snapshot crash recovery with a real SIGKILL "
                    "(counterpart of the JAX package's "
                    "tools/delta_crash_smoke.py).")
    ap.add_argument("--workdir", default="delta-crash-work")
    ap.add_argument("--device", default="cuda:0",
                    help="the pipelines' device (cpu only for tests)")
    ap.add_argument("--num-events", type=int, default=NUM_EVENTS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--roster-size", type=int, default=ROSTER)
    ap.add_argument("--lectures", type=int, default=LECTURES)
    ap.add_argument("--capacity", type=int, default=CAPACITY)
    ap.add_argument("--stall-ceiling", type=float, default=STALL_CEILING_S,
                    help="doctor's snapshot-stall p99 gate, seconds")
    ap.add_argument("--max-seconds", type=float, default=120.0)
    # The worker's own entry point, started by the parent.
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--broker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--snapshot-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--metrics-prom", default="", help=argparse.SUPPRESS)
    ap.add_argument("--alert-log", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker_main(args)
        return 0
    report = run_delta_crash(
        workdir=args.workdir, device=args.device,
        num_events=args.num_events, batch=args.batch,
        roster_size=args.roster_size, lectures=args.lectures,
        capacity=args.capacity, stall_ceiling_s=args.stall_ceiling,
        max_seconds=args.max_seconds)
    print(json.dumps({k: v for k, v in report.items() if k != "failures"},
                     default=str))
    for line in report["failures"]:
        print(f"FAIL: {line}")
    print(f"{'PASS' if report['ok'] else 'FAIL'}: delta-snapshot crash "
          f"recovery and the doctor gate ({report['wall_s']} s)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
