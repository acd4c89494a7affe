"""Worker script and shared workloads of the port's multi-process mesh.

Run as a subprocess by tests/test_torch_multihost.py and by
chip_smoke.py's phase 10 (never collected by pytest: the name has no
``test_`` prefix):

    python tests/torch_multihost_worker.py <process_id> <num_processes> \\
        <port> <out_json> [<snap_dir>] [--device cpu|cuda] [--cells N] \\
        [--wire word|seg|delta]

Each process joins a gloo group over localhost TCP
(``parallel.multihost.init_distributed``), holds ``--cells`` grid cells
of ``--device`` (the CPU, or the card, which the processes then share)
and builds ``make_multihost_mesh(num_shards=cells)``: sp fills the
process's cells, dp spans the processes, so the preload's OR, the
register max of every PFCOUNT and state read, the counters' sum and the
per-step validity gather all cross processes. Every process feeds the
same full batches (the multi-controller convention of
tests/multihost_worker.py, whose workloads these are, on the port) and
writes its facts as JSON for the caller to compare with one process's
answer and the JAX package's.
"""

import argparse
import hashlib
import json
import time


def run_workload(mesh) -> dict:
    """tests/multihost_worker.py ``run_workload`` on the port's engine:
    a roster of 20,000, four mixed batches of 4,096 alternating the
    arrays step and the word wire, then PFCOUNTs, a membership probe and
    the state's digests."""
    import numpy as np

    from attendance_tpu_torch.parallel import ShardedSketchEngine

    engine = ShardedSketchEngine(
        mesh, capacity=20_000, error_rate=0.01, num_banks=8,
        precision=14, layout="blocked", replica_sync="query")
    rng = np.random.default_rng(42)
    roster = np.arange(10_000, 30_000, dtype=np.uint32)
    engine.preload(roster)
    nvalid_total = 0
    total = 0
    exact = [set() for _ in range(8)]
    vhash = hashlib.sha256()
    for step_i in range(4):
        n = 4096
        take = rng.random(n) < 0.85
        keys = np.where(take, roster[rng.integers(0, len(roster), n)],
                        rng.integers(50_000, 80_000, n)).astype(np.uint32)
        banks = rng.integers(0, 8, n).astype(np.int32)
        if step_i % 2 == 0:
            valid = engine.step(keys, banks)
        else:
            kw = 17
            words = np.full(engine.padded_size(n), 0xFFFFFFFF, np.uint32)
            words[:n] = (banks.astype(np.uint32) << kw) | keys
            valid = engine.step_words(words, n, kw)
        v_host = valid.cpu().numpy()
        assert v_host.shape == (n,), v_host.shape
        vhash.update(np.packbits(v_host).tobytes())
        nvalid_total += int(valid.sum())
        total += n
        for b in range(8):
            exact[b].update(keys[take & (banks == b)].tolist())
    counts = [int(c) for c in engine.count_all()]
    probe = np.concatenate([roster[:512],
                            np.arange(60_000, 60_512, dtype=np.uint32)])
    member = engine.contains(probe)
    bits, regs = engine.get_state()
    return {
        "nvalid_total": nvalid_total,
        "total": total,
        "counts": counts,
        "exact": [len(s) for s in exact],
        "member_roster": int(member[:512].sum()),
        "member_invalid": int(member[512:].sum()),
        "bloom_sha": hashlib.sha256(bits.tobytes()).hexdigest(),
        "regs_sha": hashlib.sha256(regs.tobytes()).hexdigest(),
        "valid_sha": vhash.hexdigest(),
    }


def _pipeline(mesh, wire="word", **cfg):
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    config = Config(bloom_filter_capacity=20_000, wire_format=wire,
                    num_shards=mesh.shape["sp"],
                    num_replicas=mesh.shape["dp"], **cfg)
    return FusedPipeline(config, client=MemoryClient(MemoryBroker()),
                         num_banks=8, mesh=mesh)


def _feed(pipe, num_events, batch, seed):
    from attendance_tpu_torch.pipeline.loadgen import generate_frames

    roster, frames = generate_frames(num_events, batch, roster_size=8_000,
                                     num_lectures=8, invalid_fraction=0.2,
                                     seed=seed)
    pipe.preload(roster)
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    for f in frames:
        producer.send(f)


def run_pipeline_workload(mesh, wire="word") -> dict:
    """tests/multihost_worker.py ``run_pipeline_workload`` on the port:
    the FusedPipeline on the mesh, broker frames in, stored validity out
    (the per-step validity gather is what makes it host-readable on a
    multi-process mesh). The wire is pinned (``wire``: word, or seg or
    delta with one packed buffer a replica): every process must run the
    same steps."""
    import numpy as np

    pipe = _pipeline(mesh, wire)
    try:
        _feed(pipe, 8_192, 2_048, seed=71)
        pipe.run(max_events=8_192, idle_timeout_s=1.0)
        cols = pipe.store.to_columns(deduplicate=False)
        order = np.lexsort((cols["student_id"], cols["micros"]))
        valid = np.asarray(cols["is_valid"], bool)[order]
        return {
            "pipe_events": pipe.metrics.events,
            "pipe_valid_sha": hashlib.sha256(
                np.packbits(valid).tobytes()).hexdigest(),
            "pipe_counts": {str(d): int(pipe.count(d))
                            for d in pipe.lecture_days()},
            "pipe_validity_counts": list(pipe.validity_counts()),
            "pipe_wire_dwell": dict(pipe.metrics.wire_dwell),
        }
    finally:
        pipe.cleanup()


def run_crash_workload(mesh, snap_dir: str) -> dict:
    """tests/multihost_worker.py ``run_crash_workload`` on the port: the
    first half of a 16,384-event stream with a barrier every 2 frames
    (only process 0 writes ``snap_dir``); the caller then kills the
    processes and replays the rest on one process."""
    pipe = _pipeline(mesh, snapshot_dir=snap_dir, snapshot_every_batches=2)
    _feed(pipe, 16_384, 2_048, seed=93)
    pipe.run(max_events=8_192, idle_timeout_s=1.0)
    return {"crash_events": pipe.metrics.events,
            "crash_validity_counts": list(pipe.validity_counts())}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("process_id", type=int)
    p.add_argument("num_processes", type=int)
    p.add_argument("port")
    p.add_argument("out_json")
    p.add_argument("snap_dir", nargs="?", default=None)
    p.add_argument("--device", default="cpu")
    p.add_argument("--cells", type=int, default=2)
    p.add_argument("--wire", default="word",
                   choices=("word", "seg", "delta"))
    args = p.parse_args()

    import torch
    import torch.distributed as dist

    from attendance_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    assert multihost.init_distributed(
        f"127.0.0.1:{args.port}", args.num_processes, args.process_id)
    # A second call reports the group it is in.
    assert multihost.init_distributed() is True
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    devices = [device] * args.cells
    mesh = multihost.make_multihost_mesh(num_shards=args.cells,
                                         devices=devices)
    assert mesh.shape == {"dp": args.num_processes, "sp": args.cells}
    assert mesh.first_replica == args.process_id and mesh.multiprocess
    try:  # a shard group may not straddle processes
        multihost.make_multihost_mesh(num_shards=args.cells + 1,
                                      devices=devices)
        raise AssertionError("a straddling mesh must be refused")
    except ValueError:
        pass
    result = {"process_id": args.process_id,
              "process_count": dist.get_world_size()}
    if args.snap_dir is not None:
        result.update(run_crash_workload(mesh, args.snap_dir))
        with open(args.out_json, "w") as f:
            json.dump(result, f)
        print(f"[p{args.process_id}] SNAPPED", flush=True)
        # Held until the caller kills it: a real crash, no teardown.
        time.sleep(600)
        return
    t0 = time.perf_counter()
    result.update(run_workload(mesh))
    result.update(run_pipeline_workload(mesh, args.wire))
    result["seconds"] = time.perf_counter() - t0
    with open(args.out_json, "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    print(f"[p{args.process_id}] OK", flush=True)


if __name__ == "__main__":
    main()
