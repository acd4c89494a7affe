"""The port's multi-process mesh (``parallel/multihost.py``) against one
process and the JAX package.

Two layers, as tests/test_multihost.py:

* one process: the no-op init, the argument checks, the single-process
  fallback and the replicas' default;
* two real processes: a gloo group over localhost TCP, 2 CPU cells each
  (sp = 2 inside a process, dp = 2 across them), running
  tests/multihost_worker.py's workload on the port
  (tests/torch_multihost_worker.py). Each process's facts equal the
  port's single-process (2, 2) mesh and JAX's, bit for bit; a crash
  after mid-run barriers (only process 0 writes) restores on one
  process on another mesh shape and lands on the no-crash run.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from attendance_tpu_torch.parallel import make_mesh
from attendance_tpu_torch.parallel.multihost import (
    init_distributed, make_multihost_mesh)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

_REPO = Path(__file__).resolve().parents[1]
_WORKER = Path(__file__).resolve().parent / "torch_multihost_worker.py"
# The facts tests/test_multihost.py holds equal across its cluster.
FACTS = ("nvalid_total", "total", "counts", "exact", "member_roster",
         "member_invalid", "bloom_sha", "regs_sha", "valid_sha",
         "pipe_events", "pipe_valid_sha", "pipe_counts",
         "pipe_validity_counts")


def test_init_distributed_is_noop_single_process(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_rejects_partial_args():
    with pytest.raises(ValueError, match="require coordinator_address"):
        init_distributed(num_processes=2)
    with pytest.raises(ValueError, match="require coordinator_address"):
        init_distributed(process_id=0)
    with pytest.raises(ValueError, match="requires num_processes"):
        init_distributed("127.0.0.1:1", num_processes=2)


def test_make_multihost_mesh_single_process_fallback():
    mesh = make_multihost_mesh(num_shards=2, num_replicas=4,
                               devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "sp": 2} and not mesh.multiprocess


def test_make_multihost_mesh_defaults_replicas_to_all_devices():
    mesh = make_multihost_mesh(num_shards=2, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "sp": 2}
    if not torch.cuda.is_available():
        # devices=None: the process's CUDA devices, none here.
        with pytest.raises(ValueError, match="need 2 devices"):
            make_multihost_mesh(num_shards=2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(port, outs, *extra):
    env = dict(os.environ, PYTHONPATH=str(_REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(_WORKER), str(i), "2", str(port), str(out),
         *extra, "--device", "cpu", "--cells", "2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i, out in enumerate(outs)]


def test_two_process_gloo_cluster_matches_single_process_and_jax(tmp_path):
    outs = [tmp_path / f"r{i}.json" for i in range(2)]
    procs = _spawn(_free_port(), outs)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    results = [json.loads(o.read_text()) for o in outs]
    assert [r["process_count"] for r in results] == [2, 2]

    from attendance_tpu.parallel.sharded import make_mesh as jax_mesh
    from multihost_worker import (
        run_pipeline_workload as jax_pipeline_workload,
        run_workload as jax_workload)
    from torch_multihost_worker import run_pipeline_workload, run_workload

    ref = run_workload(make_mesh(2, 2, ["cpu"] * 4))
    ref.update(run_pipeline_workload(make_mesh(2, 2, ["cpu"] * 4)))
    jax_ref = jax_workload(jax_mesh(num_shards=2, num_replicas=2))
    jax_ref.update(jax_pipeline_workload(jax_mesh(num_shards=2,
                                                  num_replicas=2)))
    for r in results:
        for key in FACTS:
            assert r[key] == ref[key] == jax_ref[key], (key, r[key],
                                                        ref[key])
    assert ref["member_roster"] == 512
    assert ref["member_invalid"] <= 512 * 0.03
    for est, exact in zip(ref["counts"], ref["exact"]):
        assert abs(est - exact) / exact < 0.02


def test_two_process_gloo_cluster_on_the_seg_wire(tmp_path):
    """The same two-process run with the pipeline on the seg wire (one
    packed buffer a replica, each process packing every replica's slice
    and stepping its own): each process's facts equal the port's
    single-process (2, 2) mesh on the seg wire."""
    outs = [tmp_path / f"s{i}.json" for i in range(2)]
    procs = _spawn(_free_port(), outs, "--wire", "seg")
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    results = [json.loads(o.read_text()) for o in outs]
    from torch_multihost_worker import run_pipeline_workload, run_workload

    ref = run_workload(make_mesh(2, 2, ["cpu"] * 4))
    ref.update(run_pipeline_workload(make_mesh(2, 2, ["cpu"] * 4), "seg"))
    for r in results:
        assert r["process_count"] == 2
        for key in FACTS:
            assert r[key] == ref[key], (key, r[key], ref[key])
        assert r["pipe_wire_dwell"] == {"seg": 4}
    assert ref["pipe_events"] == 8_192


def test_two_process_crash_snapshot_restore(tmp_path):
    """Barriers mid-run on the 2-process mesh (process 0 writes), both
    processes SIGKILLed, then a restore on one process on a (2, 4) mesh
    replays the unacked half: counters, PFCOUNTs and the deduplicated
    store equal the no-crash run."""
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.pipeline.fast_path import (
        EVENTS_SEGMENTS, SKETCH_SNAPSHOT, FusedPipeline)
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    snap = tmp_path / "snap"
    outs = [tmp_path / f"c{i}.json" for i in range(2)]
    procs = _spawn(_free_port(), outs, str(snap))
    try:
        deadline = time.monotonic() + 120
        while not all(o.exists() for o in outs):
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in procs):
                for p in procs:
                    p.kill()
                logs = [p.communicate()[0] for p in procs]
                pytest.fail("crash workers failed\n" + "\n".join(
                    log[-4000:] for log in logs))
            time.sleep(0.1)
        time.sleep(0.3)  # let the final JSON writes land
        procs[1].send_signal(signal.SIGKILL)
        procs[0].send_signal(signal.SIGKILL)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r in (json.loads(o.read_text()) for o in outs):
        assert r["process_count"] == 2 and r["crash_events"] == 8_192
    assert (snap / SKETCH_SNAPSHOT).exists()
    assert list((snap / EVENTS_SEGMENTS).glob("segment-*.npz"))

    num_events, batch = 16_384, 2_048
    roster, frames = generate_frames(num_events, batch, roster_size=8_000,
                                     num_lectures=8, invalid_fraction=0.2,
                                     seed=93)
    frames = list(frames)

    def pipe(snap_dir=""):
        return FusedPipeline(
            Config(bloom_filter_capacity=20_000, num_shards=2,
                   num_replicas=4, wire_format="word",
                   snapshot_dir=snap_dir),
            client=MemoryClient(MemoryBroker()), num_banks=8,
            mesh=make_mesh(2, 4, ["cpu"] * 8))

    resumed, oracle = pipe(str(snap)), pipe()
    try:
        assert resumed.metrics.events == 0 and resumed.store.count() > 0
        assert sum(resumed.validity_counts()) == 8_192
        producer = resumed.client.create_producer(resumed.config.pulsar_topic)
        for f in frames[num_events // 2 // batch:]:
            producer.send(f)
        resumed.run(max_events=num_events // 2, idle_timeout_s=0.3)
        oracle.preload(roster)
        producer = oracle.client.create_producer(oracle.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        oracle.run(max_events=num_events, idle_timeout_s=0.3)
        assert resumed.validity_counts() == oracle.validity_counts()
        assert resumed.lecture_days() == oracle.lecture_days()
        assert resumed.count_all() == oracle.count_all()
        a = resumed.store.to_columns()
        b = oracle.store.to_columns()
        oa = np.lexsort((a["student_id"], a["micros"]))
        ob = np.lexsort((b["student_id"], b["micros"]))
        for k in ("student_id", "micros", "is_valid"):
            np.testing.assert_array_equal(np.asarray(a[k])[oa],
                                          np.asarray(b[k])[ob])
    finally:
        resumed.cleanup()
        oracle.cleanup()
