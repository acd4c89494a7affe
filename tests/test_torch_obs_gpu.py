"""The telemetry hooks on the card: ``python -m pytest --noconftest -m gpu
tests/test_torch_obs_gpu.py`` (``--noconftest``: ``tests/conftest.py``
imports jax).

A short ``fused`` run on ``cuda:0`` with every telemetry surface on,
``torch.cuda.synchronize`` patched to raise while it runs: no hook may
synchronize the card (the drain waits on each frame's own event). Skips
inside the test without a card.
"""

import json
import urllib.request

import pytest
import torch

from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs.exposition import parse_prom
from attendance_tpu_torch.pipeline import fast_path
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

pytestmark = pytest.mark.gpu


def test_fused_run_on_the_card_with_telemetry_never_synchronizes(
        tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    events, frame = 1 << 18, 1 << 15
    config = Config(wire_format="word", metrics_port=-1,
                    metrics_prom=str(tmp_path / "m.prom"),
                    flight_recorder=16,
                    flight_path=str(tmp_path / "flight.json"),
                    trace_out=str(tmp_path / "trace.json"))
    t = obs.enable(config)
    try:
        pipe = fast_path.FusedPipeline(config,
                                       client=MemoryClient(MemoryBroker()))
        roster, frames = generate_frames(events, frame, roster_size=50_000,
                                         num_lectures=8, seed=0)
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)

        def forbidden(*args, **kwargs):
            raise AssertionError("a hook synchronized the card")

        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", forbidden)
            pipe.run(max_events=events, idle_timeout_s=0.5)
        assert fast_path._INFLIGHT_DEPTH == 8
        with urllib.request.urlopen(
                f"http://127.0.0.1:{t.http_port}/metrics", timeout=10) as r:
            s = {(n, l): float(v) for n, l, v in parse_prom(r.read().decode())}
        n_frames = events // frame
        assert s[("attendance_events_total", "")] == events
        assert s[("attendance_frames_total", "")] == n_frames
        assert s[("attendance_wire_frames_total", 'wire="word"')] == n_frames
        for stage in ("dequeue_wait", "decode", "dispatch", "device_wait"):
            assert s[("attendance_stage_latency_seconds_count",
                      f'stage="{stage}"')] == n_frames, stage
        assert s[("attendance_device_transfer_bytes_total",
                  'direction="h2d",site="frame",wire="word"')] == (
            4 * frame * n_frames)
        t.dump_flight("test")
        assert json.loads((tmp_path / "flight.json").read_text())[
            "records"][-1]["events"] == frame
        pipe.cleanup()
    finally:
        obs.disable()
    trace = json.loads((tmp_path / "trace.json").read_text())
    waits = [e for e in trace["traceEvents"] if e.get("name") == "device_wait"]
    assert len(waits) == events // frame
