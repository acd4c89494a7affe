"""The SLO engine and ``--profile-dir`` on the card: ``python -m pytest
--noconftest -m gpu tests/test_torch_profiler_gpu.py`` (``--noconftest``:
``tests/conftest.py`` imports jax).

1. A ``fused`` run on ``cuda:0`` with the audit and the SLO engine on at
   a 0.05 s tick, ``torch.cuda.synchronize`` patched to raise for the run
   and for ticks after it: the engine's accuracy objectives launch K4 and
   K1 from the ``slo-engine`` thread, on the default stream, no tick
   fails, and the final tick's measured FPR meets ``fpr<=0.015``.
2. The same run under ``--profile-dir``: the ``torch.profiler`` trace
   holds one ``fused_step_dispatch`` range a frame, the launches made
   inside it, and at least one device kernel event of the ``__global__``
   functions a launch key launches for each launch (keys that share a
   function counted as one group).

Skips inside each test without a card.
"""

import json
import logging
import threading
import time

import pytest
import torch

from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline import fast_path
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.utils.profiling import (
    TRACE_FILE, kernel_events, kernel_launch_shortfall, range_count,
    trace_launches)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

pytestmark = pytest.mark.gpu

EVENTS, FRAME = 1 << 20, 1 << 17


def _pipeline(config):
    pipe = fast_path.FusedPipeline(config, client=MemoryClient(MemoryBroker()))
    roster, frames = generate_frames(EVENTS, FRAME, roster_size=100_000,
                                     num_lectures=16, seed=0)
    pipe.preload(roster)
    producer = pipe.client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    return pipe


def test_slo_ticks_read_the_card_from_their_thread(tmp_path, monkeypatch,
                                                   caplog):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = Config(wire_format="word", audit_sample=0.01,
                    alert_log=str(tmp_path / "alerts.jsonl"),
                    slo=["fpr<=0.015"], slo_fast_s=0.2, slo_slow_s=1.0)
    callers = {"bloom_contains": [], "hll_histogram": []}
    for name, seen in callers.items():
        real = getattr(kernels, name)

        def spy(*args, _real=real, _seen=seen, **kwargs):
            _seen.append(threading.current_thread().name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(kernels, name, spy)

    def forbidden(*args, **kwargs):
        raise AssertionError("the card was synchronized")

    t = obs.enable(config)
    try:
        assert t.slo.interval_s == 0.05
        pipe = _pipeline(config)
        with caplog.at_level(logging.ERROR), monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", forbidden)
            pipe.run(max_events=EVENTS, idle_timeout_s=0.5)
            # Ticks after the run read the card too (no epoch published).
            # A tick reads K1 only once the audit holds a day's truth,
            # so wait for both kernels from the engine's thread.
            deadline = time.monotonic() + 30.0
            while (sum(c == "slo-engine"
                       for c in callers["bloom_contains"]) < 3
                   or "slo-engine" not in callers["hll_histogram"]):
                assert time.monotonic() < deadline, callers
                time.sleep(0.02)
            obs.disable()  # joins the engine; its final tick too
        assert not [r for r in caplog.records
                    if "tick failed" in r.getMessage()]
        for name in callers:
            assert "slo-engine" in callers[name], callers
        # A tick early in the run reads the FPR of a few sampled
        # negatives (1/62 seen), which may breach and fire; the final
        # tick, over the whole run's sample, meets the objective.
        final = t.slo._state["bloom_measured_fpr"].last_value
        assert 0.0 <= final <= 0.015, final
        for line in (tmp_path / "alerts.jsonl").read_text().splitlines():
            assert json.loads(line)["slo"] == "bloom_measured_fpr", line
        pipe.cleanup()
    finally:
        obs.disable()


def test_profile_dir_trace_counts_the_kernels_of_a_fused_run(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = Config(profile_dir=str(tmp_path / "pd"))
    pipe = _pipeline(config)
    try:
        pipe.run(max_events=EVENTS, idle_timeout_s=0.5)
    finally:
        pipe.cleanup()
    doc = json.loads((tmp_path / "pd" / TRACE_FILE).read_text())
    # The launches made inside the trace (the preload was before it).
    launched = trace_launches(doc)
    assert range_count(doc, "fused_step_dispatch") == EVENTS // FRAME
    assert launched["fused_step"] == EVENTS // FRAME
    assert kernel_launch_shortfall(doc, launched) == {}
    assert len(kernel_events(doc)) >= sum(launched.values())
