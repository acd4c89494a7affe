"""The control plane on the card: ``python -m pytest --noconftest -m gpu
tests/test_torch_control_gpu.py`` (``--noconftest``: ``tests/conftest.py``
imports jax).

A controlled ``fused`` run on ``cuda:0`` under a controller ticked on an
injected clock: the ladder walked to ``shed`` by a circuit gauge, frames
spilled there with no K2 launch, drained on the clear with one K2 each,
their files deleted once the final barrier is durable, and the state
equal to the same frames on the CPU with no controller. Skips inside the
test without a card.
"""

import numpy as np
import pytest
import torch

from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.control import ControlEngine
from attendance_tpu_torch.models.fused import state_to_numpy
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

pytestmark = pytest.mark.gpu


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _tick_to(eng, clk, rung):
    for _ in range(64):
        if eng.ladder.rung == rung:
            return
        clk.t += 2.1
        eng.tick(clk.t)
    raise AssertionError(f"ladder at {eng.ladder.rung}, want {rung}")


def _steps():
    return sum(kernels.launches[k] for k in
               ("fused_step", "fused_step_seg", "fused_step_delta"))


def _state(pipe):
    _, regs, counts = state_to_numpy(pipe.state)
    cols = pipe.store.to_columns(deduplicate=False)
    order = np.lexsort((cols["student_id"], cols["micros"],
                        cols["lecture_day"]))
    return (regs, counts, dict(pipe._bank_of),
            {k: np.asarray(cols[k])[order] for k in
             ("student_id", "lecture_day", "micros", "is_valid")})


def test_spilled_frames_drain_through_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, frame = 1 << 17, 1 << 14
    roster, frames = generate_frames(n, frame, roster_size=50_000,
                                     num_lectures=8, seed=4)
    frames = list(frames)
    spill = tmp_path / "spill"
    cfg = Config(snapshot_dir=str(tmp_path / "snap"),
                 snapshot_every_batches=2,
                 control_log=str(tmp_path / "a.jsonl"),
                 control_spill_dir=str(spill))
    t = obs.enable(cfg)
    try:
        t.control.stop()
        clk = Clock()
        eng = t.control = ControlEngine(t, cfg.control_log,
                                        spill_dir=str(spill), _clock=clk)
        pipe = FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                             device="cuda")
        pipe.preload(roster)
        producer = pipe.client.create_producer(cfg.pulsar_topic)
        for f in frames[:2]:
            producer.send(f)
        kernels.reset_launches()
        pipe.run(max_events=2 * frame, idle_timeout_s=10.0)
        sick = t.registry.gauge("attendance_circuit_state", sink="store")
        sick.set(1.0)
        _tick_to(eng, clk, 4)
        before = _steps()
        for f in frames[2:5]:
            producer.send(f)
        pipe.run(idle_timeout_s=0.3)  # spilled, then drained at the end
        # The run's end drained them: one K2 each, files gone once the
        # final barrier was durable.
        assert eng.admission.spilled_total == 3
        assert eng.admission.drained_total == 3
        assert _steps() - before == 3
        assert not list(spill.iterdir())
        sick.set(0.0)
        _tick_to(eng, clk, 0)
        for f in frames[5:]:
            producer.send(f)
        pipe.run(max_events=n, idle_timeout_s=10.0)
        assert pipe.metrics.events == n
        got = _state(pipe)
        pipe.cleanup()
    finally:
        obs.disable()
    ref = FusedPipeline(Config(), client=MemoryClient(MemoryBroker()),
                        device="cpu")
    ref.preload(roster)
    producer = ref.client.create_producer(ref.config.pulsar_topic)
    for f in frames:
        producer.send(f)
    ref.run(max_events=n, idle_timeout_s=10.0)
    want = _state(ref)
    ref.cleanup()
    np.testing.assert_array_equal(got[1], want[1])
    assert set(got[2]) == set(want[2])
    for day, bank in want[2].items():
        np.testing.assert_array_equal(got[0][got[2][day]], want[0][bank])
    for k in want[3]:
        np.testing.assert_array_equal(got[3][k], want[3][k])
