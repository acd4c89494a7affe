"""The Pulsar transport on the card: ``python -m pytest --noconftest -m gpu
tests/test_torch_pulsar_gpu.py`` (``--noconftest``: ``tests/conftest.py``
imports jax).

The ``fused`` equality of ``tests/test_torch_pulsar.py`` on ``cuda:0``:
the run loop's per-message path over ``PulsarClient`` (the fake
pulsar-client of ``tests/torch_fake_pulsar.py``), on the word and bytes
wires and through ``--ingress-lanes 2``, equal to the port's run over its
memory broker on the card and to the plain versions' run on the CPU:
filter words, registers, counters, PFCOUNTs and stored rows. Skips inside
the test without a card.
"""

import sys

import numpy as np
import pytest
import torch

import torch_fake_pulsar as fake_mod
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models.fused import state_to_numpy
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

pytestmark = pytest.mark.gpu


def _run(config, device, roster, frames, client=None):
    pipe = FusedPipeline(config, client=client, num_banks=8, device=device)
    try:
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=1 << 18, idle_timeout_s=0.5)
        regs = state_to_numpy(pipe.state)[1]
        cols = pipe.store.to_columns(deduplicate=False)
        order = np.lexsort((cols["student_id"], cols["micros"],
                            cols["lecture_day"]))
        return (state_to_numpy(pipe.state)[0].tobytes(),
                state_to_numpy(pipe.state)[2].tobytes(),
                {d: regs[b].tobytes() for d, b in pipe._bank_of.items()},
                tuple(pipe.validity_counts()), pipe.count_all(),
                [np.asarray(cols[k])[order].tolist() for k in
                 ("student_id", "lecture_day", "micros", "is_valid")])
    finally:
        pipe.cleanup()


@pytest.mark.parametrize("wire,lanes", [("word", 0), ("bytes", 0),
                                        ("word", 2)])
def test_fused_over_the_adapter_on_the_card(monkeypatch, wire, lanes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setitem(sys.modules, "pulsar", fake_mod)
    fake_mod.reset()
    roster, frames = generate_frames(1 << 18, 1 << 15, roster_size=50_000,
                                     num_lectures=8, seed=0)
    frames = list(frames)
    config = Config(wire_format=wire, transport_backend="pulsar",
                    pulsar_host="pulsar://gpu-test:6650",
                    ingress_lanes=lanes)
    kernels.reset_launches()
    ours = _run(config, "cuda", roster, frames)
    steps = kernels.launches["fused_step"]
    mem = _run(Config(wire_format=wire), "cuda", roster, frames,
               client=MemoryClient(MemoryBroker()))
    cpu = _run(Config(wire_format=wire), "cpu", roster, frames,
               client=MemoryClient(MemoryBroker()))
    assert ours == mem == cpu
    assert sum(ours[3]) == 1 << 18
    assert steps == len(frames)
    assert fake_mod.pending(config.pulsar_topic, FusedPipeline.SUBSCRIPTION,
                            config.pulsar_host) == 0
    fake_mod.reset()
