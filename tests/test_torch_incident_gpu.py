"""The incident engine and the fleet pusher on the card: ``python -m
pytest --noconftest -m gpu tests/test_torch_incident_gpu.py``
(``--noconftest``: ``tests/conftest.py`` imports jax).

A ``fused`` run on ``cuda:0`` with the 1% audit, ``fpr<=0.0001`` at 0.4 /
1.6 s windows, ``--incident-dir`` and a fleet pusher at 0.1 s into an
in-process collector, ``torch.cuda.synchronize`` patched to raise for the
run and the wait after it: the SLO objective fires, the incident engine
opens an incident whose top rule is ``slo_burn`` from its own thread,
and its bundle's render launches K4 and K1 from the ``incident-engine``
thread, as each push does from ``fleet-pusher``, on the default stream.
No tick fails. Skips inside the test without a card.
"""

import json
import logging
import threading
import time

import pytest
import torch

from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs.fleet import FleetCollector
from attendance_tpu_torch.obs.incident import (
    EVIDENCE_PARTS, find_bundles, incident_report)
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline import fast_path
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

pytestmark = pytest.mark.gpu

EVENTS, FRAME = 1 << 20, 1 << 17


def test_incident_open_reads_the_card_from_its_thread(tmp_path, monkeypatch,
                                                      caplog):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    callers = {"bloom_contains": [], "hll_histogram": []}
    for name, seen in callers.items():
        real = getattr(kernels, name)

        def spy(*args, _real=real, _seen=seen, **kwargs):
            _seen.append(threading.current_thread().name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(kernels, name, spy)

    def forbidden(*args, **kwargs):
        raise AssertionError("the card was synchronized")

    collector = FleetCollector(directory=str(tmp_path / "fleet")).start()
    config = Config(audit_sample=0.01, incident_dir=str(tmp_path / "inc"),
                    slo=["fpr<=0.0001"], slo_fast_s=0.4, slo_slow_s=1.6,
                    metrics_interval_s=0.1, fleet_push=collector.address,
                    fleet_push_interval_s=0.1)
    t = obs.enable(config)
    try:
        pipe = fast_path.FusedPipeline(
            config, client=MemoryClient(MemoryBroker()))
        roster, frames = generate_frames(EVENTS, FRAME,
                                         roster_size=100_000,
                                         num_lectures=16, seed=0)
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)
        with caplog.at_level(logging.ERROR), monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", forbidden)
            pipe.run(max_events=EVENTS, idle_timeout_s=0.5)
            deadline = time.monotonic() + 30.0
            while (t.incidents.total_opened == 0
                   or "incident-engine" not in callers["hll_histogram"]
                   or "fleet-pusher" not in callers["hll_histogram"]):
                assert time.monotonic() < deadline, (
                    t.incidents.total_opened, callers)
                time.sleep(0.02)
            obs.disable()  # joins the engines and the pusher
        assert not [r for r in caplog.records
                    if "tick failed" in r.getMessage()
                    or "fleet push failed" in r.getMessage()]
        for name in callers:
            for thread in ("incident-engine", "fleet-pusher"):
                assert thread in callers[name], (name, callers)
        [bundle] = find_bundles(tmp_path / "inc")
        rec = json.loads((bundle / "incident.json").read_text())
        assert rec["diagnosis_top"] == "slo_burn"
        for name in EVIDENCE_PARTS:
            assert (bundle / name).is_file()
        assert "attendance_bloom_measured_fpr" in \
            (bundle / "metrics.prom").read_text()
        text, ok = incident_report(bundle)
        assert ok, text
        pipe.cleanup()
    finally:
        obs.disable()
        collector.stop()
    status = json.loads((tmp_path / "fleet" / "FLEET.json").read_text())
    [key] = status["instances"]
    assert status["instances"][key]["events"] == EVENTS
