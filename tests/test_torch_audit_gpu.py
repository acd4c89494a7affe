"""The accuracy gauges on the card: ``python -m pytest --noconftest -m gpu
tests/test_torch_audit_gpu.py`` (``--noconftest``: ``tests/conftest.py``
imports jax).

A ``fused`` run on ``cuda:0`` with the audit on and a scrape of
``/metrics`` started from inside the run loop's receive after the first
frame, on a thread of its own: the scrape's health and audit callbacks
read the card (K4 re-queries the shadow's probe sets, K1 histograms the
registers for ``count_all``) from the metrics server's request thread,
off the run loop's, while
``torch.cuda.synchronize`` is patched to raise for the whole run and
the scrape. Skips inside the test without a card.

The scrape after the first frame measures the FPR over the few sampled
outsiders seen by then (about 62 at a 1% audit), where one false
positive reads 1/62: it is held to a binomial bound for its own sample
count (at p = 0.015, a one-in-a-million tail). The read after the run,
over the whole run's outsiders, is held at 0.015.
"""

import math
import threading
import urllib.request

import pytest
import torch

from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs.exposition import parse_prom
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline import fast_path
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

pytestmark = pytest.mark.gpu


def _scraping_client(t, out: dict) -> MemoryClient:
    """A client whose consumer starts one scrape from inside the run
    loop's receive once a frame went out, on a thread of its own."""
    def scrape() -> None:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{t.http_port}/metrics", timeout=60) as r:
            out["text"] = r.read().decode()

    client = MemoryClient(MemoryBroker())
    subscribe = client.subscribe

    def subscribe_scraping(topic, subscription):
        consumer = subscribe(topic, subscription)
        raw = consumer.receive_many_raw

        def receive_many_raw(max_n, timeout_millis=None):
            got = raw(max_n, timeout_millis=timeout_millis)
            if "thread" not in out and t.frames.value >= 1:
                out["thread"] = threading.Thread(target=scrape, daemon=True)
                out["thread"].start()
            return got

        consumer.receive_many_raw = receive_many_raw
        return consumer

    client.subscribe = subscribe_scraping
    return client


def _binomial_bound(n: int, p: float = 0.015, tail: float = 1e-6) -> int:
    """The smallest k with P(Bin(n, p) > k) <= tail: the false positives
    a filter at FPR p exceeds once in a million scrapes of n outsiders."""
    cdf = 0.0
    for k in range(n + 1):
        cdf += math.comb(n, k) * p ** k * (1.0 - p) ** (n - k)
        if 1.0 - cdf <= tail:
            return k
    return n


def test_mid_run_scrape_reads_the_card_from_its_thread(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    events, frame = 1 << 20, 1 << 17
    config = Config(wire_format="word", metrics_port=-1, audit_sample=0.01)
    t = obs.enable(config)
    out = {}
    callers = {"bloom_contains": [], "hll_histogram": []}
    for name, seen in callers.items():
        real = getattr(kernels, name)

        def spy(*args, _real=real, _seen=seen, **kwargs):
            _seen.append(threading.current_thread().name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(kernels, name, spy)
    # The outsiders each measured-FPR read re-queries, by thread.
    outsiders = []
    real_sets = t.auditor.fused_probe_sets

    def probe_sets():
        sets = real_sets()
        outsiders.append((threading.current_thread().name, len(sets[1])))
        return sets

    monkeypatch.setattr(t.auditor, "fused_probe_sets", probe_sets)
    try:
        pipe = fast_path.FusedPipeline(config,
                                       client=_scraping_client(t, out))
        roster, frames = generate_frames(events, frame, roster_size=100_000,
                                         num_lectures=16, seed=0)
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)

        def forbidden(*args, **kwargs):
            raise AssertionError("the card was synchronized")

        kernels.reset_launches()
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", forbidden)
            pipe.run(max_events=events, idle_timeout_s=0.5)
            out["thread"].join(timeout=120)
            assert not out["thread"].is_alive()
        launches = dict(kernels.launches)
        s = {(n, l): float(v) for n, l, v in parse_prom(out["text"])}
        loop = threading.current_thread().name
        assert any(c != loop for c in callers["bloom_contains"]), callers
        assert any(c != loop for c in callers["hll_histogram"]), callers
        assert launches["bloom_contains"] >= 2  # roster and outsiders
        assert launches["hll_histogram"] >= 2  # estimate and HLL error
        assert s[("attendance_bloom_false_negatives_total", "")] == 0
        fpr = s[("attendance_bloom_measured_fpr", 'surface="fused"')]
        # The scrape's own sample: the outsider count of a read off the
        # loop's thread that gives the scraped ratio.
        counts = {c for name, c in outsiders if name != loop and c}
        fits = [n for n in counts
                if abs(fpr * n - round(fpr * n)) < 1e-9]
        assert fits, (fpr, counts)
        n = min(fits)
        assert 0 <= round(fpr * n) <= _binomial_bound(n), (fpr, n)
        assert 0.0 < s[("attendance_bloom_fill_fraction", "")] < 1.0
        assert s[("attendance_hll_estimate", "")] > 0
        # After the run, with nothing in flight: the gauges equal the
        # pipeline's own reads.
        reg = t.registry
        post = reg.gauge("attendance_bloom_measured_fpr",
                         surface="fused").read()
        assert 0.0 <= post <= 0.015, post
        assert outsiders[-1][1] >= n  # the whole run's outsiders
        assert reg.gauge("attendance_hll_estimate").read() == sum(
            pipe.count_all().values())
        assert reg.gauge("attendance_bloom_estimated_fpr").read() == (
            pipe.estimated_fpr())
        pipe.cleanup()
    finally:
        obs.disable()
