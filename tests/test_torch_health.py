"""The port's sketch-health gauges (``obs/health.py``) and the pipeline
hooks of the accuracy slice against the JAX package's (the health tests
of ``tests/test_tracing.py``, ``tests/test_observability.py``,
``tests/test_audit_slo.py``, ``tests/test_delta_snapshot.py``,
``tests/test_serve.py`` and ``tests/test_sharded_pipeline.py``).

Tolerance 0 (integers, ratios of integers, the same float64 host
arithmetic), with two stated exceptions: JAX reads the live fill of the
card as a float32 device mean, so its fill and estimated-FPR values are
held at float32 rounding (rel 1e-6) while the port's equal the exact
popcount over the same words; and a mesh's fill against JAX's at rel
1e-5, as the mesh tests hold it. Every test leaves both packages'
process-global telemetry disabled.
"""

import logging

import numpy as np
import pytest
import torch

from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models.bloom import (
    BloomFilter, bloom_packed_fill_fraction_np)
from attendance_tpu_torch.obs import health
from attendance_tpu_torch.obs.exposition import parse_prom, render
from attendance_tpu_torch.sketch import make_sketch_store
from attendance_tpu_torch.sketch.memory_store import MemorySketchStore
from attendance_tpu_torch.sketch.tpu_store import TpuSketchStore
from attendance_tpu_torch.utils.snapshot import (
    restore_sketch_store, snapshot_sketch_store, snapshot_sketch_store_chain)
from test_torch_obs import _jax_fused, _port_fused
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

HEALTH = tuple(health.HEALTH_HELP)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Telemetry is process-global in both packages: bare in, bare out."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _samples(text):
    return {(n, l): float(v) for n, l, v in parse_prom(text)}


# -- the estimator and its gauges ---------------------------------------------

@pytest.mark.parametrize("store_cls", [TpuSketchStore, MemorySketchStore])
def test_estimated_fpr_tracks_fill(store_cls):
    """The occupancy estimate grows with the fill and lands near the
    configured 1% at capacity; the card store's fill is the exact set
    count, the memory store's JAX's float32 mean exactly."""
    from attendance_tpu.sketch import memory_store as jmem
    from attendance_tpu.sketch import tpu_store as jtpu

    kw = {"device": "cpu"} if store_cls is TpuSketchStore else {}
    store = store_cls(Config(), **kw)
    jstore = (jtpu.TpuSketchStore if store_cls is TpuSketchStore
              else jmem.MemorySketchStore)(JaxConfig())
    assert store.estimated_fpr("bf") is None  # absent key
    for s in (store, jstore):
        s.execute_command("BF.RESERVE", "bf", 0.01, 10_000)
    assert store.estimated_fpr("bf") == 0.0  # empty filter
    rng = np.random.default_rng(0)
    keys = rng.choice(1 << 30, size=10_000, replace=False).astype(np.uint32)
    fprs = []
    for chunk in (keys[:1_000], keys[1_000:]):
        for s in (store, jstore):
            s.bf_add_many("bf", chunk)
        fprs.append(store.estimated_fpr("bf"))
        handle = store._blooms["bf"].filters[0]
        params = store._blooms["bf"].params[0]
        bits = np.asarray(handle.numpy() if isinstance(handle, torch.Tensor)
                          else handle)
        np.testing.assert_array_equal(
            bits, np.asarray(jstore._blooms["bf"].filters[0]))
        if store_cls is TpuSketchStore:
            fill = int(bits.sum()) / bits.size
            assert fprs[-1] == 1.0 - (1.0 - fill ** params.k)
            assert fprs[-1] == pytest.approx(jstore.estimated_fpr("bf"),
                                             rel=1e-6)
        else:
            assert fprs[-1] == jstore.estimated_fpr("bf")
    light, full = fprs
    assert 0.0 < light < full
    assert 0.002 < full < 0.02


def test_sketch_health_gauges_match_model_estimators(monkeypatch):
    """A fused run with no epoch reads the card: the fill is the exact
    popcount of the filter words (JAX's float32 device mean at its
    rounding), the FPR gauge equals ``estimated_fpr()``, the estimate
    equals ``sum(count_all())`` and JAX's, no register is saturated."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    kw = dict(bloom_filter_capacity=5_000, flight_recorder=4)
    jt = jobs.enable(JaxConfig(**kw))
    jpipe = _jax_fused(JaxConfig(transport_backend="memory", **kw))
    jpipe.run(max_events=4_096, idle_timeout_s=0.3)
    js = _samples(jt.render())
    jwords = np.asarray(jpipe.state.bloom_bits)
    jpipe.cleanup()
    jobs.disable()
    t = obs.enable(Config(**kw))
    pipe = _port_fused(Config(**kw))
    pipe.run(max_events=4_096, idle_timeout_s=0.3)
    try:
        s = _samples(render(t.registry))
        words = pipe.state.bloom_bits.numpy().view(np.uint32)
        np.testing.assert_array_equal(words, jwords)
        fill = bloom_packed_fill_fraction_np(words)
        assert s[("attendance_bloom_fill_fraction", "")] == fill
        assert s[("attendance_bloom_estimated_fpr", "")] == (
            pipe.estimated_fpr())
        assert s[("attendance_bloom_estimated_fpr", "")] == (
            fill ** pipe.params.k)
        assert s[("attendance_hll_estimate", "")] == sum(
            pipe.count_all().values())
        assert s[("attendance_hll_saturated_registers", "")] == 0.0
        for name in ("attendance_hll_estimate",
                     "attendance_hll_saturated_registers"):
            assert s[(name, "")] == js[(name, "")]
        for name in ("attendance_bloom_fill_fraction",
                     "attendance_bloom_estimated_fpr"):
            assert s[(name, "")] == pytest.approx(js[(name, "")], rel=1e-6)
        # No epoch, no serving: the mirror's gauges say "nothing yet".
        assert np.isnan(s[("attendance_read_staleness_seconds", "")])
        assert s[("attendance_read_epoch_seq", "")] == 0.0
    finally:
        pipe.cleanup()


def test_bloom_filter_gauge_tracks_estimated_fpr_after_inserts():
    t = obs.enable(Config(flight_recorder=4))
    bf = BloomFilter(capacity=5_000, error_rate=0.01, device="cpu")
    health.register_bloom_filter(t, bf, key="bf:test")
    rng = np.random.default_rng(3)
    for _ in range(3):  # inserts in chunks; the gauge follows live
        bf.add(rng.integers(0, 1 << 31, 1_000, dtype=np.uint32))
        s = _samples(render(t.registry))
        assert s[("attendance_bloom_estimated_fpr", 'key="bf:test"')] == (
            bf.estimated_fpr())
        assert s[("attendance_bloom_fill_fraction", 'key="bf:test"')] == (
            int(bf.bits.sum()) / bf.bits.numel())


def test_standalone_hll_gauges_equal_jax():
    from attendance_tpu.models.hll import HyperLogLog as JaxHLL
    from attendance_tpu.obs import health as jhealth
    from attendance_tpu_torch.models.hll import HyperLogLog

    t = obs.enable(Config(flight_recorder=4))
    jt = jobs.enable(JaxConfig(flight_recorder=4))
    h, jh = HyperLogLog(device="cpu"), JaxHLL()
    health.register_hll(t, h, key="h")
    jhealth.register_hll(jt, jh, key="h")
    rng = np.random.default_rng(4)
    for name in ("a", "b", "c"):
        keys = rng.integers(0, 1 << 32, 3_000).astype(np.uint32)
        h.add_by_name(name, keys)
        jh.add_by_name(name, keys)
    for name in ("attendance_hll_estimate",
                 "attendance_hll_saturated_registers"):
        key = (name, 'key="h"')
        assert _samples(t.render())[key] == _samples(jt.render())[key]
    assert _samples(t.render())[("attendance_hll_estimate", 'key="h"')] > 0


def test_scrape_is_lazy_and_off_means_no_registration(monkeypatch):
    """Telemetry off: nothing registers, nothing reads the sketches.
    Telemetry on: the health callbacks run at SCRAPE time only."""
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline

    pipe = _port_fused(Config(bloom_filter_capacity=1_000),
                       num_events=1_024, frame=1_024)
    assert obs.get() is None and pipe._obs is None
    assert pipe._auditor is None
    pipe.cleanup()
    calls = []
    orig = FusedPipeline.count_all
    monkeypatch.setattr(FusedPipeline, "count_all",
                        lambda self: (calls.append(1), orig(self))[1])
    t = obs.enable(Config(flight_recorder=4))
    pipe = _port_fused(Config(bloom_filter_capacity=1_000),
                       num_events=1_024, frame=1_024)
    pipe.run(max_events=1_024, idle_timeout_s=0.2)
    try:
        assert not calls  # the whole run read no health state
        render(t.registry)
        assert calls  # ... until the scrape asked
    finally:
        pipe.cleanup()


def test_dead_owner_skips_its_samples_with_a_warning(caplog):
    """A torn-down pipeline's gauges raise at scrape, and the exposition
    skips them with a warning instead of rendering a lying 0."""
    t = obs.enable(Config(flight_recorder=4))
    pipe = _port_fused(Config(bloom_filter_capacity=1_000),
                       num_events=1_024, frame=1_024)
    pipe.cleanup()
    del pipe
    with caplog.at_level(logging.WARNING):
        text = render(t.registry)
    for name in HEALTH:
        assert f"\n{name} " not in text
    assert "sketch owner was torn down" in caplog.text


def test_multiprocess_mesh_registers_no_health_gauges(monkeypatch):
    """On a mesh over a process group of more than one process the
    gauges' reductions are collectives: neither the health nor the
    fused audit gauges register (one process's scrape would wedge the
    group)."""
    from attendance_tpu_torch.obs.audit import register_fused_audit

    t = obs.enable(Config(audit_sample=1.0))
    pipe = _port_fused(Config(bloom_filter_capacity=1_000, num_shards=2),
                       num_events=1_024, frame=1_024, sp=2)
    try:
        # Unregister what the constructor registered (one process).
        t.registry._metrics.clear()
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size",
                            lambda group=None: 2)
        assert health.multiprocess_mesh(pipe)
        health.register_fused(t, pipe)
        register_fused_audit(t, pipe)
        assert not t.registry._metrics
    finally:
        monkeypatch.undo()
        pipe.cleanup()


# -- the mesh -----------------------------------------------------------------

def test_mesh_health_and_audit_gauges_equal_jax(monkeypatch):
    """A (2, 1) virtual mesh with the audit on: its fill gauge is the
    host popcount of its merged words (JAX's at rel 1e-5), and the
    estimate, saturation, measured FPR, false negatives and HLL error
    equal JAX's mesh pipeline's on the same frames."""
    from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipe
    from attendance_tpu.pipeline.loadgen import generate_frames
    from attendance_tpu.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    monkeypatch.setenv("ATP_NATIVE", "0")
    kw = dict(bloom_filter_capacity=5_000, num_shards=2, num_replicas=1,
              audit_sample=1.0)
    jt = jobs.enable(JaxConfig(**kw))
    client = MemoryClient(MemoryBroker())
    jpipe = JaxPipe(JaxConfig(transport_backend="memory", **kw),
                    client=client, num_banks=8)
    roster, frames = generate_frames(4_096, 1_024, roster_size=4_000,
                                     num_lectures=4, seed=0)
    jpipe.preload(roster)
    producer = client.create_producer(jpipe.config.pulsar_topic)
    for f in frames:
        producer.send(f)
    jpipe.run(max_events=4_096, idle_timeout_s=0.3)
    js = _samples(jt.render())
    jpipe.cleanup()
    jobs.disable()
    t = obs.enable(Config(**kw))
    pipe = _port_fused(Config(**kw), sp=2)
    pipe.run(max_events=4_096, idle_timeout_s=0.3)
    try:
        ps = _samples(t.render())
        words, _ = pipe.engine.get_state()
        fill = int(np.unpackbits(words.view(np.uint8)).sum()) / (
            pipe.params.m_bits)
        assert ps[("attendance_bloom_fill_fraction", "")] == fill
        assert ps[("attendance_bloom_fill_fraction", "")] == pytest.approx(
            js[("attendance_bloom_fill_fraction", "")], rel=1e-5)
        for key in (("attendance_hll_estimate", ""),
                    ("attendance_hll_saturated_registers", ""),
                    ("attendance_bloom_measured_fpr", 'surface="fused"'),
                    ("attendance_bloom_false_negatives_total", ""),
                    ("attendance_hll_measured_rel_error", 'key="fused"'),
                    ("attendance_audit_shadow_members", "")):
            assert ps[key] == js[key], key
        assert ps[("attendance_hll_estimate", "")] == sum(
            pipe.count_all().values())
    finally:
        pipe.cleanup()


# -- read epochs --------------------------------------------------------------

def test_health_gauges_read_from_epoch(tmp_path):
    """Under checkpointing the gauges answer from the pinned epoch and
    still equal the estimator methods; the mirror's staleness is finite
    and its sequence counts the publishes."""
    from test_torch_serve import _run_port

    pipe, _ = _run_port(seed=15, snap_dir=tmp_path / "s", metrics_port=-1)
    try:
        reg = obs.get().registry
        epoch = pipe.read_mirror.pin()
        assert epoch is not None and epoch.day_truth is None  # no audit
        assert reg.gauge("attendance_bloom_estimated_fpr").read() == (
            pipe.estimated_fpr())
        assert reg.gauge("attendance_hll_estimate").read() == sum(
            pipe.count_all().values())
        assert reg.gauge("attendance_hll_saturated_registers").read() == 0
        stale = reg.gauge("attendance_read_staleness_seconds").read()
        assert np.isfinite(stale) and stale >= 0.0
        assert reg.gauge("attendance_read_epoch_seq").read() == epoch.seq
        assert epoch.seq >= 2  # the preload's and the barriers'
    finally:
        pipe.cleanup()


# -- the generic store --------------------------------------------------------

def test_store_health_gauges_survive_snapshot_restore_equal_jax(tmp_path):
    """Restore replaces a store's innards and a fresh process builds a
    new store: both resume reporting, with JAX's values (memory store:
    the same host arithmetic)."""
    from attendance_tpu.sketch import make_sketch_store as jax_store
    from attendance_tpu.utils import snapshot as jsnap

    got = {}
    for pkg in ("jax", "port"):
        port = pkg == "port"
        cfg = (Config if port else JaxConfig)(sketch_backend="memory",
                                              metrics_port=-1)
        t = (obs if port else jobs).enable(cfg)
        store = (make_sketch_store if port else jax_store)(cfg)
        store.bf_add_many(cfg.bloom_filter_key,
                          np.arange(1_000, dtype=np.int64))
        store.pfadd_many(f"{cfg.hll_key_prefix}LECTURE_1",
                         np.arange(2_000, dtype=np.int64))
        before = t.registry.gauge("attendance_hll_estimate",
                                  backend="memory").value
        assert before > 0
        path = tmp_path / f"{pkg}.npz"
        (snapshot_sketch_store if port else jsnap.snapshot_sketch_store)(
            store, path)
        restored = (make_sketch_store if port else jax_store)(cfg)
        (restore_sketch_store if port else jsnap.restore_sketch_store)(
            restored, path)
        del store  # the old generation is gone: the gauges follow
        assert t.registry.gauge("attendance_hll_estimate",
                                backend="memory").value == before
        fill = t.registry.gauge("attendance_bloom_fill_fraction",
                                backend="memory").value
        assert 0 < fill < 1
        text = t.render()
        assert 'attendance_bloom_estimated_fpr{backend="memory"}' in text
        got[pkg] = {k: v for k, v in _samples(text).items()
                    if k[0] in HEALTH}
        (obs if port else jobs).disable()
    assert got["port"] == got["jax"]
    assert len(got["port"]) == len(HEALTH)


def test_restored_card_store_resumes_reporting(tmp_path):
    """The card store (on the CPU here), restored in place: the gauges
    read the RESTORED generation."""
    cfg = Config(sketch_backend="tpu", metrics_port=-1)
    t = obs.enable(cfg)
    store = make_sketch_store(cfg, device="cpu")
    store.pfadd_many(f"{cfg.hll_key_prefix}LECTURE_1",
                     np.arange(500, dtype=np.int64))
    before = t.registry.gauge("attendance_hll_estimate",
                              backend="tpu").value
    assert before > 0
    path = tmp_path / "sketch.npz"
    snapshot_sketch_store(store, path)
    restore_sketch_store(store, path)
    assert t.registry.gauge("attendance_hll_estimate",
                            backend="tpu").value == before


@pytest.mark.parametrize("backend", ["memory", "tpu"])
def test_store_chain_restore_keeps_health_gauges(tmp_path, backend):
    """The health half of a store chain's restore: after a base, a
    delta and a restore into a fresh store, the gauges report the
    restored store's state, equal to the original's."""
    cfg = Config(sketch_backend=backend, metrics_port=-1)
    t = obs.enable(cfg)
    store = make_sketch_store(cfg, device="cpu")
    store.bf_add_many(cfg.bloom_filter_key, np.arange(2_000, dtype=np.int64))
    key = f"{cfg.hll_key_prefix}LECTURE_1"
    store.pfadd_many(key, np.arange(1_000, dtype=np.int64))
    chain = tmp_path / "chain"
    snapshot_sketch_store_chain(store, chain)  # base
    store.pfadd_many(key, np.arange(1_000, 1_500, dtype=np.int64))
    snapshot_sketch_store_chain(store, chain)  # delta
    want = {k: v for k, v in _samples(t.render()).items() if k[0] in HEALTH}
    restored = make_sketch_store(cfg, device="cpu")
    restore_sketch_store(restored, chain)
    del store
    got = {k: v for k, v in _samples(t.render()).items() if k[0] in HEALTH}
    assert got == want
    assert got[("attendance_hll_estimate", f'backend="{backend}"')] > 0
    assert f'attendance_bloom_fill_fraction{{backend="{backend}"}}' in (
        t.render())


# -- the forced word wire -----------------------------------------------------

def test_forced_word_wire_that_cannot_fit_warns_once(caplog):
    """``--wire-format word`` with keys whose bits and the bank bits
    exceed 32 rides the bytes wire and says so once; without the forced
    format it says nothing."""
    from attendance_tpu_torch.pipeline.events import encode_planar_batch

    for wire, warns in (("word", 1), ("auto", 0)):
        pipe = _port_fused(Config(bloom_filter_capacity=1_000,
                                  wire_format=wire),
                           num_events=1_024, frame=1_024)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        n = 512
        for lo in (0, n):
            producer.send(encode_planar_batch({
                "student_id": (np.arange(lo, lo + n, dtype=np.uint32)
                               | np.uint32(1 << 31)),
                "lecture_day": np.full(n, 20260101, np.int32),
                "micros": np.zeros(n, np.int64),
                "is_valid": np.ones(n, bool),
                "event_type": np.zeros(n, np.int8)}))
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            pipe.run(max_events=1_024 + 2 * n, idle_timeout_s=0.2)
        assert caplog.text.count("cannot be honored") == warns, wire
        assert pipe.metrics.wire_dwell.get("bytes", 0) == 2
        pipe.cleanup()


def test_fused_verb_prom_file_carries_the_accuracy_gauges(tmp_path):
    """The ``fused`` verb with ``--metrics-prom`` and ``--audit-sample``:
    a run shorter than the reporter's interval still leaves one block,
    written while the pipeline was alive, with its health and measured
    accuracy gauges; the verb stops the telemetry it started."""
    from attendance_tpu_torch.cli import main as port_main

    prom = tmp_path / "m.prom"
    port_main(["fused", "--device", "cpu", "--num-events", "8192",
               "--frame-size", "4096", "--metrics-prom", str(prom),
               "--audit-sample", "1.0"])
    assert obs.get() is None
    s = _samples(prom.read_text())
    for name in HEALTH:
        assert (name, "") in s, name
    assert s[("attendance_bloom_false_negatives_total", "")] == 0
    assert 0 <= s[("attendance_bloom_measured_fpr", 'surface="fused"')] < 1
    assert s[("attendance_hll_measured_rel_error", 'key="fused"')] < 0.05
    assert s[("attendance_events_total", "")] == 8192
