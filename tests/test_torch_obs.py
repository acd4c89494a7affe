"""The port's telemetry core (``attendance_tpu_torch/obs``) against the JAX
package's (``tests/test_obs.py`` and the metrics half of
``tests/test_observability.py``).

The registry, the exposition text and the flight recorder are held equal
to JAX's on the same operations (tolerance 0: the text byte for byte, and
the golden file the JAX tests pin); a fused run on the CPU goes through
both packages on the same frames and their deterministic samples are
equal (the launch-shape tracker's counts among them), apart from the one
series the port adds. Every test leaves both packages'
process-global telemetry disabled.
"""

import json
import logging
import math
import os
import re
import signal
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.cli import main as jax_main
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.obs import exposition as jexposition
from attendance_tpu.obs import recorder as jrecorder
from attendance_tpu.obs import registry as jregistry
from attendance_tpu_torch import obs
from attendance_tpu_torch.cli import main as port_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs.exposition import (
    MetricsServer, parse_exemplars, parse_prom, quantiles_from_cumulative,
    render)
from attendance_tpu_torch.obs.recorder import FlightRecorder
from attendance_tpu_torch.obs.registry import (
    NUM_BUCKETS, Registry, quantile_from_buckets)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

GOLDEN = Path(__file__).parent / "data" / "obs_exposition.golden"

# Series the JAX package's fused run emits through a plane the port does
# not have yet: none (the port's launch-shape tracker emits the JAX
# recompile tracker's two series).
JAX_ONLY = set()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Telemetry is process-global in both packages: bare in, bare out."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _wait_for(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met before the deadline")
        time.sleep(0.01)


# -- registry semantics ------------------------------------------------------

def test_counter_monotonic():
    c = Registry().counter("c_total")
    c.inc()
    c.inc(41)
    assert c.value == 42
    with pytest.raises(ValueError):
        c.inc(-1)
    assert c.value == 42


def test_gauge_set_add_and_callback():
    g = Registry().gauge("g")
    g.set(10)
    g.add(-3)
    assert g.value == 7
    g.set_function(lambda: 99)
    assert g.value == 99
    g.set(1)  # set clears the callback
    assert g.value == 1


def test_histogram_bucket_boundaries():
    h = Registry().histogram("h", scale=1.0)
    for v in (0, 0.5, 1, 2, 3, 4, 7, 8):
        h.observe(v)
    buckets, total, count = h.snapshot()
    assert count == 8 and total == 25.5
    assert buckets[:5] == [2, 1, 2, 2, 1]
    assert h.bucket_bound(0) == 1.0 and h.bucket_bound(4) == 16.0
    h.observe(2.0 ** 60)  # over range: +Inf (sum, count) only
    buckets, _, count = h.snapshot()
    assert count == 9 and sum(buckets) == 8
    assert buckets[NUM_BUCKETS - 1] == 0


def test_registry_identity_and_kind_mismatch():
    reg = Registry()
    a = reg.counter("x_total", wire="word")
    assert reg.counter("x_total", wire="word") is a
    assert reg.counter("x_total", wire="seg") is not a
    with pytest.raises(ValueError):
        reg.gauge("x_total")


# -- the same operations through both registries -----------------------------

def _apply_ops(reg, seed: int, n_ops: int = 300) -> None:
    """A seeded sequence of registry operations: counters, set/add
    gauges, callback gauges (NaN and infinities among the values) and
    histograms at two scales, with exemplars."""
    rng = np.random.default_rng(seed)
    names = ["attendance_a_total", "attendance_b_total"]
    for _ in range(n_ops):
        op = int(rng.integers(0, 6))
        label = str(int(rng.integers(0, 3)))
        if op == 0:
            reg.counter(names[int(rng.integers(0, 2))], help="a counter",
                        wire=label).inc(int(rng.integers(0, 1000)))
        elif op == 1:
            reg.gauge("attendance_g", help="a gauge", k=label).set(
                float(rng.choice([rng.normal(), 3.0, float("nan"),
                                  float("inf"), -float("inf"), 1e20])))
        elif op == 2:
            reg.gauge("attendance_g", k=label).add(
                float(rng.integers(-5, 5)))
        elif op == 3:
            v = float(rng.integers(0, 1 << 20))
            reg.gauge("attendance_cb", help="a callback",
                      q=label).set_function(lambda v=v: v / 7.0)
        elif op == 4:
            reg.histogram("attendance_lat_seconds", help="latency",
                          stage=label).observe(
                float(rng.lognormal(-8, 3)),
                trace_id=f"{int(rng.integers(0, 1 << 62)):016x}"
                if rng.random() < 0.3 else "")
        else:
            reg.histogram("attendance_size", help="sizes", scale=1.0,
                          verb=label).observe(float(rng.integers(0, 5000)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_is_byte_equal_to_jax_for_the_same_operations(seed):
    ours, theirs = Registry(), jregistry.Registry()
    _apply_ops(ours, seed)
    _apply_ops(theirs, seed)
    text = render(ours)
    assert text == jexposition.render(theirs)
    assert parse_prom(text) == jexposition.parse_prom(text)
    assert parse_exemplars(text) == jexposition.parse_exemplars(text)
    assert parse_exemplars(text)  # the op mix leaves exemplars


@pytest.mark.parametrize("seed", [0, 1])
def test_quantile_from_buckets_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        buckets = [int(x) for x in rng.integers(0, 5, NUM_BUCKETS)
                   * (rng.random(NUM_BUCKETS) < 0.4)]
        count = sum(buckets) + int(rng.integers(0, 3))
        q = float(rng.choice([0.0, 0.5, 0.9, 0.99, 1.0, rng.random()]))
        scale = float(rng.choice([1e6, 1e3, 1.0]))
        a = quantile_from_buckets(buckets, count, q, scale)
        b = jregistry.quantile_from_buckets(buckets, count, q, scale)
        assert a == b or (math.isnan(a) and math.isnan(b))


# -- exposition ---------------------------------------------------------------

def _golden_registry() -> Registry:
    """tests/test_obs.py's golden registry, through the port."""
    reg = Registry()
    c = reg.counter("attendance_events_total", help="Events processed")
    c.inc(41)
    c.inc()
    reg.counter("attendance_wire_frames_total", help="Frames per wire",
                wire="word").inc(3)
    reg.counter("attendance_wire_frames_total", wire="seg").inc(2)
    reg.gauge("attendance_queue_depth", help="Pending messages",
              topic="t", subscription="s").set(7)
    h = reg.histogram("attendance_stage_latency_seconds",
                      help="Per-stage latency", stage="decode")
    h.observe(3e-6)
    h.observe(0.001)
    h.observe(0.5)
    return reg


def test_exposition_matches_golden_file():
    assert render(_golden_registry()) == GOLDEN.read_text()


_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_+][a-zA-Z0-9_]*="[^"]*")*\})? '
    r'(-?\d+(\.\d+)?([eE][-+]?\d+)?|\+Inf|-Inf|NaN)$')


def test_exposition_is_valid_prometheus_text():
    text = render(_golden_registry())
    assert text.endswith("\n")
    for line in text.splitlines():
        if not line.startswith("# "):
            assert _SAMPLE_RE.match(line), line
    cum = [float(v) for n, _, v in parse_prom(text)
           if n == "attendance_stage_latency_seconds_bucket"]
    assert cum == sorted(cum) and cum[-1] == 3


def test_gauge_callback_raising_at_scrape_is_skipped_with_warning(caplog):
    reg = Registry()
    reg.counter("ok_total").inc(5)
    reg.gauge("bad_gauge", key="a").set_function(
        lambda: (_ for _ in ()).throw(RuntimeError("gone")))
    reg.gauge("bad_gauge", key="b").set(3)
    with caplog.at_level(logging.WARNING,
                         logger="attendance_tpu_torch.obs.exposition"):
        text = render(reg)
    assert "ok_total 5" in text and 'bad_gauge{key="b"} 3' in text
    assert 'key="a"' not in text
    assert any("raised at scrape time" in r.message for r in caplog.records)


def test_gauge_nan_inf_render_per_prometheus_text_rules():
    reg = Registry()
    reg.gauge("g", k="nan").set(float("nan"))
    reg.gauge("g", k="pinf").set(float("inf"))
    reg.gauge("g", k="ninf").set(float("-inf"))
    text = render(reg)
    assert 'g{k="nan"} NaN' in text and 'g{k="pinf"} +Inf' in text
    assert 'g{k="ninf"} -Inf' in text


def test_http_endpoint_survives_raising_gauge():
    t = obs.enable(Config(metrics_port=-1))
    t.registry.gauge("doomed").set_function(
        lambda: (_ for _ in ()).throw(OSError("no device")))
    t.events.inc(3)
    with urllib.request.urlopen(
            f"http://127.0.0.1:{t.http_port}/metrics", timeout=10) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    assert "attendance_events_total 3" in body
    assert not [l for l in body.splitlines() if l.startswith("doomed ")]


def test_file_reporter_appends_scrape_blocks(tmp_path):
    path = tmp_path / "metrics.prom"
    t = obs.enable(Config(metrics_prom=str(path), metrics_interval_s=0.02))
    t.events.inc(7)
    _wait_for(lambda: path.exists()
              and path.read_text().count("# scrape ") >= 2)
    obs.disable()  # stop() writes one final block
    text = path.read_text()
    assert text.count("# scrape ") >= 3
    assert dict((n, v) for n, _, v in parse_prom(text))[
        "attendance_events_total"] == "7"


def test_add_remove_route_under_concurrent_scrape():
    reg = Registry()
    reg.counter("attendance_events_total", help="e").inc(1)
    server = MetricsServer(reg, port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    stop = threading.Event()
    failures, ok = [], []

    def scraper(path):
        while not stop.is_set():
            try:
                with urllib.request.urlopen(base + path, timeout=5) as r:
                    assert r.status == 200
                    ok.append(path)
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    failures.append(e)
            except Exception as e:  # noqa: BLE001 — any break fails
                failures.append(e)

    threads = [threading.Thread(target=scraper, args=(p,))
               for p in ("/metrics", "/extra") for _ in range(2)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 1.0
        while time.time() < deadline:
            server.add_route("/extra", lambda *a: (200, "text/plain", b"k"))
            server.remove_route("/extra")
        server.remove_route("/extra")  # idempotent on absent
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        server.stop()
    assert not failures, failures[:3]
    assert "/metrics" in ok


# -- label-cardinality guard and quantiles ------------------------------------

def test_cardinality_cap_folds_overflow_into_unexported_sink(caplog):
    reg = Registry(max_series=3)
    handles = [reg.counter("leaky_total", day=str(d)) for d in range(3)]
    with caplog.at_level(logging.ERROR,
                         logger="attendance_tpu_torch.obs.registry"):
        over_a = reg.counter("leaky_total", day="3")
        over_b = reg.counter("leaky_total", day="4")
    assert over_a is over_b and over_a not in handles
    over_a.inc(5)
    text = render(reg)
    assert text.count("leaky_total{") == 3 and "overflow" not in text
    assert len([r for r in caplog.records
                if "label-cardinality cap" in r.message]) == 1
    # The self-gauge counts the exported series only.
    assert [v for n, _, v in parse_prom(text)
            if n == "attendance_metric_series_total"] == ["4"]
    unlimited = Registry(max_series=0)
    for d in range(1500):
        unlimited.counter("big_total", day=str(d))
    assert render(unlimited).count("big_total{") == 1500


def test_quantiles_from_cumulative_edge_cases():
    assert all(math.isnan(v) for v in
               quantiles_from_cumulative([], (0.5, 0.99)))
    (p100,) = quantiles_from_cumulative([(0.5, 4)], (1.0,))
    assert p100 == 0.5
    p50, p99 = quantiles_from_cumulative(
        [(0.1, 5), (float("inf"), 10)], (0.5, 0.99))
    assert p50 <= 0.1 and math.isinf(p99)


# -- flight recorder ---------------------------------------------------------

def test_flight_ring_wraps_in_order_and_dumps_jax_keys(tmp_path):
    ours, theirs = FlightRecorder(4), jrecorder.FlightRecorder(4)
    for i in range(10):
        ours.record({"i": i})
        theirs.record({"i": i})
    assert ours.total == 10 and ours.snapshot() == theirs.snapshot()
    a = json.loads(ours.dump(tmp_path / "a.json").read_text())
    b = json.loads(theirs.dump(tmp_path / "b.json").read_text())
    assert a.keys() == b.keys()
    for key in ("reason", "ring_size", "total_records", "records"):
        assert a[key] == b[key]


def test_sigusr1_dump_and_disable_restores_the_handler(tmp_path):
    dump = tmp_path / "flight.json"
    before = signal.getsignal(signal.SIGUSR1)
    t = obs.enable(Config(flight_recorder=8, flight_path=str(dump)))
    assert signal.getsignal(signal.SIGUSR1) is not before
    for i in range(3):
        t.record_batch(ts=float(i), events=i)
    os.kill(os.getpid(), signal.SIGUSR1)
    _wait_for(dump.exists)
    doc = json.loads(dump.read_text())
    assert doc["reason"] == "SIGUSR1" and doc["total_records"] == 3
    assert [r["events"] for r in doc["records"]] == [0, 1, 2]
    obs.disable()
    assert signal.getsignal(signal.SIGUSR1) == before


# -- the hooks -----------------------------------------------------------------

def _port_fused(config, num_events=4_096, frame=1_024, seed=0, sp=1, dp=1):
    from attendance_tpu_torch.parallel import make_mesh
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    client = MemoryClient(MemoryBroker())
    if sp * dp > 1:
        pipe = FusedPipeline(config, client=client, num_banks=8,
                             mesh=make_mesh(sp, dp, ["cpu"] * (sp * dp)))
    else:
        pipe = FusedPipeline(config, client=client, num_banks=8,
                             device="cpu")
    roster, frames = generate_frames(num_events, frame, roster_size=4_000,
                                     num_lectures=4, seed=seed)
    pipe.preload(roster)
    producer = client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    return pipe


def _jax_fused(config, num_events=4_096, frame=1_024, seed=0):
    from attendance_tpu.pipeline.fast_path import FusedPipeline
    from attendance_tpu.pipeline.loadgen import generate_frames
    from attendance_tpu.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(config, client=client, num_banks=8)
    roster, frames = generate_frames(num_events, frame, roster_size=4_000,
                                     num_lectures=4, seed=seed)
    pipe.preload(roster)
    producer = client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    return pipe


def test_run_loop_crash_dumps_flight_ring(tmp_path):
    dump = tmp_path / "crash.json"
    config = Config(bloom_filter_capacity=2_000, flight_recorder=16,
                    flight_path=str(dump))
    pipe = _port_fused(config, num_events=1_024, frame=512)

    def boom(block=0):
        raise RuntimeError("synthetic ack-path failure")

    pipe._drain_inflight = boom
    with pytest.raises(RuntimeError, match="synthetic"):
        pipe.run(max_events=1_024, idle_timeout_s=0.2)
    doc = json.loads(dump.read_text())
    assert doc["reason"] == "run-loop-exception"
    assert doc["records"][-1]["events"] == 512
    pipe.cleanup()


def test_disabled_flags_leave_hot_paths_bare():
    """With every telemetry flag unset nothing is created: the global is
    None and so is every handle the hooks branch on."""
    from attendance_tpu_torch.pipeline.processor import AttendanceProcessor
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    pipe = _port_fused(Config(bloom_filter_capacity=1_000),
                       num_events=1_024, frame=1_024)
    pipe.run(max_events=1_024, idle_timeout_s=0.1)
    proc = AttendanceProcessor(Config(sketch_backend="memory"),
                               client=MemoryClient(MemoryBroker()),
                               device="cpu")
    assert obs.get() is None
    # As in JAX, the accuracy audit is a telemetry flag: a sample above 0
    # turns telemetry on (and builds the auditor); 0 does not.
    assert obs.enabled_in(Config(audit_sample=1.0))
    assert obs.enabled_in(Config(audit_sample=0.01))
    assert not obs.enabled_in(Config(audit_sample=0.0))
    assert jobs.enabled_in(JaxConfig(audit_sample=0.01))
    assert pipe._obs is None and proc._obs is None
    assert pipe._tracer is None and proc._tracer is None
    assert pipe._auditor is None and proc.sketch._auditor is None
    for name in ("_h_dequeue", "_h_decode", "_h_dispatch", "_h_device",
                 "_h_snap_write", "_h_snap_blocked", "_h_gap", "_busy",
                 "_c_xfer", "_g_delta_bytes", "_g_chain_len"):
        assert getattr(pipe, name) is None, name
    for name in ("_h_assembly", "_h_sketch", "_h_persist"):
        assert getattr(proc, name) is None, name
    sub = pipe.client._broker.topic(pipe.config.pulsar_topic).subscriptions[
        pipe.SUBSCRIPTION]
    assert sub._obs_recv_msgs is None and sub._obs_redelivered is None
    pipe.cleanup()


def _samples(text):
    return {(n, l): float(v) for n, l, v in parse_prom(text)}


def test_http_scrape_of_fused_run_exposes_contract_metrics(tmp_path):
    config = Config(bloom_filter_capacity=5_000, metrics_port=-1,
                    flight_recorder=16,
                    flight_path=str(tmp_path / "flight.json"))
    pipe = _port_fused(config)
    pipe.run(max_events=4_096, idle_timeout_s=0.3)
    t = obs.get()
    with urllib.request.urlopen(
            f"http://127.0.0.1:{t.http_port}/metrics", timeout=10) as r:
        s = _samples(r.read().decode())
    assert s[("attendance_events_total", "")] == 4_096
    assert s[("attendance_frames_total", "")] == 4
    assert s[("attendance_wire_frames_total", 'wire="word"')] == 4
    assert s[("attendance_stage_latency_seconds_count",
              'stage="dispatch"')] == 4
    assert any(n == "attendance_queue_depth" for n, _ in s)
    # The frames' wire buffers: 4 frames of 1,024 words.
    assert s[("attendance_device_transfer_bytes_total",
              'direction="h2d",site="frame",wire="word"')] == 4 * 4_096
    pipe.cleanup()


def test_fused_run_samples_equal_jax(tmp_path, monkeypatch):
    """The same frames through both packages with telemetry on: every
    deterministic sample is equal; the series sets differ by JAX_ONLY and
    the port's per-frame wire bytes only; the flight records carry the
    same keys and deterministic fields."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    kw = dict(bloom_filter_capacity=5_000, flight_recorder=16)
    jt = jobs.enable(JaxConfig(flight_path=str(tmp_path / "jf.json"), **kw))
    jpipe = _jax_fused(JaxConfig(transport_backend="memory", **kw))
    jpipe.run(max_events=4_096, idle_timeout_s=0.3)
    jtext = jt.render()
    jt.dump_flight("test")
    jpipe.cleanup()
    jobs.disable()
    pt = obs.enable(Config(flight_path=str(tmp_path / "pf.json"), **kw))
    pipe = _port_fused(Config(**kw))
    pipe.run(max_events=4_096, idle_timeout_s=0.3)
    ptext = pt.render()
    pt.dump_flight("test")
    pipe.cleanup()

    js, ps = _samples(jtext), _samples(ptext)
    port_only = {k for k in ps if k[0] == "attendance_device_transfer_"
                 "bytes_total" and 'site="frame"' in k[1]}
    assert {n for n, _ in js} - {n for n, _ in ps} == JAX_ONLY
    assert set(ps) - set(js) == port_only
    jax_only = {k for k in js if k[0] in JAX_ONLY}
    assert set(js) - set(ps) == jax_only
    deterministic = [
        ("attendance_events_total", ""), ("attendance_frames_total", ""),
        ("attendance_wire_frames_total", 'wire="word"'),
        ("attendance_device_transfer_bytes_total",
         'direction="h2d",site="preload"'),
        ("attendance_broker_received_messages_total",
         'subscription="attendance_fused",topic="attendance-events"'),
        ("attendance_broker_sent_messages_total",
         'topic="attendance-events"'),
        ("attendance_dispatch_gap_seconds_count", ""),
        ("attendance_recompiles_total", 'fn="step_words"'),
        ("attendance_recompiles_steady_total", 'fn="step_words"')]
    for stage in ("dequeue_wait", "decode", "dispatch", "snapshot_write",
                  "snapshot_blocked"):
        deterministic.append(("attendance_stage_latency_seconds_count",
                              f'stage="{stage}"'))
    for key in deterministic:
        assert ps[key] == js[key], key
    assert ps[("attendance_metric_series_total", "")] == (
        js[("attendance_metric_series_total", "")] - len(jax_only)
        + len(port_only))
    jdoc = json.loads((tmp_path / "jf.json").read_text())
    pdoc = json.loads((tmp_path / "pf.json").read_text())
    assert jdoc.keys() == pdoc.keys()
    assert len(jdoc["records"]) == len(pdoc["records"]) == 4
    for a, b in zip(jdoc["records"], pdoc["records"]):
        assert a.keys() == b.keys() and a["stages"].keys() == b["stages"].keys()
        # "inflight" counts the JAX pipeline's not-yet-ready arrays,
        # which its CPU backend makes a race; the port's CPU frames
        # complete in the call.
        for key in ("events", "wire"):
            assert a[key] == b[key], key


def test_mesh_shard_events_equal_jax(monkeypatch):
    """On a (2, 2) mesh the per-replica event gauges equal JAX's, and
    the word wire's frame bytes are the padded word buffers."""
    from attendance_tpu.pipeline.fast_path import (
        FusedPipeline as JaxPipeline)
    from attendance_tpu.pipeline.loadgen import generate_frames
    from attendance_tpu.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    monkeypatch.setenv("ATP_NATIVE", "0")
    kw = dict(bloom_filter_capacity=5_000, num_shards=2, num_replicas=2)
    jt = jobs.enable(JaxConfig(metrics_port=-1))
    client = MemoryClient(MemoryBroker())
    jpipe = JaxPipeline(JaxConfig(transport_backend="memory", **kw),
                        client=client, num_banks=8)
    roster, frames = generate_frames(3_000, 1_000, roster_size=4_000,
                                     num_lectures=4, seed=0)
    jpipe.preload(roster)
    producer = client.create_producer(jpipe.config.pulsar_topic)
    for f in frames:
        producer.send(f)
    jpipe.run(max_events=3_000, idle_timeout_s=0.3)
    js = _samples(jt.render())
    jpipe.cleanup()
    jobs.disable()
    pt = obs.enable(Config(metrics_port=-1))
    pipe = _port_fused(Config(**kw), num_events=3_000, frame=1_000, sp=2,
                       dp=2)
    pipe.run(max_events=3_000, idle_timeout_s=0.3)
    ps = _samples(pt.render())
    pipe.cleanup()
    shards = {k: v for k, v in js.items() if k[0] == "attendance_shard_events"}
    assert len(shards) == 2 and sum(shards.values()) == 3_000
    for key, value in shards.items():
        assert ps[key] == value, key
    assert ps[("attendance_wire_frames_total", 'wire="word"')] == 3
    assert ps[("attendance_device_transfer_bytes_total",
               'direction="h2d",site="frame",wire="word"')] == 3 * 4 * 1_024


def test_processor_stages_count_its_batches(tmp_path):
    from attendance_tpu_torch.cli import run_pipeline

    t = obs.enable(Config(metrics_port=-1))
    proc, report = run_pipeline(
        Config(sketch_backend="memory", batch_size=64), 60, 5, seed=3,
        device="cpu")
    s = _samples(t.render())
    batches = proc.metrics.batches
    proc.cleanup()
    assert s[("attendance_events_total", "")] == report.message_count
    assert s[("attendance_frames_total", "")] == batches
    for stage in ("sketch", "persist"):
        assert s[("attendance_stage_latency_seconds_count",
                  f'stage="{stage}"')] == batches
    # The generator published before the processor ran: every collect
    # assembled a batch.
    assert s[("attendance_stage_latency_seconds_count",
              'stage="batch_assembly"')] == batches


# -- the telemetry verb ---------------------------------------------------------

def test_cli_telemetry_verb_prints_the_same_text_as_jax(tmp_path, capsys):
    fr = FlightRecorder(4)
    fr.record({"ts": 1.0, "events": 512, "wire": "word"})
    dump = fr.dump(tmp_path / "flight.json")
    prom = tmp_path / "m.prom"
    prom.write_text("# scrape 1.0\n" + render(_golden_registry()))
    from attendance_tpu_torch.obs.tracing import Tracer
    tr = Tracer()
    with tr.span("batch", role="fused-pipeline"):
        with tr.span("decode"):
            pass
    trace = tr.flush(tmp_path / "trace.json")
    for path in (dump, prom, trace):
        port_main(["telemetry", str(path)])
        ours = capsys.readouterr().out
        jax_main(["telemetry", str(path)])
        theirs = capsys.readouterr().out
        assert ours == theirs and ours
    # A flight dump is not an attribution document: both verbs exit 2.
    for main in (port_main, jax_main):
        with pytest.raises(SystemExit) as exc:
            main(["telemetry", str(dump), "--attribution"])
        assert exc.value.code == 2
    from attendance_tpu_torch.cli import _follow_file
    assert _follow_file(str(prom), 32, 0.01, max_rounds=2) == 1
    capsys.readouterr()


# -- the fused run's metrics line ---------------------------------------------

# The metrics line's timed values (type-checked only); every other value
# is counted and held equal to JAX's.
TIMED_KEYS = {"events_per_second", "device_seconds", "wall_seconds",
              "snapshot_write_s", "snapshot_blocked_s"}
POISON = b"\x07 not a frame"


def _two_runs_with_metrics_json(pkg, tmp_path, case):
    """Two runs of one package's fused pipeline with ``metrics_json`` set
    (the first bounded by the stream's events, the second until idle);
    returns the file's lines."""
    path = tmp_path / f"{pkg}.jsonl"
    kw = dict(bloom_filter_capacity=5_000, metrics_json=str(path))
    if case == "snapshots":
        kw.update(snapshot_dir=str(tmp_path / f"{pkg}-snap"),
                  snapshot_every_batches=2)
    if case == "poison":
        kw.update(max_redeliveries=1)
    if pkg == "jax":
        pipe = _jax_fused(JaxConfig(transport_backend="memory", **kw))
    else:
        pipe = _port_fused(Config(**kw))
    if case == "poison":
        # Behind the stream: the second run nacks it once, then
        # dead-letters it on its redelivery.
        pipe.client.create_producer(pipe.config.pulsar_topic).send(POISON)
    try:
        pipe.run(max_events=4_096, idle_timeout_s=0.3)
        pipe.run(idle_timeout_s=0.3)
    finally:
        pipe.cleanup()
    return [json.loads(x) for x in path.read_text().splitlines()]


@pytest.mark.parametrize("case", ["plain", "snapshots", "poison"])
def test_fused_metrics_json_line_equals_jax(case, tmp_path, monkeypatch,
                                            caplog):
    """The counterpart of JAX's
    ``test_metrics_json_sink_appends_one_line_per_run``: the same frames
    and two runs through both packages give two lines each, with JAX's
    keys in JAX's order and equal counted values (tolerance 0); the
    ``Fused metrics:`` INFO text is JAX's but for the rate and the
    device seconds."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    with caplog.at_level(logging.INFO):
        jlines = _two_runs_with_metrics_json("jax", tmp_path, case)
        plines = _two_runs_with_metrics_json("port", tmp_path, case)
    assert len(jlines) == len(plines) == 2
    for j, p in zip(jlines, plines):
        assert list(p) == list(j)
        for key in j:
            if key in TIMED_KEYS:
                assert type(p[key]) is type(j[key]), key
            else:
                assert p[key] == j[key], key
    first = plines[0]
    assert first["events"] == 4_096 and first["batches"] == 4
    assert first["events_per_second"] > 0
    assert first["wire_dwell"] == {"word": 4}
    assert first["fpr_is_lower_bound"] is True
    assert first["estimated_fpr"] is None
    # Validity stays on the device: the line carries the host counters.
    assert first["valid_events"] == first["invalid_events"] == 0
    if case == "snapshots":
        assert plines[1]["snapshots"] > 0
    if case == "poison":
        assert [(x["nacked_batches"], x["dead_lettered"])
                for x in plines] == [(0, 0), (1, 1)]
    texts = {pkg: [r.getMessage() for r in caplog.records
                   if r.name == f"{pkg}.pipeline.fast_path"
                   and r.getMessage().startswith("Fused metrics: ")]
             for pkg in ("attendance_tpu", "attendance_tpu_torch")}
    jt, pt = texts["attendance_tpu"], texts["attendance_tpu_torch"]
    assert len(jt) == len(pt) == 2
    for a, b in zip(jt, pt):
        assert b.split("(")[0] == a.split("(")[0]
        assert b.split("est. bloom FPR")[1] == a.split("est. bloom FPR")[1]
        assert "validity in store (async)" in b


def test_metrics_line_rate_is_null_without_a_wall_clock():
    """``to_dict`` of counters no run timed equals JAX's: a null rate,
    the mean of the frame sizes rounded to one place."""
    from attendance_tpu.pipeline.processor import ProcessorMetrics
    from attendance_tpu_torch.pipeline.fast_path import FusedMetrics

    ours, theirs = FusedMetrics(events=10, batches=3), ProcessorMetrics(
        events=10, batches=3, batch_sizes=[4, 3, 3])
    assert ours.to_dict() == theirs.to_dict()
    assert ours.to_dict()["events_per_second"] is None
    assert ours.to_dict()["mean_batch"] == 3.3
    assert FusedMetrics().to_dict() == ProcessorMetrics().to_dict()


def test_failed_metrics_line_append_raises(tmp_path):
    """A metrics line that cannot be appended fails the run (as the
    processor's sink does), after the run's frames were handled."""
    config = Config(bloom_filter_capacity=5_000,
                    metrics_json=str(tmp_path / "no-such-dir" / "m.jsonl"))
    pipe = _port_fused(config)
    try:
        with pytest.raises(OSError):
            pipe.run(max_events=4_096, idle_timeout_s=0.3)
        assert pipe.metrics.events == 4_096
    finally:
        pipe.cleanup()


@pytest.mark.parametrize("redeliveries", [0, 1])
def test_fused_verb_max_redeliveries_and_metrics_json_equal_jax(
        redeliveries, tmp_path, monkeypatch):
    """``fused --max-redeliveries N --metrics-json F`` with one
    undecodable frame published ahead of the verb's stream: both
    packages nack it N times in the run (its redelivery waits behind the
    stream) or, at 0, dead-letter it at once, and write equal lines."""
    from attendance_tpu.transport.memory_broker import (
        MemoryBroker as JaxBroker, MemoryClient as JaxClient)
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    monkeypatch.setenv("ATP_NATIVE", "0")
    args = ["fused", "--num-events", "8192", "--frame-size", "2048",
            "--num-lectures", "2", "--bloom-capacity", "8192",
            "--max-redeliveries", str(redeliveries)]
    lines = {}
    for pkg, main, broker, client in (
            ("jax", jax_main, JaxBroker, JaxClient),
            ("port", port_main, MemoryBroker, MemoryClient)):
        broker.reset_shared()
        client(broker.shared()).create_producer(
            Config().pulsar_topic).send(POISON)
        path = tmp_path / f"{pkg}.jsonl"
        main(args + ["--metrics-json", str(path)]
             + (["--device", "cpu"] if pkg == "port" else []))
        lines[pkg] = [json.loads(x) for x in path.read_text().splitlines()]
        broker.reset_shared()
    assert len(lines["jax"]) == len(lines["port"]) == 1
    j, p = lines["jax"][0], lines["port"][0]
    assert list(p) == list(j)
    for key in j:
        if key in TIMED_KEYS:
            assert type(p[key]) is type(j[key]), key
        else:
            assert p[key] == j[key], key
    assert p["events"] == 8192
    assert (p["nacked_batches"], p["dead_lettered"]) == (
        (1, 0) if redeliveries else (0, 1))
