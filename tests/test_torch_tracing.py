"""The port's span tracing (``attendance_tpu_torch/obs/tracing.py``) and the
trace context its hooks carry, against the JAX package's
(``tests/test_tracing.py``).

The context wire format and the Chrome-trace export are the JAX
package's: a context from either package parses in the other, across
the byte-compatible socket broker in both directions, the export under a
fixed clock matches the JAX golden file, and a traced fused run gives the
same span trees (names and parent structure) in both packages on the same
frames. Gossip merge frames now carry the fence span's ``traceparent``
and stay byte-equal to JAX's for equal arguments.
"""

import itertools
import json
import time
import types
from pathlib import Path

import numpy as np
import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.federation import gossip as jgossip
from attendance_tpu.obs import registry as jregistry
from attendance_tpu.obs import tracing as jtracing
from attendance_tpu.transport import memory_broker as jbroker
from attendance_tpu.transport import socket_broker as jsocket
from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.federation import gossip
from attendance_tpu_torch.obs.registry import Registry
from attendance_tpu_torch.obs.tracing import (
    TRACEPARENT, SpanContext, Tracer, format_ctx, parse_ctx)
from attendance_tpu_torch.transport import memory_broker
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from attendance_tpu_torch.transport.socket_broker import (
    BrokerServer, SocketClient)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

GOLDEN = Path(__file__).parent / "data" / "trace_export.golden"


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


# -- context codec and the tracer core ----------------------------------------

def test_ctx_roundtrip_malformed_and_equal_to_jax():
    ctx = SpanContext(0xdeadbeef, 0x1234, 17)
    assert parse_ctx(format_ctx(ctx)) == ctx
    assert format_ctx(ctx) == jtracing.format_ctx(
        jtracing.SpanContext(0xdeadbeef, 0x1234, 17))
    assert tuple(jtracing.parse_ctx(format_ctx(ctx))) == tuple(ctx)
    for bad in (None, "", "zz", "1-2", "x-y-z", 42, "1-2-3-4"):
        assert parse_ctx(bad) is None and jtracing.parse_ctx(bad) is None
    assert TRACEPARENT == jtracing.TRACEPARENT


def test_span_buffer_is_bounded_and_activation_nests():
    tr = Tracer(limit=4)
    for i in range(7):
        with tr.span(f"s{i}"):
            pass
    assert len(tr) == 4 and tr.dropped == 3
    assert tr.export()["otherData"]["dropped_spans"] == 3
    tr = Tracer()
    with tr.span("outer") as outer:
        with tr.span("inner"):
            pass
    inner = [s for s in tr.snapshot() if s.name == "inner"][0]
    assert (inner.trace_id, inner.parent_id) == (outer.trace_id,
                                                 outer.span_id)
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    boom = [s for s in tr.snapshot() if s.name == "boom"][0]
    assert "RuntimeError" in boom.args["error"]


def _deterministic(cls):
    ids = itertools.count(1)
    return cls(_clock=lambda: 0.0, _ids=lambda: next(ids), _epoch=0.0)


def _golden_spans(tr):
    pub = tr.add_span("publish", 0.0, 0.0005, trace_id=1,
                      role="producer", args={"topic": "t", "seq": 0})
    batch = tr.add_span("batch", 0.001, 0.009, trace_id=1,
                        parent_id=pub.span_id, role="fused-pipeline",
                        args={"seq": 0})
    tr.add_span("decode", 0.001, 0.002, trace_id=1,
                parent_id=batch.span_id, role="fused-pipeline")
    tr.add_span("dispatch", 0.002, 0.009, trace_id=1,
                parent_id=batch.span_id, role="fused-pipeline",
                args={"wire": "word"})
    doc = tr.export()
    doc.pop("otherData")  # carries the live pid
    return json.dumps(doc, indent=1, sort_keys=True) + "\n"


def test_chrome_export_matches_golden_file_and_jax():
    ours = _golden_spans(_deterministic(Tracer))
    assert ours == GOLDEN.read_text()
    assert ours == _golden_spans(_deterministic(jtracing.Tracer))


# -- propagation ----------------------------------------------------------------

def test_memory_broker_properties_survive_nack_and_takeover():
    client = MemoryClient(MemoryBroker())
    client.create_producer("t").send(
        b"payload", properties={TRACEPARENT: "aa-bb-cc", "k": "v"})
    consumer = client.subscribe("t", "s")
    msg = consumer.receive(timeout_millis=500)
    consumer.negative_acknowledge(msg)
    again = consumer.receive(timeout_millis=500)
    assert again.redelivery_count == 1
    assert again.properties() == {TRACEPARENT: "aa-bb-cc", "k": "v"}
    consumer.close()
    taken = client.subscribe("t", "s").receive(timeout_millis=500)
    assert taken.redelivery_count == 2 and taken.properties()["k"] == "v"


def test_producer_injects_traceparent_when_tracing(tmp_path):
    t = obs.enable(Config(trace_out=str(tmp_path / "t.json")))
    client = MemoryClient(MemoryBroker())
    client.create_producer("t").send(b"x")
    client.create_producer("t").send_many([b"y", b"z"])
    msgs = client.subscribe("t", "s").receive_many(3, timeout_millis=500)
    ctxs = [parse_ctx(m.properties()[TRACEPARENT]) for m in msgs]
    pub = [s for s in t.tracer.snapshot() if s.name == "publish"]
    bulk = [s for s in t.tracer.snapshot() if s.name == "publish_many"]
    assert (ctxs[0].trace_id, ctxs[0].span_id) == (pub[0].trace_id,
                                                   pub[0].span_id)
    assert all(c.span_id == bulk[0].span_id for c in ctxs[1:])
    assert len({c.trace_id for c in ctxs}) == 3


def test_traceparent_crosses_packages_over_the_socket_broker(tmp_path):
    """A JAX producer's context parses in a port consumer across a port
    broker, and a port producer's in a JAX consumer across a JAX broker:
    each names the producer's own publish span."""
    jt = jobs.enable(JaxConfig(trace_out=str(tmp_path / "j.json")))
    pt = obs.enable(Config(trace_out=str(tmp_path / "p.json")))
    server = BrokerServer(port=0).start()
    jserver = jsocket.BrokerServer(port=0).start()
    try:
        jsocket.SocketClient(server.address).create_producer("t").send(b"a")
        got = SocketClient(server.address).subscribe("t", "s").receive(
            timeout_millis=5000)
        ctx = parse_ctx(got.properties()[TRACEPARENT])
        jpub = [s for s in jt.tracer.snapshot() if s.name == "publish"][-1]
        assert (ctx.trace_id, ctx.span_id) == (jpub.trace_id, jpub.span_id)
        SocketClient(jserver.address).create_producer("t").send(b"b")
        got = jsocket.SocketClient(jserver.address).subscribe(
            "t", "s").receive(timeout_millis=5000)
        ctx = jtracing.parse_ctx(got.properties()[TRACEPARENT])
        ppub = [s for s in pt.tracer.snapshot() if s.name == "publish"][-1]
        assert (ctx.trace_id, ctx.span_id) == (ppub.trace_id, ppub.span_id)
    finally:
        server.stop()
        jserver.stop()


def test_retry_span_parents_under_publish(tmp_path):
    """A frame that fails decode is nacked and redelivered: every retry
    span parents under the same publish span as the first attempt."""
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline

    trace_path = tmp_path / "trace.json"
    config = Config(bloom_filter_capacity=1_000, trace_out=str(trace_path),
                    max_redeliveries=2)
    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(config, client=client, num_banks=4, device="cpu")
    client.create_producer(config.pulsar_topic).send(b"not-a-frame")
    pipe.run(max_events=1, idle_timeout_s=0.3)
    assert pipe.metrics.dead_lettered == 1
    pipe.cleanup()
    evs = [e for e in json.loads(trace_path.read_text())["traceEvents"]
           if e.get("ph") == "X"]
    pub = [e for e in evs if e["name"] == "publish"]
    retries = [e for e in evs if e["name"] == "retry"]
    batches = [e for e in evs if e["name"] == "batch"]
    assert len(pub) == len(batches) == 1 and len(retries) == 2
    for e in retries + batches:
        assert e["args"]["trace_id"] == pub[0]["args"]["trace_id"]
        assert e["args"]["parent_span_id"] == pub[0]["args"]["span_id"]
    assert [e["args"]["redelivery"] for e in retries] == [1, 2]


# -- traced runs -----------------------------------------------------------------

def _trees(doc, skip=("device_wait",)):
    """{trace: sorted (span name, parent span name)} of an export, the
    spans named in ``skip`` left out."""
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    name_of = {e["args"]["span_id"]: e["name"] for e in evs}
    out = {}
    for e in evs:
        if e["name"] in skip:
            continue
        parent = name_of.get(e["args"].get("parent_span_id"))
        out.setdefault(e["args"]["trace_id"], []).append((e["name"], parent))
    return sorted(sorted(v) for v in out.values())


def _traced_runs(tmp_path, monkeypatch, flight=0):
    """The same frames through both packages' fused pipelines with
    tracing on; returns (JAX export, port export, port telemetry)."""
    from attendance_tpu.pipeline.fast_path import (
        FusedPipeline as JaxPipeline)
    from attendance_tpu.pipeline.loadgen import generate_frames as jframes
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames

    monkeypatch.setenv("ATP_NATIVE", "0")
    out = []
    for pkg in ("jax", "port"):
        path = tmp_path / f"{pkg}.json"
        kw = dict(bloom_filter_capacity=5_000, trace_out=str(path),
                  flight_recorder=flight,
                  flight_path=str(tmp_path / f"{pkg}-flight.json"))
        if pkg == "jax":
            t = jobs.enable(JaxConfig(**kw))
            client = jbroker.MemoryClient(jbroker.MemoryBroker())
            pipe = JaxPipeline(JaxConfig(transport_backend="memory", **kw),
                               client=client, num_banks=8)
            gen = jframes
        else:
            t = obs.enable(Config(**kw))
            client = MemoryClient(MemoryBroker())
            pipe = FusedPipeline(Config(**kw), client=client, num_banks=8,
                                 device="cpu")
            gen = generate_frames
        roster, frames = gen(4_096, 1_024, roster_size=4_000,
                             num_lectures=4, seed=0)
        pipe.preload(roster)
        producer = client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=4_096, idle_timeout_s=0.3)
        if flight:
            t.dump_flight("test")
        pipe.cleanup()
        out.append(json.loads(path.read_text()))
        if pkg == "jax":
            jobs.disable()
    return out[0], out[1], obs.get()


def test_traced_fused_run_span_trees_equal_jax(tmp_path, monkeypatch):
    jdoc, pdoc, _ = _traced_runs(tmp_path, monkeypatch, flight=16)
    trees = _trees(pdoc)
    assert trees == _trees(jdoc)
    assert len(trees) == 4  # one trace a published frame
    assert trees[0] == sorted([
        ("publish", None), ("batch", "publish"),
        ("dequeue_wait", "batch"), ("decode", "batch"),
        ("dispatch", "batch")])
    roles = {e["args"]["name"] for e in pdoc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert roles == {"producer", "fused-pipeline"}
    # The flight records name the traces of their batches.
    flight = json.loads((tmp_path / "port-flight.json").read_text())
    traces = {r["trace"] for r in flight["records"]}
    exported = {e["args"]["trace_id"] for e in pdoc["traceEvents"]
                if e.get("ph") == "X"}
    assert len(traces) == 4 and traces <= exported


def test_mesh_replica_spans_nest_under_batch_spans(tmp_path, monkeypatch):
    from attendance_tpu_torch.parallel import make_mesh
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames

    monkeypatch.setenv("ATP_NATIVE", "0")
    path = tmp_path / "t.json"
    config = Config(bloom_filter_capacity=5_000, num_shards=2,
                    num_replicas=2, trace_out=str(path))
    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(config, client=client, num_banks=8,
                         mesh=make_mesh(2, 2, ["cpu"] * 4))
    roster, frames = generate_frames(2_000, 1_000, roster_size=4_000,
                                     num_lectures=4, seed=0)
    pipe.preload(roster)
    producer = client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=2_000, idle_timeout_s=0.3)
    pipe.cleanup()
    doc = json.loads(path.read_text())
    trees = _trees(doc)
    assert len(trees) == 2
    for tree in trees:
        assert tree.count(("replica_dispatch", "batch")) == 2
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"
             and e["name"] == "replica_dispatch"]
    assert sorted(e["args"]["events"] for e in spans) == [488, 488, 512, 512]


def test_bridge_relays_trace_context_end_to_end(tmp_path):
    """generator JSON -> bridge -> fused pipeline is one trace: each batch
    span's trace is a bridge_forward's, rooted at a generator publish."""
    import dataclasses

    from attendance_tpu_torch.pipeline.bridge import JsonBinaryBridge
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.generator import (
        generate_student_data)

    config = Config(bloom_filter_capacity=2_000, batch_size=512,
                    trace_out=str(tmp_path / "trace.json"))
    t = obs.enable(config)
    broker = MemoryBroker()
    bridge = JsonBinaryBridge(config, client=MemoryClient(broker))
    pipe = FusedPipeline(
        dataclasses.replace(config, pulsar_topic=bridge.out_topic),
        client=MemoryClient(broker), num_banks=8, device="cpu")
    report = generate_student_data(
        producer=MemoryClient(broker).create_producer(config.pulsar_topic),
        num_students=40, seed=7)
    bridge.run(max_events=report.message_count, idle_timeout_s=0.3)
    pipe.run(max_events=report.message_count, idle_timeout_s=0.3)
    pipe.cleanup()
    spans = t.tracer.snapshot()
    fwd = {s.trace_id for s in spans if s.name == "bridge_forward"}
    batches = {s.trace_id for s in spans if s.name == "batch"}
    assert fwd and batches and batches <= fwd
    assert fwd <= {s.trace_id for s in spans if s.name == "publish"}
    assert [s.name for s in spans if s.role == "generator"] == ["generate"]


def test_processor_batch_spans_nest_the_sketch_steps(tmp_path):
    from attendance_tpu_torch.cli import run_pipeline

    t = obs.enable(Config(trace_out=str(tmp_path / "t.json")))
    proc, _ = run_pipeline(Config(sketch_backend="memory", batch_size=64),
                           30, 3, seed=1, device="cpu")
    batches = proc.metrics.batches
    proc.cleanup()
    spans = t.tracer.snapshot()
    by_id = {s.span_id: s for s in spans}
    for name in ("bf_exists", "persist", "pfadd", "batch_assembly"):
        kids = [s for s in spans if s.name == name]
        assert len(kids) == batches, name
        assert all(by_id[s.parent_id].name in ("batch", "retry")
                   for s in kids), name


# -- gossip ------------------------------------------------------------------------

def _traced_gossip(pkg, broker_mod, config_cls, registry_cls, tracer_cls):
    obs_ns = types.SimpleNamespace(registry=registry_cls(),
                                   tracer=_deterministic(tracer_cls))
    cfg = config_cls(fed_worker="w1", fed_shard=1, fed_shards=2,
                     fed_heartbeat_s=0)
    client = broker_mod.MemoryClient(broker_mod.MemoryBroker())
    g = pkg.FenceGossip(cfg, client=client, m_bits=4096, k=7, obs=obs_ns)
    g.incarnation = 1234.5
    sub = client.subscribe(g.topic, "probe")
    return g, sub, obs_ns


def test_gossip_frames_carry_a_traceparent_byte_equal_to_jax(monkeypatch,
                                                            tmp_path):
    """Publishers with equal tracer ids and a frozen clock write
    byte-equal frames whose traceparent names the fence span, and the
    port's aggregator nests its fed_merge span under it, observes the
    merge lag and marks the peer up."""
    for mod in (gossip, jgossip):
        monkeypatch.setattr(mod.time, "time", lambda: 2e9)
    rng = np.random.default_rng(3)
    regs = rng.integers(0, 20, (2, 1 << 14), dtype=np.uint8)
    counts = np.array([[9, 1], [4, 0]], np.uint32)
    bloom = rng.integers(0, 1 << 32, 128, dtype=np.uint64).astype(np.uint32)
    sent = []
    for pkg, bmod, cfg, reg, tr in (
            (gossip, memory_broker, Config, Registry, Tracer),
            (jgossip, jbroker, JaxConfig, jregistry.Registry,
             jtracing.Tracer)):
        g, sub, ns = _traced_gossip(pkg, bmod, cfg, reg, tr)
        assert g.publish_full(bloom, regs, counts, {19_000: 0, 19_001: 1},
                              1_000, roster_size=50)
        assert g.publish_delta(np.array([1], np.int32), regs[1:], counts,
                               {19_000: 0, 19_001: 1}, 1_200, 2)
        assert g.heartbeat()
        sent.append([bytes(m.data()) for m in
                     sub.receive_many(3, timeout_millis=1000)])
        g.close()
    assert sent[0] == sent[1]
    from attendance_tpu_torch.federation.frames import decode_frame
    from attendance_tpu_torch.transport.framing import dec_checksummed
    decoded = [decode_frame(dec_checksummed(raw)[0]) for raw in sent[0]]
    assert [parse_ctx(f.traceparent) is not None for f in decoded] == [
        True, True, False]  # heartbeats are not traced
    t = obs.enable(Config(trace_out=str(tmp_path / "agg.json"),
                          metrics_port=-1))
    brk = MemoryBroker()
    agg = gossip.Aggregator(client=MemoryClient(brk), topic="tp",
                            num_shards=2, dead_after_s=1e9, obs=t)
    try:
        for frame in decoded:
            agg.fold_frame(frame, now=2e9 + 0.25)
    finally:
        agg.stop()
    merges = [s for s in t.tracer.snapshot() if s.name == "fed_merge"]
    assert [s.parent_id for s in merges] == [
        parse_ctx(f.traceparent).span_id for f in decoded[:2]]
    from attendance_tpu_torch.obs.exposition import parse_prom
    s = {(n, l): float(v) for n, l, v in parse_prom(t.render())}
    assert s[("attendance_fed_merge_lag_seconds_count", "")] == 2
    assert s[("attendance_fed_merged_deltas_total", "")] == 2
    assert s[("attendance_fed_peer_up", 'peer="w1"')] == 1
    assert s[("attendance_fed_map_version", "")] >= 0


def test_cli_telemetry_verb_prints_trace_tree(tmp_path, capsys):
    from attendance_tpu_torch.cli import main

    tr = Tracer()
    with tr.span("batch", role="fused-pipeline", args={"seq": 3}):
        with tr.span("decode"):
            time.sleep(0.001)
    path = tr.flush(tmp_path / "trace.json")
    main(["telemetry", str(path)])
    out = capsys.readouterr().out
    assert "trace export: 2 spans in 1 traces" in out
    assert "  batch  " in out and "    decode  " in out
    assert "[fused-pipeline]" in out
