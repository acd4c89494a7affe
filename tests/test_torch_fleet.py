"""The port's fleet plane (``attendance_tpu_torch/obs/fleet.py``, the
``fleet`` verb, the ``/fleet/*`` routes and the ``federate`` verb's
collector) against the JAX package's (``tests/test_fleet.py``'s pusher,
collector and verb cases, and ``tests/test_profiler.py``'s fleet
headline).

Push frames cross the packages both ways: a JAX pusher into the port's
collector, and the port's pusher into JAX's, give the artifacts
(``FLEET.json``, the per-role prom files, ``fleet_trace.json``) that the
same package on both ends gives, after the wall-clock fields are
normalised; the spans come from tracers with injected clocks and ids.
The ``fleet`` verb prints JAX's table and snapshot from the same
directory. The port's departure (only a transport failure or the
collector's reject counts as a failed push) is pinned here. Tests that
wait on a socket wait for their condition up to a deadline.
"""

import json
import logging
import re
import socket
import threading
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.cli import main as jax_main
from attendance_tpu.obs import fleet as jfleet
from attendance_tpu.obs.registry import Registry as JRegistry
from attendance_tpu.obs.tracing import Tracer as JTracer
from attendance_tpu_torch import obs
from attendance_tpu_torch.cli import main as port_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs import fleet
from attendance_tpu_torch.obs.fleet import (
    STATUS_FILE, TRACE_FILE, FleetCollector, FleetPusher, PushRejected)
from attendance_tpu_torch.obs.registry import Registry
from attendance_tpu_torch.obs.tracing import Tracer
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SIDES = {"port": (Registry, Tracer, FleetPusher, FleetCollector),
         "jax": (JRegistry, JTracer, jfleet.FleetPusher,
                 jfleet.FleetCollector)}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


@pytest.fixture
def collector(tmp_path):
    col = FleetCollector(directory=str(tmp_path / "fleet"), port=0).start()
    yield col
    col.stop()


def _slices(trace_doc):
    return [e for e in trace_doc["traceEvents"] if e.get("ph") == "X"]


# -- pusher -> collector wire ------------------------------------------------

def test_push_merges_roles_with_labels_and_persists(collector, tmp_path):
    r1, t1 = Registry(), Tracer(default_role="worker")
    r1.counter("attendance_events_total", help="Events").inc(100)
    t1.add_span("dispatch", 0.0, 0.01, trace_id=t1.new_id())
    r2 = Registry()
    r2.counter("attendance_events_total", help="Events").inc(50)
    p1 = FleetPusher(r1, t1, collector.address, role="worker",
                     instance="w0")
    p2 = FleetPusher(r2, None, collector.address, role="broker",
                     instance="b1")
    assert p1.push_now() and p2.push_now()
    merged = collector.merged_exposition()
    assert ('attendance_events_total{role="worker",instance="w0"} 100'
            in merged)
    assert ('attendance_events_total{role="broker",instance="b1"} 50'
            in merged)
    assert merged.count("# TYPE attendance_events_total counter") == 1
    status = collector.status()
    assert set(status["instances"]) == {"worker@w0", "broker@b1"}
    assert status["instances"]["worker@w0"]["events"] == 100
    assert status["instances"]["worker@w0"]["spans"] == 1
    fleet_dir = tmp_path / "fleet"
    assert "attendance_events_total 100" in \
        (fleet_dir / "worker@w0.prom").read_text()
    collector.stop()
    assert json.loads((fleet_dir / STATUS_FILE).read_text())["instances"]
    trace = json.loads((fleet_dir / TRACE_FILE).read_text())
    assert [e["name"] for e in _slices(trace)] == ["dispatch"]


def test_push_paces_span_backlog_and_drains_at_stop(collector):
    reg, tracer = Registry(), Tracer()
    for _ in range(1000):
        tracer.add_span("s", 0.0, 0.001, trace_id=1)
    p = FleetPusher(reg, tracer, collector.address, role="worker",
                    instance="w0", span_batch=64)
    assert p.push_now()
    assert collector.status()["instances"]["worker@w0"]["spans"] == 64
    p.stop()  # the stop() path drains everything
    assert collector.status()["instances"]["worker@w0"]["spans"] == 1000


def test_pusher_survives_dead_collector_and_recovers(caplog):
    reg = Registry()
    reg.counter("attendance_events_total", help="e").inc(1)
    col = FleetCollector(port=0)
    addr = col.address
    col.stop()  # never accepted; the port is dead
    p = FleetPusher(reg, None, addr, role="worker", instance="w0")
    with caplog.at_level(logging.WARNING, logger=fleet.logger.name):
        assert not p.push_now()
        assert not p.push_now()
    assert len([r for r in caplog.records
                if "fleet push" in r.getMessage()]) == 1
    live = FleetCollector(port=int(addr.rsplit(":", 1)[1])).start()
    try:
        deadline = time.time() + 5
        while not p.push_now():
            assert time.time() < deadline, "pusher never recovered"
        assert "worker@w0" in live.status()["instances"]
    finally:
        p.stop()
        live.stop()


def test_collector_drops_retried_duplicate_frames(collector):
    from attendance_tpu_torch.transport.framing import enc_props

    rows = json.dumps([["s", "worker", 1, "t", 1.0, 2.0,
                        7, 8, None, None]]).encode()
    hdr = {"role": "worker", "instance": "w0", "kind": "spans",
           "seq": 2, "boot": 10.0, "ts": 1.0}
    body = enc_props(hdr) + rows
    collector._ingest(body)
    collector._ingest(body)  # identical retry: dropped
    inst = collector._instances["worker@w0"]
    assert inst.span_count == 1 and inst.pushes == 1
    collector._ingest(enc_props({**hdr, "seq": 1, "boot": 11.0}) + rows)
    assert inst.span_count == 2 and inst.pushes == 2


def test_collector_rejects_malformed_push_keeps_serving(collector):
    from attendance_tpu_torch.transport.framing import recv_frame, send_frame

    host, port = collector.address.rsplit(":", 1)
    with socket.create_connection((host, int(port))) as sock:
        send_frame(sock, 1, b"\x00garbage")
        status, reply = recv_frame(sock)
        assert status != 0 and reply
    assert FleetPusher(Registry(), None, collector.address, role="w",
                       instance="i").push_now()


def test_fleet_routes_on_metrics_server(collector):
    from attendance_tpu_torch.obs.exposition import MetricsServer

    reg = Registry()
    reg.counter("attendance_events_total", help="e").inc(9)
    assert FleetPusher(reg, None, collector.address, role="serve",
                       instance="s0").push_now()
    server = MetricsServer(reg, port=0).start()
    try:
        collector.attach(server)
        base = f"http://127.0.0.1:{server.port}"
        body = urllib.request.urlopen(base + "/fleet/metrics",
                                      timeout=5).read().decode()
        assert 'attendance_events_total{role="serve"' in body
        assert body == collector.merged_exposition()
        doc = json.loads(urllib.request.urlopen(
            base + "/fleet/status", timeout=5).read())
        assert "serve@s0" in doc["instances"]
        trace = json.loads(urllib.request.urlopen(
            base + "/fleet/trace", timeout=5).read())
        assert trace["otherData"]["stitched"] is True
        collector.detach(server)
        with pytest.raises(Exception):
            urllib.request.urlopen(base + "/fleet/status", timeout=5)
    finally:
        server.stop()


def test_collector_stop_leaves_no_thread(tmp_path):
    before = set(threading.enumerate())
    col = FleetCollector(directory=str(tmp_path / "f"), port=0).start()
    p = FleetPusher(Registry(), None, col.address, role="w", instance="i")
    assert p.push_now()  # its connection stays open until stop()
    col.stop()
    deadline = time.monotonic() + 5
    while [t for t in set(threading.enumerate()) - before
           if t.name.startswith("fleet-")]:
        assert time.monotonic() < deadline, threading.enumerate()
        time.sleep(0.02)
    p.stop()  # the final push fails quietly: the collector is gone


def test_fleet_headline_top_stage():
    from attendance_tpu_torch.obs.fleet import _headline
    prom = ("# TYPE attendance_profile_stage_fraction gauge\n"
            'attendance_profile_stage_fraction{stage="dispatch"} 0.42\n'
            'attendance_profile_stage_fraction{stage="decode"} 0.2\n'
            'attendance_profile_stage_fraction{stage="untagged"} 0.9\n'
            "attendance_events_total 7\n")
    out = _headline(prom)
    assert out["top_stage"] == "dispatch 42%"
    assert out == jfleet._headline(prom)


# -- federated trace stitching -----------------------------------------------

def test_gossip_traceparent_stitches_fed_merge_under_fence(collector,
                                                           tmp_path):
    from attendance_tpu_torch.federation.gossip import (
        Aggregator, FenceGossip)
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    broker = MemoryBroker()
    wobs = types.SimpleNamespace(registry=Registry(), tracer=Tracer())
    aobs = types.SimpleNamespace(registry=Registry(), tracer=Tracer())
    cfg = Config(fed_worker="w0", fed_shard=0,
                 snapshot_dir=str(tmp_path / "chain"))
    gossip = FenceGossip(cfg, client=MemoryClient(broker), obs=wobs)
    agg = Aggregator(client=MemoryClient(broker), topic=gossip.topic,
                     num_shards=1, dead_after_s=30.0, obs=aobs)
    try:
        regs = np.zeros((1, 1 << 14), np.uint8)
        regs[0, :4] = 3
        counts = np.array([[7, 0], [1, 0]], np.uint32)
        assert gossip.publish_full(None, regs, counts, {0: 0}, 7)
        deadline = time.time() + 10
        while agg.poll(timeout_ms=100) == 0:
            assert time.time() < deadline, "frame never folded"
    finally:
        gossip.close()
        agg.stop()
    FleetPusher(wobs.registry, wobs.tracer, collector.address,
                role="worker", instance="w0").push_now(drain=True)
    FleetPusher(aobs.registry, aobs.tracer, collector.address,
                role="aggregator", instance="agg").push_now(drain=True)
    slices = _slices(collector.export_trace())
    fences = {e["args"]["span_id"]: e for e in slices
              if e["name"] == "fence_publish"}
    merges = [e for e in slices if e["name"] == "fed_merge"]
    assert fences and merges
    for m in merges:
        parent = fences[m["args"]["parent_span_id"]]
        assert m["args"]["trace_id"] == parent["args"]["trace_id"]


# -- the push frame across the packages ----------------------------------------

def _fill(side: str):
    """Two roles' registries and deterministic tracers of one package."""
    reg_cls, tracer_cls = SIDES[side][:2]
    out = []
    for role, inst, n in (("worker", "w0", 100), ("serve", "s0", 7)):
        reg = reg_cls()
        reg.counter("attendance_events_total", help="Events").inc(n)
        reg.gauge("attendance_slo_firing", slo="fpr").set(1.0)
        h = reg.histogram("attendance_fed_merge_lag_seconds")
        for v in (0.01, 0.2, 0.4):
            h.observe(v)
        ticks = iter(range(1, 1000))
        ids = iter(range(100, 10_000))
        tr = tracer_cls(default_role=role,
                        _clock=lambda ticks=ticks: next(ticks) * 0.001,
                        _ids=lambda ids=ids: next(ids), _epoch=1.0e9)
        for k in range(3):
            tid = tr.new_id()
            tr.add_span(f"step{k}", tr.now(), tr.now(), trace_id=tid,
                        args={"k": k})
        out.append((role, inst, reg, tr))
    return out


def _artifacts(root):
    status = json.loads((root / STATUS_FILE).read_text())
    status.pop("collected_at")
    for inst in status["instances"].values():
        inst.pop("age_s")
    proms = {p.name: re.sub(r"# scrape [0-9.]+\n", "# scrape T\n",
                            p.read_text())
             for p in sorted(root.glob("*.prom"))}
    trace = json.loads((root / TRACE_FILE).read_text())
    return status, proms, trace


def _push_into(pusher_side: str, collector_side: str, root) -> tuple:
    pusher_cls = SIDES[pusher_side][2]
    col = SIDES[collector_side][3](directory=str(root), port=0).start()
    try:
        for role, inst, reg, tr in _fill(pusher_side):
            p = pusher_cls(reg, tr, col.address, role=role, instance=inst)
            assert p.push_now()
            p.stop()  # the drain push
    finally:
        col.stop()
    return _artifacts(root)


@pytest.mark.parametrize("pusher_side,collector_side",
                         [("jax", "port"), ("port", "jax")])
def test_push_frames_cross_the_packages(tmp_path, pusher_side,
                                        collector_side):
    got = _push_into(pusher_side, collector_side, tmp_path / "cross")
    want = _push_into(pusher_side, pusher_side, tmp_path / "same")
    assert got == want
    status, proms, trace = got
    assert set(status["instances"]) == {"worker@w0", "serve@s0"}
    assert status["instances"]["worker@w0"]["events"] == 100
    assert status["instances"]["worker@w0"]["slo_firing"] == 1
    assert set(proms) == {"worker@w0.prom", "serve@s0.prom"}
    assert len(_slices(trace)) == 6
    # The port's side and JAX's give the same bytes from the same values.
    assert got == _push_into(collector_side, collector_side,
                             tmp_path / "other")


# -- the fleet verb ------------------------------------------------------------

def test_fleet_verb_equals_jax_from_a_directory(tmp_path, capsys):
    _push_into("port", "port", tmp_path / "fleet")
    outs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        snap = tmp_path / f"{name}.json"
        main(["fleet", "--dir", str(tmp_path / "fleet"),
              "--snapshot-json", str(snap)])
        capsys.readouterr()
        main(["fleet", "--dir", str(tmp_path / "fleet")])
        table = capsys.readouterr().out
        main(["fleet", "--dir", str(tmp_path / "fleet"), "--once",
              "--snapshot-json", "-"])
        stdout_doc = json.loads(capsys.readouterr().out)
        outs[name] = (json.loads(snap.read_text()), table, stdout_doc)
    assert outs["port"] == outs["jax"]
    doc, table, _ = outs["port"]
    assert doc["instances"]["worker@w0"]["events"] == 100
    assert "worker@w0" in table and "role@instance" in table


def test_fleet_verb_exit_codes(tmp_path, capsys):
    for argv in (["fleet"], ["fleet", "--dir", str(tmp_path / "nope")]):
        with pytest.raises(SystemExit) as e:
            port_main(argv)
        assert e.value.code == 2


def test_fleet_verb_reads_a_live_collector(tmp_path, capsys):
    from attendance_tpu_torch.obs.exposition import MetricsServer

    col = FleetCollector(port=0).start()
    reg = Registry()
    reg.counter("attendance_events_total", help="e").inc(3)
    server = MetricsServer(reg, port=0).start()
    try:
        assert FleetPusher(reg, None, col.address, role="worker",
                           instance="w0").push_now()
        col.attach(server)
        port_main(["fleet", "--http", f"127.0.0.1:{server.port}",
                   "--once"])
        assert "worker@w0" in capsys.readouterr().out
    finally:
        server.stop()
        col.stop()


# -- telemetry, the worker and the federate verb --------------------------------

def test_fleet_push_alone_enables_telemetry_with_a_tracer(collector):
    config = Config(fleet_push=collector.address, fleet_role="worker",
                    fleet_instance="w9", fleet_push_interval_s=0.05)
    assert obs.enabled_in(config)
    t = obs.enable(config)
    assert t.tracer is not None and t.trace_path == ""
    assert t._fleet._thread.name == "fleet-pusher"
    t.events.inc(11)
    deadline = time.monotonic() + 5
    while collector.status()["instances"].get(
            "worker@w9", {}).get("events") != 11:
        assert time.monotonic() < deadline, collector.status()
        time.sleep(0.02)
    t.events.inc(1)
    obs.disable()  # the final push lands before the bundle stops
    assert collector.status()["instances"]["worker@w9"]["events"] == 12
    assert not [th for th in threading.enumerate()
                if th.name == "fleet-pusher"]


def test_worker_config_pushes_as_its_worker():
    from attendance_tpu_torch.federation import worker

    args = worker.build_parser().parse_args(
        ["--worker", "w3", "--shard", "0", "--num-shards", "1",
         "--broker", "127.0.0.1:1", "--workdir", "w", "--fleet-push",
         "127.0.0.1:9"])
    cfg = worker.make_worker_config(
        "w3", 0, 1, "127.0.0.1:1", "w", base_topic="t",
        fleet_push=args.fleet_push)
    assert (cfg.fleet_push, cfg.fleet_role, cfg.fleet_instance) == (
        "127.0.0.1:9", "worker", "w3")


def test_fleet_flags_only_where_read(tmp_path):
    from attendance_tpu_torch.cli import build_parser

    parser = build_parser()
    args = parser.parse_args(
        ["federate", "--fleet-port", "-1", "--fleet-dir", "d",
         "--fleet-push", "h:1", "--incident-dir", "i"])
    assert (args.fleet_port, args.fleet_dir, args.fleet_push,
            args.incident_dir) == (-1, "d", "h:1", "i")
    for verb in ("fused", "process", "pipeline", "bridge", "serve"):
        args = parser.parse_args(
            [verb, "--fleet-push", "h:1", "--fleet-role", "r",
             "--fleet-instance", "x", "--fleet-push-interval-s", "0.5",
             "--incident-dir", "i", "--incident-clear-ticks", "2"])
        assert args.fleet_push == "h:1" and args.incident_clear_ticks == 2
        with pytest.raises(SystemExit):
            parser.parse_args([verb, "--fleet-port", "-1"])
    for verb in ("generate", "stats", "analyze", "parity"):
        with pytest.raises(SystemExit):
            parser.parse_args([verb, "--fleet-push", "h:1"])


def test_federate_collector_holds_the_aggregator_row(tmp_path, capsys):
    """The verb's collector, its artifacts, and the stop order: a run far
    shorter than the push interval still lands the aggregator's row."""
    from attendance_tpu_torch.transport.memory_broker import MemoryBroker

    fdir = tmp_path / "fleet"
    before = set(threading.enumerate())
    port_main(["federate", "--fed-shards", "2", "--serve-port", "-1",
               "--serve-seconds", "0.2", "--fleet-port", "-1",
               "--fleet-dir", str(fdir), "--metrics-port", "-1",
               "--incident-dir", str(tmp_path / "inc")])
    out = capsys.readouterr().out
    assert "fleet collector on 127.0.0.1:" in out
    status = json.loads((fdir / STATUS_FILE).read_text())
    [key] = status["instances"]
    assert key.startswith("aggregator@pid")
    assert (fdir / TRACE_FILE).is_file()
    assert list(fdir.glob("aggregator@*.prom"))
    assert not [th for th in set(threading.enumerate()) - before
                if th.name.startswith(("fleet-", "incident-engine"))]
    MemoryBroker.reset_shared()


# -- the port's departure --------------------------------------------------------

def test_only_the_wire_fails_a_push_quietly(collector, caplog):
    """A failed render leaves push_now (JAX's calls it "collector
    down?"); a transport failure and a reject are failed pushes."""
    class Broken(Registry):
        def collect(self):
            raise RuntimeError("registry unreadable")

    p = FleetPusher(Broken(), None, collector.address, role="w",
                    instance="i")
    with pytest.raises(RuntimeError, match="registry unreadable"):
        p.push_now()
    p = FleetPusher(Registry(), None, collector.address, role="w",
                    instance="i")

    def reject(header, payload):
        raise PushRejected("collector rejected push: no")

    p._call = reject
    with caplog.at_level(logging.WARNING, logger=fleet.logger.name):
        assert not p.push_now()
    assert any("collector down?" in r.getMessage() for r in caplog.records)


def test_the_pusher_thread_logs_a_failed_render(collector, caplog):
    class Broken(Registry):
        def collect(self):
            raise RuntimeError("registry unreadable")

    p = FleetPusher(Broken(), None, collector.address, role="w",
                    instance="i", interval_s=0.02)
    with caplog.at_level(logging.ERROR, logger=fleet.logger.name):
        p.start()
        deadline = time.monotonic() + 5
        while not [r for r in caplog.records
                   if "local snapshot" in r.getMessage()]:
            assert time.monotonic() < deadline
            time.sleep(0.02)
    p._stop.set()
    p._thread.join(timeout=5)


# -- the standalone broker's push ---------------------------------------------

def _broker_series(collector):
    """{(family, labels without role/instance): value} of the samples the
    collector holds for role="broker"."""
    from attendance_tpu_torch.obs.exposition import parse_prom

    out = {}
    for name, labels, value in parse_prom(collector.merged_exposition()):
        if 'role="broker"' not in labels:
            continue
        rest = ",".join(p for p in labels.split(",")
                        if not p.startswith(("role=", "instance=")))
        out[(name, rest)] = float(value)
    return out


def _broker_push(side, tmp_path):
    """A standalone broker process of ``side`` run with ``--fleet-push``
    at a collector of the same side; 5 messages published, received and
    acked through that side's socket client. Returns the broker series
    once the traffic counts have landed."""
    from attendance_tpu.transport import socket_broker as jsock
    from attendance_tpu_torch.transport import socket_broker as tsock

    sock = tsock if side == "port" else jsock
    col = SIDES[side][3](directory=str(tmp_path / side), port=0).start()
    proc, addr = sock.spawn_broker(cwd=REPO, fleet_push=col.address)
    try:
        client = sock.SocketClient(addr)
        consumer = client.subscribe("t", "s")
        producer = client.create_producer("t")
        for i in range(5):
            producer.send(b"m%d" % i)
        got = 0
        deadline = time.monotonic() + 20
        while got < 5:
            assert time.monotonic() < deadline
            consumer.acknowledge(consumer.receive(timeout_millis=5000))
            got += 1
        client.close()
        key = ("attendance_broker_received_messages_total",
               'subscription="s",topic="t"')
        deadline = time.monotonic() + 30  # a push every 2 s
        while _broker_series(col).get(key) != 5:
            assert time.monotonic() < deadline, _broker_series(col)
            time.sleep(0.1)
        series = _broker_series(col)
        assert col.status()["instances"][
            f"broker@pid{proc.pid}"]["role"] == "broker"
        return series
    finally:
        proc.kill()
        proc.wait(timeout=10)
        col.stop()


def test_broker_fleet_push_equals_jax(tmp_path):
    """``python -m attendance_tpu_torch.transport.socket_broker --port 0
    --fleet-push HOST:PORT`` ships the broker's queue-depth and traffic
    series under role="broker", as JAX's broker does to JAX's
    collector over the same publishes: the same families and traffic
    counts."""
    port = _broker_push("port", tmp_path)
    jax = _broker_push("jax", tmp_path)
    # Every sample is a count here: the whole set is equal.
    assert port == jax
    labels = 'subscription="s",topic="t"'
    assert port[("attendance_broker_received_bytes_total", labels)] == 10
    assert port[("attendance_queue_depth", labels)] == 0


def test_broker_stop_leaves_no_pusher_thread(collector, monkeypatch, capsys):
    """The broker's main, run in-process and stopped by KeyboardInterrupt,
    stops its server and its telemetry: the final push lands and no
    ``fleet-pusher`` thread is left."""
    from attendance_tpu_torch.transport import socket_broker as tsock

    class _Clock:
        """The module's clock, whose long idle sleep is interrupted."""

        def __getattr__(self, name):
            return getattr(time, name)

        @staticmethod
        def sleep(s):
            if s >= 3600:
                raise KeyboardInterrupt
            time.sleep(s)

    monkeypatch.setattr(tsock, "time", _Clock())
    tsock.main(["--port", "0", "--fleet-push", collector.address])
    assert "broker listening on" in capsys.readouterr().out
    assert obs.get() is None
    assert not [t for t in threading.enumerate()
                if t.name == "fleet-pusher"]
    roles = {v["role"] for v in collector.status()["instances"].values()}
    assert roles == {"broker"}
