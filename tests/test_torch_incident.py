"""The port's incident plane (``attendance_tpu_torch/obs/incident.py``)
against the JAX package's (``tests/test_incident.py``'s engine, bundle and
replay cases).

Both packages' engines tick over registries driven with the same values
(tests call ``tick()``; no test waits for the engine's thread except
where the thread itself is under test): the same condition sets, open
and clear ticks, and the same ``diagnosis.json``, the incident id and
wall-clock fields apart. ``diagnose`` is equal to JAX's for every subset
of the condition names. Each package's ``doctor --incident`` reads the
other's bundles with the same text and exit code. The port's departures
(a callback raising anything but ``LookupError`` fails the tick; a
failed evidence part is logged and reported missing) are pinned here.
Every test leaves both packages' process-global telemetry disabled.
"""

import hashlib
import itertools
import json
import logging
import threading
import time

import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.cli import main as jax_main
from attendance_tpu.obs import incident as jinc
from attendance_tpu_torch import obs
from attendance_tpu_torch.cli import main as port_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs import incident
from attendance_tpu_torch.obs.incident import (
    EVIDENCE_PARTS, RULES, IncidentEngine, diagnose, find_bundles,
    incident_report)
from attendance_tpu_torch.obs.slo import ALERT_SCHEMA

PKGS = {"port": obs, "jax": jobs}
CONDITIONS = sorted({c for r in RULES for c in r.required + r.optional})


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _engine(tmp_path, pkg="port", **kw):
    """A telemetry bundle (not started: no thread) and its incident
    engine, driven by manual ticks."""
    kw.setdefault("incident_dir", str(tmp_path / pkg / "incidents"))
    t = PKGS[pkg].Telemetry(**kw)
    t.incidents.dir.mkdir(parents=True, exist_ok=True)
    return t, t.incidents


def _both(tmp_path, **kw):
    return {pkg: _engine(tmp_path, pkg, **kw) for pkg in PKGS}


def _norm_record(rec: dict) -> dict:
    rec = dict(rec)
    for key in ("id", "opened_unix", "cleared_unix", "evidence",
                "instance"):
        rec.pop(key)
    return rec


def _norm_diagnosis(doc: dict) -> dict:
    doc = dict(doc)
    doc.pop("incident")
    return doc


# -- diagnosis signature table ----------------------------------------------

def test_rules_equal_jax():
    assert [r.name for r in RULES] == [r.name for r in jinc.RULES]
    for ours, theirs in zip(RULES, jinc.RULES):
        assert (ours.name, ours.cause, ours.required, ours.optional,
                ours.evidence, ours.action) == (
            theirs.name, theirs.cause, theirs.required, theirs.optional,
            theirs.evidence, theirs.action)
    assert incident.SECONDARY_CONDITIONS == jinc.SECONDARY_CONDITIONS
    assert EVIDENCE_PARTS == jinc.EVIDENCE_PARTS


def test_diagnose_equals_jax_for_every_condition_subset():
    assert len(CONDITIONS) == 13
    for n in range(len(CONDITIONS) + 1):
        for conds in itertools.combinations(CONDITIONS, n):
            assert diagnose(conds) == jinc.diagnose(conds), conds


def test_diagnose_golden_table():
    """The composite signatures rank their cause first, and every single
    condition maps to some rule."""
    golden = [
        ({"circuit_open", "spill_growth", "slo_burn"}, "persist_sink_down"),
        ({"circuit_open", "spill_growth"}, "persist_sink_down"),
        ({"steady_recompiles"}, "shape_churn"),
        ({"steady_recompiles", "throughput_drop", "dispatch_gap"},
         "shape_churn"),
        ({"peer_down", "merge_lag"}, "dead_worker"),
        ({"peer_down"}, "dead_worker"),
        ({"throughput_drop", "stage_shift"}, "temporal_dispatch_pass"),
        ({"merge_lag"}, "fed_merge_backlog"),
        ({"read_staleness"}, "stale_reads"),
        ({"watermark_lag"}, "watermark_stall"),
        ({"lane_stall"}, "lane_stall"),
        ({"circuit_open"}, "sink_circuit_open"),
        ({"integrity_rejects"}, "wire_rot"),
        ({"slo_burn"}, "slo_burn"),
        ({"dispatch_gap"}, "dispatch_gap"),
    ]
    for conds, expected in golden:
        ranked = diagnose(conds)
        assert ranked[0]["rule"] == expected, (conds, ranked[0])
        scores = [r["score"] for r in ranked]
        assert scores == sorted(scores, reverse=True)
        for r in ranked:
            assert set(r["matched"]) <= conds
    names = [r["rule"] for r in diagnose({"circuit_open", "spill_growth"})]
    assert names.index("persist_sink_down") < names.index(
        "sink_circuit_open")


# -- the same driven registry in both packages --------------------------------

def _script(t, step: int) -> None:
    """Step ``step`` of one drive of a registry: a circuit opens, spill
    grows, a peer dies with lagging merges, everything heals."""
    reg = t.registry
    circuit = reg.gauge("attendance_circuit_state", sink="disk")
    spilled = reg.counter("attendance_persist_spilled_batches_total")
    peer = reg.gauge("attendance_fed_peer_up", peer="room-b")
    lag = reg.histogram("attendance_fed_merge_lag_seconds")
    events = reg.counter("attendance_events_total")
    if step == 0:
        peer.set(1.0)
        lag.observe(0.01)
    if step >= 1:
        events.inc(10_000)
    if step == 2:
        circuit.set(1.0)
    if step == 3:
        spilled.inc(5)
    if step == 5:
        peer.set(0.0)
        for _ in range(10):
            lag.observe(30.0)
    if step == 7:
        circuit.set(0.0)
        peer.set(1.0)


def test_driven_registry_gives_jax_conditions_and_diagnosis(tmp_path):
    engines = _both(tmp_path, incident_clear_ticks=2, flight_recorder=16)
    seen = {}
    for pkg, (t, eng) in engines.items():
        per_tick = []
        for step in range(12):
            _script(t, step)
            iid = eng.tick()
            open_inc = eng._open
            per_tick.append((iid is not None,
                             sorted(open_inc.conditions) if open_inc
                             else None,
                             open_inc.top_rule if open_inc else None,
                             eng.total_opened, eng._clean))
        [bundle] = find_bundles(eng.dir)
        seen[pkg] = (
            per_tick,
            _norm_record(json.loads((bundle / "incident.json").read_text())),
            _norm_diagnosis(json.loads(
                (bundle / "diagnosis.json").read_text())),
            sorted(json.loads(
                (bundle / "incident.json").read_text())["evidence"]))
    assert seen["port"] == seen["jax"]
    per_tick = seen["port"][0]
    # Opens on the circuit, clears on the second clean tick after the
    # heal.
    assert [p[0] for p in per_tick] == [False, False] + [True] * 6 + [
        False] * 4
    assert per_tick[2][1:3] == (["circuit_open"], "sink_circuit_open")
    assert per_tick[5][1] == ["circuit_open", "merge_lag", "peer_down",
                              "spill_growth"]
    diag = seen["port"][2]
    assert diag["top"] == "persist_sink_down"
    assert "dead_worker" in [r["rule"] for r in diag["ranked"]]
    assert diag["schema"] == ALERT_SCHEMA


# -- open / clear hysteresis -------------------------------------------------

def test_incident_open_clear_hysteresis(tmp_path):
    t, eng = _engine(tmp_path, incident_clear_ticks=3)
    circuit = t.registry.gauge("attendance_circuit_state", sink="disk")
    assert eng.tick() is None  # warm-up, no conditions
    circuit.set(1.0)
    iid = eng.tick()  # opens within one tick
    assert iid is not None and iid.startswith("inc-")
    assert t.registry.gauge("attendance_incidents_open").read() == 1.0
    assert t.registry.counter("attendance_incidents_total",
                              rule="sink_circuit_open").value == 1
    circuit.set(0.0)
    assert eng.tick() == iid
    assert eng.tick() == iid
    assert eng.tick() is None  # the third clean tick clears
    assert t.registry.gauge("attendance_incidents_open").read() == 0.0
    [bundle] = find_bundles(eng.dir)
    rec = json.loads((bundle / "incident.json").read_text())
    assert rec["schema"] == ALERT_SCHEMA and rec["kind"] == "incident"
    assert rec["id"] == iid
    assert rec["cleared_unix"] >= rec["opened_unix"]
    assert rec["conditions"] == ["circuit_open"]
    assert rec["diagnosis_top"] == "sink_circuit_open"


def test_secondary_conditions_never_open_alone(tmp_path):
    t, eng = _engine(tmp_path)
    events = t.registry.counter("attendance_events_total")
    frac = t.registry.gauge("attendance_profile_stage_fraction",
                            stage="dispatch")
    frac.set(0.10)
    eng.tick()
    for _ in range(4):
        events.inc(10_000)
        assert eng.tick() is None
    frac.set(0.80)
    for _ in range(4):  # idle tail: rate 0 trips the drop detector
        assert eng.tick() is None
    assert eng.total_opened == 0
    t.registry.gauge("attendance_circuit_state", sink="disk").set(1.0)
    assert eng.tick() is not None
    assert "circuit_open" in eng._open.conditions


def test_flap_does_not_churn_bundles(tmp_path):
    t, eng = _engine(tmp_path)
    circuit = t.registry.gauge("attendance_circuit_state", sink="disk")
    eng.tick()
    for i in range(8):
        circuit.set(1.0 if i % 2 == 0 else 0.0)
        eng.tick()
    assert eng.total_opened == 1
    assert len(find_bundles(eng.dir)) == 1


# -- evidence bundle ---------------------------------------------------------

def test_bundle_completeness_and_checksums(tmp_path):
    t, eng = _engine(tmp_path, flight_recorder=16,
                     trace_out=str(tmp_path / "trace.json"))
    t.record_batch(ts=1.0, batch=1, events=32)
    t.registry.gauge("attendance_circuit_state", sink="disk").set(1.0)
    eng.tick()
    assert eng.tick() is not None
    [bundle] = find_bundles(eng.dir)
    manifest = json.loads((bundle / "incident.json").read_text())["evidence"]
    for name in EVIDENCE_PARTS + ("diagnosis.json",):
        digest = hashlib.sha256((bundle / name).read_bytes()).hexdigest()
        assert manifest[name] == digest, name
    flight = json.loads((bundle / "flight.json").read_text())
    assert flight["collected"] is True
    assert any(r.get("batch") == 1 for r in flight["records"])
    assert json.loads((bundle / "trace_slice.json").read_text())[
        "collected"] is True
    assert "collected" in json.loads(
        (bundle / "attribution.json").read_text())
    assert "instances" in json.loads(
        (bundle / "fleet_status.json").read_text())
    assert "attendance_incidents_open 1" in \
        (bundle / "metrics.prom").read_text()
    text, ok = incident_report(eng.dir)
    assert ok and "sha256 ok" in text and "PASS" in text
    (bundle / "attribution.json").write_text("{}")
    text, ok = incident_report(eng.dir)
    assert not ok and "digest mismatch" in text


def test_absent_subsystems_yield_stubs_not_holes(tmp_path):
    t, eng = _engine(tmp_path)
    t.registry.gauge("attendance_read_staleness_seconds").set(60.0)
    eng.tick()
    assert eng.tick() is not None
    [bundle] = find_bundles(eng.dir)
    for name in EVIDENCE_PARTS:
        assert (bundle / name).is_file()
    assert json.loads((bundle / "flight.json").read_text())[
        "collected"] is False
    assert json.loads((bundle / "fleet_status.json").read_text())[
        "collected"] is False
    assert incident_report(bundle)[1]


def test_merge_rediagnoses_on_new_conditions(tmp_path):
    t, eng = _engine(tmp_path)
    spilled = t.registry.counter("attendance_persist_spilled_batches_total")
    circuit = t.registry.gauge("attendance_circuit_state", sink="disk")
    eng.tick()
    circuit.set(1.0)
    iid = eng.tick()
    assert eng._open.top_rule == "sink_circuit_open"
    spilled.inc(5)
    assert eng.tick() == iid and eng.total_opened == 1
    assert eng._open.conditions == {"circuit_open", "spill_growth"}
    assert eng._open.top_rule == "persist_sink_down"
    [bundle] = find_bundles(eng.dir)
    assert json.loads((bundle / "diagnosis.json").read_text())[
        "top"] == "persist_sink_down"
    assert json.loads((bundle / "incident.json").read_text())[
        "diagnosis_top"] == "persist_sink_down"


# -- the chaos scenarios -------------------------------------------------------

def test_persist_sink_failure_scenario(tmp_path):
    t, eng = _engine(tmp_path)
    spilled = t.registry.counter("attendance_persist_spilled_batches_total")
    circuit = t.registry.gauge("attendance_circuit_state", sink="disk")
    eng.tick()
    circuit.set(1.0)
    spilled.inc(7)
    assert eng.tick() is not None
    assert eng._open.conditions >= {"circuit_open", "spill_growth"}
    [bundle] = find_bundles(eng.dir)
    ranked = json.loads((bundle / "diagnosis.json").read_text())["ranked"]
    assert ranked[0]["rule"] == "persist_sink_down"


def test_launch_shape_storm_scenario(tmp_path):
    """New launch shapes after warm-up diagnose as shape_churn, and the
    launch-shape ledger rides in the attribution evidence."""
    t, eng = _engine(tmp_path)
    t.recompiles.mark_warm()
    eng.tick()
    for i in range(4):
        t.recompiles.observe("dispatch_frame", (128 + i, 8))
    assert eng.tick() is not None
    assert eng._open.top_rule == "shape_churn"
    [bundle] = find_bundles(eng.dir)
    attribution = json.loads((bundle / "attribution.json").read_text())
    assert attribution.get("recompiles", {}).get("steady", 0) >= 4


def test_dead_federation_worker_scenario(tmp_path):
    t, eng = _engine(tmp_path)
    peer = t.registry.gauge("attendance_fed_peer_up", peer="room-b")
    peer.set(1.0)
    lag = t.registry.histogram("attendance_fed_merge_lag_seconds")
    lag.observe(0.01)
    eng.tick()
    peer.set(0.0)
    for _ in range(10):
        lag.observe(30.0)
    assert eng.tick() is not None
    assert eng._open.conditions >= {"peer_down", "merge_lag"}
    [bundle] = find_bundles(eng.dir)
    names = [r["rule"] for r in json.loads(
        (bundle / "diagnosis.json").read_text())["ranked"]]
    assert names[0] == "dead_worker" and "fed_merge_backlog" in names


def test_incident_spans_and_metrics(tmp_path):
    t, eng = _engine(tmp_path, trace_out=str(tmp_path / "trace.json"),
                     incident_clear_ticks=1)
    circuit = t.registry.gauge("attendance_circuit_state", sink="disk")
    eng.tick()
    circuit.set(1.0)
    assert eng.tick() is not None
    circuit.set(0.0)
    assert eng.tick() is None
    names = [e.get("name") for e in t.tracer.export()["traceEvents"]]
    for name in ("incident_open", "incident_diagnosis", "incident_clear"):
        assert name in names
    assert 'attendance_incidents_total{rule="sink_circuit_open"} 1' in \
        t.render()


def test_fleet_incidents_column(tmp_path):
    from attendance_tpu.cli import _fleet_table as jax_table
    from attendance_tpu_torch.cli import _fleet_table
    from attendance_tpu_torch.obs.exposition import (
        fold_headline_samples, parse_prom)
    t, eng = _engine(tmp_path)
    t.registry.gauge("attendance_circuit_state", sink="disk").set(1.0)
    eng.tick()
    assert eng.tick() is not None
    assert fold_headline_samples(parse_prom(t.render()))["incidents"] == 1
    doc = {"instances": {
        "ingest@1": {"age_s": 1.0, "pushes": 2, "spans": 0,
                     "incidents": 1},
        "serve@2": {"age_s": 1.0, "pushes": 2, "spans": 0}}}
    table = _fleet_table(doc)
    assert table == jax_table(doc) and "incidents" in table
    assert [l for l in table.splitlines()
            if "ingest@1" in l][0].rstrip().endswith("1")
    assert [l for l in table.splitlines()
            if "serve@2" in l][0].rstrip().endswith("-")


# -- lifecycle ------------------------------------------------------------------

def test_incident_dir_alone_enables_telemetry(tmp_path):
    config = Config(incident_dir=str(tmp_path / "inc"))
    assert obs.enabled_in(config)
    t = obs.enable(config)
    assert isinstance(t.incidents, IncidentEngine)
    assert t.incidents.clear_ticks == 3
    assert t.incidents._thread.name == "incident-engine"
    obs.disable()
    assert t.incidents._thread is None


def test_finalize_persists_open_incident(tmp_path):
    t = obs.enable(Config(incident_dir=str(tmp_path / "incidents")))
    eng = t.incidents
    eng.stop()  # the test drives tick() itself
    t.registry.gauge("attendance_circuit_state", sink="disk").set(1.0)
    eng.tick()
    assert eng.tick() is not None
    obs.disable()  # Telemetry.stop -> incidents.finalize
    [bundle] = find_bundles(tmp_path / "incidents")
    rec = json.loads((bundle / "incident.json").read_text())
    assert rec["detail"]["finalized"] == "telemetry-stop"
    assert rec["cleared_unix"] is None


def test_config_checks_equal_jax():
    from attendance_tpu.config import Config as JConfig
    for kw in ({"incident_clear_ticks": 0}, {"fleet_push_interval_s": 0},
               {"fleet_port": -2}, {"fleet_port": 70000}):
        with pytest.raises(ValueError) as ours:
            Config(**kw)
        with pytest.raises(ValueError) as theirs:
            JConfig(**kw).validate()
        assert str(ours.value) == str(theirs.value)


# -- doctor --incident across the packages -------------------------------------

def _exit_code(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        return e.code
    return 0


def _clean_bundle(tmp_path, pkg):
    t, eng = _engine(tmp_path, pkg)
    t.registry.gauge("attendance_circuit_state", sink="disk").set(1.0)
    eng.tick()
    assert eng.tick() is not None
    [bundle] = find_bundles(eng.dir)
    return bundle


def _undiagnosed(bundle):
    rec = json.loads((bundle / "incident.json").read_text())
    rec["cleared_unix"] = None
    rec["diagnosis_top"] = ""
    (bundle / "incident.json").write_text(json.dumps(rec))


def _corrupt(bundle):
    (bundle / "metrics.prom").write_text("tampered\n")


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case,spoil,want", [
    ("clean", None, 0), ("undiagnosed-open", _undiagnosed, 1),
    ("corrupt", _corrupt, 1), ("missing", None, 2)])
def test_doctor_incident_reads_either_package_bundles(tmp_path, capsys, pkg,
                                                      case, spoil, want):
    if case == "missing":
        target = tmp_path / "nope"
    else:
        bundle = _clean_bundle(tmp_path, pkg)
        if spoil is not None:
            spoil(bundle)
        target = bundle.parent if case == "clean" else bundle
    rc = _exit_code(port_main, ["doctor", "--incident", str(target)])
    ours = capsys.readouterr().out
    jrc = _exit_code(jax_main, ["doctor", "--incident", str(target)])
    assert (rc, ours) == (jrc, capsys.readouterr().out)
    assert rc == want
    if want != 2:
        assert ours.startswith("incident replay: 1 bundle(s) under")


def test_doctor_incident_rides_with_artifacts(tmp_path, capsys):
    """--incident beside prom artifacts: both reports print and a corrupt
    bundle fails the combined verdict, as in JAX."""
    from attendance_tpu_torch.obs.exposition import render
    bundle = _clean_bundle(tmp_path, "port")
    t, _ = _engine(tmp_path / "other")
    prom = tmp_path / "run.prom"
    prom.write_text(render(t.registry))
    argv = ["doctor", "--incident", str(bundle), str(prom)]
    rc = _exit_code(port_main, argv)
    ours = capsys.readouterr().out
    assert (rc, ours) == (_exit_code(jax_main, argv),
                          capsys.readouterr().out)
    assert "incident replay:" in ours and "doctor: 1 artifact(s)" in ours
    _corrupt(bundle)
    rc = _exit_code(port_main, argv)
    capsys.readouterr()
    assert rc == 1 == _exit_code(jax_main, argv)


def test_doctor_still_refuses_actuations(tmp_path, capsys, caplog):
    """``--actuations`` is ported (item 11e): a missing log is refused
    with exit 2 as JAX's verb refuses it, and a present one replays."""
    with pytest.raises(SystemExit) as e:
        port_main(["doctor", "--actuations", str(tmp_path / "a.jsonl")])
    assert e.value.code == 2
    assert "no such actuation log" in caplog.text
    assert "ROADMAP item 11e" not in capsys.readouterr().err
    from attendance_tpu_torch.control import ActuationLog
    log = ActuationLog(str(tmp_path / "a.jsonl"))
    log.record(knob="audit_every", frm=1, to=8, outcome="applied",
               policy="degradation_ladder", action="widen_audit",
               direction="escalate", rung=1, conditions=["circuit_open"])
    log.close()
    with pytest.raises(SystemExit) as e:
        port_main(["doctor", "--actuations", str(tmp_path / "a.jsonl")])
    assert e.value.code == 0
    assert "actuation replay: ok" in capsys.readouterr().out


# -- the port's departures -----------------------------------------------------

def test_card_read_failure_fails_the_incident_tick(tmp_path):
    """A gauge callback raising anything but LookupError leaves the port's
    tick (JAX's passes over it); LookupError is no signal in both."""
    engines = _both(tmp_path)
    for pkg, (t, eng) in engines.items():
        eng.tick()

        def broken():
            raise RuntimeError("card read failed")

        t.registry.gauge("attendance_read_staleness_seconds").set_function(
            broken)
        if pkg == "port":
            with pytest.raises(RuntimeError, match="card read failed"):
                eng.tick()
        else:
            assert eng.tick() is None

        def gone():
            raise LookupError("sketch owner was torn down")

        t.registry.gauge("attendance_read_staleness_seconds").set_function(
            gone)
        assert eng.tick() is None
        assert eng.total_opened == 0


def test_the_engine_thread_logs_a_failed_tick(tmp_path, caplog):
    t = obs.enable(Config(incident_dir=str(tmp_path / "inc"),
                          metrics_interval_s=0.05))

    def broken():
        raise RuntimeError("card read failed")

    t.registry.gauge("attendance_fed_peer_up", peer="w0").set_function(
        broken)
    with caplog.at_level(logging.ERROR, logger=incident.logger.name):
        deadline = time.monotonic() + 5.0
        while not [r for r in caplog.records
                   if r.getMessage() == "incident tick failed"]:
            assert time.monotonic() < deadline, "no failed-tick record"
            time.sleep(0.02)
    obs.disable()


def test_a_failed_evidence_part_is_logged_and_reported_missing(tmp_path,
                                                               caplog,
                                                               capsys):
    class DeadCollector:
        def status(self):
            raise RuntimeError("collector state unreadable")

    t, eng = _engine(tmp_path)
    eng.bind_collector(DeadCollector())
    t.registry.gauge("attendance_circuit_state", sink="disk").set(1.0)
    eng.tick()
    with caplog.at_level(logging.ERROR, logger=incident.logger.name):
        iid = eng.tick()
    assert iid is not None and eng._open is not None  # stays open
    assert any("evidence part fleet_status.json failed" in r.getMessage()
               for r in caplog.records)
    [bundle] = find_bundles(eng.dir)
    assert not (bundle / "fleet_status.json").exists()
    for name in set(EVIDENCE_PARTS) - {"fleet_status.json"}:
        assert (bundle / name).is_file()
    rc = _exit_code(port_main, ["doctor", "--incident", str(bundle)])
    out = capsys.readouterr().out
    assert rc == 1 == _exit_code(jax_main, ["doctor", "--incident",
                                            str(bundle)])
    assert "fleet_status.json" in out and "missing" in out


# -- four threads reading the sketches at once ----------------------------------

def _readers(fn, n, stop, errors):
    def loop():
        while not stop.is_set():
            try:
                fn()
            except Exception as exc:  # recorded for the assertion
                errors.append(repr(exc))
    return [threading.Thread(target=loop, daemon=True) for _ in range(n)]


def test_concurrent_renders_beside_the_run_loop(tmp_path, caplog):
    """Renders from more threads than cores (a scrape, the SLO and
    incident ticks and the pusher all render) while the run loop
    registers new days: no callback raises, the state is the one a quiet
    run makes."""
    import sys

    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    def run(config):
        pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()),
                             device="cpu")
        roster, frames = generate_frames(1 << 14, 256, roster_size=2_000,
                                         num_lectures=48, seed=4)
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)
        return pipe

    quiet = run(Config())
    quiet.run(max_events=1 << 14, idle_timeout_s=0.5)
    want = (quiet.validity_counts(), quiet.count_all())
    quiet.cleanup()

    t = obs.enable(Config(audit_sample=1.0))
    pipe = run(Config(audit_sample=1.0))
    stop, errors = threading.Event(), []
    threads = _readers(t.render, 8, stop, errors)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with caplog.at_level(logging.WARNING):
            for th in threads:
                th.start()
            pipe.run(max_events=1 << 14, idle_timeout_s=0.5)
            stop.set()
            for th in threads:
                th.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
        stop.set()
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:3]
    assert not [r for r in caplog.records
                if "raised at scrape time" in r.getMessage()]
    assert (pipe.validity_counts(), pipe.count_all()) == want
    assert t.auditor._fn.value == 0
    pipe.cleanup()


def test_false_negative_high_water_mark_is_one_step(tmp_path):
    """Threads released together read the fused FPR gauge over a shadow
    that holds roster keys the filter lacks: each pipeline's gauge raises
    the false-negative counter by the miss count once, whatever the
    interleaving (a lost update of its high-water mark adds it twice)."""
    import sys

    import numpy as np

    from attendance_tpu_torch.models.bloom import (
        bloom_contains_packed, keys_tensor)
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    t = obs.enable(Config(audit_sample=1.0))
    absent = np.arange(500_000, 500_064, dtype=np.uint32)
    t.auditor.record_roster(absent)  # shadowed, never preloaded
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    want = 0
    try:
        for trial in range(12):
            # Each pipeline's gauge has its own high-water mark.
            pipe = FusedPipeline(Config(audit_sample=1.0),
                                 client=MemoryClient(MemoryBroker()),
                                 device="cpu")
            pipe.preload(np.arange(10_000, 10_200, dtype=np.uint32))
            [gauge] = [m for name, _k, _h, members in t.registry.collect()
                       if name == "attendance_bloom_measured_fpr"
                       for m in members if ("surface", "fused") in m.labels]
            gate, errors = threading.Barrier(8), []

            def read():
                gate.wait(timeout=30)
                try:
                    gauge.read()
                except Exception as exc:  # recorded for the assertion
                    errors.append(repr(exc))

            threads = [threading.Thread(target=read) for _ in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert not any(th.is_alive() for th in threads)
            assert not errors, errors[:3]
            misses = int((~bloom_contains_packed(
                pipe.state.bloom_bits, keys_tensor(absent, pipe.device),
                pipe.params)).sum())
            assert misses > 0
            want += misses
            assert t.auditor._fn.value == want, trial
            pipe.cleanup()
    finally:
        sys.setswitchinterval(switch)
