"""The port's control plane (``attendance_tpu_torch/control``, ROADMAP item
11e) and CPython list scan (item 4) against the JAX package's.

The first half ports ``tests/test_control.py`` test for test, with the
same assertions, onto the port: the degradation ladder, the knobs, the
actuation log, the engine over a live registry, ingress admission, the
SLO stage check, the diagnosis wiring, ``doctor --actuations``, the
striped consumer's lane knob, the incident cross-reference and the
``Config`` checks.

The second half holds the port against the JAX package at tolerance 0:
the same tick schedule over the same registry signals gives the same
actuation records (apart from ``ts``) and byte-equal reports; the
``doctor`` verb's output and exit codes; ``incident_report`` with an
actuation log; a controlled fused pipeline run (spill and shed at rung
4, the audit thinned to every 8th frame, a temporal pause) lands on the
same registers, counters, stored rows, audit gauges and actuation
records as JAX's under the same tick schedule; the list scan's columns.
Then the port's departures, each pinned.

Every test leaves both packages' process-global telemetry and fault
plane disabled.
"""

import json
import logging
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from attendance_tpu import chaos as jchaos
from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.control import (
    ACTUATION_SCHEMA,
    ActuationLog,
    ControlEngine,
    DegradationLadder,
    IngressAdmission,
    Knob,
    KnobBoard,
    RUNGS,
    actuation_report,
    read_actuations,
)
from attendance_tpu_torch.obs.incident import (
    RULES, _actuation_matches, diagnose)
from attendance_tpu_torch.obs.slo import parse_slo
from torch_port_fixtures import fresh_shared_broker  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (chaos, obs, jchaos, jobs):
        mod.disable()
    yield
    for mod in (chaos, obs, jchaos, jobs):
        mod.disable()


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------------------------
# DegradationLadder state machine
# ---------------------------------------------------------------------------


def test_ladder_escalates_monotonically_in_order():
    clk = Clock()
    lad = DegradationLadder(dwell_s=1.0, escalate_ticks=2,
                            clear_ticks=2, clock=clk)
    seen = []
    for _ in range(40):
        clk.t += 1.0
        moved = lad.tick(True)
        if moved is not None:
            seen.append(moved)
        if lad.rung == len(RUNGS) - 1:
            break
    # One rung at a time, strictly in ladder order, never skipping.
    assert seen == [1, 2, 3, 4]
    assert lad.mode == "shed"
    # Saturated: more pressure never overshoots.
    clk.t += 10.0
    assert lad.tick(True) is None
    assert lad.rung == 4


def test_ladder_deescalates_in_reverse_order():
    clk = Clock()
    lad = DegradationLadder(dwell_s=0.5, escalate_ticks=1,
                            clear_ticks=2, clock=clk)
    while lad.rung < 4:
        clk.t += 1.0
        lad.tick(True)
    seen = []
    for _ in range(40):
        clk.t += 1.0
        moved = lad.tick(False)
        if moved is not None:
            seen.append(moved)
        if lad.rung == 0:
            break
    assert seen == [3, 2, 1, 0]
    # Stable at normal.
    clk.t += 5.0
    assert lad.tick(False) is None


def test_ladder_dwell_minimum_blocks_fast_transitions():
    clk = Clock()
    lad = DegradationLadder(dwell_s=10.0, escalate_ticks=1,
                            clear_ticks=1, clock=clk)
    clk.t += 0.1
    assert lad.tick(True) == 1  # ladder starts settled: first is free
    # Streak satisfied but dwell not: held at rung 1.
    for _ in range(5):
        clk.t += 1.0
        assert lad.tick(True) is None
    assert lad.rung == 1
    clk.t += 10.0
    assert lad.tick(True) == 2


def test_ladder_transition_consumes_streak():
    clk = Clock()
    lad = DegradationLadder(dwell_s=0.1, escalate_ticks=3,
                            clear_ticks=3, clock=clk)
    for i in range(3):
        clk.t += 1.0
        moved = lad.tick(True)
    assert moved == 1
    # The NEXT escalation needs a fresh 3-tick pressure streak even
    # though dwell has long passed.
    clk.t += 1.0
    assert lad.tick(True) is None
    clk.t += 1.0
    assert lad.tick(True) is None
    clk.t += 1.0
    assert lad.tick(True) == 2


def test_ladder_flap_limit_holds():
    clk = Clock()
    lad = DegradationLadder(dwell_s=0.01, escalate_ticks=1,
                            clear_ticks=1, flap_limit=3, clock=clk)
    # Alternate pressure/clean fast enough to flap; all transitions
    # stay inside one 60 s window.
    transitions = 0
    for i in range(20):
        clk.t += 0.1
        if lad.tick(i % 2 == 0) is not None:
            transitions += 1
    assert transitions == 3  # capped by flap_limit
    assert lad.flap_holds > 0
    # Window expiry re-arms the ladder.
    clk.t += 61.0
    assert lad.tick(True) is not None


# ---------------------------------------------------------------------------
# Knob safety envelopes
# ---------------------------------------------------------------------------


def test_knob_clamps_to_bounds_and_counts():
    state = {"v": 10}
    k = Knob("snap", lambda: state["v"],
             lambda v: state.__setitem__("v", v), lo=4, hi=64)
    p = k.propose(1000)
    assert p.outcome == "clamped" and p.applied == 64
    assert state["v"] == 64
    p = k.propose(1)
    assert p.outcome == "clamped" and p.applied == 4
    assert state["v"] == 4
    assert k.clamped_total == 2
    p = k.propose(32)
    assert p.outcome == "applied" and state["v"] == 32
    assert k.propose(32).outcome == "noop"


def test_shape_knob_refuses_out_of_ladder():
    state = {"v": 1024}
    k = Knob("dispatch_size", lambda: state["v"],
             lambda v: state.__setitem__("v", v),
             ladder=(256, 512, 1024), shape_safe=True)
    p = k.propose(300)  # NOT a warmed shape
    assert p.outcome == "refused" and p.applied is None
    assert state["v"] == 1024  # setter never ran
    assert k.refused_total == 1
    assert k.propose(512).outcome == "applied"
    assert k.step(+1) == 1024 and state["v"] == 512
    assert k.step(-1) == 256


def test_shape_knob_requires_ladder():
    with pytest.raises(ValueError):
        Knob("bad", lambda: 1, lambda v: None, shape_safe=True)


def test_knob_board_unknown_returns_none():
    b = KnobBoard()
    assert b.propose("nope", 1) is None


# ---------------------------------------------------------------------------
# Actuation log schema round-trip
# ---------------------------------------------------------------------------


def test_actuation_log_round_trip(tmp_path):
    path = tmp_path / "act.jsonl"
    log = ActuationLog(str(path))
    log.record(knob="audit_every", frm=1, to=8, outcome="applied",
               policy="degradation_ladder", action="widen_audit",
               direction="escalate", rung=1,
               conditions=["slo_burn", "circuit_open"],
               incident="inc-1-2-003")
    log.record(knob="dispatch_size", frm=1024, to=None,
               outcome="refused", policy="dispatch_resize",
               action="resize_dispatch", direction="adapt", rung=1,
               conditions=[], requested=300)
    log.close()
    records, problems = read_actuations(str(path))
    assert problems == []
    assert [r["seq"] for r in records] == [0, 1]
    assert records[0]["schema"] == ACTUATION_SCHEMA
    assert records[0]["conditions"] == ["circuit_open", "slo_burn"]
    assert records[0]["incident"] == "inc-1-2-003"
    assert records[1]["outcome"] == "refused"
    assert records[1]["requested"] == 300
    text, ok = actuation_report(str(path))
    assert ok
    assert "widen_audit" in text and "refused" in text


def test_actuation_log_detects_tamper_and_bad_seq(tmp_path):
    path = tmp_path / "act.jsonl"
    log = ActuationLog(str(path))
    for i in range(3):
        log.record(knob="k", frm=i, to=i + 1, outcome="applied",
                   policy="p", action="a", direction="adapt", rung=0,
                   conditions=[])
    log.close()
    lines = path.read_text().splitlines()
    doc = json.loads(lines[1])
    doc["seq"] = 0  # duplicate/regressed sequence
    doc["outcome"] = "mystery"
    lines[1] = json.dumps(doc)
    lines.append("{not json")
    path.write_text("\n".join(lines) + "\n")
    records, problems = read_actuations(str(path))
    assert any("not monotonic" in p for p in problems)
    assert any("unknown outcome" in p for p in problems)
    assert any("bad json" in p for p in problems)
    _text, ok = actuation_report(str(path))
    assert not ok


# ---------------------------------------------------------------------------
# Engine-level: rung application over a live registry
# ---------------------------------------------------------------------------


def _fake_pipe(snap_every=64):
    return SimpleNamespace(_audit_every=1, _snap_every=snap_every,
                           _temporal=None, consumer=None)


def _engine(tmp_path, clk, **kw):
    t = obs.enable(Config(control_log=str(tmp_path / "act.jsonl"),
                          metrics_interval_s=0.05))
    eng = t.control
    assert isinstance(eng, ControlEngine)
    eng.stop()  # drive tick() by hand, like the incident suite
    eng2 = ControlEngine(t, str(tmp_path / "act2.jsonl"),
                         dwell_s=kw.pop("dwell_s", 1.0),
                         escalate_ticks=kw.pop("escalate_ticks", 2),
                         clear_ticks=kw.pop("clear_ticks", 2),
                         _clock=clk, **kw)
    return t, eng2


def test_engine_walks_ladder_and_restores(tmp_path):
    clk = Clock()
    t, eng = _engine(tmp_path, clk)
    pipe = _fake_pipe()
    eng.attach(pipe)
    sick = t.registry.gauge("attendance_circuit_state",
                            help="x", sink="store")
    sick.set(1.0)  # OPEN -> pressure on every tick
    for _ in range(30):
        clk.t += 1.0
        eng.tick(clk.t)
        if eng.ladder.rung == 4:
            break
    assert eng.ladder.rung == 4
    assert pipe._audit_every == 8          # rung 1
    assert pipe._snap_every == 64 * 4      # rung 2
    assert eng.admission.mode == "shed"    # rung 4 (no spill dir)
    sick.set(0.0)  # healed
    for _ in range(60):
        clk.t += 1.0
        eng.tick(clk.t)
        if eng.ladder.rung == 0:
            break
    assert eng.ladder.rung == 0
    assert pipe._audit_every == 1
    assert pipe._snap_every == 64
    assert eng.admission.mode == "pass"
    records, problems = read_actuations(eng.log.path)
    assert problems == []
    rungs = [r for r in records if r["knob"] == "ladder.rung"]
    assert [r["to"] for r in rungs[:4]] == [
        "audit_wide", "snap_stretch", "temporal_pause", "shed"]
    assert rungs[-1]["to"] == "normal"
    # Every record carries the triggering conditions.
    assert all("conditions" in r for r in records)
    assert any("circuit_open" in r["conditions"] for r in records)
    eng.log.close()


def test_engine_dispatch_shape_ladder_refuses(tmp_path):
    clk = Clock()
    t, eng = _engine(tmp_path, clk)
    consumer = SimpleNamespace(_dispatch_size=1024, lanes=[])
    consumer.set_dispatch_size = \
        lambda v: setattr(consumer, "_dispatch_size", int(v))
    pipe = _fake_pipe()
    pipe.consumer = consumer
    eng.attach(pipe)
    knob = eng.board.get("dispatch_size")
    assert knob is not None and knob.ladder == (256, 512, 1024)
    prop = knob.propose(300)
    rec = eng._record(prop, policy="dispatch_resize",
                      action="resize_dispatch", direction="adapt",
                      conditions=[], incident=None)
    assert prop.outcome == "refused"
    assert consumer._dispatch_size == 1024
    assert rec is not None and rec["outcome"] == "refused"
    fams = {name: members for name, _k, _h, members
            in t.registry.collect()}
    refused = fams.get("attendance_control_refused_total")
    assert refused and sum(m.value for m in refused) == 1
    eng.log.close()


def test_engine_spill_mode_with_dir(tmp_path):
    clk = Clock()
    t, eng = _engine(tmp_path, clk,
                     spill_dir=str(tmp_path / "ingress"))
    pipe = _fake_pipe()
    eng.attach(pipe)
    knob = eng.board.get("admission_mode")
    assert knob.ladder == ("pass", "spill", "shed")
    sick = t.registry.gauge("attendance_circuit_state",
                            help="x", sink="store")
    sick.set(1.0)
    for _ in range(30):
        clk.t += 1.0
        eng.tick(clk.t)
        if eng.ladder.rung == 4:
            break
    assert eng.admission.mode == "spill"
    eng.log.close()


# ---------------------------------------------------------------------------
# Ingress admission spill/drain
# ---------------------------------------------------------------------------


def test_admission_spill_drain_retire(tmp_path):
    adm = IngressAdmission(str(tmp_path / "spill"))
    assert adm.admit(b"frame0") == "pass"  # mode starts open
    adm.mode = "spill"
    assert adm.admit(b"frame1") == "spill"
    assert adm.admit(b"frame2") == "spill"
    assert adm.pending_count == 2
    batch = adm.drain_batch()
    assert [p[1] for p in batch] == [b"frame1", b"frame2"]
    assert adm.pending_count == 0
    paths = [p for p, _ in batch]
    assert all(p.exists() for p in paths)  # retire is the caller's
    IngressAdmission.retire(paths)
    assert not any(p.exists() for p in paths)


def test_admission_adopts_crashed_spill(tmp_path):
    d = tmp_path / "spill"
    adm = IngressAdmission(str(d))
    adm.mode = "spill"
    adm.admit(b"orphan")
    # New process over the same dir: the orphan must replay first.
    adm2 = IngressAdmission(str(d))
    assert adm2.pending_count == 1
    assert adm2.drain_batch()[0][1] == b"orphan"


def test_admission_shed_without_dir():
    adm = IngressAdmission("")
    adm.mode = "shed"
    assert adm.admit(b"x") == "shed"
    assert adm.shed_total == 1


# ---------------------------------------------------------------------------
# Satellites: SLO stage validation, diagnosis action wiring, doctor verb
# ---------------------------------------------------------------------------


def test_parse_slo_rejects_unknown_stage():
    with pytest.raises(ValueError, match="unknown stage"):
        parse_slo("persst_p99<=0.1")
    with pytest.raises(ValueError, match="unknown stage"):
        Config(slo=["bogus_p99<=1"])  # the port checks at construction
    # Known stages and aliases still parse.
    assert parse_slo("dequeue_p99<=0.1").label_filter == \
        ("stage", "dequeue_wait")
    assert parse_slo("snapshot_blocked_p95<=1.0").quantile == 0.95
    Config(slo=["sketch_p50<=0.5", "throughput>=1"])


def test_every_rule_has_a_stable_action():
    assert all(r.action for r in RULES)
    ranked = diagnose({"circuit_open", "spill_growth"})
    assert ranked[0]["rule"] == "persist_sink_down"
    assert ranked[0]["action"] == "shed_ingress"


def test_actuation_matches_semantics():
    assert _actuation_matches("shed_ingress",
                              {"action": "shed_ingress"})
    assert not _actuation_matches("shed_ingress",
                                  {"action": "widen_audit"})
    # escalate_ladder is satisfied by any escalating ladder move.
    assert _actuation_matches(
        "escalate_ladder",
        {"action": "widen_audit", "policy": "degradation_ladder",
         "direction": "escalate"})
    assert not _actuation_matches(
        "escalate_ladder",
        {"action": "widen_audit", "policy": "degradation_ladder",
         "direction": "de-escalate"})


def test_doctor_actuations_verb(tmp_path, capsys):
    from attendance_tpu_torch.cli import main as cli_main
    path = tmp_path / "act.jsonl"
    log = ActuationLog(str(path))
    log.record(knob="audit_every", frm=1, to=8, outcome="applied",
               policy="degradation_ladder", action="widen_audit",
               direction="escalate", rung=1, conditions=["slo_burn"])
    log.close()
    with pytest.raises(SystemExit) as exc:
        cli_main(["doctor", "--actuations", str(path)])
    assert exc.value.code in (0, None)
    assert "actuation replay: ok" in capsys.readouterr().out
    # A corrupt log exits 1.
    path.write_text(path.read_text() + "{broken\n")
    with pytest.raises(SystemExit) as exc:
        cli_main(["doctor", "--actuations", str(path)])
    assert exc.value.code == 1
    # A missing log exits 2.
    with pytest.raises(SystemExit) as exc:
        cli_main(["doctor", "--actuations", str(tmp_path / "no.jsonl")])
    assert exc.value.code == 2


def test_striped_consumer_lane_rescale_surface():
    """The lane_rescale policy's actuation surface: parking lanes is
    clamped to [1, n], parked lanes report in active_lanes, and
    re-opening resumes them."""
    from attendance_tpu_torch.pipeline.lanes import StripedConsumer
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    config = Config(ingress_lanes=3, batch_size=64,
                    pulsar_topic="lanes-ctl")
    cons = StripedConsumer(config, MemoryClient(MemoryBroker()),
                           "lanes-ctl", "sub")
    try:
        assert cons.active_lanes == 3
        cons.set_active_lanes(1)
        assert cons.active_lanes == 1
        assert [lane.paused for lane in cons.lanes] == \
            [False, True, True]
        cons.set_active_lanes(0)  # clamped: never below one lane
        assert cons.active_lanes == 1
        cons.set_active_lanes(99)  # clamped to the configured width
        assert cons.active_lanes == 3
        assert not any(lane.paused for lane in cons.lanes)
    finally:
        cons.close()


def test_incident_report_cross_references_actuations(tmp_path):
    """`doctor --incident` + `--actuations`: the report says whether
    the recorded actuations matched the top-ranked rule's action."""
    from attendance_tpu_torch.obs.incident import incident_report

    t = obs.enable(Config(incident_dir=str(tmp_path / "incidents")))
    eng = t.incidents
    eng.stop()
    eng.dir.mkdir(parents=True, exist_ok=True)
    t.registry.gauge("attendance_circuit_state", sink="disk").set(1.0)
    eng.tick()
    iid = eng.tick()  # sink_circuit_open -> action shed_ingress
    assert iid is not None

    path = tmp_path / "act.jsonl"
    log = ActuationLog(str(path))
    log.record(knob="admission_mode", frm="pass", to="shed",
               outcome="applied", policy="degradation_ladder",
               action="shed_ingress", direction="escalate", rung=4,
               conditions=["circuit_open"], incident=iid)
    log.close()
    text, ok = incident_report(eng.dir, actuation_log=str(path))
    assert ok
    assert "matched top rule (shed_ingress)" in text

    # A log with no matching action warns but does not fail the
    # replay (the bundle may predate the controller).
    miss = tmp_path / "miss.jsonl"
    log = ActuationLog(str(miss))
    log.record(knob="audit_every", frm=1, to=8, outcome="applied",
               policy="degradation_ladder", action="widen_audit",
               direction="escalate", rung=1, conditions=[],
               incident=iid)
    log.close()
    text, ok = incident_report(eng.dir, actuation_log=str(miss))
    assert ok
    assert "no recorded actuation for shed_ingress" in text


def test_config_control_flags_validated():
    with pytest.raises(ValueError, match="control_dwell_s"):
        Config(control_log="/tmp/a", control_dwell_s=0)
    with pytest.raises(ValueError, match="control_spill_dir"):
        Config(control_spill_dir="/tmp/s")
    Config(control_log="/tmp/a", control_spill_dir="/tmp/s")


# ===========================================================================
# Parity with the JAX package (tolerance 0)
# ===========================================================================


def _pkg(pkg):
    """(Config, obs, ControlEngine) of one package."""
    if pkg == "jax":
        from attendance_tpu.control.engine import ControlEngine as JEngine
        return JaxConfig, jobs, JEngine
    return Config, obs, ControlEngine


def _ticked_engine(pkg, tmp_path, clk, *, spill_dir="", **cfg):
    """A package's telemetry bundle with its controller replaced by one on
    the injected clock (dwell 1 s, escalate and clear after 2 ticks):
    ticks are driven by hand, as in the JAX suite."""
    cfg_cls, ob, engine_cls = _pkg(pkg)
    log = tmp_path / f"{pkg}-act.jsonl"
    t = ob.enable(cfg_cls(control_log=str(log), **cfg))
    t.control.stop()
    t.control = engine_cls(t, str(log), spill_dir=spill_dir, dwell_s=1.0,
                           escalate_ticks=2, clear_ticks=2, _clock=clk)
    return t, t.control


def _tick_until(eng, clk, rung, limit=40):
    for _ in range(limit):
        if eng.ladder.rung == rung:
            return
        clk.t += 1.1
        eng.tick(clk.t)
    raise AssertionError(f"ladder stuck at {eng.ladder.rung}, want {rung}")


def _records(path):
    records, problems = read_actuations(str(path))
    assert problems == []
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def _schedule(eng, clk, t, sick, stage_fn):
    """The shared tick schedule over a hand-set circuit gauge: pressure
    to rung 1, a stage, pressure to rung 4, a stage, the clear to rung 0
    and a last stage."""
    sick.set(1.0)
    _tick_until(eng, clk, 1)
    stage_fn("rung1")
    _tick_until(eng, clk, 4)
    stage_fn("rung4")
    sick.set(0.0)
    _tick_until(eng, clk, 0)
    stage_fn("rung0")


@pytest.mark.parametrize("spill", [True, False], ids=["spill", "shed"])
def test_engine_records_and_report_equal_jax(tmp_path, spill):
    """The same tick schedule over the same registry signals: equal
    actuation records apart from ``ts``, knobs and gauges; each package
    reads the other's log, and the report text of the same file is the
    same bytes."""
    got = {}
    for pkg in ("jax", "port"):
        clk = Clock()
        spill_dir = str(tmp_path / pkg / "spill") if spill else ""
        t, eng = _ticked_engine(pkg, tmp_path, clk, spill_dir=spill_dir,
                                control_spill_dir=spill_dir)
        pipe = _fake_pipe(snap_every=16)
        eng.attach(pipe)
        sick = t.registry.gauge("attendance_circuit_state", help="x",
                                sink="store")
        knobs = []
        _schedule(eng, clk, t, sick, lambda stage: knobs.append(
            (stage, pipe._audit_every, pipe._snap_every,
             eng.admission.mode)))
        # The engine's series: the same exposition lines, help text
        # included.
        fams = [line for line in t.render().splitlines()
                if "attendance_control" in line]
        got[pkg] = (_records(eng.log.path), knobs, fams,
                    eng.ladder.transitions_total)
        eng.stop()
        _pkg(pkg)[1].disable()
    assert got["port"] == got["jax"]
    assert got["port"][1][1][3] == ("spill" if spill else "shed")
    assert len(got["port"][2]) >= 3 * 6  # HELP, TYPE, a sample each
    from attendance_tpu.control.actuation import (
        actuation_report as jreport, read_actuations as jread)
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}-act.jsonl")
        assert actuation_report(path) == jreport(path)
        assert read_actuations(path) == jread(path)


def _doctor_rc(main, argv, capsys):
    try:
        main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code or 0
    return rc, capsys.readouterr().out


def test_doctor_actuations_equal_jax(tmp_path, capsys):
    """``doctor --actuations`` over a log, a copy with one ``seq``
    repeated, a missing file, and with ``--incident``: the same printed
    text and exit codes in both CLIs."""
    from attendance_tpu.cli import main as jax_main
    from attendance_tpu_torch.cli import main as port_main

    t = obs.enable(Config(incident_dir=str(tmp_path / "incidents")))
    inc = t.incidents
    inc.stop()
    inc.dir.mkdir(parents=True, exist_ok=True)
    t.registry.gauge("attendance_circuit_state", sink="disk").set(1.0)
    inc.tick()
    iid = inc.tick()
    assert iid is not None
    path = tmp_path / "act.jsonl"
    log = ActuationLog(str(path))
    for i, (knob, action) in enumerate((("audit_every", "widen_audit"),
                                        ("admission_mode", "shed_ingress"))):
        log.record(knob=knob, frm=i, to=i + 1, outcome="applied",
                   policy="degradation_ladder", action=action,
                   direction="escalate", rung=i + 1,
                   conditions=["circuit_open"], incident=iid, ts=100.0 + i)
    log.close()
    tampered = tmp_path / "tampered.jsonl"
    lines = path.read_text().splitlines()
    lines.append(lines[-1])  # one seq repeated
    tampered.write_text("\n".join(lines) + "\n")
    cases = (
        (["doctor", "--actuations", str(path)], 0),
        (["doctor", "--actuations", str(tampered)], 1),
        (["doctor", "--actuations", str(tmp_path / "gone.jsonl")], 2),
        (["doctor", "--incident", str(inc.dir), "--actuations", str(path)],
         0),
        (["doctor", "--incident", str(inc.dir), "--actuations",
          str(tampered)], 1),
    )
    for argv, want in cases:
        ours = _doctor_rc(port_main, argv, capsys)
        theirs = _doctor_rc(jax_main, argv, capsys)
        assert ours == theirs, argv
        assert ours[0] == want, argv
    rc, out = _doctor_rc(port_main, cases[3][0], capsys)
    assert "matched top rule (shed_ingress)" in out
    assert "actuation replay: ok" in out


def test_incident_report_with_actuations_equals_jax(tmp_path):
    """``incident_report(..., actuation_log=)``: the same text and verdict
    in both packages for a matched log, a missed one and an advisory
    top rule."""
    from attendance_tpu.obs.incident import incident_report as jreport
    from attendance_tpu_torch.obs.incident import incident_report

    t = obs.enable(Config(incident_dir=str(tmp_path / "incidents")))
    inc = t.incidents
    inc.stop()
    inc.dir.mkdir(parents=True, exist_ok=True)
    t.registry.gauge("attendance_circuit_state", sink="disk").set(1.0)
    inc.tick()
    iid = inc.tick()
    for name, action in (("hit", "shed_ingress"), ("miss", "widen_audit")):
        log = ActuationLog(str(tmp_path / f"{name}.jsonl"))
        log.record(knob="k", frm=0, to=1, outcome="applied",
                   policy="degradation_ladder", action=action,
                   direction="escalate", rung=1, conditions=[],
                   incident=iid)
        log.close()
        path = str(tmp_path / f"{name}.jsonl")
        assert incident_report(inc.dir, actuation_log=path) == \
            jreport(inc.dir, actuation_log=path)
    assert incident_report(inc.dir) == jreport(inc.dir)


def test_config_control_checks_equal_jax():
    """The five control fields: JAX's defaults, and the same refusals
    (the port's at construction, JAX's in validate())."""
    ours, theirs = Config(), JaxConfig()
    for f in ("control_log", "control_spill_dir", "control_dwell_s",
              "control_clear_ticks", "control_flap_limit"):
        assert getattr(ours, f) == getattr(theirs, f), f
    for bad in (dict(control_log="a", control_dwell_s=0),
                dict(control_log="a", control_dwell_s=-1.0),
                dict(control_log="a", control_clear_ticks=0),
                dict(control_log="a", control_flap_limit=0),
                dict(control_spill_dir="s")):
        with pytest.raises(ValueError) as ours_exc:
            Config(**bad)
        with pytest.raises(ValueError) as theirs_exc:
            JaxConfig(**bad).validate()
        assert str(ours_exc.value) == str(theirs_exc.value)
    assert obs.enabled_in(Config(control_log="a"))
    assert jobs.enabled_in(JaxConfig(control_log="a"))


# -- a controlled fused pipeline run against JAX's ------------------------------

_RUN = dict(frames=12, frame=1_024, gen=dict(roster_size=4_000,
                                             num_lectures=4, seed=5))
_TEMPORAL = dict(temporal_period_s=1.0, allowed_lateness_s=2.0,
                 watermark_idle_s=0.0,  # no wall-clock-timed flush
                 temporal_ring_banks=64, cms_depth=3, cms_width=512,
                 cms_topk=5)
_TEMPORAL_GEN = dict(disorder_frac=0.25, late_max_s=0.8)


def _frames(pkg, temporal):
    if pkg == "jax":
        from attendance_tpu.pipeline.loadgen import generate_frames
    else:
        from attendance_tpu_torch.pipeline.loadgen import generate_frames
    gen = dict(_RUN["gen"], **(_TEMPORAL_GEN if temporal else {}))
    return generate_frames(_RUN["frames"] * _RUN["frame"], _RUN["frame"],
                           **gen)


def _controlled_run(pkg, tmp_path, mode, *, top=4, snapshots=True):
    """One package's fused pipeline under the shared schedule: frames 0-3
    at rung 0, the circuit gauge opened, ticks to rung 1, frames 4-5,
    ticks to ``top``, frames 6-8 (``spill``: spilled and drained at the
    run's end; ``shed``: nacked until the fourth nack clears the gauge
    and ticks to rung 3 from the run loop's thread; ``pause``: processed
    with the temporal sidecar paused), the clear to rung 0, frames 9-11.
    Returns the pipeline (not cleaned up), its telemetry and engine."""
    cfg_cls, ob, _ = _pkg(pkg)
    d = tmp_path / pkg
    clk = Clock()
    kw = dict(bloom_filter_capacity=5_000, audit_sample=0.5)
    if snapshots:
        kw.update(snapshot_dir=str(d / "snap"), snapshot_every_batches=2)
    if mode == "pause":
        kw.update(_TEMPORAL)
    spill_dir = str(d / "spill") if mode == "spill" else ""
    if pkg == "jax":
        kw["transport_backend"] = "memory"
    t, eng = _ticked_engine(pkg, d, clk, spill_dir=spill_dir,
                            control_spill_dir=spill_dir, **kw)
    if pkg == "jax":
        from attendance_tpu.pipeline.fast_path import FusedPipeline as P
        from attendance_tpu.transport.memory_broker import (
            MemoryBroker as B, MemoryClient as C)
        pipe = P(JaxConfig(control_log=str(d / f"{pkg}-act.jsonl"),
                           control_spill_dir=spill_dir, **kw),
                 client=C(B()), num_banks=8)
    else:
        from attendance_tpu_torch.pipeline.fast_path import (
            FusedPipeline as P)
        from attendance_tpu_torch.transport.memory_broker import (
            MemoryBroker as B, MemoryClient as C)
        pipe = P(Config(control_log=str(d / f"{pkg}-act.jsonl"),
                        control_spill_dir=spill_dir, **kw),
                 client=C(B()), num_banks=8, device="cpu")
    assert pipe._control is eng
    roster, frames = _frames(pkg, mode == "pause")
    frames = list(frames)
    pipe.preload(roster)
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    sick = t.registry.gauge("attendance_circuit_state", help="x",
                            sink="store")
    n = _RUN["frame"]

    def send_run(lo, hi, **run_kw):
        for f in frames[lo:hi]:
            producer.send(f)
        pipe.run(**(run_kw or dict(max_events=hi * n,
                                   idle_timeout_s=5.0)))

    send_run(0, 4)
    sick.set(1.0)
    _tick_until(eng, clk, 1)
    send_run(4, 6)
    _tick_until(eng, clk, top)
    if mode == "spill":
        send_run(6, 9, idle_timeout_s=0.2)
        assert eng.admission.spilled_total == 3
    elif mode == "shed":
        nack = pipe.consumer.negative_acknowledge
        seen = []

        def counted(msg):
            nack(msg)
            seen.append(msg)
            if len(seen) == 4:
                sick.set(0.0)
                _tick_until(eng, clk, 3)

        pipe.consumer.negative_acknowledge = counted
        send_run(6, 9)
        assert eng.admission.shed_total == 4
    else:
        send_run(6, 9)
    sick.set(0.0)
    _tick_until(eng, clk, 0)
    send_run(9, 12)
    return pipe, t, eng


def _core(pipe):
    """Registers by bank, the bank map, counters, validity and stored
    rows in a canonical order, of either package's pipeline."""
    from attendance_tpu_torch.models.fused import state_to_numpy
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    if isinstance(pipe, FusedPipeline):
        _, regs, counts = state_to_numpy(pipe.state)
    else:
        regs, counts = (np.asarray(pipe.state.hll_regs),
                        np.asarray(pipe.state.counts))
    cols = pipe.store.to_columns(deduplicate=False)
    cols = {k: np.asarray(cols[k]) for k in
            ("student_id", "lecture_day", "micros", "is_valid")}
    order = np.lexsort((cols["student_id"], cols["micros"],
                        cols["lecture_day"]))
    return dict(bank_of=dict(pipe._bank_of), regs=np.asarray(regs),
                counts=np.asarray(counts),
                valid=pipe.validity_counts(), pf=pipe.count_all(),
                store={k: v[order] for k, v in cols.items()},
                batches=pipe.metrics.batches, events=pipe.metrics.events)


_AUDIT_RE = re.compile(r"(attendance_(?:bloom|hll)_[a-z_]+)(\{[^}]*\})? (.+)")


def _audit_lines(text):
    """The audit and health samples of an exposition (the live fill,
    which JAX computes as a float32 device mean, left out)."""
    out = {}
    for line in text.splitlines():
        m = _AUDIT_RE.fullmatch(line)
        if m and m.group(1) not in ("attendance_bloom_fill_fraction",
                                    "attendance_bloom_estimated_fpr"):
            out[(m.group(1), m.group(2) or "")] = m.group(3)  # NaN-safe
    return out


@pytest.mark.parametrize("mode", ["spill", "shed"])
def test_controlled_run_equals_jax(tmp_path, monkeypatch, mode):
    """Spill or shed at rung 4, the audit thinned to every 8th frame from
    rung 1, delta snapshots every 2 frames: the same banks, registers,
    counters, stored rows, audit gauges and actuation records (apart
    from ``ts``) as JAX's run under the same tick schedule, every frame
    processed once, and no spill file left after the final barrier."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    got = {}
    for pkg in ("jax", "port"):
        pipe, t, eng = _controlled_run(pkg, tmp_path, mode)
        try:
            got[pkg] = (_core(pipe), _audit_lines(t.render()),
                        _records(eng.log.path))
            if mode == "spill":
                spill = tmp_path / pkg / "spill"
                assert sorted(spill.iterdir()) == [], pkg
                assert eng.admission.drained_total == 3
        finally:
            pipe.cleanup()
            _pkg(pkg)[1].disable()
    (pc, pa, pr), (jc, ja, jr) = got["port"], got["jax"]
    assert pc["bank_of"] == jc["bank_of"]
    np.testing.assert_array_equal(pc["regs"], jc["regs"])
    np.testing.assert_array_equal(pc["counts"], jc["counts"])
    assert pc["valid"] == jc["valid"] and pc["pf"] == jc["pf"]
    for k in jc["store"]:
        np.testing.assert_array_equal(pc["store"][k], jc["store"][k],
                                      err_msg=k)
    n = _RUN["frames"] * _RUN["frame"]
    assert pc["events"] == jc["events"] == n
    assert pc["batches"] == jc["batches"] == _RUN["frames"]
    assert sum(pc["valid"]) == n
    assert pa == ja and pa
    assert pr == jr
    rungs = [r["to"] for r in pr if r["knob"] == "ladder.rung"]
    assert rungs[:4] == ["audit_wide", "snap_stretch", "temporal_pause",
                         "shed"]
    assert rungs[-1] == "normal"
    assert {"audit_every", "snapshot_every", "admission_mode"} <= {
        r["knob"] for r in pr}


def test_temporal_pause_equals_jax(tmp_path, monkeypatch):
    """The temporal configuration driven to rung 3 and back: the frames
    processed while paused skip the sidecar in both packages, so the
    core state, the window counts, the temporal stats and the CMS equal
    JAX's, and the windows saw 3 frames fewer than the core."""
    from attendance_tpu_torch.models import cms as tcms
    monkeypatch.setenv("ATP_NATIVE", "0")
    got = {}
    for pkg in ("jax", "port"):
        pipe, t, eng = _controlled_run(pkg, tmp_path, "pause", top=3,
                                       snapshots=False)
        try:
            cms = (tcms.cms_to_numpy(pipe._temporal.cms_counts)
                   if pkg == "port" else np.asarray(pipe._temporal._cms))
            got[pkg] = (_core(pipe), pipe.window_counts(),
                        pipe.temporal_stats(), cms, _records(eng.log.path))
        finally:
            pipe.cleanup()
            _pkg(pkg)[1].disable()
    (pc, pw, ps, pcms, pr), (jc, jw, js, jcms, jr) = got["port"], got["jax"]
    assert pc["bank_of"] == jc["bank_of"]
    np.testing.assert_array_equal(pc["regs"], jc["regs"])
    np.testing.assert_array_equal(pc["counts"], jc["counts"])
    for k in jc["store"]:
        np.testing.assert_array_equal(pc["store"][k], jc["store"][k])
    assert pw == jw and pw
    assert ps == js
    np.testing.assert_array_equal(pcms, jcms)
    assert pr == jr
    assert ps["events"] == (_RUN["frames"] - 3) * _RUN["frame"]
    assert [r["to"] for r in pr if r["knob"] == "temporal_pause"] == [1, 0]


def test_temporal_series_equal_jax(tmp_path, monkeypatch):
    """The temporal plane's series (late outcomes, rotations, evictions,
    dwell pairs, the watermark lag and the buffer gauges), which the
    control plane's watermark adaptation reads: the same exposition
    lines as JAX's after the same temporal run."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    names = ("attendance_late_events_total",
             "attendance_window_rotations_total",
             "attendance_window_evictions_total",
             "attendance_dwell_pairs_total",
             "attendance_watermark_lag_seconds",
             "attendance_window_open_buckets",
             "attendance_temporal_reorder_buffered",
             "attendance_cms_topk_size")
    kw = dict(bloom_filter_capacity=5_000, metrics_port=-1,
              **dict(_TEMPORAL, temporal_ring_banks=8))
    got = {}
    for pkg in ("jax", "port"):
        cfg_cls, ob, _ = _pkg(pkg)
        extra = {"transport_backend": "memory"} if pkg == "jax" else {}
        t = ob.enable(cfg_cls(**kw, **extra))
        if pkg == "jax":
            from attendance_tpu.pipeline.fast_path import FusedPipeline as P
            from attendance_tpu.transport.memory_broker import (
                MemoryBroker as B, MemoryClient as C)
            pipe = P(JaxConfig(**kw, **extra), client=C(B()), num_banks=8)
        else:
            from attendance_tpu_torch.pipeline.fast_path import (
                FusedPipeline as P)
            from attendance_tpu_torch.transport.memory_broker import (
                MemoryBroker as B, MemoryClient as C)
            pipe = P(Config(**kw), client=C(B()), num_banks=8,
                     device="cpu")
        roster, frames = _frames(pkg, temporal=True)
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=_RUN["frames"] * _RUN["frame"],
                 idle_timeout_s=5.0)
        got[pkg] = [line for line in t.render().splitlines()
                    if line.split("{")[0].split(" ")[0] in names
                    or any(line.startswith(f"# {k} {n} ")
                           for k in ("HELP", "TYPE") for n in names)]
        pipe.cleanup()
        ob.disable()
    assert got["port"] == got["jax"]
    assert len(got["port"]) >= 3 * len(names)
    assert any(line.startswith("attendance_window_evictions_total ")
               and not line.endswith(" 0") for line in got["port"])


def test_widen_lateness_and_grow_ring_are_grow_only():
    """The two temporal knobs' setters (JAX ``temporal/plane.py:338-360``):
    a larger value is taken, a smaller or equal one ignored."""
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    pipe = FusedPipeline(Config(bloom_filter_capacity=1_000,
                                **dict(_TEMPORAL, temporal_ring_banks=16)),
                         num_banks=4, device="cpu")
    try:
        plane = pipe._temporal
        base = plane.reorder.lateness_us
        plane.widen_lateness(base // 2)
        assert plane.reorder.lateness_us == base
        plane.widen_lateness(base * 3 // 2)
        assert plane.reorder.lateness_us == base * 3 // 2
        plane.grow_ring(8)
        assert plane.ring.capacity == 16
        plane.grow_ring(20)
        assert plane.ring.capacity == 20
    finally:
        pipe.cleanup()


# -- the telemetry bundle's control engine --------------------------------------

def test_bundle_creates_control_last_and_stops_it_first(tmp_path):
    """``control_log`` turns telemetry on; the engine is built after the
    incident engine (ticking at min(metrics_interval_s, 1 s)), started
    after it, stopped before it, and no ``control-engine`` thread
    outlives ``obs.disable()``."""
    order = []
    t = obs.enable(Config(control_log=str(tmp_path / "a.jsonl"),
                          incident_dir=str(tmp_path / "inc"),
                          metrics_interval_s=0.05))
    assert t.control is not None and t.control.interval_s == 0.05
    assert t.control._thread.is_alive()
    assert t.control._thread.name == "control-engine"
    for name in ("control", "incidents"):
        eng = getattr(t, name)
        stop = eng.stop
        eng.stop = (lambda stop=stop, name=name:
                    (order.append(name), stop()))
    obs.disable()
    assert order == ["control", "incidents"]
    assert not [th for th in threading.enumerate()
                if th.name == "control-engine"]
    t = obs.enable(Config(control_log=str(tmp_path / "b.jsonl"),
                          metrics_interval_s=5.0))
    assert t.control.interval_s == 1.0
    obs.disable()


def test_control_flags_only_on_fused(tmp_path):
    """The control flags reach the fused verb's Config; every other verb
    refuses them at parse time (a controller attaches only to a fused
    pipeline)."""
    from attendance_tpu_torch.cli import (
        _control_config, build_parser)
    args = build_parser().parse_args(
        ["fused", "--control-log", str(tmp_path / "a.jsonl"),
         "--control-spill-dir", str(tmp_path / "s"),
         "--control-dwell-s", "0.5", "--control-clear-ticks", "4",
         "--control-flap-limit", "9"])
    cfg = Config(**_control_config(args))
    assert (cfg.control_log, cfg.control_spill_dir, cfg.control_dwell_s,
            cfg.control_clear_ticks, cfg.control_flap_limit) == (
        str(tmp_path / "a.jsonl"), str(tmp_path / "s"), 0.5, 4, 9)
    for verb in (["process"], ["pipeline"], ["bridge"], ["generate"],
                 ["serve", "--snapshot-dir", str(tmp_path)], ["federate"]):
        with pytest.raises(SystemExit) as e:
            build_parser().parse_args(
                verb + ["--control-log", str(tmp_path / "a.jsonl")])
        assert e.value.code == 2, verb


def test_fused_verb_writes_a_replayable_log(tmp_path, capsys):
    """``fused --control-log`` on the CPU: the controller attaches, the
    run ends with no actuation (no pressure), the log replays."""
    from attendance_tpu_torch.cli import main as port_main
    log = tmp_path / "act.jsonl"
    port_main(["fused", "--device", "cpu", "--num-events", "8192",
               "--frame-size", "2048", "--num-lectures", "2",
               "--bloom-capacity", "4096", "--control-log", str(log),
               "--control-spill-dir", str(tmp_path / "spill")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["events"] == 8192
    with pytest.raises(SystemExit) as e:
        port_main(["doctor", "--actuations", str(log)])
    assert e.value.code == 0
    assert "records: 0" in capsys.readouterr().out


# ===========================================================================
# The port's departures
# ===========================================================================


def _attached(tmp_path, clk):
    t, eng = _ticked_engine("port", tmp_path, clk)
    eng.attach(_fake_pipe())
    return t, eng


def test_card_read_failure_fails_the_control_tick(tmp_path):
    """A gauge callback raising anything but LookupError (a failed card
    read) leaves the port's tick, where JAX's passes over it; a
    LookupError (a torn-down owner) is no signal in both."""
    for pkg in ("jax", "port"):
        clk = Clock()
        t, eng = _ticked_engine(pkg, tmp_path / pkg, clk)
        eng.attach(_fake_pipe())
        eng.tick()

        def gone():
            raise LookupError("owner collected")

        t.registry.gauge("attendance_read_staleness_seconds").set_function(
            gone)
        eng.tick()  # no signal in both

        def broken():
            raise RuntimeError("card read failed")

        t.registry.gauge("attendance_read_staleness_seconds").set_function(
            broken)
        if pkg == "port":
            with pytest.raises(RuntimeError, match="card read failed"):
                eng.tick()
        else:
            assert eng.tick() == []
        eng.stop()
        _pkg(pkg)[1].disable()


def test_the_engine_thread_logs_a_failed_tick(tmp_path, caplog):
    """The ``control-engine`` thread logs a failed tick at error level
    ("control tick failed") and keeps ticking."""
    from attendance_tpu_torch.control import engine as ceng
    t = obs.enable(Config(control_log=str(tmp_path / "a.jsonl"),
                          metrics_interval_s=0.05))
    t.control.attach(_fake_pipe())

    def broken():
        raise RuntimeError("card read failed")

    with caplog.at_level(logging.ERROR, logger=ceng.logger.name):
        t.registry.gauge("attendance_read_staleness_seconds").set_function(
            broken)
        deadline = time.monotonic() + 10.0
        while not [r for r in caplog.records
                   if r.getMessage() == "control tick failed"]:
            assert time.monotonic() < deadline, "no failed-tick record"
            time.sleep(0.02)
    obs.disable()
    assert not [th for th in threading.enumerate()
                if th.name == "control-engine"]


def test_failed_actuation_log_write_is_logged_and_counted(tmp_path,
                                                          caplog):
    """A failed actuation-log write (JAX passes over it) is logged at
    error level and counted in
    ``attendance_control_log_write_failures_total``; the tick goes on, so
    every knob of the rung still moves."""
    from attendance_tpu_torch.control import engine as ceng
    clk = Clock()
    t, eng = _attached(tmp_path, clk)
    pipe = eng._pipe

    def full(*_a, **_k):
        raise OSError(28, "No space left on device")

    eng.log.record = full
    t.registry.gauge("attendance_circuit_state", sink="store").set(1.0)
    with caplog.at_level(logging.ERROR, logger=ceng.logger.name):
        _tick_until(eng, clk, 1)
    assert pipe._audit_every == 8  # the knob moved
    # the rung record and the knob's record both failed
    assert eng.log_failures_total == 2
    assert "attendance_control_log_write_failures_total 2" in t.render()
    assert sum(r.getMessage() == "actuation log write failed"
               for r in caplog.records) == 2
    eng.stop()


def test_a_failed_write_keeps_drained_spill_files_until_durable(
        tmp_path, monkeypatch):
    """The retire point: drained spill frames' files go only when the
    write that holds their results is durable. The writer fails every
    write after the drain, the process dies, and a successor adopts the
    files, drains them and lands on the uncontrolled run's state with
    the spill directory empty after its final barrier."""
    from attendance_tpu_torch.models.fused import state_to_numpy
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    monkeypatch.setenv("ATP_NATIVE", "0")
    n = 1_024
    roster, frames = generate_frames(5 * n, n, roster_size=4_000,
                                     num_lectures=4, seed=9)
    frames = list(frames)
    ref = FusedPipeline(Config(bloom_filter_capacity=5_000),
                        client=MemoryClient(MemoryBroker()), num_banks=8,
                        device="cpu")
    ref.preload(roster)
    producer = ref.client.create_producer(ref.config.pulsar_topic)
    for f in frames:
        producer.send(f)
    ref.run(max_events=5 * n, idle_timeout_s=5.0)

    spill = tmp_path / "spill"
    kw = dict(bloom_filter_capacity=5_000, snapshot_dir=str(tmp_path / "s"),
              snapshot_every_batches=2, control_log=str(tmp_path / "a.jsonl"),
              control_spill_dir=str(spill))
    broker = MemoryBroker()
    clk = Clock()
    t, eng = _ticked_engine("port", tmp_path, clk, spill_dir=str(spill),
                            **{k: v for k, v in kw.items()
                               if k != "control_log"})
    a = FusedPipeline(Config(**kw), client=MemoryClient(broker),
                      num_banks=8, device="cpu")
    a.preload(roster)
    producer = a.client.create_producer(a.config.pulsar_topic)
    for f in frames[:2]:
        producer.send(f)
    a.run(max_events=2 * n, idle_timeout_s=5.0)
    t.registry.gauge("attendance_circuit_state", sink="store").set(1.0)
    _tick_until(eng, clk, 4)

    def dead_disk(*_a, **_k):
        raise OSError(5, "Input/output error")

    a._write_delta_files = a._write_snapshot_files = dead_disk
    for f in frames[2:]:
        producer.send(f)
    a.run(idle_timeout_s=0.2)  # spilled, acked, drained at the end
    assert eng.admission.drained_total == 3
    assert len(list(spill.glob("ingress-*.bin"))) == 3  # not retired
    assert len(a._snap_unretired) == 3
    a.consumer.close()  # the process dies: nothing more is acked
    obs.disable()

    t = obs.enable(Config(**kw))
    assert t.control.admission.pending_count == 3  # adopted
    b = FusedPipeline(Config(**kw), client=MemoryClient(broker),
                      num_banks=8, device="cpu")
    b.run(idle_timeout_s=0.3)
    assert not list(spill.iterdir())
    want, got = ref, b
    _, rr, rc = state_to_numpy(want.state)
    _, gr, gc = state_to_numpy(got.state)
    assert set(got._bank_of) == set(want._bank_of)
    for day, bank in want._bank_of.items():
        np.testing.assert_array_equal(gr[got._bank_of[day]], rr[bank])
    np.testing.assert_array_equal(gc, rc)
    assert got.count_all() == want.count_all()
    for p in (ref, a, b):
        p.cleanup()


# ===========================================================================
# Item 4: the CPython list scan
# ===========================================================================


def _payload(**over):
    d = {"student_id": 12345, "timestamp": "2026-03-02T09:15:00",
         "lecture_id": "LECTURE_20260302", "is_valid": True,
         "event_type": "entry"}
    d.update(over)
    return json.dumps(d).encode()


def _python_columns(payloads):
    from attendance_tpu_torch.pipeline.events import (
        columns_from_events, decode_event)
    return columns_from_events([decode_event(p) for p in payloads])


def _assert_cols_equal(a, b):
    for k in ("student_id", "lecture_day", "micros", "is_valid",
              "event_type"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)


FAST_SHAPES = [
    _payload(),
    _payload(event_type="exit", is_valid=False),
    _payload(timestamp="2026-03-02 23:59:59"),
    _payload(timestamp="2026-03-02T09:15:00.25"),
    _payload(timestamp="2026-03-02T09:15:00.123456"),
    _payload(timestamp="2026-03-02T09:15:00.1234567"),
    _payload(student_id=0),
    _payload(student_id=(1 << 32) - 1),
    _payload(lecture_id="LECTURE_166123456"),
    b'{ "event_type":"exit", "x": 1,"lecture_id" : "LECTURE_20260101",'
    b' "is_valid":false,"timestamp":"2025-12-31T23:59:59.999999",'
    b'"student_id":7, "y": null }',
]
FALLBACK_SHAPES = [
    _payload(lecture_id="PHYS101"),
    _payload(timestamp="2026-03-02T09:15:00+00:00"),
    _payload(lecture_id="LECT\\u0055RE_20260302"),
    _payload(lecture_id="LECTURE_café"),
]


def test_list_scan_matches_buffer_scan_and_python():
    """``tests/test_bridge.py:98`` on the port: the list scan (payload
    bytes read in place) agrees with the buffer scan and the Python
    codec, refuses the same fallback shapes, and a non-bytes entry is a
    miss at its index."""
    from attendance_tpu_torch.native import load as load_native
    from attendance_tpu_torch.pipeline.events import (
        decode_json_batch_columns)
    nat = load_native()
    assert nat.has_list_scan  # this host has Python.h

    batch = FAST_SHAPES + FALLBACK_SHAPES + FAST_SHAPES[:3]
    _assert_cols_equal(decode_json_batch_columns(list(batch)),
                       _python_columns(batch))

    out = nat.empty_json_outputs(len(FAST_SHAPES))
    assert nat.parse_json_list(list(FAST_SHAPES), out, 0) == -1
    cols_buf, miss = nat.parse_json_events(FAST_SHAPES)
    assert miss == -1
    _assert_cols_equal(out.columns(), cols_buf)

    mixed = list(FAST_SHAPES) + [memoryview(_payload())] + [_payload()]
    out2 = nat.empty_json_outputs(len(mixed))
    assert nat.parse_json_list(mixed, out2, 0) == len(FAST_SHAPES)
    assert nat.parse_json_list(mixed, out2,
                               len(FAST_SHAPES) + 1) == -1
    _assert_cols_equal(decode_json_batch_columns(mixed),
                       _python_columns([bytes(p) for p in mixed]))
    for p in FALLBACK_SHAPES:
        out3 = nat.empty_json_outputs(1)
        assert nat.parse_json_list([p], out3, 0) == 0
    with pytest.raises(TypeError):
        nat.parse_json_list(tuple(FAST_SHAPES), out, 0)
    with pytest.raises(ValueError):
        nat.parse_json_list(list(FAST_SHAPES), nat.empty_json_outputs(2), 0)


def test_list_scan_equals_jax_list_scan():
    """The port's list scan and the JAX package's on the same payloads
    (the generator's wire and the shapes above): the same resume points
    and columns."""
    from attendance_tpu.native import load as jax_native
    from attendance_tpu.pipeline.events import (
        decode_json_batch_columns as jax_decode)
    from attendance_tpu_torch.native import load as load_native
    from attendance_tpu_torch.pipeline.events import (
        decode_json_batch_columns)
    jnat, nat = jax_native(), load_native()
    if jnat is None or not jnat.has_list_scan:
        pytest.skip("the JAX package's list scan did not build here")
    rng = np.random.default_rng(3)
    wire = [_payload(student_id=int(s), event_type=("exit" if s & 1
                                                    else "entry"),
                     timestamp=f"2026-03-{1 + s % 28:02d}T09:"
                               f"{s % 60:02d}:00.{s % 999983:06d}")
            for s in rng.integers(0, 1 << 32, 2_000)]
    for batch in (wire, FAST_SHAPES + FALLBACK_SHAPES + wire[:50],
                  list(FAST_SHAPES) + [memoryview(_payload())]):
        ours, theirs = (nat.empty_json_outputs(len(batch)),
                        jnat.empty_json_outputs(len(batch)))
        idx = 0
        while True:
            m = nat.parse_json_list(batch, ours, idx)
            assert m == jnat.parse_json_list(batch, theirs, idx)
            if m < 0:
                break
            idx = m + 1
        _assert_cols_equal(decode_json_batch_columns(batch),
                           jax_decode(batch))


def test_dispatch_step_down_adds_no_steady_launch_shape(tmp_path):
    """The ``dispatch_size`` knob keeps JAX's ladder (256 up to the
    coalesce size, powers of two); stepping it down on striped JSON lanes
    after a warm run launches no shape the launch-shape tracker had not
    seen (a lane block is cut at the configured size, so a smaller target
    only coalesces fewer blocks)."""
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)
    from test_torch_lanes import ROSTER, _json_payloads
    cfg = Config(bloom_filter_capacity=10_000, batch_size=512,
                 ingress_lanes=2, control_log=str(tmp_path / "a.jsonl"),
                 metrics_interval_s=5.0)
    t = obs.enable(cfg)
    pipe = FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                         num_banks=8, device="cpu")
    try:
        pipe.preload(ROSTER)
        producer = pipe.client.create_producer(cfg.pulsar_topic)
        producer.send_many(_json_payloads(3_000, ROSTER, seed=1))
        pipe.run(max_events=3_000, idle_timeout_s=10.0)
        knob = t.control.board.get("dispatch_size")
        assert knob.ladder == (256, 512) and knob.shape_safe
        rec = t.control._record(knob.propose(knob.step(-1)),
                                policy="dispatch_resize",
                                action="resize_dispatch", direction="adapt",
                                conditions=["dispatch_gap"], incident=None)
        assert rec["outcome"] == "applied" and rec["to"] == 256
        assert pipe.consumer._dispatch_size == 256
        producer.send_many(_json_payloads(3_000, ROSTER, seed=2))
        pipe.run(max_events=6_000, idle_timeout_s=10.0)
        assert pipe.metrics.events == 6_000
        steady = [line for line in t.render().splitlines()
                  if line.startswith("attendance_recompiles_steady_total")]
        assert steady and all(line.endswith(" 0") for line in steady)
    finally:
        pipe.cleanup()


def test_only_an_undecodable_spilled_frame_is_parked(tmp_path, monkeypatch):
    """The drain parks a spilled frame that fails to decode as ``.poison``
    and goes on; any other failure of its replay leaves ``run()`` with
    the file kept for the next process (JAX's drain parks on any
    exception)."""
    from attendance_tpu_torch.pipeline import fast_path
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    monkeypatch.setenv("ATP_NATIVE", "0")
    spill = tmp_path / "spill"
    adm = IngressAdmission(str(spill))
    adm.mode = "spill"
    roster, frames = generate_frames(2_048, 1_024, roster_size=1_000,
                                     num_lectures=2, seed=1)
    frames = list(frames)
    adm.admit(b"not a frame")
    adm.admit(frames[0])
    cfg = Config(bloom_filter_capacity=2_000,
                 control_log=str(tmp_path / "a.jsonl"),
                 control_spill_dir=str(spill))
    obs.enable(cfg)
    pipe = fast_path.FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                                   num_banks=4, device="cpu")
    try:
        pipe.preload(roster)
        pipe.run(idle_timeout_s=0.2)
        assert [p.name for p in spill.iterdir()] == [
            "ingress-000001.poison"]
        assert pipe.metrics.events == 1_024
    finally:
        pipe.cleanup()
        obs.disable()

    adm = IngressAdmission(str(spill))
    adm.mode = "spill"
    adm.admit(frames[1])
    obs.enable(cfg)
    pipe = fast_path.FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                                   num_banks=4, device="cpu")

    def broken(_cols, _padded):
        raise RuntimeError("device fault")

    pipe._dispatch_single = broken
    try:
        pipe.preload(roster)
        with pytest.raises(RuntimeError, match="device fault"):
            pipe.run(idle_timeout_s=0.2)
        # Numbered from the .bin files alone, as in JAX.
        assert sorted(p.name for p in spill.iterdir()) == [
            "ingress-000001.bin", "ingress-000001.poison"]
    finally:
        pipe.cleanup()
