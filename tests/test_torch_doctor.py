"""The port's ``doctor`` (``obs/slo.doctor_report``, ``doctor_fleet_report``
and the ``doctor`` verb) against the JAX package's (the doctor half of
``tests/test_audit_slo.py`` and ``tests/test_profiler.py``).

The same artifacts give the same verdict text, byte for byte, and the
same exit codes (0 pass, 1 breach, 2 unreadable): the golden table, a
row of every kind the verdict has, a fleet directory, and each package's
doctor over the other package's artifacts from a real audited fused run
with the SLO engine on. ``--actuations`` (the control plane's log) is
held in ``tests/test_torch_control.py``. Every test leaves both packages'
process-global telemetry disabled.
"""

import json
from pathlib import Path

import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.cli import main as jax_main
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.obs import slo as jslo
from attendance_tpu_torch import obs
from attendance_tpu_torch.cli import main as port_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs.exposition import render
from attendance_tpu_torch.obs.registry import Registry
from attendance_tpu_torch.obs.slo import doctor_fleet_report, doctor_report
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

GOLDEN = Path(__file__).parent / "data" / "doctor_verdict.golden"


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _both(paths, **kw):
    """(text, ok) of both packages' doctor over the same artifacts, held
    equal."""
    ours = doctor_report(paths, **kw)
    theirs = jslo.doctor_report(paths, **kw)
    assert ours == theirs
    return ours


def _exit_code(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        return e.code
    return 0


def _cli_both(argv, capsys):
    """Exit code and printed verdict of both packages' verb, held equal."""
    rc = _exit_code(port_main, argv)
    ours = capsys.readouterr().out
    jrc = _exit_code(jax_main, argv)
    assert (rc, ours) == (jrc, capsys.readouterr().out)
    return rc, ours


# -- the golden table ------------------------------------------------------------

def _doctor_artifacts(tmp_path, breached: bool):
    reg = Registry()
    reg.gauge("attendance_bloom_measured_fpr").set(
        0.02 if breached else 0.004)
    reg.gauge("attendance_bloom_estimated_fpr").set(0.01)
    reg.counter("attendance_bloom_false_negatives_total")
    reg.gauge("attendance_hll_measured_rel_error",
              key="hll:unique:LECTURE_1").set(0.005)
    reg.gauge("attendance_slo_firing", slo="bloom_measured_fpr").set(
        1.0 if breached else 0.0)
    reg.gauge("attendance_slo_burn_rate", slo="bloom_measured_fpr",
              window="slow").set(20.0 if breached else 0.0)
    prom = tmp_path / "m.prom"
    prom.write_text("# scrape 1.0\n" + render(reg))
    alerts = tmp_path / "alerts.jsonl"
    alerts.write_text(json.dumps(
        {"schema": 1, "ts": 1.0, "slo": "bloom_measured_fpr",
         "state": "firing", "threshold": 0.01, "value": 0.02,
         "burn_fast": 75.0, "burn_slow": 20.0,
         "trace": "00000000deadbeef"}) + "\n" if breached else "")
    flight = tmp_path / "flight.json"
    flight.write_text(json.dumps({
        "reason": "test", "pid": 1, "ring_size": 4, "total_records": 2,
        "records": [
            {"ts": 0.5, "events": 512, "trace": "00000000deadbeef"},
            {"ts": 1.0, "alert": "bloom_measured_fpr",
             "state": "firing", "trace": "00000000deadbeef"},
        ] if breached else [{"ts": 0.5, "events": 512}]}))
    return [str(prom), str(alerts), str(flight)]


def test_doctor_verdict_golden_and_exit_codes(tmp_path, capsys):
    paths = _doctor_artifacts(tmp_path, breached=True)
    text, ok = _both(paths)
    assert not ok and text == GOLDEN.read_text()
    rc, out = _cli_both(["doctor"] + paths, capsys)
    assert rc == 1 and out == text + "\n"


def test_doctor_passes_clean_artifacts(tmp_path, capsys):
    paths = _doctor_artifacts(tmp_path, breached=False)
    text, ok = _both(paths)
    assert ok
    rc, out = _cli_both(["doctor"] + paths, capsys)
    assert rc == 0 and "verdict: PASS" in out


@pytest.mark.parametrize("what", ["missing", "garbage", "bad-jsonl",
                                  "nothing"])
def test_doctor_unreadable_artifacts_exit_2(tmp_path, capsys, what):
    path = tmp_path / "a.bin"
    argv = ["doctor", str(path)]
    if what == "garbage":
        path.write_text("{not json")
    elif what == "bad-jsonl":
        path.write_text('{"a": 1}\n{"b": 2}\n')
    elif what == "nothing":
        argv = ["doctor"]
    rc, _ = _cli_both(argv, capsys)
    assert rc == 2


# -- every row kind ----------------------------------------------------------------

def _hist(name, label, pairs):
    """A cumulative histogram's exposition lines."""
    lines = [f"# TYPE {name} histogram"]
    for le, c in pairs:
        lab = f'{label},le="{le}"' if label else f'le="{le}"'
        lines.append(f"{name}_bucket{{{lab}}} {c}")
    return "\n".join(lines) + "\n"


PROM_WITH_ATTRIBUTION = """\
# TYPE attendance_recompiles_total counter
attendance_recompiles_total{fn="step_words"} 3
# TYPE attendance_recompiles_steady_total counter
attendance_recompiles_steady_total{fn="step_words"} %(steady)s
# TYPE attendance_profile_stage_fraction gauge
attendance_profile_stage_fraction{stage="dispatch"} 0.42
attendance_profile_stage_fraction{stage="decode"} 0.11
# TYPE attendance_dispatch_thread_busy_fraction gauge
attendance_dispatch_thread_busy_fraction{component="device_dispatch"} 0.5
attendance_dispatch_thread_busy_fraction{component="temporal"} 0.3
# TYPE attendance_dispatch_gap_seconds histogram
attendance_dispatch_gap_seconds_bucket{le="0.000128"} 10
attendance_dispatch_gap_seconds_bucket{le="+Inf"} 12
attendance_dispatch_gap_seconds_sum 0.01
attendance_dispatch_gap_seconds_count 12
"""

ROWS = {
    "attribution": PROM_WITH_ATTRIBUTION % {"steady": 3},
    "attribution-untagged": (
        PROM_WITH_ATTRIBUTION % {"steady": 0}
        + 'attendance_profile_stage_fraction{stage="untagged"} 0.9\n'),
    "snapshot-stalls": (
        _hist("attendance_stage_latency_seconds", 'stage="snapshot_write"',
              [(0.001, 3), (0.004, 9), ("+Inf", 10)])
        + _hist("attendance_stage_latency_seconds",
                'stage="snapshot_blocked"', [(0.002, 0), ("+Inf", 0)])
        + "attendance_snapshot_chain_length 4\n"
        + "attendance_snapshot_write_failures_total 2\n"
        + "attendance_snapshot_disk_full_total 1\n"),
    "query-plane": (
        _hist("attendance_stage_latency_seconds", 'stage="query"',
              [(0.0005, 50), (0.002, 99), ("+Inf", 100)])
        + "attendance_query_false_negatives_total 0\n"
        + "attendance_query_measured_fpr 0.012\n"
        + "attendance_query_hll_rel_error 0.004\n"
        + "attendance_read_staleness_seconds 1.5\n"),
    "federation": (
        _hist("attendance_fed_merge_lag_seconds", "",
              [(0.01, 4), (0.1, 9), ("+Inf", 10)])
        + 'attendance_fed_peer_up{worker="w0"} 1\n'
        + 'attendance_fed_peer_up{worker="w1"} 0\n'
        + "attendance_fed_merged_deltas_total 17\n"
        + "attendance_fed_stale_frames_total 2\n"
        + "attendance_fed_takeovers_total 1\n"
        + "attendance_fed_geometry_rejects_total 1\n"),
    "temporal": (
        "attendance_watermark_lag_seconds 12.5\n"
        + 'attendance_late_events_total{outcome="folded"} 7\n'
        + 'attendance_late_events_total{outcome="dropped"} 3\n'
        + "attendance_window_rotations_total 40\n"
        + "attendance_window_evictions_total 5\n"),
    "integrity": (
        "attendance_reconnects_total 4\n"
        + "attendance_retry_attempts_total 9\n"
        + 'attendance_ingress_lane_events_total{lane="0"} 100\n'
        + 'attendance_ingress_lane_events_total{lane="1"} 40\n'
        + 'attendance_ingress_lane_events_total{lane="2"} 90\n'
        + 'attendance_chain_corrupt_files_total{kind="delta"} 2\n'
        + "attendance_chain_repairs_total 1\n"
        + "attendance_integrity_wire_rejects_total 3\n"
        + "attendance_spill_corrupt_records_total 1\n"
        + 'attendance_circuit_state{sink="columnar"} 0\n'),
    "open-circuit": 'attendance_circuit_state{sink="columnar"} 1\n',
    "empty": "# TYPE attendance_events_total counter\n",
}
CEILINGS = {
    "none": {},
    "gated": dict(fpr_ceiling=0.015, hll_error_ceiling=0.01,
                  snapshot_stall_ceiling=0.002, max_reconnects=2,
                  lane_skew_ceiling=0.5, query_p99_ceiling=0.001,
                  staleness_ceiling=1.0, merge_lag_ceiling=0.05,
                  watermark_lag_ceiling=30.0, recompile_ceiling=0),
}


@pytest.mark.parametrize("ceilings", sorted(CEILINGS))
@pytest.mark.parametrize("rows", sorted(ROWS))
def test_every_row_kind_equals_jax(tmp_path, rows, ceilings):
    prom = tmp_path / "m.prom"
    prom.write_text(ROWS[rows])
    text, ok = _both([str(prom)], **CEILINGS[ceilings])
    assert text.endswith("PASS") == ok


def test_recompile_ceiling_gate_and_vacuous_refusal(tmp_path):
    prom = tmp_path / "m.prom"
    prom.write_text(PROM_WITH_ATTRIBUTION % {"steady": 0})
    text, ok = _both([str(prom)], recompile_ceiling=0)
    assert ok and "steady-state recompiles" in text
    prom.write_text(PROM_WITH_ATTRIBUTION % {"steady": 2})
    assert not _both([str(prom)], recompile_ceiling=0)[1]
    # A ceiling over a run whose telemetry never exported the tracker
    # fails loudly, never vacuously.
    prom.write_text("# TYPE attendance_events_total counter\n"
                    "attendance_events_total 5\n")
    text, ok = _both([str(prom)], recompile_ceiling=0)
    assert not ok and "steady-state recompiles" in text


def test_attribution_info_rows(tmp_path):
    prom = tmp_path / "m.prom"
    prom.write_text(ROWS["attribution"])
    text, ok = _both([str(prom)])
    assert ok
    for want in ("profiled top stages", "dispatch 42%",
                 "dispatch thread occupancy", "temporal 30%",
                 "dispatch gap p50/p99",
                 "device recompiles (total, incl. warmup)",
                 "steady-state recompiles (shape leak?)"):
        assert want in text
    prom.write_text(ROWS["attribution-untagged"])
    row = next(l for l in _both([str(prom)])[0].splitlines()
               if "profiled top stages" in l)
    assert "dispatch 42%" in row and "untagged" not in row


# -- the fleet directory -------------------------------------------------------------

def test_fleet_report_equals_jax_and_gates_recompiles(tmp_path, capsys):
    fleet = tmp_path / "fleet"
    fleet.mkdir()
    (fleet / "worker@w0.prom").write_text(
        PROM_WITH_ATTRIBUTION % {"steady": 0} + ROWS["federation"])
    (fleet / "serve@s0.prom").write_text(
        "# TYPE attendance_events_total counter\n"
        "attendance_events_total 5\n"
        "attendance_read_staleness_seconds 0.5\n"
        "attendance_watermark_lag_seconds 3\n")
    for kw in ({}, dict(recompile_ceiling=0, merge_lag_ceiling=1.0,
                        staleness_ceiling=2.0, watermark_lag_ceiling=5.0)):
        ours = doctor_fleet_report(str(fleet), **kw)
        assert ours == jslo.doctor_fleet_report(str(fleet), **kw)
    text, ok = ours
    assert "fleet: steady-state recompiles" in text
    # The geometry-rejected frames of the worker's artifact fail it.
    assert not ok
    rc, out = _cli_both(["doctor", "--fleet", str(fleet)], capsys)
    assert rc == 1 and out.startswith("doctor --fleet: 2 role artifact(s)")
    (fleet / "worker@w0.prom").write_text(
        PROM_WITH_ATTRIBUTION % {"steady": 4})
    assert not doctor_fleet_report(str(fleet), recompile_ceiling=0)[1]
    (fleet / "worker@w0.prom").write_text(
        PROM_WITH_ATTRIBUTION % {"steady": 0})
    rc, _ = _cli_both(["doctor", "--fleet", str(fleet),
                       "--recompile-ceiling", "0"], capsys)
    assert rc == 0
    for bad in (tmp_path / "nope", tmp_path):  # missing; no *.prom
        rc, _ = _cli_both(["doctor", "--fleet", str(bad)], capsys)
        assert rc == 2


def test_fleet_rows_ride_along_with_artifacts(tmp_path, capsys):
    """--fleet with positional artifacts: both reports print, and a
    fleet breach fails the combined verdict."""
    fleet = tmp_path / "fleet"
    fleet.mkdir()
    (fleet / "worker@w0.prom").write_text(ROWS["open-circuit"])
    paths = _doctor_artifacts(tmp_path, breached=False)
    rc, out = _cli_both(["doctor", "--fleet", str(fleet)] + paths, capsys)
    assert rc == 1
    assert "doctor --fleet:" in out and "doctor: 3 artifact(s)" in out


# -- scrub, quarantine, refused planes ----------------------------------------------

def test_doctor_folds_the_scrub_into_its_exit_code(tmp_path, capsys):
    from attendance_tpu_torch.transport.quarantine import Quarantine

    qdir = tmp_path / "q"
    Quarantine(qdir).put(b"bad-frame", reason="poison-frame")
    paths = _doctor_artifacts(tmp_path, breached=False)
    rc, out = _cli_both(["doctor", "--scrub", str(qdir)], capsys)
    assert rc == 0
    rc, out = _cli_both(["doctor", "--scrub", str(qdir)] + paths, capsys)
    assert rc == 0 and "verdict: PASS" in out
    frame = next(qdir.glob("*.frame"))
    frame.write_bytes(b"rotted")  # the sidecar's digest no longer holds
    rc, _ = _cli_both(["doctor", "--scrub", str(qdir)] + paths, capsys)
    assert rc == 1
    rc, _ = _cli_both(["doctor", "--scrub", str(tmp_path / "gone")],
                      capsys)
    assert rc == 2


@pytest.mark.parametrize("flag,item", [("--actuations", "11e")])
def test_unported_planes_refused_at_parse_time(tmp_path, capsys, caplog,
                                               flag, item):
    """Item 11e ported the plane: ``--actuations`` parses now, and a path
    that is no actuation log (a directory) still exits 2, as JAX's verb
    does, with the artifacts' verdict never printed."""
    paths = _doctor_artifacts(tmp_path, breached=False)
    rc, out = _cli_both(["doctor", flag, str(tmp_path)] + paths, capsys)
    assert rc == 2
    assert "verdict" not in out
    assert "no such actuation log" in caplog.text
    assert f"ROADMAP item {item}" not in capsys.readouterr().err


# -- each package's doctor over the other's real run ----------------------------

def _audited_run(pkg, tmp_path):
    """A CPU fused run with the audit at 1.0, the SLO engine, a prom
    file, the launch-shape tracker and a flight ring; returns the
    artifact paths (telemetry stopped: the last block written)."""
    prom = tmp_path / f"{pkg}.prom"
    alerts = tmp_path / f"{pkg}-alerts.jsonl"
    kw = dict(bloom_filter_capacity=5_000, audit_sample=1.0,
              metrics_prom=str(prom), alert_log=str(alerts),
              flight_recorder=16, slo=["throughput>=1"])
    if pkg == "jax":
        from attendance_tpu.pipeline.fast_path import FusedPipeline
        from attendance_tpu.pipeline.loadgen import generate_frames
        from attendance_tpu.transport.memory_broker import (
            MemoryBroker, MemoryClient)
        cfg = JaxConfig(transport_backend="memory", json_chunk_decode=False,
                        **kw)
        o, extra = jobs, {}
    else:
        from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
        from attendance_tpu_torch.pipeline.loadgen import generate_frames
        from attendance_tpu_torch.transport.memory_broker import (
            MemoryBroker, MemoryClient)
        cfg = Config(**kw)
        o, extra = obs, {"device": "cpu"}
    o.enable(cfg)
    client = MemoryClient(MemoryBroker())
    pipe = FusedPipeline(cfg, client=client, num_banks=8, **extra)
    roster, frames = generate_frames(8_192, 2_048, roster_size=4_000,
                                     num_lectures=4, seed=5)
    pipe.preload(roster)
    producer = client.create_producer(cfg.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=8_192, idle_timeout_s=0.3)
    o.disable()
    pipe.cleanup()
    return [str(prom), str(alerts)]


def test_cross_package_doctor_over_real_runs(tmp_path, capsys,
                                             monkeypatch):
    """The port's doctor over the JAX run's artifacts prints JAX's
    verdict, and JAX's doctor over the port run's prints the port's."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    for pkg in ("jax", "port"):
        paths = _audited_run(pkg, tmp_path)
        for kw in ({}, dict(recompile_ceiling=0)):
            text, ok = _both(paths, **kw)
            assert ok, text
        assert "steady-state recompiles" in text
        assert "alert log" in text and "bloom measured FPR" in text
        argv = ["doctor", "--recompile-ceiling", "0"] + paths
        rc, _ = _cli_both(argv, capsys)
        assert rc == 0
