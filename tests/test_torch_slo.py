"""The port's SLO engine (``attendance_tpu_torch/obs/slo.py``) against the
JAX package's (the SLO half of ``tests/test_audit_slo.py`` and the SLO
tests of ``tests/test_chaos.py``).

Both packages' engines take the same gauge and counter values at the same
explicit tick times (no test sleeps for a tick): the firing state after
every tick, the burn gauges, the alert log's lines and the flight
records are equal at tolerance 0 (the wall-clock ``ts`` field apart).
The spec parser takes the same aliases and refuses the same specs. The
port's one departure, a gauge read that raises anything but
``LookupError`` failing the tick, is pinned here. Every test leaves both
packages' process-global telemetry disabled.
"""

import json
import logging
import math
import threading
import time

import numpy as np
import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.obs import slo as jslo
from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs import slo
from attendance_tpu_torch.obs.slo import (
    ALERT_SCHEMA, DEFAULT_SLOS, KNOWN_STAGES, SloEngine, parse_slo,
    resolve_slos)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


PKGS = {"port": (obs, slo), "jax": (jobs, jslo)}


def _engine(pkg, path, specs=(), **kw):
    """A telemetry bundle (not the process-global one: nothing starts)
    and an engine over it, fast 4 s / slow 20 s at one tick a second."""
    o, s = PKGS[pkg]
    t = o.Telemetry(flight_recorder=8)
    eng = s.SloEngine(t, specs, fast_s=4.0, slow_s=20.0, path=str(path),
                      **kw)
    return t, eng


def _alerts(path):
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        e = json.loads(line)
        e.pop("ts")
        out.append(e)
    return out


def _drive(tmp_path, script, specs=()):
    """Run ``script(t, eng, tick)`` through both packages' engines; each
    ``tick(now)`` returns the engine's firing map. Returns the per-tick
    firing maps, burn gauges, alert lines and flight alert records of
    each package."""
    out = {}
    for pkg in PKGS:
        path = tmp_path / f"{pkg}.jsonl"
        t, eng = _engine(pkg, path, specs)
        seen = []

        def tick(now, eng=eng, seen=seen):
            eng.tick(now=float(now))
            seen.append({name: (st.firing, st.fast.value, st.slow.value)
                         for name, st in eng._state.items()})

        script(t, eng, tick)
        flight = [{k: v for k, v in r.items() if k != "ts"}
                  for r in t.flight.snapshot() if "alert" in r]
        out[pkg] = (seen, _alerts(path), flight)
    return out


def _fpr(t):
    return t.registry.gauge("attendance_bloom_measured_fpr")


def test_sustained_breach_fires_like_jax(tmp_path):
    def script(t, eng, tick):
        _fpr(t).set(0.005)
        for i in range(25):
            tick(i)
        assert not eng._state["bloom_measured_fpr"].firing
        _fpr(t).set(0.05)
        for i in range(25, 50):
            tick(i)
        assert eng._state["bloom_measured_fpr"].firing
        text = t.render()
        assert 'attendance_slo_firing{slo="bloom_measured_fpr"} 1' in text
        assert "attendance_slo_burn_rate" in text

    got = _drive(tmp_path, script)
    assert got["port"] == got["jax"]
    seen, alerts, flight = got["port"]
    assert [a["state"] for a in alerts] == ["firing"]
    assert alerts[0]["slo"] == "bloom_measured_fpr"
    assert alerts[0]["schema"] == ALERT_SCHEMA
    assert alerts[0]["burn_fast"] >= slo.DEFAULT_FIRE_BURN
    assert flight[-1]["alert"] == "bloom_measured_fpr"


def test_single_window_spike_does_not_fire_like_jax(tmp_path):
    def script(t, eng, tick):
        _fpr(t).set(0.005)
        for i in range(21):
            tick(i)
        _fpr(t).set(0.05)  # a 2-tick spike: 10% of the slow window
        for i in range(21, 23):
            tick(i)
        _fpr(t).set(0.005)
        for i in range(23, 44):
            tick(i)

    got = _drive(tmp_path, script)
    assert got["port"] == got["jax"]
    assert not any(f for tick in got["port"][0]
                   for f, _, _ in tick.values())
    assert got["port"][1] == []


def test_alert_clears_with_hysteresis_like_jax(tmp_path):
    def script(t, eng, tick):
        _fpr(t).set(0.05)
        for i in range(25):
            tick(i)
        for i in range(25, 33):  # oscillation around the ceiling
            _fpr(t).set(0.05 if i % 2 else 0.005)
            tick(i)
        assert eng._state["bloom_measured_fpr"].firing
        _fpr(t).set(0.001)
        for i in range(33, 45):
            tick(i)

    got = _drive(tmp_path, script)
    assert got["port"] == got["jax"]
    assert [a["state"] for a in got["port"][1]] == ["firing", "resolved"]


def test_first_tick_breach_does_not_fire_like_jax(tmp_path):
    def script(t, eng, tick):
        _fpr(t).set(0.05)
        tick(0)
        tick(1)

    got = _drive(tmp_path, script)
    assert got["port"] == got["jax"]
    assert not got["port"][0][-1]["bloom_measured_fpr"][0]


def test_no_signal_is_not_a_breach_like_jax(tmp_path):
    def script(t, eng, tick):
        for i in range(30):
            tick(i)
        _fpr(t).set(float("nan"))
        for i in range(30, 60):
            tick(i)

    got = _drive(tmp_path, script)
    assert got["port"] == got["jax"]
    assert got["port"][1] == []


def test_throughput_and_quantile_slos_like_jax(tmp_path):
    def script(t, eng, tick):
        ev = t.registry.counter("attendance_events_total")
        h = t.stage("dequeue_wait")
        for i in range(30):
            ev.inc(10)  # 10 events a tick = 10/s under the 100 floor
            h.observe(0.5)  # every fresh observation breaches the p99
            tick(i)
        assert eng._state["throughput"].firing
        assert eng._state["dequeue_p99"].firing

    got = _drive(tmp_path, script, ("throughput>=100", "dequeue_p99<=0.1"))
    assert got["port"] == got["jax"]
    assert {a["slo"] for a in got["port"][1]} == {"throughput",
                                                  "dequeue_p99"}


def test_counter_slo_and_trace_cross_reference_like_jax(tmp_path):
    """The false-negative counter SLO fires, and the alert line carries
    the most recent flight record's trace id."""
    def script(t, eng, tick):
        fn = t.registry.counter("attendance_bloom_false_negatives_total")
        for i in range(30):
            t.record_batch(ts=float(i), events=512,
                           trace=f"{i:016x}")
            if i == 3:
                fn.inc()
            tick(i)

    got = _drive(tmp_path, script)
    assert got["port"] == got["jax"]
    alerts = got["port"][1]
    assert alerts[0]["slo"] == "bloom_false_negatives"
    assert alerts[0]["trace"] and alerts[0]["value"] == 1


def test_rendered_slo_series_equal_jax(tmp_path):
    """The engine's series (burn per window, firing, alert counters) are
    the JAX package's, help text included."""
    texts = {}
    for pkg in PKGS:
        t, eng = _engine(pkg, tmp_path / f"{pkg}.jsonl",
                         ("throughput>=5",))
        _fpr(t).set(0.5)
        for i in range(25):
            eng.tick(now=float(i))
        texts[pkg] = t.render()
    assert texts["port"] == texts["jax"]


# -- the spec parser -----------------------------------------------------------

SPECS = ["fpr<=0.02", "false_negatives<=0", "hll_error<=0.05",
         "throughput>=1e6", "read_staleness<=2.5", "watermark_lag<=30",
         "snapshot_failures<=0", "device_p95<=0.25", "dequeue_p99<=0.05",
         "assembly_p50<=0.1", "sketch_p99<=1", "query_p99 <= 0.002",
         "persist_p90>=0"]
BAD_SPECS = ["nonsense<=1", "fpr=0.01", "fpr<=abc", "bogus_p99<=1",
             "dispatch_p999<=1", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_equals_jax(spec):
    assert parse_slo(spec).__dict__ == jslo.parse_slo(spec).__dict__


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_slo_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as ours:
        parse_slo(spec)
    with pytest.raises(ValueError) as theirs:
        jslo.parse_slo(spec)
    assert str(ours.value) == str(theirs.value)


def test_parse_slo_specs_and_defaults():
    s = parse_slo("device_p95<=0.25")
    assert s.kind == "quantile" and s.quantile == 0.95
    assert s.label_filter == ("stage", "device_wait")
    slos = resolve_slos(["fpr<=0.5"])
    assert [s.threshold for s in slos
            if s.name == "bloom_measured_fpr"] == [0.5]
    assert len([s for s in slos if s.name == "bloom_false_negatives"]) == 1
    assert [s.__dict__ for s in resolve_slos(SPECS)] == [
        s.__dict__ for s in jslo.resolve_slos(SPECS)]
    assert [s.__dict__ for s in DEFAULT_SLOS] == [
        s.__dict__ for s in jslo.DEFAULT_SLOS]
    assert KNOWN_STAGES == jslo.KNOWN_STAGES


def test_config_rejects_bad_specs_and_windows():
    with pytest.raises(ValueError, match="unknown stage"):
        Config(slo=["bogus_p99<=1"])
    with pytest.raises(ValueError, match="windows"):
        Config(slo_fast_s=0.0)
    with pytest.raises(ValueError, match="slo_fast_s"):
        Config(slo_fast_s=10.0, slo_slow_s=5.0)
    Config(slo=list(SPECS))


# -- the LookupError-only departure --------------------------------------------

def test_lookup_error_reads_as_no_signal(tmp_path):
    """A torn-down owner's callback (LookupError) is no signal: the tick
    completes and the objective does not breach."""
    t, eng = _engine("port", tmp_path / "a.jsonl")

    def gone():
        raise LookupError("sketch owner was torn down")

    _fpr(t).set_function(gone)
    for i in range(30):
        eng.tick(now=float(i))
    st = eng._state["bloom_measured_fpr"]
    assert math.isnan(st.last_value) and not st.firing


def test_card_read_failure_fails_the_tick(tmp_path, caplog):
    """Any other exception from a callback (a failed card read) leaves
    tick(), and the engine's thread logs it as a failed tick, where the
    JAX engine reads it as a quiet NaN."""
    t, eng = _engine("port", tmp_path / "a.jsonl")

    def broken():
        raise RuntimeError("CUDA error: an illegal memory access")

    _fpr(t).set_function(broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.tick(now=0.0)
    # JAX skips the same callback as no signal.
    jt, jeng = _engine("jax", tmp_path / "j.jsonl")
    _fpr(jt).set_function(broken)
    jeng.tick(now=0.0)
    assert math.isnan(jeng._state["bloom_measured_fpr"].last_value)
    # On the engine's own thread: logged as a failed tick, and the
    # final tick at stop() logs too.
    eng.interval_s = 0.01
    with caplog.at_level(logging.ERROR, logger=slo.logger.name):
        eng.start()
        deadline = time.monotonic() + 10.0
        while not any("SLO tick failed" in r.getMessage()
                      for r in caplog.records):
            assert time.monotonic() < deadline, "no failed tick logged"
            time.sleep(0.01)
        eng.stop()
    assert any("SLO final tick failed" in r.getMessage()
               for r in caplog.records)
    assert not [th for th in threading.enumerate()
                if th.name == "slo-engine"]


# -- the engine in the bundle ----------------------------------------------------

def test_enable_builds_the_engine_like_jax(tmp_path):
    """enable() maps the config to the bundle as JAX's does: the engine
    at alert_log or slo, its tick interval, the staleness ceiling as a
    derived spec; the engine thread starts with telemetry and is gone
    after disable(), having touched the alert log."""
    log = tmp_path / "a.jsonl"
    kw = dict(alert_log=str(log), slo=["throughput>=5"], slo_fast_s=0.4,
              slo_slow_s=1.6, metrics_interval_s=0.5,
              read_staleness_ceiling_s=3.0)
    t = obs.enable(Config(**kw))
    assert t.slo is not None and log.exists()
    assert [th for th in threading.enumerate() if th.name == "slo-engine"]
    names = [s.name for s in t.slo.slos]
    interval = t.slo.interval_s
    obs.disable()
    assert not [th for th in threading.enumerate()
                if th.name == "slo-engine"]
    from attendance_tpu.config import Config as JaxConfig
    jt = jobs.enable(JaxConfig(**kw))
    assert [s.name for s in jt.slo.slos] == names
    assert jt.slo.interval_s == interval == 0.1
    jobs.disable()
    assert "read_staleness" in names
    # Telemetry is on at any of the new flags, off without them.
    assert obs.enabled_in(Config(alert_log="x"))
    assert obs.enabled_in(Config(slo=["fpr<=0.1"]))
    assert obs.enabled_in(Config(profile_hz=29.0))
    assert not obs.enabled_in(Config())


def test_audited_fused_run_alert_log_and_doctor(tmp_path):
    """A CPU fused run with the engine on: a finalized tick at run end,
    an empty alert log (no transition), and the run's own artifacts pass
    doctor (tests/test_audit_slo.py's real audited run)."""
    from attendance_tpu_torch.obs.slo import doctor_report
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    config = Config(bloom_filter_capacity=5_000, audit_sample=1.0,
                    metrics_prom=str(tmp_path / "m.prom"),
                    alert_log=str(tmp_path / "alerts.jsonl"),
                    flight_recorder=16)
    obs.enable(config)
    pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()),
                         device="cpu")
    roster, frames = generate_frames(8_192, 2_048, roster_size=4_000,
                                     num_lectures=4, seed=5)
    pipe.preload(roster)
    producer = pipe.client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=8_192, idle_timeout_s=0.3)
    st = obs.get().slo._state["bloom_measured_fpr"]
    assert st.samples, "run end did not tick the engine"
    obs.disable()  # writes the final exposition block
    pipe.cleanup()
    assert (tmp_path / "alerts.jsonl").read_text() == ""
    text, ok = doctor_report([str(tmp_path / "m.prom"),
                              str(tmp_path / "alerts.jsonl")])
    assert ok, text
    assert "bloom measured FPR" in text
    assert "alert log                " in text
