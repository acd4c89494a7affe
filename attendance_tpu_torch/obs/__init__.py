"""Live telemetry: registry + exposition + flight recorder + span tracing.

Counterpart of ``attendance_tpu/obs/__init__.py``: its telemetry core,
the SLO engine, the profiler planes, the incident engine, the fleet
pusher and the control plane. One process-wide :class:`Telemetry`
instance (module global), enabled iff a telemetry flag is set
(``--metrics-prom``, ``--metrics-port``, ``--flight-recorder``,
``--trace-out``, ``--audit-sample``, ``--alert-log``, ``--slo``,
``--profile-hz``, ``--fleet-push``, ``--incident-dir``,
``--control-log``).
Instrumented call sites capture the global ONCE at construction and pay
one ``is not None`` branch per hot-path event when telemetry is off:
nothing is timed or allocated, and the reporter, server, exporter and
auditor load only when a flag asks for them.

Wiring: pipeline constructors call :func:`ensure` with their config;
the first caller with a telemetry-enabled config creates and starts the
subsystem, everyone after (brokers, engines, sibling pipelines in the
same process) picks it up via :func:`get`. Tests drive
:func:`enable`/:func:`disable` directly.

A hot-path hook times with ``time.perf_counter`` and never
synchronizes the card or reads a CUDA tensor: ``device_wait`` is the
wait on a frame's own completion event, which the run loop already
makes. The sketch-health and measured-accuracy gauges (``obs/health.py``,
``obs/audit.py``) are callbacks that read the sketches when a scrape
renders the registry: from the pinned read epoch when there is one, else
from the card, on the default stream behind the run loop's steps (a
scrape waits for that stream, never for the whole device).

The SLO engine (``obs/slo.py``) ticks on its own thread; its accuracy
objectives read the same callback gauges, so a tick on a pipeline with
no read epoch launches K4 and K1 from that thread, on the default
stream, and never synchronizes the whole device. The launch-shape
tracker (``obs/profiler.RecompileTracker``) is always on with telemetry;
the host sampling profiler runs at ``--profile-hz > 0``.

The incident engine (``obs/incident.py``, thread ``incident-engine``)
and the fleet pusher (``obs/fleet.py``, thread ``fleet-pusher``) render
the registry, into each evidence bundle's ``metrics.prom`` and at every
push: the same callback gauges, so with no read epoch they launch K4 and
K1 from their threads too, on the default stream.

The control engine (``control/engine.py``, thread ``control-engine``)
reads the same registry and the sub-engines above, and moves only the
knobs a fused pipeline binds at construction; it is created last,
started after the incident engine and stopped first.

The metric names, labels, help strings and bucket bounds are the JAX
package's (the scrape contract).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from attendance_tpu_torch.obs.recorder import (  # noqa: F401
    _NOT_INSTALLED, DEFAULT_RING, FlightRecorder, install_sigusr1,
    uninstall_sigusr1)
from attendance_tpu_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, Registry)
from attendance_tpu_torch.obs.tracing import (  # noqa: F401
    TRACEPARENT, SpanContext, Tracer, format_ctx, parse_ctx)

logger = logging.getLogger(__name__)

# THE process-wide telemetry handle. None = disabled (the common case):
# every instrumented call site short-circuits on it.
TELEMETRY: Optional["Telemetry"] = None
_lock = threading.Lock()

DEFAULT_FLIGHT_PATH = "flight_recorder.json"

_atexit_installed = False


def _atexit_flush() -> None:
    t = TELEMETRY
    if t is None:
        return
    # Order matters: classify the SLOs first (a last-moment breach must
    # land in the alert log AND in the gauges), persist a still-open
    # incident, then write the final exposition block carrying those
    # gauges, then the trace, the profile and the last push.
    t.finalize_slo("atexit")
    if t.incidents is not None:
        t.incidents.finalize("atexit")
    if t._reporter is not None:
        t._reporter._write_block()
    t.flush_trace("atexit")
    t.flush_profile("atexit")
    if t._fleet is not None:
        t._fleet.push_now()  # the last snapshot reaches the collector


def _install_atexit_flush() -> None:
    """Register the exit-time flush once per process; it reads the
    CURRENT global, so stopped instances are neither pinned nor
    flushed. A CLI run shorter than the reporter interval would
    otherwise exit with an empty --metrics-prom file."""
    global _atexit_installed
    if _atexit_installed:
        return
    _atexit_installed = True
    import atexit

    atexit.register(_atexit_flush)


def enabled_in(config) -> bool:
    """Does this config ask for live telemetry at all?"""
    return bool(getattr(config, "metrics_prom", "")
                or getattr(config, "metrics_port", 0)
                or getattr(config, "flight_recorder", 0)
                or getattr(config, "trace_out", "")
                or getattr(config, "audit_sample", 0.0)
                or getattr(config, "alert_log", "")
                or getattr(config, "slo", None)
                or getattr(config, "fleet_push", "")
                or getattr(config, "profile_hz", 0.0)
                or getattr(config, "incident_dir", "")
                or getattr(config, "control_log", ""))


class Telemetry:
    """Registry + optional reporter/server/flight-recorder/tracer, SLO
    engine, profiler planes, incident engine, fleet pusher and control
    engine, one bundle."""

    def __init__(self, *, metrics_prom: str = "", metrics_port: int = 0,
                 metrics_interval_s: float = 1.0,
                 flight_recorder: int = 0,
                 flight_path: str = DEFAULT_FLIGHT_PATH,
                 trace_out: str = "", audit_sample: float = 0.0,
                 alert_log: str = "", slo_specs=(),
                 slo_fast_s: float = 60.0, slo_slow_s: float = 300.0,
                 fleet_push: str = "", fleet_role: str = "",
                 fleet_instance: str = "",
                 fleet_push_interval_s: float = 2.0,
                 metric_series_max: int = 1024,
                 profile_hz: float = 0.0, profile_out: str = "",
                 incident_dir: str = "",
                 incident_clear_ticks: int = 3,
                 control_log: str = "",
                 control_spill_dir: str = "",
                 control_dwell_s: float = 2.0,
                 control_clear_ticks: int = 3,
                 control_flap_limit: int = 8):
        self.registry = Registry(max_series=metric_series_max)
        self.flight: Optional[FlightRecorder] = (
            FlightRecorder(flight_recorder) if flight_recorder > 0
            else None)
        self.flight_path = flight_path or DEFAULT_FLIGHT_PATH
        # Span tracer: instrumented sites capture `telemetry.tracer`
        # once and branch on `is not None`, so a metrics-only run pays
        # nothing for tracing. A fleet-pushing process traces even
        # without --trace-out: its spans ship to the collector's
        # stitched export.
        self.tracer: Optional[Tracer] = (
            Tracer() if (trace_out or fleet_push) else None)
        self.trace_path = trace_out
        self._fleet_push = fleet_push
        self._fleet_role = fleet_role or "process"
        self._fleet_instance = fleet_instance
        self._fleet_interval = fleet_push_interval_s
        self._fleet = None
        # Accuracy auditor (obs/audit.py): the same capture-once handle
        # discipline; sketch stores and the fused pipeline hold
        # `telemetry.auditor` and branch on `is not None`.
        self.auditor = None
        if audit_sample > 0:
            from attendance_tpu_torch.obs.audit import ShadowAuditor
            self.auditor = ShadowAuditor(self.registry, audit_sample)
        # SLO burn-rate engine (obs/slo.py): evaluates declarative
        # objectives over the registry on its own thread; alert
        # transitions land in the JSONL log and the flight ring.
        self.slo = None
        if alert_log or slo_specs:
            from attendance_tpu_torch.obs.slo import SloEngine
            self.slo = SloEngine(self, slo_specs, slo_fast_s, slo_slow_s,
                                 alert_log,
                                 interval_s=min(metrics_interval_s,
                                                max(slo_fast_s / 4, 0.05)))
        # Attribution plane (obs/profiler.py): the launch-shape tracker
        # is always on with telemetry (one set lookup a dispatch); the
        # host sampling profiler only at --profile-hz > 0 (its stage
        # tracker is what the hot-path marks write into).
        from attendance_tpu_torch.obs.profiler import RecompileTracker
        self.recompiles = RecompileTracker(self.registry)
        self.profiler = None
        if profile_hz > 0:
            from attendance_tpu_torch.obs.profiler import SamplingProfiler
            self.profiler = SamplingProfiler(
                profile_hz, registry=self.registry, out_dir=profile_out)
        # Incident plane (obs/incident.py): correlates live breach
        # conditions into incident records with checksummed evidence
        # bundles under --incident-dir. Created after the sources it
        # reads.
        self.incidents = None
        if incident_dir:
            from attendance_tpu_torch.obs.incident import IncidentEngine
            self.incidents = IncidentEngine(
                self, incident_dir, role=self._fleet_role,
                instance=fleet_instance,
                clear_ticks=incident_clear_ticks,
                interval_s=min(metrics_interval_s, 1.0))
        # Control plane (control/): the actuation engine reads every
        # signal constructed above (slo, recompiles, incidents) and
        # moves only bounded knobs a pipeline binds at attach() time.
        # Created last, so its first tick sees the whole bundle.
        self.control = None
        if control_log:
            from attendance_tpu_torch.control.engine import ControlEngine
            self.control = ControlEngine(
                self, control_log, spill_dir=control_spill_dir,
                dwell_s=control_dwell_s, clear_ticks=control_clear_ticks,
                flap_limit=control_flap_limit,
                interval_s=min(metrics_interval_s, 1.0))
        self._reporter = None
        self._server = None
        self._prev_sigusr1 = _NOT_INSTALLED
        self._metrics_prom = metrics_prom
        self._metrics_port = metrics_port
        self._interval = metrics_interval_s
        self._stage_cache: Dict[str, Histogram] = {}
        self._wire_cache: Dict[str, Counter] = {}
        # The shared top-line counters both processors bump.
        self.events = self.registry.counter(
            "attendance_events_total", help="Events processed")
        self.frames = self.registry.counter(
            "attendance_frames_total", help="Frames/batches processed")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Telemetry":
        if self._metrics_prom or self._metrics_port:
            from attendance_tpu_torch.obs.exposition import (
                FileReporter, MetricsServer)
            if self._metrics_prom:
                self._reporter = FileReporter(
                    self.registry, self._metrics_prom,
                    self._interval).start()
            if self._metrics_port:
                # -1 selects an ephemeral port; the bound port is on
                # server.port either way.
                port = 0 if self._metrics_port < 0 else self._metrics_port
                self._server = MetricsServer(self.registry, port).start()
        if self.flight is not None:
            self._prev_sigusr1 = install_sigusr1(self.flight,
                                                 self.flight_path)
        if self.slo is not None:
            self.slo.start()
        if self.incidents is not None:
            # After the SLO engine: the first incident tick sees engine
            # state, not a half-built firing map.
            self.incidents.start()
        if self.profiler is not None:
            self.profiler.start()
        if self.control is not None:
            # After the incident engine: an actuation's incident id
            # comes from a tick that already saw the conditions.
            self.control.start()
        if self._fleet_push:
            from attendance_tpu_torch.obs.fleet import (
                FleetPusher, default_instance)
            self._fleet = FleetPusher(
                self.registry, self.tracer, self._fleet_push,
                role=self._fleet_role,
                instance=self._fleet_instance or default_instance(),
                interval_s=self._fleet_interval).start()
        if (self.tracer is not None or self._reporter is not None
                or self.slo is not None or self.profiler is not None
                or self.incidents is not None
                or self.control is not None):
            # Backstop for runs that never reach a run-loop flush; every
            # flush is idempotent.
            _install_atexit_flush()
        return self

    def stop(self) -> None:
        self.flush_trace("telemetry-stop")
        if self.control is not None:
            # The controller stops first: it must not actuate against
            # signal sources that the teardown below is dismantling.
            self.control.stop()
        if self.incidents is not None:
            # Persist a still-open incident while every evidence source
            # below is alive, then stop the tick thread.
            self.incidents.finalize("telemetry-stop")
            self.incidents.stop()
        if self.profiler is not None:
            # The sampler thread joined before the fleet drain below (the
            # final push carries its last stage fractions), then its
            # artifacts written (with the launch-shape ledger).
            self.profiler.stop()
            self.flush_profile("telemetry-stop")
        if self._fleet is not None:
            # Final push (the spans recorded above included), so a run
            # shorter than the push interval still reaches the collector.
            self._fleet.stop()
            self._fleet = None
        if self.slo is not None:
            # Final tick before the reporter's last block: a firing
            # alert reaches the log, the flight ring and the gauges.
            self.slo.stop()
        if self._reporter is not None:
            self._reporter.stop()
            self._reporter = None
        if self._server is not None:
            self._server.stop()
            self._server = None
        if self._prev_sigusr1 is not _NOT_INSTALLED:
            # Restore the displaced handler: a leaked one would keep
            # dumping this (now stale) ring to this (now stale) path.
            uninstall_sigusr1(self._prev_sigusr1)
            self._prev_sigusr1 = _NOT_INSTALLED

    @property
    def http_port(self) -> Optional[int]:
        return self._server.port if self._server is not None else None

    # -- cached handles (hot paths fetch these once at construction) ---------
    def stage(self, name: str) -> Histogram:
        h = self._stage_cache.get(name)
        if h is None:
            h = self._stage_cache[name] = self.registry.histogram(
                "attendance_stage_latency_seconds",
                help="Per-stage latency (power-of-2 buckets)",
                stage=name)
        return h

    def wire(self, name: str) -> Counter:
        c = self._wire_cache.get(name)
        if c is None:
            c = self._wire_cache[name] = self.registry.counter(
                "attendance_wire_frames_total",
                help="Frames dispatched per host->device wire",
                wire=name)
        return c

    # -- flight recorder -----------------------------------------------------
    def record_batch(self, **fields) -> None:
        if self.flight is not None:
            self.flight.record(fields)

    def dump_flight(self, reason: str) -> None:
        if self.flight is None:
            return
        p = self.flight.dump(self.flight_path, reason=reason)
        logger.info("Flight recorder dumped to %s (%s)", p, reason)

    # -- SLO engine ----------------------------------------------------------
    def finalize_slo(self, reason: str) -> None:
        """End-of-run SLO evaluation (no-op without the engine): one last
        classification tick, so runs shorter than the tick interval still
        judge their objectives and log any firing alert. The engine keeps
        running, as the tracer does after flush_trace."""
        if self.slo is not None:
            self.slo.finalize(reason)

    # -- profiling -----------------------------------------------------------
    def flush_profile(self, reason: str = "flush") -> None:
        """Write the profile artifacts (collapsed stacks, stage timeline,
        attribution.json with the launch-shape ledger) to --profile-out:
        idempotent, a no-op without a profiler, an out dir or a
        sample."""
        p = self.profiler
        if p is None or not p.out_dir or not p.samples:
            return
        path = p.write(p.out_dir, recompiles=self.recompiles)
        logger.info("Profile (%d samples) written under %s (%s)",
                    p.samples, path.parent, reason)

    # -- tracing -------------------------------------------------------------
    def flush_trace(self, reason: str = "flush") -> None:
        """Write the span buffer to ``--trace-out`` (atomic; no-op
        without a tracer or with nothing recorded). Called at the end of
        every run loop, on stop(), and at process exit."""
        if self.tracer is None or not self.trace_path:
            return
        if not len(self.tracer):
            return
        p = self.tracer.flush(self.trace_path)
        logger.info("Trace (%d spans) written to %s (%s)",
                    len(self.tracer), p, reason)

    def render(self) -> str:
        from attendance_tpu_torch.obs.exposition import render
        return render(self.registry)


def _slo_specs_from(config) -> tuple:
    """The config's SLO specs plus the derived ones: a set
    ``read_staleness_ceiling_s`` is a staleness SLO (one number, one
    spelling), derived where the specs are consumed so a Config built
    in code gets it as the CLI does."""
    specs = list(getattr(config, "slo", ()) or ())
    ceiling = getattr(config, "read_staleness_ceiling_s", 0.0)
    if ceiling and not any(
            s.replace(" ", "").startswith("read_staleness") for s in specs):
        specs.append(f"read_staleness<={ceiling}")
    return tuple(specs)


def enable(config) -> Telemetry:
    """Create, start, and install the global Telemetry from config."""
    global TELEMETRY
    with _lock:
        if TELEMETRY is not None:
            return TELEMETRY
        t = Telemetry(
            metrics_prom=getattr(config, "metrics_prom", ""),
            metrics_port=getattr(config, "metrics_port", 0),
            metrics_interval_s=getattr(config, "metrics_interval_s", 1.0),
            flight_recorder=getattr(config, "flight_recorder", 0),
            flight_path=getattr(config, "flight_path",
                                DEFAULT_FLIGHT_PATH),
            trace_out=getattr(config, "trace_out", ""),
            audit_sample=getattr(config, "audit_sample", 0.0),
            alert_log=getattr(config, "alert_log", ""),
            slo_specs=_slo_specs_from(config),
            slo_fast_s=getattr(config, "slo_fast_s", 60.0),
            slo_slow_s=getattr(config, "slo_slow_s", 300.0),
            fleet_push=getattr(config, "fleet_push", ""),
            fleet_role=getattr(config, "fleet_role", ""),
            fleet_instance=(getattr(config, "fleet_instance", "")
                            or getattr(config, "fed_worker", "")),
            fleet_push_interval_s=getattr(config,
                                          "fleet_push_interval_s", 2.0),
            metric_series_max=getattr(config, "metric_series_max",
                                      1024),
            profile_hz=getattr(config, "profile_hz", 0.0),
            profile_out=getattr(config, "profile_out", ""),
            incident_dir=getattr(config, "incident_dir", ""),
            incident_clear_ticks=getattr(config, "incident_clear_ticks",
                                         3),
            control_log=getattr(config, "control_log", ""),
            control_spill_dir=getattr(config, "control_spill_dir", ""),
            control_dwell_s=getattr(config, "control_dwell_s", 2.0),
            control_clear_ticks=getattr(config, "control_clear_ticks", 3),
            control_flap_limit=getattr(config, "control_flap_limit", 8))
        t.start()
        TELEMETRY = t
        return t


def ensure(config) -> Optional[Telemetry]:
    """The constructor chokepoint: returns the live global telemetry,
    creating it iff this config enables any telemetry surface. With all
    flags unset this is one global read: the disabled path."""
    if TELEMETRY is not None:
        return TELEMETRY
    if config is not None and enabled_in(config):
        return enable(config)
    return None


def get() -> Optional[Telemetry]:
    return TELEMETRY


def disable() -> None:
    """Stop and clear the global (tests; symmetric with enable)."""
    global TELEMETRY
    with _lock:
        if TELEMETRY is not None:
            TELEMETRY.stop()
            TELEMETRY = None
