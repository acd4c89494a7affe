"""Incident plane: correlated breach detection, evidence bundles, diagnosis.

Counterpart of ``attendance_tpu/obs/incident.py``: the same rules,
conditions, bundle files and ``doctor --incident`` text, so either
package's ``doctor`` reads either package's bundles and prints the same
table, and a bundle's ``diagnosis.json`` is the same in both.

The :class:`IncidentEngine` subscribes to every alert and transition
source the stack emits (SLO burn-rate firings, circuit-breaker opens,
spill growth, steady launch shapes, merge-lag, staleness and watermark
breaches, dead federation peers, lane stalls, integrity wire rejects)
and correlates simultaneous breaches into one incident record.

On open the engine captures an evidence bundle under ``--incident-dir``:

    <incident-dir>/<incident-id>/
        incident.json       record + sha256 manifest of every evidence part
        diagnosis.json      ranked rule matches (most likely cause first)
        flight.json         flight-recorder ring dump
        trace_slice.json    bounded trace slice for the breach window
        attribution.json    profiler attribution snapshot (+ launch shapes)
        metrics.prom        prom exposition snapshot
        fleet_status.json   fleet collector status when one is attached

Every part is written tmp+fsync+rename and its digest is recorded inside
``incident.json`` (never a ``MANIFEST.json``, which would collide with
the store-chain scrub family), so bundles survive the rot scrubber and
``doctor --incident`` verifies them offline.

Diagnosis is a declarative signature table: each rule names the
condition set that implies a cause. The rules, causes, evidence lists
and ``action`` ids are the JAX package's byte for byte, so
``diagnosis.json`` is equal across the packages; ``shape_churn``'s cause
keeps JAX's words ("XLA compilations"), as the launch-shape tracker
keeps JAX's help text (``obs/profiler.py``): on the card the condition
counts new kernel launch shapes.

``metrics.prom`` renders the registry, so on a pipeline with no
published read epoch the bundle's render launches K4 and K1 (the
accuracy gauges of ``obs/health.py`` and ``obs/audit.py``) from the
``incident-engine`` thread, on the default stream, never synchronizing
the whole device.

Departures from the JAX engine, where JAX passes over any exception:

* a gauge callback that raises ``LookupError`` (a torn-down owner)
  reads as no signal; any other exception leaves :meth:`tick`, and the
  engine's thread logs it as ``incident tick failed`` (the SLO engine's
  rule), never a quiet skip;
* an evidence part whose collection raises is logged and left out of the
  bundle, and a failed record write is logged; the incident stays open,
  as in JAX, and ``doctor --incident`` reports the missing part.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

from attendance_tpu_torch.obs.slo import ALERT_SCHEMA

logger = logging.getLogger(__name__)

INCIDENT_FILE = "incident.json"
DIAGNOSIS_FILE = "diagnosis.json"

#: The five evidence parts every bundle must contain (absent subsystems
#: contribute an explicit ``{"collected": false}`` stub, never a hole).
EVIDENCE_PARTS = (
    "flight.json",
    "trace_slice.json",
    "attribution.json",
    "metrics.prom",
    "fleet_status.json",
)

#: Bounded trace slice: hard cap on non-meta events kept in a bundle.
TRACE_SLICE_LIMIT = 5000

#: Corroborating-only conditions: they raise a diagnosis' rank and keep
#: an open incident open, but never OPEN one by themselves: a benign
#: idle tail trips the throughput EMA on every stop/start, and neither
#: matches any rule alone.
SECONDARY_CONDITIONS = frozenset({"throughput_drop", "stage_shift"})


# ---------------------------------------------------------------------------
# Diagnosis rules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    """One row of the diagnosis signature table.

    A rule matches when every ``required`` condition is present in the
    incident's condition set; ``optional`` conditions raise its rank.
    ``evidence`` names the bundle parts a human should open first.
    """

    name: str
    cause: str
    required: Tuple[str, ...]
    optional: Tuple[str, ...] = ()
    evidence: Tuple[str, ...] = ()
    #: Stable actuation id the control plane maps to a policy.
    action: str = ""


RULES: Tuple[Rule, ...] = (
    Rule(
        "persist_sink_down",
        "persist sink down: breaker open while batches spill to disk",
        required=("circuit_open", "spill_growth"),
        optional=("slo_burn",),
        evidence=("metrics.prom", "flight.json"),
        action="shed_ingress",
    ),
    Rule(
        "shape_churn",
        "steady-state recompiles: input shapes are churning XLA compilations",
        required=("steady_recompiles",),
        optional=("throughput_drop", "dispatch_gap"),
        evidence=("attribution.json", "metrics.prom"),
        action="pin_shapes",
    ),
    Rule(
        "dead_worker",
        "federation worker down: peer marked down while merge lag grows",
        required=("peer_down",),
        optional=("merge_lag", "slo_burn"),
        evidence=("fleet_status.json", "metrics.prom"),
        action="defer_rebalance",
    ),
    Rule(
        "temporal_dispatch_pass",
        "temporal host passes running on the dispatch thread: stage "
        "self-time shifted >20pp while throughput dropped",
        required=("throughput_drop", "stage_shift"),
        optional=("dispatch_gap",),
        evidence=("attribution.json", "trace_slice.json"),
        action="pause_temporal",
    ),
    Rule(
        "fed_merge_backlog",
        "federation merge backlog: merge-lag p99 over ceiling",
        required=("merge_lag",),
        optional=("slo_burn",),
        evidence=("metrics.prom", "fleet_status.json"),
        action="stretch_snapshot_cadence",
    ),
    Rule(
        "stale_reads",
        "serving reads stale: snapshot publish cadence behind ceiling",
        required=("read_staleness",),
        optional=("slo_burn",),
        evidence=("metrics.prom", "flight.json"),
        action="tighten_snapshot_cadence",
    ),
    Rule(
        "watermark_stall",
        "watermark stalled: event-time lag over ceiling, windows not closing",
        required=("watermark_lag",),
        optional=("throughput_drop",),
        evidence=("metrics.prom", "trace_slice.json"),
        action="widen_lateness",
    ),
    Rule(
        "lane_stall",
        "ingress lane stalled: one striped lane stopped making progress",
        required=("lane_stall",),
        optional=("throughput_drop",),
        evidence=("flight.json", "metrics.prom"),
        action="rescale_lanes",
    ),
    Rule(
        "sink_circuit_open",
        "persist breaker open: sink failing, spill not (yet) growing",
        required=("circuit_open",),
        optional=("slo_burn",),
        evidence=("metrics.prom", "flight.json"),
        action="shed_ingress",
    ),
    Rule(
        "wire_rot",
        "wire integrity rejects: corrupted frames arriving at ingress",
        required=("integrity_rejects",),
        optional=("throughput_drop",),
        evidence=("metrics.prom", "flight.json"),
        action="quarantine_only",
    ),
    Rule(
        "slo_burn",
        "error-budget burn: SLO firing without a correlated secondary signal",
        required=("slo_burn",),
        evidence=("metrics.prom", "flight.json"),
        action="escalate_ladder",
    ),
    Rule(
        "dispatch_gap",
        "device starvation: dispatch-gap p99 over ceiling",
        required=("dispatch_gap",),
        optional=("throughput_drop",),
        evidence=("attribution.json", "trace_slice.json"),
        action="resize_dispatch",
    ),
)


def diagnose(conditions) -> List[Dict[str, Any]]:
    """Rank the signature table against a condition set.

    Returns matching rules most-likely-first: rules with more required
    conditions satisfied are more specific and outrank broad single-signal
    rules; matched optional conditions break ties.
    """

    conds = set(conditions)
    ranked: List[Dict[str, Any]] = []
    for rule in RULES:
        if not all(c in conds for c in rule.required):
            continue
        opt = [c for c in rule.optional if c in conds]
        ranked.append(
            {
                "rule": rule.name,
                "cause": rule.cause,
                "score": 2 * len(rule.required) + len(opt),
                "matched": sorted(set(rule.required) | set(opt)),
                "evidence": list(rule.evidence),
                "action": rule.action,
            }
        )
    ranked.sort(key=lambda r: (-r["score"], r["rule"]))
    return ranked


# ---------------------------------------------------------------------------
# fsync'd bundle writes
# ---------------------------------------------------------------------------


def _fsync_write(path: Path, data: bytes) -> str:
    """Write ``data`` durably (tmp+fsync+rename) and return its sha256 hex."""

    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return hashlib.sha256(data).hexdigest()


def _fsync_dir(dir_path: Path) -> None:
    try:
        fd = os.open(dir_path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _json_bytes(doc: Any) -> bytes:
    return (json.dumps(doc, indent=1, sort_keys=True) + "\n").encode()


# ---------------------------------------------------------------------------
# Incident record
# ---------------------------------------------------------------------------


class Incident:
    """One open-or-cleared correlated breach with its on-disk bundle."""

    __slots__ = (
        "id",
        "path",
        "opened_unix",
        "cleared_unix",
        "conditions",
        "detail",
        "evidence",
        "diagnosis",
    )

    def __init__(self, iid: str, path: Path, opened_unix: float) -> None:
        self.id = iid
        self.path = path
        self.opened_unix = opened_unix
        self.cleared_unix: Optional[float] = None
        self.conditions: Set[str] = set()
        self.detail: Dict[str, Any] = {}
        self.evidence: Dict[str, str] = {}
        self.diagnosis: List[Dict[str, Any]] = []

    @property
    def top_rule(self) -> str:
        return self.diagnosis[0]["rule"] if self.diagnosis else ""

    def record(self, *, role: str, instance: str) -> Dict[str, Any]:
        return {
            "schema": ALERT_SCHEMA,
            "kind": "incident",
            "id": self.id,
            "role": role,
            "instance": instance,
            "opened_unix": round(self.opened_unix, 3),
            "cleared_unix": (
                round(self.cleared_unix, 3) if self.cleared_unix else None
            ),
            "conditions": sorted(self.conditions),
            "detail": self.detail,
            "evidence": dict(self.evidence),
            "diagnosis_top": self.top_rule,
        }


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class IncidentEngine:
    """Correlates live breach conditions into incidents with evidence.

    Rides the SLO engine's tick discipline: a daemon thread
    (``incident-engine``) calls :meth:`tick` every ``interval_s``; tests
    drive ``tick`` directly. An incident opens on the first tick whose
    condition set holds a primary condition (secondary,
    corroborating-only signals, :data:`SECONDARY_CONDITIONS`, never page
    alone) and clears after ``clear_ticks`` consecutive clean ticks
    (hysteresis, so a flapping signal cannot churn bundles).
    Delta-based conditions (spill growth, launch shapes, integrity
    rejects, lane stalls, throughput drops) warm up on the first tick so
    attaching to a long-running registry never back-dates an incident.
    """

    def __init__(
        self,
        telemetry,
        incident_dir: str,
        *,
        role: str = "",
        instance: str = "",
        clear_ticks: int = 3,
        interval_s: float = 1.0,
        breach_window_s: float = 60.0,
        staleness_ceiling_s: float = 5.0,
        watermark_lag_ceiling_s: float = 60.0,
        merge_lag_p99_ceiling_s: float = 5.0,
        dispatch_gap_p99_ceiling_s: float = 0.5,
        stage_shift_pp: float = 0.20,
        throughput_drop_ratio: float = 0.5,
        _clock=time.monotonic,
    ) -> None:
        self._t = telemetry
        self.dir = Path(incident_dir)
        self.role = role
        self.instance = instance or str(os.getpid())
        self.clear_ticks = max(1, int(clear_ticks))
        self.interval_s = interval_s
        self.breach_window_s = breach_window_s
        self.staleness_ceiling_s = staleness_ceiling_s
        self.watermark_lag_ceiling_s = watermark_lag_ceiling_s
        self.merge_lag_p99_ceiling_s = merge_lag_p99_ceiling_s
        self.dispatch_gap_p99_ceiling_s = dispatch_gap_p99_ceiling_s
        self.stage_shift_pp = stage_shift_pp
        self.throughput_drop_ratio = throughput_drop_ratio
        self._clock = _clock

        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._collector = None

        self._seq = 0
        self._open: Optional[Incident] = None
        self._clean = 0
        self._warmed = False
        self._prev_counters: Dict[str, float] = {}
        self._prev_hist: Dict[str, Tuple[List[int], int]] = {}
        self._stage_base: Dict[str, float] = {}
        self._rate_ema = 0.0
        self._rate_ticks = 0
        self.total_opened = 0

        reg = telemetry.registry
        self._g_open = reg.gauge(
            "attendance_incidents_open",
            help="Open correlated incidents on this instance.",
        )
        self._g_open.set(0.0)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="incident-engine", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # The pipeline goes on; the failure is a log record, not
                # a quiet tick.
                logger.exception("incident tick failed")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def finalize(self, reason: str = "shutdown") -> None:
        """Persist the latest state of a still-open incident at shutdown."""

        with self._lock:
            inc = self._open
            if inc is not None:
                inc.detail["finalized"] = reason
                self._write_record(inc)

    def bind_collector(self, collector) -> None:
        """Attach a fleet collector so bundles capture fleet-wide status."""

        self._collector = collector

    # -- registry access ------------------------------------------------

    def _families(self) -> Dict[str, Tuple[str, list]]:
        return {name: (kind, list(members))
                for name, kind, _help, members in self._t.registry.collect()}

    @staticmethod
    def _gauge_values(fams, name) -> List[Tuple[dict, float]]:
        kind_members = fams.get(name)
        if kind_members is None:
            return []
        out = []
        for m in kind_members[1]:
            try:
                v = float(m.read())
            except LookupError:
                # A torn-down owner is "no signal"; any other failure (a
                # card read) propagates.
                continue
            out.append((dict(m.labels), v))
        return out

    @staticmethod
    def _counter_total(fams, name) -> Optional[float]:
        kind_members = fams.get(name)
        if kind_members is None:
            return None
        return float(sum(m.value for m in kind_members[1]))

    def _counter_delta(self, fams, name: str) -> Optional[float]:
        cur = self._counter_total(fams, name)
        if cur is None:
            return None
        prev = self._prev_counters.get(name)
        self._prev_counters[name] = cur
        if prev is None:
            return None
        return cur - prev

    def _hist_p99_delta(self, fams, name: str) -> Optional[float]:
        """p99 over the observations that landed since the previous tick."""

        kind_members = fams.get(name)
        if kind_members is None or kind_members[0] != "histogram":
            return None
        from attendance_tpu_torch.obs.registry import quantile_from_buckets

        worst: Optional[float] = None
        for m in kind_members[1]:
            buckets, _total, count = m.snapshot()
            key = f"{name}{m.labels}"
            prev = self._prev_hist.get(key)
            self._prev_hist[key] = (list(buckets), count)
            if prev is None:
                continue
            delta = [max(0, b - p) for b, p in zip(buckets, prev[0])]
            dcount = count - prev[1]
            if dcount <= 0:
                continue
            q = quantile_from_buckets(delta, dcount, 0.99, m.scale)
            if q is not None and (worst is None or q > worst):
                worst = q
        return worst

    # -- condition evaluation -------------------------------------------

    def _evaluate(self) -> Tuple[Set[str], Dict[str, Any]]:
        conds: Set[str] = set()
        detail: Dict[str, Any] = {}
        fams = self._families()
        warm = self._warmed

        # SLO burn-rate firings (the engine's state; else the gauges).
        firing: List[str] = []
        slo = getattr(self._t, "slo", None)
        if slo is not None:
            firing = [name for name, st in slo._state.items() if st.firing]
        if not firing:
            firing = [
                labels.get("slo", "?")
                for labels, v in self._gauge_values(fams, "attendance_slo_firing")
                if v > 0.0
            ]
        if firing:
            conds.add("slo_burn")
            detail["slo_burn"] = sorted(firing)

        # Circuit-breaker opens (0 closed / 1 open / 2 half-open).
        open_sinks = [
            labels.get("sink", "?")
            for labels, v in self._gauge_values(fams, "attendance_circuit_state")
            if v > 0.0
        ]
        if open_sinks:
            conds.add("circuit_open")
            detail["circuit_open"] = sorted(open_sinks)

        # Spill growth while persisting.
        spill = self._counter_delta(
            fams, "attendance_persist_spilled_batches_total"
        )
        if warm and spill is not None and spill > 0:
            conds.add("spill_growth")
            detail["spill_growth"] = spill

        # Steady-state launch shapes (the tracker; registry fallback).
        steady_new = None
        rec = getattr(self._t, "recompiles", None)
        if rec is not None:
            snap = rec.snapshot()
            cur = float(snap.get("steady", 0))
            prev = self._prev_counters.get("_recompiles_steady")
            self._prev_counters["_recompiles_steady"] = cur
            if prev is not None:
                steady_new = cur - prev
            if steady_new and steady_new > 0:
                detail["steady_recompiles"] = {
                    "new": steady_new,
                    "fingerprints": len(snap.get("fingerprints", ()) or ()),
                }
        if steady_new is None:
            steady_new = self._counter_delta(
                fams, "attendance_recompiles_steady_total"
            )
            if warm and steady_new and steady_new > 0:
                detail["steady_recompiles"] = {"new": steady_new}
        if warm and steady_new and steady_new > 0:
            conds.add("steady_recompiles")

        # Dead federation peers.
        peers = self._gauge_values(fams, "attendance_fed_peer_up")
        down = [labels.get("peer", "?") for labels, v in peers if v <= 0.0]
        if down:
            conds.add("peer_down")
            detail["peer_down"] = sorted(down)

        # Merge-lag p99 over the last tick window.
        lag = self._hist_p99_delta(fams, "attendance_fed_merge_lag_seconds")
        if warm and lag is not None and lag > self.merge_lag_p99_ceiling_s:
            conds.add("merge_lag")
            detail["merge_lag"] = round(lag, 6)

        # Read staleness / watermark lag (level-based gauges).
        for cond, metric, ceiling in (
            (
                "read_staleness",
                "attendance_read_staleness_seconds",
                self.staleness_ceiling_s,
            ),
            (
                "watermark_lag",
                "attendance_watermark_lag_seconds",
                self.watermark_lag_ceiling_s,
            ),
        ):
            vals = [v for _labels, v in self._gauge_values(fams, metric)]
            if vals and max(vals) > ceiling:
                conds.add(cond)
                detail[cond] = round(max(vals), 6)

        # Dispatch-gap p99 over the last tick window.
        gap = self._hist_p99_delta(fams, "attendance_dispatch_gap_seconds")
        if warm and gap is not None and gap > self.dispatch_gap_p99_ceiling_s:
            conds.add("dispatch_gap")
            detail["dispatch_gap"] = round(gap, 6)

        # Integrity wire rejects.
        rejects = self._counter_delta(
            fams, "attendance_integrity_wire_rejects_total"
        )
        if warm and rejects is not None and rejects > 0:
            conds.add("integrity_rejects")
            detail["integrity_rejects"] = rejects

        # Lane stall: one striped lane stopped while siblings progress.
        lane_fam = fams.get("attendance_ingress_lane_events_total")
        if lane_fam is not None and len(lane_fam[1]) >= 2:
            deltas = {}
            for m in lane_fam[1]:
                lane = dict(m.labels).get("lane", "?")
                cur = float(m.value)
                prev = self._prev_counters.get(f"_lane_{lane}")
                self._prev_counters[f"_lane_{lane}"] = cur
                if prev is not None:
                    deltas[lane] = cur - prev
            if warm and deltas and max(deltas.values()) > 0:
                stalled = sorted(l for l, d in deltas.items() if d <= 0)
                if stalled:
                    conds.add("lane_stall")
                    detail["lane_stall"] = stalled

        # Throughput drop vs trailing EMA of the per-tick event rate.
        events = self._counter_total(fams, "attendance_events_total")
        if events is not None:
            prev = self._prev_counters.get("_events_total")
            self._prev_counters["_events_total"] = events
            if prev is not None:
                rate = max(0.0, events - prev)
                if (
                    self._rate_ticks >= 3
                    and self._rate_ema > 0
                    and rate < self.throughput_drop_ratio * self._rate_ema
                ):
                    conds.add("throughput_drop")
                    detail["throughput_drop"] = {
                        "rate": round(rate, 3),
                        "ema": round(self._rate_ema, 3),
                    }
                self._rate_ema = (
                    rate
                    if self._rate_ticks == 0
                    else 0.7 * self._rate_ema + 0.3 * rate
                )
                self._rate_ticks += 1

        # Stage self-time shift vs first-seen baseline (>20pp).
        for labels, frac in self._gauge_values(
            fams, "attendance_profile_stage_fraction"
        ):
            stage = labels.get("stage", "?")
            base = self._stage_base.get(stage)
            if base is None:
                self._stage_base[stage] = frac
                continue
            if frac - base > self.stage_shift_pp:
                conds.add("stage_shift")
                shifts = detail.setdefault("stage_shift", {})
                shifts[stage] = round(frac - base, 4)

        self._warmed = True
        return conds, detail

    # -- tick ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One evaluation pass; returns the open incident id, if any."""

        del now  # parity with SloEngine.tick; wall time taken at open/clear
        conds, detail = self._evaluate()
        with self._lock:
            if conds:
                if self._open is None:
                    # Secondary signals corroborate, never page alone.
                    if conds - SECONDARY_CONDITIONS:
                        self._clean = 0
                        self._open_incident(conds, detail)
                else:
                    self._clean = 0
                    if not conds <= self._open.conditions:
                        self._merge_incident(conds, detail)
            elif self._open is not None:
                self._clean += 1
                if self._clean >= self.clear_ticks:
                    self._clear_incident()
            self._g_open.set(1.0 if self._open is not None else 0.0)
            return self._open.id if self._open is not None else None

    # -- incident transitions -------------------------------------------

    def _open_incident(self, conds: Set[str], detail: Dict[str, Any]) -> None:
        self._seq += 1
        opened = time.time()
        iid = f"inc-{int(opened)}-{os.getpid()}-{self._seq:03d}"
        inc = Incident(iid, self.dir / iid, opened)
        inc.conditions = set(conds)
        inc.detail = dict(detail)
        inc.diagnosis = diagnose(conds)
        self._open = inc
        self.total_opened += 1

        # Raise the gauge BEFORE the bundle snapshot so metrics.prom
        # inside the bundle already shows the incident it belongs to.
        self._g_open.set(1.0)
        try:
            self._write_bundle(inc)
        except OSError:
            logger.exception("incident %s: bundle write failed", iid)
        self._t.registry.counter(
            "attendance_incidents_total",
            help="Incidents opened, by top diagnosis rule.",
            rule=inc.top_rule or "undiagnosed",
        ).inc()
        self._span(
            "incident_open",
            {
                "incident": iid,
                "conditions": sorted(conds),
                "rule": inc.top_rule or "undiagnosed",
            },
        )
        self._flight_mark(inc, "open")
        if inc.diagnosis:
            self._span(
                "incident_diagnosis",
                {
                    "incident": iid,
                    "rule": inc.top_rule,
                    "score": inc.diagnosis[0]["score"],
                },
            )

    def _merge_incident(self, conds: Set[str], detail: Dict[str, Any]) -> None:
        inc = self._open
        assert inc is not None
        inc.conditions |= conds
        for k, v in detail.items():
            inc.detail.setdefault(k, v)
        inc.diagnosis = diagnose(inc.conditions)
        try:
            self._write_diagnosis(inc)
            self._write_record(inc)
        except OSError:
            logger.exception("incident %s: record write failed", inc.id)

    def _clear_incident(self) -> None:
        inc = self._open
        assert inc is not None
        inc.cleared_unix = time.time()
        try:
            self._write_record(inc)
        except OSError:
            logger.exception("incident %s: record write failed", inc.id)
        self._span(
            "incident_clear",
            {
                "incident": inc.id,
                "open_s": round(inc.cleared_unix - inc.opened_unix, 3),
                "rule": inc.top_rule or "undiagnosed",
            },
        )
        self._flight_mark(inc, "clear")
        self._open = None
        self._clean = 0

    # -- evidence bundle -------------------------------------------------

    def _write_bundle(self, inc: Incident) -> None:
        inc.path.mkdir(parents=True, exist_ok=True)
        for name, build in (
            ("flight.json", lambda: _json_bytes(self._flight_doc(inc))),
            ("trace_slice.json", lambda: _json_bytes(self._trace_doc(inc))),
            ("attribution.json", lambda: _json_bytes(self._attribution_doc())),
            ("fleet_status.json", lambda: _json_bytes(self._fleet_doc())),
            ("metrics.prom", lambda: self._prom_text().encode()),
        ):
            try:
                data = build()
            except Exception:
                # The part stays out of the manifest: doctor --incident
                # reports it missing.
                logger.exception(
                    "incident %s: evidence part %s failed", inc.id, name)
                continue
            inc.evidence[name] = _fsync_write(inc.path / name, data)
        self._write_diagnosis(inc)
        self._write_record(inc)
        _fsync_dir(inc.path)

    def _write_diagnosis(self, inc: Incident) -> None:
        doc = {
            "schema": ALERT_SCHEMA,
            "incident": inc.id,
            "conditions": sorted(inc.conditions),
            "ranked": inc.diagnosis,
            "top": inc.top_rule or None,
        }
        inc.evidence[DIAGNOSIS_FILE] = _fsync_write(
            inc.path / DIAGNOSIS_FILE, _json_bytes(doc)
        )

    def _write_record(self, inc: Incident) -> None:
        inc.path.mkdir(parents=True, exist_ok=True)
        _fsync_write(
            inc.path / INCIDENT_FILE,
            _json_bytes(inc.record(role=self.role, instance=self.instance)),
        )
        _fsync_dir(inc.path)

    def _flight_doc(self, inc: Incident) -> Dict[str, Any]:
        fl = getattr(self._t, "flight", None)
        if fl is None:
            return {"collected": False, "reason": f"incident:{inc.id}"}
        return {
            "collected": True,
            "dumped_at_unix": round(time.time(), 3),
            "reason": f"incident:{inc.id}",
            "pid": os.getpid(),
            "total_records": fl.total,
            "records": fl.snapshot(),
        }

    def _trace_doc(self, inc: Incident) -> Dict[str, Any]:
        tr = getattr(self._t, "tracer", None)
        if tr is None:
            return {"collected": False, "traceEvents": []}
        exported = tr.export()
        cut_us = (inc.opened_unix - self.breach_window_s) * 1e6
        meta, rest = [], []
        for ev in exported.get("traceEvents", []):
            if ev.get("ph") == "M":
                meta.append(ev)
            elif float(ev.get("ts", 0.0)) >= cut_us:
                rest.append(ev)
        exported["traceEvents"] = meta + rest[-TRACE_SLICE_LIMIT:]
        exported["collected"] = True
        exported["incident"] = inc.id
        exported["window_s"] = self.breach_window_s
        return exported

    def _attribution_doc(self) -> Dict[str, Any]:
        rec = getattr(self._t, "recompiles", None)
        prof = getattr(self._t, "profiler", None)
        if prof is None:
            doc: Dict[str, Any] = {"kind": "attribution", "collected": False}
            if rec is not None:
                doc["recompiles"] = rec.snapshot()
            return doc
        # Force one on-demand sample so the snapshot is never empty.
        prof.sample_once()
        doc = prof.attribution(rec)
        doc["collected"] = True
        return doc

    def _fleet_doc(self) -> Dict[str, Any]:
        if self._collector is None:
            return {"collected": False, "instances": {}}
        doc = dict(self._collector.status())
        doc["collected"] = True
        return doc

    def _prom_text(self) -> str:
        from attendance_tpu_torch.obs.exposition import render

        return render(self._t.registry)

    # -- side channels ---------------------------------------------------

    def _span(self, name: str, args: Dict[str, Any]) -> None:
        tr = getattr(self._t, "tracer", None)
        if tr is None:
            return
        end = tr.now()
        tr.add_span(
            name, end, end, trace_id=tr.new_id(), role="incident", args=args
        )

    def _flight_mark(self, inc: Incident, state: str) -> None:
        fl = getattr(self._t, "flight", None)
        if fl is None:
            return
        fl.record(
            {
                "ts": round(time.time(), 3),
                "schema": ALERT_SCHEMA,
                "incident": inc.id,
                "state": state,
                "conditions": sorted(inc.conditions),
                "rule": inc.top_rule or "undiagnosed",
            }
        )


# ---------------------------------------------------------------------------
# Offline replay: doctor --incident DIR
# ---------------------------------------------------------------------------


def find_bundles(path) -> List[Path]:
    """Bundle dirs under ``path`` (itself a bundle, or a root of bundles)."""

    root = Path(path)
    if (root / INCIDENT_FILE).is_file():
        return [root]
    if not root.is_dir():
        raise FileNotFoundError(f"incident dir not found: {path}")
    found = sorted(
        d for d in root.iterdir() if d.is_dir() and (d / INCIDENT_FILE).is_file()
    )
    if not found:
        raise FileNotFoundError(f"no incident bundles under {path}")
    return found


def _verify_part(bundle: Path, name: str, expected: str) -> Tuple[str, bool]:
    part = bundle / name
    if not part.is_file():
        return "missing", False
    digest = hashlib.sha256(part.read_bytes()).hexdigest()
    if expected and digest != expected:
        return "digest mismatch", False
    return "sha256 ok", True


def _actuation_matches(action: str, rec: Dict[str, Any]) -> bool:
    """Does one actuation record satisfy a diagnosis rule's action id?
    ``escalate_ladder`` is satisfied by any escalating ladder move."""

    if rec.get("action") == action:
        return True
    return (
        action == "escalate_ladder"
        and rec.get("policy") == "degradation_ladder"
        and rec.get("direction") == "escalate"
    )


def incident_report(path, actuation_log=None) -> Tuple[str, bool]:
    """Replay bundles offline into the doctor verdict table.

    Returns ``(text, ok)``. ``ok`` is False when any bundle is incomplete,
    fails digest verification, or holds an *undiagnosed open* incident.
    Raises ``FileNotFoundError``/``ValueError`` for unreadable input so the
    CLI can exit 2 rather than report a false verdict.

    ``actuation_log`` (a control-plane JSONL path) adds a row per
    diagnosed bundle saying whether the controller's recorded actuation
    matched the top-ranked rule's ``action`` id (advisory actions have
    no knob by design and report as such). Mismatches are warnings, not
    failures: a bundle may predate the controller, or the controller
    may legitimately have acted on a lower-ranked rule first.
    """

    from attendance_tpu_torch.obs.exposition import _table

    actuations: List[Dict[str, Any]] = []
    if actuation_log is not None:
        from attendance_tpu_torch.control.actuation import read_actuations

        actuations, _problems = read_actuations(str(actuation_log))

    bundles = find_bundles(path)
    rows: List[List[str]] = []
    breached = 0
    for bundle in bundles:
        try:
            doc = json.loads((bundle / INCIDENT_FILE).read_text())
        except (OSError, json.JSONDecodeError) as exc:
            raise ValueError(f"unreadable incident record {bundle}: {exc}")
        iid = str(doc.get("id", bundle.name))
        schema = doc.get("schema")
        if schema is None:
            rows.append(
                [f"{iid} schema", "missing (pre-17 record)", "versioned", "warn"]
            )
        cleared = doc.get("cleared_unix")
        top = str(doc.get("diagnosis_top") or "")
        if cleared:
            rows.append([f"{iid} state", f"cleared @{cleared}", "-", "PASS"])
        elif top:
            rows.append([f"{iid} state", f"open, diagnosed: {top}", "-", "PASS"])
        else:
            rows.append([f"{iid} state", "open, undiagnosed", "diagnosed", "FAIL"])
            breached += 1
        rows.append(
            [
                f"{iid} conditions",
                ",".join(doc.get("conditions", ())) or "-",
                "-",
                "info",
            ]
        )

        evidence = dict(doc.get("evidence", {}))
        for name in EVIDENCE_PARTS + (DIAGNOSIS_FILE,):
            status, good = _verify_part(bundle, name, evidence.get(name, ""))
            rows.append(
                [f"{iid} {name}", status, "present+verified", "PASS" if good else "FAIL"]
            )
            if not good:
                breached += 1

        dx_path = bundle / DIAGNOSIS_FILE
        if dx_path.is_file():
            try:
                dx = json.loads(dx_path.read_text())
            except (OSError, json.JSONDecodeError) as exc:
                raise ValueError(f"unreadable diagnosis {dx_path}: {exc}")
            ranked = dx.get("ranked", [])
            if ranked:
                first = ranked[0]
                rows.append(
                    [
                        f"{iid} diagnosis",
                        f"{first.get('rule')} (score {first.get('score')})",
                        "-",
                        "info",
                    ]
                )
                action = str(first.get("action") or "")
                if actuation_log is not None and action:
                    from attendance_tpu_torch.control.engine import (
                        ADVISORY_ACTIONS,
                    )

                    mine = [a for a in actuations if a.get("incident") == iid]
                    if action in ADVISORY_ACTIONS:
                        rows.append(
                            [
                                f"{iid} actuation",
                                f"{action}: advisory (no knob)",
                                "-",
                                "info",
                            ]
                        )
                    elif any(_actuation_matches(action, a) for a in mine):
                        rows.append(
                            [
                                f"{iid} actuation",
                                f"matched top rule ({action})",
                                action,
                                "PASS",
                            ]
                        )
                    else:
                        rows.append(
                            [
                                f"{iid} actuation",
                                f"no recorded actuation for {action} "
                                f"({len(mine)} record(s) for incident)",
                                action,
                                "warn",
                            ]
                        )
    ok = breached == 0
    lines = [
        f"incident replay: {len(bundles)} bundle(s) under {path}",
        _table(rows, ["check", "value", "target", "verdict"]),
        f"verdict: {'PASS' if ok else 'FAIL'} ({breached} breached)",
    ]
    return "\n".join(lines), ok
