"""The actuation engine — a controller thread that closes the loop
from the signals the observability plane already measures to the knobs
the pipeline exposes, under hard safety rails.

Counterpart of ``attendance_tpu/control/engine.py``: the same policies,
series, help text, span and actuation records, tick for tick. The
control plane launches nothing itself; its knobs change what the fused
pipeline launches (the audit shadow's frame interval, the snapshot
cadence and with it B9's captures, the temporal sidecar's K4/K5 window
adds and K6 CMS steps, and the K2 steps of frames admission spills and
later drains).

Sensing (all read from the metrics registry / telemetry sub-engines,
the incident engine's idiom — the controller invents NO new probes):
SLO burn-rate firings, circuit state + persist-spill growth, per-lane
throughput + queue depths, read staleness, snapshot write-stall p99 +
dispatch-gap p99, open incident id + ranked diagnosis.

Actuation policies (each bounded, hysteresis-guarded, logged):

  ============================  =========================================
  policy                        behaviour
  ============================  =========================================
  degradation_ladder            pressure (circuit open | spill growth |
                                slo burn | sustained queue growth) walks
                                the rung ladder one step at a time:
                                widen audit interval -> stretch snapshot
                                cadence -> pause temporal host passes ->
                                shed/spill at ingress; de-escalates after
                                ``clear_ticks`` clean ticks, dwell-time
                                minimum per rung, flap-limited.
  snapshot_cadence              single owner of ``snapshot_every``:
                                target = base x ladder x stall-mult /
                                staleness-div.
  lane_rescale                  sustained per-lane skew parks the
                                starved tail lanes; sustained queue
                                growth at reduced width re-opens them.
  watermark_adapt               late-drop growth widens the reorder
                                lateness budget (x1.5, capped at 8x
                                the configured value) and grows the
                                bucket ring (+25%, capped at 4x).
  dispatch_resize               dispatch-gap p99 above budget steps the
                                coalesce target DOWN the power-of-two
                                shape ladder; sustained health steps it
                                back up. Out-of-ladder shapes are
                                REFUSED by the knob layer; the
                                launch-shape tracker's zero-steady gate
                                backstops the contract.
  ============================  =========================================

Every actuation (refusals included) is a traced span plus a schema'd
JSONL record carrying the triggering conditions and the open incident
id, replayable via ``doctor --actuations``.

Departures from the JAX engine, which passes over any exception in its
registry reads, its breaker nudge, its span and log writes and its tick
loop:

* a gauge callback that raises ``LookupError`` (a torn-down owner)
  reads as no signal; any other exception (a failed card read of a
  health or audit gauge) leaves :meth:`ControlEngine.tick`, and the
  ``control-engine`` thread logs it as ``control tick failed`` at error
  level, as the SLO and incident engines do;
* a failed actuation-log write is logged at error level ("actuation log
  write failed") and counted in
  ``attendance_control_log_write_failures_total``; the tick goes on, so
  the knobs stay those of the rung the ladder is on;
* a frame whose spill file fails to decode on replay is parked as
  ``.poison`` by the pipeline's drain; any other exception there leaves
  the run (``pipeline/fast_path.py``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from attendance_tpu_torch.control.actuation import ActuationLog
from attendance_tpu_torch.control.knobs import Knob, KnobBoard
from attendance_tpu_torch.control.ladder import RUNGS, DegradationLadder
from attendance_tpu_torch.obs.registry import quantile_from_buckets
from attendance_tpu_torch.utils.integrity import (
    IntegrityError, unwrap_record, wrap_record)

logger = logging.getLogger(__name__)

# Rung -> the action id recorded for its characteristic knob move
# (mirrors the incident diagnosis ``action`` ids).
_RUNG_ACTIONS = {
    1: "widen_audit",
    2: "stretch_snapshot_cadence",
    3: "pause_temporal",
    4: "shed_ingress",
}

# Diagnosis actions that are advisory — no knob exists for them by
# design (shape pinning is a standing gate, rebalance is not a knob,
# quarantine already happened by the time wire rot is diagnosed).
ADVISORY_ACTIONS = frozenset(
    {"pin_shapes", "defer_rebalance", "quarantine_only"})


class IngressAdmission:
    """The producer-facing admission valve.

    ``mode`` is flipped by the controller tick thread; ``admit`` runs on
    the pipeline's dispatch thread only (so spill sequencing needs no
    lock). In ``spill`` mode the raw frame bytes are written durably
    (checksummed + fsync'd, ``utils/integrity.wrap_record``, the JAX
    package's bytes) BEFORE the caller acks — durability is what
    justifies the ack. In ``shed`` mode the frame is nacked back to the
    broker: retention is the backpressure. Spilled frames drain through
    the normal frame path on the dispatch thread once pressure clears,
    and their files are retired only after the next durable snapshot
    covers them.
    """

    def __init__(self, spill_dir: str = "", registry=None):
        self.mode = "pass"
        self.spill_dir: Optional[Path] = None
        self._pending: List[Path] = []
        self._seq = 0
        if spill_dir:
            self.spill_dir = Path(spill_dir)
            self.spill_dir.mkdir(parents=True, exist_ok=True)
            # Adopt frames a previous (crashed mid-drain) process left:
            # they were acked against this durability, so they MUST
            # replay before this run's traffic.
            self._pending = sorted(self.spill_dir.glob("ingress-*.bin"))
            self._seq = max((int(p.stem.split("-")[1])
                             for p in self._pending), default=0)
        self.spilled_total = 0
        self.shed_total = 0
        self.drained_total = 0
        self.corrupt_total = 0
        self._c_spill = self._c_shed = None
        if registry is not None:
            self._c_spill = registry.counter(
                "attendance_control_spilled_frames_total",
                help="Ingress frames durably spilled by admission "
                     "control (acked against spill durability).")
            self._c_shed = registry.counter(
                "attendance_control_shed_frames_total",
                help="Ingress frames nacked back to the broker by "
                     "admission control.")
            registry.gauge(
                "attendance_control_spill_pending",
                help="Ingress spill files awaiting drain.",
            ).set_function(lambda: float(len(self._pending)))

    @property
    def active(self) -> bool:
        return self.mode != "pass"

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def admit(self, data: bytes) -> str:
        """-> "pass" | "spill" (caller acks) | "shed" (caller nacks)."""
        mode = self.mode
        if mode == "spill" and self.spill_dir is not None:
            self._seq += 1
            path = self.spill_dir / f"ingress-{self._seq:06d}.bin"
            try:
                with open(path, "wb") as f:
                    f.write(wrap_record(bytes(data)))
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                # Spill disk sick: fall back to shed — the frame stays
                # in the broker, never acked, so nothing is lost.
                logger.exception("ingress spill write failed; shedding "
                                 "the frame back to the broker")
                path.unlink(missing_ok=True)
                self.shed_total += 1
                if self._c_shed is not None:
                    self._c_shed.inc()
                return "shed"
            self._pending.append(path)
            self.spilled_total += 1
            if self._c_spill is not None:
                self._c_spill.inc()
            return "spill"
        if mode != "pass":
            self.shed_total += 1
            if self._c_shed is not None:
                self._c_shed.inc()
            return "shed"
        return "pass"

    def drain_batch(self, limit: int = 16
                    ) -> List[Tuple[Path, bytes]]:
        """Pop up to ``limit`` spilled frames IN ORDER for replay on the
        dispatch thread. Files are NOT deleted here — the caller
        retires them after a durable snapshot covers the replayed
        events (crash in between = re-adoption + at-least-once replay,
        the same contract broker redelivery already imposes). A torn or
        rotted record is renamed ``.bad`` and skipped."""
        out: List[Tuple[Path, bytes]] = []
        while self._pending and len(out) < limit:
            path = self._pending.pop(0)
            try:
                payload, _verified = unwrap_record(path.read_bytes())
            except (OSError, IntegrityError):
                self.corrupt_total += 1
                try:
                    path.rename(path.with_suffix(".bad"))
                except OSError:
                    logger.exception("could not set aside torn spill "
                                     "record %s", path)
                continue
            out.append((path, payload))
        self.drained_total += len(out)
        return out

    @staticmethod
    def retire(paths: List[Path]) -> None:
        for p in paths:
            p.unlink(missing_ok=True)


class ControlEngine:
    """Tick-driven controller (daemon thread ``control-engine``, the
    incident engine's lifecycle shape)."""

    def __init__(self, telemetry, log_path: str, *,
                 spill_dir: str = "",
                 dwell_s: float = 2.0,
                 escalate_ticks: int = 2,
                 clear_ticks: int = 3,
                 flap_limit: int = 8,
                 interval_s: float = 1.0,
                 stall_p99_budget_s: float = 0.5,
                 staleness_ceiling_s: float = 5.0,
                 dispatch_gap_budget_s: float = 0.25,
                 queue_growth_ticks: int = 2,
                 _clock=time.monotonic):
        self._t = telemetry
        self.log = ActuationLog(log_path) if log_path else None
        self.admission = IngressAdmission(spill_dir, telemetry.registry)
        self.board = KnobBoard()
        self.ladder = DegradationLadder(
            dwell_s=dwell_s, escalate_ticks=escalate_ticks,
            clear_ticks=clear_ticks, flap_limit=flap_limit, clock=_clock)
        self.dwell_s = float(dwell_s)
        self.clear_ticks = int(clear_ticks)
        self.interval_s = float(interval_s)
        self.stall_p99_budget_s = float(stall_p99_budget_s)
        self.staleness_ceiling_s = float(staleness_ceiling_s)
        self.dispatch_gap_budget_s = float(dispatch_gap_budget_s)
        self.queue_growth_ticks = int(queue_growth_ticks)
        self._clock = _clock
        self._pipe = None
        self._base: Dict[str, Any] = {}
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()
        # Signal state (the incident engine's delta bookkeeping).
        self._prev_counters: Dict[str, float] = {}
        self._prev_hist: Dict[str, Tuple[list, float]] = {}
        self._queue_prev: Optional[float] = None
        self._queue_rising = 0
        self._stall_mult = 1
        self._stall_clean = 0
        self._stale_div = 1
        self._stale_clean = 0
        self._gap_breach = 0
        self._gap_clean = 0
        self._skew_streak = 0
        self._knob_last: Dict[str, float] = {}
        self.actuations_total = 0
        self.ticks_total = 0
        self.log_failures_total = 0
        reg = telemetry.registry
        self._g_rung = reg.gauge(
            "attendance_control_rung",
            help="Degraded-mode rung (0 normal .. 4 shed) — the gauge "
                 "serving reads so it never silently lies.")
        self._g_rung.set(0.0)
        self._g_pressure = reg.gauge(
            "attendance_control_pressure",
            help="1 while the controller's pressure predicate holds.")
        self._g_pressure.set(0.0)
        self._c_flap = reg.counter(
            "attendance_control_flap_holds_total",
            help="Ladder transitions suppressed by the flap limit.")
        self._c_act: Dict[str, Any] = {}
        self._c_ref: Dict[str, Any] = {}

    # -- attachment ----------------------------------------------------------
    def attach(self, pipe) -> None:
        """Bind knobs to a live pipeline. Which knobs exist depends on
        what the pipeline actually runs (striped lanes, temporal plane);
        policies check the board rather than assuming. The knobs are
        plain attribute stores the run loop reads."""
        with self._lock:
            self._pipe = pipe
            board = self.board = KnobBoard()
            base = self._base = {}

            base["audit_every"] = int(getattr(pipe, "_audit_every", 1))
            board.add(Knob(
                "audit_every",
                lambda: pipe._audit_every,
                lambda v: setattr(pipe, "_audit_every", int(v)),
                lo=1, hi=64))

            base["snapshot_every"] = int(getattr(pipe, "_snap_every", 0))
            if base["snapshot_every"] > 0:
                board.add(Knob(
                    "snapshot_every",
                    lambda: pipe._snap_every,
                    lambda v: setattr(pipe, "_snap_every", int(v)),
                    lo=max(1, base["snapshot_every"] // 4),
                    hi=base["snapshot_every"] * 8))

            if getattr(pipe, "_temporal", None) is not None:
                board.add(Knob(
                    "temporal_pause",
                    lambda: int(pipe._temporal_paused),
                    lambda v: setattr(pipe, "_temporal_paused",
                                      bool(v)),
                    ladder=(0, 1)))
                plane = pipe._temporal
                reorder = getattr(plane, "reorder", None)
                if reorder is not None:
                    base["lateness_us"] = int(reorder.lateness_us)
                    # Setter routes through the plane's grow-only
                    # contract; the knob's lo bound says the same.
                    board.add(Knob(
                        "lateness_us",
                        lambda: reorder.lateness_us,
                        plane.widen_lateness,
                        lo=base["lateness_us"],
                        hi=max(base["lateness_us"] * 8, 1)))
                ring = getattr(plane, "ring", None)
                if ring is not None:
                    base["ring_capacity"] = int(ring.capacity)
                    board.add(Knob(
                        "ring_capacity",
                        lambda: ring.capacity,
                        plane.grow_ring,
                        lo=base["ring_capacity"],
                        hi=base["ring_capacity"] * 4))

            modes = ["pass", "shed"]
            if self.admission.spill_dir is not None:
                modes.insert(1, "spill")
            board.add(Knob(
                "admission_mode",
                lambda: self.admission.mode,
                lambda v: setattr(self.admission, "mode", str(v)),
                ladder=tuple(modes)))

            consumer = getattr(pipe, "consumer", None)
            if hasattr(consumer, "set_active_lanes"):
                nlanes = len(getattr(consumer, "lanes", ()) or ())
                if nlanes >= 2:
                    base["active_lanes"] = nlanes
                    board.add(Knob(
                        "active_lanes",
                        lambda: consumer.active_lanes,
                        consumer.set_active_lanes,
                        lo=1, hi=nlanes))
            if hasattr(consumer, "set_dispatch_size"):
                # The shape ladder: the power-of-two pads from 256 up to
                # the configured coalesce size, the launch shapes a warm
                # run of coalesced lane blocks has already seen
                # (``models.fused.padded_lanes``).
                top = 256
                want = int(getattr(consumer, "_dispatch_size", top))
                while top < want:
                    top *= 2
                shapes, s = [], 256
                while s <= top:
                    shapes.append(s)
                    s *= 2
                base["dispatch_size"] = want
                board.add(Knob(
                    "dispatch_size",
                    lambda: consumer._dispatch_size,
                    consumer.set_dispatch_size,
                    ladder=tuple(shapes), shape_safe=True))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="control-engine", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # The pipeline goes on; the failure is a log record, not
                # a quiet tick.
                logger.exception("control tick failed")

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if self.log is not None:
            self.log.close()

    # -- registry access (incident-engine idiom) -----------------------------
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
        kind_members = fams.get(name)
        if kind_members is None or kind_members[0] != "histogram":
            return None
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

    # -- signal evaluation ---------------------------------------------------
    def _signals(self) -> Dict[str, Any]:
        fams = self._families()
        sig: Dict[str, Any] = {"conditions": []}

        # Only fully-OPEN (1.0) is pressure. HALF_OPEN (2.0) means a
        # probe is permitted — treating it as pressure would wedge the
        # ladder at shed once admission stops the insert flow (no
        # inserts -> no probes -> the gauge never closes). Instead the
        # controller nudges the breaker once its cooldown elapsed: the
        # move to half-open clears the pressure, the ladder
        # de-escalates, admission reopens, and the next real insert is
        # the probe that closes (healed) or re-opens (still sick).
        open_sinks = [labels.get("sink", "?") for labels, v in
                      self._gauge_values(fams, "attendance_circuit_state")
                      if v == 1.0]
        if open_sinks:
            breaker = getattr(getattr(self._pipe, "store", None),
                              "breaker", None)
            if breaker is not None:
                breaker.allow()  # open -> half-open iff cooled down
            if getattr(breaker, "state", "open") != "half_open":
                sig["conditions"].append("circuit_open")

        spill = self._counter_delta(
            fams, "attendance_persist_spilled_batches_total")
        if spill is not None and spill > 0:
            sig["conditions"].append("spill_growth")

        firing: List[str] = []
        slo = getattr(self._t, "slo", None)
        if slo is not None:
            firing = [n for n, st in slo._state.items() if st.firing]
        if not firing:
            firing = [labels.get("slo", "?") for labels, v in
                      self._gauge_values(fams, "attendance_slo_firing")
                      if v > 0.0]
        if firing:
            sig["conditions"].append("slo_burn")

        depth = 0.0
        seen_depth = False
        for metric in ("attendance_ingress_lane_queue_depth",
                       "attendance_queue_depth"):
            for _labels, v in self._gauge_values(fams, metric):
                depth += v
                seen_depth = True
        if seen_depth:
            if self._queue_prev is not None and depth > self._queue_prev:
                self._queue_rising += 1
            elif self._queue_prev is not None and depth < self._queue_prev:
                self._queue_rising = 0
            self._queue_prev = depth
            if (self._queue_rising >= self.queue_growth_ticks
                    and depth >= 4):
                sig["conditions"].append("queue_growth")
        sig["queue_depth"] = depth

        sig["stall_p99"] = None
        # stage-labelled histogram: scope to the snapshot_blocked stage
        fam = fams.get("attendance_stage_latency_seconds")
        if fam is not None:
            for m in fam[1]:
                if dict(m.labels).get("stage") != "snapshot_blocked":
                    continue
                buckets, _tot, count = m.snapshot()
                key = "_snapstall"
                prev = self._prev_hist.get(key)
                self._prev_hist[key] = (list(buckets), count)
                if prev is None:
                    continue
                delta = [max(0, b - p)
                         for b, p in zip(buckets, prev[0])]
                dcount = count - prev[1]
                if dcount > 0:
                    sig["stall_p99"] = quantile_from_buckets(
                        delta, dcount, 0.99, m.scale)

        vals = [v for _l, v in self._gauge_values(
            fams, "attendance_read_staleness_seconds")]
        sig["staleness"] = max(vals) if vals else None

        # late events are outcome-labelled; scope the delta to dropped
        fam = fams.get("attendance_late_events_total")
        dropped = None
        if fam is not None:
            cur = float(sum(m.value for m in fam[1]
                            if dict(m.labels).get("outcome") == "dropped"))
            prev = self._prev_counters.get("_late_dropped")
            self._prev_counters["_late_dropped"] = cur
            if prev is not None:
                dropped = cur - prev
        if dropped is not None and dropped > 0:
            sig["conditions"].append("late_drops")
        sig["late_dropped"] = dropped

        gap = self._hist_p99_delta(
            fams, "attendance_dispatch_gap_seconds")
        sig["dispatch_gap_p99"] = gap

        lane_fam = fams.get("attendance_ingress_lane_events_total")
        deltas: Dict[str, float] = {}
        if lane_fam is not None:
            for m in lane_fam[1]:
                lane = dict(m.labels).get("lane", "?")
                cur = float(m.value)
                prev = self._prev_counters.get(f"_ctl_lane_{lane}")
                self._prev_counters[f"_ctl_lane_{lane}"] = cur
                if prev is not None:
                    deltas[lane] = cur - prev
        sig["lane_deltas"] = deltas

        inc = None
        incidents = getattr(self._t, "incidents", None)
        if incidents is not None:
            inc = getattr(incidents, "_open", None)
        sig["incident"] = getattr(inc, "id", None)
        sig["incident_action"] = None
        if inc is not None and getattr(inc, "diagnosis", None):
            top = inc.diagnosis[0]
            sig["incident_action"] = top.get("action")
        return sig

    # -- actuation plumbing --------------------------------------------------
    def _write_log(self, **fields) -> Optional[Dict[str, Any]]:
        """One actuation record; a failed write is logged and counted,
        never passed over (the knob has moved either way)."""
        try:
            return self.log.record(**fields)
        except OSError:
            self.log_failures_total += 1
            self._t.registry.counter(
                "attendance_control_log_write_failures_total",
                help="Actuation records the control plane could not "
                     "write to its log (the knob moved anyway).").inc()
            logger.exception("actuation log write failed")
            return None

    def _record(self, proposal, *, policy: str, action: str,
                direction: str, conditions: List[str],
                incident: Optional[str]) -> Optional[Dict[str, Any]]:
        """Count, trace, and log one knob proposal's outcome."""
        if proposal is None or proposal.outcome == "noop":
            return None
        name = proposal.knob
        if proposal.outcome == "refused":
            c = self._c_ref.get(name)
            if c is None:
                c = self._c_ref[name] = self._t.registry.counter(
                    "attendance_control_refused_total",
                    help="Actuation proposals refused by knob safety "
                         "envelopes (out-of-ladder shapes).",
                    knob=name)
            c.inc()
        else:
            c = self._c_act.get(name)
            if c is None:
                c = self._c_act[name] = self._t.registry.counter(
                    "attendance_control_actuations_total",
                    help="Applied knob actuations.", knob=name)
            c.inc()
            self.actuations_total += 1
        tr = getattr(self._t, "tracer", None)
        if tr is not None:
            now = tr.now()
            tr.add_span("actuation", now, now,
                        trace_id=tr.new_id(), role="control",
                        args={"knob": name,
                              "from": proposal.previous,
                              "to": proposal.applied,
                              "outcome": proposal.outcome,
                              "policy": policy, "action": action,
                              "rung": self.ladder.rung})
        doc = None
        if self.log is not None:
            doc = self._write_log(
                knob=name, frm=proposal.previous,
                to=proposal.applied, outcome=proposal.outcome,
                policy=policy, action=action, direction=direction,
                rung=self.ladder.rung, conditions=conditions,
                incident=incident, requested=proposal.requested)
        if proposal.changed:
            self._knob_last[name] = self._clock()
        return doc

    def _cooled(self, knob: str) -> bool:
        last = self._knob_last.get(knob)
        return last is None or self._clock() - last >= self.dwell_s

    # -- rung application ----------------------------------------------------
    def _snapshot_target(self) -> Optional[int]:
        base = self._base.get("snapshot_every")
        if not base:
            return None
        mult = 4 if self.ladder.rung >= 2 else 1
        mult = max(mult, self._stall_mult)
        target = (base * mult) // self._stale_div
        return max(1, target)

    def _apply_rung(self, conditions: List[str],
                    incident: Optional[str], direction: str) -> None:
        rung = self.ladder.rung
        # The synthetic rung record: every transition is visible even
        # when a rung's knob is absent in this deployment.
        if self.log is not None:
            self._write_log(
                knob="ladder.rung", frm=RUNGS[rung - 1]
                if direction == "escalate" else RUNGS[rung + 1],
                to=RUNGS[rung], outcome="applied",
                policy="degradation_ladder",
                action=_RUNG_ACTIONS.get(
                    rung if direction == "escalate" else rung + 1,
                    "restore"),
                direction=direction, rung=rung,
                conditions=conditions, incident=incident)
        targets: List[Tuple[str, Any, str]] = []
        base_audit = self._base.get("audit_every", 1)
        targets.append(("audit_every",
                        8 if rung >= 1 else base_audit, "widen_audit"))
        snap = self._snapshot_target()
        if snap is not None:
            targets.append(("snapshot_every", snap,
                            "stretch_snapshot_cadence"))
        if "temporal_pause" in self.board:
            targets.append(("temporal_pause",
                            1 if rung >= 3 else 0, "pause_temporal"))
        if rung >= 4:
            mode = ("spill" if self.admission.spill_dir is not None
                    else "shed")
        else:
            mode = "pass"
        targets.append(("admission_mode", mode, "shed_ingress"))
        for name, value, act in targets:
            knob = self.board.get(name)
            if knob is None or knob.value == value:
                continue
            self._record(knob.propose(value), policy="degradation_ladder",
                         action=act, direction=direction,
                         conditions=conditions, incident=incident)

    # -- the tick ------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        if now is None:
            now = self._clock()
        with self._lock:
            self.ticks_total += 1
            if self._pipe is None:
                return []
            sig = self._signals()
            conditions: List[str] = sig["conditions"]
            incident = sig["incident"]
            records: List[Dict[str, Any]] = []

            pressure = any(c in conditions for c in
                           ("circuit_open", "spill_growth", "slo_burn",
                            "queue_growth"))
            self._g_pressure.set(1.0 if pressure else 0.0)
            flap_before = self.ladder.flap_holds
            moved = self.ladder.tick(pressure, now)
            if self.ladder.flap_holds > flap_before:
                self._c_flap.inc(self.ladder.flap_holds - flap_before)
            if moved is not None:
                direction = ("escalate" if pressure else "de-escalate")
                self._apply_rung(conditions, incident, direction)
            self._g_rung.set(float(self.ladder.rung))

            # snapshot_cadence: single owner of the snapshot knob.
            stall = sig.get("stall_p99")
            if stall is not None and stall > self.stall_p99_budget_s:
                self._stall_clean = 0
                if self._stall_mult < 4:
                    self._stall_mult *= 2
            elif self._stall_mult > 1:
                self._stall_clean += 1
                if self._stall_clean >= self.clear_ticks:
                    self._stall_mult //= 2
                    self._stall_clean = 0
            staleness = sig.get("staleness")
            if staleness is not None and staleness > self.staleness_ceiling_s:
                self._stale_clean = 0
                self._stale_div = 2
            elif self._stale_div > 1:
                self._stale_clean += 1
                if self._stale_clean >= self.clear_ticks:
                    self._stale_div = 1
                    self._stale_clean = 0
            snap_target = self._snapshot_target()
            knob = self.board.get("snapshot_every")
            if (snap_target is not None and knob is not None
                    and knob.value != snap_target
                    and self._cooled("snapshot_every")):
                action = ("tighten_snapshot_cadence"
                          if snap_target < knob.value
                          else "stretch_snapshot_cadence")
                conds = list(conditions)
                if stall is not None and stall > self.stall_p99_budget_s:
                    conds.append("snap_stall")
                if (staleness is not None
                        and staleness > self.staleness_ceiling_s):
                    conds.append("read_staleness")
                rec = self._record(
                    knob.propose(snap_target),
                    policy="snapshot_cadence", action=action,
                    direction="adapt", conditions=conds,
                    incident=incident)
                if rec:
                    records.append(rec)

            # lane_rescale: park starved tail lanes on sustained skew,
            # re-open width under sustained queue growth.
            knob = self.board.get("active_lanes")
            if knob is not None:
                deltas = sig.get("lane_deltas") or {}
                active = knob.value
                skew = False
                if len(deltas) >= 2 and active >= 2:
                    hi, lo = max(deltas.values()), min(deltas.values())
                    skew = hi > 16 and lo * 4 < hi
                self._skew_streak = self._skew_streak + 1 if skew else 0
                if (self._skew_streak >= 2
                        and self._cooled("active_lanes")):
                    rec = self._record(
                        knob.propose(active - 1),
                        policy="lane_rescale", action="rescale_lanes",
                        direction="adapt",
                        conditions=conditions + ["lane_skew"],
                        incident=incident)
                    if rec:
                        records.append(rec)
                    self._skew_streak = 0
                elif ("queue_growth" in conditions
                      and active < (self._base.get("active_lanes")
                                    or active)
                      and self._cooled("active_lanes")):
                    rec = self._record(
                        knob.propose(active + 1),
                        policy="lane_rescale", action="rescale_lanes",
                        direction="adapt", conditions=conditions,
                        incident=incident)
                    if rec:
                        records.append(rec)

            # watermark_adapt: late drops widen lateness + grow ring.
            if "late_drops" in conditions:
                knob = self.board.get("lateness_us")
                if knob is not None and self._cooled("lateness_us"):
                    rec = self._record(
                        knob.propose(int(knob.value * 3 // 2)),
                        policy="watermark_adapt",
                        action="widen_lateness", direction="adapt",
                        conditions=conditions, incident=incident)
                    if rec:
                        records.append(rec)
                knob = self.board.get("ring_capacity")
                if knob is not None and self._cooled("ring_capacity"):
                    grow = knob.value + max(knob.value // 4, 1)
                    rec = self._record(
                        knob.propose(grow),
                        policy="watermark_adapt", action="grow_ring",
                        direction="adapt", conditions=conditions,
                        incident=incident)
                    if rec:
                        records.append(rec)

            # dispatch_resize: walk the shape ladder only.
            knob = self.board.get("dispatch_size")
            if knob is not None:
                gap = sig.get("dispatch_gap_p99")
                if gap is not None and gap > self.dispatch_gap_budget_s:
                    self._gap_breach += 1
                    self._gap_clean = 0
                else:
                    self._gap_clean += 1
                    self._gap_breach = 0
                if (self._gap_breach >= 2
                        and self._cooled("dispatch_size")):
                    down = knob.step(-1)
                    if down is not None:
                        rec = self._record(
                            knob.propose(down),
                            policy="dispatch_resize",
                            action="resize_dispatch",
                            direction="adapt",
                            conditions=conditions + ["dispatch_gap"],
                            incident=incident)
                        if rec:
                            records.append(rec)
                    self._gap_breach = 0
                elif (self._gap_clean >= self.clear_ticks * 2
                      and knob.value < self._base.get(
                          "dispatch_size", knob.value)
                      and self._cooled("dispatch_size")):
                    up = knob.step(+1)
                    if up is not None:
                        rec = self._record(
                            knob.propose(up),
                            policy="dispatch_resize",
                            action="resize_dispatch",
                            direction="adapt", conditions=conditions,
                            incident=incident)
                        if rec:
                            records.append(rec)
                    self._gap_clean = 0
            return records
