"""SLO burn-rate engine + the offline ``doctor`` verdict.

Counterpart of ``attendance_tpu/obs/slo.py``: the same objectives,
window math, alert-log lines and verdict text, so either package's
``doctor`` reads either package's artifacts and prints the same table.

Turns the ROADMAP's acceptance targets into runtime-evaluated SLOs
(Beyer et al., *Site Reliability Engineering*, multi-window
multi-burn-rate alerting): each declarative objective is sampled every
tick, classified breach/ok, and aggregated over a FAST and a SLOW
window. Burn rate = breaching fraction / error budget; an alert FIRES
only when both windows burn past the firing threshold — the slow
window rejects single-window spikes, the fast window keeps detection
fresh — and CLEARS with hysteresis (fast burn must fall below half the
firing threshold), so a breach oscillating around the ceiling cannot
flap the alert.

Outputs:

* ``attendance_slo_burn_rate{slo=...,window=fast|slow}`` gauges and
  ``attendance_slo_firing{slo=...}`` 0/1 on the normal scrape surface;
* a structured JSONL alert log (``--alert-log``): one line per
  transition (firing/resolved) with value, threshold, both burns, and
  the most recent batch's trace id for cross-reference;
* a flight-recorder record per transition (``alert``/``state``
  fields), so a ring dump shows WHERE in the batch stream the SLO
  broke.

The ``doctor`` half replays run artifacts OFFLINE — a prom exposition
file, the alert log, a flight dump, a trace export — and prints a
pass/fail verdict table with a non-zero exit on breach: the artifacts
a run already writes become CI-gateable without rerunning anything.

One departure from the JAX engine. The accuracy SLOs read callback
gauges (``obs/health.py``, ``obs/audit.py``) that, on a pipeline with no
published read epoch, launch K4 and K1 on the card from this engine's
thread. Such a callback raises ``LookupError`` when its owner was torn
down, and that alone reads as "no signal" here; any other exception (a
failed card read) leaves :meth:`SloEngine.tick` and is logged as a
failed tick, where the JAX engine skips a callback that raises anything.
A fault on the card must not pass for a quiet NaN.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import re
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# Classic SRE page-tier burn threshold: with a 1% error budget, firing
# needs a sustained >=14.4% breaching fraction in BOTH windows.
DEFAULT_BUDGET = 0.01
DEFAULT_FIRE_BURN = 14.4
CLEAR_RATIO = 0.5  # hysteresis: clear only below half the fire burn

# Version stamped on every alert-log JSONL event and incident record so
# offline consumers can evolve; pre-17 logs have no field and readers
# tolerate that with a single warning.
ALERT_SCHEMA = 1

SLO_HELP = {
    "attendance_slo_burn_rate":
        "SLO burn rate (breaching fraction / error budget) per window",
    "attendance_slo_firing":
        "1 while the SLO's alert is firing, else 0",
    "attendance_slo_alerts_total":
        "Alert transitions to firing, per SLO",
}


@dataclasses.dataclass(frozen=True)
class Slo:
    """One declarative objective over the live registry.

    kind: ``gauge`` (max over the family's samples), ``counter``
    (total), ``rate`` (d(counter)/dt per tick), or ``quantile``
    (p-quantile of the tick interval's fresh histogram observations).
    ``op`` is the HEALTHY direction: ``<=`` is a ceiling, ``>=`` a
    floor; a tick breaches when the value violates it."""
    name: str
    kind: str
    metric: str
    op: str
    threshold: float
    # One (label, value) pair the metric's members must carry, e.g.
    # ("stage", "dequeue_wait"); () matches every member.
    label_filter: Tuple[str, ...] = ()
    quantile: float = 0.0


# The paper's acceptance targets (ROADMAP north star), always installed
# when the engine is on: measured — not estimated — accuracy ceilings,
# and the structural zero-false-negative invariant.
DEFAULT_SLOS = (
    Slo("bloom_measured_fpr", "gauge",
        "attendance_bloom_measured_fpr", "<=", 0.01),
    Slo("bloom_false_negatives", "counter",
        "attendance_bloom_false_negatives_total", "<=", 0.0),
    Slo("hll_measured_rel_error", "gauge",
        "attendance_hll_measured_rel_error", "<=", 0.02),
)

_STAGE_ALIAS = {"dequeue": "dequeue_wait", "device": "device_wait",
                "assembly": "batch_assembly"}
# Every stage name the pipelines actually time (grep `.stage("...")`).
# A quantile spec naming anything else would sit in the registry and
# never fire — reject it at parse (= config) time instead: a dead
# objective is worse than none, because a human (or the controller)
# believes it is being watched.
KNOWN_STAGES = frozenset({
    "dequeue_wait", "decode", "dispatch", "device_wait",
    "snapshot_write", "snapshot_blocked", "batch_assembly", "sketch",
    "persist", "query",
})
_QUANTILE_RE = re.compile(r"^([a-z_]+)_p(\d{1,2})$")


def parse_slo(spec: str) -> Slo:
    """Parse one ``--slo`` spec: ``alias<=value`` / ``alias>=value``.

    Aliases: ``fpr`` / ``false_negatives`` / ``hll_error`` (override
    the default ceilings), ``throughput`` (events/s rate floor), and
    ``<stage>_p<NN>`` latency-quantile ceilings over the stage
    histograms (``dequeue_p99``, ``device_p95``, ``sketch_p50``, ...;
    ``dequeue``/``device``/``assembly`` expand to their full stage
    names)."""
    for op in ("<=", ">="):
        if op in spec:
            alias, _, raw = spec.partition(op)
            alias = alias.strip()
            try:
                threshold = float(raw)
            except ValueError:
                raise ValueError(f"bad SLO threshold in {spec!r}")
            break
    else:
        raise ValueError(
            f"bad SLO spec {spec!r} (want alias<=value or alias>=value)")
    if alias == "fpr":
        return Slo("bloom_measured_fpr", "gauge",
                   "attendance_bloom_measured_fpr", op, threshold)
    if alias == "false_negatives":
        return Slo("bloom_false_negatives", "counter",
                   "attendance_bloom_false_negatives_total", op,
                   threshold)
    if alias == "hll_error":
        return Slo("hll_measured_rel_error", "gauge",
                   "attendance_hll_measured_rel_error", op, threshold)
    if alias == "throughput":
        return Slo("throughput", "rate", "attendance_events_total",
                   op, threshold)
    if alias == "read_staleness":
        # The query plane's freshness objective: the published read
        # epoch's age (bounded by the snapshot barrier cadence).
        return Slo("read_staleness", "gauge",
                   "attendance_read_staleness_seconds", op, threshold)
    if alias == "watermark_lag":
        # The temporal plane's freshness objective: how far the
        # watermark trails the stream head (event-time seconds).
        return Slo("watermark_lag", "gauge",
                   "attendance_watermark_lag_seconds", op, threshold)
    if alias == "snapshot_failures":
        # The PR-robustness hook: a bounded-backoff writer retrying a
        # failing disk is healthy; an unbounded failure COUNT is not.
        return Slo("snapshot_write_failures", "counter",
                   "attendance_snapshot_write_failures_total", op,
                   threshold)
    m = _QUANTILE_RE.match(alias)
    if m:
        stage = _STAGE_ALIAS.get(m.group(1), m.group(1))
        if stage not in KNOWN_STAGES:
            raise ValueError(
                f"unknown stage {stage!r} in SLO spec {spec!r} "
                f"(known stages: {', '.join(sorted(KNOWN_STAGES))})")
        return Slo(alias, "quantile",
                   "attendance_stage_latency_seconds", op, threshold,
                   label_filter=("stage", stage),
                   quantile=int(m.group(2)) / 100.0)
    raise ValueError(f"unknown SLO alias {alias!r} in {spec!r}")


def resolve_slos(specs: Sequence[str]) -> List[Slo]:
    """Defaults + user specs; a spec naming a default REPLACES it."""
    parsed = [parse_slo(s) for s in specs]
    names = {s.name for s in parsed}
    return [s for s in DEFAULT_SLOS if s.name not in names] + parsed


class _SloState:
    __slots__ = ("samples", "fast", "slow", "firing", "last_value",
                 "rate_prev", "hist_prev")

    def __init__(self, fast_gauge, slow_gauge):
        self.samples: List[Tuple[float, bool]] = []
        self.fast = fast_gauge
        self.slow = slow_gauge
        self.firing = False
        self.last_value = float("nan")
        self.rate_prev: Optional[Tuple[float, float]] = None
        self.hist_prev = None  # (buckets, count) at the previous tick


class SloEngine:
    """Tick-driven evaluator. Production runs it on a background
    thread (``start``/``stop``); tests drive :meth:`tick` directly
    with explicit timestamps — the window math is pure function of the
    sample times passed in."""

    def __init__(self, telemetry, specs: Sequence[str] = (),
                 fast_s: float = 60.0, slow_s: float = 300.0,
                 path: str = "", *, budget: float = DEFAULT_BUDGET,
                 fire_burn: float = DEFAULT_FIRE_BURN,
                 interval_s: float = 1.0, _clock=time.monotonic):
        self._telemetry = telemetry
        self.slos = resolve_slos(specs)
        self.fast_s = fast_s
        self.slow_s = slow_s
        self.path = path
        self.budget = budget
        self.fire_burn = fire_burn
        self.interval_s = interval_s
        self._clock = _clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = telemetry.registry
        self._alerts = {
            s.name: reg.counter(
                "attendance_slo_alerts_total",
                help=SLO_HELP["attendance_slo_alerts_total"],
                slo=s.name)
            for s in self.slos}
        self._firing_gauges = {
            s.name: reg.gauge("attendance_slo_firing",
                              help=SLO_HELP["attendance_slo_firing"],
                              slo=s.name)
            for s in self.slos}
        self._state: Dict[str, _SloState] = {
            s.name: _SloState(
                reg.gauge("attendance_slo_burn_rate",
                          help=SLO_HELP["attendance_slo_burn_rate"],
                          slo=s.name, window="fast"),
                reg.gauge("attendance_slo_burn_rate",
                          help=SLO_HELP["attendance_slo_burn_rate"],
                          slo=s.name, window="slow"))
            for s in self.slos}
        for g in self._firing_gauges.values():
            g.set(0.0)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SloEngine":
        if self.path:
            # Touch the log so a clean run still leaves the artifact
            # (doctor reads an empty file as "0 transitions" — a
            # MISSING file would be indistinguishable from a run that
            # never had the engine on).
            try:
                Path(self.path).parent.mkdir(parents=True,
                                             exist_ok=True)
                Path(self.path).touch()
            except Exception:
                logger.exception("alert log touch failed")
        self._thread = threading.Thread(target=self._loop,
                                        name="slo-engine", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception("SLO tick failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.finalize("engine-stop")

    def finalize(self, reason: str) -> None:
        """One last evaluation so short runs (shorter than a tick
        interval) still classify and any firing alert reaches the log
        before process exit."""
        try:
            self.tick()
        except Exception:
            logger.exception("SLO final tick failed (%s)", reason)

    # -- value extraction ----------------------------------------------------
    def _family(self, metric: str):
        for name, kind, help, members in (
                self._telemetry.registry.collect()):
            if name == metric:
                return members
        return []

    def _members(self, slo: Slo):
        members = self._family(slo.metric)
        if slo.label_filter:
            members = [m for m in members
                       if slo.label_filter in m.labels]
        return members

    def _value(self, slo: Slo, now: float, st: _SloState) -> float:
        members = self._members(slo)
        if slo.kind == "gauge":
            vals = []
            for m in members:
                try:
                    v = float(m.read())
                except LookupError:
                    # A torn-down owner is "no signal", not 0.0; any
                    # other failure (a card read) propagates.
                    continue
                if not math.isnan(v):
                    vals.append(v)
            return max(vals) if vals else float("nan")
        if slo.kind == "counter":
            return float(sum(m.value for m in members)) \
                if members else float("nan")
        if slo.kind == "rate":
            total = float(sum(m.value for m in members)) \
                if members else 0.0
            prev = st.rate_prev
            st.rate_prev = (now, total)
            if prev is None or now <= prev[0]:
                return float("nan")
            return (total - prev[1]) / (now - prev[0])
        if slo.kind == "quantile":
            from attendance_tpu_torch.obs.registry import (
                quantile_from_buckets)
            if not members:
                return float("nan")
            h = members[0]
            buckets, _, count = h.snapshot()
            prev = st.hist_prev
            st.hist_prev = (buckets, count)
            if prev is None:
                return float("nan")
            db = [b - p for b, p in zip(buckets, prev[0])]
            dc = count - prev[1]
            if dc <= 0:
                return float("nan")  # no fresh observations this tick
            return quantile_from_buckets(db, dc, slo.quantile, h.scale)
        raise ValueError(f"unknown SLO kind {slo.kind!r}")

    @staticmethod
    def _breaches(slo: Slo, value: float) -> bool:
        if math.isnan(value):
            return False  # no signal is not a breach
        if slo.op == "<=":
            return value > slo.threshold
        return value < slo.threshold

    # -- window math ---------------------------------------------------------
    def _burn(self, samples: List[Tuple[float, bool]], now: float,
              window_s: float) -> float:
        """Breaching fraction over the window / error budget. The
        denominator is the window's EXPECTED sample count (window /
        tick interval), not just the samples seen so far: dividing by
        a near-empty window would let the very first breaching tick
        claim a 100%-breach window and fire instantly — exactly the
        single-tick spike the slow window exists to reject. Until a
        window has filled once, missing ticks count as healthy."""
        inside = [b for t, b in samples if t > now - window_s]
        if not inside:
            return 0.0
        expected = max(1, math.ceil(window_s / self.interval_s))
        return (sum(inside) / max(len(inside), expected)) / self.budget

    def tick(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            for slo in self.slos:
                st = self._state[slo.name]
                value = self._value(slo, now, st)
                st.last_value = value
                st.samples.append((now, self._breaches(slo, value)))
                cutoff = now - self.slow_s
                while st.samples and st.samples[0][0] <= cutoff:
                    st.samples.pop(0)
                burn_fast = self._burn(st.samples, now, self.fast_s)
                burn_slow = self._burn(st.samples, now, self.slow_s)
                st.fast.set(burn_fast)
                st.slow.set(burn_slow)
                if (not st.firing and burn_fast >= self.fire_burn
                        and burn_slow >= self.fire_burn):
                    st.firing = True
                    self._alerts[slo.name].inc()
                    self._firing_gauges[slo.name].set(1.0)
                    self._emit(slo, st, "firing", burn_fast, burn_slow)
                elif (st.firing
                      and burn_fast < self.fire_burn * CLEAR_RATIO):
                    st.firing = False
                    self._firing_gauges[slo.name].set(0.0)
                    self._emit(slo, st, "resolved", burn_fast,
                               burn_slow)

    # -- alert emission ------------------------------------------------------
    def _last_trace(self) -> str:
        """Trace id of the most recent flight-recorder batch record —
        the cross-reference from an SLO transition into the span tree
        (empty when no recorder/tracing is live)."""
        flight = getattr(self._telemetry, "flight", None)
        if flight is None:
            return ""
        records = flight.snapshot()
        for rec in reversed(records):
            t = rec.get("trace") if isinstance(rec, dict) else None
            if t:
                return str(t)
        return ""

    def _emit(self, slo: Slo, st: _SloState, state: str,
              burn_fast: float, burn_slow: float) -> None:
        trace = self._last_trace()
        value = st.last_value
        event = {
            "schema": ALERT_SCHEMA,
            "ts": round(time.time(), 3),
            "slo": slo.name,
            "state": state,
            "metric": slo.metric,
            "op": slo.op,
            "threshold": slo.threshold,
            "value": None if math.isnan(value) else round(value, 6),
            "burn_fast": round(burn_fast, 3),
            "burn_slow": round(burn_slow, 3),
            "window_fast_s": self.fast_s,
            "window_slow_s": self.slow_s,
        }
        if trace:
            event["trace"] = trace
        logger.warning("SLO %s %s (value=%s threshold=%s%s burn "
                       "fast=%.1f slow=%.1f)", slo.name, state.upper(),
                       event["value"], slo.op, slo.threshold,
                       burn_fast, burn_slow)
        if self.path:
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(event) + "\n")
            except Exception:
                logger.exception("alert log append failed")
        # Flag the transition in the flight ring: a dump then shows the
        # alert inline with the batch records around it, trace id
        # attached for the jump into the Perfetto tree.
        rec = {"ts": event["ts"], "alert": slo.name, "state": state}
        if trace:
            rec["trace"] = trace
        self._telemetry.record_batch(**rec)


# ---------------------------------------------------------------------------
# doctor: offline artifact replay -> verdict table + exit code
# ---------------------------------------------------------------------------

def _classify(path: str) -> Tuple[str, object]:
    """Sniff one artifact: ('prom', text) | ('alerts', [events]) |
    ('flight', doc) | ('trace', doc)."""
    text = Path(path).read_text()
    stripped = text.lstrip()
    if not stripped:
        # An empty file is a clean run's alert log (the engine touches
        # it at start so "no transitions" and "engine never ran" stay
        # distinguishable artifacts).
        return "alerts", []
    if not stripped.startswith("{"):
        return "prom", text
    try:
        doc = json.loads(text)
        if "traceEvents" in doc:
            return "trace", doc
        if "slo" in doc and "state" in doc:
            # A one-transition alert log is a single valid JSON object
            # — the event signature, not the document shape, decides.
            return "alerts", [doc]
        return "flight", doc
    except json.JSONDecodeError:
        events = []
        for line in stripped.splitlines():
            line = line.strip()
            if line:
                events.append(json.loads(line))
        if not all(isinstance(e, dict) and "slo" in e for e in events):
            raise ValueError(f"unrecognized artifact {path!r}")
        return "alerts", events


def _fmt_value(v: Optional[float]) -> str:
    if v is None:
        return "n/a"
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        # A quantile past the last finite bucket bound renders as the
        # exposition spelling (int() on it would raise).
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


def _prom_checks(text: str, fpr_ceiling: float,
                 hll_error_ceiling: float,
                 fire_burn: float,
                 snapshot_stall_ceiling: Optional[float],
                 max_reconnects: Optional[int] = None,
                 lane_skew_ceiling: Optional[float] = None,
                 query_p99_ceiling: Optional[float] = None,
                 staleness_ceiling: Optional[float] = None,
                 merge_lag_ceiling: Optional[float] = None,
                 watermark_lag_ceiling: Optional[float] = None,
                 recompile_ceiling: Optional[int] = None
                 ) -> List[List[str]]:
    from attendance_tpu_torch.obs.exposition import parse_prom

    samples = parse_prom(text)

    def _vals(metric: str, label_part: str = "") -> List[float]:
        out = []
        for name, labels, value in samples:
            if name == metric and label_part in labels:
                try:
                    v = float(value)
                except ValueError:
                    continue
                if not math.isnan(v):
                    out.append(v)
        return out

    rows: List[List[str]] = []

    def ceiling(check: str, metric: str, limit: float) -> None:
        vals = _vals(metric)
        if not vals:
            rows.append([check, "n/a", f"<= {_fmt_value(limit)}",
                         "n/a"])
            return
        worst = max(vals)
        rows.append([check, _fmt_value(worst),
                     f"<= {_fmt_value(limit)}",
                     "PASS" if worst <= limit else "FAIL"])

    ceiling("bloom measured FPR", "attendance_bloom_measured_fpr",
            fpr_ceiling)
    fn = _vals("attendance_bloom_false_negatives_total")
    rows.append(["bloom false negatives",
                 _fmt_value(max(fn) if fn else None), "== 0",
                 "n/a" if not fn
                 else ("PASS" if max(fn) == 0 else "FAIL")])
    ceiling("HLL measured rel error",
            "attendance_hll_measured_rel_error", hll_error_ceiling)
    # Estimator drift: measurement vs the fill^k model, informational
    # (a large drift means the estimator is lying, not that the run
    # breached — the measured ceiling above is the gate).
    measured = _vals("attendance_bloom_measured_fpr")
    estimated = _vals("attendance_bloom_estimated_fpr")
    if measured and estimated:
        drift = abs(max(measured) - max(estimated))
        rows.append(["FPR estimator drift", _fmt_value(drift), "-",
                     "info"])
    # Snapshot stall ceiling: p99 of each snapshot stage histogram
    # (write = one background write's wall, blocked = hot-loop waits
    # on a full staging queue), recovered from the scraped cumulative
    # buckets. Informational without a ceiling; a gate with one.
    from attendance_tpu_torch.obs.exposition import (
        _parse_le, quantiles_from_cumulative)

    for stage in ("snapshot_write", "snapshot_blocked"):
        pairs = []
        for name, labels, value in samples:
            if (name == "attendance_stage_latency_seconds_bucket"
                    and f'stage="{stage}"' in labels):
                le = _parse_le(labels)
                if le is not None:
                    try:
                        pairs.append((le, float(value)))
                    except ValueError:
                        continue
        if not pairs or max(c for _, c in pairs) == 0:
            continue  # run never snapshotted: nothing to judge
        (p99,) = quantiles_from_cumulative(pairs, (0.99,))
        if snapshot_stall_ceiling is None:
            rows.append([f"{stage} p99", _fmt_value(p99), "-", "info"])
        else:
            rows.append([f"{stage} p99", _fmt_value(p99),
                         f"<= {_fmt_value(snapshot_stall_ceiling)}",
                         "PASS" if p99 <= snapshot_stall_ceiling
                         else "FAIL"])
    # Query plane: the read-path latency quantile (stage="query"
    # histogram, same recovery as the snapshot stalls above), read-path
    # accuracy (its own measured gauges, beside the write path's), and
    # epoch staleness. Informational without ceilings; gates with them.
    qpairs = []
    for name, labels, value in samples:
        if (name == "attendance_stage_latency_seconds_bucket"
                and 'stage="query"' in labels):
            le = _parse_le(labels)
            if le is not None:
                try:
                    qpairs.append((le, float(value)))
                except ValueError:
                    continue
    if qpairs and max(c for _, c in qpairs) > 0:
        (p99,) = quantiles_from_cumulative(qpairs, (0.99,))
        if query_p99_ceiling is None:
            rows.append(["query p99", _fmt_value(p99), "-", "info"])
        else:
            rows.append(["query p99", _fmt_value(p99),
                         f"<= {_fmt_value(query_p99_ceiling)}",
                         "PASS" if p99 <= query_p99_ceiling
                         else "FAIL"])
    qfn = _vals("attendance_query_false_negatives_total")
    if qfn:
        worst = max(qfn)
        rows.append(["query-path false negatives", _fmt_value(worst),
                     "== 0", "PASS" if worst == 0 else "FAIL"])
    qfpr = _vals("attendance_query_measured_fpr")
    if qfpr:
        rows.append(["query-path measured FPR",
                     _fmt_value(max(qfpr)),
                     f"<= {_fmt_value(fpr_ceiling)}",
                     "PASS" if max(qfpr) <= fpr_ceiling else "FAIL"])
    qerr = _vals("attendance_query_hll_rel_error")
    if qerr:
        rows.append(["query-path HLL rel error",
                     _fmt_value(max(qerr)),
                     f"<= {_fmt_value(hll_error_ceiling)}",
                     "PASS" if max(qerr) <= hll_error_ceiling
                     else "FAIL"])
    # Federation plane: fence->fold merge lag (gated by
    # --merge-lag-ceiling; informational without), peer liveness at
    # the last scrape, and fold/staleness counters. Peers-down is an
    # informational row, not a gate: a worker that exited cleanly
    # after its final fence looks "down" to an aggregator that
    # outlives it by the silence budget, which is the normal teardown
    # order — the soak gates takeover by its own invariants instead.
    fpairs = []
    for name, labels, value in samples:
        if name == "attendance_fed_merge_lag_seconds_bucket":
            le = _parse_le(labels)
            if le is not None:
                try:
                    fpairs.append((le, float(value)))
                except ValueError:
                    continue
    has_lag = bool(fpairs) and max(c for _, c in fpairs) > 0
    if has_lag and merge_lag_ceiling is None:
        (p99,) = quantiles_from_cumulative(fpairs, (0.99,))
        rows.append(["fed merge lag p99", _fmt_value(p99), "-",
                     "info"])
    elif merge_lag_ceiling is not None:
        # The ceiling is only ever set for runs that gossiped: an
        # absent/empty histogram means the aggregator never folded a
        # fence, so the gate must FAIL loudly, not pass vacuously.
        p99 = (quantiles_from_cumulative(fpairs, (0.99,))[0]
               if has_lag else None)
        rows.append(["fed merge lag p99", _fmt_value(p99),
                     f"<= {_fmt_value(merge_lag_ceiling)}",
                     "FAIL" if p99 is None or p99 > merge_lag_ceiling
                     else "PASS"])
    peers = [(labels, float(v)) for name, labels, v in samples
             if name == "attendance_fed_peer_up"]
    if peers:
        up = sum(1 for _, v in peers if v >= 1.0)
        rows.append(["fed peers up at last scrape",
                     f"{up}/{len(peers)}", "-", "info"])
    merged = _vals("attendance_fed_merged_deltas_total")
    if merged:
        rows.append(["fed merged frames", _fmt_value(max(merged)),
                     "-", "info"])
    fstale = _vals("attendance_fed_stale_frames_total")
    if fstale and max(fstale) > 0:
        rows.append(["fed stale frames (counters ignored)",
                     _fmt_value(max(fstale)), "-", "info"])
    takeovers = _vals("attendance_fed_takeovers_total")
    if takeovers and max(takeovers) > 0:
        rows.append(["fed shard takeovers", _fmt_value(max(takeovers)),
                     "-", "info"])
    geom = _vals("attendance_fed_geometry_rejects_total")
    if geom and max(geom) > 0:
        # A misconfigured peer's frames were rejected: its shard is
        # missing from the merged view — always a failing verdict.
        rows.append(["fed geometry-rejected frames",
                     _fmt_value(max(geom)), "== 0", "FAIL"])
    stale = _vals("attendance_read_staleness_seconds")
    if stale or staleness_ceiling is not None:
        worst = max(stale) if stale else None
        if staleness_ceiling is None:
            rows.append(["read epoch staleness",
                         _fmt_value(worst), "-", "info"])
        else:
            rows.append(["read epoch staleness", _fmt_value(worst),
                         f"<= {_fmt_value(staleness_ceiling)}",
                         "n/a" if worst is None
                         else ("PASS" if worst <= staleness_ceiling
                               else "FAIL")])
    chain = _vals("attendance_snapshot_chain_length")
    if chain:
        rows.append(["snapshot chain length", _fmt_value(max(chain)),
                     "-", "info"])
    # Temporal plane: watermark lag (gated by
    # --watermark-lag-ceiling-s; informational without), late-event
    # outcomes and bucket-rotation totals (always informational — a
    # dropped straggler is a data-quality fact the side channel
    # already preserved, not an SLO breach).
    wlag = _vals("attendance_watermark_lag_seconds")
    if wlag or watermark_lag_ceiling is not None:
        worst = max(wlag) if wlag else None
        if watermark_lag_ceiling is None:
            rows.append(["watermark lag", _fmt_value(worst), "-",
                         "info"])
        else:
            # Like the merge-lag gate: a ceiling set for a run that
            # never ran the temporal plane must FAIL loudly, not pass
            # vacuously.
            rows.append(["watermark lag", _fmt_value(worst),
                         f"<= {_fmt_value(watermark_lag_ceiling)}",
                         "FAIL" if worst is None
                         or worst > watermark_lag_ceiling else "PASS"])
    late_folded = _vals("attendance_late_events_total",
                        'outcome="folded"')
    if late_folded and max(late_folded) > 0:
        rows.append(["late events folded (still-open bucket)",
                     _fmt_value(max(late_folded)), "-", "info"])
    late_dropped = _vals("attendance_late_events_total",
                         'outcome="dropped"')
    if late_dropped and max(late_dropped) > 0:
        rows.append(["late events dropped (side channel)",
                     _fmt_value(max(late_dropped)), "-", "info"])
    rotations = _vals("attendance_window_rotations_total")
    if rotations:
        rows.append(["window bucket rotations",
                     _fmt_value(max(rotations)), "-", "info"])
    evictions = _vals("attendance_window_evictions_total")
    if evictions and max(evictions) > 0:
        rows.append(["window buckets evicted (ring pressure)",
                     _fmt_value(max(evictions)), "-", "info"])
    # Attribution plane: where the time went, which stage the dispatch
    # thread spends itself on, how often the device sat idle between
    # dispatches (informational context for every gate above), plus
    # the RECOMPILE gate: a steady-state count means unpadded shapes
    # reach the device (on the card: new launch shapes, so new
    # allocator blocks and grids every frame), and --recompile-ceiling
    # (normally 0) turns that from invisible into a failing verdict.
    from attendance_tpu_torch.obs.exposition import (label_value,
                                               rank_profile_stages)

    prof: Dict[str, float] = {}
    for name, labels, value in samples:
        if name == "attendance_profile_stage_fraction":
            try:
                v = float(value)
            except ValueError:
                continue
            if not math.isnan(v):
                prof[label_value(labels, "stage") or ""] = v
    if prof:
        # One shared ranking (exposition.rank_profile_stages) with
        # the fleet dashboard's top_stage cell: marked stages above
        # the untagged remainder, so the two surfaces can never name
        # different "top" stages for one run.
        rows.append(["profiled top stages",
                     ", ".join(f"{s} {v:.0%}" for s, v
                               in rank_profile_stages(prof)),
                     "-", "info"])
    busy = []
    for name, labels, value in samples:
        if name == "attendance_dispatch_thread_busy_fraction":
            try:
                v = float(value)
            except ValueError:
                continue
            if not math.isnan(v):
                busy.append((label_value(labels, "component") or "",
                             v))
    if busy:
        rows.append(["dispatch thread occupancy",
                     ", ".join(f"{c} {v:.0%}"
                               for c, v in sorted(busy)), "-", "info"])
    gpairs = []
    for name, labels, value in samples:
        if name == "attendance_dispatch_gap_seconds_bucket":
            le = _parse_le(labels)
            if le is not None:
                try:
                    gpairs.append((le, float(value)))
                except ValueError:
                    continue
    if gpairs and max(c for _, c in gpairs) > 0:
        p50, p99 = quantiles_from_cumulative(gpairs, (0.50, 0.99))
        rows.append(["dispatch gap p50/p99 (device idle window)",
                     f"{_fmt_value(p50)}/{_fmt_value(p99)}", "-",
                     "info"])
    recomp = _vals("attendance_recompiles_total")
    if recomp:
        rows.append(["device recompiles (total, incl. warmup)",
                     _fmt_value(sum(recomp)), "-", "info"])
    steady = _vals("attendance_recompiles_steady_total")
    if recompile_ceiling is not None:
        # Like the merge-lag/watermark gates: a ceiling set for a run
        # that never exported the tracker's counters FAILS loudly —
        # vacuous passes hide exactly the storms this gate exists for.
        worst = sum(steady) if steady else None
        rows.append(["steady-state recompiles", _fmt_value(worst),
                     f"<= {recompile_ceiling}",
                     "FAIL" if worst is None
                     or worst > recompile_ceiling else "PASS"])
    elif steady and sum(steady) > 0:
        rows.append(["steady-state recompiles (shape leak?)",
                     _fmt_value(sum(steady)), "-", "info"])
    # Self-healing transport: reconnects are REMEDIATION (each one is
    # a survived outage), so the row is informational by default —
    # --max-reconnects turns it into a gate for runs that should have
    # seen a quiet network.
    recon = _vals("attendance_reconnects_total")
    if recon or max_reconnects is not None:
        worst = max(recon) if recon else 0.0
        if max_reconnects is None:
            rows.append(["broker reconnects", _fmt_value(worst), "-",
                         "info"])
        else:
            rows.append(["broker reconnects", _fmt_value(worst),
                         f"<= {max_reconnects}",
                         "PASS" if worst <= max_reconnects else "FAIL"])
    retries = _vals("attendance_retry_attempts_total")
    if retries:
        rows.append(["broker RPC retries",
                     _fmt_value(sum(retries)), "-", "info"])
    # Striped ingress lane skew: the worst lane's event share vs the
    # median lane. A dead or starved lane (connection wedged below the
    # reconnect threshold, poisoned session) shows up as skew long
    # before it shows up as throughput — informational by default,
    # --lane-skew-ceiling gates it (the dead-lane detector; 0.5 flags
    # a lane running under half the median).
    lane_events = _vals("attendance_ingress_lane_events_total")
    if len(lane_events) >= 2 or (lane_events
                                 and lane_skew_ceiling is not None):
        ordered = sorted(lane_events)
        mid = len(ordered) // 2
        # True median (even counts average the middle pair): the
        # upper-middle element would make the 2-lane gate min/MAX.
        median = (ordered[mid] if len(ordered) % 2
                  else (ordered[mid - 1] + ordered[mid]) / 2.0)
        skew = (ordered[0] / median) if median > 0 else 0.0
        if lane_skew_ceiling is None:
            rows.append(["ingress lane skew (min/median)",
                         _fmt_value(round(skew, 4)), "-", "info"])
        else:
            rows.append(["ingress lane skew (min/median)",
                         _fmt_value(round(skew, 4)),
                         f">= {_fmt_value(lane_skew_ceiling)}",
                         "PASS" if skew >= lane_skew_ceiling
                         else "FAIL"])
    snap_fail = _vals("attendance_snapshot_write_failures_total")
    if snap_fail:
        rows.append(["snapshot write failures",
                     _fmt_value(max(snap_fail)), "-", "info"])
    # Integrity plane (informational rows — scrub and the chaos soak
    # are the hard gates; these surface the conditions in one place):
    # ENOSPC snapshot refusals (the writer backs off at the capped
    # cadence, frames stay unacked), corrupt durable artifacts
    # detected/quarantined, repairs performed, and wire-checksum
    # rejects at the gossip/fleet folds.
    disk_full = _vals("attendance_snapshot_disk_full_total")
    if disk_full and max(disk_full) > 0:
        rows.append(["snapshot disk full (ENOSPC)",
                     _fmt_value(max(disk_full)), "-", "info"])
    corrupt = _vals("attendance_chain_corrupt_files_total")
    if corrupt:
        rows.append(["corrupt chain files quarantined",
                     _fmt_value(sum(corrupt)), "-", "info"])
    repairs = _vals("attendance_chain_repairs_total")
    if repairs:
        rows.append(["chain repairs (local + peer)",
                     _fmt_value(sum(repairs)), "-", "info"])
    wire_rej = _vals("attendance_integrity_wire_rejects_total")
    if wire_rej and max(wire_rej) > 0:
        rows.append(["wire checksum rejects",
                     _fmt_value(sum(wire_rej)), "-", "info"])
    spill_rot = _vals("attendance_spill_corrupt_records_total")
    if spill_rot and max(spill_rot) > 0:
        rows.append(["corrupt spill records dropped",
                     _fmt_value(sum(spill_rot)), "-", "info"])
    circ = [(labels, v) for name, labels, v in samples
            if name == "attendance_circuit_state"]
    if circ:
        worst = max(float(v) for _, v in circ)
        # 0 = closed: a circuit still open/half-open at the last scrape
        # means the sink never healed — spilled batches are stranded.
        rows.append(["persist circuit state at last scrape",
                     _fmt_value(worst), "== 0 (closed)",
                     "PASS" if worst == 0.0 else "FAIL"])
    firing = [(labels, v) for name, labels, v in samples
              if name == "attendance_slo_firing" and float(v) >= 1.0]
    rows.append(["SLO alerts firing at last scrape", str(len(firing)),
                 "== 0", "PASS" if not firing else "FAIL"])
    burns = _vals("attendance_slo_burn_rate", 'window="slow"')
    if burns:
        worst = max(burns)
        rows.append(["worst slow-window burn rate", _fmt_value(worst),
                     f"< {_fmt_value(fire_burn)}",
                     "PASS" if worst < fire_burn else "FAIL"])
    return rows


def _alert_checks(events: List[dict]) -> Tuple[List[List[str]],
                                               List[str]]:
    last_state: Dict[str, str] = {}
    fired: Dict[str, int] = {}
    traces: List[str] = []
    versionless = 0
    for e in events:
        if e.get("schema") is None:
            versionless += 1
        last_state[e["slo"]] = e.get("state", "")
        if e.get("state") == "firing":
            fired[e["slo"]] = fired.get(e["slo"], 0) + 1
            if e.get("trace"):
                traces.append(str(e["trace"]))
    rows: List[List[str]] = []
    if not events:
        rows.append(["alert log", "0 transitions", "-", "PASS"])
    if versionless:
        # Pre-17 alert logs predate the schema field: readable, but flag
        # once so operators know which vintage they are replaying.
        rows.append(["alert log schema",
                     f"{versionless} versionless event(s) (pre-17 log)",
                     f"schema={ALERT_SCHEMA}", "warn"])
    for slo in sorted(last_state):
        unresolved = last_state[slo] == "firing"
        rows.append([f"alert {slo}",
                     f"{fired.get(slo, 0)} fired, last "
                     f"{last_state[slo]}", "resolved",
                     "FAIL" if unresolved else "PASS"])
    return rows, traces


def _quarantine_rows(directory: str) -> List[List[str]]:
    """Quarantine listing as verdict rows: entry count (informational —
    dead-lettered poison is a data-quality fact, not an SLO breach) and
    a per-reason breakdown."""
    from attendance_tpu_torch.transport.quarantine import list_entries

    entries = list_entries(directory)
    rows = [["quarantined frames", str(len(entries)), "-", "info"]]
    by_reason: Dict[str, int] = {}
    for e in entries:
        reason = e.get("reason") or "unspecified"
        by_reason[reason] = by_reason.get(reason, 0) + 1
    for reason in sorted(by_reason):
        rows.append([f"  quarantine[{reason}]",
                     str(by_reason[reason]), "-", "info"])
    return rows


def _fleet_wide_rows(per_role_samples: Dict[str, list],
                     merge_lag_ceiling: Optional[float],
                     staleness_ceiling: Optional[float],
                     watermark_lag_ceiling: Optional[float] = None,
                     recompile_ceiling: Optional[int] = None
                     ) -> List[List[str]]:
    """Fleet-level rows judged over the MERGED data: merge-lag p99
    from the summed cumulative buckets across every artifact that has
    the histogram (normally just the aggregator's), read staleness as
    the worst instance, events as the sum over ingest roles, and a
    fleet-size row. Ceilings turn the first two into gates."""
    from attendance_tpu_torch.obs.exposition import (
        fold_headline_samples, quantiles_from_cumulative)

    rows: List[List[str]] = []
    rows.append(["fleet: roles collected",
                 str(len(per_role_samples)), ">= 1",
                 "PASS" if per_role_samples else "FAIL"])
    # One shared extraction (exposition.fold_headline_samples) with
    # the `fleet` dashboard's headline — folding every role's samples
    # into one accumulator IS the merge (lag buckets sum by le).
    acc = None
    for samples in per_role_samples.values():
        acc = fold_headline_samples(samples, acc)
    acc = fold_headline_samples((), acc)
    staleness = acc["staleness"]
    firing = acc["firing"]
    if acc["have_events"]:
        rows.append(["fleet: events (sum over roles)",
                     _fmt_value(acc["events"]), "-", "info"])
    pairs = sorted(acc["lag_by_le"].items())
    has_lag = bool(pairs) and max(c for _, c in pairs) > 0
    if merge_lag_ceiling is not None:
        # Same vacuous-pass refusal as the single-run doctor: a fleet
        # judged with a merge-lag ceiling MUST have gossiped.
        p99 = (quantiles_from_cumulative(pairs, (0.99,))[0]
               if has_lag else None)
        rows.append(["fleet: merge lag p99", _fmt_value(p99),
                     f"<= {_fmt_value(merge_lag_ceiling)}",
                     "FAIL" if p99 is None or p99 > merge_lag_ceiling
                     else "PASS"])
    elif has_lag:
        (p99,) = quantiles_from_cumulative(pairs, (0.99,))
        rows.append(["fleet: merge lag p99", _fmt_value(p99), "-",
                     "info"])
    if staleness or staleness_ceiling is not None:
        worst = max(staleness, default=None)
        if staleness_ceiling is None:
            rows.append(["fleet: worst read staleness",
                         _fmt_value(worst), "-", "info"])
        else:
            rows.append(["fleet: worst read staleness",
                         _fmt_value(worst),
                         f"<= {_fmt_value(staleness_ceiling)}",
                         "n/a" if worst is None
                         else ("PASS" if worst <= staleness_ceiling
                               else "FAIL")])
    # Temporal plane: worst watermark lag across every role that
    # exports the gauge — informational when present without a
    # ceiling (like staleness/merge-lag above); a ceiling over a
    # fleet with NO temporal role fails loudly, never vacuously.
    lags = []
    for samples in per_role_samples.values():
        for name, _labels, v in samples:
            if name != "attendance_watermark_lag_seconds":
                continue
            try:
                v = float(v)
            except ValueError:
                continue
            if not math.isnan(v):
                lags.append(v)
    if watermark_lag_ceiling is not None:
        worst = max(lags) if lags else None
        rows.append(["fleet: worst watermark lag", _fmt_value(worst),
                     f"<= {_fmt_value(watermark_lag_ceiling)}",
                     "FAIL" if worst is None
                     or worst > watermark_lag_ceiling else "PASS"])
    elif lags:
        rows.append(["fleet: worst watermark lag",
                     _fmt_value(max(lags)), "-", "info"])
    # Attribution plane: steady-state recompiles summed over every
    # role that exports the tracker (dispatching roles); a ceiling
    # over a fleet where NO role exported it fails loudly — and the
    # only dispatching roles are exactly the ones that must export.
    steadies = []
    for samples in per_role_samples.values():
        for name, _labels, v in samples:
            if name != "attendance_recompiles_steady_total":
                continue
            try:
                v = float(v)
            except ValueError:
                continue
            if not math.isnan(v):
                steadies.append(v)
    if recompile_ceiling is not None:
        worst = sum(steadies) if steadies else None
        rows.append(["fleet: steady-state recompiles",
                     _fmt_value(worst), f"<= {recompile_ceiling}",
                     "FAIL" if worst is None
                     or worst > recompile_ceiling else "PASS"])
    elif steadies and sum(steadies) > 0:
        rows.append(["fleet: steady-state recompiles (shape leak?)",
                     _fmt_value(sum(steadies)), "-", "info"])
    rows.append(["fleet: SLO alerts firing across roles",
                 str(firing), "== 0",
                 "PASS" if firing == 0 else "FAIL"])
    return rows


def doctor_fleet_report(fleet_dir: str, *,
                        fpr_ceiling: float = 0.01,
                        hll_error_ceiling: float = 0.02,
                        fire_burn: float = DEFAULT_FIRE_BURN,
                        snapshot_stall_ceiling: Optional[float] = None,
                        max_reconnects: Optional[int] = None,
                        lane_skew_ceiling: Optional[float] = None,
                        query_p99_ceiling: Optional[float] = None,
                        staleness_ceiling: Optional[float] = None,
                        merge_lag_ceiling: Optional[float] = None,
                        watermark_lag_ceiling: Optional[float] = None,
                        recompile_ceiling: Optional[int] = None
                        ) -> Tuple[str, bool]:
    """ONE verdict table over a fleet collector's artifact directory
    (``--fleet-dir``): every ``<role>@<instance>.prom`` the collector
    persisted is judged with the normal per-run checks (rows prefixed
    with the role), then fleet-WIDE rows judge the merged data —
    merge-lag p99 over the summed histograms, worst read staleness,
    roles collected, alerts firing anywhere. Exit semantics match
    :func:`doctor_report`: the CLI maps (text, ok=False) to exit 1,
    unreadable input raises (exit 2)."""
    from attendance_tpu_torch.obs.exposition import _table, parse_prom

    root = Path(fleet_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"no fleet artifact dir: {fleet_dir}")
    prom_files = sorted(root.glob("*.prom"))
    if not prom_files:
        raise ValueError(
            f"fleet dir {fleet_dir} holds no *.prom artifacts — was "
            "the collector given a --fleet-dir?")
    rows: List[List[str]] = []
    per_role_samples: Dict[str, list] = {}
    for path in prom_files:
        role = path.stem  # role@instance
        text = path.read_text()
        per_role_samples[role] = parse_prom(text)
        for row in _prom_checks(text, fpr_ceiling, hll_error_ceiling,
                                fire_burn, snapshot_stall_ceiling,
                                max_reconnects, lane_skew_ceiling,
                                query_p99_ceiling,
                                staleness_ceiling=None,
                                merge_lag_ceiling=None):
            rows.append([f"{role}: {row[0]}", *row[1:]])
    rows.extend(_fleet_wide_rows(per_role_samples, merge_lag_ceiling,
                                 staleness_ceiling,
                                 watermark_lag_ceiling,
                                 recompile_ceiling))
    trace_path = root / "fleet_trace.json"
    if trace_path.exists():
        doc = json.loads(trace_path.read_text())
        other = doc.get("otherData", {})
        names = {e.get("name") for e in doc.get("traceEvents", [])
                 if e.get("ph") == "X"}
        stitched = {"fence_publish", "fed_merge"} <= names
        rows.append(["fleet: stitched trace",
                     f"{other.get('span_count', 0)} spans / "
                     f"{other.get('instances', 0)} instances"
                     + (", fence->merge stitched" if stitched else ""),
                     "-", "info"])
    ok = not any(r[3] == "FAIL" for r in rows)
    failed = sum(1 for r in rows if r[3] == "FAIL")
    head = [f"doctor --fleet: {len(prom_files)} role artifact(s) "
            f"under {fleet_dir}",
            _table(rows, ["check", "value", "target", "verdict"]),
            f"verdict: {'PASS' if ok else f'FAIL ({failed} breached)'}"]
    return "\n".join(head), ok


def doctor_report(paths: Sequence[str], *,
                  fpr_ceiling: float = 0.01,
                  hll_error_ceiling: float = 0.02,
                  fire_burn: float = DEFAULT_FIRE_BURN,
                  snapshot_stall_ceiling: Optional[float] = None,
                  max_reconnects: Optional[int] = None,
                  lane_skew_ceiling: Optional[float] = None,
                  query_p99_ceiling: Optional[float] = None,
                  staleness_ceiling: Optional[float] = None,
                  merge_lag_ceiling: Optional[float] = None,
                  watermark_lag_ceiling: Optional[float] = None,
                  recompile_ceiling: Optional[int] = None,
                  quarantine_dir: str = ""
                  ) -> Tuple[str, bool]:
    """Replay run artifacts offline; returns (verdict text, ok).

    Accepts any mix of: a ``--metrics-prom`` exposition file (the last
    scrape block is judged), a ``--alert-log`` JSONL, a flight-recorder
    dump, a ``--trace-out`` export — plus, via ``quarantine_dir``, an
    on-disk quarantine whose entries are listed informationally.
    ``max_reconnects`` turns the reconnect row from informational into
    a gate. Unknown/unreadable files raise — the CLI maps that to exit
    2, distinct from the SLO-breach exit 1.
    """
    from attendance_tpu_torch.obs.exposition import _table

    rows: List[List[str]] = []
    artifacts: List[str] = []
    alert_traces: List[str] = []
    trace_ids: set = set()
    flight_alerts = 0
    for path in paths:
        kind, payload = _classify(path)
        artifacts.append(f"{kind}: {Path(path).name}")
        if kind == "prom":
            rows.extend(_prom_checks(payload, fpr_ceiling,
                                     hll_error_ceiling, fire_burn,
                                     snapshot_stall_ceiling,
                                     max_reconnects,
                                     lane_skew_ceiling,
                                     query_p99_ceiling,
                                     staleness_ceiling,
                                     merge_lag_ceiling,
                                     watermark_lag_ceiling,
                                     recompile_ceiling))
        elif kind == "alerts":
            arows, traces = _alert_checks(payload)
            rows.extend(arows)
            alert_traces.extend(traces)
        elif kind == "flight":
            recs = payload.get("records", [])
            flight_alerts += sum(1 for r in recs
                                 if isinstance(r, dict) and "alert" in r)
            trace_ids.update(str(r["trace"]) for r in recs
                             if isinstance(r, dict) and r.get("trace"))
        elif kind == "trace":
            for e in payload.get("traceEvents", []):
                t = (e.get("args") or {}).get("trace_id")
                if t:
                    trace_ids.add(str(t))
    if flight_alerts:
        rows.append(["flight records flagged by alerts",
                     str(flight_alerts), "-", "info"])
    if alert_traces:
        found = sum(1 for t in alert_traces if t in trace_ids)
        rows.append(["alert trace ids found in trace/flight artifacts",
                     f"{found}/{len(alert_traces)}", "-", "info"])
    if quarantine_dir:
        artifacts.append(f"quarantine: {Path(quarantine_dir).name}")
        rows.extend(_quarantine_rows(quarantine_dir))
    if not rows:
        raise ValueError("no judgeable artifacts (need a prom "
                         "exposition file, an alert log, or a "
                         "quarantine dir)")
    ok = not any(r[3] == "FAIL" for r in rows)
    failed = sum(1 for r in rows if r[3] == "FAIL")
    head = [f"doctor: {len(artifacts)} artifact(s) — "
            + ", ".join(artifacts),
            _table(rows, ["check", "value", "target", "verdict"]),
            f"verdict: {'PASS' if ok else f'FAIL ({failed} breached)'}"]
    return "\n".join(head), ok
