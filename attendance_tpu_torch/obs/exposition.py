"""Prometheus text exposition + the two delivery surfaces.

Counterpart of ``attendance_tpu/obs/exposition.py``: the text is byte for
byte the JAX package's for the same registry (names, label order, help
strings, bucket bounds, float spelling, the ``# scrape`` header), so one
package's artifacts read in the other's ``telemetry`` verb.

``render`` turns a Registry into Prometheus text-exposition format
(version 0.0.4 — the format every scraper and promtool parses). Two
delivery modes, both off the hot path:

* :class:`FileReporter` — a background thread appending one rendered
  block per interval to a file (``--metrics-prom``), each prefixed with
  a ``# scrape <unix_ts>`` marker so consumers (and the CLI
  ``telemetry`` verb) can split blocks.
* :class:`MetricsServer` — a stdlib ThreadingHTTPServer answering
  ``GET /metrics`` with a fresh render (``--metrics-port``); no
  third-party dependency, matching the container constraint.

Also home of the ``telemetry`` CLI verb's table formatters: a prom file
or a flight-recorder dump pretty-printed as a live-style table.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from attendance_tpu_torch.obs.registry import (
    Counter, Gauge, Histogram, NUM_BUCKETS, Registry)

logger = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v) -> str:
    """Prometheus sample value: integers bare, floats via repr (both
    are valid exposition floats; bare ints keep counters exact).
    Non-finite values render per the text-format spec (``NaN``,
    ``+Inf``, ``-Inf``) — repr would emit ``nan``/``inf``, which
    promtool rejects, and the int-folding below would raise on them."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(items, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def render(registry: Registry) -> str:
    """Registry -> Prometheus text exposition (one trailing newline)."""
    lines: List[str] = []
    for name, kind, help, members in registry.collect():
        if help:
            lines.append(f"# HELP {name} {_escape(help)}")
        lines.append(f"# TYPE {name} {kind}")
        for m in members:
            if isinstance(m, Counter):
                lines.append(f"{name}{_labels(m.labels)} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                # Callback gauges (queue depths, sketch health) read
                # live state at scrape time; one raising callback (a
                # bad device read) must SKIP its sample with a warning
                # — not 500 the /metrics endpoint, not abort the prom
                # file append, and not render a lying 0.0.
                try:
                    v = m.read()
                except Exception as exc:
                    logger.warning(
                        "gauge %s%s raised at scrape time; sample "
                        "skipped: %r", name, _labels(m.labels), exc)
                    continue
                lines.append(f"{name}{_labels(m.labels)} {_fmt(v)}")
            elif isinstance(m, Histogram):
                buckets, total, count = m.snapshot()
                # OpenMetrics-style exemplar on the landing bucket: the
                # worst traced observation of this scrape window, so a
                # p99 breach links straight to its span tree. Reading
                # it resets the window (best-effort sample semantics).
                ex = m.exemplar()
                ex_idx = -1
                if ex is not None:
                    u = int(ex[0] * m.scale)
                    ex_idx = min(u.bit_length() if u > 0 else 0,
                                 NUM_BUCKETS)
                ex_suffix = ("" if ex is None else
                             f' # {{trace_id="{_escape(ex[1])}"}}'
                             f" {_fmt(ex[0])}")
                cum = 0
                for i in range(NUM_BUCKETS):
                    cum += buckets[i]
                    le = 'le="%s"' % _fmt(m.bucket_bound(i))
                    line = f"{name}_bucket{_labels(m.labels, le)} {cum}"
                    if i == ex_idx:
                        line += ex_suffix
                    lines.append(line)
                inf = 'le="+Inf"'
                line = f"{name}_bucket{_labels(m.labels, inf)} {count}"
                if ex_idx == NUM_BUCKETS:
                    line += ex_suffix
                lines.append(line)
                lines.append(f"{name}_sum{_labels(m.labels)} {_fmt(total)}")
                lines.append(f"{name}_count{_labels(m.labels)} {count}")
    return "\n".join(lines) + "\n"


class FileReporter:
    """Append a rendered block to ``path`` every ``interval_s``."""

    def __init__(self, registry: Registry, path: str,
                 interval_s: float = 1.0):
        self.registry = registry
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="metrics-reporter", daemon=True)

    def start(self) -> "FileReporter":
        self._thread.start()
        return self

    def _write_block(self) -> None:
        block = f"# scrape {time.time():.3f}\n" + render(self.registry)
        with open(self.path, "a") as f:
            f.write(block)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._write_block()
            except Exception:
                logger.exception("metrics reporter write failed")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            self._write_block()  # final block: short runs still report
        except Exception:
            logger.exception("metrics reporter final write failed")


class MetricsServer:
    """``GET /metrics`` over stdlib http.server; port 0 = ephemeral
    (the bound port is exposed as ``.port``).

    Other subsystems may mount extra paths on the same endpoint via
    :meth:`add_route` (the query plane's ``/query/*`` verbs,
    serve/http.py): a route handler takes ``(method, path, query_str,
    body_bytes)`` and returns ``(status, content_type, body_bytes)``.
    Routes are matched by exact path after stripping the query string;
    a raising handler answers 500 with the repr — never a hung
    connection."""

    def __init__(self, registry: Registry, port: int,
                 host: str = "127.0.0.1"):
        outer = self
        self.routes: dict = {}

        class Handler(BaseHTTPRequestHandler):
            def _dispatch(self, method: str):
                path, _, query = self.path.partition("?")
                route = outer.routes.get(path)
                if route is not None:
                    length = int(self.headers.get("Content-Length")
                                 or 0)
                    body = self.rfile.read(length) if length else b""
                    try:
                        status, ctype, reply = route(method, path,
                                                     query, body)
                    except Exception as exc:
                        status, ctype = 500, "text/plain; charset=utf-8"
                        reply = repr(exc).encode()
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(reply)))
                    self.end_headers()
                    self.wfile.write(reply)
                    return
                if method == "GET" and path in ("/metrics", "/"):
                    body = render(outer.registry).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_error(404)

            def do_GET(self):  # noqa: N802 (stdlib naming)
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802 (stdlib naming)
                self._dispatch("POST")

            def log_message(self, *args):  # scrapes are not log lines
                pass

        self.registry = registry
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)

    def add_route(self, path: str, handler) -> None:
        """Mount ``handler(method, path, query, body) -> (status,
        content_type, body_bytes)`` at an exact path."""
        self.routes[path] = handler

    def remove_route(self, path: str) -> None:
        """Unmount a path (idempotent). Subsystems that mounted routes
        must remove them on teardown: the server is process-global, so
        a leaked closure would keep answering from (and pinning) a
        dead owner's state."""
        self.routes.pop(path, None)

    def start(self) -> "MetricsServer":
        self._thread.start()
        logger.info("Serving Prometheus metrics on :%d/metrics",
                    self.port)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


# -- CLI table formatting ----------------------------------------------------

def parse_prom(text: str):
    """Samples of the LAST scrape block: [(name, labels_str, value)].
    Accepts both reporter files (multiple ``# scrape`` blocks) and a
    single raw exposition."""
    blocks = text.split("# scrape ")
    last = blocks[-1]
    if len(blocks) > 1:  # drop the timestamp line of the marker
        last = last.split("\n", 1)[1] if "\n" in last else ""
    samples = []
    for line in last.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if " # " in line:
            # Drop an OpenMetrics exemplar suffix (` # {trace_id=...}
            # <value>`) so pre-exemplar offline consumers keep parsing
            # the sample itself; parse_exemplars reads the suffix.
            line = line.split(" # ", 1)[0].rstrip()
        try:
            metric, value = line.rsplit(" ", 1)
        except ValueError:
            continue
        if "{" in metric:
            name, rest = metric.split("{", 1)
            labels = rest.rstrip("}")
        else:
            name, labels = metric, ""
        samples.append((name, labels, value))
    return samples


_EXEMPLAR_RE = re.compile(r'\{trace_id="([^"]*)"\}\s+(\S+)')


def parse_exemplars(text: str):
    """OpenMetrics exemplars of the LAST scrape block:
    {(base_name, labels_without_le): (value, trace_id)} — the worst
    traced observation per histogram series, the jump from a latency
    breach into the trace slice."""
    blocks = text.split("# scrape ")
    last = blocks[-1]
    if len(blocks) > 1:
        last = last.split("\n", 1)[1] if "\n" in last else ""
    out = {}
    for line in last.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or " # " not in line:
            continue
        metric_part, ex_part = line.split(" # ", 1)
        m = _EXEMPLAR_RE.match(ex_part.strip())
        if m is None:
            continue
        metric = metric_part.rsplit(" ", 1)[0]
        if "{" in metric:
            name, rest = metric.split("{", 1)
            labels = rest.rstrip("}")
        else:
            name, labels = metric, ""
        if name.endswith("_bucket"):
            name = name[:-len("_bucket")]
            labels = ",".join(p for p in labels.split(",")
                              if p and not p.startswith("le="))
        try:
            out[(name, labels)] = (float(m.group(2)), m.group(1))
        except ValueError:
            continue
    return out


def _table(rows: List[List[str]], headers: List[str]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    out = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
    out.extend(fmt.format(*r) for r in rows)
    return "\n".join(out)


def label_value(labels: str, key: str) -> Optional[str]:
    """Value of one label in a parse_prom labels string, unquoted;
    None when absent — the ONE label-value parse every offline
    consumer (doctor rows, fleet headlines, the le= bound below)
    shares."""
    for part in labels.split(","):
        if part.startswith(f"{key}="):
            return part[len(key) + 1:].strip('"')
    return None


def _parse_le(labels: str) -> Optional[float]:
    raw = label_value(labels, "le")
    if raw is None:
        return None
    return float("inf") if raw == "+Inf" else float(raw)


def quantiles_from_cumulative(pairs, qs) -> List[float]:
    """Quantile estimates from cumulative (le_bound, cum_count) bucket
    samples, linearly interpolated inside the landing bucket (the
    text-exposition counterpart of registry.quantile_from_buckets —
    this one works from a scraped prom file, where only the cumulative
    form survives). NaN per quantile when the histogram is empty; +Inf
    when the rank lands in the +Inf bucket."""
    pairs = sorted(pairs, key=lambda p: p[0])
    count = pairs[-1][1] if pairs else 0.0
    out = []
    for q in qs:
        if count <= 0:
            out.append(float("nan"))
            continue
        rank = max(1.0, math.ceil(q * count))
        lo_bound, lo_cum = 0.0, 0.0
        value = float("inf")
        for bound, cum in pairs:
            if cum >= rank:
                if math.isinf(bound):
                    value = bound
                elif cum > lo_cum:
                    frac = (rank - lo_cum) / (cum - lo_cum)
                    value = lo_bound + (bound - lo_bound) * frac
                else:
                    value = bound
                break
            lo_bound, lo_cum = bound, cum
        out.append(value)
    return out


def fold_headline_samples(samples, acc: Optional[dict] = None) -> dict:
    """Fold one exposition's parsed samples into the shared headline
    accumulator — the ONE definition of the cross-role headline
    numbers both fleet surfaces read (`fleet` status/dashboard and
    ``doctor --fleet``'s fleet-wide rows): events sum, SLO-firing
    count, per-sample read-staleness values, the series self-gauge,
    and merge-lag cumulative buckets summed by ``le`` (so folding
    several roles' samples yields the merged histogram). Pass the
    returned ``acc`` back in to accumulate across instances."""
    if acc is None:
        acc = {"events": 0.0, "have_events": False, "firing": 0,
               "staleness": [], "series": None, "lag_by_le": {},
               "prof_stages": {}, "incidents": None}
    for name, labels, value in samples:
        try:
            v = float(value)
        except ValueError:
            continue
        if math.isnan(v):
            continue
        if name == "attendance_events_total":
            acc["events"] += v
            acc["have_events"] = True
        elif name == "attendance_slo_firing" and v >= 1.0:
            acc["firing"] += 1
        elif name == "attendance_read_staleness_seconds":
            acc["staleness"].append(v)
        elif name == "attendance_metric_series_total":
            acc["series"] = int(v)
        elif name == "attendance_incidents_open":
            # Summed across folded instances; None stays "metric
            # absent" (pre-17 exposition) vs 0 "engine on, no incident".
            acc["incidents"] = int(v) + (acc["incidents"] or 0)
        elif name == "attendance_profile_stage_fraction":
            # Sampling-profiler self-time per stage — the
            # fleet surfaces render each role's top stage from it.
            stage = label_value(labels, "stage")
            if stage is not None:
                acc["prof_stages"][stage] = max(
                    acc["prof_stages"].get(stage, 0.0), v)
        elif name == "attendance_fed_merge_lag_seconds_bucket":
            le = _parse_le(labels)
            if le is not None:
                acc["lag_by_le"][le] = (acc["lag_by_le"].get(le, 0.0)
                                        + v)
    return acc


def rank_profile_stages(fracs: dict, top: int = 3) -> list:
    """Busiest-first (stage, fraction) pairs with marked stages
    ranking above the untagged remainder (untagged shows only when it
    is all there is) — the ONE ordering shared by the fleet
    dashboard's ``top_stage`` cell and doctor's "profiled top stages"
    row, so the two surfaces can never name different top stages for
    the same exposition."""
    tagged = {s: v for s, v in fracs.items() if s != "untagged"} \
        or fracs
    return sorted(tagged.items(), key=lambda kv: -kv[1])[:top]


def format_prom_table(text: str) -> str:
    """Live-style table of the last scrape block of a prom file.
    Histograms are folded to count/sum/mean plus p50/p95/p99 derived
    from the cumulative buckets (registry.Histogram.quantile's offline
    twin) — the raw buckets stay in the file for machine consumers."""
    samples = parse_prom(text)
    exemplars = parse_exemplars(text)
    hist: dict = {}
    rows = []
    for name, labels, value in samples:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[:-len(suffix)]
                key_labels = ",".join(
                    p for p in labels.split(",") if not
                    p.startswith("le=")) if suffix == "_bucket" else labels
                h = hist.setdefault((base, key_labels), {})
                if suffix == "_bucket":
                    le = _parse_le(labels)
                    if le is not None:
                        h.setdefault("_buckets", []).append(
                            (le, float(value)))
                else:
                    h[suffix] = value
                break
        else:
            rows.append([name, labels, value])
    for (base, labels), h in sorted(hist.items()):
        count = float(h.get("_count", 0) or 0)
        total = float(h.get("_sum", 0) or 0)
        mean = f"{total / count:.6g}" if count else "n/a"
        cell = f"count={int(count)} sum={total:.6g} mean={mean}"
        if count and h.get("_buckets"):
            p50, p95, p99 = quantiles_from_cumulative(
                h["_buckets"], (0.50, 0.95, 0.99))
            cell += (f" p50={p50:.6g} p95={p95:.6g} p99={p99:.6g}")
        ex = exemplars.get((base, labels))
        if ex is not None:
            cell += f" exemplar={ex[1]}@{ex[0]:.6g}"
        rows.append([base, labels, cell])
    rows.sort()
    return _table(rows, ["metric", "labels", "value"])


def format_flight_table(doc: dict, last: int = 32) -> str:
    """Flight-recorder dump -> table of the most recent records."""
    records = doc.get("records", [])[-last:]
    cols: List[str] = []
    for r in records:
        for k in r:
            if k not in cols:
                cols.append(k)
    rows = [[str(r.get(c, "")) for c in cols] for r in records]
    head = (f"flight recorder dump: reason={doc.get('reason')} "
            f"pid={doc.get('pid')} total_records="
            f"{doc.get('total_records')} ring={doc.get('ring_size')} "
            f"(showing last {len(records)})")
    return head + "\n" + _table(rows, cols or ["(empty)"])


def format_trace_tree(doc: dict, last: int = 32) -> str:
    """Chrome-trace export (--trace-out) -> per-trace span trees with
    durations: one block per trace_id (most recent ``last`` traces),
    spans indented under their parent in start order, each line
    ``name  dur  [role]  {extra args}``."""
    # Normalize up front: the trace-event format permits args-less
    # events (foreign/profiler traces routed here by format_file's
    # sniffing) and this formatter must print a tree, not KeyError.
    events = [{**e, "args": e.get("args") or {}}
              for e in doc.get("traceEvents", [])
              if e.get("ph") == "X"]
    roles = {e["pid"]: (e.get("args") or {}).get("name", "")
             for e in doc.get("traceEvents", [])
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    by_trace: dict = {}
    for e in events:
        tid = e["args"].get("trace_id", "?")
        by_trace.setdefault(tid, []).append(e)
    # Most recent traces last, ordered by their earliest span.
    ordered = sorted(by_trace.items(),
                     key=lambda kv: min(e.get("ts", 0) for e in kv[1]))
    shown = ordered[-last:]
    out = [f"trace export: {len(events)} spans in {len(by_trace)} "
           f"traces (showing last {len(shown)}); "
           f"dropped={doc.get('otherData', {}).get('dropped_spans', 0)}"]

    def _fmt_dur(us: float) -> str:
        return (f"{us / 1e3:.3f}ms" if us < 1e6 else f"{us / 1e6:.3f}s")

    for trace_id, spans in shown:
        spans.sort(key=lambda e: (e.get("ts", 0), -e.get("dur", 0)))
        children: dict = {}
        ids = {e["args"].get("span_id") for e in spans}
        roots = []
        for e in spans:
            parent = e["args"].get("parent_span_id")
            if parent in ids and parent != e["args"].get("span_id"):
                children.setdefault(parent, []).append(e)
            else:
                roots.append(e)
        out.append(f"trace {trace_id}:")
        stack = [(e, 1) for e in reversed(roots)]
        while stack:
            e, depth = stack.pop()
            extra = {k: v for k, v in e["args"].items()
                     if k not in ("trace_id", "span_id",
                                  "parent_span_id")}
            role = roles.get(e["pid"], "")
            out.append("  " * depth + f"{e['name']}  "
                       f"{_fmt_dur(e.get('dur', 0))}"
                       + (f"  [{role}]" if role else "")
                       + (f"  {extra}" if extra else ""))
            for c in reversed(children.get(e["args"].get("span_id"),
                                           [])):
                stack.append((c, depth + 1))
    return "\n".join(out)


def format_file(path: str, last: int = 32) -> str:
    """Sniff ``path`` (trace export / flight-dump JSON / prom text)
    and format it."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        doc = json.loads(text)
        if doc.get("kind") == "attribution":
            from attendance_tpu_torch.obs.profiler import (
                format_attribution_table)
            return format_attribution_table(doc)
        if "traceEvents" in doc:
            return format_trace_tree(doc, last=last)
        return format_flight_table(doc, last=last)
    return format_prom_table(text)
