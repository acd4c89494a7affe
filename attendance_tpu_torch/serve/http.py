"""JSON query routes behind the telemetry HTTP endpoint.

Counterpart of ``attendance_tpu/serve/http.py``. The ``--metrics-port``
server (obs/exposition.MetricsServer) gains the query verbs as JSON
routes: occupancy tables a ``curl`` can read, beside the scrape surface,
with no second HTTP stack. The fast path is the binary RPC (serve/rpc);
these routes are the human and integration surface. They answer from
the engine's pinned epoch, in host numpy, and never read the card.

Routes (all answer ``application/json``):

* ``GET  /query/occupancy``          — {day: unique} table.
* ``GET  /query/rate[?roster=N]``    — {day: attendance rate}.
* ``GET  /query/stats``              — epoch metadata + validity.
* ``GET  /query/exists?keys=1,2,3``  — [bool, ...] per key.
* ``GET  /query/pfcount?days=D1,D2`` — [count, ...] per day
  (days accept ints or reference-style ``LECTURE_YYYYMMDD`` ids).
* ``GET  /query/window[?day=D&from=P&to=P]`` — merge-on-read unique
  count over the matching temporal buckets ("who attended this
  week" = a day + its period range).
* ``GET  /query/window_occupancy`` — {"day:period": unique} table.
* ``GET  /query/rate_series[?day=D&roster=N]`` — {period: rate}.
* ``POST /query`` — batch body ``{"verb": ..., "keys": [...],
  "days": [...], "day": D, "period_lo": P, "period_hi": P,
  "roster_size": N}`` -> ``{"result": ...}``.
"""

from __future__ import annotations

import json
from urllib.parse import parse_qs

import numpy as np


def _json(doc, status: int = 200):
    return (status, "application/json; charset=utf-8",
            json.dumps(doc).encode())


def _days_arg(vals):
    """Day vector from mixed JSON/query inputs: ints and digit strings
    pass through, ``LECTURE_YYYYMMDD`` ids resolve via the shared
    one-key-space rule."""
    from attendance_tpu_torch.serve.engine import resolve_days

    out = []
    for v in vals:
        if isinstance(v, str):
            if not v:
                continue
            out.append(int(v) if v.lstrip("-").isdigit() else v)
        else:
            out.append(int(v))
    return resolve_days(out)


def attach(server, engine) -> None:
    """Mount the query routes for ``engine`` on a MetricsServer."""

    def occupancy(method, path, query, body):
        return _json({str(d): c for d, c in
                      sorted(engine.occupancy().items())})

    def rate(method, path, query, body):
        q = parse_qs(query)
        roster = int(q.get("roster", ["0"])[0])
        return _json({str(d): r for d, r in
                      sorted(engine.attendance_rate(roster).items())})

    def stats(method, path, query, body):
        return _json(engine.stats())

    def exists(method, path, query, body):
        q = parse_qs(query)
        raw = ",".join(q.get("keys", [""]))
        keys = np.array([int(k) for k in raw.split(",") if k],
                        dtype=np.uint32)
        return _json([bool(v) for v in engine.bf_exists(keys)])

    def pfcount(method, path, query, body):
        q = parse_qs(query)
        raw = ",".join(q.get("days", [""]))
        days = _days_arg(raw.split(","))
        return _json([int(v) for v in engine.pfcount(days)])

    def _opt_int(q, name):
        raw = q.get(name, [""])[0]
        return int(raw) if raw else None

    def _wocc_doc(table):
        return {f"{d}:{p}": int(v)
                for (d, p), v in sorted(table.items())}

    def window(method, path, query, body):
        q = parse_qs(query)
        day = q.get("day", [""])[0]
        day = (_days_arg([day])[0] if day else None)
        return _json({"unique": engine.window_pfcount(
            None if day is None else int(day),
            _opt_int(q, "from"), _opt_int(q, "to"))})

    def window_occupancy(method, path, query, body):
        return _json(_wocc_doc(engine.window_occupancy()))

    def rate_series(method, path, query, body):
        q = parse_qs(query)
        day = q.get("day", [""])[0]
        day = (int(_days_arg([day])[0]) if day else None)
        roster = int(q.get("roster", ["0"])[0])
        return _json({str(p): r for p, r in sorted(
            engine.rate_series(day, roster).items())})

    def batch(method, path, query, body):
        if method != "POST":
            return _json({"error": "POST a JSON batch here"}, 405)
        doc = json.loads(body or b"{}")
        verb = doc.get("verb", "")
        keys = doc.get("keys")
        days = doc.get("days")
        day = doc.get("day")
        result = engine.execute(
            verb,
            keys=(None if keys is None
                  else np.asarray(keys, dtype=np.uint32)),
            days=None if days is None else _days_arg(days),
            day=None if day is None else int(_days_arg([day])[0]),
            period_lo=doc.get("period_lo"),
            period_hi=doc.get("period_hi"),
            roster_size=int(doc.get("roster_size", 0)))
        if isinstance(result, np.ndarray):
            result = [bool(v) if result.dtype == bool else int(v)
                      for v in result]
        elif isinstance(result, dict):
            if result and isinstance(next(iter(result)), tuple):
                result = _wocc_doc(result)
            else:
                result = {str(k): v for k, v in result.items()}
        return _json({"verb": verb, "result": result})

    server.add_route("/query/occupancy", occupancy)
    server.add_route("/query/rate", rate)
    server.add_route("/query/stats", stats)
    server.add_route("/query/exists", exists)
    server.add_route("/query/pfcount", pfcount)
    server.add_route("/query/window", window)
    server.add_route("/query/window_occupancy", window_occupancy)
    server.add_route("/query/rate_series", rate_series)
    server.add_route("/query", batch)


QUERY_ROUTES = ("/query/occupancy", "/query/rate", "/query/stats",
                "/query/exists", "/query/pfcount", "/query/window",
                "/query/window_occupancy", "/query/rate_series",
                "/query")


def detach(server) -> None:
    """Unmount the query routes (the owning pipeline's cleanup): the
    metrics server is process-global and outlives pipelines, so leaked
    route closures would keep serving a dead pipeline's last epoch as
    live data AND pin its mirror arrays for the process lifetime."""
    for path in QUERY_ROUTES:
        server.remove_route(path)
