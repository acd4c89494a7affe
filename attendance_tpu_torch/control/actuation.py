"""The actuation log — every knob the controller touches, on disk.

Counterpart of ``attendance_tpu/control/actuation.py``: the same schema,
records (``json.dumps(..., sort_keys=True)``, so two logs of the same
actuations differ only in ``ts``), checks and report text, so either
package's ``doctor --actuations`` reads either package's log.

One JSONL record per actuation (including refusals), fsync'd as it is
written: the log is the flight recorder for "why is the system in this
mode", so it must survive the crash it may be explaining.  Schema is
versioned (``attendance-actuation-v1``) and validated on read;
``doctor --actuations`` replays a log and fails loudly on schema drift,
non-monotonic sequence numbers, or unknown outcomes — the same
tamper-evident posture the incident evidence bundles take.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

ACTUATION_SCHEMA = "attendance-actuation-v1"

# Field -> required?  (validated on read; extra fields are tolerated so
# v1 readers survive additive growth).
_FIELDS = {
    "schema": True, "ts": True, "seq": True, "knob": True,
    "from": True, "to": True, "outcome": True, "policy": True,
    "action": True, "direction": True, "rung": True,
    "conditions": True, "incident": False, "requested": False,
}
_OUTCOMES = ("applied", "clamped", "refused", "noop")
_DIRECTIONS = ("escalate", "de-escalate", "adapt")


class ActuationLog:
    """Append-only JSONL writer with per-record durability."""

    def __init__(self, path: str):
        self.path = str(path)
        self.seq = 0
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def record(self, *, knob: str, frm: Any, to: Any, outcome: str,
               policy: str, action: str, direction: str,
               rung: int, conditions: List[str],
               incident: Optional[str] = None,
               requested: Any = None,
               ts: Optional[float] = None) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "schema": ACTUATION_SCHEMA,
            "ts": time.time() if ts is None else float(ts),
            "seq": self.seq,
            "knob": knob,
            "from": frm,
            "to": to,
            "outcome": outcome,
            "policy": policy,
            "action": action,
            "direction": direction,
            "rung": int(rung),
            "conditions": sorted(conditions),
        }
        if incident is not None:
            doc["incident"] = incident
        if requested is not None:
            doc["requested"] = requested
        self.seq += 1
        self._fh.write(json.dumps(doc, sort_keys=True) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())
        return doc

    def close(self) -> None:
        self._fh.close()


# -- replay -------------------------------------------------------------------

def validate_actuation(doc: Dict[str, Any]) -> List[str]:
    """Schema errors for one record ([] when clean)."""
    errs: List[str] = []
    if doc.get("schema") != ACTUATION_SCHEMA:
        errs.append(f"schema {doc.get('schema')!r} != {ACTUATION_SCHEMA!r}")
    for field, required in _FIELDS.items():
        if required and field not in doc:
            errs.append(f"missing field {field!r}")
    if doc.get("outcome") not in _OUTCOMES:
        errs.append(f"unknown outcome {doc.get('outcome')!r}")
    if doc.get("direction") not in _DIRECTIONS:
        errs.append(f"unknown direction {doc.get('direction')!r}")
    if not isinstance(doc.get("conditions"), list):
        errs.append("conditions is not a list")
    return errs


def read_actuations(path: str) -> Tuple[List[Dict[str, Any]], List[str]]:
    """All records plus a list of problems (parse/schema/sequence)."""
    records: List[Dict[str, Any]] = []
    problems: List[str] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.readlines()
    except OSError as exc:
        return [], [f"unreadable: {exc}"]
    prev_seq = -1
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except ValueError as exc:
            problems.append(f"line {i + 1}: bad json ({exc})")
            continue
        for err in validate_actuation(doc):
            problems.append(f"line {i + 1}: {err}")
        seq = doc.get("seq")
        if isinstance(seq, int):
            if seq <= prev_seq:
                problems.append(
                    f"line {i + 1}: seq {seq} not monotonic "
                    f"(prev {prev_seq})")
            prev_seq = seq
        records.append(doc)
    return records, problems


def actuation_report(path: str) -> Tuple[str, bool]:
    """Human-readable replay of an actuation log; ok=False on any
    schema/sequence problem (the ``doctor --actuations`` gate)."""
    records, problems = read_actuations(path)
    lines = [f"actuation log: {path}",
             f"  records: {len(records)}"]
    if records:
        t0 = records[0].get("ts", 0.0)
        by_knob: Dict[str, int] = {}
        refused = 0
        max_rung = 0
        for rec in records:
            by_knob[rec.get("knob", "?")] = \
                by_knob.get(rec.get("knob", "?"), 0) + 1
            if rec.get("outcome") == "refused":
                refused += 1
            if isinstance(rec.get("rung"), int):
                max_rung = max(max_rung, rec["rung"])
        lines.append(f"  knobs touched: "
                     + ", ".join(f"{k}={n}" for k, n
                                 in sorted(by_knob.items())))
        lines.append(f"  refused: {refused}   peak rung: {max_rung}")
        lines.append(f"  {'seq':>4} {'+t(s)':>8} {'knob':<16} "
                     f"{'from':>8} {'to':>8} {'outcome':<8} "
                     f"{'dir':<12} {'action':<24} conditions")
        for rec in records:
            conds = ",".join(rec.get("conditions", [])) or "-"
            inc = rec.get("incident")
            if inc:
                conds += f" [{inc}]"
            lines.append(
                f"  {rec.get('seq', '?'):>4} "
                f"{rec.get('ts', 0.0) - t0:>8.2f} "
                f"{str(rec.get('knob', '?')):<16} "
                f"{str(rec.get('from', '?')):>8} "
                f"{str(rec.get('to', '?')):>8} "
                f"{str(rec.get('outcome', '?')):<8} "
                f"{str(rec.get('direction', '?')):<12} "
                f"{str(rec.get('action', '?')):<24} {conds}")
    if problems:
        lines.append("  PROBLEMS:")
        for p in problems:
            lines.append(f"    {p}")
        lines.append("  actuation replay: FAIL")
        return "\n".join(lines), False
    lines.append("  actuation replay: ok")
    return "\n".join(lines), True
