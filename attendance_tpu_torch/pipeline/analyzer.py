"""Batch analytics: the reference's five insights, computed columnar.

Counterpart of ``attendance_tpu/pipeline/analyzer.py``, over the
columnar store and the row stores.

The reference materializes every event into a pandas DataFrame and runs
five row-oriented groupbys (reference attendance_analysis.py:19-118).
At north-star event volumes that row reconstruction is the bottleneck,
so this analyzer keeps events as flat numpy column vectors end to end —
the same layout the fused device path produces (`ColumnarEventStore
.to_columns`) — and every insight reduces to a factorize + run-length
count over one vector:

  ``groupby(key).size()``  ->  ``np.unique(key, return_counts=True)``

Calendar features come straight from epoch-microsecond arithmetic
(hour = micros/3.6e9 mod 24; weekday = epoch-days + Thursday offset),
never from per-row datetime objects. Group cardinalities here (students,
lectures, weekdays) are tiny next to event counts, so the O(n log n)
host factorize is bandwidth-bound and cheaper than a device round-trip;
the event-rate-critical sketch math already runs on the card.

Insight contract (titles, descriptions, thresholds, console format) is
byte-compatible with reference attendance_analysis.py:65-142:

  1. habitual latecomers   — hour >= 9 events, above-median count/student
  2. attendance by day-of-week
  3. lecture rankings      — top-3 / bottom-3 by event count
  4. consistency           — count > median + sample-std per student
  5. invalid attempts per student
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

LATE_THRESHOLD_HOUR = 9  # 9 AM, reference attendance_analysis.py:67

_DAY_NAMES = np.array(["Monday", "Tuesday", "Wednesday", "Thursday",
                       "Friday", "Saturday", "Sunday"])
_MICROS_PER_HOUR = 3_600_000_000
_MICROS_PER_DAY = 24 * _MICROS_PER_HOUR
_EPOCH_WEEKDAY = 3  # 1970-01-01 was a Thursday (Monday == 0)


def _group_sizes(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``groupby(key).size()`` over one flat vector.

    Integer keys with a bounded value range (student ids, day codes —
    always true for the binary event schema) count via one bincount
    pass instead of np.unique's O(n log n) sort (~2x at 50M keys,
    measured). The sort path remains for strings/huge ranges."""
    if keys.size == 0:
        return keys[:0], np.zeros(0, np.int64)
    if np.issubdtype(keys.dtype, np.integer):
        lo, hi = int(keys.min()), int(keys.max())
        span = hi - lo + 1
        # Dense-enough ranges only: the count array must not dwarf the
        # data (span cap ~16M = 128MB of int64 counts).
        if span <= max(4 * keys.size, 1 << 20) and span <= 1 << 24:
            # Widen before offsetting: `keys - lo` in a narrow dtype
            # (int16 etc.) can wrap negative and crash bincount.
            counts = np.bincount(keys.astype(np.intp) - lo,
                                 minlength=span)
            nz = np.flatnonzero(counts)
            return (nz + lo).astype(keys.dtype), counts[nz]
    return np.unique(keys, return_counts=True)


def _size_dict(keys: np.ndarray, counts: np.ndarray) -> Dict:
    return {k: int(c) for k, c in zip(keys.tolist(), counts.tolist())}


def format_insights(insights: List[Dict]) -> str:
    """Render insights to the reference's console format (one string)."""
    if not insights:
        return "\nNo insights available - no attendance data found."
    lines: List[str] = []
    for ins in insights:
        lines += ["", f"=== {ins['title']} ===", ins["description"], "Data:"]
        data = ins.get("data")
        if isinstance(data, dict) and data:
            for key, value in data.items():
                if isinstance(value, dict):
                    lines += ["", f"{key}:"]
                    lines += [f"  {k}: {v}" for k, v in value.items()]
                else:
                    lines.append(f"{key}: {value}")
        else:
            lines.append("No data available")
        lines.append("-" * 50)
    return "\n".join(lines)


class AttendanceAnalyzer:
    """Five-insight batch report over any event store.

    Columnar stores are read through ``to_columns``; row stores (the
    Cassandra-semantics ``scan_all``) are transposed into the same
    vectors once, then share the aggregation path.
    """

    def __init__(self, event_store):
        self.store = event_store

    # -- column extraction ---------------------------------------------------
    def _columns(self) -> Optional[Dict[str, np.ndarray]]:
        """Events as {student_id, micros, is_valid} int64/bool vectors
        plus a lecture axis: integer ``lecture_day`` codes (columnar
        store) or string labels (row stores)."""
        if hasattr(self.store, "to_columns"):
            cols = self.store.to_columns()
            if len(cols["student_id"]) == 0:
                return None
            return {
                "student_id": np.asarray(cols["student_id"], np.int64),
                "lecture_day": np.asarray(cols["lecture_day"], np.int64),
                "micros": np.asarray(cols["micros"], np.int64),
                "is_valid": np.asarray(cols["is_valid"], bool),
            }
        rows = self.store.scan_all()
        if not rows:
            return None
        ts = np.array([r.timestamp for r in rows], dtype="datetime64[us]")
        return {
            "student_id": np.array([r.student_id for r in rows], np.int64),
            "lecture_id": np.array([r.lecture_id for r in rows]),
            "micros": ts.astype(np.int64),
            "is_valid": np.array([r.is_valid for r in rows], bool),
        }

    # -- the five insights ---------------------------------------------------
    def _latecomers(self, student_id, micros) -> Dict:
        hour = (micros // _MICROS_PER_HOUR) % 24
        students, counts = _group_sizes(
            student_id[hour >= LATE_THRESHOLD_HOUR])
        keep = (counts > np.median(counts) if counts.size
                else np.zeros(0, bool))
        return {
            "title": "Habitual Latecomers",
            "description": (
                f"Found {int(keep.sum())} students who frequently arrive "
                f"after {LATE_THRESHOLD_HOUR}:00 AM"),
            "data": _size_dict(students[keep], counts[keep]),
        }

    def _day_of_week(self, micros) -> Dict:
        weekday = ((micros // _MICROS_PER_DAY) + _EPOCH_WEEKDAY) % 7
        # Count the 7 integer codes, then label + alphabetize the handful
        # of groups — never an n-length string array.
        codes, counts = _group_sizes(weekday)
        names = _DAY_NAMES[codes]
        order = np.argsort(names)
        names, counts = names[order], counts[order]
        return {
            "title": "Attendance by Day",
            "description": "Distribution of attendance across different days",
            "data": _size_dict(names, counts),
        }

    def _lecture_rankings(self, cols) -> Dict:
        key = (cols["lecture_id"] if "lecture_id" in cols
               else cols["lecture_day"])
        lectures, counts = _group_sizes(key)
        # Descending count; ties break toward the smaller key (keys come
        # sorted ascending).
        order = np.lexsort((np.arange(counts.size), -counts))
        if "lecture_id" in cols:
            labels = [str(k) for k in lectures[order].tolist()]
        else:
            labels = [f"LECTURE_{day}" for day in lectures[order].tolist()]
        ranked = list(zip(labels, counts[order].tolist()))
        return {
            "title": "Lecture Attendance Rankings",
            "description": "Most and least attended lectures",
            "data": {
                "most_attended": {k: int(c) for k, c in ranked[:3]},
                "least_attended": {k: int(c) for k, c in ranked[-3:]},
            },
        }

    def _consistency(self, student_id) -> Dict:
        students, counts = _group_sizes(student_id)
        if counts.size >= 2:  # sample std undefined below 2 groups
            keep = counts > np.median(counts) + np.std(counts, ddof=1)
        else:
            keep = np.zeros(counts.size, bool)
        return {
            "title": "Most Consistent Attendees",
            "description": "Students with above-average attendance",
            "data": _size_dict(students[keep], counts[keep]),
        }

    def _invalid_attempts(self, student_id, is_valid) -> Dict:
        students, counts = _group_sizes(student_id[~is_valid])
        return {
            "title": "Invalid Attendance Attempts",
            "description": "Number of invalid attendance attempts by "
                           "student ID",
            "data": _size_dict(students, counts),
        }

    # -- public API (reference attendance_analysis.py:54-146) ---------------
    def generate_insights(self) -> List[Dict]:
        logger.info("Generating attendance insights...")
        cols = self._columns()
        if cols is None:
            logger.warning("No attendance data found")
            return []
        return [
            self._latecomers(cols["student_id"], cols["micros"]),
            self._day_of_week(cols["micros"]),
            self._lecture_rankings(cols),
            self._consistency(cols["student_id"]),
            self._invalid_attempts(cols["student_id"], cols["is_valid"]),
        ]

    def print_insights(self, insights: List[Dict]) -> None:
        print(format_insights(insights))

    def cleanup(self) -> None:
        self.store.close()
