"""In-process event store with Cassandra's upsert-by-primary-key
semantics (``--storage-backend memory``).

Counterpart of ``attendance_tpu/storage/memory_store.py``. Rows are keyed
by the reference table's primary key ``(lecture_id, timestamp,
student_id)``, so re-inserting a replayed batch is an overwrite that
changes nothing: the idempotence the at-least-once ack protocol relies
on.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Tuple


@dataclass(frozen=True)
class AttendanceRow:
    """One attendance event row (columns of the reference's table DDL)."""
    student_id: int
    timestamp: str
    lecture_id: str
    is_valid: bool
    event_type: str


_PK = Tuple[str, int]  # (timestamp, student_id) clustering key


class MemoryEventStore:
    def __init__(self):
        # partition (lecture_id) -> clustering key -> row, mirroring the
        # partition/clustering layout so per-lecture scans are O(partition).
        self._parts: Dict[str, Dict[_PK, AttendanceRow]] = {}
        self._lock = threading.Lock()

    # -- write path ---------------------------------------------------------
    def insert(self, row: AttendanceRow) -> None:
        self.insert_batch([row])

    def insert_batch(self, rows: Iterable[AttendanceRow]) -> int:
        """Upsert a batch of rows; returns rows written (incl. overwrites)."""
        n = 0
        with self._lock:
            for row in rows:
                part = self._parts.setdefault(row.lecture_id, {})
                part[(row.timestamp, row.student_id)] = row
                n += 1
        return n

    # -- read path (the analyzer/stats query contract) ----------------------
    def distinct_lecture_ids(self) -> List[str]:
        """SELECT DISTINCT lecture_id (reference attendance_analysis.py:22)."""
        with self._lock:
            return sorted(self._parts)

    def scan_lecture(self, lecture_id: str) -> List[AttendanceRow]:
        """Per-partition ordered scan (reference attendance_analysis.py:33-39,
        attendance_processor.py:155-160) — clustering order (timestamp,
        student_id) ascending, like the reference's table."""
        with self._lock:
            part = self._parts.get(lecture_id, {})
            return [part[k] for k in sorted(part)]

    def scan_student(self, student_id: int) -> List[AttendanceRow]:
        """Every row of one student, ordered (lecture_id, timestamp) —
        the per-student access pattern the reference's README promises
        via a second ``events_by_student_day`` table it never creates
        (README.md:124-148; SURVEY.md §0.3 item 3). Implemented as a
        filtered scan over the one real table, like the analyzer's own
        ALLOW FILTERING reads."""
        sid = int(student_id)
        return [r for r in self.scan_all() if r.student_id == sid]

    def scan_all(self) -> List[AttendanceRow]:
        """Full-table scan, partition by partition."""
        out: List[AttendanceRow] = []
        for lecture_id in self.distinct_lecture_ids():
            out.extend(self.scan_lecture(lecture_id))
        return out

    def count(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._parts.values())

    # -- durability (the store-side half of snapshot/restore) ---------------
    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            rows = [row.__dict__ for part in self._parts.values()
                    for row in part.values()]
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text("\n".join(json.dumps(r) for r in rows))
        tmp.replace(path)

    def load(self, path) -> int:
        text = Path(path).read_text()
        rows = [AttendanceRow(**json.loads(line))
                for line in text.splitlines() if line]
        return self.insert_batch(rows)

    def truncate(self) -> None:
        with self._lock:
            self._parts.clear()

    def close(self) -> None:
        pass
