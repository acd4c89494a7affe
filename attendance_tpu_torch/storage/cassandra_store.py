"""Real Cassandra event store (``--storage-backend cassandra``,
import-gated).

Counterpart of ``attendance_tpu/storage/cassandra_store.py``: an adapter
over cassandra-driver with the reference's keyspace, ``attendance``
table, per-event INSERT columns, ``SELECT DISTINCT lecture_id`` and the
per-lecture scan; only imported when selected. Batched writes use
concurrent async INSERTs. As in the reference's table, ``event_type`` is
not persisted: scans return rows with event_type "entry".
"""

from __future__ import annotations

from datetime import datetime
from typing import Iterable, List

from attendance_tpu_torch.storage.memory_store import AttendanceRow

try:
    from cassandra.cluster import Cluster
    HAVE_CASSANDRA = True
except ImportError:  # pragma: no cover - environment without the driver
    Cluster = None
    HAVE_CASSANDRA = False

_CONCURRENCY = 128  # in-flight async INSERTs per batch


class CassandraEventStore:
    def __init__(self, config):
        if not HAVE_CASSANDRA:
            raise RuntimeError(
                "storage_backend='cassandra' requires cassandra-driver")
        self.keyspace = config.cassandra_keyspace
        self.cluster = Cluster(list(config.cassandra_hosts))
        self.session = self.cluster.connect()
        self._setup()
        self._insert_stmt = self.session.prepare(
            "INSERT INTO attendance (student_id, lecture_id, timestamp, "
            "is_valid) VALUES (?, ?, ?, ?)")

    def _setup(self) -> None:
        self.session.execute(
            f"CREATE KEYSPACE IF NOT EXISTS {self.keyspace} WITH "
            "replication = {'class': 'SimpleStrategy', "
            "'replication_factor': 1}")
        self.session.set_keyspace(self.keyspace)
        self.session.execute(
            "CREATE TABLE IF NOT EXISTS attendance ("
            " student_id int, lecture_id text, timestamp timestamp,"
            " is_valid boolean,"
            " PRIMARY KEY ((lecture_id), timestamp, student_id))")

    # -- write path ---------------------------------------------------------
    def insert(self, row: AttendanceRow) -> None:
        self.insert_batch([row])

    def insert_batch(self, rows: Iterable[AttendanceRow]) -> int:
        rows = list(rows)
        futures = []
        for row in rows:
            ts = datetime.fromisoformat(row.timestamp)
            futures.append(self.session.execute_async(
                self._insert_stmt,
                (row.student_id, row.lecture_id, ts, row.is_valid)))
            if len(futures) >= _CONCURRENCY:
                for f in futures:
                    f.result()
                futures.clear()
        for f in futures:
            f.result()
        return len(rows)

    # -- read path ----------------------------------------------------------
    def distinct_lecture_ids(self) -> List[str]:
        rows = self.session.execute(
            "SELECT DISTINCT lecture_id FROM attendance")
        return sorted(r.lecture_id for r in rows)

    def scan_lecture(self, lecture_id: str) -> List[AttendanceRow]:
        rows = self.session.execute(
            "SELECT student_id, lecture_id, timestamp, is_valid "
            "FROM attendance WHERE lecture_id = %s ALLOW FILTERING",
            (lecture_id,))
        return [AttendanceRow(student_id=r.student_id,
                              timestamp=r.timestamp.isoformat(),
                              lecture_id=r.lecture_id,
                              is_valid=r.is_valid,
                              event_type="entry")
                for r in rows]

    def scan_student(self, student_id: int) -> List[AttendanceRow]:
        """Per-student filtered scan — the access pattern of the
        README-promised ``events_by_student_day`` table
        (README.md:124-148), served from the one real table with the
        same ALLOW FILTERING the analyzer's reads use
        (attendance_analysis.py:33-39)."""
        rows = self.session.execute(
            "SELECT student_id, lecture_id, timestamp, is_valid "
            "FROM attendance WHERE student_id = %s ALLOW FILTERING",
            (int(student_id),))
        return sorted(
            (AttendanceRow(student_id=r.student_id,
                           timestamp=r.timestamp.isoformat(),
                           lecture_id=r.lecture_id,
                           is_valid=r.is_valid,
                           event_type="entry")
             for r in rows),
            key=lambda r: (r.lecture_id, r.timestamp))

    def scan_all(self) -> List[AttendanceRow]:
        out: List[AttendanceRow] = []
        for lecture_id in self.distinct_lecture_ids():
            out.extend(self.scan_lecture(lecture_id))
        return out

    def count(self) -> int:
        row = self.session.execute("SELECT COUNT(*) FROM attendance").one()
        return int(row[0])

    def truncate(self) -> None:
        self.session.execute("TRUNCATE attendance")

    def close(self) -> None:
        self.cluster.shutdown()
