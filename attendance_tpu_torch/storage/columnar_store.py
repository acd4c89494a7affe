"""Columnar event store: the batched side-output of the fused path.

Counterpart of ``attendance_tpu/storage/columnar_store.py`` without the
memoized compaction and the DataFrame view. Micro-batches are appended as column blocks with no
per-event Python. A block's ``is_valid`` may be a device tensor (the
fused step's output) or, on the seg/delta wires, a lazy view of one in
packed order, so an insert never waits for the device; it is copied to
the host (and put back in original order) when first read. The store is
append-only and deduplicates at read time, keeping the last row per
primary key (lecture_day, micros, student_id) as Cassandra's upsert
would: with the native host runtime by its hash upsert
(``atp_dedup_last``), with ``ATP_NATIVE=0`` by a numpy lexsort.

Durability: :meth:`save_segments` writes the blocks appended since the
last call as one numbered segment file, :meth:`load_segments` reads them
back in order and :meth:`compact_segments` merges them; the files are
the JAX package's (npz, one array per column), so each package loads
the other's.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from attendance_tpu_torch.native import load as load_native
from attendance_tpu_torch.pipeline.events import (
    columns_from_events, lecture_to_day)
from attendance_tpu_torch.utils.snapshot import fsync_dir

_COLS = ("student_id", "lecture_day", "micros", "is_valid", "event_type")


def _host(col) -> np.ndarray:
    """A block's column on the host: a device tensor is copied (on the
    calling thread's current stream), any other array-like (numpy, or
    the seg/delta wires' lazy validity view, which scatters its
    packed-order answer back to original order) goes through
    ``np.asarray``."""
    if isinstance(col, torch.Tensor):
        return col.cpu().numpy()
    return np.asarray(col)


class ColumnarEventStore:
    """Append-only columnar store keyed by the planar codec's columns."""

    def __init__(self):
        self._blocks: List[Dict[str, object]] = []
        self._lock = threading.Lock()
        # save_segments watermark: blocks below this index are durable
        # in a segment file. The sequence number is never reset (not
        # even by truncate), so segment names stay unique in a
        # directory.
        self._saved_blocks = 0
        self._segment_seq = 0
        # The lecture-id strings of day codes inserted through the row
        # adapter, so distinct_lecture_ids() returns the exact ids other
        # layers keyed on (the processor's HLL keys).
        self._lid_of_day: Dict[int, str] = {}

    # -- write path ----------------------------------------------------------
    def insert_columns(self, cols: Dict[str, object]) -> int:
        """Append one micro-batch. Arrays are referenced, not copied:
        callers must not mutate them afterwards."""
        with self._lock:
            self._blocks.append({name: cols[name] for name in _COLS})
        return len(cols["student_id"])

    # -- read path -----------------------------------------------------------
    def to_columns(self, deduplicate: bool = True) -> Dict[str, np.ndarray]:
        """All blocks as flat host column vectors, optionally deduped."""
        with self._lock:
            blocks = list(self._blocks)
        if not blocks:
            return {name: np.zeros(0, np.int64) for name in _COLS}
        for block in blocks:
            # Device validity is copied to the host once, in place, so
            # later reads do not fetch it again.
            block["is_valid"] = _host(block["is_valid"])
        cols = {name: np.concatenate([_host(b[name]) for b in blocks])
                for name in _COLS}
        if deduplicate:
            keep = self._dedup_keep(cols)
            cols = {name: arr[keep] for name, arr in cols.items()}
        return cols

    @staticmethod
    def _dedup_keep(cols: Dict[str, np.ndarray]) -> np.ndarray:
        """Indices of the last row per primary key, ascending."""
        nat = load_native()
        if nat is not None:
            # Day codes and student ids fit uint32; micros stays int64.
            return nat.dedup_last(cols["lecture_day"], cols["student_id"],
                                  cols["micros"])
        n = len(cols["student_id"])
        order = np.lexsort((np.arange(n), cols["student_id"],
                            cols["micros"], cols["lecture_day"]))
        day = cols["lecture_day"][order]
        mic = cols["micros"][order]
        sid = cols["student_id"][order]
        last = np.ones(n, bool)
        last[:-1] = ((day[1:] != day[:-1]) | (mic[1:] != mic[:-1])
                     | (sid[1:] != sid[:-1]))
        return np.sort(order[last])  # original append order

    def count(self) -> int:
        """Distinct primary keys (post-dedup)."""
        return len(self.to_columns()["student_id"])

    def distinct_lecture_days(self) -> List[int]:
        days = self.to_columns(deduplicate=False)["lecture_day"]
        return np.unique(np.asarray(days, np.int64)).tolist()

    def distinct_lecture_ids(self) -> List[str]:
        """Lecture ids of the stored day codes: an id inserted through
        the row adapter comes back exactly (a hashed day code maps back
        to its string); a planar-wire day reads ``LECTURE_<day>``."""
        with self._lock:
            lid_of_day = dict(self._lid_of_day)
        return [lid_of_day.get(day, f"LECTURE_{day}")
                for day in self.distinct_lecture_days()]

    def scan_lecture(self, lecture_day) -> Dict[str, np.ndarray]:
        """One lecture partition's deduped columns; ``lecture_day`` is an
        integer day code or a ``LECTURE_YYYYMMDD`` id."""
        if isinstance(lecture_day, str):
            lecture_day = lecture_to_day(lecture_day)
        cols = self.to_columns()
        sel = np.asarray(cols["lecture_day"], np.int64) == int(lecture_day)
        return {name: arr[sel] for name, arr in cols.items()}

    def scan_student(self, student_id: int) -> Dict[str, np.ndarray]:
        """One student's deduped columns across every lecture."""
        cols = self.to_columns()
        sel = np.asarray(cols["student_id"], np.int64) == int(student_id)
        return {name: arr[sel] for name, arr in cols.items()}

    # -- row-store interface adapters -----------------------------------------
    # The processor and the CLI speak the row stores' vocabulary
    # (insert_batch of AttendanceRow, string lecture ids).
    def insert_batch(self, rows) -> int:
        """Append AttendanceRow-shaped objects as one column block."""
        if not rows:
            return 0
        with self._lock:
            for lid in {r.lecture_id for r in rows}:
                self._lid_of_day.setdefault(lecture_to_day(lid), lid)
        return self.insert_columns(columns_from_events(rows))

    # -- durability ----------------------------------------------------------
    def mark(self) -> int:
        """The block count now: a barrier's consistent point, passed as
        ``upto`` to :meth:`save_segments` so a background writer
        persists exactly the blocks that existed at the barrier."""
        with self._lock:
            return len(self._blocks)

    def save_segments(self, dir_path, upto: Optional[int] = None) -> int:
        """Write the blocks appended since the previous call (up to
        ``upto``) as one numbered segment file (atomic rename); returns
        rows written. A restore that loads every segment in order
        reproduces the append stream, and rows of frames replayed after
        a crash fold in through the read-time dedup.

        The file is fsynced before its rename and the directory after
        it, so the segment is durable before the caller publishes the
        snapshot that acks its frames (the JAX package fsyncs neither).
        The watermark and the sequence number advance only once the
        file is published, so a failed write leaves its blocks pending
        for the next call (the JAX package advances them first, which
        drops such blocks from every later segment). Device validity in
        the blocks is copied to the host on the calling thread's current
        stream, in place. One writer at a time: the caller serializes
        calls."""
        dir_path = Path(dir_path)
        dir_path.mkdir(parents=True, exist_ok=True)
        with self._lock:
            end = len(self._blocks) if upto is None else upto
            pending = self._blocks[self._saved_blocks:end]
            seq = self._segment_seq + 1
        if not pending:
            return 0
        for block in pending:
            for name in _COLS:
                block[name] = _host(block[name])
        cols = {name: np.concatenate([b[name] for b in pending])
                for name in _COLS}
        path = dir_path / f"segment-{seq:08d}.npz"
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **cols)
            f.flush()
            os.fsync(f.fileno())
        tmp.replace(path)
        # The directory too: the caller's manifest rename, fsynced
        # after this, is what lets the frames be acked.
        fsync_dir(dir_path)
        with self._lock:
            self._saved_blocks = end
            self._segment_seq = seq
        return len(cols["student_id"])

    def load_segments(self, dir_path) -> int:
        """Load every segment file in write order; returns rows loaded.
        The restored blocks count as durable, and the sequence resumes
        past the highest segment on disk."""
        dir_path = Path(dir_path)
        if not dir_path.is_dir():
            return 0
        total = 0
        last_seq = 0
        for path in sorted(dir_path.glob("segment-*.npz")):
            total += self.load(path)
            last_seq = max(last_seq, int(path.stem.split("-")[1]))
        with self._lock:
            self._saved_blocks = len(self._blocks)
            self._segment_seq = max(self._segment_seq, last_seq)
        return total

    def compact_segments(self, dir_path, min_segments: int = 8) -> int:
        """Merge every segment into ONE deduped file and delete the
        originals (no-op below ``min_segments``); returns segments
        merged. The merged file is fsynced and renamed into place
        (numbered after the highest existing segment) and the directory
        fsynced before any original is unlinked; a crash in between
        leaves overlapping rows that the dedup folds. Not to run
        concurrently with :meth:`save_segments`."""
        dir_path = Path(dir_path)
        paths = sorted(dir_path.glob("segment-*.npz"))
        if len(paths) < max(min_segments, 2):
            return 0
        merged: Dict[str, List[np.ndarray]] = {n: [] for n in _COLS}
        for p in paths:
            with np.load(p) as data:
                for name in _COLS:
                    merged[name].append(data[name])
        cols = {name: np.concatenate(arrs) for name, arrs in merged.items()}
        keep = self._dedup_keep(cols)
        cols = {name: arr[keep] for name, arr in cols.items()}
        last_seq = int(paths[-1].stem.split("-")[1])
        out = dir_path / f"segment-{last_seq + 1:08d}.npz"
        tmp = out.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **cols)
            f.flush()
            os.fsync(f.fileno())
        tmp.replace(out)
        fsync_dir(dir_path)
        for p in paths:
            p.unlink()
        with self._lock:
            self._segment_seq = max(self._segment_seq, last_seq + 1)
        return len(paths)

    def save(self, path) -> None:
        """The deduped store as one compressed npz (atomic rename)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        cols = self.to_columns()
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **cols)
        tmp.replace(path)

    def load(self, path) -> int:
        with np.load(Path(path)) as data:
            cols = {c: data[c] for c in _COLS}
        return self.insert_columns(cols)

    def truncate(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._lid_of_day.clear()
            self._saved_blocks = 0  # _segment_seq stays monotonic

    def close(self) -> None:
        pass
