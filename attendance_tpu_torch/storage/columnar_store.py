"""Columnar event store: the batched side-output of the fused path.

Counterpart of ``attendance_tpu/storage/columnar_store.py``
(``insert_columns``, ``to_columns``, ``scan_lecture``). Micro-batches are
appended as column blocks with no per-event Python. A block's
``is_valid`` may be a device tensor (the fused step's output) or, on
the seg/delta wires, a lazy view of one in packed order, so an insert
never waits for the device; it is copied to the host (and put back in
original order) when first read. The store is append-only and
deduplicates at read time, keeping the last row per primary key
(lecture_day, micros, student_id) as Cassandra's upsert would.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from attendance_tpu_torch.pipeline.events import lecture_to_day

_COLS = ("student_id", "lecture_day", "micros", "is_valid", "event_type")


def _host(col) -> np.ndarray:
    """A block's column on the host: a device tensor is copied, any other
    array-like (numpy, or the seg/delta wires' lazy validity view, which
    scatters its packed-order answer back to original order) goes
    through ``np.asarray``."""
    if isinstance(col, torch.Tensor):
        return col.cpu().numpy()
    return np.asarray(col)


class ColumnarEventStore:
    """Append-only columnar store keyed by the planar codec's columns."""

    def __init__(self):
        self._blocks: List[Dict[str, object]] = []
        self._lock = threading.Lock()

    def insert_columns(self, cols: Dict[str, object]) -> int:
        """Append one micro-batch. Arrays are referenced, not copied:
        callers must not mutate them afterwards."""
        with self._lock:
            self._blocks.append({name: cols[name] for name in _COLS})
        return len(cols["student_id"])

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

    def scan_lecture(self, lecture_day) -> Dict[str, np.ndarray]:
        """One lecture partition's deduped columns; ``lecture_day`` is an
        integer day code or a ``LECTURE_YYYYMMDD`` id."""
        if isinstance(lecture_day, str):
            lecture_day = lecture_to_day(lecture_day)
        cols = self.to_columns()
        sel = np.asarray(cols["lecture_day"], np.int64) == int(lecture_day)
        return {name: arr[sel] for name, arr in cols.items()}

    def close(self) -> None:
        pass
