"""Bounded watermark reorder stage at the codec seam.

Counterpart of ``attendance_tpu/temporal/reorder.py``. It sits between
frame decode and the ORDER-SENSITIVE temporal consumers (bucket
rotation, entry/exit dwell pairing, the CMS fold). The order-FREE
windowed HLL add bypasses it: its bucket is a pure function of the
event's own timestamp, so it rides the frame's own device dispatch and
the frame's ack, like the per-day banks.

Semantics (standard event-time streaming):

  * the **watermark** trails the maximum event time seen by
    ``allowed_lateness``: ``W = max_seen - lateness``;
  * events with ``t > W`` are **buffered**; once W advances past them
    they are **released in event-time order**;
  * events arriving with ``t <= W`` are stragglers: released at once
    (merged into this offer's sorted release) and flagged ``late``;
    the bucket ring decides folded (bucket still open) vs dropped;
  * an idle stream (``watermark_idle_s`` of wall-clock silence)
    advances W to ``max_seen``, flushing the buffer so final buckets
    close without waiting for traffic that will never come.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

_COLS = ("student_id", "lecture_day", "micros", "event_type")


def _take(cols: Dict[str, np.ndarray], idx: np.ndarray
          ) -> Dict[str, np.ndarray]:
    return {c: cols[c][idx] for c in _COLS}


def _concat(blocks: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if len(blocks) == 1:
        return blocks[0]
    return {c: np.concatenate([b[c] for b in blocks]) for c in _COLS}


class ReorderStage:
    """One consumer's bounded event-time reorder buffer."""

    def __init__(self, lateness_us: int, idle_s: float = 0.0):
        if lateness_us < 0:
            raise ValueError("allowed lateness must be >= 0")
        self.lateness_us = int(lateness_us)
        self.idle_s = float(idle_s)
        self.max_seen_us: int = -(1 << 62)
        self._pending: List[Dict[str, np.ndarray]] = []
        self._pending_events = 0
        self._last_event_mono = time.monotonic()
        self._advance_to_head = False
        self.last_arrival_late = np.zeros(0, bool)
        self.late_released_total = 0  # t <= W at arrival (stragglers)
        self.released_total = 0

    # -- state ---------------------------------------------------------------
    @property
    def watermark_us(self) -> int:
        return self.max_seen_us - self.lateness_us

    @property
    def buffered(self) -> int:
        return self._pending_events

    def watermark_lag_s(self) -> float:
        """How far the watermark trails (NaN before the first event):
        the event-time trail behind the stream head plus, while events
        sit buffered, the wall-clock seconds since traffic stopped."""
        if self.max_seen_us <= -(1 << 61):
            return float("nan")
        lag = (self.max_seen_us - self.effective_watermark_us) / 1e6
        if self._pending_events:
            lag += max(0.0,
                       time.monotonic() - self._last_event_mono)
        return lag

    # -- ingest --------------------------------------------------------------
    def arrival_late_mask(self, micros: np.ndarray) -> np.ndarray:
        """Per-event lateness AT ARRIVAL: event i is late iff it trails
        the stream head as of its own arrival (previous frames' max
        folded with the frame's running prefix max) by more than the
        allowed lateness."""
        micros = np.asarray(micros, np.int64)
        if not len(micros):
            return np.zeros(0, bool)
        prefix = np.maximum.accumulate(micros)
        head_before = np.empty(len(micros), np.int64)
        head_before[0] = self.max_seen_us
        np.maximum(prefix[:-1], np.int64(self.max_seen_us),
                   out=head_before[1:])
        return micros <= head_before - np.int64(self.lateness_us)

    def offer(self, cols: Dict[str, np.ndarray]
              ) -> Optional[Dict[str, np.ndarray]]:
        """Stage one decoded frame; returns the released block (sorted
        by event time, with a ``late`` bool column marking stragglers)
        or None when nothing crossed the watermark yet."""
        micros = np.asarray(cols["micros"], np.int64)
        late_mask = self.arrival_late_mask(micros)
        self.last_arrival_late = late_mask  # the plane's fold counter
        if len(micros):
            self._last_event_mono = time.monotonic()
            self.note_activity()  # traffic resumed post-flush
            frame_max = int(micros.max())
            if frame_max > self.max_seen_us:
                self.max_seen_us = frame_max
        wm = self.watermark_us
        n_late = int(late_mask.sum())
        hold_mask = ~late_mask
        block = {c: np.asarray(cols[c]) for c in _COLS}
        if n_late:
            # Stragglers release NOW; the rest buffers until W reaches it.
            straggler = _take(block, np.flatnonzero(late_mask))
            if hold_mask.any():
                self._stash(_take(block, np.flatnonzero(hold_mask)))
        else:
            straggler = None
            if len(micros):
                self._stash(block)
        ready = self._drain_ready(wm)
        if straggler is not None:
            self.late_released_total += n_late
            ready = ready + [straggler] if ready else [straggler]
            n_ready = sum(len(b["micros"]) for b in ready) - n_late
            late_col = np.zeros(n_ready + n_late, bool)
        elif ready:
            late_col = np.zeros(sum(len(b["micros"]) for b in ready),
                                bool)
        else:
            return None
        out = _concat(ready)
        if straggler is not None:
            # Mark the straggler lanes BEFORE the sort so the flag
            # travels with its events into event-time order.
            late_col[-len(straggler["micros"]):] = True
        order = np.argsort(out["micros"], kind="stable")
        out = _take(out, order)
        out["late"] = late_col[order]
        self.released_total += len(out["micros"])
        return out

    def _stash(self, block: Dict[str, np.ndarray]) -> None:
        # Own the bytes: buffered events outlive their frame.
        self._pending.append({c: np.array(block[c]) for c in _COLS})
        self._pending_events += len(block["micros"])

    def _drain_ready(self, wm: int) -> List[Dict[str, np.ndarray]]:
        if not self._pending or self._pending_events == 0:
            return []
        combined = _concat(self._pending)
        micros = combined["micros"]
        ready_mask = micros <= wm
        if not ready_mask.any():
            # Re-pack as the single combined block (bounds the list).
            self._pending = [combined]
            return []
        ready = _take(combined, np.flatnonzero(ready_mask))
        rest_idx = np.flatnonzero(~ready_mask)
        if len(rest_idx):
            self._pending = [_take(combined, rest_idx)]
            self._pending_events = len(rest_idx)
        else:
            self._pending = []
            self._pending_events = 0
        return [ready]

    # -- liveness ------------------------------------------------------------
    def idle_due(self) -> bool:
        """Has the stream been silent past ``watermark_idle_s`` with
        events still buffered? (0 disables idle advancement.)"""
        return (self.idle_s > 0 and self._pending_events > 0
                and time.monotonic() - self._last_event_mono
                >= self.idle_s)

    def flush(self) -> Optional[Dict[str, np.ndarray]]:
        """Advance the watermark to the stream head and release
        everything buffered (idle advancement / end of run)."""
        if self._pending_events == 0:
            return None
        combined = _concat(self._pending)
        self._pending = []
        self._pending_events = 0
        order = np.argsort(combined["micros"], kind="stable")
        out = _take(combined, order)
        out["late"] = np.zeros(len(out["micros"]), bool)
        self.released_total += len(out["micros"])
        # The watermark jumps to the head: buckets behind it may now
        # rotate (the ring reads effective_watermark_us after a flush).
        self.max_seen_us = max(self.max_seen_us,
                               int(out["micros"][-1]))
        self._advance_to_head = True
        return out

    @property
    def effective_watermark_us(self) -> int:
        """The watermark the bucket ring rotates against: normally
        ``max_seen - lateness``; after a flush the stream head itself,
        so final buckets can close."""
        if self._advance_to_head:
            return self.max_seen_us
        return self.watermark_us

    def note_activity(self) -> None:
        """New traffic after an idle flush: the watermark resumes
        trailing by the allowed lateness."""
        self._advance_to_head = False
