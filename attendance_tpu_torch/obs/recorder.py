"""Flight recorder: a fixed-size ring of the last N per-batch records.

Counterpart of ``attendance_tpu/obs/recorder.py``. Answers "what
happened in the last second before it wedged", the question end-of-run
metrics cannot.

The hot path pays one dict construction and one slot store under a
mutex per batch; the ring never allocates after construction. Dumps are
triggered by SIGUSR1, by an unhandled exception in a run loop, or
explicitly — each writes one self-describing JSON document (atomic
rename, so a reader never sees a torn file).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger(__name__)

DEFAULT_RING = 256


class FlightRecorder:
    """Fixed-size ring buffer of per-batch record dicts."""

    def __init__(self, size: int = DEFAULT_RING):
        if size <= 0:
            raise ValueError("flight recorder size must be positive")
        self.size = size
        # REENTRANT: the SIGUSR1 handler runs on the main thread
        # between bytecodes and may interrupt record() while that same
        # thread holds the lock — a plain Lock would deadlock the
        # process at exactly the moment the operator asks for
        # forensics. Worst case under re-entry is one torn record in
        # the dump, which the dump exists to tolerate.
        self._lock = threading.RLock()
        self._buf: List[Optional[dict]] = [None] * size
        self._idx = 0
        self._total = 0

    def record(self, rec: dict) -> None:
        with self._lock:
            self._buf[self._idx] = rec
            self._idx = (self._idx + 1) % self.size
            self._total += 1

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    def snapshot(self) -> List[dict]:
        """Records oldest-to-newest (at most ``size`` of them)."""
        with self._lock:
            if self._total < self.size:
                return [r for r in self._buf[:self._idx]]
            return ([r for r in self._buf[self._idx:]]
                    + [r for r in self._buf[:self._idx]])

    def dump(self, path, reason: str = "manual") -> Path:
        """Write one JSON document (atomic rename) and return its path."""
        path = Path(path)
        doc = {
            "dumped_at_unix": time.time(),
            "reason": reason,
            "pid": os.getpid(),
            "ring_size": self.size,
            "total_records": self.total,
            "records": self.snapshot(),
        }
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        tmp.replace(path)
        return path


_NOT_INSTALLED = object()


def install_sigusr1(recorder: FlightRecorder, path):
    """Dump the ring to ``path`` on SIGUSR1. Returns the PREVIOUS
    handler (so the caller can restore it on teardown — a leaked
    handler would dump a stale ring to a stale path after telemetry
    is disabled), or the _NOT_INSTALLED sentinel off the main thread
    or on platforms without the signal — telemetry must degrade, not
    raise, in embedded/test contexts."""
    if not hasattr(signal, "SIGUSR1"):
        return _NOT_INSTALLED

    def _handler(signum, frame):
        try:
            p = recorder.dump(path, reason="SIGUSR1")
            logger.info("Flight recorder dumped to %s", p)
        except Exception:
            logger.exception("Flight recorder dump failed")

    try:
        return signal.signal(signal.SIGUSR1, _handler)
    except ValueError:  # not the main thread
        logger.warning("SIGUSR1 flight-dump handler not installed "
                       "(not on the main thread)")
        return _NOT_INSTALLED


def uninstall_sigusr1(previous) -> None:
    """Restore the handler ``install_sigusr1`` displaced (no-op for
    the sentinel, or off the main thread)."""
    if previous is _NOT_INSTALLED or not hasattr(signal, "SIGUSR1"):
        return
    try:
        signal.signal(signal.SIGUSR1,
                      previous if previous is not None else signal.SIG_DFL)
    except ValueError:
        pass
