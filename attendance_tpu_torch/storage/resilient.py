"""Circuit-breaker event-store wrapper with a durable spill buffer.

Counterpart of ``attendance_tpu/storage/resilient.py``. Without it a
failing persist sink turns every fused frame into a failed frame and
nacks the processor's whole batches into a redelivery storm; with it
the sink gets the classic remediation:

* **closed**: writes flow to the inner store; ``failure_threshold``
  consecutive failures open the circuit.
* **open**: writes short-circuit into fsync'd spill files on disk (the
  hot path degrades to a local append instead of stalling or failing);
  after ``cooldown_s`` the next write is the half-open probe.
* **half-open**: one probe write goes to the sink, after the spill
  backlog drained IN ORDER (read-time last-write-wins dedup depends on
  append order); success closes the circuit, failure reopens it and
  restarts the cooldown.

Each spill file is one checksummed record (``utils.integrity.
wrap_record`` of a pickle), the JAX package's format, so either package
drains the other's spill. The spill is adopted at construction, so a
crash while the circuit is open loses nothing: the next process drains
the backlog once the sink heals. ``close()`` makes a bounded final
drain and otherwise leaves the files for the next run.

Exposes ``attendance_circuit_state{sink=}`` (0 closed, 1 open, 2
half-open), ``attendance_circuit_transitions_total{sink=,to=}``,
``attendance_persist_spilled_batches_total{sink=}`` and
``attendance_spill_corrupt_records_total{sink=,kind=}``.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from attendance_tpu_torch.utils.integrity import (
    IntegrityError, chaos_post_publish, unwrap_record, wrap_record)

logger = logging.getLogger(__name__)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


class CircuitBreaker:
    """State machine only — no I/O; the wrapper owns the spill."""

    def __init__(self, *, failure_threshold: int = 3,
                 cooldown_s: float = 1.0, clock=time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.opened_total = 0
        self._listeners: List = []

    def on_transition(self, fn) -> None:
        """fn(new_state) on every state change (gauge/counter hook)."""
        self._listeners.append(fn)

    def _set(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        if state == OPEN:
            self.opened_total += 1
            self._opened_at = self._clock()
        for fn in self._listeners:
            fn(state)

    def allow(self) -> bool:
        """May the next write attempt the real sink? Open flips to
        half-open (probe) once the cooldown elapsed."""
        if self.state == OPEN:
            if self._clock() - self._opened_at >= self.cooldown_s:
                self._set(HALF_OPEN)
                return True
            return False
        return True

    def record_success(self) -> None:
        self._failures = 0
        self._set(CLOSED)

    def record_failure(self) -> None:
        self._failures += 1
        if self.state == HALF_OPEN or \
                self._failures >= self.failure_threshold:
            self._set(OPEN)


class ResilientEventStore:
    """Breaker-guarded write surface over any event store. Reads and
    every other capability (``save_segments``, ``mark``, ``scan_*``,
    ...) delegate to the inner store untouched, so feature detection
    by the pipelines keeps answering for the real backend."""

    def __init__(self, inner, spill_dir, *, sink: str = "events",
                 breaker: Optional[CircuitBreaker] = None):
        self._inner = inner
        self._sink = sink
        self.spill_dir = Path(spill_dir)
        self.spill_dir.mkdir(parents=True, exist_ok=True)
        self.breaker = breaker or CircuitBreaker()
        self._lock = threading.RLock()
        # Adopt spill files a previous (crashed / still-degraded)
        # process left behind: they drain before any new write.
        self._pending: List[Path] = sorted(
            self.spill_dir.glob("spill-*.pkl"))
        self._seq = max((int(p.stem.split("-")[1])
                         for p in self._pending), default=0)
        self.spilled_total = 0
        self.drained_total = 0
        self._g_state = self._c_transitions = self._c_spilled = None
        from attendance_tpu_torch import obs
        t = obs.get()
        if t is not None:
            self._g_state = t.registry.gauge(
                "attendance_circuit_state",
                help="Persist-sink circuit state "
                     "(0 closed, 1 open, 2 half-open)", sink=sink)
            self._g_state.set(_STATE_CODE[self.breaker.state])
            self._c_spilled = t.registry.counter(
                "attendance_persist_spilled_batches_total",
                help="Batches diverted to the on-disk spill buffer",
                sink=sink)
            reg = t.registry
            trans = {
                to: reg.counter(
                    "attendance_circuit_transitions_total",
                    help="Circuit-breaker state transitions",
                    sink=sink, to=to)
                for to in (CLOSED, OPEN, HALF_OPEN)}
            self._c_transitions = trans
        self.breaker.on_transition(self._note_transition)
        if self._pending:
            logger.warning(
                "adopted %d spilled batch(es) from %s; they drain "
                "once the %s sink accepts writes",
                len(self._pending), self.spill_dir, sink)

    # -- state plumbing ------------------------------------------------------
    def _note_transition(self, state: str) -> None:
        logger.warning("persist circuit %r -> %s", self._sink, state)
        if self._g_state is not None:
            self._g_state.set(_STATE_CODE[state])
        if self._c_transitions is not None:
            self._c_transitions[state].inc()

    @property
    def spill_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- spill I/O -----------------------------------------------------------
    @staticmethod
    def _materialize(kind: str, payload):
        """Make a batch picklable: columns on the card (the fused step's
        validity, or the seg/delta wires' lazy view of it) are copied to
        host numpy on the calling thread's stream, which waits for the
        step. Acceptable on the degraded path; the healthy path never
        comes here."""
        if kind == "columns":
            return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v)) for k, v in payload.items()}
        return list(payload)

    def _spill(self, kind: str, payload) -> None:
        self._seq += 1
        path = self.spill_dir / f"spill-{self._seq:06d}.pkl"
        blob = pickle.dumps(
            {"kind": kind, "data": self._materialize(kind, payload)},
            protocol=pickle.HIGHEST_PROTOCOL)
        # Per-record checksum header (utils/integrity): the drain
        # verifies before unpickling, so a record storage rot mangled
        # is dropped loudly (redelivery covers its frames) instead of
        # unpickling garbage into the sink. (No injected ENOSPC here:
        # the spill IS the degraded path — full-disk chaos targets the
        # snapshot writer seam, which has a remediation ladder.)
        with open(path, "wb") as f:
            f.write(wrap_record(blob))
            f.flush()
            os.fsync(f.fileno())
        chaos_post_publish("disk.spill", path)
        self._pending.append(path)
        self.spilled_total += 1
        if self._c_spilled is not None:
            self._c_spilled.inc()

    def _apply(self, kind: str, payload) -> None:
        if kind == "columns":
            self._inner.insert_columns(payload)
        else:
            self._inner.insert_batch(payload)

    def _drain_locked(self) -> None:
        """Replay the spill backlog into the sink IN ORDER; raises on
        the first failure (the failed file stays pending)."""
        while self._pending:
            path = self._pending[0]
            try:
                payload, verified = unwrap_record(path.read_bytes())
                blob = pickle.loads(payload)
            except (OSError, pickle.UnpicklingError, EOFError,
                    IntegrityError) as exc:
                # A torn or rotted spill record (crash mid-write, or
                # storage rot the checksum header caught): its batch
                # was never acked against the broker, so redelivery
                # covers it — drop the file loudly rather than
                # wedging the drain or replaying mangled rows.
                logger.exception("dropping unreadable spill file %s",
                                 path)
                self._count_corrupt_record(
                    "digest_mismatch" if isinstance(exc, IntegrityError)
                    else "unreadable")
                self._pending.pop(0)
                path.unlink(missing_ok=True)
                continue
            self._apply(blob["kind"], blob["data"])
            self._pending.pop(0)
            self.drained_total += 1
            path.unlink(missing_ok=True)

    def _count_corrupt_record(self, kind: str) -> None:
        from attendance_tpu_torch import obs
        t = obs.get()
        if t is not None:
            t.registry.counter(
                "attendance_spill_corrupt_records_total",
                help="Spill records dropped at drain for failed "
                     "integrity verification (frames redeliver)",
                sink=self._sink, kind=kind).inc()

    # -- breaker-guarded write surface ---------------------------------------
    def _write(self, kind: str, payload) -> None:
        with self._lock:
            if self.breaker.allow():
                try:
                    self._drain_locked()  # order before the new batch
                    self._apply(kind, payload)
                    self.breaker.record_success()
                    return
                except Exception:
                    self.breaker.record_failure()
                    logger.exception(
                        "persist sink %r write failed (circuit %s)",
                        self._sink, self.breaker.state)
            self._spill(kind, payload)

    def insert_columns(self, cols) -> None:
        self._write("columns", cols)

    def insert_batch(self, rows) -> None:
        self._write("rows", rows)

    def flush_spill(self, *, budget_s: float = 10.0,
                    probe_interval_s: float = 0.05) -> bool:
        """Bounded best-effort drain (shutdown / pre-query): probes at
        a FIXED short cadence until the backlog is empty or the budget
        runs out (the breaker's cooldown still paces real sink
        attempts; an exponential backoff here would waste most of a
        hard budget sleeping while the sink sits healthy — observed
        stranding batches under chaos soak). Partial progress persists:
        every probe drains files until its first failure. Returns True
        when fully drained."""
        deadline = time.monotonic() + budget_s
        while True:
            with self._lock:
                if not self._pending:
                    return True
                if self.breaker.allow():
                    try:
                        self._drain_locked()
                        self.breaker.record_success()
                        return True
                    except Exception:
                        self.breaker.record_failure()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                logger.error(
                    "%d spilled batch(es) remain in %s after the "
                    "drain budget; they persist on disk for the next "
                    "run", self.spill_pending, self.spill_dir)
                return False
            time.sleep(min(probe_interval_s, remaining))

    def close(self) -> None:
        self.flush_spill()
        self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)
