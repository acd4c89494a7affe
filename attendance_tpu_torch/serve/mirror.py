"""Epoch-pinned read mirror: lock-free snapshot isolation for reads.

Counterpart of ``attendance_tpu/serve/mirror.py``. One
:class:`ReadMirror` sits between the writer and every reader (query
executors, the scrape-time health and audit gauges). The writer
publishes immutable :class:`Epoch` objects; the publish is one attribute
assignment (atomic under the GIL), and a reader pins an epoch by holding
the reference ``pin()`` returned: no unpin call, no reader registration,
nothing for the hot loop to wait on.

Register buffers are double-buffered: ``publish`` recycles the register
array of the previous-previous epoch when no reader still references
that epoch (checked by its refcount), so a steady barrier cadence
allocates nothing, while a reader that pins an old epoch across many
barriers only forces a fresh allocation, never a torn row.

The Bloom words are fixed between preloads (the fused hot loop never
adds to the filter), so epochs share one host words array by reference;
a new preload publishes a new array, and old epochs keep answering from
the roster they were published under.

With telemetry on, :func:`register_staleness_gauges` exports the current
epoch's age (``attendance_read_staleness_seconds``) and sequence number
(``attendance_read_epoch_seq``) for any epoch source.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, Optional

import numpy as np


class Epoch:
    """One immutable published read view. Readers treat every field as
    frozen; the mirror recycles only ``hll_regs`` buffers of epochs no
    reader references anymore."""

    __slots__ = ("seq", "published_at", "events", "bloom_words",
                 "hll_regs", "counts", "bank_of", "day_truth",
                 "roster_size", "params", "precision", "source")

    def __init__(self, *, seq: int, events: int,
                 bloom_words: Optional[np.ndarray], hll_regs: np.ndarray,
                 counts: Optional[np.ndarray], bank_of: Dict[int, int],
                 params, precision: int, roster_size: int = 0,
                 day_truth: Optional[Dict[int, float]] = None,
                 source: str = "live",
                 published_at: Optional[float] = None):
        self.seq = seq
        self.published_at = (time.time() if published_at is None
                             else published_at)
        self.events = events
        self.bloom_words = bloom_words
        self.hll_regs = hll_regs
        self.counts = counts
        self.bank_of = bank_of
        # The audit shadow's per-day truth at publish (None without an
        # auditor): the read audit compares an epoch's estimates with
        # the truth of the same moment. In memory only.
        self.day_truth = day_truth
        self.roster_size = roster_size
        self.params = params
        self.precision = precision
        self.source = source

    def age_s(self, now: Optional[float] = None) -> float:
        return (time.time() if now is None else now) - self.published_at


class ReadMirror:
    """The current epoch and the double-buffer recycler.

    ``pin()`` is the whole read side: one attribute load. Publishes are
    serialized by a small lock (the callers are the snapshot writer
    thread and cold paths, never the hot loop)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._current: Optional[Epoch] = None
        self._previous: Optional[Epoch] = None
        self._seq = 0

    # -- read side ---------------------------------------------------------------
    def pin(self) -> Optional[Epoch]:
        """The current epoch (None before the first publish). Holding the
        returned object IS the pin: its arrays stay valid for as long as
        the reference lives."""
        return self._current

    def staleness_s(self) -> float:
        """Age of the current epoch; NaN before the first publish (0.0
        would claim perfect freshness)."""
        e = self._current
        return float("nan") if e is None else e.age_s()

    # -- write side --------------------------------------------------------------
    def _recycled_regs(self, shape, dtype) -> np.ndarray:
        """A register buffer for the next epoch: the previous-previous
        epoch's array when provably unpinned, else a fresh one. When
        ``self._previous`` holds the only reference to that Epoch (the
        refcount sees ours, this local and getrefcount's argument) and
        the Epoch's slot the only one to its array, no reader can reach
        the array once we drop it, and overwriting it is invisible."""
        prev = self._previous
        if (prev is not None and prev.hll_regs.shape == shape
                and prev.hll_regs.dtype == dtype
                and sys.getrefcount(prev) == 3
                and sys.getrefcount(prev.hll_regs) == 2):
            return prev.hll_regs
        return np.empty(shape, dtype)

    def publish(self, *, regs: np.ndarray, events: int,
                bank_of: Dict[int, int], params, precision: int,
                bloom_words: Optional[np.ndarray] = None,
                counts: Optional[np.ndarray] = None,
                roster_size: Optional[int] = None,
                day_truth: Optional[Dict[int, float]] = None,
                source: str = "live") -> Epoch:
        """Publish the next epoch from the writer's host state.

        ``regs`` is the writer's private mirror, which later deltas
        mutate, so it is copied into a (usually recycled) read buffer.
        ``bloom_words``, ``counts`` and ``roster_size`` default to the
        previous epoch's; ``day_truth`` is the audit shadow's per-day
        truth of this moment (None without an auditor). ``source`` names
        the publisher ("live", or "federated" for the federation's
        aggregator)."""
        regs = np.asarray(regs, dtype=np.uint8)
        with self._lock:
            prev = self._current
            buf = self._recycled_regs(regs.shape, regs.dtype)
            np.copyto(buf, regs)
            if bloom_words is None and prev is not None:
                bloom_words = prev.bloom_words
            if counts is None and prev is not None:
                counts = prev.counts
            if roster_size is None:
                roster_size = prev.roster_size if prev is not None else 0
            self._seq += 1
            epoch = Epoch(
                seq=self._seq, events=events, bloom_words=bloom_words,
                hll_regs=buf,
                counts=None if counts is None else np.array(counts,
                                                            copy=True),
                bank_of=dict(bank_of), params=params, precision=precision,
                roster_size=int(roster_size),
                day_truth=None if day_truth is None else dict(day_truth),
                source=source)
            # Shift the double buffer: current -> previous (the recycle
            # candidate at the NEXT publish), previous dropped.
            self._previous = prev
            self._current = epoch  # the atomic pointer swap
            return epoch

    def register_gauges(self, telemetry) -> None:
        register_staleness_gauges(telemetry, self)


def register_staleness_gauges(telemetry, source) -> None:
    """Export ``attendance_read_staleness_seconds`` (the current epoch's
    age; NaN before the first publish) and the epoch sequence gauge for
    any epoch source (a ReadMirror or a chain reader). Idempotent:
    set_function replaces the callback."""
    telemetry.registry.gauge(
        "attendance_read_staleness_seconds",
        help="Age of the published read epoch (bounded by the "
        "snapshot barrier cadence; NaN before the first publish)"
    ).set_function(source.staleness_s)

    def seq() -> float:
        e = source.pin()
        return float(e.seq) if e is not None else 0.0

    telemetry.registry.gauge(
        "attendance_read_epoch_seq",
        help="Monotonic sequence number of the published read "
        "epoch").set_function(seq)
