"""Windowed HLL bank ring: (day, period) buckets over shared bank rows.

Counterpart of ``attendance_tpu/temporal/windows.py``. Pure host
bookkeeping: the device work (register max, row zeroing) happens
through the two callbacks the owning pipeline provides, against the
SAME ``uint8[num_banks, 2^p]`` register tensor the per-day banks live
in. A bucket is one bank row keyed by its
:func:`temporal.buckets.bucket_key`, riding the pipeline's ordinary
``bank_of`` map.

Lifecycle:

  * **open**: the bucket's period has not been passed by the
    watermark; events fold in (register max, order-free);
  * **rotated (closed)**: ``watermark >= (period+1) * T``: the bucket
    is immutable; late events targeting it are DROPPED to the side
    channel (counted, never misbucketed). Closed buckets stay
    queryable until ring pressure evicts them;
  * **evicted**: the ring holds at most ``capacity`` buckets; when a
    new bucket needs a row, the oldest CLOSED bucket is evicted: its
    bank row is zeroed on the device and returned to the pipeline's
    free-bank list, and its key leaves ``bank_of``. Open buckets are
    never evicted: the ring over-commits with a one-time warning
    instead of dropping live data.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Tuple

import numpy as np

from attendance_tpu_torch.temporal.buckets import (
    bucket_keys, decode_bucket_key, is_bucket_key)

logger = logging.getLogger(__name__)


class BucketRing:
    def __init__(self, period_us: int, capacity: int,
                 alloc_bank: Callable[[int], int],
                 free_buckets: Callable[[List[int], List[int]], None]):
        if capacity < 2:
            raise ValueError("temporal ring needs >= 2 bucket rows")
        self.period_us = int(period_us)
        self.capacity = int(capacity)
        self._alloc_bank = alloc_bank
        self._free_buckets = free_buckets
        self.buckets: Dict[int, int] = {}  # bucket key -> bank row
        self._first_open = 0  # periods below this are rotated/closed
        self.rotations_total = 0
        self.evictions_total = 0
        self._warned_overcommit = False

    # -- assignment ----------------------------------------------------------
    def assign(self, days: np.ndarray, micros: np.ndarray
               ) -> Tuple[np.ndarray, int, List[int]]:
        """Bank row per event (int32[B], -1 = dropped: the bucket had
        already rotated). Returns ``(banks, dropped, touched)``, where
        ``touched`` is the distinct bucket keys that received events.
        Allocation happens here; rotation is the caller's NEXT step, so
        events are judged against the pre-advance frontier."""
        periods = (np.asarray(micros, np.int64)
                   // np.int64(self.period_us))
        keys = bucket_keys(np.asarray(days, np.int64), periods)
        if not len(keys):
            return np.zeros(0, np.int32), 0, []
        uniq, inverse = np.unique(keys, return_inverse=True)
        lut = np.empty(len(uniq), np.int32)
        for i, key in enumerate(uniq.tolist()):
            _, period = decode_bucket_key(key)
            if period < self._first_open:
                # Rotated buckets are immutable, retained or not.
                lut[i] = -1
                continue
            bank = self.buckets.get(key)
            if bank is None:
                bank = self._allocate(key)
            lut[i] = bank
        banks = lut[inverse].astype(np.int32, copy=False)
        dropped = int(np.bincount(inverse)[lut < 0].sum())
        return banks, dropped, uniq[lut >= 0].tolist()

    def _allocate(self, key: int) -> int:
        if len(self.buckets) >= self.capacity:
            self._evict_one()
        bank = self._alloc_bank(key)
        self.buckets[key] = bank
        return bank

    def _evict_one(self) -> None:
        """Evict the oldest rotated bucket (period, then day order);
        over-commit with a warning when everything is still open."""
        oldest_key = None
        oldest = None
        for key in self.buckets:
            day, period = decode_bucket_key(key)
            if period >= self._first_open:
                continue
            rank = (period, day)
            if oldest is None or rank < oldest:
                oldest, oldest_key = rank, key
        if oldest_key is None:
            if not self._warned_overcommit:
                self._warned_overcommit = True
                logger.warning(
                    "temporal ring over capacity (%d buckets) with "
                    "every bucket still open: raise "
                    "--temporal-ring-banks or widen the period; open "
                    "buckets are never dropped", len(self.buckets))
            return
        bank = self.buckets.pop(oldest_key)
        self._free_buckets([oldest_key], [bank])
        self.evictions_total += 1

    # -- rotation ------------------------------------------------------------
    def rotate(self, watermark_us: int) -> int:
        """Advance the open frontier to the watermark; returns how
        many buckets rotated (open -> closed) at this boundary."""
        new_first = max(int(watermark_us) // self.period_us, 0)
        if new_first <= self._first_open:
            return 0
        n = sum(1 for key in self.buckets
                if self._first_open
                <= decode_bucket_key(key)[1] < new_first)
        self._first_open = new_first
        self.rotations_total += n
        return n

    @property
    def open_buckets(self) -> int:
        return sum(1 for key in self.buckets
                   if decode_bucket_key(key)[1] >= self._first_open)

    def __len__(self) -> int:
        return len(self.buckets)

    # -- restore -------------------------------------------------------------
    def restore(self, bank_of: Dict[int, int]) -> int:
        """Re-seed the ring from a restored ``bank_of`` map (every bucket
        key in it). Every restored bucket starts OPEN: the watermark is
        ephemeral and rebuilds from the redelivered stream, so a restart
        can only widen the fold window, never misbucket (register-max
        re-adds are idempotent). Returns the bucket count."""
        self.buckets = {int(k): int(b) for k, b in bank_of.items()
                        if is_bucket_key(int(k))}
        self._first_open = 0
        return len(self.buckets)
