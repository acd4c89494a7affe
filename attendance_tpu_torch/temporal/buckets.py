"""Bucket-key encoding: (lecture day, time period) -> one int bank key.

Counterpart of ``attendance_tpu/temporal/buckets.py`` (the same layout,
so bucket keys, and with them ``bank_of`` maps, agree across the two
packages). A bucket is addressed by ONE integer that can never collide
with a real lecture-day key (calendar ``yyyymmdd`` < 10^8; hashed
lecture ids < 10^8 + 2^26), fits int64, and decodes back to
(day, period) without a side table.

Layout (63 bits):  1 << 62  |  period << 28  |  day

  * day: 28 bits, covering calendar yyyymmdd AND the hashed-lecture
    space (< 2^28);
  * period: 34 bits, ``micros // (period_s * 1e6)``; at the minimum
    1-second period that reaches year ~2514 before overflow.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

BUCKET_KEY_BASE = 1 << 62
_DAY_BITS = 28
_DAY_MASK = (1 << _DAY_BITS) - 1
_PERIOD_BITS = 34
MAX_PERIOD = (1 << _PERIOD_BITS) - 1

MICROS_PER_S = 1_000_000


def period_micros(period_s: float) -> int:
    """Bucket width in microseconds (validated at config time)."""
    us = int(round(period_s * MICROS_PER_S))
    if us < MICROS_PER_S:
        raise ValueError(
            f"temporal period must be >= 1s (got {period_s}s) — the "
            "34-bit period field is sized for 1-second buckets")
    return us


def bucket_key(day: int, period: int) -> int:
    """Encode one (day, period) bucket as its synthetic bank key."""
    if not (0 <= day <= _DAY_MASK):
        raise ValueError(f"day {day} exceeds the {_DAY_BITS}-bit field")
    if not (0 <= period <= MAX_PERIOD):
        raise ValueError(
            f"period {period} exceeds the {_PERIOD_BITS}-bit field")
    return BUCKET_KEY_BASE | (int(period) << _DAY_BITS) | int(day)


def bucket_keys(days: np.ndarray, periods: np.ndarray) -> np.ndarray:
    """Vectorized :func:`bucket_key`: int64[B] (callers guarantee the
    field bounds — frame days/periods come from the validated codec
    columns)."""
    return (np.int64(BUCKET_KEY_BASE)
            | (np.asarray(periods, np.int64) << np.int64(_DAY_BITS))
            | np.asarray(days, np.int64))


def is_bucket_key(key: int) -> bool:
    """Is this bank key a temporal bucket (vs a plain lecture day)?"""
    return int(key) >= BUCKET_KEY_BASE


def decode_bucket_key(key: int) -> Tuple[int, int]:
    """(day, period) of a bucket key; raises on a non-bucket key."""
    key = int(key)
    if key < BUCKET_KEY_BASE:
        raise ValueError(f"{key} is a plain day key, not a bucket key")
    body = key - BUCKET_KEY_BASE
    return body & _DAY_MASK, body >> _DAY_BITS
