"""Bulk binary load generator for the fused path.

Counterpart of ``attendance_tpu/pipeline/loadgen.py``: the same numpy RNG
calls in the same order, so for a given seed the frames are byte-equal
to the JAX package's. The event population follows the reference
generator: valid ids from the roster, invalid ids strictly above the
roster's range, a 10% invalid-attempt fraction, events spread over the
lecture days.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from attendance_tpu_torch.pipeline.events import encode_planar_batch

_BASE_MICROS = 1_753_000_000_000_000  # an arbitrary 2025 epoch anchor


def synth_columns(rng: np.random.Generator, batch: int,
                  roster: np.ndarray, num_lectures: int,
                  invalid_fraction: float = 0.1,
                  invalid_base: Optional[int] = None) -> dict:
    """One micro-batch of synthetic swipe columns. Invalid ids are drawn
    above the roster's id range, so ``is_valid`` never mislabels."""
    if invalid_base is None:
        invalid_base = max(100_000, int(roster.max()) + 1)
    valid = rng.random(batch) >= invalid_fraction
    student = np.where(
        valid,
        roster[rng.integers(0, len(roster), batch)],
        rng.integers(invalid_base, invalid_base + 900_000,
                     batch).astype(np.uint32))
    day = (20_260_701 + rng.integers(0, num_lectures, batch)).astype(
        np.uint32)
    micros = (_BASE_MICROS
              + rng.integers(0, 86_400_000_000, batch)).astype(np.int64)
    return {
        "student_id": student.astype(np.uint32),
        "lecture_day": day,
        "micros": micros,
        "is_valid": valid,  # generator ground truth (oracle only)
        "event_type": (rng.random(batch) < 0.5).astype(np.int8),
    }


def frame_from_columns(cols: dict) -> bytes:
    """One micro-batch of columns as a planar ATB2 frame (the JAX
    package's ``frame_from_columns`` with its default ``planar=True``;
    the interleaved ATB1 form is not generated here)."""
    return encode_planar_batch(cols)


def stream_micros(rng: np.random.Generator, n: int, cursor: int,
                  mean_gap_us: int = 1000) -> np.ndarray:
    """Monotone event-time stamps continuing from ``cursor``."""
    gaps = rng.integers(1, max(2 * mean_gap_us, 2), n)
    return (np.int64(cursor) + np.cumsum(gaps)).astype(np.int64)


def apply_disorder(micros: np.ndarray, rng: np.random.Generator,
                   disorder_frac: float, late_max_s: float) -> np.ndarray:
    """Displace a ``disorder_frac`` sample of events back in event time
    by up to ``late_max_s`` seconds (arrival position unchanged)."""
    if disorder_frac <= 0 or late_max_s <= 0:
        return micros
    out = np.array(micros, np.int64)
    pick = rng.random(len(out)) < disorder_frac
    n_pick = int(pick.sum())
    if n_pick:
        out[pick] -= rng.integers(1, int(late_max_s * 1e6) + 1, n_pick)
    return out


def generate_frames(num_events: int, batch: int,
                    roster_size: int = 100_000, num_lectures: int = 64,
                    invalid_fraction: float = 0.1,
                    seed: Optional[int] = 0,
                    disorder_frac: float = 0.0,
                    late_max_s: float = 0.0,
                    ordered: bool = False,
                    mean_gap_us: int = 1000,
                    ) -> Tuple[np.ndarray, Iterator[bytes]]:
    """(roster, iterator of planar frames totalling num_events events).

    ``ordered=True`` (implied by a nonzero ``disorder_frac``) replaces
    the uniform-within-a-day timestamps with a monotone stream clock,
    of which ``disorder_frac`` is then displaced up to ``late_max_s``."""
    rng = np.random.default_rng(seed)
    roster = rng.choice(np.arange(10_000, 10_000 + 4 * roster_size,
                                  dtype=np.uint32),
                        size=roster_size, replace=False)
    invalid_base = max(100_000, 10_000 + 4 * roster_size)
    ordered = ordered or disorder_frac > 0

    def frames():
        left = num_events
        cursor = _BASE_MICROS
        while left > 0:
            n = min(batch, left)
            cols = synth_columns(rng, n, roster, num_lectures,
                                 invalid_fraction,
                                 invalid_base=invalid_base)
            if ordered:
                micros = stream_micros(rng, n, cursor, mean_gap_us)
                cursor = int(micros[-1])
                cols["micros"] = apply_disorder(
                    micros, rng, disorder_frac, late_max_s)
            yield frame_from_columns(cols)
            left -= n

    return roster, frames()
