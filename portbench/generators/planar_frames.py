"""Swipe frames of the binary wire, made from the seed.

A frozen copy of the program's load generator (``pipeline/loadgen.py``:
``synth_columns``) and of its planar encoder (``pipeline/events.py``:
``encode_planar_batch``), so that a later change to the program leaves
the benchmark's traffic as it is. The mix is the reference generator's:
valid ids drawn from the roster, invalid ids strictly above the
roster's id range (``invalid_fraction`` of the attempts), lecture days
uniform over the configuration's days, ``event_type`` split evenly.

Every seed gets the same frame sizes and the same number of frames;
only the draws differ. Seeds are any non-negative integers, past 32 bits
too.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

PLANAR_MAGIC = b"ATB2"
FIRST_DAY = 20_260_701
_BASE_MICROS = 1_753_000_000_000_000
_INVALID_SPAN = 900_000


def make_roster(rng: np.random.Generator, size: int) -> np.ndarray:
    """``size`` distinct student ids spread over [10000, 10000 + 4 size):
    one id drawn in each stride of four, so ids fit the same bits as the
    program's generator gives them and no sort or permutation of the
    whole range is needed."""
    return (10_000 + 4 * np.arange(size, dtype=np.uint32)
            + rng.integers(0, 4, size, dtype=np.uint32)).astype(np.uint32)


def invalid_base(roster_size: int) -> int:
    """The smallest invalid id: above every roster id."""
    return max(100_000, 10_000 + 4 * roster_size)


def synth_columns(rng: np.random.Generator, n: int, roster: np.ndarray,
                  num_lectures: int, invalid_fraction: float,
                  base: int) -> Dict[str, np.ndarray]:
    """One frame's columns; ``is_valid`` is the generator's truth (the
    program recomputes validity and never reads it)."""
    valid = rng.random(n) >= invalid_fraction
    student = np.where(
        valid, roster[rng.integers(0, len(roster), n)],
        rng.integers(base, base + _INVALID_SPAN, n).astype(np.uint32))
    day = (FIRST_DAY + rng.integers(0, num_lectures, n)).astype(np.uint32)
    micros = (_BASE_MICROS
              + rng.integers(0, 86_400_000_000, n)).astype(np.int64)
    return {"student_id": student.astype(np.uint32), "lecture_day": day,
            "micros": micros, "is_valid": valid,
            "event_type": (rng.random(n) < 0.5).astype(np.int8)}


def encode_planar(cols: Dict[str, np.ndarray]) -> bytes:
    """ATB2: magic, u32 n, then the student, day, micros and flags
    planes (flags bit 0 the truth, bit 1 the event type)."""
    n = len(cols["student_id"])
    flags = (np.asarray(cols["is_valid"]).astype(np.uint8)
             | (np.asarray(cols["event_type"]).astype(np.uint8) << 1))
    return b"".join([
        PLANAR_MAGIC, np.uint32(n).tobytes(),
        np.ascontiguousarray(cols["student_id"], np.uint32).tobytes(),
        np.ascontiguousarray(cols["lecture_day"], np.uint32).tobytes(),
        np.ascontiguousarray(cols["micros"], np.int64).tobytes(),
        flags.tobytes()])


def frame_bytes(events: int) -> int:
    """Size of one planar frame of ``events`` events."""
    return len(PLANAR_MAGIC) + 4 + 17 * events


def decode_ids(frame: bytes):
    """(student ids, lecture days) of a frame, as views."""
    n = int(np.frombuffer(frame, np.uint32, 1, len(PLANAR_MAGIC))[0])
    off = len(PLANAR_MAGIC) + 4
    return (np.frombuffer(frame, np.uint32, n, off),
            np.frombuffer(frame, np.uint32, n, off + 4 * n))


def generate(config: dict, traffic: dict, seed: int, frames: int):
    """(roster, list of ``frames`` planar frames) for one seed. Frame i
    draws from its own stream, ``default_rng([seed, i])``, so the frames
    are made on a thread each and come out the same."""
    size = config["roster_size"]
    roster = make_roster(np.random.default_rng(seed), size)
    base = invalid_base(size)

    def frame(i: int) -> bytes:
        return encode_planar(synth_columns(
            np.random.default_rng([seed, i]), traffic["frame_events"],
            roster, config["lecture_days"], traffic["invalid_fraction"],
            base))

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        out: List[bytes] = list(pool.map(frame, range(frames)))
    return roster, out
