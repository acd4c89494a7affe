"""Per-swipe JSON records of the reference generator, made from the seed.

The record is the reference generator's wire (``data_generator.py``;
the program's ``generate_student_data``): ``json.dumps`` of
``{"student_id", "timestamp", "lecture_id", "is_valid", "event_type"}``
in that order, a naive ISO timestamp to the minute and the lecture id
``LECTURE_<YYYYMMDD>`` of its day. The mix is drawn column-wise rather
than student by student: each record is an invalid attempt (an id
strictly above the roster's range, an entry) with ``invalid_fraction``,
else a roster id, entry or exit evenly; entries at hours 8-11, exits
3-4 hours later; days uniform over the configuration's lecture-days.
Every seed gets the same number of records of the same form.
"""

from __future__ import annotations

from datetime import date, timedelta
from typing import Dict

import numpy as np

from portbench.generators.planar_frames import invalid_base, make_roster

FIRST_DATE = date(2026, 7, 1)
_INVALID_SPAN = 900_000


def day_ids(lecture_days: int):
    """(ISO date, lecture id) of each lecture-day."""
    days = [FIRST_DATE + timedelta(days=d) for d in range(lecture_days)]
    return ([d.isoformat() for d in days],
            [f"LECTURE_{d.strftime('%Y%m%d')}" for d in days])


def columns(rng: np.random.Generator, n: int, roster: np.ndarray,
            lecture_days: int, invalid_fraction: float,
            base: int) -> Dict[str, np.ndarray]:
    invalid = rng.random(n) < invalid_fraction
    sid = np.where(invalid,
                   rng.integers(base, base + _INVALID_SPAN, n),
                   roster[rng.integers(0, len(roster), n)]).astype(np.int64)
    exit_ = ~invalid & (rng.random(n) < 0.5)
    hour = rng.integers(8, 12, n) + np.where(exit_, rng.integers(3, 5, n), 0)
    return {"student_id": sid, "day": rng.integers(0, lecture_days, n),
            "hour": hour, "minute": rng.integers(0, 60, n),
            "truth": ~invalid, "exit": exit_}


def encode(cols: Dict[str, np.ndarray], lecture_days: int) -> list:
    """One JSON message (bytes) a record."""
    iso, lid = day_ids(lecture_days)
    return [
        (f'{{"student_id": {s}, "timestamp": "{iso[d]}T{h:02d}:{m:02d}:00",'
         f' "lecture_id": "{lid[d]}", "is_valid": {"true" if t else "false"},'
         f' "event_type": "{"exit" if e else "entry"}"}}').encode()
        for s, d, h, m, t, e in zip(
            cols["student_id"].tolist(), cols["day"].tolist(),
            cols["hour"].tolist(), cols["minute"].tolist(),
            cols["truth"].tolist(), cols["exit"].tolist())]


def generate(config: dict, traffic: dict, seed: int):
    """(roster, columns, messages) for one seed."""
    rng = np.random.default_rng(seed)
    size = config["roster_size"]
    roster = make_roster(rng, size)
    cols = columns(rng, traffic["pool_messages"], roster,
                   config["lecture_days"], traffic["invalid_fraction"],
                   invalid_base(size))
    return roster, cols, encode(cols, config["lecture_days"])
