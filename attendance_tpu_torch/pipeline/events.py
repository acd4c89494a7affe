"""Event schema, JSON frames, binary record frames (ATB1), planar binary
frames (ATB2) and lecture-id day codes.

Counterpart of ``attendance_tpu/pipeline/events.py``: the same JSON (the
reference's ``json.dumps(dict).encode()`` frames of ``{student_id,
timestamp, lecture_id, is_valid, event_type}``) and the same byte
layouts, so frames written by either package decode in the other.

ATB1: magic | records of 20 bytes (u32 student_id | u32 lecture_day |
i64 micros | u8 flags | 3 pad). ATB2: magic | u32 n | student_id u32[n]
| lecture_day u32[n] | micros i64[n] | flags u8[n]. All little-endian;
flags bit0 = is_valid (generator ground truth), bit1 = event_type (exit).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Sequence

import numpy as np

from attendance_tpu_torch.ops.murmur3 import murmur3_bytes

PLANAR_MAGIC = b"ATB2"
BINARY_MAGIC = b"ATB1"
BINARY_DTYPE = np.dtype([
    ("student_id", "<u4"),
    ("lecture_day", "<u4"),
    ("micros", "<i8"),
    ("flags", "<u1"),
    ("pad", "V3"),
])
EVENT_ENTRY = 0
EVENT_EXIT = 1


@dataclass
class AttendanceEvent:
    student_id: int
    timestamp: str  # ISO-8601, as the reference emits
    lecture_id: str
    is_valid: bool
    event_type: str

    def to_dict(self) -> Dict:
        return {
            "student_id": self.student_id,
            "timestamp": self.timestamp,
            "lecture_id": self.lecture_id,
            "is_valid": self.is_valid,
            "event_type": self.event_type,
        }


def encode_event(event: AttendanceEvent) -> bytes:
    """The reference's wire format: json.dumps(dict).encode('utf-8')."""
    return json.dumps(event.to_dict()).encode("utf-8")


def decode_event(data: bytes) -> AttendanceEvent:
    d = json.loads(data.decode("utf-8"))
    return AttendanceEvent(
        student_id=int(d["student_id"]),
        timestamp=str(d["timestamp"]),
        lecture_id=str(d["lecture_id"]),
        is_valid=bool(d.get("is_valid", True)),
        event_type=str(d.get("event_type", "entry")),
    )


def decode_event_batch(frames: Sequence[bytes]) -> List[AttendanceEvent]:
    return [decode_event(f) for f in frames]


_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


def iso_to_micros(ts: str) -> int:
    """Epoch microseconds of an ISO-8601 timestamp. A naive timestamp is
    pinned to UTC, so the result is a pure function of the string (the
    hour written in it is ``micros // 3.6e9 % 24`` on any host); exact
    integer arithmetic, no float product."""
    try:
        dt = datetime.fromisoformat(ts)
    except ValueError:
        # Normalize what older fromisoformat refuses: Z -> +00:00, the
        # fraction padded or cut to exactly 6 digits.
        norm = ts[:-1] + "+00:00" if ts.endswith("Z") else ts
        i = norm.find(".")
        if i != -1:
            j = i + 1
            while j < len(norm) and norm[j].isdigit():
                j += 1
            frac = norm[i + 1:j][:6].ljust(6, "0")
            norm = norm[:i + 1] + frac + norm[j:]
        dt = datetime.fromisoformat(norm)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return (dt - _EPOCH) // timedelta(microseconds=1)


def columns_from_events(events: Sequence[AttendanceEvent]
                        ) -> Dict[str, np.ndarray]:
    """The column arrays of decoded JSON events (the columnar store's
    block shape)."""
    n = len(events)
    student = np.empty(n, dtype=np.uint32)
    day = np.empty(n, dtype=np.uint32)
    micros = np.empty(n, dtype=np.int64)
    flags_valid = np.empty(n, dtype=bool)
    etype = np.empty(n, dtype=np.int8)
    for i, e in enumerate(events):
        student[i] = e.student_id & 0xFFFFFFFF
        day[i] = lecture_to_day(e.lecture_id)
        micros[i] = iso_to_micros(e.timestamp)
        flags_valid[i] = e.is_valid
        etype[i] = EVENT_EXIT if e.event_type == "exit" else EVENT_ENTRY
    return {"student_id": student, "lecture_day": day, "micros": micros,
            "is_valid": flags_valid, "event_type": etype}


def decode_json_batch_columns(payloads: Sequence[bytes]
                              ) -> Dict[str, np.ndarray]:
    """Reference-wire JSON payloads -> binary columns, batched.

    With the native host runtime (``native.load``) and a list of
    payloads, the CPython list scan (``atp_parse_json_list``) reads each
    ``bytes`` payload in place when the library has it; otherwise one
    joined buffer is scanned by ``atp_parse_json_events``. Either way a
    payload outside the fast shape (escapes, timezone suffixes, lecture
    ids that need murmur3, and for the list scan any entry that is not
    ``bytes``) is parsed in Python alone and the scan resumes after it.
    With ``ATP_NATIVE=0``, every payload is parsed in Python. The
    results are the same; malformed JSON raises as :func:`decode_event`
    does."""
    from attendance_tpu_torch.native import load as load_native

    nat = load_native()
    if nat is None or not payloads:
        return columns_from_events(decode_event_batch(payloads))
    if nat.has_list_scan and isinstance(payloads, list):
        batch = nat.empty_json_outputs(len(payloads))
        idx = 0
        while True:
            miss = nat.parse_json_list(payloads, batch, idx)
            if miss < 0:
                return batch.columns()
            batch.set_row(miss, columns_from_events(
                [decode_event(bytes(payloads[miss]))]))
            idx = miss + 1
    batch = nat.prepare_json_batch(payloads)
    idx = 0
    while True:
        miss = nat.parse_json_from(batch, idx)
        if miss < 0:
            return batch.columns()
        batch.set_row(miss, columns_from_events(
            [decode_event(bytes(payloads[miss]))]))
        idx = miss + 1


def _record(e: AttendanceEvent, rec: np.ndarray, i: int) -> None:
    rec["student_id"][i] = e.student_id & 0xFFFFFFFF
    rec["lecture_day"][i] = lecture_to_day(e.lecture_id)
    rec["micros"][i] = iso_to_micros(e.timestamp)
    rec["flags"][i] = ((1 if e.is_valid else 0)
                       | (2 if e.event_type == "exit" else 0))


def encode_event_binary(event: AttendanceEvent) -> bytes:
    """One event as a one-record ATB1 frame."""
    return encode_binary_batch([event])


def encode_binary_batch(events: Sequence[AttendanceEvent]) -> bytes:
    """One ATB1 frame holding N records."""
    rec = np.zeros(len(events), dtype=BINARY_DTYPE)
    for i, e in enumerate(events):
        _record(e, rec, i)
    return BINARY_MAGIC + rec.tobytes()


def decode_binary_batch(data: bytes,
                        include_truth: bool = True) -> Dict[str, np.ndarray]:
    """Zero-copy decode of an ATB1 record frame (strided column views) or
    an ATB2 planar frame (contiguous views)."""
    if magic_match(data, PLANAR_MAGIC):
        return decode_planar_batch(data, include_truth)
    if not magic_match(data, BINARY_MAGIC):
        raise ValueError("not a binary event frame")
    rec = np.frombuffer(data, dtype=BINARY_DTYPE, offset=len(BINARY_MAGIC))
    cols = {
        "student_id": rec["student_id"],
        "lecture_day": rec["lecture_day"],
        "micros": rec["micros"],
        "event_type": ((rec["flags"] >> 1) & 1).astype(np.int8),
    }
    if include_truth:
        cols["is_valid"] = (rec["flags"] & 1).astype(bool)
    return cols


def magic_match(data, magic: bytes) -> bool:
    """``data.startswith(magic)`` for any buffer type (memoryviews have
    no ``startswith``); slicing costs O(len(magic))."""
    head = data[:len(magic)]
    return (head if isinstance(head, bytes) else bytes(head)) == magic


def encode_planar_batch(cols: Dict[str, np.ndarray]) -> bytes:
    """Pack column arrays into one planar frame."""
    n = len(cols["student_id"])
    flags = (np.asarray(cols["is_valid"]).astype(np.uint8)
             | (np.asarray(cols["event_type"]).astype(np.uint8) << 1))
    parts = [PLANAR_MAGIC, np.uint32(n).tobytes(),
             np.ascontiguousarray(cols["student_id"],
                                  dtype=np.uint32).tobytes(),
             np.ascontiguousarray(cols["lecture_day"],
                                  dtype=np.uint32).tobytes(),
             np.ascontiguousarray(cols["micros"],
                                  dtype=np.int64).tobytes(),
             flags.tobytes()]
    return b"".join(parts)


def decode_planar_batch(data: bytes,
                        include_truth: bool = True) -> Dict[str, np.ndarray]:
    """Zero-copy decode: every column is a contiguous view of ``data``.
    ``include_truth=False`` skips the generator's ``is_valid`` column
    (the pipeline recomputes validity on the device)."""
    if not magic_match(data, PLANAR_MAGIC):
        raise ValueError("not a planar event frame")
    off = len(PLANAR_MAGIC)
    (n,) = np.frombuffer(data, np.uint32, count=1, offset=off)
    n = int(n)
    off += 4
    student = np.frombuffer(data, np.uint32, count=n, offset=off)
    off += 4 * n
    day = np.frombuffer(data, np.uint32, count=n, offset=off)
    off += 4 * n
    micros = np.frombuffer(data, np.int64, count=n, offset=off)
    off += 8 * n
    flags = np.frombuffer(data, np.uint8, count=n, offset=off)
    cols = {
        "student_id": student,
        "lecture_day": day,
        "micros": micros,
        "event_type": ((flags >> 1) & 1).astype(np.int8),
    }
    if include_truth:
        cols["is_valid"] = (flags & 1).astype(bool)
    return cols


_HASH_DAY_BASE = 100_000_000           # above any yyyymmdd calendar value
_HASH_DAY_LIMIT = _HASH_DAY_BASE + (1 << 26)


def lecture_to_day(lecture_id: str) -> int:
    """``"LECTURE_YYYYMMDD"`` -> yyyymmdd. A re-emitted hashed code
    (``"LECTURE_<9 digits>"``) maps back to itself; any other id hashes
    (murmur3, stable across processes) to a code above every calendar
    value."""
    tail = lecture_id.rsplit("_", 1)[-1]
    if tail.isdigit():
        if len(tail) == 8:
            return int(tail)
        if len(tail) == 9 and _HASH_DAY_BASE <= int(tail) < _HASH_DAY_LIMIT:
            return int(tail)
    return _HASH_DAY_BASE + (murmur3_bytes(lecture_id.encode(), 0)
                             & 0x3FFFFFF)
