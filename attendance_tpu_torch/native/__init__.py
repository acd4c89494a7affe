"""ctypes binding of the port's native host pack (``hostpipe.c``).

Counterpart of ``attendance_tpu/native/__init__.py`` cut to the pack
half, the buffer JSON scan (:meth:`HostPipe.prepare_json_batch`,
:meth:`HostPipe.parse_json_from`), the CPython list scan
(:meth:`HostPipe.parse_json_list`, in the library when ``Python.h`` was
there to build it: :attr:`HostPipe.has_list_scan`) and the columnar
store's dedup. The list scan reads Python objects, so it is bound
through ``ctypes.PyDLL`` (the GIL held); every other entry keeps its
``CDLL`` binding, which releases the GIL.
The methods and return codes are the JAX package's: -1 on success, the index of the
first event whose day missed the LUT, -2 when the native pass cannot run
(scratch allocation, or more banks than its u16 scratch holds), -3 when
a key overflowed the width tried.

``load()`` returns the :class:`HostPipe`, building the library on first
use, or ``None`` when ``ATP_NATIVE=0`` (the JAX package's switch; the
pipeline then packs with numpy). A missing compiler or a failed build or
load raises: the port never drops to the numpy pack quietly.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from attendance_tpu_torch.models.fused import (
    delta_buf_words, pick_delta_width, seg_buf_words)
from attendance_tpu_torch.native.build import build, python_include

_lock = threading.Lock()
_cached: Optional["HostPipe"] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_sz = ctypes.c_size_t
_u32 = ctypes.c_uint32

# name -> (restype, argtypes) of every C entry point (see hostpipe.c).
SIGNATURES = {
    "atp_max_key": (_u32, (_u8p, _sz, _sz)),
    "atp_pack_words": (ctypes.c_int64, (
        _u8p, _sz, _u8p, _sz, _sz, _sz, _i32p, _u32, _u32, _u32, _u32p)),
    "atp_pack_bytes": (ctypes.c_int64, (
        _u8p, _sz, _u8p, _sz, _sz, _sz, _i32p, _u32, _u32, _u32, _u8p)),
    "atp_pack_seg": (ctypes.c_int64, (
        _u8p, _sz, _u8p, _sz, _sz, _sz, _i32p, _u32, _u32, _u32, _u32,
        _u32p, _sz, _u32p)),
    "atp_delta_scan": (ctypes.c_int64, (
        _u8p, _sz, _u8p, _sz, _sz, _i32p, _u32, _u32, _u32,
        _u32p, _u32p, _u32p, _u32p, _u32p)),
    "atp_bitpack": (ctypes.c_int64, (_u32p, _sz, _sz, _u32, _u32p, _sz)),
    "atp_dedup_last": (ctypes.c_int64, (
        _u32p, _u32p, ctypes.POINTER(ctypes.c_int64), _sz, _u32p)),
    "atp_parse_json_events": (ctypes.c_int64, (
        _u8p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32), _sz, _u32p, _u32p,
        ctypes.POINTER(ctypes.c_int64), _u8p)),
}


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(typ)


def _strided(col: np.ndarray):
    """(byte pointer, element stride) of a u32 column: a contiguous
    planar view or a strided record field alike. The caller's reference
    keeps the owning buffer alive through the (synchronous) call."""
    addr = col.__array_interface__["data"][0]
    return ctypes.cast(addr, _u8p), col.strides[0]


def _check_lanes(keys: np.ndarray, days: np.ndarray, lut: np.ndarray,
                 padded: Optional[int]) -> None:
    """The C passes trust these sizes; a wrong one would write past a
    buffer, so they are checked before any pointer is passed."""
    if (keys.ndim != 1 or days.shape != keys.shape
            or keys.dtype.itemsize != 4 or days.dtype.itemsize != 4):
        raise ValueError("keys and days must be 1-D 4-byte columns of one "
                         "length")
    if lut.dtype != np.int32 or not lut.flags.c_contiguous:
        raise ValueError("the day LUT must be a contiguous int32 array")
    if padded is not None and len(keys) > padded:
        raise ValueError(f"{len(keys)} events do not fit {padded} lanes")


class PreparedJsonBatch:
    """The joined payload buffer, its offset and length tables and the
    output columns of one resumable JSON scan
    (:meth:`HostPipe.parse_json_from`)."""

    __slots__ = ("buf", "offs", "lens", "student", "day", "micros",
                 "flags")

    def __init__(self, buf, offs, lens, student, day, micros, flags):
        self.buf = buf
        self.offs = offs
        self.lens = lens
        self.student = student
        self.day = day
        self.micros = micros
        self.flags = flags

    def set_row(self, i: int, cols) -> None:
        """Fill row ``i`` from a one-event column dict (the Python parse
        of a payload outside the fast shape)."""
        self.student[i] = cols["student_id"][0]
        self.day[i] = cols["lecture_day"][0]
        self.micros[i] = cols["micros"][0]
        self.flags[i] = (int(bool(cols["is_valid"][0]))
                         | (int(cols["event_type"][0]) << 1))

    def columns(self, k: Optional[int] = None) -> dict:
        k = len(self.student) if k is None else k
        return {
            "student_id": self.student[:k],
            "lecture_day": self.day[:k],
            "micros": self.micros[:k],
            "is_valid": (self.flags[:k] & 1).astype(bool),
            "event_type": ((self.flags[:k] >> 1) & 1).astype(np.int8),
        }


class HostPipe:
    """Typed wrapper over the host pack library. ``list_lib`` is the same
    library loaded through ``ctypes.PyDLL`` when it was built with the
    list scan."""

    def __init__(self, lib: ctypes.CDLL,
                 list_lib: Optional[ctypes.PyDLL] = None):
        self._lib = lib
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        self._parse_list = None
        if list_lib is not None:
            fn = list_lib.atp_parse_json_list
            fn.restype = ctypes.c_int64
            fn.argtypes = (ctypes.py_object, _sz, _sz, _u32p, _u32p,
                           ctypes.POINTER(ctypes.c_int64), _u8p)
            self._parse_list = fn

    @property
    def has_list_scan(self) -> bool:
        return self._parse_list is not None

    def max_key(self, keys: np.ndarray) -> int:
        base, stride = _strided(keys)
        return int(self._lib.atp_max_key(base, len(keys), stride))

    def pack_words(self, keys: np.ndarray, days: np.ndarray,
                   lut: np.ndarray, day_base: int, kw: int,
                   padded: int) -> Tuple[Optional[np.ndarray], int]:
        """Fused LUT map + word pack: (words, -1), (None, miss index) on
        a LUT miss, or (None, -3) when a key overflowed ``kw`` bits."""
        _check_lanes(keys, days, lut, padded)
        kp, ks = _strided(keys)
        dp, ds = _strided(days)
        out = np.empty(padded, np.uint32)
        rc = self._lib.atp_pack_words(
            kp, ks, dp, ds, len(keys), padded, _ptr(lut, _i32p),
            day_base & 0xFFFFFFFF, len(lut), kw, _ptr(out, _u32p))
        if rc == 0:
            return out, -1
        if rc < 0:
            return None, -3
        return None, int(rc - 1)

    def pack_bytes(self, keys: np.ndarray, days: np.ndarray,
                   lut: np.ndarray, day_base: int, bank_width: int,
                   padded: int) -> Tuple[Optional[np.ndarray], int]:
        """Fused LUT map + bytes pack: (buf, -1) or (None, miss index)."""
        _check_lanes(keys, days, lut, padded)
        kp, ks = _strided(keys)
        dp, ds = _strided(days)
        out = np.empty((4 + bank_width) * padded, np.uint8)
        rc = self._lib.atp_pack_bytes(
            kp, ks, dp, ds, len(keys), padded, _ptr(lut, _i32p),
            day_base & 0xFFFFFFFF, len(lut), bank_width, _ptr(out, _u8p))
        if rc == 0:
            return out, -1
        return None, int(rc - 1)

    def pack_seg(self, keys: np.ndarray, days: np.ndarray,
                 lut: np.ndarray, day_base: int, kb: int, padded: int,
                 num_banks: int
                 ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], int]:
        """Fused LUT map + segmented bit-pack: (buf, perm, -1), or
        (None, None, miss index / -2 / -3)."""
        _check_lanes(keys, days, lut, padded)
        kp, ks = _strided(keys)
        dp, ds = _strided(days)
        buf = np.empty(seg_buf_words(num_banks, kb, padded), np.uint32)
        perm = np.empty(max(len(keys), 1), np.uint32)
        rc = self._lib.atp_pack_seg(
            kp, ks, dp, ds, len(keys), padded, _ptr(lut, _i32p),
            day_base & 0xFFFFFFFF, len(lut), kb, num_banks,
            _ptr(buf, _u32p), len(buf), _ptr(perm, _u32p))
        if rc == 0:
            return buf, perm[:len(keys)], -1
        if rc == -2:  # a key overflowed kb bits
            return None, None, -3
        if rc < 0:
            return None, None, -2
        return None, None, int(rc - 1)

    def delta_scan(self, keys: np.ndarray, days: np.ndarray,
                   lut: np.ndarray, day_base: int, num_banks: int):
        """Fused LUT map + (bank, key) sort + delta emit: (scan, -1) with
        ``scan`` the ``models.fused.delta_scan`` tuple (perm, counts,
        bases, deltas, needed), or (None, miss index / -2)."""
        _check_lanes(keys, days, lut, None)
        kp, ks = _strided(keys)
        dp, ds = _strided(days)
        n = len(keys)
        counts = np.empty(num_banks, np.uint32)
        bases = np.empty(num_banks, np.uint32)
        deltas = np.empty(max(n, 1), np.uint32)
        perm = np.empty(max(n, 1), np.uint32)
        needed = np.zeros(1, np.uint32)
        rc = self._lib.atp_delta_scan(
            kp, ks, dp, ds, n, _ptr(lut, _i32p), day_base & 0xFFFFFFFF,
            len(lut), num_banks, _ptr(counts, _u32p), _ptr(bases, _u32p),
            _ptr(deltas, _u32p), _ptr(perm, _u32p), _ptr(needed, _u32p))
        if rc > 0:
            return None, int(rc - 1)
        if rc < 0:
            return None, -2
        return ((perm[:n], counts, bases, deltas[:n],
                 max(int(needed[0]), 1)), -1)

    def bitpack_delta(self, scan, db: int, padded: int,
                      num_banks: int) -> Optional[np.ndarray]:
        """The delta wire buffer of a scan (native or numpy) at width
        ``db``; None when the scan's widest gap needs more than ``db``
        bits or the native pass cannot run."""
        perm, counts, bases, deltas, needed = scan
        if len(deltas) != len(perm) or len(perm) > padded:
            raise ValueError(f"{len(perm)} events (deltas {len(deltas)}) "
                             f"do not fit {padded} lanes")
        if needed > db:
            return None
        deltas = np.ascontiguousarray(deltas, dtype=np.uint32)
        buf = np.empty(delta_buf_words(num_banks, db, padded), np.uint32)
        buf[:num_banks] = counts
        buf[num_banks:2 * num_banks] = bases
        rc = self._lib.atp_bitpack(
            _ptr(deltas, _u32p), len(perm), padded, db,
            _ptr(buf[2 * num_banks:], _u32p), len(buf) - 2 * num_banks)
        return None if rc < 0 else buf

    def pack_delta(self, keys: np.ndarray, days: np.ndarray,
                   lut: np.ndarray, day_base: int, db_hint: int,
                   padded: int, num_banks: int):
        """Delta scan + bit-pack at ``pick_delta_width(db_hint, needed)``:
        (buf, perm, db, needed, -1), or (None, None, 0, 0, miss index /
        -2)."""
        scan, miss = self.delta_scan(keys, days, lut, day_base, num_banks)
        if scan is None:
            return None, None, 0, 0, miss
        db = pick_delta_width(db_hint, scan[4])
        buf = self.bitpack_delta(scan, db, padded, num_banks)
        if buf is None:
            return None, None, 0, 0, -2
        return buf, scan[0], db, scan[4], -1

    def prepare_json_batch(self, payloads) -> PreparedJsonBatch:
        """One O(total bytes) setup for a batch of JSON payloads: the
        joined buffer and its offset and length tables."""
        n = len(payloads)
        lens = np.array(list(map(len, payloads)), np.uint32)
        buf = np.frombuffer(b"".join(payloads), np.uint8)
        if int(lens.sum()) != buf.size:
            # A buffer payload whose items are wider than a byte: len()
            # counts items, the join copies bytes.
            payloads = [bytes(p) for p in payloads]
            lens = np.array(list(map(len, payloads)), np.uint32)
            buf = np.frombuffer(b"".join(payloads), np.uint8)
        offs = np.zeros(n, np.uint64)
        if n > 1:
            np.cumsum(lens[:-1], out=offs[1:])
        return PreparedJsonBatch(
            buf=buf, offs=offs, lens=lens,
            student=np.empty(n, np.uint32), day=np.empty(n, np.uint32),
            micros=np.empty(n, np.int64), flags=np.empty(n, np.uint8))

    def parse_json_from(self, b: PreparedJsonBatch, start: int) -> int:
        """Scan payloads [start, n) into the batch's columns: -1 when all
        parsed, else the absolute index of the first payload outside the
        fast shape (rows before it are filled; the caller parses that one
        in Python and resumes at index + 1)."""
        n = len(b.offs) - start
        if n <= 0:
            return -1
        rc = self._lib.atp_parse_json_events(
            _ptr(b.buf, _u8p),
            b.offs[start:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            b.lens[start:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n, _ptr(b.student[start:], _u32p), _ptr(b.day[start:], _u32p),
            b.micros[start:].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _ptr(b.flags[start:], _u8p))
        return -1 if rc == 0 else start + int(rc - 1)

    @staticmethod
    def empty_json_outputs(n: int) -> PreparedJsonBatch:
        """The output columns of a list scan (the ``set_row`` and
        ``columns`` of a prepared batch, with no joined buffer or tables:
        the list scan reads each payload in place)."""
        return PreparedJsonBatch(
            buf=None, offs=None, lens=None,
            student=np.empty(n, np.uint32), day=np.empty(n, np.uint32),
            micros=np.empty(n, np.int64), flags=np.empty(n, np.uint8))

    def parse_json_list(self, payloads: list, b: PreparedJsonBatch,
                        start: int) -> int:
        """Scan ``payloads[start:]`` (a list) in place into ``b``'s
        columns: -1 when all parsed, else the absolute index of the first
        entry that is not ``bytes`` or falls outside the fast shape (the
        caller parses that one in Python and resumes at index + 1, as
        with :meth:`parse_json_from`). Raises when the library has no
        list scan."""
        if self._parse_list is None:
            raise RuntimeError("the native host pack was built without "
                               "the list scan (no Python.h)")
        if not isinstance(payloads, list):
            raise TypeError("the list scan reads a list of payloads")
        n = len(payloads)
        if len(b.student) < n:
            raise ValueError(f"{n} payloads do not fit {len(b.student)} "
                             "output rows")
        if start >= n:
            return -1
        rc = self._parse_list(
            payloads, start, n, _ptr(b.student, _u32p), _ptr(b.day, _u32p),
            b.micros.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _ptr(b.flags, _u8p))
        return -1 if rc == 0 else int(rc - 1)

    def parse_json_events(self, payloads) -> Tuple[dict, int]:
        """One-shot scan: (columns, -1), or (the parsed prefix's columns,
        the first failed index)."""
        if len(payloads) == 0:
            return {"student_id": np.zeros(0, np.uint32),
                    "lecture_day": np.zeros(0, np.uint32),
                    "micros": np.zeros(0, np.int64),
                    "is_valid": np.zeros(0, bool),
                    "event_type": np.zeros(0, np.int8)}, -1
        b = self.prepare_json_batch(payloads)
        miss = self.parse_json_from(b, 0)
        return b.columns(len(payloads) if miss < 0 else miss), miss

    def dedup_last(self, day: np.ndarray, sid: np.ndarray,
                   micros: np.ndarray) -> np.ndarray:
        """Last-wins primary-key dedup over (day, micros, sid): the kept
        rows' original indices in append order. Raises MemoryError when
        the pass cannot allocate its table."""
        n = len(day)
        day = np.ascontiguousarray(day, np.uint32)
        sid = np.ascontiguousarray(sid, np.uint32)
        micros = np.ascontiguousarray(micros, np.int64)
        if sid.shape != (n,) or micros.shape != (n,):
            raise ValueError("dedup columns must be 1-D of one length")
        out = np.empty(n, np.uint32)
        kept = self._lib.atp_dedup_last(
            _ptr(day, _u32p), _ptr(sid, _u32p),
            micros.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            _ptr(out, _u32p))
        if kept < 0:
            raise MemoryError(f"native dedup could not allocate for {n} "
                              "rows")
        return out[:kept]


def load() -> Optional[HostPipe]:
    """The host pack (built on first call), or None when ``ATP_NATIVE=0``.
    Raises when the library cannot be built or loaded."""
    global _cached
    if os.environ.get("ATP_NATIVE", "1") == "0":
        return None
    with _lock:
        if _cached is None:
            path = str(build())
            _cached = HostPipe(
                ctypes.CDLL(path),
                ctypes.PyDLL(path) if python_include() is not None
                else None)
        return _cached
