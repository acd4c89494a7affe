"""The ingress codec seam of the fused path: wire payloads -> columns ->
one canonical planar block.

Counterpart of ``attendance_tpu/pipeline/codec.py``: one
:class:`IngressCodec` per wire (``json``, the reference's per-event
wire; ``binary``, ATB1 record and ATB2 planar frames; ``columnar``, the
COLW compressed wire), the sniffing :func:`decode_frame`, and two JSON
engines with the same results: the native scan
(``events.decode_json_batch_columns``) and the numpy-vectorized
:func:`scan_json_batch_columns`. Payloads outside the fast shape take
the exact Python codec row by row.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from attendance_tpu_torch.pipeline.events import (
    _HASH_DAY_BASE, _HASH_DAY_LIMIT, BINARY_DTYPE, BINARY_MAGIC,
    PLANAR_MAGIC, columns_from_events, decode_binary_batch, decode_event,
    decode_json_batch_columns, encode_planar_batch, magic_match)

COLUMN_KEYS = ("student_id", "lecture_day", "micros", "is_valid",
               "event_type")

# The COLW compressed columnar wire ships on the checksummed framing
# (transport.framing CK_MAGIC + sha256 + body).
COLW_MAGIC = b"ATC1"


# ---------------------------------------------------------------------------
# Codec interface + registry
# ---------------------------------------------------------------------------

class IngressCodec:
    """One wire format's decode/assemble pair: ``decode`` maps a batch of
    payloads to column arrays, ``assemble`` column arrays to one
    canonical planar block. A codec keeps no state between batches."""

    name = "abstract"

    def decode(self, payloads: Sequence[bytes], *,
               prefer_gil_release: bool = False
               ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def assemble(self, cols: Dict[str, np.ndarray]) -> bytes:
        """Columns -> canonical planar block (shared by every codec:
        the dispatcher consumes exactly one format)."""
        return encode_planar_batch(cols)


class JsonCodec(IngressCodec):
    """The reference's per-event JSON wire: one JSON object per payload.
    ``prefer_gil_release=True`` selects the numpy-vectorized scanner;
    the default is the native scan (``ATP_NATIVE=0``: Python)."""

    name = "json"

    def decode(self, payloads: Sequence[bytes], *,
               prefer_gil_release: bool = False
               ) -> Dict[str, np.ndarray]:
        if prefer_gil_release:
            return scan_json_batch_columns(payloads)
        return decode_json_batch_columns(payloads)


class BinaryCodec(IngressCodec):
    """Bulk binary frames: interleaved ATB1 records or planar ATB2
    blocks, one frame per payload, concatenated into one column set."""

    name = "binary"

    def decode(self, payloads: Sequence[bytes], *,
               prefer_gil_release: bool = False
               ) -> Dict[str, np.ndarray]:
        del prefer_gil_release  # np.frombuffer never holds the GIL long
        if len(payloads) == 1:
            return decode_binary_batch(payloads[0])
        return merge_columns([decode_binary_batch(p) for p in payloads])


class ColumnarCodec(IngressCodec):
    """The COLW compressed columnar wire: delta-encoded timestamps,
    dictionary- or width-packed ids, bit-packed flags, on the checksummed
    framing, so a corrupt frame raises at decode (the poison path
    dead-letters it)."""

    name = "columnar"

    def decode(self, payloads: Sequence[bytes], *,
               prefer_gil_release: bool = False
               ) -> Dict[str, np.ndarray]:
        del prefer_gil_release  # the unpack is numpy passes already
        if len(payloads) == 1:
            return decode_columnar_frame(payloads[0])
        return merge_columns([decode_columnar_frame(p)
                              for p in payloads])


CODECS: Dict[str, IngressCodec] = {
    c.name: c for c in (JsonCodec(), BinaryCodec(), ColumnarCodec())}


def get_codec(name: str) -> IngressCodec:
    codec = CODECS.get(name)
    if codec is None:
        raise KeyError(f"unknown ingress codec {name!r} "
                       f"(have: {sorted(CODECS)})")
    return codec


def codec_for_frame(data: bytes) -> IngressCodec:
    """Sniff one payload's wire: binary frames carry the ATB1/ATB2
    magic, columnar frames the COLW magic (bare, or behind the
    checksummed-framing CK magic); everything else is the JSON wire
    (malformed payloads take the JSON codec's poison path). ``data`` may
    be any buffer."""
    if magic_match(data, BINARY_MAGIC) or magic_match(data, PLANAR_MAGIC):
        return CODECS["binary"]
    if magic_match(data, COLW_MAGIC) or magic_match(data, _CK_MAGIC):
        return CODECS["columnar"]
    return CODECS["json"]


def decode_frame(data: bytes,
                 include_truth: bool = True) -> Dict[str, np.ndarray]:
    """One payload -> columns through the sniffed codec: binary frames
    as zero-copy views, COLW frames by the vectorized unpack, a JSON
    payload as a one-event batch."""
    if magic_match(data, PLANAR_MAGIC) or magic_match(data, BINARY_MAGIC):
        return decode_binary_batch(data, include_truth=include_truth)
    if magic_match(data, COLW_MAGIC) or magic_match(data, _CK_MAGIC):
        return decode_columnar_frame(data, include_truth=include_truth)
    cols = decode_json_batch_columns([bytes(data)])
    if not include_truth:
        cols = {k: v for k, v in cols.items() if k != "is_valid"}
    return cols


def frame_event_count(data: bytes) -> int:
    """Event count of one bulk frame without decoding it."""
    if magic_match(data, PLANAR_MAGIC):
        (n,) = np.frombuffer(data, np.uint32, count=1,
                             offset=len(PLANAR_MAGIC))
        return int(n)
    if magic_match(data, BINARY_MAGIC):
        return (len(data) - len(BINARY_MAGIC)) // BINARY_DTYPE.itemsize
    off = _colw_body_offset(data)
    if off is not None:
        (n,) = np.frombuffer(data, np.uint32, count=1,
                             offset=off + len(COLW_MAGIC))
        return int(n)
    raise ValueError("not a bulk event frame")


def merge_columns(blocks: Sequence[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Concatenate column sets; keys follow the first block."""
    if len(blocks) == 1:
        return blocks[0]
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


# ---------------------------------------------------------------------------
# COLW: the columnar compressed wire
# ---------------------------------------------------------------------------
# Frame body layout (little-endian, self-contained per frame — decode
# never depends on cross-frame state, so redelivery/poison semantics
# hold per message):
#
#   "ATC1" | u32 n
#   | i64 ts_base | u8 ts_w | zigzag(diff(micros)) as u{ts_w}[n-1]
#   | id-column(student_id) | id-column(lecture_day)
#   | flags u8[ceil(n/4)]          (2 bits/event: valid | exit<<1)
#
#   id-column := u8 mode
#     mode 0 (width-packed): u8 w in {1,2,3,4} | u{w}[n] values
#     mode 1 (dictionary):   u32 k | u32[k] dict | u8 iw in {1,2,4}
#                            | u{iw}[n] indices
#
# ts_w in {0,1,2,3,4,8}: 0 = all timestamps equal ts_base; out-of-range
# deltas (negative / > u32 after zigzag) fall back to width 8, so ANY
# int64 micros round-trips exactly.  The encoder picks the cheaper id
# mode per column per frame; the decoder bounds-checks every section
# and every dictionary index — a malformed frame raises, never yields
# silently wrong events.  The whole frame ships wrapped in the
# checksummed framing (CK magic + sha256 + body).

_CK_MAGIC = b"CKF1"          # transport.framing.CK_MAGIC
_CK_DIGEST_LEN = 32
_ID_WIDTHS = (1, 2, 3, 4)
_ZZ_ONE = np.uint64(1)


def _zigzag(d: np.ndarray) -> np.ndarray:
    """int64 deltas -> uint64 zigzag (small magnitudes -> small codes,
    negative deltas representable — out-of-order timestamps survive)."""
    ud = d.view(np.uint64)
    return (ud << _ZZ_ONE) ^ (np.uint64(0) - (ud >> np.uint64(63)))


def _unzigzag(zz: np.ndarray) -> np.ndarray:
    zz = zz.astype(np.uint64, copy=False)
    return ((zz >> _ZZ_ONE) ^ (np.uint64(0) - (zz & _ZZ_ONE))).view(
        np.int64)


def _enc_u32_column(vals: np.ndarray) -> bytes:
    """One id column, whichever of width-packing / dictionary coding
    is smaller for THIS frame (dictionary wins when values repeat —
    lecture days; packing wins on high-cardinality columns — student
    ids over a large roster)."""
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    n = len(vals)
    vmax = int(vals.max()) if n else 0
    w = next(k for k in _ID_WIDTHS if vmax < (1 << (8 * k)))
    packed_size = 1 + n * w
    uniq, inv = np.unique(vals, return_inverse=True)
    iw = 1 if len(uniq) <= 0xFF else 2 if len(uniq) <= 0xFFFF else 4
    dict_size = 5 + 4 * len(uniq) + 1 + n * iw
    if dict_size < packed_size:
        return b"".join([
            b"\x01", np.uint32(len(uniq)).tobytes(), uniq.tobytes(),
            bytes([iw]), inv.astype(f"<u{iw}").tobytes()])
    if w == 3:
        b = np.empty((n, 3), np.uint8)
        b[:, 0] = vals & 0xFF
        b[:, 1] = (vals >> 8) & 0xFF
        b[:, 2] = (vals >> 16) & 0xFF
        body = b.tobytes()
    else:
        body = vals.astype(f"<u{w}").tobytes()
    return b"\x00" + bytes([w]) + body


def _dec_u32_column(buf, off: int, n: int):
    """-> (uint32 values, next offset); bounds- and index-checked."""
    mode = _read_u8(buf, off)
    off += 1
    if mode == 0:
        w = _read_u8(buf, off)
        off += 1
        if w not in _ID_WIDTHS:
            raise ValueError(f"COLW: bad packed id width {w}")
        end = off + n * w
        _check_room(buf, end, "packed ids")
        if w == 3:
            b = np.frombuffer(buf, np.uint8, count=3 * n,
                              offset=off).reshape(n, 3).astype(np.uint32)
            vals = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        else:
            vals = np.frombuffer(buf, f"<u{w}", count=n,
                                 offset=off).astype(np.uint32)
        return vals, end
    if mode != 1:
        raise ValueError(f"COLW: unknown id-column mode {mode}")
    _check_room(buf, off + 4, "dict header")
    (k,) = np.frombuffer(buf, np.uint32, count=1, offset=off)
    k = int(k)
    off += 4
    end = off + 4 * k
    _check_room(buf, end, "dict values")
    dic = np.frombuffer(buf, np.uint32, count=k, offset=off)
    off = end
    iw = _read_u8(buf, off)
    off += 1
    if iw not in (1, 2, 4):
        raise ValueError(f"COLW: bad dict index width {iw}")
    end = off + n * iw
    _check_room(buf, end, "dict indices")
    idx = np.frombuffer(buf, f"<u{iw}", count=n, offset=off)
    if n and (k == 0 or int(idx.max()) >= k):
        # A dictionary miss is decoder-fatal BY DESIGN: an index past
        # the dictionary can only mean frame corruption (or an encoder
        # bug), and guessing a value would silently mutate events.
        raise ValueError("COLW: dictionary index out of range "
                         f"(k={k}, max index={int(idx.max()) if n else 0})")
    return dic[idx], end


def _read_u8(buf, off: int) -> int:
    _check_room(buf, off + 1, "header byte")
    return buf[off]


def _check_room(buf, end: int, what: str) -> None:
    if end > len(buf):
        raise ValueError(f"COLW: truncated frame ({what} ends at "
                         f"{end}, frame is {len(buf)} bytes)")


def encode_columnar_batch(cols: Dict[str, np.ndarray], *,
                          checksum: bool = True) -> bytes:
    """Columns -> one COLW frame (the producer-side encoder).

    ``checksum=True`` (the default, and what every shipping producer
    uses) wraps the body in the checksummed framing so the decode side
    rejects in-flight rot loudly; ``False`` emits the bare body (tests
    exercising the legacy-frame tolerance)."""
    micros = np.ascontiguousarray(cols["micros"], dtype=np.int64)
    n = len(micros)
    parts = [COLW_MAGIC, np.uint32(n).tobytes()]
    base = int(micros[0]) if n else 0
    parts.append(np.int64(base).tobytes())
    if n > 1:
        zz = _zigzag(np.diff(micros))
        m = int(zz.max())
        ts_w = (0 if m == 0 else 1 if m < (1 << 8) else
                2 if m < (1 << 16) else 3 if m < (1 << 24) else
                4 if m < (1 << 32) else 8)
    else:
        ts_w = 0
    parts.append(bytes([ts_w]))
    if ts_w == 3:
        b = np.empty((n - 1, 3), np.uint8)
        b[:, 0] = zz & np.uint64(0xFF)
        b[:, 1] = (zz >> np.uint64(8)) & np.uint64(0xFF)
        b[:, 2] = (zz >> np.uint64(16)) & np.uint64(0xFF)
        parts.append(b.tobytes())
    elif ts_w:
        parts.append(zz.astype(f"<u{ts_w}").tobytes())
    parts.append(_enc_u32_column(cols["student_id"]))
    parts.append(_enc_u32_column(cols["lecture_day"]))
    flags = (np.asarray(cols["is_valid"]).astype(np.uint8)
             | (np.asarray(cols["event_type"]).astype(np.uint8) << 1))
    pad = (-n) % 4
    if pad:
        flags = np.concatenate([flags, np.zeros(pad, np.uint8)])
    f4 = flags.reshape(-1, 4)
    parts.append((f4[:, 0] | (f4[:, 1] << 2) | (f4[:, 2] << 4)
                  | (f4[:, 3] << 6)).astype(np.uint8).tobytes())
    body = b"".join(parts)
    if not checksum:
        return body
    from attendance_tpu_torch.transport.framing import enc_checksummed
    return enc_checksummed(body)


def _colw_body_offset(data) -> "int | None":
    """Offset of the COLW body inside ``data`` (0 for a bare frame,
    past the checksum header for a wrapped one), or None if ``data``
    is not a COLW frame at all.  Does NOT verify the digest — sizing
    probes must stay O(1); decode verifies."""
    if magic_match(data, COLW_MAGIC):
        return 0
    if magic_match(data, _CK_MAGIC):
        off = len(_CK_MAGIC) + _CK_DIGEST_LEN
        if magic_match(data[off:off + len(COLW_MAGIC)], COLW_MAGIC):
            return off
    return None


def decode_columnar_frame(data,
                          include_truth: bool = True
                          ) -> Dict[str, np.ndarray]:
    """One COLW frame -> column arrays: a handful of vectorized numpy
    passes (frombuffer + cumsum + dictionary gather), no per-event
    Python.  A checksum-wrapped frame is VERIFIED first — rot raises
    ``FrameChecksumError`` (a ValueError), taking the poison/DLQ path;
    a bare body decodes with the same structural validation (the
    legacy-frame tolerance the checksummed framing documents)."""
    if magic_match(data, _CK_MAGIC):
        from attendance_tpu_torch.transport.framing import dec_checksummed
        data, _verified = dec_checksummed(bytes(data))
    if not magic_match(data, COLW_MAGIC):
        raise ValueError("not a COLW columnar frame")
    buf = bytes(data) if not isinstance(data, bytes) else data
    off = len(COLW_MAGIC)
    _check_room(buf, off + 4, "event count")
    (n,) = np.frombuffer(buf, np.uint32, count=1, offset=off)
    n = int(n)
    off += 4
    # Bound the untrusted count BEFORE any allocation sized by it: the
    # flags section alone costs n/4 bytes, so a frame can never hold
    # more than 4x its own size in events — a corrupt bare header
    # (the unchecksummed legacy-tolerance path) must raise here, not
    # attempt a multi-GB np.full.
    if n > 4 * len(buf):
        raise ValueError(f"COLW: event count {n} impossible for a "
                         f"{len(buf)}-byte frame")
    _check_room(buf, off + 9, "timestamp header")
    (base,) = np.frombuffer(buf, np.int64, count=1, offset=off)
    off += 8
    ts_w = buf[off]
    off += 1
    micros = np.full(n, int(base), np.int64)
    if n > 1:
        if ts_w not in (0, 1, 2, 3, 4, 8):
            raise ValueError(f"COLW: bad timestamp delta width {ts_w}")
        if ts_w:
            end = off + (n - 1) * ts_w
            _check_room(buf, end, "timestamp deltas")
            if ts_w == 3:
                b = np.frombuffer(buf, np.uint8, count=3 * (n - 1),
                                  offset=off).reshape(n - 1, 3).astype(
                                      np.uint64)
                zz = b[:, 0] | (b[:, 1] << np.uint64(8)) \
                    | (b[:, 2] << np.uint64(16))
            else:
                zz = np.frombuffer(buf, f"<u{ts_w}", count=n - 1,
                                   offset=off)
            off = end
            np.cumsum(_unzigzag(zz), out=micros[1:])
            micros[1:] += base
    student, off = _dec_u32_column(buf, off, n)
    day, off = _dec_u32_column(buf, off, n)
    nf = (n + 3) // 4
    end = off + nf
    _check_room(buf, end, "flags")
    packed = np.frombuffer(buf, np.uint8, count=nf, offset=off)
    if end != len(buf):
        raise ValueError(f"COLW: {len(buf) - end} trailing bytes")
    f = np.empty(nf * 4, np.uint8)
    f[0::4] = packed & 3
    f[1::4] = (packed >> 2) & 3
    f[2::4] = (packed >> 4) & 3
    f[3::4] = (packed >> 6) & 3
    f = f[:n]
    cols = {
        "student_id": student,
        "lecture_day": day,
        "micros": micros,
        "event_type": ((f >> 1) & 1).astype(np.int8),
    }
    if include_truth:
        cols["is_valid"] = (f & 1).astype(bool)
    return cols


def columnar_wire_bytes_per_event(frames) -> float:
    """Wire bytes per event over encoded COLW frames."""
    total_bytes = sum(len(f) for f in frames)
    total_events = sum(frame_event_count(f) for f in frames)
    return total_bytes / total_events if total_events else 0.0


# ---------------------------------------------------------------------------
# Vectorized JSON batch scanner
# ---------------------------------------------------------------------------
# The reference producer emits json.dumps(dict) with default separators
# and a fixed key order (the reference's data_generator.py):
#   {"student_id": N, "timestamp": "...", "lecture_id": "LECTURE_...",
#    "is_valid": true|false, "event_type": "entry"|"exit"}
# The scanner verifies that exact shape vectorized over the whole
# chunk; any payload deviating (escapes, timezone suffixes, odd
# fraction widths, non-LECTURE ids needing murmur3, reordered keys)
# drops to the per-row Python codec, so results are always identical
# to decode_event.

_L_SID = b'{"student_id": '
_L_TS = b', "timestamp": "'
_L_LID = b'", "lecture_id": "LECTURE_'
_L_VALID = b'", "is_valid": '
_L_TRUE = b"true"
_L_FALSE = b"false"
_L_ETYPE = b', "event_type": "'
_L_ENTRY = b'entry'
_L_EXIT = b'exit'
_L_END = b'"}'

_US_PER_DAY = 86_400_000_000


def scan_json_batch_columns(payloads: Sequence[bytes]
                            ) -> Dict[str, np.ndarray]:
    """Whole-chunk vectorized JSON decode: one join and numpy passes over
    the joined bytes, no per-event Python for fast-shape payloads.
    Raises on malformed JSON exactly like ``decode_event`` (through the
    row fallback)."""
    n = len(payloads)
    student = np.zeros(n, np.uint32)
    day = np.zeros(n, np.uint32)
    micros = np.zeros(n, np.int64)
    valid = np.zeros(n, bool)
    etype = np.zeros(n, np.int8)
    cols = {"student_id": student, "lecture_day": day, "micros": micros,
            "is_valid": valid, "event_type": etype}
    if n == 0:
        return cols
    lens = np.fromiter((len(p) for p in payloads), np.int64, n)
    buf = b"".join(bytes(p) if not isinstance(p, bytes) else p
                   for p in payloads)
    arr = np.frombuffer(buf, np.uint8)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    ends = starts + lens
    ok = np.ones(n, bool)
    safe_hi = max(arr.size - 1, 0)

    # Positional reads never bounds-check against each payload's own
    # end: a short payload either mismatches the next literal, or runs
    # its cursor past its end and fails the final ``pos == ends``
    # fence — both route it to the exact row fallback.  Only the
    # buffer-global clamp is needed for safe gathers.

    def gather2(pos, width: int):
        """(n, width) byte window starting at each payload's cursor —
        ONE fancy-index per field instead of one per character."""
        idx = pos[:, None] + np.arange(width, dtype=np.int64)
        np.minimum(idx, safe_hi, out=idx)
        return arr[idx]

    def check_lit(pos, lit: bytes):
        w = gather2(pos, len(lit))
        np.logical_and(
            ok, (w == np.frombuffer(lit, np.uint8)).all(axis=1), out=ok)
        return pos + len(lit)

    def digits_window(w):
        """Byte window -> per-column digit values + all-digits mask."""
        d = w.astype(np.int64) - 48
        return d, ((d >= 0) & (d <= 9)).all(axis=1)

    def var_digits(pos, max_digits: int):
        """Variable-width unsigned int ending at the first non-digit;
        ok requires 1..max_digits digits."""
        w = gather2(pos, max_digits + 1)
        d = w.astype(np.int64) - 48
        is_d = ((d >= 0) & (d <= 9)
                & (pos[:, None] + np.arange(max_digits + 1)
                   < ends[:, None]))
        width = np.argmin(is_d, axis=1)  # first non-digit column
        np.logical_and(ok, (width >= 1) & (width <= max_digits), out=ok)
        val = np.zeros(n, np.int64)
        for k in range(max_digits):
            val = np.where(k < width, val * 10 + d[:, k], val)
        return val, width, pos + width

    pos = check_lit(starts, _L_SID)
    sid, _, pos = var_digits(pos, 10)
    pos = check_lit(pos, _L_TS)
    # The whole "YYYY-MM-DDTHH:MM:SS" timestamp in ONE gather.
    ts = gather2(pos, 19)
    np.logical_and(ok, (ts[:, 4] == ord("-")) & (ts[:, 7] == ord("-"))
                   & (ts[:, 10] == ord("T")) & (ts[:, 13] == ord(":"))
                   & (ts[:, 16] == ord(":")), out=ok)
    td, tmask = digits_window(
        ts[:, (0, 1, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18)])
    np.logical_and(ok, tmask, out=ok)
    year = td[:, 0] * 1000 + td[:, 1] * 100 + td[:, 2] * 10 + td[:, 3]
    month = td[:, 4] * 10 + td[:, 5]
    mday = td[:, 6] * 10 + td[:, 7]
    hh = td[:, 8] * 10 + td[:, 9]
    mm = td[:, 10] * 10 + td[:, 11]
    ss = td[:, 12] * 10 + td[:, 13]
    pos = pos + 19
    np.logical_and(ok, (month >= 1) & (month <= 12)
                   & (mday >= 1) & (mday <= 31)
                   & (hh <= 23) & (mm <= 59) & (ss <= 59), out=ok)
    # Optional exactly-6-digit fraction (datetime.isoformat emits six
    # or none); other widths / timezone suffixes take the row fallback.
    fw = gather2(pos, 7)
    has_frac = fw[:, 0] == ord(".")
    fd, fmask = digits_window(fw[:, 1:])
    np.logical_and(ok, ~has_frac | fmask, out=ok)
    frac = np.where(
        has_frac,
        fd @ np.array([100_000, 10_000, 1_000, 100, 10, 1], np.int64),
        0)
    pos = np.where(has_frac, pos + 7, pos)
    # days-from-civil (proleptic Gregorian; matches
    # datetime.fromisoformat + UTC pin in events.iso_to_micros).
    y = year - (month <= 2)
    era = y // 400
    yoe = y - era * 400
    mp = np.where(month > 2, month - 3, month + 9)
    doy = (153 * mp + 2) // 5 + mday - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    days = era * 146097 + doe - 719468
    ts_us = (days * _US_PER_DAY + hh * 3_600_000_000
             + mm * 60_000_000 + ss * 1_000_000 + frac)

    pos = check_lit(pos, _L_LID)
    dayval, dwidth, pos = var_digits(pos, 10)
    # Same semantics as events.lecture_to_day for digit tails: 8
    # digits = the calendar day; 9 digits inside the hash range = an
    # already-hashed code round-tripping.  Everything else (short
    # tails, out-of-range codes, non-digit ids) needs murmur3 — the
    # row fallback owns those.
    np.logical_and(ok, (dwidth == 8)
                   | ((dwidth == 9) & (dayval >= _HASH_DAY_BASE)
                      & (dayval < _HASH_DAY_LIMIT)), out=ok)
    pos = check_lit(pos, _L_VALID)
    vw = gather2(pos, 5)
    is_true = ((vw[:, :4]
                == np.frombuffer(_L_TRUE, np.uint8)).all(axis=1))
    is_false = ((vw == np.frombuffer(_L_FALSE, np.uint8)).all(axis=1))
    np.logical_and(ok, is_true | is_false, out=ok)
    pos = pos + np.where(is_true, len(_L_TRUE), len(_L_FALSE))
    pos = check_lit(pos, _L_ETYPE)
    ew = gather2(pos, 5)
    is_entry = ((ew == np.frombuffer(_L_ENTRY, np.uint8)).all(axis=1))
    is_exit = ((ew[:, :4]
                == np.frombuffer(_L_EXIT, np.uint8)).all(axis=1))
    np.logical_and(ok, is_entry | is_exit, out=ok)
    pos = pos + np.where(is_exit, len(_L_EXIT), len(_L_ENTRY))
    pos = check_lit(pos, _L_END)
    np.logical_and(ok, pos == ends, out=ok)

    student[:] = np.where(ok, sid & 0xFFFFFFFF, 0).astype(np.uint32)
    day[:] = np.where(ok, dayval, 0).astype(np.uint32)
    micros[:] = np.where(ok, ts_us, 0)
    valid[:] = ok & is_true
    etype[:] = np.where(ok & is_exit, 1, 0).astype(np.int8)

    misses = np.nonzero(~ok)[0]
    for i in misses.tolist():
        # The exact Python codec for non-fast-shape payloads — raises
        # on malformed JSON, like every decode in events.py.
        row = columns_from_events([decode_event(bytes(payloads[i]))])
        student[i] = row["student_id"][0]
        day[i] = row["lecture_day"][0]
        micros[i] = row["micros"][0]
        valid[i] = row["is_valid"][0]
        etype[i] = row["event_type"][0]
    return cols


__all__: List[str] = [
    "IngressCodec", "JsonCodec", "BinaryCodec", "ColumnarCodec",
    "CODECS", "get_codec", "codec_for_frame", "decode_frame",
    "frame_event_count", "merge_columns", "scan_json_batch_columns",
    "COLUMN_KEYS", "COLW_MAGIC", "encode_columnar_batch",
    "decode_columnar_frame", "columnar_wire_bytes_per_event",
]
