"""The length-prefixed wire framing of every socket surface.

Counterpart of ``attendance_tpu/transport/framing.py``, byte for byte,
so a port client talks to a JAX socket broker and the other way round.

Frame shape (little-endian): ``u8 code, u32 body_len, body``; ``code``
is an opcode on requests and a status on replies. Properties are a
u32-length-prefixed compact JSON dict (length 0 = none). A message batch
(the chunk lane's reply carrying broker deliveries) is ``u64 chunk_id,
u32 count`` followed per message by ``u64 message_id, u32 redeliveries,
u32 data_len``, the props block, then the payload bytes. A checksummed
frame (``CKF1``) is the magic, the raw sha256 of the body, then the
body.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import List, Optional, Tuple

HDR = struct.Struct("<BI")

_U32 = struct.Struct("<I")
_BATCH_HDR = struct.Struct("<QI")
_MSG_HDR = struct.Struct("<QII")


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError on EOF."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, code: int, body: bytes) -> None:
    sock.sendall(HDR.pack(code, len(body)) + body)


def recv_frame(sock: socket.socket) -> Tuple[int, bytes]:
    code, blen = HDR.unpack(recv_exact(sock, HDR.size))
    return code, recv_exact(sock, blen) if blen else b""


def enc_props(props) -> bytes:
    """u32-length-prefixed compact JSON dict; empty/None = zero length."""
    if not props:
        return _U32.pack(0)
    body = json.dumps(props, separators=(",", ":")).encode()
    return _U32.pack(len(body)) + body


def dec_props(body: bytes, off: int):
    """-> (props_or_None, next_offset)."""
    (plen,) = _U32.unpack_from(body, off)
    off += 4
    if not plen:
        return None, off
    return json.loads(body[off:off + plen]), off + plen


def enc_message_batch(chunk_id: int, msgs) -> bytes:
    """Encode one delivery batch: ``msgs`` is a sequence of
    ``(message_id, data, redeliveries, props)`` tuples (the broker's
    raw delivery shape)."""
    parts = [_BATCH_HDR.pack(chunk_id, len(msgs))]
    for mid, data, red, props in msgs:
        parts.append(_MSG_HDR.pack(mid, red, len(data)))
        parts.append(enc_props(props))
        parts.append(data)
    return b"".join(parts)


def dec_message_batch(body: bytes) -> Tuple[int, List[tuple]]:
    """Decode one delivery batch -> (chunk_id, [(mid, data, red,
    props)]). Payloads are bytes copies: the frame decoders take bytes
    objects."""
    cid, count = _BATCH_HDR.unpack_from(body)
    out: List[tuple] = []
    off = _BATCH_HDR.size
    for _ in range(count):
        mid, red, dlen = _MSG_HDR.unpack_from(body, off)
        off += _MSG_HDR.size
        props, off = dec_props(body, off)
        out.append((mid, body[off:off + dlen], red, props))
        off += dlen
    return cid, out


def enc_str(s: str) -> bytes:
    """u16-length-prefixed UTF-8 string (topic/subscription fields)."""
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def dec_str(body: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<H", body, off)
    off += 2
    return body[off:off + n].decode(), off + n


CK_MAGIC = b"CKF1"


class FrameChecksumError(ValueError):
    """A checksummed frame's body no longer hashes to its header digest
    (in-flight rot): rejected, never folded."""


def enc_checksummed(body: bytes) -> bytes:
    """The checksummed frame: magic + raw sha256(body) + body (the
    spill record's ``utils.integrity.wrap_record`` with its own
    magic)."""
    from attendance_tpu_torch.utils.integrity import wrap_record

    return wrap_record(body, magic=CK_MAGIC)


def dec_checksummed(data: bytes):
    """-> (body, verified). A frame without the magic is a legacy frame
    and passes through unverified (``verified=False``); a wrapped frame
    whose digest no longer matches raises :class:`FrameChecksumError`."""
    from attendance_tpu_torch.utils.integrity import (
        IntegrityError, unwrap_record)

    try:
        return unwrap_record(data, magic=CK_MAGIC)
    except IntegrityError as exc:
        raise FrameChecksumError(
            f"checksummed frame failed verification ({exc} — "
            "in-flight corruption)") from None


def enc_array(arr) -> bytes:
    """One numpy array with a self-describing u32-prefixed header (dtype
    as the portable ``np.dtype.str`` spelling, shape), then its bytes."""
    import numpy as np

    arr = np.ascontiguousarray(arr)
    hdr = enc_props({"dtype": arr.dtype.str, "shape": list(arr.shape)})
    raw = arr.tobytes()
    return hdr + _U32.pack(len(raw)) + raw


def dec_array(body: bytes, off: int):
    """-> (array, next_offset); the array is a copy of the buffer."""
    import numpy as np

    hdr, off = dec_props(body, off)
    (nbytes,) = _U32.unpack_from(body, off)
    off += 4
    arr = np.frombuffer(body, dtype=np.dtype(hdr["dtype"]),
                        count=int(np.prod(hdr["shape"], dtype=np.int64))
                        if hdr["shape"] else 1,
                        offset=off)
    return arr.reshape(hdr["shape"]).copy(), off + nbytes
