"""Versioned merge-frame wire of the fence gossip.

Counterpart of ``attendance_tpu/federation/frames.py``, byte for byte:
the same header fields in the same order, the same array layout and the
same version gate, so each package decodes the other's frames. One frame
carries one worker's sketch contribution at a snapshot fence: the
dirty-bank DELTA the barrier's capture made durable (``kind="delta"``:
bank rows and the worker's day -> bank map), or the FULL state
(``kind="full"``: packed Bloom words and every register bank, at
preload, restore, base snapshots and chain recovery), plus array-less
``heartbeat`` frames that keep liveness observable between fences and
``repair_request`` frames (a worker whose chain restore met a corrupt
file asks the aggregator to re-assert its retained contribution as a
full frame on ``<topic>.reassert.<worker>``).

Every frame is published through the checksummed framing variant
(``transport.framing.enc_checksummed``), so in-flight rot is rejected at
the fold. Wire layout (little-endian), on :mod:`transport.framing`:

    u16 version (= FRAME_VERSION)
    props block   — the JSON header (framing.enc_props)
    u16 n_arrays
    per array: props block {name} + framing.enc_array payload

The header names what the merge needs to fold the frame without
trusting arrival order: the worker id, its monotonic ``incarnation`` (a
takeover of the same id gets a larger one) and per-incarnation ``seq``,
the owned ``shard``, the fence's wall clock ``fence_ts`` (the merge-lag
clock), the cumulative ``events`` / ``roster_size`` counters, the sketch
geometry (``m_bits`` / ``k`` / ``precision``, so mismatched
configurations fail loudly), and the worker's ``bank_of`` map for the
rows carried. The ``traceparent`` field is always present: a worker
that traces writes its ``fence_publish`` span's context there (from the
tracer, ``obs.tracing.format_ctx``), and a worker without tracing
writes ``""``.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

from attendance_tpu_torch.transport.framing import (
    dec_array, dec_props, enc_array, enc_props)

FRAME_VERSION = 1

KINDS = ("full", "delta", "heartbeat", "repair_request")

_U16 = struct.Struct("<H")


class MergeFrame:
    """A decoded gossip frame: ``header`` dict + named numpy arrays."""

    __slots__ = ("header", "arrays")

    def __init__(self, header: Dict, arrays: Dict[str, np.ndarray]):
        self.header = header
        self.arrays = arrays

    def __getattr__(self, name):
        try:
            return self.header[name]
        except KeyError:
            raise AttributeError(name) from None


def encode_frame(*, worker: str, kind: str, incarnation: float,
                 seq: int, shard: int, fence_ts: float, events: int,
                 bank_of: Optional[Dict[int, int]] = None,
                 m_bits: int = 0, k: int = 0, precision: int = 14,
                 num_banks: int = 0, roster_size: int = 0,
                 snapshot_dir: str = "", traceparent: str = "",
                 arrays: Optional[Dict[str, np.ndarray]] = None
                 ) -> bytes:
    """Serialize one merge frame. ``arrays`` by kind:

    * ``full``: ``bloom`` u32[m_words] (absent before a preload),
      ``regs`` u8[num_banks, 2^p], ``counts`` u32[2, 2];
    * ``delta``: ``bank_idx`` i32[n], ``rows`` u8[n, 2^p],
      ``counts`` u32[2, 2];
    * ``heartbeat``, ``repair_request``: none.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown merge-frame kind {kind!r}")
    header = {
        "worker": worker, "kind": kind,
        "incarnation": float(incarnation), "seq": int(seq),
        "shard": int(shard), "fence_ts": float(fence_ts),
        "events": int(events), "roster_size": int(roster_size),
        "m_bits": int(m_bits), "k": int(k),
        "precision": int(precision), "num_banks": int(num_banks),
        "snapshot_dir": snapshot_dir,
        "traceparent": traceparent,
        # day -> bank as a JSON-safe {str(day): bank} map, as the
        # snapshot manifests spell it.
        "bank_of": {str(d): int(b)
                    for d, b in (bank_of or {}).items()},
    }
    arrays = arrays or {}
    parts = [_U16.pack(FRAME_VERSION), enc_props(header),
             _U16.pack(len(arrays))]
    for name, arr in arrays.items():
        parts.append(enc_props({"name": name}))
        parts.append(enc_array(arr))
    return b"".join(parts)


def decode_frame(data: bytes) -> MergeFrame:
    """Parse one merge frame; raises ValueError on another version (a
    rolling upgrade must fail loudly, not mis-merge) or a malformed
    header."""
    (version,) = _U16.unpack_from(data)
    if version != FRAME_VERSION:
        raise ValueError(
            f"merge frame version {version} (this build speaks "
            f"{FRAME_VERSION}) — upgrade the older peer")
    header, off = dec_props(data, _U16.size)
    if header is None or header.get("kind") not in KINDS:
        raise ValueError("malformed merge frame header")
    header["bank_of"] = {int(d): int(b)
                         for d, b in header.get("bank_of", {}).items()}
    (n_arrays,) = _U16.unpack_from(data, off)
    off += _U16.size
    arrays: Dict[str, np.ndarray] = {}
    for _ in range(n_arrays):
        meta, off = dec_props(data, off)
        arr, off = dec_array(data, off)
        arrays[meta["name"]] = arr
    return MergeFrame(header, arrays)
