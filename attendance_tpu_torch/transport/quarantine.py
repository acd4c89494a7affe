"""On-disk quarantine for dead-lettered frames (the durable DLQ).

Counterpart of ``attendance_tpu/transport/quarantine.py``, byte-compatible
on disk, so entries written by either package list and replay in the
other. ``handle_poison`` bounds a poison frame's retries and acks it;
with ``quarantine_dir`` set it writes the frame here first, so the only
copy survives as a file that can be inspected and replayed.

Layout (one quarantine directory per consumer role)::

    <dir>/q-000001.frame   raw payload bytes, fsync'd first
    <dir>/q-000001.json    metadata sidecar; its presence commits the
                           entry (a crash between the two writes leaves
                           an ignored orphan .frame)

Metadata: ``ts`` (epoch seconds), ``topic``, ``reason``,
``redeliveries``, ``bytes``, ``sha256`` (the payload's digest) and
``properties`` (the broker message properties).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from attendance_tpu_torch.utils.integrity import bytes_digest

logger = logging.getLogger(__name__)

_FRAME_SUFFIX = ".frame"
_META_SUFFIX = ".json"

_instances: dict = {}
_instances_lock = threading.Lock()


def get_quarantine(directory) -> "Quarantine":
    """Process-cached Quarantine per directory (a fresh instance globs
    the directory for its sequence). Writers in other processes stay
    safe through the O_EXCL frame create."""
    key = str(Path(directory))
    with _instances_lock:
        q = _instances.get(key)
        if q is None:
            q = _instances[key] = Quarantine(directory)
        return q


def _fsync_write(path: Path, data: bytes, exclusive: bool = False) -> None:
    with open(path, "xb" if exclusive else "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class Quarantine:
    """Writer half: appends dead-lettered frames to a directory."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._seq = max(
            (int(p.stem.split("-")[1]) for p in
             self.dir.glob(f"q-*{_FRAME_SUFFIX}")), default=0)

    def put(self, data: bytes, *, topic: str = "", reason: str = "",
            redeliveries: int = 0,
            properties: Optional[dict] = None) -> Path:
        """Durably quarantine one frame; returns the frame path. The
        metadata sidecar lands (fsync'd) AFTER the frame bytes — its
        presence is the commit point listings honor. The frame file is
        created EXCLUSIVELY (O_EXCL) with seq-bump retry, so competing
        writers sharing one directory — other processes, or per-call
        Quarantine instances that derived the same next seq from the
        same glob — can never overwrite each other's only copy."""
        while True:
            with self._lock:
                self._seq += 1
                stem = f"q-{self._seq:06d}"
            frame = self.dir / (stem + _FRAME_SUFFIX)
            try:
                _fsync_write(frame, bytes(data), exclusive=True)
                break
            except FileExistsError:
                continue  # another writer owns this seq: take the next
        meta = {
            "ts": round(time.time(), 3),
            "topic": topic,
            "reason": reason,
            "redeliveries": int(redeliveries),
            "bytes": len(data),
            "sha256": bytes_digest(data),
        }
        if properties:
            meta["properties"] = dict(properties)
        _fsync_write(self.dir / (stem + _META_SUFFIX),
                     json.dumps(meta, sort_keys=True).encode())
        from attendance_tpu_torch import obs
        t = obs.get()
        if t is not None:
            t.registry.counter(
                "attendance_quarantined_frames_total",
                help="Frames dead-lettered into the on-disk quarantine",
                reason=reason or "unknown").inc()
        logger.error("Quarantined %d-byte frame after %d redeliveries "
                     "-> %s (%s)", len(data), redeliveries, frame,
                     reason or "unspecified")
        return frame


def list_entries(directory) -> List[Dict]:
    """Committed quarantine entries (metadata + frame path), in
    quarantine order. Orphan ``.frame`` files without a sidecar (a
    crash mid-put) are skipped — their frame was never acked, so it
    redelivers through the broker anyway."""
    d = Path(directory)
    if not d.is_dir():
        return []
    out = []
    for meta_path in sorted(d.glob(f"q-*{_META_SUFFIX}")):
        frame = meta_path.with_suffix(_FRAME_SUFFIX)
        if not frame.exists():
            continue
        try:
            meta = json.loads(meta_path.read_text())
        except (json.JSONDecodeError, OSError):
            logger.warning("unreadable quarantine sidecar %s", meta_path)
            continue
        meta["frame"] = str(frame)
        meta["name"] = meta_path.stem
        out.append(meta)
    return out


def replay(directory, producer, *, remove: bool = False) -> int:
    """Republish every committed entry's frame bytes through
    ``producer`` (original message properties reattached); returns the
    count. With
    ``remove`` the entry's files are deleted AFTER its publish returns
    — a replay interrupted midway leaves the tail quarantined."""
    n = 0
    for entry in list_entries(directory):
        frame = Path(entry["frame"])
        data = frame.read_bytes()
        producer.send(data, entry.get("properties") or None)
        n += 1
        if remove:
            for path in (frame, frame.with_suffix(_META_SUFFIX)):
                try:
                    path.unlink()
                except OSError:
                    pass
    return n
