"""Integrity of the durable snapshot chain: digests, classified errors
and quarantine.

Counterpart of the subset of ``attendance_tpu/utils/integrity.py`` that
the fused pipeline's chain reads and writes: one sha256 spelling (hex)
for every file CHAIN.json records (``base_digest``, ``digests``), a
classified :class:`ChainIntegrityError` that restore's repair ladder
acts on, the structural zip-CRC check of an npz that carries no digest,
and :func:`quarantine_artifact`, which moves a corrupt file aside with a
JSON sidecar naming why. Every detected corruption is counted by kind in
:data:`corrupt_counts` (:func:`count_corrupt`; the JAX package counts
into its telemetry registry). The digests are the JAX package's, so each
package verifies the other's chains.
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

QUARANTINE_SUBDIR = "integrity-quarantine"

# Durable artifacts that failed verification, by kind (quarantined,
# never served): restore's ladder and the serve chain reader count here.
corrupt_counts: Counter = Counter()


def count_corrupt(kind: str) -> None:
    """Count one detected corruption of ``kind``."""
    corrupt_counts[kind] += 1


class IntegrityError(ValueError):
    """A durable artifact failed verification."""


class ChainIntegrityError(IntegrityError):
    """A snapshot-chain artifact failed verification, classified.

    ``kind`` is one of:

    * ``digest_mismatch``: the file's bytes no longer hash to the digest
      its manifest recorded (bit rot, torn or partial rewrite);
    * ``missing``: the manifest names a file that does not exist;
    * ``torn_manifest``: the manifest JSON itself is unreadable;
    * ``unreadable``: the file exists, no digest was recorded, and it
      fails to parse.
    """

    def __init__(self, kind: str, path, detail: str = "",
                 expected: str = ""):
        self.kind = kind
        self.path = Path(path)
        self.detail = detail
        # The recorded digest (digest_mismatch only), carried into the
        # quarantine sidecar as expected_sha256.
        self.expected = expected
        super().__init__(
            f"{kind} at {path}" + (f": {detail}" if detail else ""))


def bytes_digest(data: bytes) -> str:
    """Hex sha256 of a byte string."""
    return hashlib.sha256(bytes(data)).hexdigest()


def file_digest(path, chunk_size: int = 1 << 20) -> str:
    """Streaming hex sha256 of a file."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def verify_file(path, expected: str) -> None:
    """Raise :class:`ChainIntegrityError` unless ``path`` exists and
    hashes to ``expected``."""
    p = Path(path)
    if not p.exists():
        raise ChainIntegrityError("missing", p)
    actual = file_digest(p)
    if actual != expected:
        raise ChainIntegrityError(
            "digest_mismatch", p,
            f"recorded {expected[:12]}…, on disk {actual[:12]}…",
            expected=expected)


def structural_npz_check(path) -> Optional[str]:
    """Does the npz parse, every entry read through its zip CRC? Returns
    a failure detail, or None when it is clean."""
    try:
        with np.load(path) as data:
            for name in data.files:
                data[name]
    except Exception as exc:  # noqa: BLE001 — any parse failure is rot
        return f"{type(exc).__name__}: {exc}"
    return None


def quarantine_artifact(path, *, reason: str, expected_digest: str = "",
                        detail: str = "") -> Optional[Path]:
    """Move a corrupt artifact into ``<dir>/integrity-quarantine/`` and
    write a JSON sidecar naming why; the bytes survive for triage and
    readers stop tripping over them. Returns the quarantined path, or
    None when the file was already gone."""
    p = Path(path)
    if not p.exists():
        return None
    qdir = p.parent / QUARANTINE_SUBDIR
    qdir.mkdir(parents=True, exist_ok=True)
    dest = qdir / p.name
    n = 0
    while dest.exists():  # repeated corruption of a recycled name
        n += 1
        dest = qdir / f"{p.name}.{n}"
    meta = {"ts": round(time.time(), 3), "reason": reason,
            "detail": detail, "original": str(p)}
    try:
        meta["sha256"] = file_digest(p)
    except OSError:
        pass
    if expected_digest:
        meta["expected_sha256"] = expected_digest
    p.replace(dest)
    sidecar = dest.with_name(dest.name + ".quarantine.json")
    sidecar.write_text(json.dumps(meta, sort_keys=True))
    count_corrupt(reason)
    logger.error("quarantined corrupt artifact %s -> %s (%s%s)", p, dest,
                 reason, f": {detail}" if detail else "")
    return dest
