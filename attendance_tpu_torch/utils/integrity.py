"""The integrity plane of the durable artifacts: digests, checksummed
records, classified errors, quarantine, scrub and the disk fault hooks.

Counterpart of ``attendance_tpu/utils/integrity.py``: one sha256 spelling
(hex) for every file a manifest records (CHAIN.json ``base_digest`` and
``digests``, MANIFEST.json ``digests``), the quarantine sidecar and the
spill record header; :func:`wrap_record` / :func:`unwrap_record`, the
checksummed record (magic + raw sha256 + payload) of the persist spill
and of the checksummed wire frames; a classified
:class:`ChainIntegrityError` that restore's repair ladder acts on; the
structural zip-CRC check of an npz that carries no digest;
:func:`quarantine_artifact`, which moves a corrupt file aside with a
JSON sidecar naming why; :func:`scrub_paths` / :func:`scrub_report`, the
offline walker of the ``scrub`` verb (every artifact ok, legacy, orphan,
stale-digest or CORRUPT with its class, the same table text as the JAX
package's); and the chaos plane's hooks at the durable-write seam
(``enospc`` before a write, ``disk_corrupt`` and ``torn_write`` after
its publish). Every detected corruption is counted by kind in
:data:`corrupt_counts` and, with telemetry on, in
``attendance_chain_corrupt_files_total{kind=}``. The formats are the JAX
package's, so each package verifies and drains the other's files.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

QUARANTINE_SUBDIR = "integrity-quarantine"

# The checksummed record header: magic + raw sha256(payload) + payload.
RECORD_MAGIC = b"SPR1"
_DIGEST_LEN = 32

# Durable artifacts that failed verification, by kind (quarantined,
# never served): restore's ladder and the serve chain reader count here.
corrupt_counts: Counter = Counter()


def count_corrupt(kind: str) -> None:
    """Count one detected corruption of ``kind`` (and, with telemetry
    on, ``attendance_chain_corrupt_files_total{kind=}``)."""
    corrupt_counts[kind] += 1
    from attendance_tpu_torch import obs
    t = obs.get()
    if t is not None:
        t.registry.counter(
            "attendance_chain_corrupt_files_total",
            help="Durable artifacts that failed integrity "
                 "verification (quarantined, never served)",
            kind=kind).inc()


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


def wrap_record(payload: bytes, magic: bytes = RECORD_MAGIC) -> bytes:
    """The checksummed record: magic + raw sha256 + payload. One
    implementation: the persist spill uses the default magic, the
    checksummed wire frames (``transport.framing.enc_checksummed``)
    their own."""
    payload = bytes(payload)
    return magic + hashlib.sha256(payload).digest() + payload


def unwrap_record(data: bytes,
                  magic: bytes = RECORD_MAGIC) -> Tuple[bytes, bool]:
    """-> (payload, verified). Legacy records (no magic) pass through
    unverified; a record whose header digest no longer matches raises
    :class:`IntegrityError`."""
    data = bytes(data)
    if not data.startswith(magic):
        return data, False
    digest = data[len(magic):len(magic) + _DIGEST_LEN]
    payload = data[len(magic) + _DIGEST_LEN:]
    if hashlib.sha256(payload).digest() != digest:
        raise IntegrityError("checksummed record failed verification "
                             "(payload digest mismatch)")
    return payload, True


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


# -- offline scrub ------------------------------------------------------------

class ScrubRow:
    """One scrub verdict: ``status`` is ok | legacy | orphan |
    CORRUPT; corrupt rows carry the classification in ``kind``."""

    __slots__ = ("path", "artifact", "status", "kind", "detail")

    def __init__(self, path, artifact: str, status: str,
                 kind: str = "", detail: str = ""):
        self.path = str(path)
        self.artifact = artifact
        self.status = status
        self.kind = kind
        self.detail = detail

    @property
    def corrupt(self) -> bool:
        return self.status == "CORRUPT"

    def as_list(self) -> List[str]:
        return [self.path, self.artifact, self.status,
                self.kind or "-", self.detail or "-"]


def _scrub_file(rows: List[ScrubRow], path: Path, artifact: str,
                expected: Optional[str]) -> None:
    if not path.exists():
        rows.append(ScrubRow(path, artifact, "CORRUPT", "missing",
                             "manifest names it, file absent"))
        return
    if expected:
        actual = file_digest(path)
        if actual != expected:
            rows.append(ScrubRow(
                path, artifact, "CORRUPT", "digest_mismatch",
                f"recorded {expected[:12]}…, on disk {actual[:12]}…"))
        else:
            rows.append(ScrubRow(path, artifact, "ok"))
        return
    detail = structural_npz_check(path)
    if detail:
        rows.append(ScrubRow(path, artifact, "CORRUPT", "unreadable",
                             detail))
    else:
        rows.append(ScrubRow(path, artifact, "legacy", "",
                             "no digest recorded (pre-integrity "
                             "chain); structural check only"))


def _scrub_no_manifest_fallback(d: Path, rows: List[ScrubRow],
                                artifact: str) -> None:
    """A torn manifest takes the recorded digests with it; fall back
    to structural (zip-CRC) checks of every chain file so rot in the
    payloads is still reported instead of hiding behind the torn
    manifest."""
    globs = ["base-*.npz", "delta-*.npz", "fused_sketch.npz"]
    for pat in globs:
        for p in sorted(d.glob(pat)):
            detail = structural_npz_check(p)
            if detail:
                rows.append(ScrubRow(p, artifact, "CORRUPT",
                                     "unreadable", detail))
            else:
                rows.append(ScrubRow(p, artifact, "legacy", "",
                                     "manifest torn: structural "
                                     "check only"))


def _scrub_fused_chain(d: Path, rows: List[ScrubRow]) -> None:
    """CHAIN.json chain (the fused pipeline's layout)."""
    manifest_path = d / "CHAIN.json"
    if not manifest_path.exists():
        # Base written, manifest not yet (or quarantined): structural
        # checks only, like a chain-manifest-less restore.
        _scrub_no_manifest_fallback(d, rows, "chain-file")
        return
    try:
        chain = json.loads(manifest_path.read_text())
    except (ValueError, OSError) as exc:
        rows.append(ScrubRow(manifest_path, "chain-manifest", "CORRUPT",
                             "torn_manifest", str(exc)))
        _scrub_no_manifest_fallback(d, rows, "chain-file")
        return
    rows.append(ScrubRow(manifest_path, "chain-manifest", "ok"))
    digests = chain.get("digests", {})
    base = chain.get("base", "fused_sketch.npz")
    base_path = d / base
    base_digest = chain.get("base_digest")
    if base_digest and base_path.exists():
        actual = file_digest(base_path)  # hashed ONCE (bases are big)
        if actual == base_digest:
            rows.append(ScrubRow(base_path, "chain-base", "ok"))
        elif structural_npz_check(base_path) is None:
            # Same discrimination as read_chain_state: a crash between
            # the base's in-place replace and the manifest reset
            # leaves a STALE recorded digest over a perfectly good
            # newer base — the zip CRCs separate that benign window
            # from real rot.
            rows.append(ScrubRow(
                base_path, "chain-base", "stale-digest", "",
                "manifest digest is stale (crash-before-manifest-"
                "reset window) but the file verifies structurally"))
        else:
            rows.append(ScrubRow(
                base_path, "chain-base", "CORRUPT", "digest_mismatch",
                "digest differs AND the file fails the structural "
                "check"))
    else:
        _scrub_file(rows, base_path, "chain-base", base_digest)
    named = {base}
    for name in chain.get("deltas", ()):
        named.add(name)
        _scrub_file(rows, d / name, "chain-delta", digests.get(name))
    for p in sorted(d.glob("delta-*.npz")):
        if p.name not in named:
            rows.append(ScrubRow(p, "chain-delta", "orphan", "",
                                 "unlisted by manifest; ignored by "
                                 "restore (frames redeliver)"))


def _scrub_store_chain(d: Path, rows: List[ScrubRow]) -> None:
    """MANIFEST.json chain (the generic sketch-store layout)."""
    manifest_path = d / "MANIFEST.json"
    try:
        chain = json.loads(manifest_path.read_text())
    except (ValueError, OSError) as exc:
        rows.append(ScrubRow(manifest_path, "store-manifest", "CORRUPT",
                             "torn_manifest", str(exc)))
        _scrub_no_manifest_fallback(d, rows, "store-file")
        return
    rows.append(ScrubRow(manifest_path, "store-manifest", "ok"))
    digests = chain.get("digests", {})
    named = set()
    base = chain.get("base")
    if base:
        named.add(base)
        _scrub_file(rows, d / base, "store-base", digests.get(base))
    for name in chain.get("deltas", ()):
        named.add(name)
        _scrub_file(rows, d / name, "store-delta", digests.get(name))
    for p in sorted(list(d.glob("base-*.npz"))
                    + list(d.glob("delta-*.npz"))):
        if p.name not in named:
            rows.append(ScrubRow(p, "store-delta", "orphan", "",
                                 "unlisted by manifest; ignored by "
                                 "restore"))


def _scrub_spill(d: Path, rows: List[ScrubRow]) -> None:
    for p in sorted(d.glob("spill-*.pkl")):
        data = p.read_bytes()
        try:
            payload, verified = unwrap_record(data)
        except IntegrityError as exc:
            rows.append(ScrubRow(p, "spill-record", "CORRUPT",
                                 "digest_mismatch", str(exc)))
            continue
        if verified:
            rows.append(ScrubRow(p, "spill-record", "ok"))
            continue
        import pickle
        try:
            pickle.loads(payload)
        except Exception as exc:  # noqa: BLE001
            rows.append(ScrubRow(p, "spill-record", "CORRUPT",
                                 "unreadable",
                                 f"{type(exc).__name__}: {exc}"))
        else:
            rows.append(ScrubRow(p, "spill-record", "legacy", "",
                                 "no checksum header (pre-integrity "
                                 "record); unpickle check only"))


def _scrub_events(d: Path, rows: List[ScrubRow]) -> None:
    """Event-store snapshots (one-shot ``fused_events.npz`` and the
    incremental ``segment-*.npz`` files): the store's writers record
    no digests, but the npz zip's per-entry CRCs make flips and tears
    structurally detectable — the same discriminator the chain base
    uses. Restore quarantines what fails here instead of crashing."""
    targets = sorted(d.glob("segment-*.npz"))
    one_shot = d / "fused_events.npz"
    if one_shot.exists():
        targets.append(one_shot)
    for p in targets:
        detail = structural_npz_check(p)
        if detail:
            rows.append(ScrubRow(p, "events-file", "CORRUPT",
                                 "unreadable", detail))
        else:
            rows.append(ScrubRow(p, "events-file", "ok", "",
                                 "structural (zip CRC) check"))


def _scrub_incident(d: Path, rows: List[ScrubRow]) -> None:
    """Incident evidence bundle (the JAX package's ``obs/incident.py``
    writes it): ``incident.json`` doubles as the bundle manifest, a
    sha256 per evidence part (deliberately not named MANIFEST.json,
    which would collide with the store-chain family). A torn record
    takes its digests with it; the parts then get an existence-only
    sweep so rot is still reported."""
    record_path = d / "incident.json"
    try:
        record = json.loads(record_path.read_text())
    except (ValueError, OSError) as exc:
        rows.append(ScrubRow(record_path, "incident-record", "CORRUPT",
                             "torn_manifest", str(exc)))
        for p in sorted(d.iterdir()):
            if p.is_file() and p.name != "incident.json":
                rows.append(ScrubRow(p, "incident-evidence", "legacy",
                                     "", "record torn: existence "
                                     "check only"))
        return
    rows.append(ScrubRow(record_path, "incident-record", "ok", "",
                         f"incident {record.get('id', '?')}"))
    for name, expected in sorted(
            (record.get("evidence") or {}).items()):
        _scrub_file(rows, d / name, "incident-evidence", expected)


def _scrub_quarantine(d: Path, rows: List[ScrubRow]) -> None:
    for meta_path in sorted(d.glob("q-*.json")):
        frame = meta_path.with_suffix(".frame")
        try:
            meta = json.loads(meta_path.read_text())
        except (ValueError, OSError) as exc:
            rows.append(ScrubRow(meta_path, "quarantine-sidecar",
                                 "CORRUPT", "torn_manifest", str(exc)))
            continue
        if not frame.exists():
            rows.append(ScrubRow(frame, "quarantine-frame", "orphan",
                                 "", "sidecar without frame (crash "
                                 "mid-put; never acked, redelivers)"))
            continue
        expected = meta.get("sha256")
        if expected and file_digest(frame) != expected:
            rows.append(ScrubRow(frame, "quarantine-frame", "CORRUPT",
                                 "digest_mismatch",
                                 "frame bytes differ from sidecar "
                                 "digest"))
        else:
            rows.append(ScrubRow(frame, "quarantine-frame", "ok"))


def scrub_dir(directory) -> List[ScrubRow]:
    """Scrub one directory, auto-detecting every artifact family it
    holds (a workdir may hold several: chain + spill + quarantine)."""
    d = Path(directory)
    rows: List[ScrubRow] = []
    if not d.is_dir():
        raise FileNotFoundError(f"no such directory: {d}")
    chain_handled = False
    if (d / "CHAIN.json").exists() or (d / "fused_sketch.npz").exists():
        _scrub_fused_chain(d, rows)
        chain_handled = True
    if (d / "MANIFEST.json").exists():
        _scrub_store_chain(d, rows)
        chain_handled = True
    if not chain_handled and (any(d.glob("base-*.npz"))
                              or any(d.glob("delta-*.npz"))):
        # Chain files with no manifest of either family (a torn
        # manifest self-quarantined and the process died before the
        # fresh base+manifest landed): rot here must not be invisible
        # — structural sweep, like a torn-manifest chain.
        _scrub_no_manifest_fallback(d, rows, "chain-file")
    if any(d.glob("spill-*.pkl")):
        _scrub_spill(d, rows)
    if any(d.glob("segment-*.npz")) or (d / "fused_events.npz").exists():
        _scrub_events(d, rows)
    if any(d.glob("q-*.json")) or any(d.glob("q-*.frame")):
        _scrub_quarantine(d, rows)
    if (d / "incident.json").exists():
        _scrub_incident(d, rows)
    for sub in sorted(p for p in d.iterdir() if p.is_dir()
                      and p.name != QUARANTINE_SUBDIR):
        try:
            rows.extend(scrub_dir(sub))
        except FileNotFoundError:
            continue
    return rows


def scrub_paths(paths) -> Tuple[List[ScrubRow], bool]:
    """Scrub every directory; -> (rows, ok). ``ok`` is False when any
    row is CORRUPT (legacy/orphan rows do not fail the verdict — they
    are tolerated by restore too)."""
    rows: List[ScrubRow] = []
    for p in paths:
        rows.extend(scrub_dir(p))
    return rows, not any(r.corrupt for r in rows)


def scrub_report(paths) -> Tuple[str, bool]:
    """Human verdict table of the ``scrub`` CLI verb."""
    rows, ok = scrub_paths(paths)
    header = ["artifact", "kind", "status", "class", "detail"]
    table = [header] + [r.as_list() for r in rows]
    widths = [max(len(str(row[i])) for row in table)
              for i in range(len(header))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(str(c).ljust(w)
                               for c, w in zip(row, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    counts: Dict[str, int] = {}
    for r in rows:
        counts[r.status] = counts.get(r.status, 0) + 1
    summary = ", ".join(f"{v} {k}" for k, v in sorted(counts.items()))
    lines.append("")
    lines.append(f"scrub: {summary or 'no artifacts found'} -> "
                 + ("PASS" if ok else "FAIL"))
    return "\n".join(lines), ok


# -- chaos hooks at the durable-write seam (disk_corrupt, torn_write, enospc)
# One call each in every fsync'd writer (fused chain, store chain, spill).

def surviving_disk_faults(disk_faults) -> set:
    """Paths from an injector's ``disk_faults`` ledger whose rot is
    STILL on disk: the file exists and its current digest equals the
    post-fault digest the ledger recorded (a later clean rewrite —
    e.g. a re-published manifest — heals the path; GC/quarantine
    removes it). The soak gate: scrub must detect every one of
    these."""
    out = set()
    for entry in disk_faults:
        _site, _fault, path = entry[0], entry[1], entry[2]
        digest = entry[3] if len(entry) > 3 else ""
        p = Path(path)
        if not p.exists():
            continue
        if digest and file_digest(p) != digest:
            continue  # rewritten since the fault: healed
        out.add(str(p))
    return out


def chaos_pre_write(site: str) -> None:
    """Injected ENOSPC at the writer seam: raises OSError(ENOSPC)
    before any bytes land (the full-disk failure class the snapshot
    writer must treat distinctly from generic write failure)."""
    from attendance_tpu_torch import chaos
    inj = chaos.get()
    if inj is not None and inj.roll(site, "enospc"):
        import errno
        raise OSError(errno.ENOSPC,
                      f"chaos enospc at {site}: no space left on "
                      "device (injected)")


def chaos_post_publish(site: str, path) -> None:
    """Injected storage rot AFTER the artifact became durable: a
    ``disk_corrupt`` hit flips one mid-file byte, a ``torn_write`` hit
    truncates the file to half — both post-fsync, so the write path
    believed it succeeded and only verification can notice."""
    from attendance_tpu_torch import chaos
    inj = chaos.get()
    if inj is None:
        return
    if inj.active("disk_corrupt") and inj.roll(site, "disk_corrupt"):
        _flip_byte(path)
        inj.note_disk_fault(site, "disk_corrupt", path,
                            file_digest(path))
    if inj.active("torn_write") and inj.roll(site, "torn_write"):
        _truncate_half(path)
        inj.note_disk_fault(site, "torn_write", path,
                            file_digest(path))


def _flip_byte(path) -> None:
    p = Path(path)
    size = p.stat().st_size
    if size == 0:
        return
    off = size // 2
    with open(p, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
        f.flush()
        os.fsync(f.fileno())


def _truncate_half(path) -> None:
    p = Path(path)
    size = p.stat().st_size
    with open(p, "r+b") as f:
        f.truncate(size // 2)
        f.flush()
        os.fsync(f.fileno())
