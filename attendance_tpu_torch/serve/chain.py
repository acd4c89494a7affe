"""Merge-on-read epoch source over the on-disk snapshot chain.

Counterpart of ``attendance_tpu/serve/chain.py`` (its telemetry gauges
are not ported). A separate READER process serves queries without ever
joining the ingest process: it loads the base snapshot and every
manifest-listed delta (``fast_path.read_chain_state``, as restore does)
and publishes the merged state as an epoch. A background thread
re-reads the chain at ``refresh_s`` cadence and republishes when the
writer made new state durable; an epoch's staleness is taken from the
chain's mtime, so it describes the data, not this reader's load time.

A concurrent manifest swap (the writer compacting or appending while
this reader loads) is retried: every manifest state is self-consistent
(a delta is named only after its file is fsync'd; compaction resets the
manifest before deleting superseded deltas), so the one race is a named
file vanishing under compaction between the manifest read and the file
open, and the loader then reads the manifest again. A reader serves the
old epoch or the new one, never a mix. A chain that is corrupt (a digest
mismatch, a torn manifest, an unreadable file) never kills the reader:
the offending file is quarantined, counted (``utils.integrity``), and
the last good epoch keeps being served.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from attendance_tpu_torch.models.bloom import BloomParams
from attendance_tpu_torch.pipeline.fast_path import (
    CHAIN_MANIFEST, SKETCH_SNAPSHOT, read_chain_state)
from attendance_tpu_torch.serve.mirror import Epoch
from attendance_tpu_torch.utils.integrity import (
    ChainIntegrityError, count_corrupt, quarantine_artifact)

logger = logging.getLogger(__name__)

_SWAP_RETRIES = 8


class ChainEpochSource:
    """A ``pin()`` epoch source over a snapshot directory."""

    def __init__(self, snapshot_dir, *, refresh_s: float = 1.0):
        self._dir = Path(snapshot_dir)
        self._manifest = self._dir / CHAIN_MANIFEST
        self.refresh_s = refresh_s
        self._epoch: Optional[Epoch] = None
        self._fingerprint = None
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reload()  # fail fast on an unreadable or absent chain

    # -- the epoch-source surface ---------------------------------------------------
    def pin(self) -> Optional[Epoch]:
        return self._epoch

    def staleness_s(self) -> float:
        e = self._epoch
        return float("nan") if e is None else e.age_s()

    # -- loading -------------------------------------------------------------------
    def _chain_fingerprint(self):
        """(manifest bytes, base mtime_ns): changes iff a publish or a
        compaction landed (a base refolded in place keeps the delta list
        empty but bumps the base file)."""
        try:
            manifest = self._manifest.read_bytes()
        except FileNotFoundError:
            manifest = b""
        try:
            base_mtime = (self._dir / SKETCH_SNAPSHOT).stat().st_mtime_ns
        except FileNotFoundError:
            base_mtime = 0
        return manifest, base_mtime

    def reload(self, force: bool = False) -> bool:
        """Load the chain if it changed since the last load; True when a
        new epoch was published. Retries across concurrent manifest swaps;
        corruption is quarantined and the last good epoch kept
        (:meth:`_on_corrupt`)."""
        fp = self._chain_fingerprint()
        if not force and fp == self._fingerprint and \
                self._epoch is not None:
            return False
        last_exc: Optional[Exception] = None
        for _attempt in range(_SWAP_RETRIES):
            try:
                state = read_chain_state(self._dir)
            except FileNotFoundError:
                raise
            except ChainIntegrityError as exc:
                if exc.kind == "missing":
                    # The one benign race: compaction deleted a named
                    # delta between our manifest read and the open.
                    last_exc = exc
                    time.sleep(0.01)
                    continue
                return self._on_corrupt(exc)
            except (ValueError, OSError) as exc:
                # The manifest itself is mid-swap: read again.
                last_exc = exc
                time.sleep(0.01)
                continue
            # Record the fingerprint taken BEFORE the load: if a publish
            # landed mid-load we may have read the older state, and the
            # stale fingerprint makes the next refresh load again.
            self._fingerprint = fp
            self._seq += 1
            man = state["manifest"]
            params = BloomParams(
                m_bits=int(man["m_bits"]), k=int(man["k"]),
                layout="blocked", capacity=0, error_rate=0.0)
            self._epoch = Epoch(
                seq=self._seq, events=int(state["events"]),
                bloom_words=np.asarray(state["bits"], np.uint32),
                hll_regs=np.asarray(state["regs"], np.uint8),
                counts=np.asarray(state["counts"], np.uint32),
                # The manifest's JSON keys are strings; every epoch reader
                # keys days and buckets by int.
                bank_of={int(d): int(b)
                         for d, b in state["bank_of"].items()},
                params=params, precision=int(man["precision"]),
                source="chain", published_at=self._chain_mtime())
            return True
        if isinstance(last_exc, ChainIntegrityError):
            # A named file stayed missing through every retry: not the
            # compaction race, a broken chain.
            return self._on_corrupt(last_exc)
        raise RuntimeError(
            f"chain at {self._dir} kept moving for {_SWAP_RETRIES} read "
            f"attempts: {last_exc!r}")

    def _on_corrupt(self, exc: ChainIntegrityError) -> bool:
        """A corrupt chain: quarantine the offender and keep serving the
        last good epoch. Only a reader with no epoch at all (starting on
        a rotten chain) fails: there is nothing safe to serve."""
        logger.error(
            "chain at %s is corrupt (%s at %s)%s: %s", self._dir, exc.kind,
            exc.path.name, f": {exc.detail}" if exc.detail else "",
            "serving the last good epoch" if self._epoch is not None
            else "no epoch served yet")
        if exc.kind == "missing" or quarantine_artifact(
                exc.path, reason=exc.kind, detail=exc.detail,
                expected_digest=exc.expected) is None:
            # Nothing on disk to quarantine: still counted.
            count_corrupt(exc.kind)
        if self._epoch is None:
            raise RuntimeError(
                f"chain at {self._dir} is corrupt ({exc.kind} at "
                f"{exc.path.name}) and no earlier epoch exists to keep "
                "serving") from exc
        # The corrupt state does not heal by itself: remember its
        # fingerprint so each refresh does not count it again.
        self._fingerprint = self._chain_fingerprint()
        return False

    def _chain_mtime(self) -> float:
        """When the on-disk state was published: the newer of the chain
        manifest and the base file (compaction refolds the base without
        changing the manifest's content)."""
        newest = 0.0
        for path in (self._manifest, self._dir / SKETCH_SNAPSHOT):
            try:
                newest = max(newest, path.stat().st_mtime)
            except FileNotFoundError:
                continue
        return newest or time.time()

    # -- the refresh thread ------------------------------------------------------------
    def start(self) -> "ChainEpochSource":
        self._thread = threading.Thread(
            target=self._loop, name="chain-refresh", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.refresh_s):
            try:
                if self.reload():
                    logger.info("chain reader refreshed: epoch %d, %d "
                                "events", self._epoch.seq,
                                self._epoch.events)
            except Exception:
                logger.exception("chain refresh failed (will retry)")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
