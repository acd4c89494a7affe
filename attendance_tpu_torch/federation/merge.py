"""The federation's merge core: fold merge frames into one global view.

Counterpart of ``attendance_tpu/federation/merge.py``, host numpy as
there. Sketches are state-based CRDTs: a Bloom filter joins under
bitwise OR and an HLL bank under register max
(``models.bloom.bloom_or_words_np``), both commutative, associative and
idempotent, so the view converges whatever the frames' order,
duplication or replay. The one reconciliation is NAMING: each worker
numbers its HLL banks in its own arrival order, so :class:`MergedView`
keys the global registers by DAY, routing every folded row through the
frame's own ``bank_of`` map into a global day -> bank assignment (which
grows by doubling, as the workers' arrays do).

Cumulative counters (events, valid and invalid totals, roster size) are
not idempotent under re-add: they fold newest-(incarnation, seq)-wins
per worker id and aggregate as a sum over workers, so a replayed or
stale frame never double-counts, and a takeover worker (same id, higher
incarnation, counters seeded from the dead peer's chain) supersedes its
predecessor.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from attendance_tpu_torch.federation.frames import MergeFrame
from attendance_tpu_torch.models.bloom import BloomParams, bloom_or_words_np
from attendance_tpu_torch.models.fused import decode_counts


class GeometryMismatch(ValueError):
    """Frames describe incompatible sketch geometry (capacity, error
    rate, layout or precision differ across the federation)."""


def encode_counts(valid: int, invalid: int) -> np.ndarray:
    """(valid, invalid) as the two-lane uint32[2, 2] counters
    (``decode_counts``'s inverse)."""
    out = np.zeros((2, 2), np.uint32)
    out[0, 0] = valid & 0xFFFFFFFF
    out[0, 1] = valid >> 32
    out[1, 0] = invalid & 0xFFFFFFFF
    out[1, 1] = invalid >> 32
    return out


class _WorkerLedger:
    """One worker id's cumulative counters, newest incarnation wins."""

    __slots__ = ("incarnation", "seq", "events", "valid", "invalid",
                 "roster_size", "shard", "snapshot_dir", "last_seen")

    def __init__(self):
        self.incarnation = -1.0
        self.seq = -1
        self.events = 0
        self.valid = 0
        self.invalid = 0
        self.roster_size = 0
        self.shard = -1
        self.snapshot_dir = ""
        self.last_seen = 0.0


class MergedView:
    """The aggregator's global sketch state, built by folding frames.

    ``fold`` runs on one consumer loop; readers see immutable epochs the
    aggregator publishes from :meth:`epoch_fields`, never this object."""

    def __init__(self, precision: int = 14,
                 retain_worker_state: bool = True):
        self.precision = precision
        self.m = 1 << precision
        self.params: Optional[BloomParams] = None
        self.bloom_words: Optional[np.ndarray] = None
        self.bank_of: Dict[int, int] = {}  # day -> global bank
        self.regs = np.zeros((8, self.m), np.uint8)
        self.workers: Dict[str, _WorkerLedger] = {}
        # Each worker's OWN contribution (Bloom-OR of its frames'
        # words, register max of its rows by day): what the repair
        # ladder's peer re-assert sends back, so a repaired worker's
        # filter stays its shard's. One sketch copy per worker.
        self.retain_worker_state = retain_worker_state
        self.worker_state: Dict[str, dict] = {}
        self.folded_deltas = 0
        self.folded_fulls = 0
        self.stale_frames = 0

    # -- bank routing --------------------------------------------------------
    def _global_bank(self, day: int) -> int:
        bank = self.bank_of.get(day)
        if bank is not None:
            return bank
        bank = len(self.bank_of)
        if bank >= self.regs.shape[0]:
            grown = np.zeros((self.regs.shape[0] * 2, self.m), np.uint8)
            grown[:self.regs.shape[0]] = self.regs
            self.regs = grown
        self.bank_of[day] = bank
        return bank

    def _check_geometry(self, frame: MergeFrame) -> None:
        if int(frame.precision) != self.precision:
            raise GeometryMismatch(
                f"worker {frame.worker} gossips precision "
                f"{frame.precision}, aggregator runs {self.precision}")
        if frame.m_bits and self.params is not None and \
                int(frame.m_bits) != self.params.m_bits:
            raise GeometryMismatch(
                f"worker {frame.worker} gossips a {frame.m_bits}-bit "
                f"filter, federation runs {self.params.m_bits} bits — "
                "Bloom capacity/error-rate/layout must match")
        if frame.k and self.params is not None and \
                int(frame.k) != self.params.k:
            # Same m_bits with another probe count still breaks the
            # no-false-negative contract: readers would probe positions
            # the writer never set.
            raise GeometryMismatch(
                f"worker {frame.worker} gossips k={frame.k} hash "
                f"probes, federation runs k={self.params.k}")

    # -- folding -------------------------------------------------------------
    def fold(self, frame: MergeFrame,
             now: Optional[float] = None) -> Dict:
        """Fold one decoded frame; returns ``{"stale": bool, "lag_s":
        float | None}`` (the fence -> fold lag, for frames that carry
        state)."""
        now = time.time() if now is None else now
        self._check_geometry(frame)
        w = self.workers.setdefault(frame.worker, _WorkerLedger())
        key = (float(frame.incarnation), int(frame.seq))
        stale = key <= (w.incarnation, w.seq)
        if not stale:
            # Liveness rides only current-incarnation traffic: a
            # superseded zombie's heartbeats must not keep the ledger
            # fresh, or its takeover successor's death would go unseen.
            w.last_seen = now
            w.incarnation, w.seq = key
            w.shard = int(frame.shard)
            if frame.header.get("snapshot_dir"):
                w.snapshot_dir = frame.header["snapshot_dir"]
            # max() keeps the counters monotone even when a fresh
            # incarnation's frame briefly trails the restored totals.
            w.events = max(w.events, int(frame.events))
            w.roster_size = max(w.roster_size, int(frame.roster_size))
            if "counts" in frame.arrays:
                valid, invalid = decode_counts(frame.arrays["counts"])
                w.valid = max(w.valid, valid)
                w.invalid = max(w.invalid, invalid)
        else:
            self.stale_frames += 1
        if frame.kind in ("heartbeat", "repair_request"):
            return {"stale": stale, "lag_s": None}
        # Sketch state folds even from stale frames: OR and max are
        # idempotent, so a late frame of a previous owner re-asserts
        # at most what the takeover carries (or events its chain
        # missed: folding them is the difference from a loss).
        if "bloom" in frame.arrays:
            words = np.asarray(frame.arrays["bloom"], np.uint32)
            if self.params is None:
                self.params = BloomParams(
                    m_bits=int(frame.m_bits), k=int(frame.k),
                    layout="blocked", capacity=0, error_rate=0.0)
            if self.bloom_words is None:
                self.bloom_words = words.copy()
            else:
                self.bloom_words = bloom_or_words_np(
                    self.bloom_words, words)
        inv = {b: d for d, b in frame.bank_of.items()}
        if frame.kind == "full" and "regs" in frame.arrays:
            rows = np.asarray(frame.arrays["regs"], np.uint8)
            local_banks = np.arange(rows.shape[0])
            self.folded_fulls += 1
        elif frame.kind == "delta":
            rows = np.asarray(frame.arrays.get(
                "rows", np.zeros((0, self.m), np.uint8)), np.uint8)
            local_banks = np.asarray(frame.arrays.get(
                "bank_idx", np.zeros(0, np.int32)), np.int64)
            self.folded_deltas += 1
        else:
            rows = np.zeros((0, self.m), np.uint8)
            local_banks = np.zeros(0, np.int64)
        if rows.shape[0]:
            if rows.shape[1] != self.m:
                raise GeometryMismatch(
                    f"worker {frame.worker} gossips {rows.shape[1]} "
                    f"registers/bank, aggregator expects {self.m}")
            gbanks = []
            keep = []
            for i, lb in enumerate(np.asarray(local_banks).tolist()):
                day = inv.get(int(lb))
                if day is None:
                    # A bank the frame's map does not name (a full
                    # frame's unused rows): skip it.
                    continue
                gbanks.append(self._global_bank(int(day)))
                keep.append(i)
            if keep:
                gb = np.asarray(gbanks, np.int64)
                sub = rows[np.asarray(keep, np.int64)]
                # A frame's local banks are unique, so gb is: the
                # fancy-index max-merge is exact.
                self.regs[gb] = np.maximum(self.regs[gb], sub)
        if self.retain_worker_state and \
                (rows.shape[0] or "bloom" in frame.arrays):
            self._retain(frame, inv, rows, local_banks)
        return {"stale": stale,
                "lag_s": max(0.0, now - float(frame.fence_ts))}

    def _retain(self, frame: MergeFrame, inv: Dict, rows: np.ndarray,
                local_banks) -> None:
        """Fold this frame into its worker's OWN retained view (the same
        joins, keyed by worker id: a takeover shares the dead peer's id
        and so its contribution, which is exactly the shard's)."""
        ws = self.worker_state.setdefault(
            frame.worker, {"bloom": None, "rows": {}})
        if "bloom" in frame.arrays:
            words = np.asarray(frame.arrays["bloom"], np.uint32)
            ws["bloom"] = (words.copy() if ws["bloom"] is None
                           else bloom_or_words_np(ws["bloom"], words))
        for i, lb in enumerate(np.asarray(local_banks).tolist()):
            day = inv.get(int(lb))
            if day is None:
                continue
            cur = ws["rows"].get(int(day))
            ws["rows"][int(day)] = (rows[i].copy() if cur is None
                                    else np.maximum(cur, rows[i]))

    # -- aggregate reads -----------------------------------------------------
    @property
    def events(self) -> int:
        return sum(w.events for w in self.workers.values())

    @property
    def roster_size(self) -> int:
        return sum(w.roster_size for w in self.workers.values())

    def counts_array(self) -> np.ndarray:
        """Aggregate (valid, invalid) as the two-lane uint32[2, 2]."""
        return encode_counts(
            sum(w.valid for w in self.workers.values()),
            sum(w.invalid for w in self.workers.values()))

    def epoch_fields(self) -> Dict:
        """The keyword arguments of ``serve.mirror.ReadMirror.publish``
        for the next federated read epoch."""
        return dict(
            regs=self.regs[:max(len(self.bank_of), 1)],
            events=self.events,
            bank_of=dict(self.bank_of),
            params=self.params,
            precision=self.precision,
            bloom_words=self.bloom_words,
            counts=self.counts_array(),
            roster_size=self.roster_size,
            source="federated")

    def regs_by_day(self) -> Dict[int, np.ndarray]:
        """{day: register row}: the surface held against an oracle."""
        return {day: self.regs[bank].copy()
                for day, bank in self.bank_of.items()}
