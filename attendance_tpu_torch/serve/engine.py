"""Vectorized query executor over a pinned epoch.

Counterpart of ``attendance_tpu/serve/engine.py``. One
:class:`QueryEngine` answers whole request batches from whatever epoch
source it was built over: the live pipeline's
:class:`serve.mirror.ReadMirror` or a
:class:`serve.chain.ChainEpochSource`. Every verb pins ONE epoch up front
and answers the whole batch from it, so a barrier publishing mid-batch
changes nothing the batch sees. Everything here is host numpy
over the epoch's arrays: no device, no locks, nothing on the hot loop's
stream.

* ``bf_exists(keys)``: BF.EXISTS over a uint32 key batch through
  ``bloom_contains_words_np``;
* ``pfcount(days)``: per-lecture-day estimates, one batched histogram
  pass over the distinct banks the days map to (unknown days answer 0);
* ``occupancy()``: {day: unique} over every registered day;
* ``attendance_rate(roster_size)``: occupancy / roster (the epoch's
  preload size by default);
* ``window_pfcount``, ``window_occupancy``, ``rate_series``: the
  temporal plane's buckets, decoded from the epoch's bank map;
* ``stats()``: the epoch's metadata and validity counters.

With telemetry (``obs``) each answered batch counts a request and its
keys per verb (``attendance_query_requests_total``, ``_keys_total``,
the ``attendance_query_batch_size`` histogram), its latency in the
``query`` stage and the age of the epoch it was answered from
(``attendance_query_epoch_age_seconds``), and with tracing adds a
``query`` span. With the accuracy audit on (``obs.auditor``), a
:class:`serve.audit.ReadAuditor` cross-checks the sampled lanes of each
BF.EXISTS batch and each PFCOUNT and occupancy answer against the shared
exact shadow.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from attendance_tpu_torch.models.bloom import bloom_contains_words_np
from attendance_tpu_torch.models.fused import decode_counts
from attendance_tpu_torch.models.hll import (
    estimate_from_histogram, estimates_from_rows, hll_histograms_np)
from attendance_tpu_torch.serve.mirror import Epoch
from attendance_tpu_torch.temporal.buckets import (
    decode_bucket_key, is_bucket_key)


class NoEpoch(RuntimeError):
    """No epoch has been published yet (nothing to answer from)."""


def _noted(verb: str, size=len):
    """Count one answered batch of ``verb`` (of ``size(answer)`` keys)
    when telemetry is on; the batch's epoch is the one its ``pin()``
    took on this thread."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            if self._obs is None:
                return fn(self, *args, **kwargs)
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            self._note(verb, size(out), self._pinned.epoch, t0)
            return out
        return wrapper
    return deco


class QueryEngine:
    _TRACE_ROLE = "query-engine"

    def __init__(self, source, *, obs=None, batch_max: int = 1 << 16,
                 staleness_ceiling_s: Optional[float] = None):
        """``source`` is anything with ``pin() -> Epoch | None``."""
        self._source = source
        self.batch_max = max(1, batch_max)
        self.staleness_ceiling_s = staleness_ceiling_s
        self._obs = obs
        self._tracer = obs.tracer if obs is not None else None
        # Sampling-profiler stage mark (obs/profiler.py): serve threads
        # are single-purpose, so pin() marks them "serve" once (sticky).
        prof = obs.profiler if obs is not None else None
        self._stage_mark = prof.stages if prof is not None else None
        self._pinned = threading.local()
        self._counters: Dict[str, object] = {}
        self._key_counters: Dict[str, object] = {}
        self._h_batch: Dict[str, object] = {}
        self._h_latency = self._h_epoch_age = None
        self._auditor = None
        if obs is not None:
            self._h_latency = obs.stage("query")
            self._h_epoch_age = obs.registry.histogram(
                "attendance_query_epoch_age_seconds",
                help="Age of the epoch each query batch was answered "
                "from", scale=1e3)
            if obs.auditor is not None:
                from attendance_tpu_torch.serve.audit import ReadAuditor
                self._auditor = ReadAuditor(obs.registry, obs.auditor)

    # -- epoch access ------------------------------------------------------------
    def pin(self) -> Epoch:
        if self._stage_mark is not None:
            self._stage_mark.set("serve")
        epoch = self._source.pin()
        if epoch is None:
            raise NoEpoch("no epoch published yet: preload, restore or a "
                          "snapshot barrier publishes the first")
        if self._obs is not None:
            self._pinned.epoch = epoch
        return epoch

    def _note(self, verb: str, n: int, epoch: Epoch, t0: float) -> None:
        """One answered batch: request and key counters, batch size,
        latency, epoch age and, with tracing, a ``query`` span."""
        obs = self._obs
        t1 = time.perf_counter()
        c = self._counters.get(verb)
        if c is None:
            c = self._counters[verb] = obs.registry.counter(
                "attendance_query_requests_total",
                help="Query batches answered, per verb", verb=verb)
            self._key_counters[verb] = obs.registry.counter(
                "attendance_query_keys_total",
                help="Point answers produced (keys/days per batch "
                "summed), per verb", verb=verb)
            self._h_batch[verb] = obs.registry.histogram(
                "attendance_query_batch_size",
                help="Keys/days per query batch", scale=1.0, verb=verb)
        c.inc()
        self._key_counters[verb].inc(max(n, 1))
        self._h_batch[verb].observe(float(max(n, 1)))
        self._h_latency.observe(t1 - t0)
        self._h_epoch_age.observe(max(epoch.age_s(), 0.0))
        tr = self._tracer
        if tr is not None:
            cur = tr.current()
            tr.add_span(
                "query", t0, t1,
                trace_id=cur.trace_id if cur is not None else tr.new_id(),
                parent_id=cur.span_id if cur is not None else None,
                role=self._TRACE_ROLE,
                args={"verb": verb, "n": n, "epoch": epoch.seq})

    def staleness_s(self) -> float:
        epoch = self._source.pin()
        return float("nan") if epoch is None else epoch.age_s()

    def _check_batch(self, n: int) -> None:
        if n > self.batch_max:
            raise ValueError(f"query batch of {n} exceeds --query-batch-max "
                             f"{self.batch_max}")

    # -- verbs -------------------------------------------------------------------
    @_noted("exists")
    def bf_exists(self, keys) -> np.ndarray:
        """BF.EXISTS for a batch of uint32 keys: bool[B] from the pinned
        epoch's packed filter words."""
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        self._check_batch(len(keys))
        epoch = self.pin()
        if epoch.bloom_words is None:
            raise NoEpoch("epoch carries no filter words (no preload "
                          "reached the mirror yet)")
        out = bloom_contains_words_np(epoch.bloom_words, keys,
                                      epoch.params)
        if self._auditor is not None:
            self._auditor.check_bf(keys, out)
        return out

    @staticmethod
    def _estimates(epoch: Epoch, days: np.ndarray) -> np.ndarray:
        """Estimates for a day vector: the distinct known banks in ONE
        histogram pass; unknown days answer 0 (PFCOUNT of a missing
        key)."""
        banks = np.array([epoch.bank_of.get(int(d), -1) for d in days],
                         dtype=np.int64)
        known = np.unique(banks[banks >= 0])
        out = np.zeros(len(days), dtype=np.int64)
        if len(known):
            ests = estimates_from_rows(epoch.hll_regs[known],
                                       epoch.precision)
            lut = dict(zip(known.tolist(),
                           np.rint(ests).astype(np.int64).tolist()))
            for i, b in enumerate(banks.tolist()):
                if b >= 0:
                    out[i] = lut[b]
        return out

    @_noted("pfcount")
    def pfcount(self, days) -> np.ndarray:
        """Per-lecture-day unique-attendee estimates: int64[B]."""
        days = np.atleast_1d(np.asarray(days, dtype=np.int64))
        self._check_batch(len(days))
        epoch = self.pin()
        out = self._estimates(epoch, days)
        if self._auditor is not None:
            self._auditor.check_pfcount(epoch, days, out)
        return out

    @staticmethod
    def _day_map(epoch: Epoch) -> Dict[int, int]:
        """The epoch's plain-day banks (temporal bucket keys share the
        map but belong to the window verbs)."""
        return {d: b for d, b in epoch.bank_of.items()
                if not is_bucket_key(d)}

    @staticmethod
    def _bucket_map(epoch: Epoch) -> Dict[tuple, int]:
        """{(day, period): bank} decoded from the epoch's bucket keys,
        all the window verbs need: no live-ring state, so a chain reader
        answers as the live pipeline does."""
        return {decode_bucket_key(key): bank
                for key, bank in epoch.bank_of.items()
                if is_bucket_key(key)}

    @staticmethod
    def _day_estimates(epoch: Epoch, day_map: Dict[int, int]):
        days = np.fromiter(day_map.keys(), dtype=np.int64,
                           count=len(day_map))
        banks = np.fromiter(day_map.values(), dtype=np.int64,
                            count=len(day_map))
        return days, estimates_from_rows(epoch.hll_regs[banks],
                                         epoch.precision)

    @_noted("occupancy")
    def occupancy(self) -> Dict[int, int]:
        """{day: unique} over every registered day, one histogram pass."""
        epoch = self.pin()
        day_map = self._day_map(epoch)
        if not day_map:
            return {}
        days, ests = self._day_estimates(epoch, day_map)
        ests = np.rint(ests).astype(np.int64)
        if self._auditor is not None:
            self._auditor.check_pfcount(epoch, days, ests)
        return {int(d): int(e) for d, e in zip(days, ests)}

    @_noted("rate")
    def attendance_rate(self, roster_size: int = 0) -> Dict[int, float]:
        """{day: unique / roster}; ``roster_size`` 0 = the epoch's
        preload size."""
        epoch = self.pin()
        denom = int(roster_size) or epoch.roster_size
        day_map = self._day_map(epoch)
        if denom <= 0 or not day_map:
            return {}
        days, ests = self._day_estimates(epoch, day_map)
        return {int(d): float(e) / denom for d, e in zip(days, ests)}

    # -- window verbs (the temporal plane) -----------------------------------------
    @staticmethod
    def _merged_estimate(epoch: Epoch, banks) -> float:
        """PFMERGE, then estimate, over bucket rows: one register-max
        fold, one histogram, one Ertl estimate."""
        merged = np.max(epoch.hll_regs[np.asarray(banks, np.int64)],
                        axis=0)
        hist = hll_histograms_np(merged[None, :], epoch.precision)[0]
        return estimate_from_histogram(hist, epoch.precision)

    def window_pfcount(self, day: Optional[int] = None,
                       period_lo: Optional[int] = None,
                       period_hi: Optional[int] = None) -> int:
        """Unique valid students across every bucket of ``day`` (None =
        every day) in the inclusive period range: one register-max fold
        over the selected rows, then one estimate."""
        t0 = time.perf_counter()
        epoch = self.pin()
        rows = [bank for (d, p), bank in self._bucket_map(epoch).items()
                if (day is None or d == int(day))
                and (period_lo is None or p >= int(period_lo))
                and (period_hi is None or p <= int(period_hi))]
        out = (int(round(self._merged_estimate(epoch, rows)))
               if rows else 0)
        if self._obs is not None:
            self._note("window_pfcount", len(rows), epoch, t0)
        return out

    @_noted("window_occupancy")
    def window_occupancy(self) -> Dict[tuple, int]:
        """{(day, period): unique} over every retained bucket, one
        histogram pass."""
        epoch = self.pin()
        bmap = self._bucket_map(epoch)
        if not bmap:
            return {}
        pairs = list(bmap.items())
        banks = np.asarray([b for _, b in pairs], np.int64)
        ests = np.rint(estimates_from_rows(
            epoch.hll_regs[banks], epoch.precision)).astype(np.int64)
        return {dp: int(e) for (dp, _), e in zip(pairs, ests)}

    @_noted("rate_series")
    def rate_series(self, day: Optional[int] = None,
                    roster_size: int = 0) -> Dict[int, float]:
        """{period: unique / roster}: ``day``'s series, or with no day
        each period's buckets folded across days first."""
        epoch = self.pin()
        denom = int(roster_size) or epoch.roster_size
        out: Dict[int, float] = {}
        if denom > 0:
            by_period: Dict[int, list] = {}
            for (d, p), bank in self._bucket_map(epoch).items():
                if day is None or d == int(day):
                    by_period.setdefault(p, []).append(bank)
            for p, banks in sorted(by_period.items()):
                out[p] = self._merged_estimate(epoch, banks) / denom
        return out

    @_noted("stats", size=lambda out: 1)
    def stats(self) -> Dict:
        """The epoch's metadata and validity counters."""
        epoch = self.pin()
        valid = invalid = None
        if epoch.counts is not None:
            valid, invalid = decode_counts(epoch.counts)
        return {
            "epoch": epoch.seq,
            "source": epoch.source,
            "published_at": epoch.published_at,
            "age_s": round(epoch.age_s(), 6),
            "events": epoch.events,
            "banks": len(self._day_map(epoch)),
            "window_buckets": len(self._bucket_map(epoch)),
            "roster_size": epoch.roster_size,
            "valid": valid,
            "invalid": invalid,
            "staleness_ceiling_s": self.staleness_ceiling_s,
        }

    def execute(self, verb: str, *, keys=None, days=None,
                roster_size: int = 0, day=None, period_lo=None,
                period_hi=None):
        """One request by verb name (the wire surfaces' entry point)."""
        if verb == "exists":
            return self.bf_exists(keys if keys is not None else ())
        if verb == "pfcount":
            return self.pfcount(days if days is not None else ())
        if verb == "occupancy":
            return self.occupancy()
        if verb == "rate":
            return self.attendance_rate(roster_size)
        if verb == "window_pfcount":
            return self.window_pfcount(day, period_lo, period_hi)
        if verb == "window_occupancy":
            return self.window_occupancy()
        if verb == "rate_series":
            return self.rate_series(day, roster_size)
        if verb == "stats":
            return self.stats()
        raise ValueError(f"unknown query verb {verb!r}")


def resolve_days(values: Sequence) -> np.ndarray:
    """A lecture-day vector from mixed inputs: ints pass through,
    ``LECTURE_YYYYMMDD`` ids resolve by the pipeline's one key-space
    rule (``events.lecture_to_day``)."""
    from attendance_tpu_torch.pipeline.events import lecture_to_day

    out = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values):
        out[i] = lecture_to_day(v) if isinstance(v, str) else int(v)
    return out
