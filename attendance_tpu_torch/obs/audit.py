"""Continuous accuracy auditing: measured sketch error, live.

Counterpart of ``attendance_tpu/obs/audit.py``. The health gauges
(``obs/health.py``) expose *estimated* accuracy
(``attendance_bloom_estimated_fpr`` is fill^k, an occupancy model). This
module measures it: an exact shadow (ground-truth member and cardinality
sets) is kept for a hash-sampled fraction of the key space, every
sampled sketch answer is cross-checked against it, and the drift between
estimator and measurement becomes its own observable: the accuracy
targets (<= 1% Bloom FPR, <= 2% HLL relative error) evaluated while the
system runs.

Sampling is a HASH PARTITION of the key space (Knuth multiplicative
hash over the u32 key domain, threshold compare), not a per-call coin
flip: a sampled key is sampled on every add AND every query, so the
shadow is complete ground truth for its subspace:

* a sampled query answered positive whose key was never added is a
  certain FALSE POSITIVE (measured FPR = fp / sampled negative
  queries, an unbiased estimate of the filter's true FPR);
* a sampled query answered negative whose key WAS added is a certain
  FALSE NEGATIVE, impossible for a correct Bloom filter, so
  ``attendance_bloom_false_negatives_total`` must stay 0 and any
  increment is a kernel bug caught in production;
* the distinct sampled members of an HLL key, scaled by 1/sample, are
  an unbiased exact-count estimate, so
  ``attendance_hll_measured_rel_error`` measures the sketch's real
  error at sample=1.0 and a sampling-noise-bounded estimate below.

Cost: the per-batch cost is one vectorized multiply and compare over the
batch plus set operations on the sampled lanes (about 1% by default),
in Python on the calling thread; shadow sets are capped (a key past
:data:`SHADOW_CAP` sampled members stops being audited, loudly, instead
of growing without bound). The fused pipeline only RECORDS shadow truth
per frame; its measured gauges are scrape-time callbacks that re-query
the filter (the ``obs/health.py`` discipline: reads of the card only
when a scrape renders the registry).
"""

from __future__ import annotations

import logging
import threading
import weakref
from typing import Dict, Optional, Sequence, Set

import numpy as np

logger = logging.getLogger(__name__)

# Knuth's multiplicative constant (2^32 / phi, odd): multiplication
# mod 2^32 is a bijection of the key domain, so threshold sampling
# takes an (almost exactly) `sample` fraction of ANY key population —
# including the sequential student-id rosters the reference generates,
# which a plain modulus would sample pathologically.
_MIX = np.uint32(2654435761)

# Per-key shadow bound: past this many sampled members the key's audit
# is abandoned (counted, logged once) rather than letting ground-truth
# sets grow without bound on a multi-hour run. 1<<20 sampled members
# at the default 1% sample covers a ~100M-distinct-key population.
SHADOW_CAP = 1 << 20

AUDIT_HELP = {
    "attendance_bloom_measured_fpr":
        "Measured Bloom FPR: false positives / sampled negative "
        "queries against the exact shadow (NaN until a sampled "
        "negative query happens)",
    "attendance_bloom_false_positives_total":
        "Sampled Bloom queries answered positive whose key was never "
        "added (shadow-certain false positives)",
    "attendance_bloom_false_negatives_total":
        "Sampled Bloom queries answered negative whose key WAS added "
        "— must stay 0; any increment is a sketch correctness bug",
    "attendance_audit_negative_checks_total":
        "Sampled Bloom queries whose key is not in the shadow (the "
        "measured-FPR denominator)",
    "attendance_audit_checks_total":
        "Sampled sketch answers cross-checked against the shadow",
    "attendance_hll_measured_rel_error":
        "Measured HLL relative error vs the exact shadow count "
        "(scaled by 1/sample)",
    "attendance_audit_shadow_members":
        "Ground-truth members currently held by the shadow auditor",
    "attendance_audit_shadow_overflow_total":
        "Keys whose shadow hit its cap and stopped being audited",
}


class ShadowAuditor:
    """Sampled exact-shadow cross-checker shared by every instrumented
    sketch surface (SketchStore command dispatch + the fused pipeline).

    Thread-safe the same way the registry is: one mutex around the
    shadow sets; counters/gauges carry their own locks. All public
    methods take the u32-normalized key arrays the call sites already
    computed — auditing never re-hashes members.
    """

    def __init__(self, registry, sample: float):
        if not (0.0 < sample <= 1.0):
            raise ValueError(f"audit sample out of range: {sample}")
        self.sample = sample
        # Threshold compare on the mixed key: u32 < sample * 2^32.
        # sample=1.0 (threshold 2^32, every key) is special-cased so
        # the per-frame compare stays in the uint32 domain — no
        # widening pass over the batch on the hot path.
        self._all = sample >= 1.0
        self._threshold = np.uint32(
            min(round(sample * (1 << 32)), (1 << 32) - 1))
        self._lock = threading.Lock()
        self._bloom_shadow: Dict[str, Set[int]] = {}
        self._hll_shadow: Dict[str, Set[int]] = {}
        self._dead: Set[str] = set()  # keys past SHADOW_CAP
        # Fused traffic reservoir freeze: at cap the set stops GROWING
        # (measured FPR keeps working over the frozen probe population)
        # instead of being evicted per frame — an O(cap) rebuild per
        # frame would silently blow the hot-path guardrail.
        self._traffic_frozen = False
        r = registry
        self._checks = r.counter("attendance_audit_checks_total",
                                 help=AUDIT_HELP[
                                     "attendance_audit_checks_total"])
        self._fp = r.counter(
            "attendance_bloom_false_positives_total",
            help=AUDIT_HELP["attendance_bloom_false_positives_total"])
        self._fn = r.counter(
            "attendance_bloom_false_negatives_total",
            help=AUDIT_HELP["attendance_bloom_false_negatives_total"])
        self._negatives = r.counter(
            "attendance_audit_negative_checks_total",
            help=AUDIT_HELP["attendance_audit_negative_checks_total"])
        self._overflow = r.counter(
            "attendance_audit_shadow_overflow_total",
            help=AUDIT_HELP["attendance_audit_shadow_overflow_total"])
        r.gauge("attendance_audit_shadow_members",
                help=AUDIT_HELP["attendance_audit_shadow_members"]
                ).set_function(self._shadow_size)
        # Measured FPR is derived from the two counters at READ time,
        # so the gauge, the counters, and an offline recount can never
        # disagree; NaN (not 0.0) before any sampled negative query —
        # "no data yet" must not render as "FPR is zero".
        r.gauge("attendance_bloom_measured_fpr",
                help=AUDIT_HELP["attendance_bloom_measured_fpr"]
                ).set_function(self.measured_fpr)
        self._registry = r

    # -- sampling ------------------------------------------------------------
    def sample_mask(self, keys_u32: np.ndarray) -> np.ndarray:
        """bool[B]: which keys belong to the audited subspace."""
        keys = np.asarray(keys_u32, dtype=np.uint32)
        if self._all:
            return np.ones(len(keys), dtype=bool)
        return (keys * _MIX) < self._threshold

    def _shadow_size(self) -> float:
        with self._lock:
            return float(
                sum(len(s) for s in self._bloom_shadow.values())
                + sum(len(s) for s in self._hll_shadow.values()))

    def _shadow_add(self, shadows: Dict[str, Set[int]], key: str,
                    sampled: np.ndarray) -> None:
        with self._lock:
            if key in self._dead:
                return
            s = shadows.setdefault(key, set())
            s.update(int(k) for k in sampled)
            if len(s) > SHADOW_CAP:
                self._dead.add(key)
                shadows.pop(key, None)
                self._overflow.inc()
                logger.warning(
                    "audit shadow for %r exceeded %d sampled members; "
                    "auditing of this key stops (counted in "
                    "attendance_audit_shadow_overflow_total)",
                    key, SHADOW_CAP)

    # -- Bloom surface -------------------------------------------------------
    def record_bf_add(self, key: str, keys_u32: np.ndarray) -> None:
        mask = self.sample_mask(keys_u32)
        if mask.any():
            self._shadow_add(self._bloom_shadow, key,
                             np.asarray(keys_u32, np.uint32)[mask])

    def check_bf_exists(self, key: str, keys_u32: np.ndarray,
                        answers: np.ndarray) -> None:
        """Cross-check one BF.EXISTS answer vector: every sampled lane
        is classified against the shadow."""
        mask = self.sample_mask(keys_u32)
        if not mask.any():
            return
        sampled = np.asarray(keys_u32, np.uint32)[mask]
        got = np.asarray(answers, dtype=bool)[mask]
        with self._lock:
            if key in self._dead:
                return
            shadow = self._bloom_shadow.get(key, set())
            member = np.fromiter((int(k) in shadow for k in sampled),
                                 dtype=bool, count=len(sampled))
        self._checks.inc(len(sampled))
        neg = ~member
        n_neg = int(neg.sum())
        if n_neg:
            self._negatives.inc(n_neg)
            n_fp = int((got & neg).sum())
            if n_fp:
                self._fp.inc(n_fp)
        n_fn = int((member & ~got).sum())
        if n_fn:
            # Structurally impossible for a correct filter — scream,
            # don't just count.
            self._fn.inc(n_fn)
            logger.error(
                "Bloom FALSE NEGATIVE on %r: %d sampled added keys "
                "answered absent — sketch correctness bug", key, n_fn)

    def measured_fpr(self) -> float:
        neg = self._negatives.value
        if neg == 0:
            return float("nan")
        return self._fp.value / neg

    # -- HLL surface ---------------------------------------------------------
    def record_pfadd(self, key: str, keys_u32: np.ndarray,
                     mask: Optional[np.ndarray] = None) -> None:
        keys_u32 = np.asarray(keys_u32, np.uint32)
        if mask is not None:
            keys_u32 = keys_u32[np.asarray(mask, dtype=bool)]
        if len(keys_u32) == 0:
            return
        smask = self.sample_mask(keys_u32)
        if smask.any():
            self._shadow_add(self._hll_shadow, key, keys_u32[smask])

    def shadow_count(self, keys: Sequence[str]) -> Optional[float]:
        """Exact distinct count of the sampled subspace across ``keys``
        (union semantics, like PFCOUNT), scaled by 1/sample — None when
        no shadow exists or any key's shadow overflowed."""
        with self._lock:
            if any(k in self._dead for k in keys):
                return None
            sets = [self._hll_shadow.get(k) for k in keys]
            sets = [s for s in sets if s]
            if not sets:
                return None
            union = set().union(*sets)
        return len(union) / self.sample

    def check_pfcount(self, keys: Sequence[str], answer: int) -> None:
        truth = self.shadow_count(keys)
        if not truth:
            return
        self._checks.inc()
        rel = abs(float(answer) - truth) / truth
        # One gauge per audited key set; multi-key unions (rare) label
        # by arity so the cardinality of the label space stays bounded.
        label = keys[0] if len(keys) == 1 else f"union:{len(keys)}"
        self._registry.gauge(
            "attendance_hll_measured_rel_error",
            help=AUDIT_HELP["attendance_hll_measured_rel_error"],
            key=label).set(rel)

    # -- fused-pipeline surface ----------------------------------------------
    # The fused hot loop only RECORDS ground truth (roster + sampled
    # traffic); measurement happens in the scrape-time callbacks
    # register_fused_audit installs, which re-query the live filter —
    # the hot path never blocks on a device answer for auditing.

    def record_roster(self, keys_u32: np.ndarray) -> None:
        """Shadow the fused preload (the roster IS the filter's full
        membership: the fused hot loop never BF.ADDs)."""
        self.record_bf_add("__fused_roster__", keys_u32)

    def _fused_dead(self) -> bool:
        """True once the roster shadow overflowed: with the ground
        truth gone, EVERY fused measurement must stop (not degrade) —
        classifying traffic against a vanished roster would read every
        valid key as a 'negative' and report an FPR near 1.0 on a
        perfectly healthy filter."""
        return "__fused_roster__" in self._dead

    def observe_fused_frame(self, sid: np.ndarray,
                            days: np.ndarray) -> None:
        """Record one decoded frame's sampled lanes: traffic keys (the
        measured-FPR query population) and, for lanes the shadow knows
        to be valid, per-day HLL ground truth."""
        sid = np.asarray(sid, np.uint32)
        mask = self.sample_mask(sid)
        if not mask.any():
            return
        sampled = sid[mask]
        sdays = np.asarray(days)[mask]
        with self._lock:
            if self._fused_dead():
                return
            roster = self._bloom_shadow.get("__fused_roster__", set())
            traffic = self._bloom_shadow.setdefault(
                "__fused_traffic__", set())
            valid = np.fromiter((int(k) in roster for k in sampled),
                                dtype=bool, count=len(sampled))
            if not self._traffic_frozen:
                traffic.update(int(k) for k in sampled)
                if len(traffic) >= SHADOW_CAP:
                    # Freeze (never evict): the measured FPR keeps
                    # working over the frozen probe population, and
                    # the hot path never pays a per-frame rebuild.
                    self._traffic_frozen = True
                    self._overflow.inc()
                    logger.warning(
                        "fused audit traffic reservoir reached %d "
                        "sampled keys; probe population frozen",
                        SHADOW_CAP)
        for day in np.unique(sdays[valid]):
            self._shadow_add(self._hll_shadow, f"day:{int(day)}",
                             sampled[valid & (sdays == day)])

    def fused_probe_sets(self):
        """(roster_probes, negative_probes) u32 arrays for the scrape-
        time device re-query: sampled roster keys (every one must
        answer present — false-negative check) and sampled observed
        traffic keys outside the roster (the measured-FPR population).
        Both empty once the roster shadow overflowed — no ground
        truth, no measurement."""
        with self._lock:
            if self._fused_dead():
                empty = np.empty(0, np.uint32)
                return empty, empty
            roster = self._bloom_shadow.get("__fused_roster__", set())
            traffic = self._bloom_shadow.get("__fused_traffic__", set())
            negatives = traffic - roster
            return (np.fromiter(roster, np.uint32, len(roster)),
                    np.fromiter(negatives, np.uint32, len(negatives)))

    def roster_membership(self, keys_u32: np.ndarray):
        """(sampled_mask, member) against the fused roster shadow:
        ``sampled_mask`` is bool[B] (which lanes the audit owns) and
        ``member`` is bool[sampled] ground-truth roster membership of
        those lanes — the read path's (serve/audit) classification
        input. (None, None) once the roster shadow overflowed (no
        ground truth, no measurement — same rule as the write path)."""
        keys = np.asarray(keys_u32, np.uint32)
        mask = self.sample_mask(keys)
        if not mask.any():
            return mask, np.zeros(0, dtype=bool)
        sampled = keys[mask]
        with self._lock:
            if self._fused_dead():
                return None, None
            roster = self._bloom_shadow.get("__fused_roster__", set())
            member = np.fromiter((int(k) in roster for k in sampled),
                                 dtype=bool, count=len(sampled))
        return mask, member

    def fused_day_truth(self) -> Dict[int, float]:
        """{lecture_day: exact shadow count scaled by 1/sample};
        empty once the roster shadow overflowed (valid-lane
        classification needs the roster, so the per-day truth stops
        being maintained the same moment)."""
        with self._lock:
            if self._fused_dead():
                return {}
            return {int(k.split(":", 1)[1]): len(s) / self.sample
                    for k, s in self._hll_shadow.items()
                    if k.startswith("day:")}


def register_fused_audit(telemetry, pipe, **labels) -> None:
    """Install the fused pipeline's measured-accuracy gauges: scrape-
    time callbacks that re-query the filter over the shadow's probe sets
    and compare ``count_all`` against the shadow's exact per-day counts.
    Same weakref/raise discipline as obs/health.py: never pins the
    pipeline, a dead pipeline's sample is skipped with a warning, reads
    of the card happen only at scrape."""
    from attendance_tpu_torch.obs.health import multiprocess_mesh

    auditor = telemetry.auditor
    if auditor is None:
        return
    if multiprocess_mesh(pipe):
        # The mesh's query contains collectives: never run those from
        # one process's scrape thread (see health.register_fused).
        return
    ref = weakref.ref(pipe)

    def _deref():
        p = ref()
        if p is None:
            raise LookupError("fused pipeline was torn down")
        return p

    def _query(p, keys: np.ndarray) -> np.ndarray:
        # Prefer the epoch-pinned mirror: bit-identical to the card's
        # filter (fixed between preloads; every preload republishes).
        # Pipelines that never published an epoch query the card: K9 and
        # the AND across sp on a mesh, K4 on one card.
        epoch = p.read_mirror.pin()
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        if epoch is not None and epoch.bloom_words is not None:
            from attendance_tpu_torch.models.bloom import (
                bloom_contains_words_np)
            return bloom_contains_words_np(epoch.bloom_words, keys,
                                           epoch.params)
        if p.engine is not None:
            return p.engine.contains(keys)
        from attendance_tpu_torch.models.bloom import (
            bloom_contains_packed, keys_tensor)
        return bloom_contains_packed(
            p.state.bloom_bits, keys_tensor(keys, p.device),
            p.params).cpu().numpy()

    # Fused misses already reported into the shared false-negative
    # counter: the counter also carries store-path increments, so the
    # fused surface reconciles against its OWN baseline; diffing against
    # the shared total would let a store-path FN mask a fused kernel bug.
    # The lock makes the high-water mark one step: the scrape, SLO,
    # incident and fleet threads may read at once.
    fn_reported = [0]
    fn_lock = threading.Lock()

    def measured_fpr() -> float:
        p = _deref()
        roster, negatives = auditor.fused_probe_sets()
        if len(roster):
            misses = int((~_query(p, roster)).sum())
            if misses:
                # Filter bits only get set, so the fused miss count can
                # only shrink between scrapes; report the high-water
                # mark once.
                with fn_lock:
                    if misses > fn_reported[0]:
                        auditor._fn.inc(misses - fn_reported[0])
                        fn_reported[0] = misses
                logger.error(
                    "Fused Bloom FALSE NEGATIVE: %d sampled roster "
                    "keys answered absent", misses)
        if not len(negatives):
            return float("nan")
        return float(_query(p, negatives).sum()) / len(negatives)

    def hll_rel_error() -> float:
        p = _deref()
        # Under checkpointing, answer from the pinned epoch with the
        # TRUTH SNAPSHOT captured at its publish: estimate and truth
        # then describe the same moment (a barrier-stale estimate
        # against live-growing truth would charge barrier lag to the
        # sketch), and the scrape never reads the card.
        epoch = p.read_mirror.pin() if p.checkpointing else None
        if epoch is not None and epoch.day_truth is not None:
            # day_truth == {}: the auditor existed but nothing was
            # audited by this epoch's publish (the preload epoch): "no
            # data yet" is NaN.
            from attendance_tpu_torch.models.hll import estimates_from_rows
            truth = epoch.day_truth
            if not truth:
                return float("nan")
            days = [d for d in truth if d in epoch.bank_of]
            if not days:
                return float("nan")
            banks = np.array([epoch.bank_of[d] for d in days], np.int64)
            ests = estimates_from_rows(epoch.hll_regs[banks],
                                       epoch.precision)
            total_truth = sum(truth[d] for d in days)
            return abs(float(ests.sum()) - total_truth) / total_truth
        truth = auditor.fused_day_truth()
        if not truth:
            return float("nan")
        est = p.count_all()
        total_truth = sum(truth.values())
        total_est = float(sum(est.get(day, 0) for day in truth))
        return abs(total_est - total_truth) / total_truth

    telemetry.registry.gauge(
        "attendance_bloom_measured_fpr",
        help=AUDIT_HELP["attendance_bloom_measured_fpr"],
        surface="fused", **labels).set_function(measured_fpr)
    telemetry.registry.gauge(
        "attendance_hll_measured_rel_error",
        help=AUDIT_HELP["attendance_hll_measured_rel_error"],
        key="fused", **labels).set_function(hll_rel_error)
