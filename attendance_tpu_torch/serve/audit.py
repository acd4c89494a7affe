"""Read-path accuracy auditing: sampled query answers vs the shadow.

Counterpart of ``attendance_tpu/serve/audit.py``. The write path's
auditor (obs/audit.ShadowAuditor) keeps exact ground
truth for a hash-sampled key subspace. The query plane reuses that
SAME shadow — the sampled subspace is sampled for queries too, so a
sampled read answer is exactly classifiable:

* a sampled BF.EXISTS answered absent for a shadowed roster key is a
  certain FALSE NEGATIVE (``attendance_query_false_negatives_total``
  must stay 0 — an increment means the mirror/probe path corrupted the
  filter view, caught in production);
* a sampled BF.EXISTS for a key outside the shadowed roster is a
  measured-FPR trial (``attendance_query_measured_fpr`` = read-path
  fp / read-path sampled negatives);
* a PFCOUNT answer for an audited day is compared against the epoch's
  own shadow-truth snapshot (``Epoch.day_truth``, captured at publish
  time so estimate and truth describe the SAME moment — a live-truth
  comparison would charge barrier staleness to the sketch), exported
  as ``attendance_query_hll_rel_error{key=day:<d>}``.

Gauges are separate from the write path's so drift between the two
surfaces is itself observable (a healthy filter with a corrupt mirror
shows clean write gauges and dirty read gauges).
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

QUERY_AUDIT_HELP = {
    "attendance_query_measured_fpr":
        "Measured read-path Bloom FPR: sampled positive answers for "
        "keys outside the shadowed roster / sampled negative trials "
        "(NaN until a sampled negative query happens)",
    "attendance_query_false_negatives_total":
        "Sampled read-path BF.EXISTS answers of 'absent' for keys the "
        "shadow knows were preloaded — must stay 0",
    "attendance_query_audited_total":
        "Sampled read-path answers cross-checked against the shadow",
}


class ReadAuditor:
    """Per-engine read audit over a shared ShadowAuditor's ground
    truth. All methods take the already-built u32 key arrays and the
    vectorized answers — auditing never re-runs the query."""

    def __init__(self, registry, shadow):
        self._shadow = shadow
        # Per-day rel-error gauges, cached: check_pfcount runs on
        # every audited table answer, and re-resolving through the
        # locked registry per day per call would contend with the
        # scrape thread at table-RPC rate (same discipline as
        # QueryEngine's per-verb counter cache).
        self._day_gauges = {}
        self._checks = registry.counter(
            "attendance_query_audited_total",
            help=QUERY_AUDIT_HELP["attendance_query_audited_total"])
        self._fn = registry.counter(
            "attendance_query_false_negatives_total",
            help=QUERY_AUDIT_HELP[
                "attendance_query_false_negatives_total"])
        self._fp = registry.counter(
            "attendance_query_false_positives_total",
            help="Sampled read-path positives for keys outside the "
            "shadowed roster")
        self._neg = registry.counter(
            "attendance_query_negative_trials_total",
            help="Sampled read-path BF.EXISTS trials outside the "
            "shadowed roster (the measured-FPR denominator)")
        registry.gauge(
            "attendance_query_measured_fpr",
            help=QUERY_AUDIT_HELP["attendance_query_measured_fpr"]
        ).set_function(self.measured_fpr)
        self._registry = registry

    def measured_fpr(self) -> float:
        neg = self._neg.value
        if neg == 0:
            return float("nan")
        return self._fp.value / neg

    def check_bf(self, keys_u32: np.ndarray,
                 answers: np.ndarray) -> None:
        """Classify the sampled lanes of one BF.EXISTS batch against
        the shadowed roster membership."""
        sampled, member = self._shadow.roster_membership(keys_u32)
        if sampled is None or not sampled.any():
            return
        got = np.asarray(answers, dtype=bool)[sampled]
        self._checks.inc(int(sampled.sum()))
        n_fn = int((member & ~got).sum())
        if n_fn:
            self._fn.inc(n_fn)
            logger.error(
                "Read-path Bloom FALSE NEGATIVE: %d sampled roster "
                "keys answered absent from the epoch mirror", n_fn)
        neg = ~member
        n_neg = int(neg.sum())
        if n_neg:
            self._neg.inc(n_neg)
            n_fp = int((got & neg).sum())
            if n_fp:
                self._fp.inc(n_fp)

    def check_pfcount(self, epoch, days, answers) -> None:
        """Compare audited days' estimates against the epoch's OWN
        truth snapshot (captured at publish — same moment as the
        registers the estimate came from)."""
        truth = getattr(epoch, "day_truth", None)
        if not truth:
            return
        for day, est in zip(np.asarray(days).tolist(),
                            np.asarray(answers).tolist()):
            t = truth.get(int(day))
            if not t:
                continue
            self._checks.inc()
            g = self._day_gauges.get(day)
            if g is None:
                g = self._day_gauges[day] = self._registry.gauge(
                    "attendance_query_hll_rel_error",
                    help="Measured read-path HLL relative error vs "
                    "the epoch's shadow-truth snapshot",
                    key=f"day:{int(day)}")
            g.set(abs(float(est) - t) / t)
