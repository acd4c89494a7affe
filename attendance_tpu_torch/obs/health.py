"""Sketch-health gauges: live accuracy telemetry at scrape time.

Counterpart of ``attendance_tpu/obs/health.py``. The accuracy targets
(<= 1% Bloom FPR, <= 2% HLL relative error) are defined over sketch
STATE, not traffic, so the scrape surface reports the live Bloom fill
and FPR and the HLL estimate and saturation, and an accuracy regression
shows DURING a run instead of only in a parity check after it.

Design constraints, in order:

* Never on the hot path: every gauge is a CALLBACK registered at
  construction; the reads (a popcount and a scalar copy for the filter,
  the K1 register histogram for the HLL) run only when a scrape renders
  the registry. With telemetry off nothing here is registered.
* Never pin the owner: callbacks close over a ``weakref`` to the
  pipeline or store.
* Never lie: a callback that RAISES (a torn-down owner, a failed card
  read) propagates, and the exposition layer skips the sample with a
  warning (``obs.exposition.render``) rather than rendering a 0.0 that
  reads as "FPR is zero".

A scrape thread's reads of the card go on the default stream, behind
the run loop's steps, and wait for that stream (``.item()``,
``.cpu()``), never for the whole device.

Metric names (part of the stable scrape contract in obs/__init__):

* ``attendance_bloom_fill_fraction``: fraction of set filter bits.
* ``attendance_bloom_estimated_fpr``: fill^k, the estimator of
  ``BloomFilter.estimated_fpr`` / ``FusedPipeline.estimated_fpr``.
* ``attendance_hll_estimate``: Ertl estimate summed over registered
  banks (``models/hll.py:estimate_from_histogram``).
* ``attendance_hll_saturated_registers``: registers at rank > q (the
  ``C[q+1]`` histogram bin), where the relative error starts to degrade.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

HEALTH_HELP = {
    "attendance_bloom_fill_fraction":
        "Fraction of set Bloom filter bits (scrape-time device read)",
    "attendance_bloom_estimated_fpr":
        "Occupancy-based Bloom FPR estimate (fill^k)",
    "attendance_hll_estimate":
        "HLL cardinality estimate summed over registered banks",
    "attendance_hll_saturated_registers":
        "HLL registers at rank > q (saturation)",
}


def _gauge(telemetry, name: str, fn, **labels) -> None:
    telemetry.registry.gauge(
        name, help=HEALTH_HELP[name], **labels).set_function(fn)


def _deref(ref):
    obj = ref()
    if obj is None:
        # Propagate: render() skips the sample with a warning; a dead
        # pipeline has NO fill fraction, and 0.0 would claim an empty
        # filter.
        raise LookupError("sketch owner was torn down")
    return obj


def multiprocess_mesh(pipe) -> bool:
    """True for a mesh pipeline in a process group of more than one
    process: its fill and count reductions are collectives, which must
    never run from one process's scrape thread (the others would not
    join, and the group would wedge)."""
    return (pipe.engine is not None and torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


def register_fused(telemetry, pipe, **labels) -> None:
    """Register the four health gauges for a FusedPipeline (one card's
    packed state or the mesh engine). Called from the pipeline
    constructor iff telemetry is live."""
    if multiprocess_mesh(pipe):
        return
    ref = weakref.ref(pipe)

    def _bloom_epoch(p):
        """The pinned epoch, when its filter words can answer for the
        live filter: the fused filter is fixed between preloads (the hot
        loop never adds to it) and every preload republishes, so ANY
        epoch carrying words is bit-current."""
        epoch = p.read_mirror.pin()
        if epoch is not None and epoch.bloom_words is not None:
            return epoch
        return None

    def _hll_epoch(p):
        """The pinned epoch, when its register rows are the right source
        for the HLL gauges: only under checkpointing, where barriers
        republish at cadence, so a scrape racing a barrier's capture
        reads a consistent epoch. Without checkpointing nothing
        republishes mid-run, and the gauges read the card."""
        if not p.checkpointing:
            return None
        return p.read_mirror.pin()

    def fill() -> float:
        p = _deref(ref)
        epoch = _bloom_epoch(p)
        if epoch is not None:
            from attendance_tpu_torch.models.bloom import (
                bloom_packed_fill_fraction_np)
            return bloom_packed_fill_fraction_np(epoch.bloom_words)
        if p.engine is not None:
            return float(p.engine.fill_fraction())
        from attendance_tpu_torch.models.bloom import (
            bloom_packed_fill_fraction)
        return float(bloom_packed_fill_fraction(p.state.bloom_bits))

    def fpr() -> float:
        return fill() ** _deref(ref).params.k

    def hll_estimate() -> float:
        p = _deref(ref)
        epoch = _hll_epoch(p)
        if epoch is not None:
            from attendance_tpu_torch.models.hll import estimates_from_rows
            if not epoch.bank_of:
                return 0.0
            banks = np.fromiter(epoch.bank_of.values(), np.int64,
                                len(epoch.bank_of))
            ests = estimates_from_rows(epoch.hll_regs[banks],
                                       epoch.precision)
            # Per-bank integer rounding, as count_all(): the gauge and
            # the model's own method agree exactly.
            return float(np.rint(ests).sum())
        return float(sum(p.count_all().values()))

    def hll_saturated() -> float:
        p = _deref(ref)
        q = 64 - p.config.hll_precision
        epoch = _hll_epoch(p)
        if epoch is not None:
            return float((epoch.hll_regs > q).sum())
        if p.engine is not None:
            # The registers merged across replicas: the view the query
            # path counts with (register-max union).
            return float((p.engine._merged_regs() > q).sum())
        return float(torch.count_nonzero(p.state.hll_regs > q))

    _gauge(telemetry, "attendance_bloom_fill_fraction", fill, **labels)
    _gauge(telemetry, "attendance_bloom_estimated_fpr", fpr, **labels)
    _gauge(telemetry, "attendance_hll_estimate", hll_estimate, **labels)
    _gauge(telemetry, "attendance_hll_saturated_registers",
           hll_saturated, **labels)


def register_store(telemetry, store, bloom_key: str, **labels) -> None:
    """Register the health gauges for a generic :class:`SketchStore`
    (the ``--sketch-backend memory/tpu/redis-sim`` command path).

    The weakref target is the STORE, not its inner filter or HLL
    objects: a snapshot restore REPLACES those, so the callbacks re-read
    ``store._blooms`` / ``store._hll`` on each scrape.
    ``utils/snapshot.restore_sketch_store`` also re-invokes this
    registration (idempotent: ``set_function`` on the same gauge)."""
    from attendance_tpu_torch.models.hll import (
        best_histogram as best_histogram_of,
        estimate_from_histogram as estimate_of)

    ref = weakref.ref(store)

    def _fills(s):
        """(fill, m_bits) per sub-filter of the audited Bloom chain;
        None when the key is absent."""
        bloom = s._blooms.get(bloom_key)
        if bloom is None:
            return None
        return [(s._filter_fill(handle, params), params.m_bits)
                for handle, params in zip(bloom.filters, bloom.params)]

    def fill() -> float:
        fills = _fills(_deref(ref))
        if not fills:
            raise LookupError(f"no inspectable filter at {bloom_key!r}")
        total = sum(m for _, m in fills)
        return sum(f * m for f, m in fills) / total

    def fpr() -> float:
        v = _deref(ref).estimated_fpr(bloom_key)
        if v is None:
            raise LookupError(f"no inspectable filter at {bloom_key!r}")
        return float(v)

    def _per_key(s) -> dict:
        per_key = getattr(s, "_hll_regs", None)
        if per_key is None:
            per_key = getattr(s, "_hlls", None)  # redis-sim
        return per_key or {}

    def hll_estimate() -> float:
        s = _deref(ref)
        hll = getattr(s, "_hll", None)
        if hll is not None:  # banked (the card store): one K1 launch
            hists = best_histogram_of(hll.regs, hll.precision).cpu().numpy()
            return float(sum(
                estimate_of(hists[b], hll.precision)
                for b in hll._bank_of.values()))
        # Per-key stores: the sum of per-key estimates (the aggregate
        # the fused gauge reports).
        precision = getattr(s, "precision", 14)
        total = 0.0
        q = 64 - precision
        for regs in _per_key(s).values():
            hist = np.bincount(np.asarray(regs), minlength=q + 2)
            total += estimate_of(hist, precision)
        return total

    def hll_saturated() -> float:
        s = _deref(ref)
        hll = getattr(s, "_hll", None)
        if hll is not None:
            return float(torch.count_nonzero(
                hll.regs > 64 - hll.precision))
        per_key = _per_key(s)
        if not per_key:
            raise LookupError("store holds no HLL state yet")
        q = 64 - getattr(s, "precision", 14)
        return float((np.stack(list(per_key.values())) > q).sum())

    _gauge(telemetry, "attendance_bloom_fill_fraction", fill, **labels)
    _gauge(telemetry, "attendance_bloom_estimated_fpr", fpr, **labels)
    _gauge(telemetry, "attendance_hll_estimate", hll_estimate, **labels)
    _gauge(telemetry, "attendance_hll_saturated_registers",
           hll_saturated, **labels)
    # Breadcrumb for restore-time re-registration (utils/snapshot).
    store._health_registration = (bloom_key, dict(labels))


def reregister_store(store) -> None:
    """Refresh a store's health gauges after a snapshot restore, if it
    was ever registered and telemetry is still live."""
    from attendance_tpu_torch import obs

    reg = getattr(store, "_health_registration", None)
    t = obs.get()
    if reg is None or t is None:
        return
    bloom_key, labels = reg
    register_store(t, store, bloom_key, **labels)


def register_bloom_filter(telemetry, bloom, **labels) -> None:
    """Register fill/FPR gauges for a standalone
    ``models.bloom.BloomFilter``; label by filter key so several
    filters coexist."""
    ref = weakref.ref(bloom)

    def fill() -> float:
        from attendance_tpu_torch.models.bloom import bloom_fill_fraction
        return float(bloom_fill_fraction(_deref(ref).bits))

    def fpr() -> float:
        return _deref(ref).estimated_fpr()

    _gauge(telemetry, "attendance_bloom_fill_fraction", fill, **labels)
    _gauge(telemetry, "attendance_bloom_estimated_fpr", fpr, **labels)


def register_hll(telemetry, hll, **labels) -> None:
    """Register estimate/saturation gauges for a standalone
    ``models.hll.HyperLogLog``."""
    ref = weakref.ref(hll)

    def estimate() -> float:
        from attendance_tpu_torch.models.hll import (
            best_histogram, estimate_from_histogram)
        h = _deref(ref)
        hists = best_histogram(h.regs, h.precision).cpu().numpy()
        return float(sum(estimate_from_histogram(hists[b], h.precision)
                         for b in h._bank_of.values()))

    def saturated() -> float:
        h = _deref(ref)
        return float(torch.count_nonzero(h.regs > 64 - h.precision))

    _gauge(telemetry, "attendance_hll_estimate", estimate, **labels)
    _gauge(telemetry, "attendance_hll_saturated_registers", saturated,
           **labels)
