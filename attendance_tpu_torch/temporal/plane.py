"""TemporalPlane: the fused pipeline's temporal sidecar.

Counterpart of ``attendance_tpu/temporal/plane.py``, its telemetry
series included (late outcomes, rotations, evictions, dwell pairs, the
watermark lag and the buffer gauges). One instance per FusedPipeline
when ``temporal_period_s`` > 0. Per frame it does three things:

1. **Windowed HLL adds, at arrival.** Every event's bucket is a pure
   function of its own timestamp and the register update is an
   order-free max, so the add dispatches with the frame itself (K4
   Bloom probe, then K5 register max into the SHARED register tensor,
   through the pipeline's ``dispatch_add``) and is acknowledged with
   the frame. Only the drop/fold classification consults the
   watermark; events whose bucket already rotated are side-channeled
   (counted, sampled) instead of misbucketed.

2. **Watermarked reorder for the order-sensitive consumers.** The
   bounded reorder stage releases events in event-time order;
   rotation and eviction advance at watermark boundaries, entry/exit
   pairs fold into the dwell histogram, and the CMS estimates stage
   toward the top-K.

3. **Count-Min gate-fraud tracking.** Every released swipe (valid or
   not: fraud cares about raw attempts) goes through the CMS step (K6
   on the card); its estimate tensor stays staged, with its keys, and
   is read back (``.cpu()``, ordered on the current stream) only when
   folded into the bounded top-K at rotation boundaries, so the hot
   loop does not wait on the card.

The reorder buffer, CMS counts, top-K and dwell state are advisory;
the windowed HLL banks are the durable answer.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from attendance_tpu_torch.device import to_device
from attendance_tpu_torch.models.cms import TopK, cms_init, cms_step
from attendance_tpu_torch.models.fused import padded_lanes
from attendance_tpu_torch.temporal.buckets import bucket_keys, period_micros
from attendance_tpu_torch.temporal.reorder import ReorderStage
from attendance_tpu_torch.temporal.windows import BucketRing

logger = logging.getLogger(__name__)

_DROP_SAMPLE = 256  # side-channel ring of recent dropped events
_CMS_FOLD_BLOCKS = 64  # staged (keys, est) blocks before an early fold


class TemporalPlane:
    def __init__(self, config, *, device: torch.device, alloc_bank,
                 free_buckets, mark_dirty, dispatch_add, obs=None):
        self.device = device
        # Attribution plane (obs/profiler.py): the CMS step reports its
        # fingerprint to the launch-shape tracker, as the fused steps do.
        self._recomp = obs.recompiles if obs is not None else None
        self.period_us = period_micros(config.temporal_period_s)
        self.reorder = ReorderStage(
            int(round(config.allowed_lateness_s * 1e6)),
            idle_s=config.watermark_idle_s)
        self.ring = BucketRing(self.period_us,
                               config.temporal_ring_banks,
                               alloc_bank, free_buckets)
        self._mark_dirty = mark_dirty
        self._dispatch_add = dispatch_add
        # Second sketch: device CMS + bounded host top-K.
        self.cms_counts = cms_init(config.cms_depth, config.cms_width,
                                   device)
        # (keys np, est tensor, pinned keys or None) until folded.
        self._cms_staged: List[tuple] = []
        self.topk = TopK(config.cms_topk)
        # Dwell pairing: pending entry times keyed by (day << 32 | sid)
        # as SORTED parallel arrays, plus a log2-bucketed histogram of
        # paired dwell times.
        self._dwell_keys = np.zeros(0, np.int64)
        self._dwell_times = np.zeros(0, np.int64)
        self.dwell_hist = np.zeros(40, np.int64)  # 2^b us buckets
        self.dwell_pairs_total = 0
        self.dwell_unmatched_exits = 0
        # Side channel + counters.
        self.dropped_sample: deque = deque(maxlen=_DROP_SAMPLE)
        self.late_folded_total = 0
        self.late_dropped_total = 0
        self.events_total = 0
        # Exact shadow (the window audit oracle): per-bucket sets of
        # VALID students, kept when the full-population audit is on.
        self._shadow: Optional[Dict[int, set]] = (
            {} if config.audit_sample >= 1.0 else None)
        self._roster: Optional[np.ndarray] = None
        # The plane's series (JAX's names, help and labels): the late
        # outcomes the control plane's watermark adaptation reads, the
        # rotations and evictions, and scrape-time callback gauges over
        # host state.
        self._evictions_seen = 0
        self._c_late = {}
        if obs is not None:
            reg = obs.registry
            for outcome in ("folded", "dropped"):
                self._c_late[outcome] = reg.counter(
                    "attendance_late_events_total",
                    help="Late events per outcome: folded = landed in "
                    "the correct still-open bucket; dropped = bucket "
                    "already rotated, event side-channeled",
                    outcome=outcome)
            self._c_rotations = reg.counter(
                "attendance_window_rotations_total",
                help="Bucket rotations (open -> closed) at watermark "
                "boundaries")
            self._c_evictions = reg.counter(
                "attendance_window_evictions_total",
                help="Closed buckets evicted by ring pressure (bank "
                "row zeroed and recycled)")
            reg.gauge(
                "attendance_watermark_lag_seconds",
                help="Event-time lag between the stream head and the "
                "watermark (steady state = allowed lateness; NaN "
                "before the first event)").set_function(
                    self.reorder.watermark_lag_s)
            reg.gauge(
                "attendance_window_open_buckets",
                help="Temporal buckets not yet rotated").set_function(
                    lambda: float(self.ring.open_buckets))
            reg.gauge(
                "attendance_temporal_reorder_buffered",
                help="Events held by the watermark reorder buffer"
            ).set_function(lambda: float(self.reorder.buffered))
            reg.gauge(
                "attendance_cms_topk_size",
                help="Heavy-hitter candidates currently tracked"
            ).set_function(lambda: float(len(self.topk)))
            self._c_dwell = reg.counter(
                "attendance_dwell_pairs_total",
                help="Entry/exit pairs folded into the dwell-time "
                "histogram")

    # -- roster / shadow -----------------------------------------------------
    def record_roster(self, keys: np.ndarray) -> None:
        """The preloaded roster (the filter's full membership): what
        the exact window shadow uses to classify validity."""
        self._roster = np.sort(np.asarray(keys, np.uint32))

    def shadow_truth(self) -> Dict[int, int]:
        """Exact unique-valid-student count per bucket key (empty when
        the full shadow is off)."""
        if self._shadow is None:
            return {}
        return {k: len(s) for k, s in self._shadow.items()}

    # -- per-frame hook ------------------------------------------------------
    def observe_frame(self, cols: Dict[str, np.ndarray]) -> None:
        days = np.asarray(cols["lecture_day"])
        micros = np.asarray(cols["micros"], np.int64)
        sids = np.asarray(cols["student_id"], np.uint32)
        n = len(micros)
        if n == 0:
            return
        self.events_total += n
        # Reorder first: bumps max_seen, returns the ordered releases
        # for the order-sensitive consumers below.
        released = self.reorder.offer(cols)
        wm = self.reorder.effective_watermark_us
        arrival_late = self.reorder.last_arrival_late
        # Windowed adds at arrival, judged against the PRE-rotation
        # frontier (releases freed by this very advance never drop).
        banks, dropped, touched = self.ring.assign(days, micros)
        if dropped:
            self.late_dropped_total += dropped
            if self._c_late:
                self._c_late["dropped"].inc(dropped)
            drop_idx = np.flatnonzero(banks < 0)[:_DROP_SAMPLE]
            for i in drop_idx.tolist():
                self.dropped_sample.append(
                    (int(sids[i]), int(days[i]), int(micros[i])))
        folded = int(((banks >= 0) & arrival_late).sum())
        if folded:
            self.late_folded_total += folded
            if self._c_late:
                self._c_late["folded"].inc(folded)
        keep = banks >= 0
        if keep.any():
            self._mark_dirty(touched)
            self._dispatch_add(sids, banks)
        if self._shadow is not None and self._roster is not None \
                and len(self._roster):
            self._record_shadow(sids[keep], days[keep], micros[keep])
        # Rotation AFTER the adds; eviction and the top-K fold ride it.
        if self._rotate(wm):
            self._fold_cms()
        if released is not None:
            self._consume_released(released)

    def _rotate(self, watermark_us: int) -> int:
        """Advance the ring's frontier and sync the rotation and eviction
        counters: the one rotate path for per-frame advances, idle
        flushes and end-of-run flushes alike."""
        rotated = self.ring.rotate(watermark_us)
        if self._c_late:
            if rotated:
                self._c_rotations.inc(rotated)
            ev = self.ring.evictions_total
            if ev > self._evictions_seen:
                self._c_evictions.inc(ev - self._evictions_seen)
                self._evictions_seen = ev
        return rotated

    def _record_shadow(self, sids, days, micros) -> None:
        valid_pos = np.searchsorted(self._roster, sids)
        valid_pos = np.clip(valid_pos, 0, len(self._roster) - 1)
        valid = self._roster[valid_pos] == sids
        if not valid.any():
            return
        periods = micros // np.int64(self.period_us)
        keys = bucket_keys(days.astype(np.int64), periods)
        for key, sid in zip(keys[valid].tolist(),
                            sids[valid].tolist()):
            self._shadow.setdefault(key, set()).add(sid)

    # -- order-sensitive consumers -------------------------------------------
    def _consume_released(self, rel: Dict[str, np.ndarray]) -> None:
        sids = np.ascontiguousarray(rel["student_id"], np.uint32)
        if len(sids) == 0:
            return
        # CMS: one update+query step; the estimates stay on the device
        # until the fold. No padding: the card has no compile cache.
        if self._recomp is not None:
            # The JAX package's fingerprint: the power-of-two padded
            # lanes its compiled step takes. K6 launches at the batch's
            # own length, so this site's steady count says nothing of
            # the launch shape.
            self._recomp.observe("cms_step", (padded_lanes(len(sids)),))
        keys, pinned = to_device(sids.view(np.int32), self.device)
        est = cms_step(self.cms_counts, keys)
        self._cms_staged.append((sids, est, pinned))
        if len(self._cms_staged) >= _CMS_FOLD_BLOCKS:
            self._fold_cms()
        self._pair_dwell(rel)

    def _fold_cms(self) -> None:
        """Fold staged (keys, estimates) into the top-K. Runs at
        rotation boundaries (and on staging overflow); ``.cpu()`` on the
        current stream waits for the step that wrote each estimate."""
        staged, self._cms_staged = self._cms_staged, []
        for keys, est, _pinned in staged:
            self.topk.offer(keys, est.cpu().numpy().view(np.uint32))

    def _pair_dwell(self, rel: Dict[str, np.ndarray]) -> None:
        """Entry/exit pairing over the ORDERED release stream: adjacent
        (student, day) entry->exit pairs fold vectorized; pairs that
        straddle release blocks go through the bounded pending map."""
        sid = rel["student_id"].astype(np.int64)
        day = rel["lecture_day"].astype(np.int64)
        et = np.asarray(rel["event_type"])
        mic = np.asarray(rel["micros"], np.int64)
        pkey = (day << np.int64(32)) | sid
        order = np.argsort(pkey, kind="stable")  # stable: time order
        k, e, m = pkey[order], et[order], mic[order]
        same_prev = np.concatenate([[False], k[1:] == k[:-1]])
        prev_entry = np.concatenate([[False], e[:-1] == 0])
        paired = (e == 1) & same_prev & prev_entry
        if paired.any():
            m_prev = np.concatenate([[np.int64(0)], m[:-1]])
            self._fold_dwell(m[paired] - m_prev[paired])
        # Repeated exits (exit directly after exit) have no entry.
        self.dwell_unmatched_exits += int(
            ((e == 1) & same_prev & ~prev_entry).sum())
        # Cross-block boundaries against the sorted pending arrays:
        # run-leading exits match (and consume) pending entries;
        # run-trailing unconsumed entries feed the map (a re-entry's
        # LATEST entry time wins).
        lead = np.flatnonzero((e == 1) & ~same_prev)
        pk, pt = self._dwell_keys, self._dwell_times
        if len(lead):
            lk, lt = k[lead], m[lead]  # sorted, unique (one per run)
            pos = np.searchsorted(pk, lk)
            found = (pos < len(pk))
            found[found] = pk[np.minimum(pos[found], len(pk) - 1)] \
                == lk[found]
            if found.any():
                self._fold_dwell(lt[found] - pt[pos[found]])
                keep = np.ones(len(pk), bool)
                keep[pos[found]] = False
                pk, pt = pk[keep], pt[keep]
            self.dwell_unmatched_exits += int((~found).sum())
        last_of_run = np.concatenate([k[1:] != k[:-1], [True]])
        tail = np.flatnonzero((e == 0) & last_of_run)
        if len(tail):
            tk, tt = k[tail], m[tail]  # sorted, unique
            pos = np.searchsorted(pk, tk)
            found = (pos < len(pk))
            found[found] = pk[np.minimum(pos[found], len(pk) - 1)] \
                == tk[found]
            if found.any():
                pt = pt.copy()
                pt[pos[found]] = tt[found]  # latest entry wins
            fresh = ~found
            if fresh.any():
                pk = np.concatenate([pk, tk[fresh]])
                pt = np.concatenate([pt, tt[fresh]])
                order = np.argsort(pk, kind="stable")
                pk, pt = pk[order], pt[order]
        if len(pk) > 1 << 21:  # bound a pathological stream
            pk = np.zeros(0, np.int64)
            pt = np.zeros(0, np.int64)
            logger.warning("dwell pending map overflowed; cleared")
        self._dwell_keys, self._dwell_times = pk, pt

    def _fold_dwell(self, dwell_us: np.ndarray) -> None:
        dwell_us = dwell_us[dwell_us >= 0]
        if not len(dwell_us):
            return
        b = np.log2(np.maximum(dwell_us, 1)).astype(np.int64)
        np.add.at(self.dwell_hist, np.clip(b, 0, 39), 1)
        self.dwell_pairs_total += len(dwell_us)
        if self._c_late:
            self._c_dwell.inc(len(dwell_us))

    # -- control-plane knobs -------------------------------------------------
    def widen_lateness(self, lateness_us: int) -> None:
        """GROW the allowed-lateness budget (the controller's late-drop
        adaptation, from its own thread). Widening is safe mid-stream:
        the watermark only trails further, so no event that would have
        been released on time can now drop. A smaller value could jump
        the watermark over buffered events and is ignored (the knob's
        lower bound is the configured value for the same reason)."""
        lateness_us = int(lateness_us)
        if lateness_us > self.reorder.lateness_us:
            self.reorder.lateness_us = lateness_us

    def grow_ring(self, capacity: int) -> None:
        """GROW the bucket ring's capacity (the controller's late-drop
        adaptation). Eviction triggers on len >= capacity, so a larger
        one only delays the next eviction; a smaller one would strand
        allocated buckets past the bound and is ignored."""
        capacity = int(capacity)
        if capacity > self.ring.capacity:
            self.ring.capacity = capacity

    # -- liveness ------------------------------------------------------------
    def maybe_idle_flush(self) -> bool:
        """Watermark idle advancement: silent past watermark_idle_s
        with events buffered -> release everything and rotate to the
        stream head. Called from the run loop's receive timeout."""
        if not self.reorder.idle_due():
            return False
        self.flush()
        return True

    def flush(self) -> None:
        """End of stream: release the reorder buffer, rotate to the
        head, fold the staged CMS estimates."""
        released = self.reorder.flush()
        if released is not None:
            self._consume_released(released)
        self._rotate(self.reorder.effective_watermark_us)
        self._fold_cms()

    def restore(self, bank_of: Dict[int, int]) -> None:
        """Re-seed after a chain restore: the buckets come back from the
        chain's bank map; the watermark, CMS, top-K and dwell state are
        advisory and restart."""
        n = self.ring.restore(bank_of)
        if n:
            logger.info("temporal ring restored %d bucket(s) from the "
                        "snapshot chain", n)

    def stats(self) -> Dict:
        return {
            "events": self.events_total,
            "buckets": len(self.ring),
            "open_buckets": self.ring.open_buckets,
            "rotations": self.ring.rotations_total,
            "evictions": self.ring.evictions_total,
            "late_folded": self.late_folded_total,
            "late_dropped": self.late_dropped_total,
            "reorder_buffered": self.reorder.buffered,
            "watermark_lag_s": self.reorder.watermark_lag_s(),
            "dwell_pairs": self.dwell_pairs_total,
            "dwell_unmatched_exits": self.dwell_unmatched_exits,
            "topk": [(int(k), int(v)) for k, v in self.topk.items()],
        }
