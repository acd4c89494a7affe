"""Fused high-rate processor: the hot path end to end on one CUDA card.

Counterpart of ``attendance_tpu/pipeline/fast_path.py:FusedPipeline``,
single-chip branch. Per frame: one planar binary frame from the broker
-> zero-copy columnar decode -> day->bank map and host pack of one wire
(word, bytes, seg or delta; one fused native pass, ``native/``, or the
numpy path with ``ATP_NATIVE=0`` and for days the dense LUT cannot
cover) -> ONE fused kernel call (Bloom validate + HLL count: K2, or its
seg/delta variant) -> with ``temporal_period_s > 0``, the temporal
plane's per-frame hook (window add: K4 probe + K5 register max; the CMS
step K6 on released events; evicted rows zeroed) -> columnar side-store
append -> ack.

Ack ordering: launches are asynchronous, so the host decodes and packs
frame N+1 while the card runs frame N; a frame is acknowledged only
after its step completed. Each dispatch records a ``torch.cuda.Event``;
the in-flight deque acks frames in order as their events complete, and
blocks on the oldest when it is ``_INFLIGHT_DEPTH`` deep. The pinned
host buffers of a frame's copies stay referenced until its event
completes, so an asynchronous copy never reads a recycled buffer.
Replays after a crash are harmless: OR/max sketches and the read-time
dedup store are idempotent.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from attendance_tpu_torch.config import Config
from attendance_tpu_torch.device import resolve_device, to_device
from attendance_tpu_torch.models.bloom import (
    bloom_add_packed, bloom_contains_packed, bloom_packed_fill_fraction)
from attendance_tpu_torch.models.fused import (
    bank_wire_dtype, decode_counts, delta_scan, fused_step_bytes,
    fused_step_delta, fused_step_seg, fused_step_words, init_state,
    pack_bytes, pack_delta, pack_seg, pack_words, pick_delta_width)
from attendance_tpu_torch.models.hll import (
    best_histogram, estimate_from_histogram, hll_add)
from attendance_tpu_torch.native import load as load_native
from attendance_tpu_torch.pipeline.codec import decode_frame
from attendance_tpu_torch.pipeline.events import lecture_to_day
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore
from attendance_tpu_torch.temporal.buckets import is_bucket_key
from attendance_tpu_torch.temporal.plane import TemporalPlane
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient, ReceiveTimeout)

_INFLIGHT_DEPTH = 8  # dispatched-but-unacked frames before blocking
# Host stages of the run loop, in frame order. The native host pack fuses
# the day map with the pack in one call, charged to "pack"; "bank_map" is
# the numpy day map (ATP_NATIVE=0, days the dense LUT cannot cover) and
# the registration of days a native pack missed. "dispatch" is the H2D
# copy enqueue plus the kernel launch, "temporal" the temporal plane's
# host passes and launches (0 when the plane is off), "ack_wait" the time
# blocked on the card.
STAGES = ("receive", "decode", "bank_map", "pack", "dispatch", "temporal",
          "store", "ack_wait")


class _ScatterValidity:
    """Lazy original-order view of the seg/delta wires' validity: the
    step's bool[padded] in packed (bank-sorted) order and the packed
    lane -> original index permutation. ``out[perm] = valid[:n]`` is
    made only when a reader asks (``np.asarray``, as
    ``ColumnarEventStore.to_columns`` does), so the hot loop neither
    waits on the card nor scatters."""

    __slots__ = ("_valid", "_perm", "_n")

    def __init__(self, valid: torch.Tensor, perm: np.ndarray, n: int):
        self._valid, self._perm, self._n = valid, perm, n

    def __len__(self) -> int:
        return self._n

    def __array__(self, dtype=None, copy=None):
        v = self._valid[:self._n].cpu().numpy()
        out = np.empty(self._n, v.dtype)
        out[self._perm] = v
        if dtype is not None and np.dtype(dtype) != out.dtype:
            out = out.astype(dtype)
        return out


@dataclasses.dataclass
class FusedMetrics:
    """Per-run counters of the fused pipeline."""
    batches: int = 0
    events: int = 0
    valid_events: int = 0
    invalid_events: int = 0
    wall_seconds: float = 0.0
    # Frames dispatched per host->device wire (word, bytes, seg, delta).
    wire_dwell: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Host wall seconds by run-loop stage (STAGES).
    stage_seconds: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(STAGES, 0.0))

    @property
    def events_per_second(self) -> float:
        return self.events / self.wall_seconds if self.wall_seconds else 0.0


class FusedPipeline:
    SUBSCRIPTION = "attendance_fused"
    _LUT_SIZE = 1 << 14  # covers ~44 years of calendar days from base

    def __init__(self, config: Optional[Config] = None, *,
                 num_banks: int = 256, device=None):
        self.config = config or Config()
        self.device = resolve_device(device)
        self.metrics = FusedMetrics()
        # Each pipeline owns an in-process broker; producers reach it
        # through ``self.client``.
        self.client = MemoryClient(MemoryBroker())
        self.consumer = self.client.subscribe(self.config.pulsar_topic,
                                              self.SUBSCRIPTION)
        self.store = ColumnarEventStore()
        # The fused packed step requires the blocked layout (one 512-bit
        # block per key).
        self.state, self.params = init_state(
            capacity=self.config.bloom_filter_capacity,
            error_rate=self.config.bloom_filter_error_rate,
            layout="blocked", num_banks=num_banks,
            precision=self.config.hll_precision, device=self.device)
        self._bank_dtype = bank_wire_dtype(num_banks)
        # Native host pack (one fused LUT-map + pack pass per frame), or
        # None with ATP_NATIVE=0; a failed build raises here.
        # _native_skip bypasses it for a while after a frame whose days
        # the dense LUT cannot cover (see _dispatch_single).
        self._native = load_native()
        self._native_skip = 0
        # Wire-selection state: the monotonic key-width hint (word and
        # seg wires), the delta-width hint with its outlier decay
        # (_decayed_db), and the auto ladder's level (0 word, 1 seg,
        # 2 delta) and backpressure score (_auto_wire), fed by
        # _drain_waited.
        self._kw_hint = 1
        self._db_hint = 1
        self._db_slack = 0
        self._db_seen = 1
        self._auto_level = 0
        self._auto_pressure = 0
        self._drain_waited = False
        # Bank allocation: days AND temporal buckets share one map and
        # one register tensor. The allocator is a monotonic counter plus
        # a free list: the temporal ring's evictions recycle bank rows.
        self._bank_of: Dict[int, int] = {}
        self._next_bank = 0
        self._free_banks: list = []
        # Dense day->bank lookup: days in [base, base + LUT) map with one
        # fancy-index instead of an np.unique per frame.
        self._day_base: Optional[int] = None
        self._day_lut = np.full(self._LUT_SIZE, -1, np.int32)
        # (message, completion event or None, pinned host buffers)
        self._inflight: deque = deque()
        # Pinned host buffers of the frame being dispatched.
        self._frame_pinned: list = []
        # Temporal sketch plane: windowed HLL bucket ring + watermarked
        # reorder + CMS fraud detector; one `is not None` branch per
        # frame when off.
        self._temporal: Optional[TemporalPlane] = None
        if self.config.temporal_period_s > 0:
            self._temporal = TemporalPlane(
                self.config, device=self.device,
                alloc_bank=self._register_temporal_bucket,
                free_buckets=self._free_temporal_buckets,
                mark_dirty=self._mark_temporal_dirty,
                dispatch_add=self._temporal_dispatch)

    # -- roster -------------------------------------------------------------
    def preload(self, keys) -> None:
        """Load the roster into the Bloom filter: one K3 launch."""
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        bloom_add_packed(self.state.bloom_bits,
                         torch.from_numpy(keys.view(np.int32)).to(
                             self.device),
                         self.params)
        if self._temporal is not None:
            # The window shadow classifies validity by roster membership.
            self._temporal.record_roster(keys)

    # -- bank mapping -------------------------------------------------------
    def _num_banks(self) -> int:
        return self.state.hll_regs.shape[0]

    def _grow_banks(self) -> None:
        regs = self.state.hll_regs
        grown = torch.zeros((regs.shape[0] * 2, regs.shape[1]),
                            dtype=regs.dtype, device=regs.device)
        grown[:regs.shape[0]] = regs
        self.state = self.state._replace(hll_regs=grown)
        self._bank_dtype = bank_wire_dtype(grown.shape[0])

    def _alloc_bank(self) -> int:
        """Next free HLL bank row: the free list (rows recycled by
        temporal-ring evictions, popped from its end) first, else the
        monotonic counter, growing the register tensor on demand."""
        if self._free_banks:
            return self._free_banks.pop()
        bank = self._next_bank
        while bank >= self._num_banks():
            self._grow_banks()  # double the bank array (rare)
        self._next_bank = bank + 1
        return bank

    def _register_day(self, day: int) -> int:
        bank = self._bank_of.get(day)
        if bank is not None:
            return bank
        bank = self._alloc_bank()
        self._bank_of[day] = bank
        if self._day_base is not None:
            off = day - self._day_base
            if 0 <= off < self._LUT_SIZE:
                self._day_lut[off] = bank
        return bank

    def _rebuild_lut(self, base: int) -> None:
        self._day_base = base
        self._day_lut.fill(-1)
        for day, bank in self._bank_of.items():
            off = day - base
            if 0 <= off < self._LUT_SIZE:
                self._day_lut[off] = bank

    def _banks_for(self, lecture_days: np.ndarray) -> np.ndarray:
        """Vectorized day->bank through the dense LUT; new or
        out-of-window days take the slow path, which registers them."""
        days_u32 = np.ascontiguousarray(lecture_days, dtype=np.uint32)
        if self._day_base is None:
            self._rebuild_lut(int(days_u32.min()))
        # uint32 wraparound keeps day<base negative after the int32
        # reinterpret (calendar deltas never approach 2^31).
        off = (days_u32 - np.uint32(self._day_base)).view(np.int32)
        mn, mx = int(off.min()), int(off.max())
        if 0 <= mn and mx < self._LUT_SIZE:
            banks = np.take(self._day_lut, off)
            if banks.min() >= 0:
                return banks
        return self._banks_for_slow(days_u32.astype(np.int64))

    def _banks_for_slow(self, days: np.ndarray) -> np.ndarray:
        if int(days.min()) < self._day_base:
            self._rebuild_lut(int(days.min()))
        off = days - self._day_base
        in_range = (off >= 0) & (off < self._LUT_SIZE)
        banks = np.where(in_range,
                         self._day_lut[np.where(in_range, off, 0)], -1)
        misses = banks < 0
        if misses.any():
            for day in np.unique(days[misses]).tolist():
                self._register_day(int(day))
            # re-resolve only the missed lanes
            moff = days[misses] - self._day_base
            mok = (moff >= 0) & (moff < self._LUT_SIZE)
            fixed = np.where(mok, self._day_lut[np.where(mok, moff, 0)], -1)
            still = fixed < 0
            if still.any():  # outside the LUT window: scalar map
                vals = days[misses][still]
                fixed[still] = [self._bank_of[int(d)]
                                for d in vals.tolist()]
            banks[misses] = fixed
        return banks.astype(np.int32, copy=False)

    # -- temporal plane hooks ------------------------------------------------
    def _register_temporal_bucket(self, key: int) -> int:
        """Allocate one bank row for a temporal bucket key (the ring's
        alloc callback), from the same allocator as days."""
        bank = self._alloc_bank()
        self._bank_of[key] = bank
        return bank

    def _free_temporal_buckets(self, keys, banks) -> None:
        """Evict rotated buckets (the ring's eviction callback): drop
        their keys from the bank map, zero their register rows and
        recycle the rows through the free list. The zeroing is one
        ``index_fill_``: a memset of whole rows, as the JAX scatter-set
        ``_t_clear`` was."""
        for key in keys:
            self._bank_of.pop(key, None)
        if not banks:
            return
        rows = torch.tensor(banks, dtype=torch.int64, device=self.device)
        self.state.hll_regs.index_fill_(0, rows, 0)
        self._free_banks.extend(int(b) for b in banks)

    def _mark_temporal_dirty(self, keys) -> None:
        """Dirty-bucket hook of the delta snapshot chain: a no-op, as
        the port has no snapshots yet."""

    def _temporal_dispatch(self, keys: np.ndarray,
                           banks: np.ndarray) -> None:
        """The window add into the SHARED register tensor: K4 probes the
        frame's keys against the filter, then K5 maxes the valid lanes
        into their bucket rows (bank -1 lanes drop). Launched on the
        current ``state.hll_regs`` after the frame's step, so it is
        acknowledged with the frame."""
        keys_t = self._to_device(
            np.ascontiguousarray(keys, np.uint32).view(np.int32))
        banks_t = self._to_device(np.ascontiguousarray(banks, np.int32))
        valid = bloom_contains_packed(self.state.bloom_bits, keys_t,
                                      self.params)
        hll_add(self.state.hll_regs, banks_t, keys_t, valid,
                self.config.hll_precision)

    def temporal_stats(self) -> Optional[Dict]:
        """The temporal plane's live counters (None when off)."""
        return (self._temporal.stats() if self._temporal is not None
                else None)

    def _live_regs(self) -> torch.Tensor:
        """The register rows a bank was ever allocated from (rows at or
        past ``_next_bank`` are never written): a contiguous slice, so a
        histogram of every live bank reads only these."""
        return self.state.hll_regs[:self._next_bank]

    def window_counts(self) -> Dict[int, int]:
        """PFCOUNT of every live temporal bucket from ONE histogram
        launch over the live rows: {bucket key: unique-valid-student
        estimate}."""
        keys = {k: b for k, b in self._bank_of.items() if is_bucket_key(k)}
        if not keys:
            return {}
        prec = self.config.hll_precision
        hists = best_histogram(self._live_regs(), prec).cpu().numpy()
        return {k: int(round(estimate_from_histogram(hists[b], prec)))
                for k, b in keys.items()}

    # -- hot loop -----------------------------------------------------------
    def _lap(self, stage: str, since: float) -> float:
        """Charge the time since ``since`` to ``stage``; returns now."""
        now = time.perf_counter()
        self.metrics.stage_seconds[stage] += now - since
        return now

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device; its pinned host copy (on the
        card) is kept with the frame until the frame's event completes."""
        tensor, pinned = to_device(arr, self.device)
        if pinned is not None:
            self._frame_pinned.append(pinned)
        return tensor

    def process_frame(self, data: bytes):
        """Dispatch one planar frame; returns (valid[:n] on the device, in
        packed order on the seg/delta wires, completion event or None,
        pinned host buffers of its copies)."""
        t = time.perf_counter()
        cols = decode_frame(data, include_truth=False)
        t = self._lap("decode", t)
        n = len(cols["student_id"])
        if n == 0:
            return None, None, []
        padded = 256
        while padded < n:
            padded *= 2
        valid, perm = self._dispatch_single(cols, padded)
        valid_n = valid[:n]
        # The seg/delta wires answer in bank-sorted order: the store keeps
        # rows in original order with a lazy view that scatters the
        # validity back when read.
        stored = valid_n if perm is None else _ScatterValidity(valid, perm,
                                                                n)
        if self._temporal is not None:
            # After the day map and the step, as in the JAX package: days
            # take their banks first, then new buckets take theirs.
            t = time.perf_counter()
            self._temporal.observe_frame(cols)
            self._lap("temporal", t)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        pinned, self._frame_pinned = self._frame_pinned, []
        t = time.perf_counter()
        self.store.insert_columns({**cols, "is_valid": stored})
        self._lap("store", t)
        self.metrics.batches += 1
        self.metrics.events += n
        return valid_n, done, pinned

    def _pick_kw(self, frame_bits: int, num_banks: int) -> int:
        """Key width of the word wire: the frame's own max-key bits
        widened to the monotonic hint, unless the hint no longer fits a
        word after bank growth while the frame's own width does."""
        kw = max(frame_bits, 1)
        hinted = max(kw, self._kw_hint)
        return hinted if hinted + num_banks.bit_length() <= 32 else kw

    def _rescan_width(self, nat, sid: np.ndarray, num_banks: int):
        """(frame key bits, word-wire width, word verdict) from the native
        max-key scan. A frame that outgrows the word wire folds its width
        into the hint, so the next frames go straight to the bytes wire
        instead of paying a doomed hinted pack each."""
        frame_bits = nat.max_key(sid).bit_length()
        kw = self._pick_kw(frame_bits, num_banks)
        use_words = kw + num_banks.bit_length() <= 32
        if not use_words:
            self._kw_hint = max(self._kw_hint, frame_bits)
        return frame_bits, kw, use_words

    def _decayed_db(self, width: int, needed: int) -> int:
        """Next delta-width hint after a frame packed at ``width`` whose
        own minimum was ``needed``: growth is immediate (``width`` has
        it); 16 frames in a row with >= 3 bits of slack drop the hint to
        the widest width those frames needed, so one outlier frame widens
        the wire once, not forever."""
        if needed <= width - 3:
            self._db_slack += 1
            self._db_seen = max(self._db_seen, needed)
            if self._db_slack >= 16:
                width = pick_delta_width(1, self._db_seen)
                self._db_slack, self._db_seen = 0, 1
        else:
            self._db_slack, self._db_seen = 0, 1
        return width

    _WIRE_LADDER = ("word", "seg", "delta")

    def _auto_wire(self) -> str:
        """The auto mode's wire for this frame, from backpressure: a hot
        loop that blocked on a full in-flight deque since the last frame
        (``_drain_waited``) means the card or the link is behind, so the
        ladder climbs to a narrower wire after 2 such signals; a deque of
        at most one frame means the host is behind, and 6 such signals
        step back down (asymmetric hysteresis). A mid-stream switch is
        safe: every frame is a self-contained dispatch. (The JAX package
        also freezes the level while checkpointing; the port has no
        checkpoints yet.)"""
        if self._drain_waited:
            self._auto_pressure = min(self._auto_pressure + 1, 8)
        elif len(self._inflight) <= 1:
            self._auto_pressure = max(self._auto_pressure - 1, -8)
        self._drain_waited = False
        if self._auto_pressure >= 2 and self._auto_level < 2:
            self._auto_level += 1
            self._auto_pressure = 0
        elif self._auto_pressure <= -6 and self._auto_level > 0:
            self._auto_level -= 1
            self._auto_pressure = 0
        return self._WIRE_LADDER[self._auto_level]

    def _count_wire(self, key: str) -> None:
        """One frame dispatched over ``key``: counted where the step is
        launched, so a fallback frame counts for the wire that carried
        it."""
        dwell = self.metrics.wire_dwell
        dwell[key] = dwell.get(key, 0) + 1

    def _lut_covers(self, day) -> bool:
        off = int(day) - self._day_base
        return 0 <= off < self._LUT_SIZE and self._day_lut[off] >= 0

    def _dispatch_single(self, cols: Dict[str, np.ndarray], padded: int):
        """Pack one frame's lanes and launch the fused step; returns
        (valid[padded], perm), perm the packed lane -> original index
        permutation of the seg/delta wires, None on the others.

        The wires, narrowest link to cheapest host pack: delta (db bits
        an event, sorted-key gaps per bank), seg (kb bits, the bank never
        crosses the link), word (4 bytes: the bank folded into the key's
        spare high bits) and bytes (4 + w bytes, when key and bank bits
        do not fit a word). ``auto`` climbs the word/seg/delta ladder on
        backpressure (:meth:`_auto_wire`), only with the native pack.

        With the native pack one call maps the days through the dense
        LUT and packs. On a LUT miss (a day with no bank yet) the days
        are registered once through the numpy map, and the native pack
        is retried only if the missed day landed in the LUT window; a day
        outside it (a hashed non-calendar lecture id) takes the numpy
        pack with the resolved banks, and the native pack is skipped for
        the next 32 frames. The protocol is the JAX package's, so the
        two number banks alike."""
        sid, days = cols["student_id"], cols["lecture_day"]
        num_banks = self._num_banks()
        nat = self._native
        banks = None
        if nat is not None and self._native_skip > 0:
            self._native_skip -= 1
            nat = None
        wire = self.config.wire_format
        if wire == "auto" and nat is not None:
            wire = self._auto_wire()
        if wire in ("seg", "delta"):
            valid, perm, banks = self._dispatch_narrow(
                cols, padded, nat, wire,
                forced=self.config.wire_format != "auto")
            if valid is not None:
                return valid, perm
            # Auto mode and no native seg/delta pack for this frame: the
            # wide wires carry it, reusing any banks already resolved.
            nat = None
            num_banks = self._num_banks()
        t = time.perf_counter()
        if nat is not None:
            if self._day_base is None:
                self._rebuild_lut(int(days.min()))
            # The width is the monotonic hint, trusted without a max-key
            # scan: the pack reports an overflow (-3), and only then is
            # the frame's width scanned and the pack retried.
            frame_bits = None
            for attempt in (0, 1):
                kw = (max(self._kw_hint, 1) if frame_bits is None
                      else self._pick_kw(frame_bits, num_banks))
                use_words = (kw + num_banks.bit_length() <= 32
                             and wire != "bytes")
                if not use_words and frame_bits is None and wire != "bytes":
                    # The hint outgrew a word; the frame's own width may
                    # still fit.
                    frame_bits, kw, use_words = self._rescan_width(
                        nat, sid, num_banks)
                if use_words:
                    buf, miss = nat.pack_words(sid, days, self._day_lut,
                                               self._day_base, kw, padded)
                    if miss == -3:
                        frame_bits, kw, use_words = self._rescan_width(
                            nat, sid, num_banks)
                        if use_words:
                            buf, miss = nat.pack_words(
                                sid, days, self._day_lut, self._day_base,
                                kw, padded)
                if not use_words:
                    buf, miss = nat.pack_bytes(
                        sid, days, self._day_lut, self._day_base,
                        np.dtype(self._bank_dtype).itemsize, padded)
                t = self._lap("pack", t)
                if miss == -1:
                    return self._launch_wide(buf, use_words, kw, t), None
                if attempt == 1:
                    # Missed again after registration: a day the LUT
                    # cannot cover.
                    self._native_skip = 32
                    break
                banks = self._banks_for(days)
                num_banks = self._num_banks()
                t = self._lap("bank_map", t)
                if not self._lut_covers(days[miss]):
                    self._native_skip = 32
                    break
        if banks is None:
            banks = self._banks_for(days)
            num_banks = self._num_banks()
            t = self._lap("bank_map", t)
        kw = self._pick_kw(int(sid.max()).bit_length(), num_banks)
        use_words = kw + num_banks.bit_length() <= 32 and wire != "bytes"
        buf = (pack_words(sid, banks, kw, padded) if use_words
               else pack_bytes(sid, banks, self._bank_dtype, padded))
        t = self._lap("pack", t)
        return self._launch_wide(buf, use_words, kw, t), None

    def _launch_wide(self, buf: np.ndarray, use_words: bool, kw: int,
                     t: float) -> torch.Tensor:
        """K2 over a packed word (``use_words``) or bytes buffer."""
        prec = self.config.hll_precision
        if use_words:
            self._kw_hint = kw
            self._count_wire("word")
            valid = fused_step_words(self.state,
                                     self._to_device(buf.view(np.int32)),
                                     self.params, kw, prec)
        else:
            self._count_wire("bytes")
            valid = fused_step_bytes(self.state, self._to_device(buf),
                                     self.params,
                                     np.dtype(self._bank_dtype).itemsize,
                                     prec)
        self._lap("dispatch", t)
        return valid

    def _dispatch_narrow(self, cols: Dict[str, np.ndarray], padded: int,
                         nat, mode: str, forced: bool):
        """The seg or delta wire (``mode``) for one frame: (valid, perm,
        None), or (None, None, banks or None) when auto mode should carry
        the frame on a wide wire instead (the native pass cannot run, or
        a day lies outside the LUT window); ``banks`` passes on any days
        already resolved. A forced wire falls back to the numpy pack of
        the same wire."""
        sid, days = cols["student_id"], cols["lecture_day"]
        num_banks = self._num_banks()
        banks = None
        t = time.perf_counter()
        if nat is not None:
            if self._day_base is None:
                self._rebuild_lut(int(days.min()))
            for attempt in (0, 1):
                if mode == "seg":
                    # The width hint again; the pack detects an overflow.
                    width = min(max(1, self._kw_hint), 32)
                    buf, perm, miss = nat.pack_seg(
                        sid, days, self._day_lut, self._day_base, width,
                        padded, num_banks)
                    if miss == -3:
                        width = min(max(nat.max_key(sid).bit_length(), 1,
                                        self._kw_hint), 32)
                        buf, perm, miss = nat.pack_seg(
                            sid, days, self._day_lut, self._day_base,
                            width, padded, num_banks)
                else:
                    buf, perm, width, needed, miss = nat.pack_delta(
                        sid, days, self._day_lut, self._day_base,
                        self._db_hint, padded, num_banks)
                t = self._lap("pack", t)
                if miss == -1:
                    if mode == "seg":
                        self._kw_hint = width
                    else:
                        self._db_hint = self._decayed_db(width, needed)
                    return (self._launch_narrow(mode, buf, width, padded,
                                                num_banks, t), perm, None)
                if miss == -2:  # scratch allocation, or too many banks
                    if not forced:
                        return None, None, banks
                    break
                if attempt == 1:
                    self._native_skip = 32
                    if not forced:
                        return None, None, banks
                    break
                banks = self._banks_for(days)
                num_banks = self._num_banks()
                t = self._lap("bank_map", t)
                if not self._lut_covers(days[miss]):
                    self._native_skip = 32
                    if not forced:
                        return None, None, banks
                    break
        # numpy pack: ATP_NATIVE=0, or a forced wire past the native pass.
        if banks is None:
            banks = self._banks_for(days)
            num_banks = self._num_banks()
            t = self._lap("bank_map", t)
        if mode == "seg":
            width = min(max(int(sid.max()).bit_length(), 1, self._kw_hint),
                        32)
            self._kw_hint = width
            buf, perm = pack_seg(sid, banks, width, padded, num_banks)
        else:
            scan = delta_scan(sid, banks, num_banks)
            width = pick_delta_width(self._db_hint, scan[-1])
            self._db_hint = self._decayed_db(width, scan[-1])
            buf, perm = pack_delta(sid, banks, width, padded, num_banks,
                                   scan=scan)
        t = self._lap("pack", t)
        return (self._launch_narrow(mode, buf, width, padded, num_banks, t),
                perm, None)

    def _launch_narrow(self, mode: str, buf: np.ndarray, width: int,
                       padded: int, num_banks: int, t: float
                       ) -> torch.Tensor:
        """K2-seg or K2-delta over a packed buffer."""
        self._count_wire(mode)
        step = fused_step_seg if mode == "seg" else fused_step_delta
        valid = step(self.state, self._to_device(buf.view(np.int32)),
                     self.params, width, padded, num_banks,
                     self.config.hll_precision)
        self._lap("dispatch", t)
        return valid

    # -- ack draining -------------------------------------------------------
    def _drain_inflight(self, block: int = 0) -> None:
        """Ack completed in-flight frames in dispatch order. ``block`` is
        how many not-yet-complete head entries to wait for (-1 = all)."""
        while self._inflight:
            msg, done, _pinned = self._inflight[0]
            if done is not None and not done.query():
                if block == 0:
                    break
                if block > 0:
                    # The hot loop stalls on a full deque: the card or
                    # the link is behind (_auto_wire's climb signal).
                    self._drain_waited = True
                t = time.perf_counter()
                done.synchronize()
                self._lap("ack_wait", t)
                if block > 0:
                    block -= 1
            self.consumer.acknowledge(msg)
            self._inflight.popleft()

    def run(self, max_events: Optional[int] = None,
            idle_timeout_s: float = 1.0) -> None:
        """Consume frames until ``max_events`` or an idle timeout; every
        consumed frame is acknowledged before this returns."""
        t_start = time.perf_counter()
        idle_since = time.monotonic()
        while True:
            t = time.perf_counter()
            try:
                msg = self.consumer.receive(timeout_millis=50)
            except ReceiveTimeout:
                t = self._lap("receive", t)
                if self._temporal is not None:
                    # Watermark idle advancement: a silent stream must
                    # not pin the reorder buffer or final buckets open.
                    self._temporal.maybe_idle_flush()
                    self._lap("temporal", t)
                self._drain_inflight(block=-1)
                if time.monotonic() - idle_since > idle_timeout_s:
                    break
                continue
            self._lap("receive", t)
            idle_since = time.monotonic()
            _valid, done, pinned = self.process_frame(msg.data())
            self._inflight.append((msg, done, pinned))
            self._drain_inflight(
                block=1 if len(self._inflight) >= _INFLIGHT_DEPTH else 0)
            if max_events is not None and self.metrics.events >= max_events:
                break
        if self._temporal is not None:
            # End of run: release the reorder buffer, rotate the final
            # buckets, fold the staged CMS estimates.
            t = time.perf_counter()
            self._temporal.flush()
            self._lap("temporal", t)
        self._drain_inflight(block=-1)
        self.metrics.wall_seconds = time.perf_counter() - t_start

    # -- queries ------------------------------------------------------------
    def lecture_days(self):
        """Sorted lecture days with an HLL bank (temporal bucket keys
        share the map but are served by :meth:`window_counts`)."""
        return sorted(d for d in self._bank_of if not is_bucket_key(d))

    def validity_counts(self) -> Tuple[int, int]:
        """(valid, invalid) totals accumulated on the device since
        construction (waits for the device)."""
        return decode_counts(self.state.counts)

    def estimated_fpr(self) -> float:
        """Occupancy-based FPR estimate of the roster filter: fill^k (a
        slight underestimate for the blocked layout)."""
        fill = float(bloom_packed_fill_fraction(self.state.bloom_bits))
        return fill ** self.params.k

    @staticmethod
    def _resolve_day(lecture) -> int:
        """An int day code, or a ``"LECTURE_YYYYMMDD"`` id."""
        if isinstance(lecture, str):
            return lecture_to_day(lecture)
        return int(lecture)

    def count(self, lecture_day) -> int:
        """PFCOUNT of one lecture day (0 for an unknown day)."""
        bank = self._bank_of.get(self._resolve_day(lecture_day))
        if bank is None:
            return 0
        prec = self.config.hll_precision
        hist = best_histogram(self.state.hll_regs[bank:bank + 1], prec)
        return int(round(estimate_from_histogram(hist.cpu().numpy()[0],
                                                 prec)))

    def count_all(self) -> Dict[int, int]:
        """PFCOUNT of every registered lecture day from ONE histogram
        launch over the live rows."""
        days = {d: b for d, b in self._bank_of.items()
                if not is_bucket_key(d)}
        if not days:
            return {}
        prec = self.config.hll_precision
        hists = best_histogram(self._live_regs(), prec).cpu().numpy()
        return {day: int(round(estimate_from_histogram(hists[bank], prec)))
                for day, bank in days.items()}

    def cleanup(self) -> None:
        self.client.close()
        self.store.close()
