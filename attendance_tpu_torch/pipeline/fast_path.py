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

Checkpoint/restore: with ``snapshot_dir`` set the pipeline restores the
chain on construction (:meth:`FusedPipeline.restore`) and checkpoints
every ``snapshot_every_batches`` frames. A checkpoint is an ack
BARRIER: frames are acknowledged only once a durable snapshot covers
them, so a crash loses nothing acknowledged and redelivers the rest.
The barrier captures the state on the compute stream (B9: the dirty
banks' rows in delta mode, every row in barrier mode, and the counters,
``models.fused.snapshot_capture_*``): since the steps update the state
in place, the capture is the consistent point, taken before the next
frame's step is enqueued. A background writer copies it to the host on
a side stream that waits on the capture's event, writes the files and
the fsync'd CHAIN.json whose rename is the durability point, then acks
the barrier's frames. The files are the JAX package's: each package
restores the other's chains. The counters are plain sums, not
idempotent, so a frame is acked only by the snapshot whose counters
include it; a failed write fails every job staged behind it and owes a
full base, which acks the failed jobs' frames once it is durable.

Ingress: one consumer (a JSON wire coalesces into chunks,
``lanes.JsonChunkConsumer``), or with ``ingress_lanes > 0`` the striped
lanes (``lanes.StripedConsumer``), whose acks route back to each frame's
lane; with ``ingress_wire="shm"`` the frames come from the shared-memory
ring (``transport.shm_ring``) and a frame borrowed from a slot is copied
out before anything keeps it. Serving: the writer's host register mirror
is published as read epochs (``serve.mirror``) at preload, restore and
every barrier, and with ``serve_port`` set an in-process query engine
answers over the binary RPC (``serve.rpc``) without touching the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from attendance_tpu_torch.config import Config
from attendance_tpu_torch.device import resolve_device, to_device
from attendance_tpu_torch.models.bloom import (
    bloom_add_packed, bloom_contains_packed, bloom_packed_fill_fraction)
from attendance_tpu_torch.models.fused import (
    bank_wire_dtype, decode_counts, delta_scan, fused_step_bytes,
    fused_step_delta, fused_step_seg, fused_step_words, init_state,
    pack_bytes, pack_delta, pack_seg, pack_words, pick_delta_width,
    snapshot_capture_base, snapshot_capture_rows, state_from_numpy)
from attendance_tpu_torch.models.hll import (
    best_histogram, estimate_from_histogram, hll_add)
from attendance_tpu_torch.native import load as load_native
from attendance_tpu_torch.pipeline.codec import decode_frame
from attendance_tpu_torch.pipeline.events import lecture_to_day
from attendance_tpu_torch.pipeline.lanes import (
    JsonChunkConsumer, StripedConsumer)
from attendance_tpu_torch.serve.engine import QueryEngine
from attendance_tpu_torch.serve.mirror import ReadMirror
from attendance_tpu_torch.serve.rpc import QueryServer
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore
from attendance_tpu_torch.temporal.buckets import is_bucket_key
from attendance_tpu_torch.temporal.plane import TemporalPlane
from attendance_tpu_torch.transport import (
    PoisonTracker, handle_poison, make_client)
from attendance_tpu_torch.transport.memory_broker import ReceiveTimeout
from attendance_tpu_torch.utils.integrity import (
    ChainIntegrityError, file_digest, quarantine_artifact,
    structural_npz_check, verify_file)
from attendance_tpu_torch.utils.snapshot import (
    fsync_write_npz, write_manifest_atomic)

logger = logging.getLogger(__name__)

_INFLIGHT_DEPTH = 8  # dispatched-but-unacked frames before blocking
DEFAULT_SNAPSHOT_EVERY = 64  # barrier cadence when only snapshot_dir is set
SKETCH_SNAPSHOT = "fused_sketch.npz"
EVENTS_SNAPSHOT = "fused_events.npz"  # the JAX package's legacy name
EVENTS_SEGMENTS = "fused_events_segs"
CHAIN_MANIFEST = "CHAIN.json"  # fsync'd base+delta chain manifest
_SNAP_QUEUE_DEPTH = 2  # staged delta captures in flight (double buffer)
# Host stages of the run loop, in frame order. The native host pack fuses
# the day map with the pack in one call, charged to "pack"; "bank_map" is
# the numpy day map (ATP_NATIVE=0, days the dense LUT cannot cover) and
# the registration of days a native pack missed. "dispatch" is the H2D
# copy enqueue plus the kernel launch, "temporal" the temporal plane's
# host passes and launches (0 when the plane is off), "ack_wait" the time
# blocked on the card.
STAGES = ("receive", "decode", "bank_map", "pack", "dispatch", "temporal",
          "store", "ack_wait")


class PoisonFrame(ValueError):
    """A frame that failed to decode (the run loop's poison path)."""


def _verify_npz_structure(path, orig_exc) -> None:
    """Full structural read of an npz (every entry through its zip
    CRC): what tells a stale recorded digest (the benign crash window)
    from real storage rot. Re-raises the original classified error when
    the file does not parse clean."""
    if structural_npz_check(path) is not None:
        raise orig_exc from None


def read_chain_state(snap_dir, *, expect_m_bits: Optional[int] = None,
                     expect_precision: Optional[int] = None,
                     stop_before: Optional[str] = None) -> dict:
    """Merge-on-read over a snapshot directory: the base npz plus every
    CHAIN.json-listed delta, applied in order (the JAX package's
    ``read_chain_state``, without its verified-digest cache).

    Every observable state is self-consistent under the chain's write
    protocol (delta files are fsync'd before the manifest names them; a
    full base resets the manifest BEFORE deleting superseded deltas).
    Every file with a recorded digest is verified before it is trusted;
    failures raise a classified :class:`ChainIntegrityError`
    (``digest_mismatch`` / ``missing`` / ``torn_manifest`` /
    ``unreadable``), the input to restore's repair ladder.
    ``stop_before`` truncates the applied chain just before the named
    delta. Raises FileNotFoundError when no base snapshot exists, and
    ValueError on a geometry mismatch or a bank map inconsistent with
    the registers."""
    snap_dir = Path(snap_dir)
    path = snap_dir / SKETCH_SNAPSHOT
    if not path.exists():
        if (snap_dir / CHAIN_MANIFEST).exists():
            # A manifest with no base is corruption, not a directory
            # that was never checkpointed.
            raise ChainIntegrityError(
                "missing", path,
                "chain manifest exists but the base snapshot is absent")
        raise FileNotFoundError(f"no base snapshot at {path}")
    chain: list = []
    chain_digests: dict = {}
    base_digest = ""
    chain_path = snap_dir / CHAIN_MANIFEST
    if chain_path.exists():
        try:
            chain_doc = json.loads(chain_path.read_text())
        except ValueError as exc:  # torn JSON or non-UTF8 bytes
            raise ChainIntegrityError("torn_manifest", chain_path,
                                      str(exc)) from exc
        chain = list(chain_doc.get("deltas", []))
        chain_digests = dict(chain_doc.get("digests", {}))
        base_digest = chain_doc.get("base_digest", "")
    if base_digest:
        try:
            verify_file(path, base_digest)
        except ChainIntegrityError as exc:
            if exc.kind != "digest_mismatch":
                raise
            # The one legitimate mismatch: a crash between the base's
            # in-place replace and the manifest reset leaves CHAIN.json
            # naming the OLD base's digest. A base that parses clean
            # is that window, not rot: record the digest of the base on
            # disk (the chain_seq fence below skips the stale deltas).
            _verify_npz_structure(path, exc)
            base_digest = file_digest(path)
            logger.warning(
                "base snapshot digest differs from CHAIN.json but the "
                "file verifies structurally: treating as the "
                "crash-before-manifest-reset window, not rot")
    try:
        base_npz = np.load(path)
    except Exception as exc:  # noqa: BLE001 — classify, never opaque
        raise ChainIntegrityError(
            "unreadable", path, f"{type(exc).__name__}: {exc}") from exc
    with base_npz as data:
        try:
            manifest = json.loads(bytes(data["manifest"]).decode())
            bits = np.array(data["bloom_words"])
            regs = np.array(data["hll_regs"], dtype=np.uint8)
            counts = np.array(data["counts"] if "counts" in data
                              else np.zeros((2, 2), np.uint32))
        except Exception as exc:  # noqa: BLE001
            raise ChainIntegrityError(
                "unreadable", path, f"{type(exc).__name__}: {exc}") from exc
        if (expect_m_bits is not None
                and manifest["m_bits"] != expect_m_bits):
            raise ValueError(
                f"snapshot filter is {manifest['m_bits']} bits but "
                f"config derives {expect_m_bits} — capacity/"
                "error-rate/layout changed since the snapshot")
        if (expect_precision is not None
                and manifest["precision"] != expect_precision):
            raise ValueError(
                f"snapshot HLL precision is {manifest['precision']} "
                f"but config requests {expect_precision} — "
                "register banks are not convertible across precisions")
    bank_of_raw = manifest["bank_of"]
    events = manifest["events"]
    # Staleness fence: deltas numbered <= the base's chain_seq are older
    # than the base (the crash window between a base replace and the
    # manifest reset) and are skipped before verification.
    base_seq = int(manifest.get("chain_seq", -1))
    applied: list = []
    for name in chain:
        if name == stop_before:
            break  # repair truncation: the chain is good up to here
        dpath = snap_dir / name
        if int(name.split("-")[1].split(".")[0]) <= base_seq:
            continue
        if name in chain_digests:
            verify_file(dpath, chain_digests[name])
        elif not dpath.exists():
            raise ChainIntegrityError(
                "missing", dpath,
                f"chain manifest names {name} but the delta file is "
                "absent — snapshot directory is corrupt")
        try:
            delta_npz = np.load(dpath)
        except FileNotFoundError as exc:
            raise ChainIntegrityError(
                "missing", dpath,
                "vanished between manifest read and open") from exc
        except Exception as exc:  # noqa: BLE001
            raise ChainIntegrityError(
                "unreadable", dpath,
                f"{type(exc).__name__}: {exc}") from exc
        with delta_npz as d:
            try:
                dman = json.loads(bytes(d["manifest"]).decode())
                d_idx = np.asarray(d["bank_idx"], np.int64)
                d_rows = np.asarray(d["regs_rows"])
                d_counts = np.array(d["counts"], np.uint32)
            except Exception as exc:  # noqa: BLE001
                raise ChainIntegrityError(
                    "unreadable", dpath,
                    f"{type(exc).__name__}: {exc}") from exc
            nb = int(dman.get("num_banks", regs.shape[0]))
            if nb > regs.shape[0]:
                grown = np.zeros((nb, regs.shape[1]), np.uint8)
                grown[:regs.shape[0]] = regs
                regs = grown
            if len(d_idx):
                if int(d_idx.max()) >= regs.shape[0]:
                    raise ValueError(
                        f"delta {name} writes bank {int(d_idx.max())} "
                        f"but the chain only restored {regs.shape[0]} "
                        "banks — chain is corrupt")
                regs[d_idx] = d_rows
            counts = d_counts
            bank_of_raw = dman["bank_of"]
            events = dman["events"]
        applied.append(name)
    # The bank map must fit the register banks it routes into: a stale
    # or hand-edited manifest would silently misroute every PFADD.
    bank_vals = [int(b) for b in bank_of_raw.values()]
    if bank_vals:
        if len(set(bank_vals)) != len(bank_vals):
            raise ValueError("snapshot manifest maps two days to one HLL "
                             "bank — manifest is corrupt")
        if max(bank_vals) >= regs.shape[0]:
            raise ValueError(
                f"snapshot manifest references bank {max(bank_vals)} but "
                f"only {regs.shape[0]} register banks were restored — "
                "manifest and registers are from different snapshots")
    return dict(bits=bits, regs=regs, counts=counts, bank_of=bank_of_raw,
                events=events, applied=applied, manifest=manifest,
                base_digest=base_digest,
                digests={n: chain_digests[n] for n in applied
                         if n in chain_digests})


class _StaleBaseError(RuntimeError):
    """A staged delta with no durable base under it (an earlier write
    failed): bookkeeping only, no disk was touched, so it does not
    extend the writer's backoff."""



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
    # Host wall seconds in process_frame (decode to store append).
    device_seconds: float = 0.0
    # Checkpointing: wall seconds of each background snapshot write, and
    # how long the hot loop was blocked waiting on a busy writer.
    snapshot_stalls: List[float] = dataclasses.field(default_factory=list)
    snapshot_blocked_s: float = 0.0
    # Poison frames: nacks for redelivery, and frames dead-lettered
    # (acked after max_redeliveries failed decodes).
    nacked_batches: int = 0
    dead_lettered: int = 0

    @property
    def events_per_second(self) -> float:
        return self.events / self.wall_seconds if self.wall_seconds else 0.0

    def summary(self, estimated_fpr: Optional[float] = None,
                include_validity: bool = True,
                fpr_is_lower_bound: bool = False) -> str:
        """One metrics line, the text of the JAX package's
        ``ProcessorMetrics.summary``. ``fpr_is_lower_bound`` prints the
        estimate as ">=" (the blocked layout's occupancy formula
        understates its FPR)."""
        mean_batch = self.events / self.batches if self.batches else 0.0
        bound = ">= " if fpr_is_lower_bound else ""
        fpr = ("n/a" if estimated_fpr is None
               else f"{bound}{estimated_fpr:.4%}")
        validity = (f"{self.valid_events} valid, "
                    f"{self.invalid_events} invalid"
                    if include_validity
                    else "validity in store (async)")
        wires = ("" if not self.wire_dwell else "; wires " + ",".join(
            f"{k}:{v}" for k, v in sorted(self.wire_dwell.items())))
        rate = (f"{self.events_per_second:.0f}"
                if self.wall_seconds else "n/a")
        return (f"{self.events} events in {self.batches} batches "
                f"({rate} ev/s; mean batch "
                f"{mean_batch:.0f}; device {self.device_seconds:.3f}s; "
                f"est. bloom FPR {fpr}; {validity}, "
                f"{self.nacked_batches} nacked, {self.dead_lettered} "
                f"dead-lettered{wires})")


class FusedPipeline:
    SUBSCRIPTION = "attendance_fused"
    _LUT_SIZE = 1 << 14  # covers ~44 years of calendar days from base

    def __init__(self, config: Optional[Config] = None, *, client=None,
                 num_banks: int = 256, device=None):
        self.config = config or Config()
        self.device = resolve_device(device)
        self.metrics = FusedMetrics()
        # The broker client: config.transport_backend's (the process's
        # shared memory broker, or a socket broker) unless one is passed
        # (a successor pipeline after a crash shares the dead one's);
        # producers reach it through ``self.client``.
        self.client = client or make_client(self.config)
        if self.config.ingress_lanes > 0:
            # Striped ingress: N lane sessions decoding off this thread
            # behind the one-consumer call shape; acks, the writer's
            # group commits included, route back to each owning lane.
            # On the shm wire each lane maps its own ring file.
            self.consumer = StripedConsumer(
                self.config, self.client, self.config.pulsar_topic,
                self.SUBSCRIPTION)
        else:
            self.consumer = self.client.subscribe(self.config.pulsar_topic,
                                                  self.SUBSCRIPTION)
            if self.config.ingress_wire != "shm":
                # Per-event JSON coalesces into one decode and one
                # dispatch a chunk; bulk frames pass through untouched.
                # (A ring slot always holds a planar frame already.)
                self.consumer = JsonChunkConsumer(
                    self.consumer, self.config, metrics=self.metrics)
        # Poison retries bounded by the frame's own failure count.
        self._poison = PoisonTracker()
        # The chunk consumer's JSON decode seconds already charged to the
        # decode stage (run() moves them out of the receive stage).
        self._chunk_decode_s = 0.0
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
        # Checkpoint chain (snapshot_dir "" = off). A set dir with no
        # cadence still checkpoints, at the default one.
        self._snap_dir = (Path(self.config.snapshot_dir)
                          if self.config.snapshot_dir else None)
        self._snap_every = (self.config.snapshot_every_batches
                            if self.config.snapshot_every_batches > 0
                            else DEFAULT_SNAPSHOT_EVERY)
        self._batches_at_snap = 0
        # Host copy of the filter for the snapshot path: the run loop
        # never writes the filter, so one read after the preload serves
        # every later snapshot.
        self._bloom_host: Optional[np.ndarray] = None
        self._snap_mode = self.config.snapshot_mode
        self._snap_compact_every = self.config.snapshot_compact_every
        # Delta mode: lecture days (and temporal bucket keys) touched
        # since the last barrier, resolved to dirty banks at it.
        self._snap_dirty = (self._snap_dir is not None
                            and self._snap_mode == "delta")
        self._dirty_days: set = set()
        self._base_stale = True     # no durable base for this run yet
        self._writer_base_ok = False
        # Chain bookkeeping, owned by the writer thread (and by
        # snapshot()/restore(), which run with no write in flight).
        self._snap_chain: list = []  # delta files since the base
        self._delta_seq = 0
        self._integrity = self.config.integrity
        self._snap_digests: Dict[str, str] = {}  # delta name -> sha256
        self._base_digest = ""
        # The writer's host copy of the registers: what a compaction
        # folds into a new base with no device read.
        self._regs_mirror: Optional[np.ndarray] = None
        self._events_restored = 0
        # The background writer: one thread draining staged captures in
        # barrier order. Frames of a failed job wait in _snap_unacked
        # for the next durable base, whose counters include them.
        self._snap_jobs: deque = deque()
        self._snap_cv = threading.Condition()
        self._snap_pending = 0
        self._snap_unacked: list = []
        self._snap_fail_streak = 0
        self._snap_thread: Optional[threading.Thread] = None
        self._snap_io_lock = threading.Lock()
        # On the card: the writer's side stream for the captures' D2H,
        # and its pinned staging buffer (one: the writer drains one job
        # at a time), grown to the largest capture on first need.
        self._snap_stream = None
        self._staging: Optional[torch.Tensor] = None
        # Temporal sketch plane: windowed HLL bucket ring + watermarked
        # reorder + CMS fraud detector; one `is not None` branch per
        # frame when off. Built before restore(), which re-seeds it.
        self._temporal: Optional[TemporalPlane] = None
        if self.config.temporal_period_s > 0:
            self._temporal = TemporalPlane(
                self.config, device=self.device,
                alloc_bank=self._register_temporal_bucket,
                free_buckets=self._free_temporal_buckets,
                mark_dirty=self._mark_temporal_dirty,
                dispatch_add=self._temporal_dispatch)
        # The epoch-pinned read mirror (serve/): host register state
        # published as immutable epochs at preload, restore and every
        # snapshot barrier, from copies the writer already holds, so the
        # query plane never reads the card mid-run.
        self.read_mirror = ReadMirror()
        self._roster_size = 0
        self.query_engine: Optional[QueryEngine] = None
        self.query_server: Optional[QueryServer] = None
        if self._snap_dir is not None:
            self.restore()
        if self.config.serve_port:
            # The in-process query plane: host numpy over the mirror's
            # pinned epoch behind a binary batch RPC port.
            self.query_engine = QueryEngine(
                self.read_mirror, batch_max=self.config.query_batch_max,
                staleness_ceiling_s=(
                    self.config.read_staleness_ceiling_s or None))
            port = self.config.serve_port
            self.query_server = QueryServer(
                self.query_engine, port=0 if port < 0 else port).start()

    # -- roster -------------------------------------------------------------
    def preload(self, keys) -> None:
        """Load the roster into the Bloom filter: one K3 launch."""
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        bloom_add_packed(self.state.bloom_bits,
                         torch.from_numpy(keys.view(np.int32)).to(
                             self.device),
                         self.params)
        # The filter changed: no base on disk covers it, so the next
        # barrier writes a full base before deltas (which never carry
        # the filter) may chain on.
        self._base_stale = True
        self._bloom_host = None
        if self._temporal is not None:
            # The window shadow classifies validity by roster membership.
            self._temporal.record_roster(keys)
        self._roster_size = len(keys)
        if self.checkpointing or self.query_engine is not None:
            # The snapshot path's host filter and the first read epoch,
            # read here, before the run, where the wait costs least.
            self.publish_epoch()

    @property
    def _events_total(self) -> int:
        """Events including a restored chain's total: what every durable
        manifest stamps (``metrics.events`` restarts at 0 on restore)."""
        return self._events_restored + self.metrics.events

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
            self._dirty_days.discard(key)
        if not banks:
            return
        rows = torch.tensor(banks, dtype=torch.int64, device=self.device)
        self.state.hll_regs.index_fill_(0, rows, 0)
        self._free_banks.extend(int(b) for b in banks)

    def _mark_temporal_dirty(self, keys) -> None:
        """Dirty-bucket hook of the delta chain: buckets a frame touched
        are captured at the next barrier, as days are."""
        if self._snap_dirty:
            self._dirty_days.update(keys)

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
        """Dispatch one frame of any wire ``codec.decode_frame`` takes;
        returns (valid[:n] on the device, in packed order on the seg/delta
        wires, completion event or None, pinned host buffers of its
        copies). A frame that does not decode raises :class:`PoisonFrame`
        before any state changes."""
        t0 = t = time.perf_counter()
        if isinstance(data, memoryview):
            # A frame borrowed from a shm ring slot: the slot is recycled
            # once the frame is acked, while the store (and the temporal
            # plane's reorder buffer) keep its columns past that, so it
            # is copied out of the mapping first.
            data = bytes(data)
        try:
            cols = decode_frame(data, include_truth=False)
        except Exception as exc:
            raise PoisonFrame(f"undecodable frame: {exc!r}") from exc
        t = self._lap("decode", t)
        n = len(cols["student_id"])
        if n == 0:
            return None, None, []
        if self._snap_dirty:
            # Delta checkpointing: the lecture days this frame touches,
            # seen before the dispatch (native packs never materialize
            # a host bank array).
            self._note_dirty(cols["lecture_day"])
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
        t = self._lap("store", t)
        self.metrics.batches += 1
        self.metrics.events += n
        self.metrics.device_seconds += t - t0
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
        safe: every frame is a self-contained dispatch. Checkpointing
        holds frames until barriers, so the deque's depth stops meaning
        backpressure: the level freezes there."""
        if self.checkpointing:
            return self._WIRE_LADDER[self._auto_level]
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

    # -- checkpoint: barriers and the background writer ---------------------
    @property
    def checkpointing(self) -> bool:
        return self._snap_dir is not None

    def _record_event(self) -> Optional["torch.cuda.Event"]:
        """An event recorded now on the compute stream (None on the CPU,
        where every call has completed when it returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _note_dirty(self, days: np.ndarray) -> None:
        """Record the lecture days one frame touches: a min/max pair in
        the dense LUT window (one bincount over the offsets when the
        frame spans several days), else an np.unique."""
        days_u32 = np.ascontiguousarray(days, dtype=np.uint32)
        base = self._day_base
        if base is not None:
            off = (days_u32 - np.uint32(base)).view(np.int32)
            mn, mx = int(off.min()), int(off.max())
            if 0 <= mn and mx < self._LUT_SIZE:
                if mn == mx:
                    self._dirty_days.add(mn + base)
                else:
                    seen = np.bincount(off - mn, minlength=1)
                    self._dirty_days.update(
                        (np.nonzero(seen)[0] + (mn + base)).tolist())
                return
        self._dirty_days.update(
            np.unique(days_u32.astype(np.int64)).tolist())

    def _drain_dirty_banks(self) -> np.ndarray:
        """Swap out the dirty set and resolve it to sorted bank indices
        (a key with no bank, e.g. an evicted bucket, is not dirty)."""
        days, self._dirty_days = self._dirty_days, set()
        return np.asarray(sorted(self._bank_of[d] for d in days
                                 if d in self._bank_of), dtype=np.int64)

    @staticmethod
    def _pad_bank_index(banks: np.ndarray) -> np.ndarray:
        """Dirty-bank indices padded to a power of two (min 8), pad rows
        gathering bank 0 (sliced off on the host): the JAX capture's
        shapes, so a capture moves the same bytes in both packages."""
        padded = 8
        while padded < len(banks):
            padded *= 2
        idx = np.zeros(padded, np.int64)
        idx[:len(banks)] = banks
        return idx

    def _checkpoint_async(self, force: bool) -> None:
        """A barrier (the BGSAVE analogue): capture a consistent point on
        the compute stream and hand it to the background writer, which
        acks the captured frames once they are durable.

        Delta mode captures the rows of the banks dirtied since the last
        barrier (B9), barrier mode (or a base owed) every row; both copy
        the counters. The capture is enqueued after every step of the
        frames it covers and before the next frame's, and an event
        recorded after it tells the writer's side stream when it is
        complete. Up to _SNAP_QUEUE_DEPTH captures may be staged in
        delta mode, one in barrier mode; past that a barrier is deferred
        unless ``force`` (the in-flight bound), which waits for a slot
        and charges the wait to ``metrics.snapshot_blocked_s``."""
        depth = _SNAP_QUEUE_DEPTH if self._snap_mode == "delta" else 1
        if self._snap_pending >= depth:
            if not force:
                return  # defer: re-checked on a later frame
            self._wait_snap_slots(depth - 1)
        if self._bloom_host is None:
            self._bloom_host = self.state.bloom_bits.cpu().numpy().view(
                np.uint32)
        pinned = [p for _, _, ps in self._inflight for p in ps]
        if self._snap_mode == "delta" and not self._base_stale:
            banks = self._drain_dirty_banks()
            idx, idx_pinned = to_device(self._pad_bank_index(banks),
                                        self.device)
            if idx_pinned is not None:
                pinned.append(idx_pinned)
            rows, counts = snapshot_capture_rows(self.state.hll_regs, idx,
                                                 self.state.counts)
            job = dict(kind="delta", banks=banks, regs=rows,
                       counts=counts, num_banks=self._num_banks())
        else:
            regs, counts = snapshot_capture_base(self.state.hll_regs,
                                                 self.state.counts)
            # The base covers every bank: the dirty set and the chain
            # restart from it (a failed write flips _base_stale back).
            self._dirty_days.clear()
            self._base_stale = False
            job = dict(kind="base", regs=regs, counts=counts,
                       bloom=self._bloom_host)
        job.update(ready=self._record_event(), upto=self.store.mark(),
                   msgs=[m for m, _, _ in self._inflight], pinned=pinned,
                   events=self._events_total, bank_of=dict(self._bank_of))
        self._inflight.clear()
        self._batches_at_snap = self.metrics.batches
        self._enqueue_snap(job)

    def _checkpoint_and_ack(self) -> None:
        """A barrier that waits until its snapshot is durable and its
        frames acked (idle receive, end of run)."""
        self._checkpoint_async(force=True)
        self._flush_snapshots()

    def _flush_snapshots(self) -> None:
        """Wait out every staged snapshot write."""
        self._wait_snap_slots(0)

    def _wait_snap_slots(self, below: int) -> None:
        """Block until at most ``below`` staged writes remain, charging
        the wait to ``metrics.snapshot_blocked_s``."""
        with self._snap_cv:
            if self._snap_pending <= below:
                return
            t0 = time.perf_counter()
            while self._snap_pending > below:
                self._snap_cv.wait()
            blocked = time.perf_counter() - t0
        self.metrics.snapshot_blocked_s += blocked

    def _enqueue_snap(self, job: dict) -> None:
        with self._snap_cv:
            if self._snap_thread is None or not self._snap_thread.is_alive():
                self._snap_thread = threading.Thread(
                    target=FusedPipeline._snap_writer_main,
                    args=(weakref.ref(self), self._snap_cv,
                          self._snap_jobs),
                    name="snapshot-writer", daemon=True)
                self._snap_thread.start()
            self._snap_jobs.append(job)
            self._snap_pending += 1
            self._snap_cv.notify_all()

    def _stop_snap_writer(self) -> None:
        """Shut the writer down (cleanup): a sentinel after the queue,
        then join."""
        with self._snap_cv:
            t = self._snap_thread
            if t is None or not t.is_alive():
                return
            self._snap_jobs.append(None)
            self._snap_cv.notify_all()
        t.join(timeout=10.0)
        self._snap_thread = None

    @staticmethod
    def _snap_writer_main(pipe_ref, cv, jobs) -> None:
        """The writer thread: drains staged captures in barrier order and
        makes each durable (D2H, files, manifest rename), then acks its
        frames as one group commit. It holds only a weak reference to
        the pipeline between jobs, so a pipeline dropped without
        cleanup() is still collected, and the thread then exits."""
        while True:
            with cv:
                while not jobs:
                    if pipe_ref() is None:
                        return
                    cv.wait(timeout=1.0)
                job = jobs.popleft()
            if job is None:
                return  # cleanup sentinel
            pipe = pipe_ref()
            if pipe is None:
                return  # frames stay unacked; the process is ending
            backoff = pipe._writer_backoff_s()
            if backoff and (job["kind"] == "base" or pipe._writer_base_ok):
                # Bounded backoff between attempts after failures; a delta
                # staged behind a failed write skips it (it fails the
                # no-durable-base guard without touching the disk).
                time.sleep(backoff)
            pipe._run_snap_job_logged(job)
            del job, pipe

    def _writer_backoff_s(self) -> float:
        """0 while healthy, exponential from 50 ms after consecutive
        failures, capped at 5 s."""
        streak = self._snap_fail_streak
        if streak <= 0:
            return 0.0
        return min(0.05 * 2 ** min(streak - 1, 7), 5.0)

    def _snap_stream_ctx(self, job: dict):
        """The context a job's device reads run in: on the card, the
        writer's side stream (device set first, on this thread), made
        to wait on the capture's event, so the copies see the captured
        point and the compute stream never waits for them."""
        if job["ready"] is None:
            return contextlib.nullcontext()
        torch.cuda.set_device(self.device)
        if self._snap_stream is None:
            self._snap_stream = torch.cuda.Stream(self.device)
        self._snap_stream.wait_event(job["ready"])
        return torch.cuda.stream(self._snap_stream)

    def _capture_to_host(self, job: dict
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(uint8 register rows, uint32[2, 2] counters) of a capture on
        the host. On the card: a non-blocking copy on the side stream
        into the writer's pinned staging buffer, waited for with the
        copy's own event (never a device-wide synchronize). The capture
        tensors stay referenced by the job until the copy completed, so
        the caching allocator cannot hand their memory to a frame."""
        regs, counts = job["regs"], job["counts"]
        if regs.device.type != "cuda":
            return regs.numpy(), counts.numpy().view(np.uint32)
        n = regs.numel()
        slot = self._staging
        if slot is None or slot.numel() < n + 16:
            slot = torch.empty(n + 16, dtype=torch.uint8, pin_memory=True)
            self._staging = slot
        slot[:n].view(regs.shape).copy_(regs, non_blocking=True)
        slot[n:n + 16].view(torch.int32).copy_(counts.view(-1),
                                               non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        done.synchronize()
        # Counters are copied off the buffer; the rows are a view of it,
        # read by this job only (the writer runs one job at a time).
        return (slot[:n].numpy().reshape(tuple(regs.shape)),
                slot[n:n + 16].numpy().view(np.uint32).reshape(2, 2).copy())

    def _run_snap_job_logged(self, job: dict) -> None:
        t0 = time.perf_counter()
        try:
            with self._snap_stream_ctx(job):
                self._run_snap_job(job)
            self._ack(job["msgs"])
            if job["kind"] == "base":
                self._ack_unacked()
            self._snap_fail_streak = 0
        except Exception as exc:
            # Every job staged behind a failure fails too (no delta
            # chains onto a chain missing a write) and the next barrier
            # writes a full base, which acks these frames as well: its
            # counters include them, so a crash before it redelivers
            # them onto a chain whose counters do not.
            self._base_stale = True
            self._writer_base_ok = False
            with self._snap_cv:
                self._snap_unacked.extend(job["msgs"])
            disk_full = (isinstance(exc, OSError)
                         and exc.errno == errno.ENOSPC)
            if disk_full:
                self._snap_fail_streak = max(self._snap_fail_streak + 1, 8)
                logger.error(
                    "Snapshot disk is FULL (ENOSPC): frames stay unacked, "
                    "writer retries every %.1fs until space frees",
                    self._writer_backoff_s())
            else:
                if not isinstance(exc, _StaleBaseError):
                    self._snap_fail_streak += 1
                logger.exception(
                    "Background snapshot failed (consecutive failures: "
                    "%d, next attempt in %.2fs)", self._snap_fail_streak,
                    self._writer_backoff_s())
        finally:
            self.metrics.snapshot_stalls.append(time.perf_counter() - t0)
            with self._snap_cv:
                self._snap_pending -= 1
                self._snap_cv.notify_all()

    def _ack(self, msgs) -> None:
        for msg in msgs:
            self.consumer.acknowledge(msg)

    def _ack_unacked(self) -> None:
        """A durable full base covers every frame before its capture:
        ack the frames of the jobs that failed before it."""
        with self._snap_cv:
            msgs, self._snap_unacked = self._snap_unacked, []
        self._ack(msgs)

    def _run_snap_job(self, job: dict) -> None:
        if job["kind"] == "base":
            regs_h, counts_h = self._capture_to_host(job)
            with self._snap_io_lock:
                self._write_snapshot_files(
                    job["bloom"], regs_h, counts_h, job["bank_of"],
                    job["events"], job["upto"])
            self._regs_mirror = np.array(regs_h, dtype=np.uint8, copy=True)
            self._publish_epoch(self._regs_mirror, counts_h,
                                bank_of=job["bank_of"], events=job["events"])
            self._writer_base_ok = True
            return
        if not self._writer_base_ok:
            raise _StaleBaseError(
                "delta capture with no durable base (an earlier write "
                "failed); frames stay unacked and the next barrier "
                "writes a full base")
        banks = job["banks"]
        rows_h, counts_h = self._capture_to_host(job)
        rows_h = rows_h[:len(banks)]
        with self._snap_io_lock:
            nbytes = self._write_delta_files(
                banks, rows_h, counts_h, job["bank_of"], job["events"],
                job["num_banks"], job["upto"])
        self._post_delta_bookkeeping(banks, rows_h, nbytes, counts_h,
                                     job["bank_of"], job["events"],
                                     job["num_banks"], job["upto"])

    def snapshot(self) -> None:
        """Write a full base snapshot now, synchronously, after any
        staged write (the run loop's barriers use the writer)."""
        if self._snap_dir is None:
            return
        self._flush_snapshots()
        if self._bloom_host is None:
            self._bloom_host = self.state.bloom_bits.cpu().numpy().view(
                np.uint32)
        bits = self._bloom_host
        regs = self.state.hll_regs.cpu().numpy()
        counts = self.state.counts.cpu().numpy().view(np.uint32)
        self._dirty_days.clear()
        self._regs_mirror = np.array(regs, dtype=np.uint8, copy=True)
        self._publish_epoch(self._regs_mirror, counts,
                            bank_of=dict(self._bank_of))
        with self._snap_io_lock:
            self._write_snapshot_files(bits, regs, counts,
                                       dict(self._bank_of),
                                       self._events_total, upto=None)
        # Only after the write: a raise above leaves the base owed.
        self._base_stale = False
        self._writer_base_ok = True
        self._batches_at_snap = self.metrics.batches
        self._ack_unacked()

    def _write_snapshot_files(self, bits, regs, counts, bank_of: dict,
                              events: int, upto) -> None:
        """The file half of a base snapshot (caller holds _snap_io_lock):
        event segments, the sketch npz (fsync'd, atomic rename), then the
        chain manifest reset and the superseded deltas' deletion."""
        self._snap_dir.mkdir(parents=True, exist_ok=True)
        manifest = {
            "bank_of": {str(d): b for d, b in bank_of.items()},
            "m_bits": self.params.m_bits,
            "k": self.params.k,
            "precision": self.config.hll_precision,
            "events": events,
            # Staleness fence: deltas numbered <= this are older than
            # this base (see read_chain_state).
            "chain_seq": self._delta_seq,
        }
        # Event segments first: a crash between the two writes leaves
        # extra rows of unacked frames, which the replay's dedup folds.
        self.store.save_segments(self._snap_dir / EVENTS_SEGMENTS,
                                 upto=upto)
        path = self._snap_dir / SKETCH_SNAPSHOT
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, bloom_words=bits, hll_regs=regs, counts=counts,
                     manifest=np.frombuffer(
                         json.dumps(manifest).encode(), dtype=np.uint8))
            # fsync before the rename: the manifest reset below unlinks
            # the deltas this base supersedes.
            f.flush()
            os.fsync(f.fileno())
        self._base_digest = file_digest(tmp) if self._integrity else ""
        tmp.replace(path)
        # A full base supersedes the delta chain: reset the manifest
        # FIRST, then delete the superseded files.
        old = list(self._snap_chain)
        self._snap_chain = []
        self._snap_digests = {}
        self._write_chain_manifest()
        for name in old:
            try:
                (self._snap_dir / name).unlink()
            except OSError:
                pass

    def _write_chain_manifest(self) -> None:
        """Publish the base+delta chain atomically (caller holds
        _snap_io_lock): the rename is the snapshot's durability point; a
        delta file a crash orphaned before it is ignored on restore."""
        doc = {"base": SKETCH_SNAPSHOT, "deltas": list(self._snap_chain)}
        if self._integrity:
            doc["base_digest"] = self._base_digest
            doc["digests"] = {n: self._snap_digests[n]
                              for n in self._snap_chain
                              if n in self._snap_digests}
        write_manifest_atomic(self._snap_dir, doc, CHAIN_MANIFEST)

    def _write_delta_files(self, banks: np.ndarray, rows: np.ndarray,
                           counts, bank_of: dict, events: int,
                           num_banks: int, upto) -> int:
        """The file half of one delta (caller holds _snap_io_lock): event
        segments, the fsync'd delta npz, then the manifest rename that
        makes it part of the chain. Returns the delta file's size."""
        self._snap_dir.mkdir(parents=True, exist_ok=True)
        self.store.save_segments(self._snap_dir / EVENTS_SEGMENTS,
                                 upto=upto)
        manifest = {"bank_of": {str(d): b for d, b in bank_of.items()},
                    "events": events, "num_banks": num_banks}
        self._delta_seq += 1
        name = f"delta-{self._delta_seq:04d}.npz"
        path = self._snap_dir / name
        digest = fsync_write_npz(path, dict(
            bank_idx=np.asarray(banks, np.int32),
            regs_rows=np.asarray(rows, np.uint8),
            counts=np.asarray(counts, np.uint32),
            manifest=np.frombuffer(json.dumps(manifest).encode(),
                                   dtype=np.uint8)))
        if self._integrity:
            self._snap_digests[name] = digest
        self._snap_chain.append(name)
        self._write_chain_manifest()
        return path.stat().st_size

    def _post_delta_bookkeeping(self, banks, rows, nbytes: int, counts,
                                bank_of: dict, events: int,
                                num_banks: int, upto: int) -> None:
        """After a durable delta: fold its rows into the host mirror,
        publish the mirror as the next read epoch and, at the compaction
        cadence, fold the chain into a fresh base. (The JAX package also
        gossips the delta here; the port has no federation yet.)"""
        mirror = self._regs_mirror
        if mirror is not None:
            if num_banks > mirror.shape[0]:
                grown = np.zeros((num_banks, mirror.shape[1]), np.uint8)
                grown[:mirror.shape[0]] = mirror
                self._regs_mirror = mirror = grown
            if len(banks):
                mirror[np.asarray(banks, np.int64)] = rows
            # The mirror now holds this delta: the atomic swap readers
            # pin against.
            self._publish_epoch(mirror, counts, bank_of=bank_of,
                                events=events)
        if len(self._snap_chain) >= self._snap_compact_every:
            self._compact_chain(counts, bank_of, events, upto)

    def _compact_chain(self, counts_h, bank_of: dict, events: int,
                       upto: int) -> None:
        """Fold the delta chain into a full base from the host mirror (no
        device read), in the writer, and merge the event segments. The
        base persists the store's blocks up to the delta's own ``upto``
        and no further: the side stream is ordered after that barrier's
        capture only, so a later block's validity may still be being
        written by a step on the compute stream."""
        if self._regs_mirror is None or self._bloom_host is None:
            return
        with self._snap_io_lock:
            self._write_snapshot_files(self._bloom_host, self._regs_mirror,
                                       counts_h, bank_of, events, upto)
            # This thread is the only save_segments caller here.
            self.store.compact_segments(self._snap_dir / EVENTS_SEGMENTS)

    # -- read epochs (serve/) --------------------------------------------------
    def _publish_epoch(self, regs_h: np.ndarray, counts_h, *,
                       bank_of: dict, events: Optional[int] = None) -> None:
        """Publish one read epoch from host state: the registers, bank
        map and counters of one moment (cold paths and the snapshot
        writer only, never the hot loop)."""
        self.read_mirror.publish(
            regs=regs_h,
            events=self._events_total if events is None else events,
            bank_of=bank_of, params=self.params,
            precision=self.config.hll_precision,
            bloom_words=self._bloom_host,
            counts=None if counts_h is None else np.asarray(counts_h),
            roster_size=self._roster_size)

    def publish_epoch(self) -> None:
        """Publish one epoch from the card's CURRENT state, after the
        staged snapshot writes: the one device read of the query plane,
        for embedders that serve without checkpointing. A cold path:
        call it between runs, never mid-stream."""
        self._flush_snapshots()
        if self._bloom_host is None:
            self._bloom_host = self.state.bloom_bits.cpu().numpy().view(
                np.uint32)
        self._publish_epoch(self.state.hll_regs.cpu().numpy(),
                            self.state.counts.cpu().numpy().view(np.uint32),
                            bank_of=dict(self._bank_of))

    # -- restore ---------------------------------------------------------------
    def restore(self) -> bool:
        """Load the chain in snapshot_dir, if there is one: the base plus
        every delta CHAIN.json names (:func:`read_chain_state`), then the
        event segments. Delta files the manifest does not name are crash
        orphans and are ignored; their frames were never acked. A corrupt
        chain is repaired (:meth:`_repair_chain`)."""
        if self._snap_dir is None:
            return False
        repaired = False
        try:
            chain_state = read_chain_state(
                self._snap_dir, expect_m_bits=self.params.m_bits,
                expect_precision=self.config.hll_precision)
        except FileNotFoundError:
            return False
        except ChainIntegrityError as exc:
            chain_state = self._repair_chain(exc)
            if chain_state is None:
                return False
            repaired = True
        regs = chain_state["regs"]
        bank_of_raw = chain_state["bank_of"]
        events = chain_state["events"]
        applied = chain_state["applied"]
        # The allocator: holes left by temporal-ring evictions become the
        # free list, and their rows are ZEROED (the chain still holds an
        # evicted bucket's registers: its live zeroing was never
        # captured), or a key reallocated into a hole would max onto
        # stale registers.
        used = set(int(b) for b in bank_of_raw.values())
        next_bank = (max(used) + 1) if used else 0
        free_banks = sorted(set(range(next_bank)) - used)
        if free_banks:
            regs = np.array(regs, dtype=np.uint8)
            regs[np.asarray(free_banks, np.int64)] = 0
        self.state = state_from_numpy(chain_state["bits"], regs,
                                      chain_state["counts"], self.device)
        # The chain may hold more banks than this construction (growth
        # before the crash): the wire's bank dtype follows the restored
        # count.
        self._bank_dtype = bank_wire_dtype(regs.shape[0])
        self._bank_of = {int(d): b for d, b in bank_of_raw.items()}
        self._next_bank = next_bank
        self._free_banks = free_banks
        if self._temporal is not None:
            self._temporal.restore(self._bank_of)
        self._day_base = None
        self._day_lut.fill(-1)
        self._bloom_host = np.asarray(chain_state["bits"], np.uint32)
        # Resume the chain where the manifest left it (stale entries
        # dropped); the delta sequence skips past orphaned files.
        self._snap_chain = applied
        self._snap_digests = dict(chain_state["digests"])
        self._base_digest = chain_state["base_digest"]
        self._dirty_days.clear()
        self._regs_mirror = np.array(regs, dtype=np.uint8, copy=True)
        self._publish_epoch(self._regs_mirror, chain_state["counts"],
                            bank_of=self._bank_of, events=events)
        self._events_restored = int(events)
        if repaired:
            # Name only the survivors (unless the base itself was lost)
            # and owe a fresh base.
            if (self._snap_dir / SKETCH_SNAPSHOT).exists():
                with self._snap_io_lock:
                    self._write_chain_manifest()
            self._base_stale = True
            self._writer_base_ok = False
        else:
            self._base_stale = False
            self._writer_base_ok = True
        # Number the next delta past every file on disk AND past the
        # base's fence: a compaction deleted the deltas it folded, and a
        # delta numbered at or below the base's chain_seq would be
        # skipped as stale on the next restore (the JAX package numbers
        # from the files alone).
        self._delta_seq = max(
            max((int(p.stem.split("-")[1])
                 for p in self._snap_dir.glob("delta-*.npz")), default=0),
            int(chain_state["manifest"].get("chain_seq", 0)))
        segs_dir = self._snap_dir / EVENTS_SEGMENTS
        if segs_dir.is_dir():
            self._load_event_segments(segs_dir)
        if repaired:
            # A fresh full base from the repaired state supersedes the
            # truncated chain now; a failed write leaves the base owed.
            try:
                self.snapshot()
            except Exception:
                logger.exception("fresh-base write after chain repair "
                                 "failed; the next barrier retries")
                self._base_stale = True
                self._writer_base_ok = False
        logger.info("Restored snapshot: %d events (%d deltas), %d HLL "
                    "banks%s", events, len(applied), len(self._bank_of),
                    " [REPAIRED]" if repaired else "")
        return True

    def _load_event_segments(self, segs_dir) -> None:
        """Load the event segments, compacting them first; a segment that
        fails the structural check is quarantined (its rows are lost
        locally, loudly) and the load retried over the survivors."""
        for attempt in range(2):
            self.store.truncate()
            try:
                if attempt == 0:
                    self.store.compact_segments(segs_dir)
                self.store.load_segments(segs_dir)
                return
            except Exception as exc:  # noqa: BLE001 — classify rot
                bad = [p for p in sorted(Path(segs_dir).glob(
                    "segment-*.npz")) if structural_npz_check(p) is not None]
                if not bad or attempt:
                    raise
                logger.error(
                    "event segment(s) %s failed structural verification "
                    "(%s: %s) — quarantining; their rows are lost locally",
                    [p.name for p in bad], type(exc).__name__, exc)
                for p in bad:
                    quarantine_artifact(
                        p, reason="unreadable",
                        detail="event segment failed the zip-CRC "
                               "structural check")

    def _repair_chain(self, exc: ChainIntegrityError) -> Optional[dict]:
        """The repair ladder for a corrupt chain: quarantine the corrupt
        artifact and re-read the chain truncated to its good prefix (a
        torn CHAIN.json degrades to the base alone; a corrupt base
        leaves nothing); restore then owes a fresh base. Returns a
        ``read_chain_state`` dict, or None when nothing is recoverable.
        (The JAX ladder's peer re-assert step needs federation, which
        the port has not yet.)"""
        state = None
        for _attempt in range(4):
            path = exc.path
            logger.error("snapshot chain at %s is corrupt (%s at %s)%s — "
                         "quarantining and repairing", self._snap_dir,
                         exc.kind, path.name,
                         f": {exc.detail}" if exc.detail else "")
            quarantine_artifact(path, reason=exc.kind, detail=exc.detail,
                                expected_digest=exc.expected)
            if path.name == SKETCH_SNAPSHOT:
                break  # the base is lost: nothing to restore locally
            stop = None if path.name == CHAIN_MANIFEST else path.name
            try:
                state = read_chain_state(
                    self._snap_dir, expect_m_bits=self.params.m_bits,
                    expect_precision=self.config.hll_precision,
                    stop_before=stop)
                break
            except ChainIntegrityError as exc2:
                exc = exc2
            except FileNotFoundError:
                break
        if state is not None and self._integrity \
                and not state["base_digest"]:
            # A torn manifest took the digests with it; the base parsed
            # clean, so record its digest for the republished manifest.
            state["base_digest"] = file_digest(
                self._snap_dir / SKETCH_SNAPSHOT)
        if state is not None:
            logger.warning(
                "chain repaired LOCALLY: state truncated at the corrupt "
                "artifact — events acked into the lost suffix are not "
                "locally recoverable")
        else:
            logger.error(
                "chain at %s is unrepairable locally (base corrupt) — "
                "starting EMPTY; the corrupt bytes are preserved under "
                "integrity-quarantine/", self._snap_dir)
        return state

    # -- ack draining -------------------------------------------------------
    def _drain_inflight(self, block: int = 0) -> None:
        """Ack completed in-flight frames in dispatch order. ``block`` is
        how many not-yet-complete head entries to wait for (-1 = all).
        With checkpointing on, frames are acked only by the barriers'
        durable snapshots."""
        if self.checkpointing:
            return
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
        consumed frame is acknowledged (with checkpointing: is durable)
        before this returns, unless its snapshot write failed."""
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
                if self.checkpointing and self._inflight:
                    self._checkpoint_and_ack()
                self._drain_inflight(block=-1)
                if time.monotonic() - idle_since > idle_timeout_s:
                    break
                continue
            self._lap("receive", t)
            chunk_s = (self.consumer.decode_seconds
                       if isinstance(self.consumer, JsonChunkConsumer)
                       else 0.0)
            if chunk_s != self._chunk_decode_s:
                # The chunk consumer's JSON decode ran inside receive.
                moved = chunk_s - self._chunk_decode_s
                self._chunk_decode_s = chunk_s
                self.metrics.stage_seconds["receive"] -= moved
                self.metrics.stage_seconds["decode"] += moved
            idle_since = time.monotonic()
            try:
                _valid, done, pinned = self.process_frame(msg.data())
            except PoisonFrame:
                # Bounded retry, then dead-letter: a frame nacked
                # forever livelocks the subscription. Only a failed
                # decode is poison: a device fault raises.
                logger.exception("Bad frame")
                handle_poison(msg, self.consumer, self.metrics,
                              self.config, logger, tracker=self._poison)
                continue
            self._inflight.append((msg, done, pinned))
            if self.checkpointing:
                # A barrier on the frame cadence, and on the in-flight
                # depth (which bounds the frames' pinned buffers).
                depth_forced = (len(self._inflight)
                                >= max(_INFLIGHT_DEPTH, self._snap_every))
                if (self.metrics.batches - self._batches_at_snap
                        >= self._snap_every or depth_forced):
                    self._checkpoint_async(force=depth_forced)
            else:
                self._drain_inflight(
                    block=1 if len(self._inflight) >= _INFLIGHT_DEPTH
                    else 0)
            if max_events is not None and self.metrics.events >= max_events:
                break
        if self._temporal is not None:
            # End of run: release the reorder buffer, rotate the final
            # buckets, fold the staged CMS estimates (before the final
            # barrier).
            t = time.perf_counter()
            self._temporal.flush()
            self._lap("temporal", t)
        if self.checkpointing:
            if self._inflight or self._snap_unacked:
                self._checkpoint_and_ack()
            else:
                self._flush_snapshots()
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

    def get_attendance_stats(self, lecture_day) -> Dict:
        """PFCOUNT and partition scan of one lecture day (an int day or a
        ``"LECTURE_YYYYMMDD"`` id): the reference's stats query."""
        day = self._resolve_day(lecture_day)
        records = self.store.scan_lecture(day)
        return {"unique_attendees": self.count(day),
                "attendance_records": records,
                "num_records": len(records["student_id"])}

    def cleanup(self) -> None:
        if self.query_server is not None:
            self.query_server.stop()
        # Wait out the staged snapshot writes (their acks go through the
        # consumer), then stop the writer.
        self._flush_snapshots()
        self._stop_snap_writer()
        if isinstance(self.consumer, StripedConsumer):
            # Stop the lane threads (which send the queued acks) and
            # close their sessions before the client goes.
            self.consumer.close()
        self.client.close()
        self.store.close()
