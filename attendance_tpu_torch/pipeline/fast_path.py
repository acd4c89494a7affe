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

Mesh: with ``num_shards * num_replicas > 1`` the sketch state lives in a
``parallel.ShardedSketchEngine`` over a (dp, sp) grid of devices (the
process's CUDA devices, dp spanning the processes of a torchrun group,
unless a ``mesh`` is passed). A frame goes through the numpy day map
onto the word wire (or, when key and bank bits do not fit a word, as
key and bank arrays), or onto the seg or delta wire with one packed
buffer a replica (forced, or picked by the ``auto`` ladder). The mesh's
barriers run on the hot loop's thread, as JAX's do: its
state reads are collectives on a multi-process mesh, where only process
0 writes files and gossips.

Telemetry (``obs/``, on when a telemetry flag is set): per-stage latency
histograms (dequeue_wait, decode, dispatch, device_wait, snapshot_write,
snapshot_blocked), the host gap between consecutive dispatches, the
dispatch thread's busy fractions, events, frames and wire frames, the
bytes each frame's wire carries to the card, per-batch spans under the
trace the producer started, and one flight record a frame. Every hook
reads host clocks only: ``device_wait`` times the wait on a frame's own
completion event at its drain, which the run loop makes anyway.

Attribution (``obs/profiler.py``): with ``--profile-hz`` the hot loop
marks its stage (dequeue, decode, dispatch, temporal, device_wait; the
writer thread snapshot) at the transitions the stage histograms time,
for the host sampler; every dispatch site reports the JAX package's
``fn`` name and shape fingerprint to the launch-shape tracker (always on
with telemetry), which turns warm after the first completed run. With
``--profile-dir`` each run is a ``torch.profiler`` trace
(``utils/profiling.py``), the single-card dispatch a
``fused_step_dispatch`` range, the mesh's ``sharded_fused_step`` or
``sharded_narrow_step``, and a traced batch a ``trace:<id>`` range.

Federation: with ``fed_worker`` set the pipeline is one shard's worker
(``federation/``). A full merge frame (the Bloom words and every bank)
goes to the gossip topic at preload, restore and every base snapshot,
and every durable delta is gossiped as the same dirty-bank rows the
writer just made durable, with no new device read. A corrupt chain's
repair asks the aggregator to re-assert this worker's retained
contribution before falling back to the local repair.

Faults (``chaos/``, on with ``config.chaos``): the injector is installed
before the transport and the store, whose seams take it. The store is
wrapped by ``storage.wrap_store`` (``persist_fail``; the circuit breaker
and its spill with ``persist_spill_dir``). The writer rolls
``writer_stall`` and ``snap_fail`` at ``snapshot.writer``, and the base
write carries the ``disk.chain`` hooks (ENOSPC before, rot after the
publish). A persist failure that reaches the run loop (no spill dir) is
handled as JAX handles it: the frame is nacked, then dead-lettered
after ``max_redeliveries``.

Control (``control/``, on with ``config.control_log``): the telemetry
bundle's controller binds its knobs here at construction. They are
plain attributes the run loop reads: ``_audit_every`` (the audit shadow
records every Nth frame by ``metrics.batches``), ``_snap_every``,
``_temporal_paused`` (no K4/K5 window add and no K6 step is enqueued for
a paused frame) and the ingress admission valve at the run loop's edge:
``spill`` writes the frame durably and acks it, ``shed`` nacks it. A
spilled frame drains through :meth:`FusedPipeline.process_frame` once
admission reopens (one K2 step each) and at the end of the run, and its
file is deleted only once a durable snapshot covers it: by the writer
thread after the write that holds the drained frames' results, not at
the capture.
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
import torch.distributed as dist

from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.chaos import ChaosFault, PersistFault
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.control.engine import IngressAdmission
from attendance_tpu_torch.device import resolve_device, to_device
from attendance_tpu_torch.federation.gossip import FenceGossip
from attendance_tpu_torch.federation.merge import encode_counts
from attendance_tpu_torch.models.bloom import (
    bloom_add_packed, bloom_contains_packed, bloom_or_words_np,
    bloom_packed_fill_fraction)
from attendance_tpu_torch.models.fused import (
    bank_wire_dtype, decode_counts, delta_scan, fused_step_bytes,
    fused_step_delta, fused_step_seg, fused_step_words, init_state,
    pack_bytes, pack_delta, pack_seg, pack_words, padded_lanes,
    pick_delta_width,
    snapshot_capture_base, snapshot_capture_rows, state_from_numpy)
from attendance_tpu_torch.models.hll import (
    best_histogram, estimate_from_histogram, hll_add)
from attendance_tpu_torch.native import load as load_native
from attendance_tpu_torch.parallel.multihost import (
    init_distributed, make_multihost_mesh)
from attendance_tpu_torch.parallel.sharded import ShardedSketchEngine
from attendance_tpu_torch.pipeline.codec import decode_frame
from attendance_tpu_torch.pipeline.events import lecture_to_day
from attendance_tpu_torch.pipeline.lanes import (
    JsonChunkConsumer, StripedConsumer)
from attendance_tpu_torch.obs import health
from attendance_tpu_torch.obs.audit import register_fused_audit
from attendance_tpu_torch.serve import http as serve_http
from attendance_tpu_torch.serve.engine import QueryEngine
from attendance_tpu_torch.serve.mirror import ReadMirror
from attendance_tpu_torch.serve.rpc import QueryServer
from attendance_tpu_torch.storage import wrap_store
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore
from attendance_tpu_torch.temporal.buckets import is_bucket_key
from attendance_tpu_torch.temporal.plane import TemporalPlane
from attendance_tpu_torch.transport import (
    PoisonTracker, acknowledge_all, handle_poison, make_client,
    redelivery_count)
from attendance_tpu_torch.transport.memory_broker import ReceiveTimeout
from attendance_tpu_torch.utils.integrity import (
    ChainIntegrityError, chaos_post_publish, chaos_pre_write, file_digest,
    quarantine_artifact, structural_npz_check, verify_file)
from attendance_tpu_torch.utils.profiling import (
    annotate_trace, maybe_annotate, maybe_trace)
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
    waits on the card nor scatters.

    One card's pack puts all n real lanes first (``lanes=None``); a
    mesh's per-replica packs leave them at the front of each replica's
    slice, so the mesh passes their positions ``lanes`` (len n, aligned
    with ``perm``)."""

    __slots__ = ("_valid", "_perm", "_n", "_lanes")

    def __init__(self, valid: torch.Tensor, perm: np.ndarray, n: int,
                 lanes: Optional[np.ndarray] = None):
        self._valid, self._perm, self._n = valid, perm, n
        self._lanes = lanes

    def __len__(self) -> int:
        return self._n

    def __array__(self, dtype=None, copy=None):
        if self._lanes is None:
            v = self._valid[:self._n].cpu().numpy()
        else:
            v = self._valid.cpu().numpy()[self._lanes]
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
    # Host wall seconds of the restore on construction (chain read,
    # repair, the state's copy to the device), 0 without a chain.
    restore_seconds: float = 0.0

    @property
    def events_per_second(self) -> float:
        return self.events / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def mean_batch(self) -> float:
        """Events a frame: every counted frame adds its events and one
        batch, so this is the mean of the per-frame sizes."""
        return self.events / self.batches if self.batches else 0.0

    def to_dict(self, estimated_fpr: Optional[float] = None,
                fpr_is_lower_bound: bool = False) -> Dict:
        """The metrics line as one flat JSON-serializable dict, for the
        JSON-lines sink (``config.metrics_json``): the JAX package's
        ``ProcessorMetrics.to_dict`` keys, order and rounding. The
        port's ``stage_seconds`` and ``restore_seconds`` stay out."""
        return {
            "events": self.events,
            "batches": self.batches,
            # null, not 0.0, when no wall clock was measured: a zero
            # rate reads as a dead run.
            "events_per_second": round(self.events_per_second, 1)
            if self.wall_seconds else None,
            "mean_batch": round(self.mean_batch, 1),
            "device_seconds": round(self.device_seconds, 6),
            "wall_seconds": round(self.wall_seconds, 6),
            "valid_events": self.valid_events,
            "invalid_events": self.invalid_events,
            "nacked_batches": self.nacked_batches,
            "dead_lettered": self.dead_lettered,
            "estimated_fpr": estimated_fpr,
            "fpr_is_lower_bound": fpr_is_lower_bound,
            "wire_dwell": dict(self.wire_dwell),
            "snapshots": len(self.snapshot_stalls),
            "snapshot_write_s": round(sum(self.snapshot_stalls), 4),
            "snapshot_blocked_s": round(self.snapshot_blocked_s, 4),
        }

    def write_json_line(self, path: str, **to_dict_kwargs) -> None:
        """Append one JSON metrics line (:meth:`to_dict`) to ``path``."""
        with open(path, "a") as f:
            f.write(json.dumps(self.to_dict(**to_dict_kwargs)) + "\n")

    def summary(self, estimated_fpr: Optional[float] = None,
                include_validity: bool = True,
                fpr_is_lower_bound: bool = False) -> str:
        """One metrics line, the text of the JAX package's
        ``ProcessorMetrics.summary``. ``fpr_is_lower_bound`` prints the
        estimate as ">=" (the blocked layout's occupancy formula
        understates its FPR)."""
        mean_batch = self.mean_batch
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
    _TRACE_ROLE = "fused-pipeline"

    def __init__(self, config: Optional[Config] = None, *, client=None,
                 num_banks: int = 256, device=None, mesh=None):
        self.config = config or Config()
        # Live telemetry: created here iff a telemetry flag is set,
        # BEFORE the engine and the transport below so the mesh and the
        # broker queues register their gauges. With the flags unset
        # every hook in this class is one `is not None` branch and every
        # handle below is None.
        self._obs = obs.ensure(self.config)
        self._tracer = (self._obs.tracer if self._obs is not None
                        else None)
        self._h_dequeue = self._h_decode = self._h_dispatch = None
        self._h_device = self._h_snap_write = self._h_snap_blocked = None
        self._h_gap = None
        self._busy: Optional[Dict[str, float]] = None
        self._c_xfer: Optional[dict] = None
        self._last_wire = ""
        # Attribution plane: the launch-shape tracker and the sampling
        # profiler's stage marks, one `is not None` branch each when off;
        # the torch.profiler ranges only with --profile-dir.
        self._recomp = (self._obs.recompiles if self._obs is not None
                        else None)
        prof = self._obs.profiler if self._obs is not None else None
        self._stage_mark = prof.stages if prof is not None else None
        self._profiling = bool(self.config.profile_dir)
        if self._obs is not None:
            self._init_telemetry()
        # A mesh (num_shards * num_replicas > 1): the sketch state lives
        # in a ShardedSketchEngine over a (dp, sp) grid of devices (the
        # process's CUDA devices, over the processes of a torchrun group,
        # unless ``mesh`` is given); ``device`` is then its first cell's.
        self.engine: Optional[ShardedSketchEngine] = None
        if self.config.num_shards * self.config.num_replicas > 1:
            self.engine = self._make_engine(mesh, num_banks)
            self.device = self.engine.device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"cell {self.device}")
        else:
            self.device = resolve_device(device)
        # On a multi-process mesh every process holds the same state and
        # runs the same barriers; only process 0 writes files and
        # gossips.
        self._primary = (self.engine is None
                         or not self.engine.mesh.multiprocess
                         or dist.get_rank() == 0)
        self.metrics = FusedMetrics()
        # The fault plane before the transport and the store, whose seams
        # take it; None (the default) keeps every hook at one branch.
        self._chaos = chaos.ensure(self.config)
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
                self.SUBSCRIPTION, obs=self._obs)
        else:
            self.consumer = self.client.subscribe(self.config.pulsar_topic,
                                                  self.SUBSCRIPTION)
            if (self.config.ingress_wire != "shm"
                    and hasattr(self.consumer, "receive_many_raw")):
                # Per-event JSON coalesces into one decode and one
                # dispatch a chunk; bulk frames pass through untouched.
                # (A ring slot always holds a planar frame already.) A
                # consumer without the raw lane (pulsar-client's) serves
                # the run loop message by message.
                self.consumer = JsonChunkConsumer(
                    self.consumer, self.config, obs=self._obs,
                    metrics=self.metrics)
        # Poison retries bounded by the frame's own failure count.
        self._poison = PoisonTracker()
        # The chunk consumer's JSON decode seconds already charged to the
        # decode stage (run() moves them out of the receive stage).
        self._chunk_decode_s = 0.0
        self.store = wrap_store(ColumnarEventStore(), self.config,
                                sink="columnar")
        # The fused packed step requires the blocked layout (one 512-bit
        # block per key).
        if self.engine is None:
            self.state, self.params = init_state(
                capacity=self.config.bloom_filter_capacity,
                error_rate=self.config.bloom_filter_error_rate,
                layout="blocked", num_banks=num_banks,
                precision=self.config.hll_precision, device=self.device)
        else:
            self.state, self.params = None, self.engine.params
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
        self._warned_word_degrade = False
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
        # Drained spill files of failed jobs, retired with their frames.
        self._snap_unretired: list = []
        self._snap_fail_streak = 0
        self._snap_thread: Optional[threading.Thread] = None
        self._snap_io_lock = threading.Lock()
        # On the card: the writer's side stream for the captures' D2H,
        # and its pinned staging buffer (one: the writer drains one job
        # at a time), grown to the largest capture on first need.
        self._snap_stream = None
        self._staging: Optional[torch.Tensor] = None
        self._g_delta_bytes = self._g_chain_len = None
        if self._obs is not None and self._snap_dir is not None:
            self._g_delta_bytes = self._obs.registry.gauge(
                "attendance_snapshot_delta_bytes",
                help="Bytes of the last incremental snapshot delta")
            self._g_chain_len = self._obs.registry.gauge(
                "attendance_snapshot_chain_length",
                help="Delta files since the last full base snapshot")
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
                dispatch_add=self._temporal_dispatch, obs=self._obs)
        # The epoch-pinned read mirror (serve/): host register state
        # published as immutable epochs at preload, restore and every
        # snapshot barrier, from copies the writer already holds, so the
        # query plane never reads the card mid-run.
        self.read_mirror = ReadMirror()
        self._roster_size = 0
        self.query_engine: Optional[QueryEngine] = None
        self.query_server: Optional[QueryServer] = None
        if self._obs is not None:
            self.read_mirror.register_gauges(self._obs)
        # The accuracy auditor, taken from the telemetry bundle after
        # restore() (whose epoch carries no audit truth, as in JAX).
        self._auditor = None
        # Fence gossip of a federated worker, built before restore() so a
        # takeover's restored chain reaches the aggregator at once.
        self._fed: Optional[FenceGossip] = None
        if self.config.fed_worker and self._primary:
            self._fed = FenceGossip(
                self.config, client=self.client, m_bits=self.params.m_bits,
                k=self.params.k, obs=self._obs).start_heartbeat()
        if self._snap_dir is not None:
            t = time.perf_counter()
            self.restore()
            self.metrics.restore_seconds = time.perf_counter() - t
        if self._obs is not None:
            # The hot loop only RECORDS sampled shadow truth (one
            # vectorized hash and a small set update a frame); the
            # sketch-health and measured-accuracy gauges are scrape-time
            # callbacks that read the filter and registers then.
            self._auditor = self._obs.auditor
            health.register_fused(self._obs, self)
            if self._auditor is not None:
                register_fused_audit(self._obs, self)
        if self.config.serve_port:
            # The in-process query plane: host numpy over the mirror's
            # pinned epoch behind a binary batch RPC port.
            self.query_engine = QueryEngine(
                self.read_mirror, obs=self._obs,
                batch_max=self.config.query_batch_max,
                staleness_ceiling_s=(
                    self.config.read_staleness_ceiling_s or None))
            port = self.config.serve_port
            self.query_server = QueryServer(
                self.query_engine, port=0 if port < 0 else port).start()
            if self._obs is not None and self._obs._server is not None:
                # The query verbs as JSON routes beside GET /metrics.
                serve_http.attach(self._obs._server, self.query_engine)
        # Control-plane knobs (control/). The attributes exist with or
        # without a controller: without one they are the configured
        # constants the hot path reads. `_audit_every` thins the audit
        # shadow under ladder rung >= 1, `_temporal_paused` gates the
        # temporal sidecar under rung >= 3; `_admission` is the ingress
        # valve of rung 4, and `_admission_retire` the drained spill
        # files the next durable snapshot retires.
        self._audit_every = 1
        self._temporal_paused = False
        self._admission = None
        self._admission_retire: list = []
        self._control = (self._obs.control if self._obs is not None
                         else None)
        if self._control is not None:
            self._control.attach(self)
            self._admission = self._control.admission

    def _init_telemetry(self) -> None:
        """The hot loop's telemetry handles: the stage histograms, the
        dispatch-gap histogram and the dispatch thread's busy-fraction
        callback gauges (host seconds over host wall, divided at scrape
        time; nothing in them reads the card)."""
        t = self._obs
        self._h_dequeue = t.stage("dequeue_wait")
        self._h_decode = t.stage("decode")
        self._h_dispatch = t.stage("dispatch")
        self._h_device = t.stage("device_wait")
        self._h_snap_write = t.stage("snapshot_write")
        self._h_snap_blocked = t.stage("snapshot_blocked")
        # Wall seconds this thread spent in decode / dispatch / the
        # temporal host passes / the drain's waits since run() started.
        self._busy = {"decode": 0.0, "device_dispatch": 0.0,
                      "temporal": 0.0, "device_wait": 0.0}
        self._busy_anchor = time.perf_counter()
        self._last_dispatch_t = 0.0
        self._last_dequeue_s = 0.0  # run-loop receive wait, per batch
        self._dw_accum = 0.0  # device_wait since the last flight record
        self._c_xfer = {}
        self._h_gap = t.registry.histogram(
            "attendance_dispatch_gap_seconds",
            help="Host-side gap between consecutive device "
            "dispatch enqueues (device idle opportunity: the "
            "transport/host side is what fills it)")
        ref = weakref.ref(self)

        def _busy_reader(component: str):
            def read() -> float:
                pipe = ref()
                if pipe is None:
                    return float("nan")
                wall = time.perf_counter() - pipe._busy_anchor
                return pipe._busy[component] / wall if wall > 0 else 0.0
            return read

        components = ("decode", "device_dispatch", "device_wait")
        if self.config.temporal_period_s > 0:
            components += ("temporal",)
        for component in components:
            t.registry.gauge(
                "attendance_dispatch_thread_busy_fraction",
                help="Dispatch-thread occupancy split since the "
                "current run started (the measurement behind the "
                "lane-style temporal-worker decision)",
                component=component).set_function(
                    _busy_reader(component))

    def _count_xfer(self, site: str, direction: str, nbytes: int,
                    wire: Optional[str] = None) -> None:
        """Count host<->device bytes: the gather seams the JAX package
        counts (roster preload H2D, snapshot capture and mirror gather
        D2H, ``{site, direction}``), and each frame's wire buffer
        (``site="frame"``, labelled by ``wire``)."""
        if self._obs is None or nbytes <= 0:
            return
        key = (site, direction, wire)
        c = self._c_xfer.get(key)
        if c is None:
            labels = dict(site=site, direction=direction)
            if wire is not None:
                labels["wire"] = wire
            c = self._c_xfer[key] = self._obs.registry.counter(
                "attendance_device_transfer_bytes_total",
                help="Host<->device bytes moved at the snapshot/"
                "mirror gather seams", **labels)
        c.inc(int(nbytes))

    def _make_engine(self, mesh, num_banks: int) -> ShardedSketchEngine:
        """The mesh's engine."""
        cfg = self.config
        if cfg.wire_format == "bytes":
            logger.warning(
                "--wire-format=bytes has no effect with num_shards/"
                "num_replicas > 1: the sharded engine carries wide "
                "frames as separate key/bank arrays instead")
        if mesh is None:
            init_distributed()  # a no-op outside a process group
            mesh = make_multihost_mesh(cfg.num_shards, cfg.num_replicas)
        if mesh.shape != {"dp": cfg.num_replicas, "sp": cfg.num_shards}:
            raise ValueError(f"mesh {mesh.shape} is not the config's dp="
                             f"{cfg.num_replicas} x sp={cfg.num_shards}")
        return ShardedSketchEngine(
            mesh, capacity=cfg.bloom_filter_capacity,
            error_rate=cfg.bloom_filter_error_rate, num_banks=num_banks,
            precision=cfg.hll_precision, layout="blocked",
            replica_sync=cfg.replica_sync)

    # -- roster -------------------------------------------------------------
    def preload(self, keys) -> None:
        """Load the roster into the Bloom filter: one K3 launch (on a
        mesh, one K11 launch per cell over its replica's share of the
        roster, then the OR across dp)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        self._count_xfer("preload", "h2d", keys.nbytes)
        if self.engine is not None:
            self.engine.preload(keys)
        else:
            bloom_add_packed(self.state.bloom_bits,
                             torch.from_numpy(keys.view(np.int32)).to(
                                 self.device),
                             self.params)
        # The filter changed: no base on disk covers it, so the next
        # barrier writes a full base before deltas (which never carry
        # the filter) may chain on.
        self._base_stale = True
        self._bloom_host = None
        if self._auditor is not None:
            # The roster IS the filter's whole membership (the hot loop
            # never adds to it): its sampled subset is the shadow's
            # ground truth for the false-negative probe and the
            # measured-FPR classification. Recorded after the preload:
            # the scrape thread re-queries the filter, and shadowing
            # keys the filter does not hold yet reads them as false
            # negatives.
            self._auditor.record_roster(keys)
        if self._temporal is not None:
            # The window shadow classifies validity by roster membership.
            self._temporal.record_roster(keys)
        self._roster_size = len(keys)
        # The mesh publishes its first epoch at its first barrier (on a
        # multi-process mesh its state reads are collectives), as in JAX.
        if self.engine is None and (self.checkpointing
                                    or self.query_engine is not None
                                    or self._fed is not None):
            # The snapshot path's host filter, the first read epoch and a
            # federated worker's first full frame, read here, before the
            # run, where the wait costs least.
            regs_h, counts_h = self._host_state()
            self._publish_epoch(regs_h, counts_h, bank_of=dict(self._bank_of))
            if self._fed is not None:
                # The filter reaches the aggregator before any delta
                # (deltas never carry Bloom words): the federation's
                # zero-false-negative guarantee is the OR of every
                # shard's preload frame.
                self._fed.publish_full(self._bloom_host, regs_h, counts_h,
                                       dict(self._bank_of),
                                       self._events_total,
                                       roster_size=self._roster_size)

    @property
    def _events_total(self) -> int:
        """Events including a restored chain's total: what every durable
        manifest stamps (``metrics.events`` restarts at 0 on restore)."""
        return self._events_restored + self.metrics.events

    # -- bank mapping -------------------------------------------------------
    def _num_banks(self) -> int:
        if self.engine is not None:
            return self.engine.num_banks
        return self.state.hll_regs.shape[0]

    def _grow_banks(self) -> None:
        if self.engine is not None:
            self.engine.grow_banks(self.engine.num_banks * 2)
            return
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
        if self.engine is not None or not banks:
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
        if self._recomp is not None:
            # The JAX package's fingerprint: its compiled add takes the
            # keys padded to a power of two. The port launches K4/K5 at
            # the frame's own length, so this site's steady count says
            # nothing of the launch shape.
            self._note_compile("temporal_window_add",
                               padded_lanes(len(keys)))
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
        keys = {k: b for k, b in dict(self._bank_of).items()
                if is_bucket_key(k)}
        if not keys:
            return {}
        if self.engine is not None:
            ests = self.engine.count_all()
            return {k: int(ests[b]) for k, b in keys.items()}
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
        obs_t = self._obs
        st = self._stage_mark
        if st is not None:
            st.set("decode")
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
        t = t_dec = self._lap("decode", t)
        if st is not None:
            st.set("dispatch")
        n = len(cols["student_id"])
        if n == 0:
            return None, None, []
        if obs_t is not None and self._last_dispatch_t:
            # Gap since the previous dispatch enqueue completed: the
            # window the card could have been starving in (launches are
            # asynchronous, so the host's feed gaps are the ceiling).
            # After the empty-frame return: an empty frame dispatches
            # nothing.
            self._h_gap.observe(max(t_dec - self._last_dispatch_t, 0.0))
        if self._snap_dirty:
            # Delta checkpointing: the lecture days this frame touches,
            # seen before the dispatch (native packs never materialize
            # a host bank array).
            self._note_dirty(cols["lecture_day"])
        if self._auditor is not None and (
                self._audit_every <= 1
                or self.metrics.batches % self._audit_every == 0):
            # Shadow recording only (no read of the card): the sampled
            # lanes feed the scrape-time measured FPR and HLL error
            # (obs/audit.register_fused_audit). Under ladder rung >= 1
            # the controller widens `_audit_every`, so the shadow thins
            # to every Nth frame: the measured gauges stay live over a
            # sparser sample.
            self._auditor.observe_fused_frame(cols["student_id"],
                                              cols["lecture_day"])
        if self.engine is not None:
            valid_n, stored = self._dispatch_sharded(cols, n)
        else:
            padded = padded_lanes(n)
            with maybe_annotate(self._profiling, "fused_step_dispatch"):
                valid, perm = self._dispatch_single(cols, padded)
            valid_n = valid[:n]
            # The seg/delta wires answer in bank-sorted order: the store
            # keeps rows in original order with a lazy view that scatters
            # the validity back when read.
            stored = (valid_n if perm is None
                      else _ScatterValidity(valid, perm, n))
        t_tmp = 0.0
        if self._temporal is not None and not self._temporal_paused:
            # After the day map and the step, as in the JAX package: days
            # take their banks first, then new buckets take theirs. A
            # paused frame (ladder rung >= 3) skips the sidecar: windowed
            # analytics go stale, the core state does not.
            t = time.perf_counter()
            if st is not None:
                st.set("temporal")
            self._temporal.observe_frame(cols)
            t_tmp = self._lap("temporal", t) - t
            if st is not None:
                st.set("dispatch")
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        pinned, self._frame_pinned = self._frame_pinned, []
        t = time.perf_counter()
        try:
            self.store.insert_columns({**cols, "is_valid": stored})
        except PersistFault:
            # The run loop nacks the frame and drops its pinned buffers:
            # wait for the copies that read them first.
            if done is not None:
                done.synchronize()
            raise
        t_end = t = self._lap("store", t)
        self.metrics.batches += 1
        self.metrics.events += n
        self.metrics.device_seconds += t - t0
        if obs_t is not None:
            self._observe_frame(obs_t, n, t0, t_dec, t_tmp, t_end)
        return valid_n, done, pinned

    def _observe_frame(self, obs_t, n: int, t0: float, t_dec: float,
                       t_tmp: float, t_end: float) -> None:
        """One dispatched frame's telemetry: the busy split, events and
        frames, the decode and dispatch spans under the batch span the
        run loop activated, the stage histograms (the trace id as their
        exemplar) and the flight record."""
        self._last_dispatch_t = t_end
        # The temporal host passes are carved out of the dispatch phase
        # they ride inside.
        self._busy["decode"] += t_dec - t0
        self._busy["temporal"] += t_tmp
        self._busy["device_dispatch"] += (t_end - t_dec) - t_tmp
        obs_t.events.inc(n)
        obs_t.frames.inc()
        trace_hex = ""
        tr = self._tracer
        if tr is not None:
            # The batch span run() activated; process_frame called
            # directly (tests, embedding) roots fresh spans.
            cur = tr.current()
            tid = cur.trace_id if cur is not None else tr.new_id()
            parent = cur.span_id if cur is not None else None
            tr.add_span("decode", t0, t_dec, trace_id=tid,
                        parent_id=parent, role=self._TRACE_ROLE,
                        args={"events": n})
            tr.add_span("dispatch", t_dec, t_end, trace_id=tid,
                        parent_id=parent, role=self._TRACE_ROLE,
                        args={"wire": self._last_wire})
            trace_hex = f"{tid:016x}"
        self._h_decode.observe(t_dec - t0, trace_hex)
        self._h_dispatch.observe(t_end - t_dec, trace_hex)
        dw, self._dw_accum = self._dw_accum, 0.0
        if obs_t.flight is None:
            return
        stages = {
            "dequeue_wait": round(self._last_dequeue_s, 6),
            "decode": round(t_dec - t0, 6),
            "dispatch": round((t_end - t_dec) - t_tmp, 6),
            "device_wait": round(dw, 6),
        }
        if self._temporal is not None:
            stages["temporal"] = round(t_tmp, 6)
        rec = dict(
            ts=round(time.time(), 6), events=n, wire=self._last_wire,
            decode_s=round(t_dec - t0, 6),
            dispatch_s=round(t_end - t_dec, 6),
            inflight=len(self._inflight), stages=stages)
        if trace_hex:
            # A dump names the trace each batch record belongs to.
            rec["trace"] = trace_hex
        obs_t.record_batch(**rec)

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

    def _note_word_degrade(self) -> None:
        """Log ONCE when ``--wire-format word`` was asked for but a
        frame's key and bank bits exceed 32, so it rides the wide wire
        (bytes on one card, arrays on a mesh): without it the forced
        format would go unhonoured silently (only wire_dwell would show
        it)."""
        if (self.config.wire_format == "word"
                and not self._warned_word_degrade):
            self._warned_word_degrade = True
            logger.warning(
                "--wire-format=word cannot be honored: key bits + bank "
                "bits exceed one 32-bit word; frames fall back to the "
                "%s wire (see metrics wire_dwell for the split)",
                "arrays" if self.engine is not None else "bytes")

    def _count_wire(self, key: str, nbytes: int) -> None:
        """One frame dispatched over ``key``, ``nbytes`` of wire buffer
        to the card: counted where the step is launched, so a fallback
        frame counts for the wire that carried it."""
        dwell = self.metrics.wire_dwell
        dwell[key] = dwell.get(key, 0) + 1
        self._last_wire = key
        if self._obs is not None:
            self._obs.wire(key).inc()
            self._count_xfer("frame", "h2d", nbytes, wire=key)

    def _note_compile(self, fn: str, *fingerprint) -> None:
        """Report one dispatch's shape fingerprint to the launch-shape
        tracker (``obs/profiler.RecompileTracker``), at the dispatch
        sites themselves, like _count_wire, with the JAX package's ``fn``
        names and fingerprints. One set lookup a frame."""
        rc = self._recomp
        if rc is not None:
            rc.observe(fn, fingerprint)

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
                    self._note_word_degrade()
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
        if not use_words:
            self._note_word_degrade()
        buf = (pack_words(sid, banks, kw, padded) if use_words
               else pack_bytes(sid, banks, self._bank_dtype, padded))
        t = self._lap("pack", t)
        return self._launch_wide(buf, use_words, kw, t), None

    def _dispatch_sharded(self, cols: Dict[str, np.ndarray], n: int):
        """One frame onto the mesh: the numpy day map, then the seg or
        delta wire (``--wire-format``, or the ``auto`` ladder's pick,
        which on a mesh climbs with or without the native pack, as in
        JAX), else the packed word wire (4 bytes an event) when key and
        bank bits fit a word, else separate key and bank arrays. Returns
        (the device validity, what the store keeps): valid[:n] on the
        wide wires; on the narrow ones the packed per-slice vector and
        its lazy original-order view."""
        sid, days = cols["student_id"], cols["lecture_day"]
        t = time.perf_counter()
        banks = self._banks_for(days)
        t = self._lap("bank_map", t)
        wire = self.config.wire_format
        if wire == "auto":
            wire = self._auto_wire()
        if wire in ("seg", "delta"):
            with maybe_annotate(self._profiling, "sharded_narrow_step"):
                valid, lanes, orig = self._dispatch_sharded_narrow(
                    sid, banks, days, n, wire, t)
            return valid, _ScatterValidity(valid, orig, n, lanes=lanes)
        num_banks = self._num_banks()
        kw = self._pick_kw(int(sid.max()).bit_length(), num_banks)
        with maybe_annotate(self._profiling, "sharded_fused_step"):
            if kw + num_banks.bit_length() <= 32:
                self._kw_hint = kw
                words = pack_words(sid, banks, kw,
                                   self.engine.padded_size(n))
                t = self._lap("pack", t)
                self._count_wire("word", words.nbytes)
                self._note_compile("sharded_step_words", kw, len(words))
                valid = self.engine.step_words(words, n, kw)
            else:
                # Keys and bank ids: 8 bytes a padded lane.
                self._note_word_degrade()
                self._count_wire("arrays", 8 * self.engine.padded_size(n))
                self._note_compile("sharded_step_arrays",
                                   self.engine.padded_size(n))
                valid = self.engine.step(sid, banks)
        self._lap("dispatch", t)
        return valid, valid

    def _dispatch_sharded_narrow(self, sid: np.ndarray, banks: np.ndarray,
                                 days: np.ndarray, n: int, mode: str,
                                 t: float):
        """The seg or delta wire onto the mesh: the frame split into dp
        contiguous slices of ``padded_local`` lanes, each packed on its
        own (one uint32[dp, words] array, a replica's row for its
        cells), the JAX package's protocol. Returns (valid, lanes,
        orig): the device validity in packed per-slice order, and the
        positions of the real lanes in it with their original indices.

        A slice packs natively (the single card's passes) where it can.
        ``banks`` is resolved already, so a native LUT miss is a day
        outside the LUT window: that slice takes the numpy pack with the
        resolved banks, and the native pack is skipped for the next 32
        frames. The replicas share one seg width (the key-width hint) and
        one delta width (from every slice's scan, then the decayed
        hint)."""
        engine = self.engine
        dp = engine.dp
        num_banks = engine.num_banks
        padded_local = engine.padded_size(n) // dp
        bounds = [min(n, r * padded_local) for r in range(dp + 1)]
        slices = [(sid[bounds[r]:bounds[r + 1]],
                   banks[bounds[r]:bounds[r + 1]],
                   days[bounds[r]:bounds[r + 1]]) for r in range(dp)]
        nat = self._native
        if nat is not None and self._native_skip > 0:
            self._native_skip -= 1
            nat = None
        if nat is not None and self._day_base is None:
            self._rebuild_lut(int(days.min()))
        if mode == "seg":
            width = min(max(int(sid.max()).bit_length(), 1,
                            self._kw_hint), 32)
            self._kw_hint = width
        else:
            scans = []
            for ks, bs, ds in slices:
                scan = None
                if nat is not None and len(ks):
                    scan, miss = nat.delta_scan(
                        ks, ds, self._day_lut, self._day_base, num_banks)
                    if scan is None and miss >= 0:
                        self._native_skip = 32
                if scan is None:
                    scan = delta_scan(ks, bs, num_banks)
                scans.append(scan)
            needed = max(scan[-1] for scan in scans)
            width = pick_delta_width(self._db_hint, needed)
            self._db_hint = self._decayed_db(width, needed)
        bufs = None
        lanes = np.empty(n, np.int64)
        orig = np.empty(n, np.int64)
        pos = 0
        tr = self._tracer
        for r, (ks, bs, ds) in enumerate(slices):
            t_pack = time.perf_counter() if tr is not None else 0.0
            buf = perm = None
            if mode == "seg":
                if nat is not None and len(ks):
                    buf, perm, miss = nat.pack_seg(
                        ks, ds, self._day_lut, self._day_base, width,
                        padded_local, num_banks)
                    if buf is None and miss >= 0:
                        self._native_skip = 32
                if buf is None:
                    buf, perm = pack_seg(ks, bs, width, padded_local,
                                         num_banks)
            else:
                perm = scans[r][0]
                if nat is not None:
                    buf = nat.bitpack_delta(scans[r], width, padded_local,
                                            num_banks)
                if buf is None:
                    buf, perm = pack_delta(ks, bs, width, padded_local,
                                           num_banks, scan=scans[r])
            if tr is not None:
                # Replica-labelled host-pack spans: which dp slice's pack
                # dominates the mesh batch (under the batch span).
                cur = tr.current()
                tr.add_span("pack", t_pack, time.perf_counter(),
                            trace_id=(cur.trace_id if cur is not None
                                      else tr.new_id()),
                            parent_id=cur.span_id if cur is not None
                            else None, role=self._TRACE_ROLE,
                            args={"replica": r, "wire": mode,
                                  "events": len(ks)})
            if bufs is None:
                bufs = np.empty((dp, len(buf)), np.uint32)
            bufs[r] = buf
            m = len(ks)
            lanes[pos:pos + m] = r * padded_local + np.arange(m)
            orig[pos:pos + m] = bounds[r] + perm
            pos += m
        t = self._lap("pack", t)
        self._count_wire(mode, bufs.nbytes)
        if self._obs is not None:
            engine.note_shard_events(
                [bounds[r + 1] - bounds[r] for r in range(dp)])
        self._note_compile(f"sharded_step_{mode}", width, padded_local)
        valid = engine.step_narrow(bufs, mode, width, padded_local)
        self._lap("dispatch", t)
        return valid, lanes, orig

    def _launch_wide(self, buf: np.ndarray, use_words: bool, kw: int,
                     t: float) -> torch.Tensor:
        """K2 over a packed word (``use_words``) or bytes buffer."""
        prec = self.config.hll_precision
        if use_words:
            self._kw_hint = kw
            self._count_wire("word", buf.nbytes)
            self._note_compile("step_words", kw, len(buf))
            valid = fused_step_words(self.state,
                                     self._to_device(buf.view(np.int32)),
                                     self.params, kw, prec)
        else:
            self._count_wire("bytes", buf.nbytes)
            self._note_compile("step_bytes", len(buf))
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
        self._count_wire(mode, buf.nbytes)
        self._note_compile(f"step_{mode}", width, padded, num_banks)
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
        pinned = [p for _, _, ps, _ in self._inflight for p in ps]
        if self._snap_mode == "delta" and not self._base_stale:
            banks = self._drain_dirty_banks()
            idx_h = self._pad_bank_index(banks)
            self._note_compile("snapshot_capture", len(idx_h))
            idx, idx_pinned = to_device(idx_h, self.device)
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
                   msgs=[m for m, *_ in self._inflight if m is not None],
                   retire=self._admission_retire, pinned=pinned,
                   events=self._events_total, bank_of=dict(self._bank_of))
        self._inflight.clear()
        self._admission_retire = []
        self._batches_at_snap = self.metrics.batches
        self._enqueue_snap(job)

    def _checkpoint_and_ack(self) -> None:
        """A barrier that waits until its snapshot is durable and its
        frames acked (idle receive, end of run, and every barrier on a
        mesh). The mesh's barrier stays on this thread, as in JAX: on a
        multi-process mesh its state reads are collectives that every
        process must run in the same order; in delta mode it reads only
        the dirty banks' rows."""
        if self.engine is None:
            self._checkpoint_async(force=True)
            self._flush_snapshots()
            return
        if self._snap_mode == "delta" and not self._base_stale:
            self._snapshot_sync_delta()
        else:
            self.snapshot()
        self._ack([m for m, *_ in self._inflight if m is not None])
        self._inflight.clear()
        self._retire_spilled()

    def _snapshot_sync_delta(self) -> None:
        """The mesh's delta barrier: the dirty banks' rows merged across
        dp (only those rows leave the devices) and the counters, written
        synchronously. Every process reads; only process 0 writes."""
        self._flush_snapshots()
        banks = self._drain_dirty_banks()
        rows = self.engine.get_state_rows(
            self._pad_bank_index(banks))[:len(banks)]
        counts = self.engine.get_counts()
        self._count_xfer("snapshot_capture", "d2h", rows.nbytes)
        self._batches_at_snap = self.metrics.batches
        if not self._primary:
            return
        bank_of, events = dict(self._bank_of), self._events_total
        num_banks = self.engine.num_banks
        with self._snap_io_lock:
            nbytes = self._write_delta_files(banks, rows, counts, bank_of,
                                             events, num_banks, upto=None)
        self._post_delta_bookkeeping(banks, rows, nbytes, counts, bank_of,
                                     events, num_banks, upto=None)

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
        if self._obs is not None:
            self._h_snap_blocked.observe(blocked)

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
        self._count_xfer("snapshot_capture", "d2h",
                         regs.numel() + 4 * counts.numel())
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
        inj = self._chaos
        st = self._stage_mark
        prev_stage = st.set("snapshot") if st is not None else None
        try:
            if inj is not None:
                stall = inj.stall_s("snapshot.writer")
                if stall:
                    time.sleep(stall)  # an injected writer stall
                if inj.roll("snapshot.writer", "snap_fail"):
                    raise ChaosFault("chaos snap_fail at snapshot.writer")
            with self._snap_stream_ctx(job):
                self._run_snap_job(job)
            self._ack(job["msgs"])
            # The write holding the drained spill frames' results is
            # durable: their files go now, not at the capture.
            IngressAdmission.retire(job.get("retire", ()))
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
                self._snap_unretired.extend(job.get("retire", ()))
            disk_full = (isinstance(exc, OSError)
                         and exc.errno == errno.ENOSPC)
            if self._obs is not None:
                self._obs.registry.counter(
                    "attendance_snapshot_write_failures_total",
                    help="Background snapshot writes that failed "
                    "(frames stay unacked; next barrier forces a "
                    "full base)").inc()
                if disk_full:
                    self._obs.registry.counter(
                        "attendance_snapshot_disk_full_total",
                        help="Snapshot writes refused with ENOSPC "
                        "(writer backs off at the capped cadence "
                        "until space frees; frames stay unacked)").inc()
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
            if st is not None:
                st.restore(prev_stage)
            t_done = time.perf_counter()
            self.metrics.snapshot_stalls.append(t_done - t0)
            if self._obs is not None:
                self._h_snap_write.observe(t_done - t0)
                if self._tracer is not None:
                    self._tracer.add_span(
                        "snapshot_write", t0, t_done,
                        trace_id=self._tracer.new_id(),
                        role=self._TRACE_ROLE,
                        args={"events_at": job["events"],
                              "kind": job["kind"]})
            with self._snap_cv:
                self._snap_pending -= 1
                self._snap_cv.notify_all()

    def _ack(self, msgs) -> None:
        acknowledge_all(self.consumer, msgs)

    def _ack_unacked(self) -> None:
        """A durable full base covers every frame before its capture:
        ack the frames of the jobs that failed before it and retire
        their drained spill files."""
        with self._snap_cv:
            msgs, self._snap_unacked = self._snap_unacked, []
            paths, self._snap_unretired = self._snap_unretired, []
        self._ack(msgs)
        IngressAdmission.retire(paths)

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
            if self._fed is not None:
                self._fed.publish_full(job["bloom"], self._regs_mirror,
                                       counts_h, job["bank_of"],
                                       job["events"],
                                       roster_size=self._roster_size)
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
        staged write (the run loop's barriers use the writer; a mesh's
        base barriers call this)."""
        if self._snap_dir is None:
            return
        regs, counts = self._host_state()
        bits = self._bloom_host
        self._dirty_days.clear()
        self._regs_mirror = np.array(regs, dtype=np.uint8, copy=True)
        self._publish_epoch(self._regs_mirror, counts,
                            bank_of=dict(self._bank_of))
        if self._fed is not None:
            self._fed.publish_full(bits, self._regs_mirror, counts,
                                   dict(self._bank_of), self._events_total,
                                   roster_size=self._roster_size)
        if self._primary:
            # On a multi-process mesh every process holds the same state;
            # one writes it.
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
        chaos_pre_write("disk.chain")
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
        # The digest of the clean bytes, before the chaos rot hook can
        # touch the published copy.
        self._base_digest = file_digest(tmp) if self._integrity else ""
        tmp.replace(path)
        chaos_post_publish("disk.chain", path)
        # A full base supersedes the delta chain: reset the manifest
        # FIRST, then delete the superseded files.
        old = list(self._snap_chain)
        self._snap_chain = []
        self._snap_digests = {}
        self._write_chain_manifest()
        if self._g_chain_len is not None:
            self._g_chain_len.set(0.0)
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
        publish the mirror as the next read epoch, gossip the delta when
        federated and, at the compaction cadence, fold the chain into a
        fresh base. Only a durable delta gossips: a failed write raises
        before this, and the full base owed after it gossips a full
        frame."""
        if self._g_delta_bytes is not None:
            self._g_delta_bytes.set(float(nbytes))
            self._g_chain_len.set(float(len(self._snap_chain)))
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
        if self._fed is not None:
            # The same rows that just became durable. A publisher that
            # owes a full frame (an earlier publish failed, so the
            # aggregator may lack banks) sends one from the host mirror.
            if self._fed.full_due and mirror is not None \
                    and self._bloom_host is not None:
                self._fed.publish_full(self._bloom_host, mirror, counts,
                                       bank_of, events,
                                       roster_size=self._roster_size)
            else:
                self._fed.publish_delta(banks, rows, counts, bank_of,
                                        events, num_banks,
                                        roster_size=self._roster_size)
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
        writer only, never the hot loop). The audit shadow's per-day
        truth is taken WITH the epoch, so the read path's HLL audit
        compares estimate and truth of the same moment instead of
        charging barrier staleness to the sketch."""
        auditor = self._auditor
        self.read_mirror.publish(
            regs=regs_h,
            events=self._events_total if events is None else events,
            bank_of=bank_of, params=self.params,
            precision=self.config.hll_precision,
            bloom_words=self._bloom_host,
            counts=None if counts_h is None else np.asarray(counts_h),
            roster_size=self._roster_size,
            day_truth=(auditor.fused_day_truth() if auditor is not None
                       else None))

    def _host_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """(uint8 registers, uint32[2, 2] counters) of the card's CURRENT
        state on the host, after the staged snapshot writes; reads the
        host filter too when none is held (a mesh reads it every time,
        with its registers merged across dp). A cold path: between
        runs."""
        self._flush_snapshots()
        if self.engine is not None:
            bits, regs = self.engine.get_state()
            self._bloom_host = bits
            self._count_xfer("mirror_gather", "d2h",
                             bits.nbytes + regs.nbytes)
            return regs, self.engine.get_counts()
        if self._bloom_host is None:
            self._bloom_host = self.state.bloom_bits.cpu().numpy().view(
                np.uint32)
            self._count_xfer("mirror_gather", "d2h",
                             self._bloom_host.nbytes)
        regs_h = self.state.hll_regs.cpu().numpy()
        self._count_xfer("mirror_gather", "d2h", regs_h.nbytes)
        return regs_h, self.state.counts.cpu().numpy().view(np.uint32)

    def publish_epoch(self) -> None:
        """Publish one epoch from the card's CURRENT state, after the
        staged snapshot writes: the one device read of the query plane,
        for embedders that serve without checkpointing. A cold path:
        call it between runs, never mid-stream."""
        regs_h, counts_h = self._host_state()
        self._publish_epoch(regs_h, counts_h, bank_of=dict(self._bank_of))

    def fed_flush(self) -> None:
        """Publish one FULL merge frame of the current state: a federated
        worker's end-of-run handshake (the aggregator holds its whole
        contribution before the process exits). A cold path: it reads
        the card, as ``publish_epoch`` does."""
        if self._fed is None:
            return
        regs_h, counts_h = self._host_state()
        self._fed.publish_full(self._bloom_host, regs_h, counts_h,
                               dict(self._bank_of), self._events_total,
                               roster_size=self._roster_size)

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
        if self.engine is not None:
            self.engine.set_state(np.asarray(chain_state["bits"], np.uint32),
                                  np.asarray(regs, np.uint8))
            self.engine.set_counts(chain_state["counts"])
        else:
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
        if self._fed is not None:
            # A takeover re-asserts everything the dead peer made durable
            # under this (higher) incarnation, and its event counter
            # continues from the restored total (_events_total), so the
            # aggregator's per-worker max never double-counts a replay.
            self._fed.publish_full(self._bloom_host, self._regs_mirror,
                                   chain_state["counts"],
                                   dict(self._bank_of), int(events),
                                   roster_size=self._roster_size)
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
        """The repair ladder for a corrupt chain:

        1. local quarantine: the corrupt artifact moves into
           ``integrity-quarantine/`` and the chain is re-read truncated
           to its good prefix (a torn CHAIN.json degrades to the base
           alone; a corrupt base leaves nothing);
        2. peer re-assert, when federated: the aggregator's retained
           view of this worker holds the banks the lost deltas carried
           (they were gossiped at their fences), so a full re-assert
           frame is requested and folded over the surviving state;
        3. fresh base: restore owes a full base at once.

        Returns a ``read_chain_state`` dict, or None when nothing is
        recoverable (a corrupt base and no peer): restore then starts
        empty, loudly, with the corrupt bytes kept for triage."""
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
        folded = False
        if self._fed is not None:
            reassert = self._fed.request_reassert()
            if reassert is not None:
                state, folded = self._fold_reassert_state(state, reassert)
        if folded:
            self._count_repair("peer")
            return state  # _fold_reassert_state logged the repair
        if state is not None:
            self._count_repair("local")
            logger.warning(
                "chain repaired LOCALLY only (no federation peer to "
                "re-assert from): state truncated at the corrupt "
                "artifact — events acked into the lost suffix are not "
                "locally recoverable")
        else:
            logger.error(
                "chain at %s is unrepairable locally (base corrupt) and "
                "no peer re-assert is available — starting EMPTY; the "
                "corrupt bytes are preserved under integrity-quarantine/",
                self._snap_dir)
        return state

    def _count_repair(self, source: str) -> None:
        if self._obs is not None:
            self._obs.registry.counter(
                "attendance_chain_repairs_total",
                help="Corrupt-chain repairs (local truncation or "
                     "peer-assisted re-assert)", source=source).inc()

    def _fold_reassert_state(self, state: Optional[dict],
                             frame) -> Tuple[Optional[dict], bool]:
        """Fold a peer re-assert full frame (the aggregator's retained
        view of THIS worker's contribution) over the surviving chain
        state, or build the state from it when the base was lost. The
        CRDT joins (Bloom OR, register max, counter max) make the fold
        safe however much the two overlap. Returns ``(state, folded)``:
        False when the frame was refused (another geometry, or no
        filter to rebuild a lost base from)."""
        prec = self.config.hll_precision
        if int(frame.m_bits) and int(frame.m_bits) != self.params.m_bits:
            logger.error(
                "peer re-assert gossips a %s-bit filter, this worker "
                "runs %s bits — refusing the repair frame",
                frame.m_bits, self.params.m_bits)
            return state, False
        if int(frame.precision) != prec:
            logger.error(
                "peer re-assert gossips precision %s, this worker runs "
                "%s — refusing the repair frame", frame.precision, prec)
            return state, False
        f_regs = np.asarray(frame.arrays.get(
            "regs", np.zeros((0, 1 << prec), np.uint8)), np.uint8)
        f_counts = frame.arrays.get("counts")
        f_bloom = frame.arrays.get("bloom")
        if state is None:
            if f_bloom is None:
                logger.error("peer re-assert carries no Bloom words; "
                             "cannot rebuild a lost base from it")
                return None, False
            bank_of = {str(d): int(b) for d, b in frame.bank_of.items()}
            manifest = {
                "bank_of": bank_of,
                "m_bits": self.params.m_bits, "k": self.params.k,
                "precision": prec, "events": int(frame.events),
                "chain_seq": self._delta_seq,
            }
            state = dict(
                bits=np.asarray(f_bloom, np.uint32), regs=f_regs.copy(),
                counts=(np.asarray(f_counts, np.uint32)
                        if f_counts is not None
                        else np.zeros((2, 2), np.uint32)),
                bank_of=bank_of, events=int(frame.events), applied=[],
                manifest=manifest, base_digest="", digests={})
            logger.warning("rebuilt lost base entirely from the peer "
                           "re-assert (%d events, %d banks)",
                           state["events"], len(frame.bank_of))
            return state, True
        if f_bloom is not None:
            state["bits"] = bloom_or_words_np(state["bits"], f_bloom)
        bank_of = {int(d): int(b) for d, b in state["bank_of"].items()}
        regs = np.asarray(state["regs"], np.uint8)
        for day, fb in frame.bank_of.items():
            if fb >= f_regs.shape[0]:
                continue
            row = f_regs[fb]
            sb = bank_of.get(int(day))
            if sb is None:
                # Past the highest bank in use, not len(bank_of): a
                # temporal eviction's hole would otherwise alias a live
                # bank.
                sb = max(bank_of.values(), default=-1) + 1
                if sb >= regs.shape[0]:
                    grown = np.zeros((max(sb + 1, regs.shape[0] * 2),
                                      regs.shape[1]), np.uint8)
                    grown[:regs.shape[0]] = regs
                    regs = grown
                bank_of[int(day)] = sb
                regs[sb] = row
            else:
                regs[sb] = np.maximum(regs[sb], row)
        state["regs"] = regs
        state["bank_of"] = {str(d): b for d, b in bank_of.items()}
        lv, li = decode_counts(np.asarray(state["counts"], np.uint32))
        fv, fi = (decode_counts(np.asarray(f_counts, np.uint32))
                  if f_counts is not None else (0, 0))
        state["counts"] = encode_counts(max(lv, fv), max(li, fi))
        state["events"] = max(int(state["events"]), int(frame.events))
        logger.warning(
            "folded peer re-assert over the truncated chain: events %d, "
            "%d banks (lost deltas recovered from the aggregator's "
            "retained view)", state["events"], len(bank_of))
        return state, True

    # -- ack draining -------------------------------------------------------
    def _drain_inflight(self, block: int = 0) -> None:
        """Ack completed in-flight frames in dispatch order. ``block`` is
        how many not-yet-complete head entries to wait for (-1 = all).
        With checkpointing on, frames are acked only by the barriers'
        durable snapshots.

        With telemetry on, every frame drained on the card records its
        ``device_wait``: the host time from the query of its completion
        event to the end of the wait on it (0 when the card was done),
        a host clock around the wait the drain makes anyway. The
        profiler's ``device_wait`` stage mark spans the same interval."""
        if self.checkpointing:
            return
        st = self._stage_mark
        while self._inflight:
            msg, done, _pinned, span = self._inflight[0]
            if done is not None:
                t_w = time.perf_counter() if self._obs is not None else 0.0
                prev_stage = (st.set("device_wait") if st is not None
                              else None)
                if not done.query():
                    if block == 0:
                        if st is not None:
                            st.restore(prev_stage)
                        break
                    if block > 0:
                        # The hot loop stalls on a full deque: the card
                        # or the link is behind (_auto_wire's climb
                        # signal).
                        self._drain_waited = True
                    t = time.perf_counter()
                    done.synchronize()
                    self._lap("ack_wait", t)
                    if block > 0:
                        block -= 1
                if self._obs is not None:
                    self._observe_device_wait(t_w, time.perf_counter(),
                                              span)
                if st is not None:
                    st.restore(prev_stage)
            if msg is not None:  # a drained spill frame has no message
                self.consumer.acknowledge(msg)
            self._inflight.popleft()

    def _observe_device_wait(self, t_w: float, t_done: float,
                             span) -> None:
        self._h_device.observe(t_done - t_w)
        self._busy["device_wait"] += t_done - t_w
        self._dw_accum += t_done - t_w
        if self._tracer is not None and span is not None:
            # device_wait lands after its batch span closed (the frames
            # are pipelined): committed with explicit timestamps under
            # the same trace.
            self._tracer.add_span(
                "device_wait", t_w, t_done, trace_id=span.trace_id,
                parent_id=span.span_id, role=self._TRACE_ROLE)

    def run(self, max_events: Optional[int] = None,
            idle_timeout_s: float = 1.0) -> None:
        """Consume frames until ``max_events`` or an idle timeout; every
        consumed frame is acknowledged (with checkpointing: is durable)
        before this returns, unless its snapshot write failed."""
        t_start = time.perf_counter()
        if self._obs is not None:
            # The busy fractions and the dispatch gap describe the
            # CURRENT run: an idle gap between runs dilutes neither.
            self._busy_anchor = t_start
            for k in self._busy:
                self._busy[k] = 0.0
            self._last_dispatch_t = 0.0
            self._last_dequeue_s = 0.0
        try:
            with maybe_trace(self.config.profile_dir, self.device):
                self._run_loop(max_events, idle_timeout_s)
        except Exception:
            # The crash forensics: the ring holds the last N per-batch
            # records leading up to this exception.
            if self._obs is not None:
                self._obs.dump_flight("run-loop-exception")
            raise
        if self._admission is not None and self._admission.pending_count:
            # Every spilled frame was acked against its spill file's
            # durability: it reaches the sketch state (and the final
            # barrier below) before this run ends.
            while self._drain_admission(limit=64):
                pass
        if self._temporal is not None:
            # End of run: release the reorder buffer, rotate the final
            # buckets, fold the staged CMS estimates (before the final
            # barrier).
            t = time.perf_counter()
            self._temporal.flush()
            self._lap("temporal", t)
        if self.checkpointing:
            if self._inflight or self._snap_unacked \
                    or self._admission_retire:
                # Drained spill frames force a barrier even with no
                # broker frame in flight: their files retire only once a
                # snapshot covers their events.
                self._checkpoint_and_ack()
            else:
                self._flush_snapshots()
        self._drain_inflight(block=-1)
        self.metrics.wall_seconds = time.perf_counter() - t_start
        # No device read here: validity and the FPR estimate stay on the
        # device until a caller asks (validity_counts, estimated_fpr), so
        # the metrics line defers both.
        if logger.isEnabledFor(logging.INFO):
            logger.info("Fused metrics: %s",
                        self.metrics.summary(None, include_validity=False))
        if self.config.metrics_json:
            self.metrics.write_json_line(self.config.metrics_json,
                                         fpr_is_lower_bound=True)
        if self._obs is not None:
            self._obs.finalize_slo("run-end")
            self._obs.flush_trace("run-end")
            self._obs.flush_profile("run-end")
            if self._recomp is not None:
                # Steady-state contract: warm-up shapes end with the
                # first completed run; a new fingerprint after this is a
                # shape leak doctor's --recompile-ceiling gates at 0.
                self._recomp.mark_warm()

    def _begin_batch_span(self, msg, t_rx: float, t_got: float):
        """The per-batch span continuing the trace the producer put in
        the message properties (a fresh one when the producer did not
        trace); a redelivered frame becomes a ``retry`` span under the
        same publish span."""
        props = (msg.properties() if hasattr(msg, "properties")
                 else None)
        return self._tracer.begin_consume(
            props, redelivery_count(msg), role=self._TRACE_ROLE,
            start=t_rx, got=t_got, wait_name="dequeue_wait",
            args={"bytes": len(msg.data())})

    def _run_loop(self, max_events: Optional[int],
                  idle_timeout_s: float) -> None:
        idle_since = time.monotonic()
        st = self._stage_mark
        while True:
            if st is not None:
                st.set("dequeue")
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
                if (self._admission is not None
                        and not self._admission.active
                        and self._admission.pending_count):
                    # Pressure cleared with frames parked in the ingress
                    # spill: replay them on this thread (process_frame is
                    # the dispatch thread's). Their files retire once a
                    # durable snapshot covers them.
                    if self._drain_admission(limit=16):
                        idle_since = time.monotonic()  # progress
                    continue
                if time.monotonic() - idle_since > idle_timeout_s:
                    break
                continue
            t_got = self._lap("receive", t)
            if self._obs is not None:
                self._h_dequeue.observe(t_got - t)
                self._last_dequeue_s = t_got - t
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
            adm = self._admission
            if adm is not None and adm.active:
                # Admission control (the ladder's shed rung), at the
                # producer-facing edge: "spill" wrote the raw frame
                # durably, which is what justifies the ack; "shed" nacks,
                # so the broker's retention is the backpressure. Either
                # way the frame skips decode and dispatch.
                decision = adm.admit(msg.data())
                if decision == "spill":
                    self.consumer.acknowledge(msg)
                    continue
                if decision == "shed":
                    self.consumer.negative_acknowledge(msg)
                    continue
                # "pass": the controller reopened between the check and
                # the admit.
            span = (self._begin_batch_span(msg, t, t_got)
                    if self._tracer is not None else None)
            try:
                if span is None:
                    _valid, done, pinned = self.process_frame(msg.data())
                else:
                    # Activated: the decode/dispatch spans and the mesh's
                    # replica spans nest under the batch span; a profile
                    # trace names the batch's range after its trace id.
                    with self._tracer.activate(span), annotate_trace(
                            self._profiling, span):
                        _valid, done, pinned = self.process_frame(
                            msg.data())
            except (PoisonFrame, PersistFault):
                # Bounded retry, then dead-letter: a frame nacked
                # forever livelocks the subscription. A failed decode is
                # poison, and so, as in JAX, is a persist failure that no
                # spill absorbed; a device fault raises.
                if span is not None:
                    self._tracer.end_span(span, error=True)
                logger.exception("Bad frame")
                handle_poison(msg, self.consumer, self.metrics,
                              self.config, logger, tracker=self._poison)
                continue
            if span is not None:
                self._tracer.end_span(span)
            self._inflight.append((msg, done, pinned, span))
            self._settle()
            if max_events is not None and self.metrics.events >= max_events:
                break

    def _settle(self) -> None:
        """After a frame joined the in-flight deque: with checkpointing a
        barrier on the frame cadence and on the in-flight depth (which
        bounds the frames' pinned buffers), else the acks of the frames
        whose steps completed."""
        if self.checkpointing:
            depth_forced = (len(self._inflight)
                            >= max(_INFLIGHT_DEPTH, self._snap_every))
            if (self.metrics.batches - self._batches_at_snap
                    >= self._snap_every or depth_forced):
                if self.engine is not None:
                    self._checkpoint_and_ack()
                else:
                    self._checkpoint_async(force=depth_forced)
        else:
            self._drain_inflight(
                block=1 if len(self._inflight) >= _INFLIGHT_DEPTH else 0)

    # -- ingress-spill draining (control plane) -----------------------------
    def _drain_admission(self, limit: int = 16) -> int:
        """Replay up to ``limit`` admission-spilled frames through the
        frame path (dispatch thread only): one K2 step each, in the
        in-flight deque with no broker message to ack. Their files are
        retired once a durable snapshot covers them (at-least-once: a
        crash before re-adopts them). Only a frame that fails to decode
        is parked as ``.poison``; any other exception leaves the run, as
        for a broker frame."""
        adm = self._admission
        if adm is None:
            return 0
        batch = adm.drain_batch(limit)
        for path, payload in batch:
            try:
                _valid, done, pinned = self.process_frame(payload)
            except PoisonFrame:
                logger.exception("Bad spilled frame %s", path)
                path.rename(path.with_suffix(".poison"))
                continue
            self._inflight.append((None, done, pinned, None))
            self._admission_retire.append(path)
            self._settle()
        if not self.checkpointing and self._admission_retire:
            # No barriers in this mode: processed is as durable as the
            # pipeline ever gets.
            adm.retire(self._admission_retire)
            self._admission_retire.clear()
        return len(batch)

    def _retire_spilled(self) -> None:
        """Delete the drained spill files of a barrier this thread just
        made durable (the mesh's synchronous barrier)."""
        if self._admission is not None and self._admission_retire:
            self._admission.retire(self._admission_retire)
            self._admission_retire.clear()

    # -- queries ------------------------------------------------------------
    def lecture_days(self):
        """Sorted lecture days with an HLL bank (temporal bucket keys
        share the map but are served by :meth:`window_counts`)."""
        return sorted(d for d in self._bank_of if not is_bucket_key(d))

    def validity_counts(self) -> Tuple[int, int]:
        """(valid, invalid) totals accumulated on the device since
        construction (waits for the device; a mesh sums its replicas')."""
        if self.engine is not None:
            return self.engine.validity_counts()
        return decode_counts(self.state.counts)

    def estimated_fpr(self) -> float:
        """Occupancy-based FPR estimate of the roster filter: fill^k (a
        slight underestimate for the blocked layout)."""
        if self.engine is not None:
            fill = self.engine.fill_fraction()
        else:
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
        if self.engine is not None:
            return self.engine.count(bank)
        prec = self.config.hll_precision
        hist = best_histogram(self.state.hll_regs[bank:bank + 1], prec)
        return int(round(estimate_from_histogram(hist.cpu().numpy()[0],
                                                 prec)))

    def count_all(self) -> Dict[int, int]:
        """PFCOUNT of every registered lecture day from ONE histogram
        launch over the live rows. Safe beside the run loop: the day map
        is copied in one step (a scrape, an SLO or incident tick and a
        fleet push call this from their own threads)."""
        days = {d: b for d, b in dict(self._bank_of).items()
                if not is_bucket_key(d)}
        if not days:
            return {}
        if self.engine is not None:
            ests = self.engine.count_all()
            return {day: int(ests[bank]) for day, bank in days.items()}
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
            if self._obs is not None and self._obs._server is not None:
                # The metrics server is process-global and outlives this
                # pipeline: leaked routes would serve (and pin) its last
                # epoch as live data.
                serve_http.detach(self._obs._server)
        # Wait out the staged snapshot writes (their acks go through the
        # consumer), then stop the writer.
        self._flush_snapshots()
        self._stop_snap_writer()
        if self._fed is not None:
            # After the writer drained: the last fence's frame is sent
            # before the producer closes.
            self._fed.close()
            self._fed = None
        if isinstance(self.consumer, StripedConsumer):
            # Stop the lane threads (which send the queued acks) and
            # close their sessions before the client goes.
            self.consumer.close()
        self.client.close()
        self.store.close()
