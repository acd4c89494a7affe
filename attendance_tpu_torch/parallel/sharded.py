"""Sharded sketch engine over a (dp, sp) grid of devices.

Counterpart of ``attendance_tpu/parallel/sharded.py``. State layout:

  * Bloom filter, packed words: the allocation is cut into sp slices of
    whole 512-bit blocks; grid cell (r, s) holds slice s (every replica r
    holds the whole filter, as JAX replicates it over "dp").
  * HLL registers: cell (r, s) holds replica r's private registers of
    slice s, ``uint8[banks, 2^p / sp]``, one contiguous tensor per cell
    (the kernels read rows of that stride, never a strided view).
  * Counters: replica r's two-lane ``int32[2, 2]`` block on its cell
    (r, 0) (JAX kept one copy on every sp device of the replica).
  * An event batch, padded: replica r takes lanes ``[r * local, (r + 1) *
    local)``, every cell of the replica reads them.

Per step, each cell answers for the probes its slice holds (K9, a probe
outside counting as set), the replica ANDs its cells' answers, and only
then does each cell max the valid lanes' ranks into its slice (K10; the
cell s = 0 also bumps the replica's counters). On the seg and delta
wires (``step_narrow``) each replica's own packed buffer is first
decoded into key and bank arrays (K12), once on each device of its
cells. Preload adds each
replica's whole share of the roster into every slice, one K11 call a
cell, and ORs the slices across dp. PFCOUNT takes the register max
across dp, then K1 on each slice, summed across sp.

JAX's collectives are XLA's; here they are host orchestration across
the grid: a min (AND) across sp inside a process, and across dp the OR
of the filter slices, the register max, the counters' sum and the
validity gather, which cross processes on a multi-process mesh
(``parallel.multihost``) over gloo, staged through host tensors. sp
never leaves a process. ``replica_sync="step"`` runs the register max
across dp after every step, ``"query"`` (the default) only when a
PFCOUNT or a state read needs it: max is associative, so the two are
observationally equal.

A mesh whose devices repeat one card (``make_mesh(..., devices=[cuda:0]
* 8)``, as the tests' ``["cpu"] * 8``) runs every slice program on 1/sp
of the state and every collective across those cells: the counterpart of
JAX's virtual CPU devices. The 1 x 1 mesh runs the single-card kernels
(K3, K2 and K2-seg/-delta, K4, K1) on the single-card state layout, as
JAX's ``_build_single_kernels`` does.

Telemetry (on when ``obs`` is live at construction): each replica's
events are a host counter (``attendance_shard_events{replica=}``, summed
over the live engines at scrape time), and with tracing each step adds
replica-labelled ``replica_dispatch`` spans under the active batch span.
Neither reads the card.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from attendance_tpu_torch.models.bloom import (
    BLOCK_BITS, BloomParams, bloom_packed_set_bits, derive_bloom_params)
from attendance_tpu_torch.models.fused import (
    SketchState, decode_counts, fused_step_bytes, fused_step_delta,
    fused_step_seg, fused_step_words, pack_bytes)
from attendance_tpu_torch.models.hll import estimate_from_histogram
from attendance_tpu_torch.ops import kernels


# Live engines the shard-event gauges sum over: sibling engines in one
# process add up per replica, and a dead engine is neither pinned by a
# gauge's closure nor reported.
_LIVE_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


class Mesh:
    """A (dp, sp) grid of ``torch.device``s, the rows this process holds:
    ``devices[r][s]`` is the cell of global replica ``first_replica +
    r``, shard s. In one process it holds every replica; on a
    multi-process mesh (``group`` set) the dp axis spans the group's
    processes and each holds its own replicas' rows."""

    def __init__(self, devices: Sequence[Sequence], *,
                 dp: Optional[int] = None, first_replica: int = 0,
                 group=None):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh needs equal, non-empty rows of devices")
        self.devices: List[List[torch.device]] = rows
        self.sp = len(rows[0])
        self.dp = len(rows) if dp is None else dp
        self.first_replica = first_replica
        self.group = group

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def multiprocess(self) -> bool:
        return self.group is not None


def make_mesh(num_shards: int = 1, num_replicas: int = 1,
              devices=None) -> Mesh:
    """A (dp=num_replicas, sp=num_shards) mesh over ``devices`` (default:
    every CUDA device of the process). An explicit list may repeat one
    device, e.g. ``["cpu"] * 8`` or ``[torch.device("cuda", 0)] * 8``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    need = num_shards * num_replicas
    if num_shards < 1 or num_replicas < 1 or len(devices) < need:
        raise ValueError(
            f"need {need} devices for dp={num_replicas} x sp={num_shards}, "
            f"have {len(devices)}")
    return Mesh([devices[r * num_shards:(r + 1) * num_shards]
                 for r in range(num_replicas)])


class ShardedSketchEngine:
    """Mesh-resident Bloom filter + HLL banks with the fused step.

    The multi-device counterpart of the single-card fused state: one
    Bloom filter (the roster) and ``num_banks`` HLL banks, laid out as
    the module docstring says. Batches are host arrays; the engine pads
    them (``padded_size``) and masks the padding.
    """

    def __init__(self, mesh: Mesh, capacity: int, error_rate: float,
                 num_banks: int = 64, precision: int = 14,
                 layout: str = "blocked",
                 params: Optional[BloomParams] = None,
                 replica_sync: str = "query"):
        if replica_sync not in ("step", "query"):
            raise ValueError(f"replica_sync must be 'step' or 'query', "
                             f"got {replica_sync!r}")
        if layout != "blocked":
            raise ValueError("the mesh engine is blocked-only: its slice "
                             "kernels need a key's probes in one block")
        self.mesh = mesh
        self.sp, self.dp = mesh.sp, mesh.dp
        self.replica_sync = replica_sync
        self.precision = precision
        self.params = params or derive_bloom_params(capacity, error_rate,
                                                    layout)
        # The ALLOCATION is padded to sp slices of whole blocks; the hash
        # modulus stays params.m_bits, so every key's probes (and every
        # answer) are the same on every mesh shape, and the pad words are
        # never addressed.
        chunk = self.sp * BLOCK_BITS
        self.m_alloc = -(-self.params.m_bits // chunk) * chunk
        self.m_words = self.m_alloc // 32
        self.m_regs = 1 << precision
        if self.m_regs % self.sp:
            raise ValueError(f"sp={self.sp} must divide {self.m_regs}")
        self.words_local = self.m_words // self.sp
        self.regs_local = self.m_regs // self.sp
        self.num_banks = num_banks
        self.single = self.sp * self.dp == 1
        self.device = mesh.devices[0][0]
        self.bits = [[torch.zeros(self.words_local, dtype=torch.int32,
                                  device=d) for d in row]
                     for row in mesh.devices]
        self.regs = [[self._zero_regs(num_banks, d) for d in row]
                     for row in mesh.devices]
        self.counts = [torch.zeros((2, 2), dtype=torch.int32, device=row[0])
                       for row in mesh.devices]
        # Per-replica event counters on the host: one numpy add a step,
        # read by callback gauges only when a scrape renders them, and
        # only kept while telemetry is live at construction.
        self.shard_events = np.zeros(self.dp, np.int64)
        from attendance_tpu_torch import obs
        t = obs.get()
        self._tracer = t.tracer if t is not None else None
        self._obs_enabled = t is not None
        if t is not None:
            _LIVE_ENGINES.add(self)
            for r in range(self.dp):
                t.registry.gauge(
                    "attendance_shard_events",
                    help="Events dispatched to each dp replica slice "
                    "(summed over live engines)",
                    replica=str(r)).set_function(
                        lambda r=r: sum(
                            int(e.shard_events[r])
                            for e in list(_LIVE_ENGINES) if r < e.dp))

    def _zero_regs(self, banks: int, device) -> torch.Tensor:
        return torch.zeros((banks, self.regs_local), dtype=torch.uint8,
                           device=device)

    def _state(self) -> SketchState:
        """The 1 x 1 mesh's state as the single-card kernels take it."""
        return SketchState(self.bits[0][0], self.regs[0][0], self.counts[0])

    def _rows(self):
        """(local row r, global replica g, devices) of this process."""
        first = self.mesh.first_replica
        return [(r, first + r, row) for r, row in enumerate(self.mesh.devices)]

    def _on_cells(self, arr: np.ndarray) -> Dict[torch.device, torch.Tensor]:
        """A host array on every distinct device of this process's cells
        (once per device: cells of one card share the copy)."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        out = {}
        for row in self.mesh.devices:
            for d in row:
                if d not in out:
                    out[d] = host.to(d)
        return out

    # -- cross-process legs of the collectives (gloo, host tensors) -----------
    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        host = t.cpu()
        dist.all_reduce(host, op=op, group=self.mesh.group)
        return host

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenation over the group's processes, in rank (= replica)
        order."""
        host = t.cpu().contiguous()
        parts = [torch.empty_like(host)
                 for _ in range(dist.get_world_size(self.mesh.group))]
        dist.all_gather(parts, host, group=self.mesh.group)
        return torch.cat(parts)

    # -- padded batches -----------------------------------------------------
    def padded_size(self, n: int) -> int:
        """Next power of two (min 256), rounded up to a dp multiple so the
        batch splits evenly across replicas (dp = 3 works)."""
        padded = 256
        while padded < n:
            padded *= 2
        return -(-padded // self.dp) * self.dp

    def _pad(self, arr: np.ndarray, fill, dtype) -> Tuple[np.ndarray, int]:
        n = len(arr)
        buf = np.full(self.padded_size(n), fill, dtype=dtype)
        buf[:n] = arr
        return buf, n

    # -- preload ------------------------------------------------------------
    def preload(self, keys) -> None:
        """Batched BF.ADD of the roster: global replica g adds its
        contiguous share ``keys[g * n // dp:(g + 1) * n // dp]`` into each
        of its slices with one K11 call a cell, then the slices are ORed
        across dp. The 1 x 1 mesh makes one K3 call over the whole
        roster, as one card does.

        The words equal the JAX engine's, which adds fixed chunks of
        2^14 keys (padded with a repeat of a key) and ORs across dp after
        each: OR is commutative, associative and idempotent, so neither
        the split into shares nor the padding changes the union, onto
        whatever the filter already holds; and no caller sees a
        replica's partial words, as preload returns only after the OR."""
        keys = np.asarray(keys, dtype=np.uint32)
        n = len(keys)
        if n == 0:
            return
        on = self._on_cells(keys.view(np.int32))
        if self.single:
            kernels.bloom_add(self.bits[0][0], on[self.device], self.params)
            return
        for r, g, row in self._rows():
            lo, hi = g * n // self.dp, (g + 1) * n // self.dp
            for s, d in enumerate(row):
                kernels.bloom_add_slice(
                    self.bits[r][s], on[d][lo:hi], self.params,
                    first_word=s * self.words_local)
        self._or_replicas()

    def _or_replicas(self) -> None:
        """Every replica's slice s := the OR of all replicas' slice s."""
        for s in range(self.sp):
            cells = [self.bits[r][s] for r in range(len(self.mesh.devices))]
            out = cells[0].clone()
            for c in cells[1:]:
                out |= c.to(out.device)
            if self.mesh.multiprocess:
                gathered = self._all_gather(out).view(-1, out.shape[0])
                out = gathered[0].clone()
                for part in gathered[1:]:
                    out |= part
            for c in cells:
                c.copy_(out.to(c.device))

    # -- telemetry ----------------------------------------------------------
    def _note_events(self, n: int, padded: int) -> None:
        """Attribute a batch's n real events to the contiguous dp slices
        that carry them."""
        if not self._obs_enabled:
            return
        local = padded // self.dp
        for r in range(self.dp):
            c = n - r * local
            if c <= 0:
                break
            self.shard_events[r] += min(c, local)

    def note_shard_events(self, lane_counts) -> None:
        """Attribute per-replica event counts packed outside the engine
        (the narrow wires pack each slice in the pipeline)."""
        if self._obs_enabled:
            self.shard_events += np.asarray(lane_counts, np.int64)

    def _trace_dispatch(self, wire: str, t0: float, n: Optional[int],
                        padded: int) -> None:
        """One ``replica_dispatch`` span per dp slice that carries real
        events (the launches are asynchronous: the span covers the host
        side). ``n`` None (the narrow wires) gives every replica a span
        with no events argument."""
        tr = self._tracer
        if tr is None:
            return
        t1 = time.perf_counter()
        cur = tr.current()
        trace_id = cur.trace_id if cur is not None else tr.new_id()
        parent = cur.span_id if cur is not None else None
        local = max(padded // self.dp, 1)
        for r in range(self.dp):
            args = {"replica": r, "wire": wire}
            if n is not None:
                c = n - r * local
                if c <= 0:
                    break
                args["events"] = min(c, local)
            tr.add_span("replica_dispatch", t0, t1, trace_id=trace_id,
                        parent_id=parent, role="sharded-engine",
                        args=args)

    # -- steps --------------------------------------------------------------
    def step_words(self, words: np.ndarray, n: int, kw: int) -> torch.Tensor:
        """Fused validate+count over the packed word wire: ``words``
        uint32, already padded (pad lanes all ones) to a dp multiple.
        Returns validity[:n] (bool)."""
        words = np.ascontiguousarray(words, dtype=np.uint32)
        if len(words) % self.dp:
            raise ValueError(f"{len(words)} words do not split over "
                             f"dp={self.dp}")
        self._note_events(n, len(words))
        t0 = time.perf_counter() if self._tracer is not None else 0.0
        if self.single:
            wire = torch.from_numpy(words.view(np.int32)).to(self.device)
            valid = fused_step_words(self._state(), wire, self.params, kw,
                                     self.precision)[:n]
        else:
            valid = self._step(words.view(np.int32), None, n, kw)
        self._trace_dispatch("word", t0, n, len(words))
        return valid

    def step(self, keys, bank_idx) -> torch.Tensor:
        """Fused validate+count for one batch of keys and bank ids (>= 0);
        returns validity[:n] (bool). The 1 x 1 mesh sends it as K2's
        bytes wire with 4-byte bank ids, whose all-ones field marks the
        padding as the arrays step's mask does."""
        keys = np.asarray(keys, dtype=np.uint32)
        bank_idx = np.asarray(bank_idx, dtype=np.int32)
        if len(bank_idx) and int(bank_idx.min()) < 0:
            raise ValueError("bank ids of real lanes must be >= 0")
        n = len(keys)
        padded = self.padded_size(n)
        self._note_events(n, padded)
        t0 = time.perf_counter() if self._tracer is not None else 0.0
        if self.single:
            buf = pack_bytes(keys, bank_idx, np.uint32, padded)
            wire = torch.from_numpy(buf).to(self.device)
            valid = fused_step_bytes(self._state(), wire, self.params, 4,
                                     self.precision)[:n]
        else:
            kbuf, n = self._pad(keys, 0, np.uint32)
            bbuf, _ = self._pad(bank_idx, -1, np.int32)
            valid = self._step(kbuf.view(np.int32), bbuf, n, 0)
        self._trace_dispatch("arrays", t0, n, padded)
        return valid

    def step_narrow(self, bufs: np.ndarray, mode: str, width: int,
                    padded_local: int) -> torch.Tensor:
        """Fused validate+count over the seg or delta wire (``mode``):
        ``bufs`` uint32[dp, words] holds one independently packed buffer
        per replica, each ``padded_local`` lanes of its contiguous slice
        of the frame, with a header of ``num_banks`` banks. Returns the
        validity of every lane (bool[dp * padded_local]) in packed
        per-slice order; the caller holds the pack permutations.

        The 1 x 1 mesh runs K2-seg or K2-delta on the single-card state.
        A larger mesh decodes replica g's buffer once on each distinct
        device of its cells (K12), then runs K9 on each cell and the AND
        across sp, and K10 with the decoded banks, its real lanes the
        header's total (cell s = 0 bumps the replica's counters)."""
        bufs = np.ascontiguousarray(bufs, dtype=np.uint32)
        if mode not in ("seg", "delta"):
            raise ValueError(f"narrow wire must be seg or delta, got {mode!r}")
        if bufs.ndim != 2 or bufs.shape[0] != self.dp:
            raise ValueError(f"bufs must be uint32[dp={self.dp}, words], "
                             f"got {bufs.shape}")
        nb = self.num_banks
        t0 = time.perf_counter() if self._tracer is not None else 0.0
        if self.single:
            step = fused_step_seg if mode == "seg" else fused_step_delta
            buf = torch.from_numpy(bufs[0].view(np.int32)).to(self.device)
            valid = step(self._state(), buf, self.params, width,
                         padded_local, nb, self.precision)
            self._trace_dispatch(mode, t0, None, self.dp * padded_local)
            return valid
        decode = kernels.decode_seg if mode == "seg" else kernels.decode_delta
        wkey = "kb" if mode == "seg" else "db"
        answers = []
        for r, g, row in self._rows():
            host = torch.from_numpy(bufs[g].view(np.int32))
            keys, banks = {}, {}
            for d in row:
                if d not in keys:
                    keys[d], banks[d] = decode(
                        host.to(d), padded=padded_local, num_banks=nb,
                        **{wkey: width})
            # The header's total: the slice's real lanes, packed first.
            n_real = min(int(bufs[g, :nb].sum(dtype=np.int64)), padded_local)
            valid = self._partial_and(r, row, keys, slice(None), 0)
            for s, d in enumerate(row):
                kernels.hll_add_slice(
                    self.regs[r][s], keys[d], valid.to(d),
                    lo=s * self.regs_local, precision=self.precision,
                    bank=banks[d], n_real=n_real,
                    counts=self.counts[r] if s == 0 else None)
            answers.append(valid)
        valid = self._gather_valid(answers).to(torch.bool)
        self._trace_dispatch(mode, t0, None, self.dp * padded_local)
        return valid

    def _gather_valid(self, answers: List[torch.Tensor]) -> torch.Tensor:
        """After a step: ``replica_sync="step"``'s register max, then the
        replicas' validity concatenated in replica order (across the
        processes of a multi-process mesh)."""
        if self.replica_sync == "step":
            self._sync_replicas()
        valid = torch.cat([a.to(self.device) for a in answers])
        if self.mesh.multiprocess:
            valid = self._all_gather(valid)
        return valid

    def _partial_and(self, r: int, row, lanes, sl: slice,
                     kw: int) -> torch.Tensor:
        """Replica row r's validity of lanes[sl]: K9 on each of its cells,
        ANDed across sp (JAX's pmin of {0, 1}), on its cell s = 0."""
        valid = None
        for s, d in enumerate(row):
            part = kernels.bloom_contains_slice(
                self.bits[r][s], lanes[d][sl], self.params,
                first_word=s * self.words_local, key_bits=kw)
            valid = part if valid is None else valid & part.to(valid.device)
        return valid

    def _step(self, lanes_np: np.ndarray, bank_np: Optional[np.ndarray],
              n: int, kw: int) -> torch.Tensor:
        local = len(lanes_np) // self.dp
        lanes = self._on_cells(lanes_np)
        banks = None if bank_np is None else self._on_cells(bank_np)
        answers = []
        for r, g, row in self._rows():
            sl = slice(g * local, (g + 1) * local)
            # The AND across sp comes before any add: a key another slice
            # rejects must not be counted.
            valid = self._partial_and(r, row, lanes, sl, kw)
            n_real = min(max(n - g * local, 0), local)
            for s, d in enumerate(row):
                kernels.hll_add_slice(
                    self.regs[r][s], lanes[d][sl], valid.to(d),
                    lo=s * self.regs_local, precision=self.precision,
                    bank=None if banks is None else banks[d][sl],
                    key_bits=kw, n_real=n_real,
                    counts=self.counts[r] if s == 0 else None)
            answers.append(valid)
        return self._gather_valid(answers)[:n].to(torch.bool)

    def _sync_replicas(self) -> None:
        """``replica_sync="step"``: every replica's registers := their max
        across dp."""
        for s in range(self.sp):
            merged = self._merged_slice(s, None)
            for r in range(len(self.mesh.devices)):
                self.regs[r][s].copy_(merged.to(self.regs[r][s].device))

    # -- queries and state ----------------------------------------------------
    def contains(self, keys) -> np.ndarray:
        """BF.EXISTS of host keys: bool[n] on the host."""
        keys = np.asarray(keys, dtype=np.uint32)
        kbuf, n = self._pad(keys, 0, np.uint32)
        if self.single:
            t = torch.from_numpy(kbuf.view(np.int32)).to(self.device)
            return kernels.bloom_contains(self.bits[0][0], t,
                                          self.params).cpu().numpy()[:n]
        local = len(kbuf) // self.dp
        lanes = self._on_cells(kbuf.view(np.int32))
        answers = [self._partial_and(r, row, lanes,
                                     slice(g * local, (g + 1) * local), 0)
                   .to(self.device) for r, g, row in self._rows()]
        valid = torch.cat(answers)
        if self.mesh.multiprocess:
            valid = self._all_gather(valid)
        return valid.cpu().numpy()[:n].astype(bool)

    def _merged_slice(self, s: int, rows: Optional[torch.Tensor]
                      ) -> torch.Tensor:
        """Slice s of the registers, max across every replica (of bank
        rows ``rows`` only, when given), on this process's first cell of
        shard s; contiguous."""
        d = self.mesh.devices[0][s]
        merged = None
        for r in range(len(self.mesh.devices)):
            x = self.regs[r][s]
            if rows is not None:
                x = x.index_select(0, rows.to(x.device))
            x = x.to(d)
            merged = x.clone() if merged is None else torch.maximum(merged, x)
        if self.mesh.multiprocess:
            merged = self._all_reduce(merged, dist.ReduceOp.MAX).to(d)
        return merged.contiguous()

    def _merged_regs(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Host uint8[banks, 2^p] of the registers merged across dp (bank
        rows ``rows`` only, when given)."""
        idx = (None if rows is None
               else torch.from_numpy(np.asarray(rows, dtype=np.int64)))
        return torch.cat([self._merged_slice(s, idx).cpu()
                          for s in range(self.sp)], dim=1).numpy()

    def _hist(self, bank: Optional[int] = None) -> np.ndarray:
        """int64[banks, q+2] register histograms (of one bank's row when
        given): the max across dp, then K1 on each slice, summed across
        sp. The histogram follows the union: the histogram of a max is
        not the max of histograms."""
        rows = None if bank is None else torch.tensor([bank])
        total = None
        for s in range(self.sp):
            h = kernels.hll_histogram(self._merged_slice(s, rows),
                                      self.precision).cpu().numpy()
            total = h.astype(np.int64) if total is None else total + h
        return total

    def validity_counts(self) -> Tuple[int, int]:
        """(valid, invalid) totals since construction (or the last
        set_counts): the replicas' two-lane counters, summed."""
        totals = np.zeros(2, np.int64)
        for c in self.counts:
            totals += np.asarray(decode_counts(c), np.int64)
        if self.mesh.multiprocess:
            totals = self._all_reduce(torch.from_numpy(totals),
                                      dist.ReduceOp.SUM).numpy()
        return int(totals[0]), int(totals[1])

    def get_counts(self) -> np.ndarray:
        """The totals in the snapshot encoding: uint32[2, 2] (lo, hi) rows
        (valid, invalid), restorable on any mesh shape or one card."""
        v, i = self.validity_counts()
        return np.array([[v & 0xFFFFFFFF, v >> 32],
                         [i & 0xFFFFFFFF, i >> 32]], dtype=np.uint32)

    def set_counts(self, counts) -> None:
        """Install snapshot totals: replica 0 carries them, the others
        restart at zero (totals are a sum over replicas)."""
        c = np.asarray(counts, dtype=np.uint32).reshape(2, 2).view(np.int32)
        for r, g, row in self._rows():
            self.counts[r] = (torch.from_numpy(c.copy()).to(row[0]) if g == 0
                              else torch.zeros((2, 2), dtype=torch.int32,
                                               device=row[0]))

    def _put_merged_regs(self, merged: np.ndarray) -> None:
        """Install merged registers uint8[banks, 2^p]: replica 0 carries
        them (cut into its slices), the others start at zero; equal under
        the max-union."""
        merged = np.asarray(merged, dtype=np.uint8)
        rl = self.regs_local
        for r, g, row in self._rows():
            self.regs[r] = [
                torch.from_numpy(np.ascontiguousarray(
                    merged[:, s * rl:(s + 1) * rl])).to(d) if g == 0
                else self._zero_regs(merged.shape[0], d)
                for s, d in enumerate(row)]

    def grow_banks(self, new_num_banks: int) -> None:
        """Bank growth: every cell's registers zero-extended to the new
        bank count (a fresh contiguous tensor per cell; register 0 is
        the max's identity, so no merge is needed)."""
        for r, row in enumerate(self.mesh.devices):
            for s, d in enumerate(row):
                grown = self._zero_regs(new_num_banks, d)
                grown[:self.num_banks] = self.regs[r][s]
                self.regs[r][s] = grown
        self.num_banks = new_num_banks

    def get_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host (packed bloom words, merged HLL banks). The words are
        UNPADDED (m_bits // 32): the allocation padding is never
        addressed, so snapshots restore across mesh shapes and to and
        from one card."""
        real = self.params.m_bits // 32
        bits = torch.cat([b.cpu() for b in self.bits[0]]).numpy()
        return bits[:real].view(np.uint32), self._merged_regs()

    def get_state_rows(self, bank_idx) -> np.ndarray:
        """Merged register rows of the given banks only (the delta
        capture): only those rows leave the devices."""
        return self._merged_regs(np.asarray(bank_idx, dtype=np.int64))

    def set_state(self, bits: np.ndarray, regs: np.ndarray) -> None:
        """Restore state from get_state (or one card, or the JAX
        package): the filter is cut into this mesh's slices with the
        padding zeroed, the registers carried by replica 0."""
        real = self.params.m_bits // 32
        if bits.shape != (real,):
            raise ValueError(
                f"snapshot bloom has {bits.shape[0]} words, engine "
                f"expects {real} (different capacity/layout?)")
        padded = np.zeros(self.m_words, dtype=np.uint32)
        padded[:real] = bits
        wl = self.words_local
        for r, row in enumerate(self.mesh.devices):
            self.bits[r] = [torch.from_numpy(
                padded[s * wl:(s + 1) * wl].view(np.int32).copy()).to(d)
                for s, d in enumerate(row)]
        self.num_banks = regs.shape[0]
        self._put_merged_regs(regs)

    def fill_fraction(self) -> float:
        """Set-bit fraction of the roster filter: the slices' popcounts
        summed across sp (the padding is zero), over m_bits."""
        set_bits = sum(int(bloom_packed_set_bits(b)) for b in self.bits[0])
        return set_bits / self.params.m_bits

    def count(self, bank: int) -> int:
        """PFCOUNT of one bank (Ertl's estimator over its histogram)."""
        return int(round(estimate_from_histogram(self._hist(bank)[0],
                                                 self.precision)))

    def count_all(self) -> np.ndarray:
        """PFCOUNT of every bank from one histogram pass."""
        return np.array([int(round(estimate_from_histogram(
            h, self.precision))) for h in self._hist()])
