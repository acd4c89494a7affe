"""The fused hot-loop step: validate (Bloom) + count (HLL) per frame.

Counterpart of ``attendance_tpu/models/fused.py`` (word, bytes, seg and
delta wires, with their numpy host packs). The reference's per-event
loop body (BF.EXISTS, then PFADD if valid) runs as ONE kernel call per
frame (K2, ``ops/kernels.fused_step``, ``fused_step_seg`` and
``fused_step_delta``); the only host traffic is the packed wire in and
the validity vector out.

State is three tensors, updated in place by each step where the JAX
step donated its input state:
  bloom_bits  int32[m_bits // 32]   packed filter (uint32 bit patterns)
  hll_regs    uint8[num_banks, 2^p] HLL register banks
  counts      int32[2, 2]           rows (valid, invalid), cols (lo, hi)
Their bytes equal the JAX ``SketchState``'s, so :func:`state_from_numpy`
and :func:`state_to_numpy` carry a state across the two packages.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from attendance_tpu_torch.models.bloom import (
    BloomParams, bloom_packed_init, derive_bloom_params)
from attendance_tpu_torch.models.hll import hll_init
from attendance_tpu_torch.ops import kernels


class SketchState(NamedTuple):
    """Device-resident sketch state threaded through the fused step."""
    bloom_bits: torch.Tensor  # int32[m_bits // 32], bit-packed
    hll_regs: torch.Tensor    # uint8[num_banks, 2^p]
    counts: torch.Tensor      # int32[2, 2]: 64-bit counters as (lo, hi)


def decode_counts(counts) -> Tuple[int, int]:
    """(valid, invalid) Python ints from the two-lane counters: a tensor,
    or their host copy (uint32 or int32 [2, 2])."""
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    a = np.asarray(counts).view(np.uint32).astype(np.uint64)
    return (int(a[0, 0] + (a[0, 1] << np.uint64(32))),
            int(a[1, 0] + (a[1, 1] << np.uint64(32))))


def init_state(capacity: int, error_rate: float, layout: str,
               num_banks: int, precision: int,
               device: torch.device) -> Tuple[SketchState, BloomParams]:
    params = derive_bloom_params(capacity, error_rate, layout)
    return SketchState(bloom_packed_init(params, device),
                       hll_init(num_banks, precision, device),
                       torch.zeros((2, 2), dtype=torch.int32,
                                   device=device)), params


def state_from_numpy(bloom_bits: np.ndarray, hll_regs: np.ndarray,
                     counts: np.ndarray, device: torch.device) -> SketchState:
    """A state from host arrays in the JAX ``SketchState`` dtypes
    (uint32 words, uint8 registers, uint32[2, 2] counters)."""
    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return SketchState(
        put(np.asarray(bloom_bits, np.uint32).view(np.int32), np.int32),
        put(hll_regs, np.uint8),
        put(np.asarray(counts, np.uint32).view(np.int32), np.int32))


def state_to_numpy(state: SketchState
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(uint32 words, uint8 registers, uint32[2, 2] counters) on the
    host, byte-equal to the JAX ``SketchState``'s arrays."""
    return (state.bloom_bits.cpu().numpy().view(np.uint32),
            state.hll_regs.cpu().numpy(),
            state.counts.cpu().numpy().view(np.uint32))


def snapshot_capture_rows(regs: torch.Tensor, bank_idx: torch.Tensor,
                          counts: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capture of a snapshot DELTA (B9): the register rows of the banks
    dirtied since the last barrier (``bank_idx``, int64, padded; callers
    drop the pad rows on the host) and a copy of the counters. Both are
    new tensors enqueued on the current stream, the stream that runs
    the fused steps: since the steps update ``regs`` and ``counts`` in
    place, the capture holds exactly the frames enqueued before it, and
    a reader that waits on an event recorded after it sees a
    consistent point while later steps run on. The rows are gathered by
    advanced indexing: on the card 4x faster than ``index_select`` over
    16 rows (PERF.md)."""
    return regs[bank_idx], counts.clone()


def snapshot_capture_base(regs: torch.Tensor, counts: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capture of a full base snapshot: copies of every register row and
    of the counters, on the current stream (see
    :func:`snapshot_capture_rows`)."""
    return regs.clone(), counts.clone()


def bank_wire_dtype(num_banks: int):
    """Smallest unsigned dtype for bank ids on the bytes wire; the
    dtype's max value is reserved as the padded-lane sentinel."""
    if num_banks <= 0xFF:
        return np.uint8
    if num_banks <= 0xFFFF:
        return np.uint16
    return np.uint32


def fused_step_bytes(state: SketchState, buf: torch.Tensor,
                     params: BloomParams, bank_itemsize: int,
                     precision: int = 14) -> torch.Tensor:
    """The step over ONE byte buffer, uint8[(4 + w) * B]: B little-endian
    uint32 keys, then B bank ids as uint{8w}, the dtype's max marking
    padded lanes. Updates ``state``'s registers and counters in place;
    returns valid: bool[B]."""
    return kernels.fused_step(state.bloom_bits, state.hll_regs,
                              state.counts, buf, params,
                              bank_bytes=bank_itemsize, precision=precision)


def fused_step_words(state: SketchState, words: torch.Tensor,
                     params: BloomParams, key_bits: int,
                     precision: int = 14) -> torch.Tensor:
    """The step over ONE uint32 word per event (int32 storage): the low
    ``key_bits`` bits are the key, the high ``32 - key_bits`` bits the
    bank id, the all-ones bank field marking padded lanes. Updates
    ``state``'s registers and counters in place; returns valid: bool[B]."""
    return kernels.fused_step(state.bloom_bits, state.hll_regs,
                              state.counts, words, params, bank_bytes=0,
                              key_bits=key_bits, precision=precision)


def pack_words(keys, banks, key_bits: int, padded: int) -> np.ndarray:
    """Host-side pack: uint32[padded] of ``bank << key_bits | key`` with
    all-ones words on the padding lanes. A real bank id equal to the
    all-ones bank field would read as padding, so it raises."""
    n = len(keys)
    if n:
        sentinel = (1 << (32 - key_bits)) - 1
        if int(np.max(banks)) >= sentinel:
            raise ValueError(
                f"pack_words: bank id >= {sentinel} collides with the "
                f"padding sentinel at key_bits={key_bits} (bank field "
                f"is {32 - key_bits} bits)")
    out = np.empty(padded, np.uint32)
    np.left_shift(np.asarray(banks, np.uint32), np.uint32(key_bits),
                  out=out[:n])
    np.bitwise_or(out[:n], np.asarray(keys, np.uint32), out=out[:n])
    out[n:] = 0xFFFFFFFF
    return out


def pack_bytes(keys, banks, bank_dtype, padded: int) -> np.ndarray:
    """Host-side pack of the bytes wire consumed by
    :func:`fused_step_bytes`: uint8[(4 + w) * padded], zero keys and the
    dtype's all-ones sentinel on padding lanes."""
    n = len(keys)
    w = np.dtype(bank_dtype).itemsize
    out = np.empty((4 + w) * padded, np.uint8)
    kv = out[:4 * padded].view(np.uint32)
    kv[:n] = keys
    kv[n:] = 0
    bv = out[4 * padded:].view(bank_dtype)
    bv[:n] = banks  # caller guarantees all < num_banks <= sentinel
    bv[n:] = np.iinfo(bank_dtype).max
    return out


# ---------------------------------------------------------------------------
# Segmented bit-packed wire: kb bits/event, banks carried as segment counts
# ---------------------------------------------------------------------------

SEG_GUARD_WORDS = 2  # bitstream tail slack so packers may write whole words


def seg_buf_words(num_banks: int, kb: int, padded: int) -> int:
    """uint32 length of the segmented wire buffer:
    [counts u32[num_banks] | bitstream ceil(padded*kb/32) | guard]."""
    return num_banks + (padded * kb + 31) // 32 + SEG_GUARD_WORDS


def delta_buf_words(num_banks: int, db: int, padded: int) -> int:
    """uint32 length of the delta wire buffer:
    [counts u32[num_banks] | base keys u32[num_banks] |
     bitstream ceil(padded*db/32) | guard]."""
    return 2 * num_banks + (padded * db + 31) // 32 + SEG_GUARD_WORDS


def fused_step_seg(state: SketchState, buf: torch.Tensor,
                   params: BloomParams, kb: int, padded: int,
                   num_banks: int, precision: int = 14) -> torch.Tensor:
    """The step over the segmented wire: ONE uint32 vector (int32
    storage) of per-bank event counts, then a little-endian bitstream of
    ``kb`` bits per event, events stably sorted by bank, zero bits on
    padding lanes. The bank id never crosses the link: lane i's bank is
    the segment holding i. Updates ``state``'s registers and counters in
    place; returns valid: bool[padded], in packed (bank-sorted) order."""
    return kernels.fused_step_seg(state.bloom_bits, state.hll_regs,
                                  state.counts, buf, params, kb=kb,
                                  padded=padded, num_banks=num_banks,
                                  precision=precision)


def fused_step_delta(state: SketchState, buf: torch.Tensor,
                     params: BloomParams, db: int, padded: int,
                     num_banks: int, precision: int = 14) -> torch.Tensor:
    """The step over the delta wire: per-bank counts, per-bank base
    (smallest) keys, then ``db``-bit gaps between consecutive keys of
    each bank segment (events sorted by (bank, key)). A key is its
    bank's base plus the segment's prefix sum of gaps, exact under
    uint32 wraparound. Updates ``state`` in place; returns valid:
    bool[padded], in packed order."""
    return kernels.fused_step_delta(state.bloom_bits, state.hll_regs,
                                    state.counts, buf, params, db=db,
                                    padded=padded, num_banks=num_banks,
                                    precision=precision)


def _or_stream(buf: np.ndarray, vals: np.ndarray, width: int,
               base: int) -> None:
    """OR ``width``-bit values into ``buf``'s little-endian bitstream
    starting at word ``base``. Adjacent lanes may share words; lanes
    ``stride`` apart never do (stride * width >= 64 bits), so strided
    fancy-index ORs see unique indices and vectorize."""
    n = len(vals)
    pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    w0 = (pos >> np.uint64(5)).astype(np.int64) + base
    v = vals.astype(np.uint64) << (pos & np.uint64(31))  # <= 63 bits
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    stride = -(-64 // max(width, 1))
    for s in range(stride):
        buf[w0[s::stride]] |= lo[s::stride]
        buf[w0[s::stride] + 1] |= hi[s::stride]


def pack_seg(keys, banks, kb: int, padded: int, num_banks: int):
    """Host-side numpy pack of the segmented wire: (buf, perm), ``perm``
    mapping packed lane -> original event index (stable within each
    bank, so rows with equal primary keys keep their append order). A
    key wider than ``kb`` bits would spill into the next lane, so it
    raises (the native packer returns -3)."""
    n = len(keys)
    banks = np.asarray(banks)
    perm = np.argsort(banks, kind="stable").astype(np.uint32)
    counts = np.bincount(banks, minlength=num_banks).astype(np.uint32)
    buf = np.zeros(seg_buf_words(num_banks, kb, padded), np.uint32)
    buf[:num_banks] = counts
    if n:
        keys_u32 = np.asarray(keys, np.uint32)
        if kb < 32 and int(keys_u32.max()) >> kb:
            raise ValueError(
                f"pack_seg: key exceeds {kb}-bit width "
                f"(max key {int(keys_u32.max())})")
        _or_stream(buf, keys_u32[perm], kb, num_banks)
    return buf, perm


def pick_delta_width(hint: int, needed: int) -> int:
    """Wire width for a frame whose widest sorted-key gap needs
    ``needed`` bits: at least the monotonic ``hint``, rounded up to even
    so frame-to-frame jitter of the widest gap moves the width rarely.
    The one definition for the native and the numpy pack."""
    return min(32, (max(hint, needed) + 1) // 2 * 2)


def delta_scan(keys, banks, num_banks: int):
    """Sort by (bank, key) keeping append order on ties, and compute the
    per-event deltas the wire carries: (perm, counts, bases, deltas,
    needed_bits). numpy version of the native ``atp_delta_scan``."""
    n = len(keys)
    keys = np.asarray(keys, np.uint32)
    banks = np.asarray(banks)
    perm = np.lexsort((np.arange(n), keys, banks)).astype(np.uint32)
    counts = np.bincount(banks, minlength=num_banks).astype(np.uint32)
    sk = keys[perm]
    deltas = np.empty(n, np.uint32)
    if n:
        deltas[0] = 0
        np.subtract(sk[1:], sk[:-1], out=deltas[1:])
    starts = np.cumsum(counts) - counts
    bases = np.zeros(num_banks, np.uint32)
    nz = counts > 0
    bases[nz] = sk[starts[nz]]
    deltas[starts[nz]] = 0  # segment firsts ride in the base header
    needed = int(deltas.max()).bit_length() if n else 1
    return perm, counts, bases, deltas, max(needed, 1)


def pack_delta(keys, banks, db: int, padded: int, num_banks: int,
               scan=None):
    """Host-side numpy pack of the delta wire: (buf, perm), or (None,
    None) when the frame's widest delta needs more than ``db`` bits.
    ``scan`` reuses a :func:`delta_scan` result (native or numpy)."""
    perm, counts, bases, deltas, needed = (
        scan if scan is not None else delta_scan(keys, banks, num_banks))
    if needed > db:
        return None, None
    buf = np.zeros(delta_buf_words(num_banks, db, padded), np.uint32)
    buf[:num_banks] = counts
    buf[num_banks:2 * num_banks] = bases
    if len(keys):
        _or_stream(buf, np.asarray(deltas, np.uint32), db, 2 * num_banks)
    return buf, perm
