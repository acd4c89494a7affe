"""Wrappers of the hand-written CUDA kernels, with their plain versions.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream and
adds one to its entry in :data:`launches` per launch. A tensor on the CPU
goes to the kernel's plain PyTorch version (the same arithmetic, used by
the CPU tests and as the comparison on the card); a CUDA tensor launches
the kernel or raises. The kernels live in ``csrc/sketch_kernels.cu`` and
are built on first use (``ops/build.py``).

Bounds below are for one H100 SXM (3.35 TB/s device memory).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from attendance_tpu_torch.models.bloom import (
    BLOCK_BITS, BloomParams, bloom_add_packed_plain, bloom_add_plain,
    bloom_contains_plain, bloom_contains_words, bloom_positions,
    pack_bloom_bits, unpack_bloom_bits)
from attendance_tpu_torch.models import cms, hll
from attendance_tpu_torch.ops.build import library
from attendance_tpu_torch.ops.murmur3 import MASK32, as_u32, to_i32

# Kernel launches since the last reset_launches(), by wrapper name.
launches = {"hll_histogram": 0, "fused_step": 0, "fused_step_seg": 0,
            "fused_step_delta": 0, "bloom_add": 0, "bloom_contains": 0,
            "hll_add": 0, "cms_step": 0, "bloom_add_bytes": 0,
            "bloom_contains_bytes": 0, "hll_histogram_rows": 0,
            "hll_union_histogram": 0, "bloom_pack_bytes": 0,
            "bloom_contains_slice": 0, "hll_add_slice": 0,
            "bloom_add_slice": 0, "decode_seg": 0, "decode_delta": 0}


# The __global__ functions of csrc/sketch_kernels.cu that one call of each
# wrapper of :data:`launches` may launch (a path a plan picks, a pass of
# two): what a profiler trace's device kernel events are named after.
_BLOOM_ADD_KERNELS = ("bloom_add_keys_kernel", "bloom_tile_count_kernel",
                      "bloom_tile_scatter_kernel", "bloom_tile_or_kernel")
KERNEL_FUNCTIONS = {
    "hll_histogram": ("hll_histogram_kernel",),
    "hll_histogram_rows": ("hll_histogram_kernel",),
    "hll_union_histogram": ("hll_union_histogram_kernel",),
    "fused_step": ("fused_step_kernel",),
    "fused_step_seg": ("fused_step_kernel",),
    "fused_step_delta": ("fused_step_kernel", "delta_sums_kernel"),
    "decode_seg": ("decode_seg_kernel",),
    "decode_delta": ("decode_delta_scan_kernel", "decode_lanes_kernel",
                     "delta_sums_kernel"),
    "bloom_add": _BLOOM_ADD_KERNELS,
    "bloom_add_slice": _BLOOM_ADD_KERNELS,
    "bloom_contains": ("bloom_contains_kernel",),
    "hll_add": ("hll_add_kernel",),
    "cms_step": ("cms_update_kernel", "cms_query_kernel"),
    "bloom_add_bytes": ("bloom_add_bytes_kernel", "bloom_add_partial_kernel",
                        "bloom_merge_partials_kernel"),
    "bloom_contains_bytes": ("bloom_contains_bytes_kernel",
                             "bloom_pack_bytes_kernel",
                             "bloom_contains_image_kernel",
                             "bloom_contains_kernel"),
    "bloom_pack_bytes": ("bloom_pack_bytes_kernel",),
    "bloom_contains_slice": ("bloom_contains_slice_kernel",
                             "bloom_contains_slice_compact_kernel"),
    "hll_add_slice": ("hll_add_slice_kernel",),
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        _require(t.device == dev, f"tensors on {dev} and {t.device}")
        _require(t.is_contiguous(), "kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


# ---------------------------------------------------------------------------
# K1: register-value histogram
# ---------------------------------------------------------------------------

def hll_histogram(regs: torch.Tensor, precision: int = 14) -> torch.Tensor:
    """int32[num_banks, q+2] register-value histogram of uint8 banks.

    Replaces the Pallas kernel ``hll_histogram_pallas``
    (attendance_tpu/ops/pallas_kernels.py:398; ``_hist_kernel`` :373),
    which compared the whole [num_banks, 2^p] block against each of the
    q+2 values in VMEM. Bound: bytes — every register byte is read once
    (16 banks at p=14: 256 KB in, about 0.08 us at 3.35 TB/s; 1024
    banks: 16 MiB, 5.1 us). Design: one CTA per bank issues its 16-byte
    loads before counting; every thread counts into its own shared-memory
    counter per value ([value][thread], 64 KB, so no two lanes of a warp
    share an address) with shared atomics whose results it does not wait
    for, then a warp per value sums its row of counters into the output.
    One shared atomic per byte is what bounds it at large bank counts;
    at small ones the launch and one trip to memory. Any bank count
    works (no 128-bank split as on the TPU), including a row slice at a
    16-byte-aligned offset, as ``count()`` passes. A bank split over a
    thread-block cluster was slower at every bank count measured
    (PERF.md).

    ``regs`` may also be one mesh cell's register slice,
    ``uint8[num_banks, 2^precision / sp]`` (``parallel/sharded.py``):
    any width that divides ``2^precision`` and is a multiple of 16 (the
    kernel reads a row as 16-byte vectors). The bins stay those of
    ``precision``, so the slices' histograms sum to the whole banks'.
    """
    _require(regs.dtype == torch.uint8 and regs.dim() == 2,
             f"regs must be uint8[num_banks, m], got {regs.dtype} "
             f"{tuple(regs.shape)}")
    width = regs.shape[1]
    _require(4 <= precision <= 18 and width >= 16 and width % 16 == 0
             and (1 << precision) % width == 0,
             f"regs width {width} must be 2^{precision} or a slice of it: "
             f"a divisor of 2^{precision} that is a multiple of 16")
    if regs.device.type == "cpu":
        return hll.hll_histogram(regs, precision)
    _require_cuda(regs)
    _require(regs.data_ptr() % 16 == 0, "regs must be 16-byte aligned")
    num_bins = 64 - precision + 2
    out = torch.empty((regs.shape[0], num_bins), dtype=torch.int32,
                      device=regs.device)
    if regs.shape[0] == 0:
        return out
    with torch.cuda.device(regs.device):
        rc = library().atp_hll_histogram(
            regs.data_ptr(), out.data_ptr(), regs.shape[0], regs.shape[1],
            num_bins, _stream(regs))
    _check_launch(rc, "atp_hll_histogram")
    launches["hll_histogram"] += 1
    return out


def _check_rows(regs: torch.Tensor, rows: torch.Tensor,
                precision: int) -> None:
    _require(regs.dtype == torch.uint8 and regs.dim() == 2
             and 4 <= precision <= 18 and regs.shape[1] == 1 << precision,
             f"regs must be uint8[num_banks, 2^{precision}]")
    _require(rows.dtype == torch.int32 and rows.dim() == 1,
             "rows must be int32[R]")
    _require(rows.shape[0] == 0 or regs.shape[0] >= 1,
             "rows of an empty bank array")


def hll_histogram_rows(regs: torch.Tensor, rows: torch.Tensor,
                       precision: int = 14) -> torch.Tensor:
    """int32[R, q+2] register-value histograms of banks ``rows``
    (int32[R], any order, repeats allowed; a row outside the bank range
    is clamped into it, as a JAX gather clamps).

    Replaces the generic store's XLA gather and histogram
    (``TpuSketchStore.pfcount_many``, attendance_tpu/sketch/
    tpu_store.py:102-124: ``regs[known]`` then ``best_histogram``) and
    ``HyperLogLog.count``'s row slice (attendance_tpu/models/
    hll.py:354-361). Bound: bytes, each listed row read once (1,024 rows
    at p = 14: 16 MiB, 5.0 us at 3.35 TB/s). Design: K1's body (one CTA
    per listed bank) with CTA b reading bank ``rows[b]``, so no gathered
    copy of the rows is made: one load of the row index before K1's
    loads.
    """
    _check_rows(regs, rows, precision)
    if regs.device.type == "cpu" and rows.device.type == "cpu":
        return hll.hll_histogram_rows_plain(regs, rows, precision)
    _require_cuda(regs, rows)
    _require(regs.data_ptr() % 16 == 0, "regs must be 16-byte aligned")
    num_bins = 64 - precision + 2
    out = torch.empty((rows.shape[0], num_bins), dtype=torch.int32,
                      device=regs.device)
    if rows.shape[0] == 0:
        return out
    with torch.cuda.device(regs.device):
        rc = library().atp_hll_histogram_rows(
            regs.data_ptr(), regs.shape[0], regs.shape[1], rows.data_ptr(),
            rows.shape[0], num_bins, out.data_ptr(), _stream(regs))
    _check_launch(rc, "atp_hll_histogram_rows")
    launches["hll_histogram_rows"] += 1
    return out


def hll_union_histogram(regs: torch.Tensor, rows: torch.Tensor,
                        precision: int = 14) -> torch.Tensor:
    """int32[q+2] register-value histogram of the register max over
    banks ``rows`` (int32[R], R >= 1, clamped as in
    :func:`hll_histogram_rows`): the multi-key PFCOUNT's histogram.

    Replaces ``HyperLogLog.count_union``'s XLA ``hll_merge`` chain and
    histogram (attendance_tpu/models/hll.py:363-372). Bound: bytes, each
    listed row read once (2 rows: 32 KB; 1,024 rows: 16 MiB, 5.0 us at
    3.35 TB/s). Design: a grid over slices of 128 registers (128 CTAs at
    p = 14, never one CTA per union, which would put all rows through
    one SM); in a CTA each thread owns one 16-byte vector of the slice
    and 32 thread groups split the rows, keeping per-byte maxima
    (``__vmaxu4``) with four rows' loads in flight; the maxima meet in
    shared memory, are counted into shared bins, and each CTA adds its
    bins to the output with global atomics (the entry point zeroes the
    output first). One wrapper call is one launch in :data:`launches`.
    """
    _check_rows(regs, rows, precision)
    _require(rows.shape[0] >= 1, "a union of no rows")
    if regs.device.type == "cpu" and rows.device.type == "cpu":
        return hll.hll_union_histogram_plain(regs, rows, precision)
    _require_cuda(regs, rows)
    _require(regs.data_ptr() % 16 == 0, "regs must be 16-byte aligned")
    num_bins = 64 - precision + 2
    out = torch.empty(num_bins, dtype=torch.int32, device=regs.device)
    with torch.cuda.device(regs.device):
        rc = library().atp_hll_union_histogram(
            regs.data_ptr(), regs.shape[0], regs.shape[1], rows.data_ptr(),
            rows.shape[0], num_bins, out.data_ptr(), _stream(regs))
    _check_launch(rc, "atp_hll_union_histogram")
    launches["hll_union_histogram"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: packed Bloom preload
# ---------------------------------------------------------------------------

# K3 cuts the filter into about this many tiles (4 per SM of an H100), of
# at most 2^9 blocks (32 KB of shared memory) each, and hands each CTA of
# its count and scatter passes between _K3_MIN_CHUNK and _K3_MAX_CHUNK
# keys, in about _K3_CTAS CTAs (8 per SM) where that allows.
_K3_TILES = 528
_K3_MAX_LOG2_BLOCKS = 9
_K3_MIN_CHUNK = 2048
_K3_MAX_CHUNK = 8192
_K3_CTAS = 1056
# Below this many keys K3 runs one thread per key (see bloom_add).
K3_BINNED_MIN_KEYS = 1 << 18


def bloom_add_plan(n: int, num_blocks: int):
    """(log2 blocks per tile, keys per CTA, scratch int32 words) of K3
    for ``n`` keys into ``num_blocks`` 64-byte blocks, and of K11 for
    ``n`` keys into a slice of ``num_blocks`` blocks (its tiles cover the
    slice; the payload holds every key, as when all lie in the slice)."""
    per_tile = -(-num_blocks // _K3_TILES)
    log2_bpt = min(_K3_MAX_LOG2_BLOCKS, (per_tile - 1).bit_length())
    tiles = -(-num_blocks // (1 << log2_bpt))
    chunk = min(_K3_MAX_CHUNK, max(_K3_MIN_CHUNK, -(-n // _K3_CTAS)))
    ctas = -(-n // chunk)
    # totals[tiles], starts[tiles + 1], counts[ctas * tiles],
    # offsets[ctas * tiles], payload[n] (csrc/sketch_kernels.cu, K3).
    return log2_bpt, chunk, 2 * tiles + 1 + 2 * ctas * tiles + n


def bloom_add(words: torch.Tensor, keys: torch.Tensor,
              params: BloomParams, *, binned: Optional[bool] = None) -> None:
    """OR every key's k probe bits into the packed filter, in place.

    Replaces the XLA program of ``bloom_add_packed`` /
    ``packed_or_scatter`` (attendance_tpu/models/bloom.py:223-271): XLA
    has no OR-scatter, so JAX sorted the probe words, OR-scanned runs of
    equal words and scattered each run once. Bound: bytes — read the
    keys once and read and write the touched words (100k roster: 0.4 MB
    of keys, 138 KB of filter; 10M: 40 MB and 13.8 MB). Design: k global
    ``atomicOr``s per key run at the card's L2 atomic rate, so a large
    batch is binned by filter tile (``bloom_add_plan``): a count pass
    reserves each CTA's range per tile with one global atomic per (CTA,
    tile), a scatter pass sorts each CTA's keys by tile in shared memory
    and writes each tile's run (the key's block and probe offsets) to
    its range of a scratch buffer, and one CTA per tile ORs its keys'
    bits into a shared-memory copy of the tile and writes the tile back
    with 16-byte stores: a memset and three kernels. Those passes cost a
    fixed chain of launches and scans that a small batch does not repay,
    so the wrapper picks by batch size: below ``K3_BINNED_MIN_KEYS``
    (2^18) keys one thread per key issues one global ``atomicOr`` per
    distinct word of its block (about 6.5 of k = 8); ``binned`` forces
    one path. Either is one launch in :data:`launches`. OR is
    order-free, so the words equal the sort/segment scheme's exactly,
    onto whatever the filter already holds. The filter must start
    64-byte aligned.
    """
    _require(words.dtype == torch.int32 and words.dim() == 1
             and words.shape[0] == params.m_bits // 32,
             f"words must be int32[{params.m_bits // 32}]")
    _require(keys.dtype == torch.int32 and keys.dim() == 1,
             "keys must be int32[B] (uint32 bit patterns)")
    if words.device.type == "cpu" and keys.device.type == "cpu":
        bloom_add_packed_plain(words, keys, params)
        return
    _require_cuda(words, keys)
    _require(params.layout == "blocked",
             "the preload kernel implements the blocked layout only")
    _require(words.data_ptr() % 64 == 0, "words must be 64-byte aligned")
    n = keys.shape[0]
    if n == 0:
        return
    num_blocks = params.m_bits // BLOCK_BITS
    if binned is None:
        binned = n >= K3_BINNED_MIN_KEYS
    log2_bpt, chunk, scratch_words = bloom_add_plan(n, num_blocks)
    scratch = (torch.empty(scratch_words, dtype=torch.int32,
                           device=words.device) if binned else None)
    with torch.cuda.device(words.device):
        rc = library().atp_bloom_add(
            words.data_ptr(), keys.data_ptr(), n, num_blocks, params.k,
            log2_bpt, chunk, None if scratch is None else scratch.data_ptr(),
            _stream(words))
    _check_launch(rc, "atp_bloom_add")
    launches["bloom_add"] += 1


# ---------------------------------------------------------------------------
# K2: the fused step (word and bytes wires)
# ---------------------------------------------------------------------------

def _unpack_lanes(wire: torch.Tensor, bank_bytes: int, key_bits: int):
    """(keys, bank) int64 lanes of one wire buffer; bank -1 = padding."""
    if bank_bytes == 0:
        u = as_u32(wire)
        keys = u & ((1 << key_bits) - 1)
        field = u >> key_bits  # logical: u is non-negative
        sentinel = (1 << (32 - key_bits)) - 1
    else:
        lanes = wire.shape[0] // (4 + bank_bytes)
        keys = as_u32(wire[:4 * lanes].view(torch.int32))
        raw = wire[4 * lanes:]
        if bank_bytes == 1:
            field = raw.to(torch.int64)
        elif bank_bytes == 2:
            field = raw.view(torch.int16).to(torch.int64) & 0xFFFF
        else:
            field = as_u32(raw.view(torch.int32))
        sentinel = (1 << (8 * bank_bytes)) - 1
    # Bank ids are int32 on both sides: a field >= 2^31 reads negative.
    bank = torch.where(field == sentinel, -1, field - ((field >> 31) << 32))
    return keys, bank


def _bump_counts(counts: torch.Tensor, nv: torch.Tensor,
                 ni: torch.Tensor) -> None:
    """Add (nv, ni) to the int32[2, 2] (lo, hi) counters with carry, in
    place (the JAX ``_bump_counts`` returned new counters)."""
    c = as_u32(counts)
    lo = c[:, 0] + torch.stack([nv, ni]).to(torch.int64)
    hi = (c[:, 1] + (lo >> 32)) & MASK32
    counts.copy_(to_i32(torch.stack([lo & MASK32, hi], dim=1)))


def _step_tail_plain(bloom: torch.Tensor, regs: torch.Tensor,
                     counts: torch.Tensor, keys: torch.Tensor,
                     bank: torch.Tensor, params: BloomParams,
                     precision: int) -> torch.Tensor:
    """What every wire's step does after its decode: Bloom probe, HLL
    add for valid real lanes (bank >= 0), counter bump; returns valid."""
    valid = bloom_contains_words(bloom, keys, params)
    hll.hll_add_plain(regs, torch.where(valid, bank, -1), keys,
                      precision=precision)
    real = bank >= 0
    nv = (valid & real).sum()
    _bump_counts(counts, nv, real.sum() - nv)
    return valid


def fused_step_plain(bloom: torch.Tensor, regs: torch.Tensor,
                     counts: torch.Tensor, wire: torch.Tensor,
                     params: BloomParams, bank_bytes: int, key_bits: int,
                     precision: int) -> torch.Tensor:
    """Plain version of K2: unpack, Bloom probe, HLL add for valid real
    lanes, counter bump. Updates ``regs`` and ``counts`` in place and
    returns valid: bool[lanes]."""
    keys, bank = _unpack_lanes(wire, bank_bytes, key_bits)
    return _step_tail_plain(bloom, regs, counts, keys, bank, params,
                            precision)


def _check_step_state(bloom: torch.Tensor, regs: torch.Tensor,
                      counts: torch.Tensor, params: BloomParams,
                      precision: int) -> None:
    _require(bloom.dtype == torch.int32
             and bloom.shape == (params.m_bits // 32,),
             f"bloom must be int32[{params.m_bits // 32}]")
    _require(regs.dtype == torch.uint8 and regs.dim() == 2
             and regs.shape[1] == 1 << precision,
             f"regs must be uint8[num_banks, 2^{precision}]")
    _require(counts.dtype == torch.int32 and counts.shape == (2, 2),
             "counts must be int32[2, 2]")
    _require(params.layout == "blocked", "the fused step is blocked-only")


def _require_step_cuda(wire: torch.Tensor, bloom: torch.Tensor,
                       regs: torch.Tensor, counts: torch.Tensor) -> None:
    _require_cuda(wire, bloom, regs, counts)
    _require(wire.data_ptr() % 4 == 0 and regs.data_ptr() % 4 == 0
             and counts.data_ptr() % 8 == 0,
             "wire and regs must be 4-byte and counts 8-byte aligned")
    _require(bloom.data_ptr() % 64 == 0, "bloom must be 64-byte aligned")


def fused_step(bloom: torch.Tensor, regs: torch.Tensor,
               counts: torch.Tensor, wire: torch.Tensor,
               params: BloomParams, *, bank_bytes: int, key_bits: int = 0,
               precision: int = 14) -> torch.Tensor:
    """One frame through the hot loop: valid = BF.EXISTS per lane, then
    PFADD of valid real lanes and the (valid, invalid) counter bump.
    ``regs`` and ``counts`` are updated in place (JAX donated them).

    ``bank_bytes == 0`` is the word wire (int32[lanes] of
    ``bank << key_bits | key``); 1, 2 or 4 is the bytes wire
    (uint8[(4 + bank_bytes) * lanes]: keys, then bank ids).

    Replaces the XLA programs ``fused_step_words`` and
    ``fused_step_bytes`` (attendance_tpu/models/fused.py:175,123). Bound:
    bytes at the frame's scale — the wire is read once, the k probes of
    a lane share one 64-byte filter block (the 100k-roster filter, 138
    KB, stays in L2) and a valid lane touches one register. Design: one
    thread per lane over a full grid. Each key's 64-byte filter block is
    read once: the four lanes of a quad load one block together (16
    bytes each, so the filter must start 64-byte aligned), a warp stages
    its 32 blocks in shared memory, and each lane tests its k bits there
    (a scalar probe reads k words, each warp-wide load touching 32 cache
    lines). The register max is a 32-bit ``atomicCAS`` loop on the word
    holding the byte (CUDA has no 8-bit atomic max) that writes nothing
    when the register already holds the rank; counts are warp ballots
    summed per CTA and added with one 64-bit atomic per CTA.
    """
    _require(bank_bytes in (0, 1, 2, 4), f"bank_bytes {bank_bytes}")
    if bank_bytes == 0:
        _require(wire.dtype == torch.int32 and 1 <= key_bits <= 31,
                 "word wire must be int32 with 1 <= key_bits <= 31")
        lanes = wire.shape[0]
    else:
        _require(wire.dtype == torch.uint8
                 and wire.shape[0] % (4 + bank_bytes) == 0,
                 f"bytes wire must be uint8[(4 + {bank_bytes}) * lanes]")
        lanes = wire.shape[0] // (4 + bank_bytes)
    _require(wire.dim() == 1, "wire must be 1-D")
    _check_step_state(bloom, regs, counts, params, precision)
    tensors = (wire, bloom, regs, counts)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_step_plain(bloom, regs, counts, wire, params,
                                bank_bytes, key_bits, precision)
    _require_step_cuda(*tensors)
    valid = torch.empty(lanes, dtype=torch.bool, device=wire.device)
    if lanes == 0:
        return valid
    with torch.cuda.device(wire.device):
        rc = library().atp_fused_step(
            wire.data_ptr(), bank_bytes, key_bits, lanes, bloom.data_ptr(),
            params.m_bits // BLOCK_BITS, params.k, regs.data_ptr(),
            regs.shape[0], precision, counts.data_ptr(), valid.data_ptr(),
            _stream(wire))
    _check_launch(rc, "atp_fused_step")
    launches["fused_step"] += 1
    return valid


# ---------------------------------------------------------------------------
# K2-seg and K2-delta: the fused step over the narrow wires
# ---------------------------------------------------------------------------

def _stream_lanes(u: torch.Tensor, base: int, width: int, padded: int):
    """(fields, lane index) of lanes 0..padded-1 of the ``width``-bit
    little-endian bitstream starting at word ``base`` of ``u`` (uint32
    values in int64 lanes). A field spans at most two words; the second
    is masked off when the field starts a word, as in the JAX decode."""
    lane = torch.arange(padded, dtype=torch.int64, device=u.device)
    bit = lane * width
    w0 = base + (bit >> 5)
    sh = bit & 31
    lo = u[w0] >> sh
    hi = torch.where(sh == 0, 0, (u[w0 + 1] << ((32 - sh) & 31)) & MASK32)
    return (lo | hi) & ((1 << width) - 1), lane


def _segments(counts: torch.Tensor, lane: torch.Tensor):
    """(bank with -1 on padding, bank with 0 on padding, the banks'
    exclusive starts) of each lane, from the per-bank counts: a lane's
    bank is ``searchsorted(ends, lane, right=True)``, so runs of empty
    banks go to the next non-empty one; lanes at or past the total are
    padding."""
    ends = torch.cumsum(counts, 0)
    bank = torch.searchsorted(ends, lane, right=True)
    real = lane < ends[-1]
    return (torch.where(real, bank, -1), torch.where(real, bank, 0),
            ends - counts)


def decode_seg_lanes_plain(buf: torch.Tensor, kb: int, padded: int,
                           num_banks: int):
    """Plain decode of the seg wire (JAX ``decode_seg_lanes``,
    attendance_tpu/models/fused.py:292): (keys, bank) int64 lanes, bank
    -1 on padding."""
    u = as_u32(buf)
    keys, lane = _stream_lanes(u, num_banks, kb, padded)
    bank, _, _ = _segments(u[:num_banks], lane)
    return keys, bank


def decode_delta_lanes_plain(buf: torch.Tensor, db: int, padded: int,
                             num_banks: int):
    """Plain decode of the delta wire (JAX ``decode_delta_lanes``,
    attendance_tpu/models/fused.py:416): key = bases[b] + c[i] - c[s-1]
    with c the frame-wide cumsum of the deltas mod 2^32 (an int64 sum of
    at most 2^31 values below 2^32 cannot overflow; it is masked after
    the sum), s the segment's start and c[-1] = 0; padding lanes take
    bank 0's base and prefix. (keys, bank) int64 lanes, bank -1 on
    padding."""
    u = as_u32(buf)
    deltas, lane = _stream_lanes(u, 2 * num_banks, db, padded)
    bank, bank_c, starts = _segments(u[:num_banks], lane)
    c = torch.cumsum(deltas, 0) & MASK32
    s = starts[bank_c]
    before = torch.where(s == 0, 0, c[(s - 1).clamp(min=0)])
    keys = (u[num_banks:2 * num_banks][bank_c] + c - before) & MASK32
    return keys, bank


def fused_step_seg_plain(bloom: torch.Tensor, regs: torch.Tensor,
                         counts: torch.Tensor, buf: torch.Tensor,
                         params: BloomParams, kb: int, padded: int,
                         num_banks: int, precision: int) -> torch.Tensor:
    """Plain version of K2-seg: the seg decode, then K2's plain tail."""
    keys, bank = decode_seg_lanes_plain(buf, kb, padded, num_banks)
    return _step_tail_plain(bloom, regs, counts, keys, bank, params,
                            precision)


def fused_step_delta_plain(bloom: torch.Tensor, regs: torch.Tensor,
                           counts: torch.Tensor, buf: torch.Tensor,
                           params: BloomParams, db: int, padded: int,
                           num_banks: int, precision: int) -> torch.Tensor:
    """Plain version of K2-delta: the delta decode, then K2's plain
    tail."""
    keys, bank = decode_delta_lanes_plain(buf, db, padded, num_banks)
    return _step_tail_plain(bloom, regs, counts, keys, bank, params,
                            precision)


# The narrow wires' kernels scan the header's counts in shared memory
# (4 bytes a bank per CTA, at most 227 KB with K2's own 17 KB).
NARROW_MAX_BANKS = 1 << 15


def delta_scratch_words(padded: int) -> int:
    """int32 scratch of K2-delta, which its first pass writes whole on
    every call: the delta sum of each tile of 256 lanes, then of each
    group of 8 tiles."""
    tiles = -(-padded // 256)
    return tiles + -(-tiles // 8)


def _check_narrow_wire(name: str, buf: torch.Tensor, width: int,
                       padded: int, num_banks: int) -> None:
    """The checks of a seg (``name`` "seg") or delta wire buffer."""
    # Imported here: models.fused builds its steps on this module.
    from attendance_tpu_torch.models.fused import (
        delta_buf_words, seg_buf_words)

    words = (seg_buf_words if name == "seg" else delta_buf_words)(
        num_banks, width, padded)
    _require(1 <= width <= 32, f"{name} width {width} not in 1..32")
    _require(num_banks >= 1 and 1 <= padded < 1 << 31,
             f"{name} wire needs num_banks >= 1 and 1 <= padded < 2^31")
    _require(buf.dtype == torch.int32 and buf.dim() == 1
             and buf.shape[0] == words,
             f"{name} wire must be int32[{words}] (uint32 words)")


def _narrow_step(name: str, bloom: torch.Tensor, regs: torch.Tensor,
                 counts: torch.Tensor, buf: torch.Tensor,
                 params: BloomParams, width: int, padded: int,
                 num_banks: int, precision: int) -> torch.Tensor:
    """The shared wrapper of K2-seg (``name`` "seg") and K2-delta."""
    _check_narrow_wire(name, buf, width, padded, num_banks)
    _check_step_state(bloom, regs, counts, params, precision)
    tensors = (buf, bloom, regs, counts)
    if all(t.device.type == "cpu" for t in tensors):
        plain = (fused_step_seg_plain if name == "seg"
                 else fused_step_delta_plain)
        return plain(bloom, regs, counts, buf, params, width, padded,
                     num_banks, precision)
    _require_step_cuda(*tensors)
    _require(num_banks <= NARROW_MAX_BANKS,
             f"{name} kernel takes at most {NARROW_MAX_BANKS} header banks")
    valid = torch.empty(padded, dtype=torch.bool, device=buf.device)
    head = (buf.data_ptr(), width, padded, num_banks)
    tail = (bloom.data_ptr(), params.m_bits // BLOCK_BITS, params.k,
            regs.data_ptr(), regs.shape[0], precision, counts.data_ptr(),
            valid.data_ptr(), _stream(buf))
    with torch.cuda.device(buf.device):
        if name == "seg":
            rc = library().atp_fused_step_seg(*head, *tail)
        else:
            sums = torch.empty(delta_scratch_words(padded),
                               dtype=torch.int32, device=buf.device)
            rc = library().atp_fused_step_delta(*head, sums.data_ptr(),
                                                *tail)
    _check_launch(rc, f"atp_fused_step_{name}")
    launches[f"fused_step_{name}"] += 1
    return valid


def fused_step_seg(bloom: torch.Tensor, regs: torch.Tensor,
                   counts: torch.Tensor, buf: torch.Tensor,
                   params: BloomParams, *, kb: int, padded: int,
                   num_banks: int, precision: int = 14) -> torch.Tensor:
    """K2 over the seg wire: ``buf`` int32[seg_buf_words(num_banks, kb,
    padded)] is [per-bank counts | kb-bit little-endian key bitstream,
    lanes sorted by bank | 2 guard words]; ``num_banks`` is the header's
    length (the register rows when it was packed; the registers may have
    grown since, and a bank past ``regs`` is dropped). Updates ``regs``
    and ``counts`` in place; returns valid: bool[padded] in packed order,
    padding lanes (key 0) included, as the JAX step does.

    Replaces the XLA program ``fused_step_seg`` with
    ``decode_seg_lanes`` (attendance_tpu/models/fused.py:261,292). Bound:
    K2's, with kb/8 bytes of wire per lane instead of 4 and the decode's
    few integer operations added; at a 131,072-lane frame the operations
    (hash and probe) outweigh the bytes (chip_smoke.py). Design: one
    launch, K2's body with a seg decode. Each CTA issues its lanes' key
    loads (two words and a funnel shift per key), scans the header's
    counts in shared memory (``cta_exclusive_scan``; 4 bytes a bank, so
    at most ``NARROW_MAX_BANKS``) and finds its lanes' banks there:
    lanes are sorted by bank, so two threads search the banks of the
    tile's first and last lane and each lane searches only between them
    (none when they are equal, as at the main path's frame, 8,192 lanes
    a bank against 256 a CTA).
    """
    return _narrow_step("seg", bloom, regs, counts, buf, params, kb, padded,
                        num_banks, precision)


def fused_step_delta(bloom: torch.Tensor, regs: torch.Tensor,
                     counts: torch.Tensor, buf: torch.Tensor,
                     params: BloomParams, *, db: int, padded: int,
                     num_banks: int, precision: int = 14) -> torch.Tensor:
    """K2 over the delta wire: ``buf`` int32[delta_buf_words(num_banks,
    db, padded)] is [per-bank counts | per-bank base keys | db-bit key
    deltas, lanes sorted by (bank, key) | 2 guard words]. Updates
    ``regs`` and ``counts`` in place; returns valid: bool[padded] in
    packed order, padding lanes included (their key is bank 0's base
    plus the frame's whole delta sum, as in the JAX decode).

    Replaces the XLA program ``fused_step_delta`` with
    ``decode_delta_lanes`` (attendance_tpu/models/fused.py:386,416).
    Bound: as K2-seg's, at db/8 bytes of wire per lane. Design: a key is
    its bank's base plus the inclusive segmented scan of the deltas (a
    segment per bank; a padding lane takes bank 0's base plus the
    frame-wide prefix). Two launches: a pass writes every 256-lane
    tile's delta sum and every 8-tile group's into an int32 scratch
    (``delta_scratch_words``), then K2's body runs with a delta decode
    that waits on no other CTA: each CTA finds its lanes' banks and
    heads as K2-seg does, scans its tile, and adds, for the lanes before
    its first head, the sum from its segment's head (the head tile's
    lanes from the wire, then whole tiles and groups from the sums; one
    load per thread, all issued together). The step is launched as a
    programmatic dependent of the pass, so its scan of the counts and
    its loads overlap the pass. A single pass with decoupled look-back
    (ticket, status words, memset) was slower on an H100 at 1,048,576
    lanes than a frame-wide prefix in three pre-passes, and this design
    faster than both at every shape measured (PERF.md).
    """
    return _narrow_step("delta", bloom, regs, counts, buf, params, db,
                        padded, num_banks, precision)


# ---------------------------------------------------------------------------
# K12: a narrow wire's lanes alone, for the mesh engine
# ---------------------------------------------------------------------------

# The K12 kernels read a header of at most this many banks from registers,
# a longer one from shared memory (csrc/sketch_kernels.cu, SmallHeader).
K12_SMALL_HEADER = 32
# K12-seg's CTA is 256 threads of 2 consecutive lanes each below this many
# lanes, of 4 from it (measured on an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md).
K12_SEG_WIDE_MIN_LANES = 3 << 17
# K12-delta's designs (see decode_delta_plan), and where the look-back
# takes over from the two-pass design under a header of one bank or of
# K12_SMALL_HEADER + 1 to K12_TWO_PASS_MAX_BANKS banks (PERF.md).
K12_DELTA_DESIGNS = ("two_pass", "lookback")
K12_LOOKBACK_MIN_LANES = 1 << 18
K12_TWO_PASS_MAX_BANKS = 256
# The look-back's CTA: 256 threads of 4 consecutive lanes each; its
# scratch: 4 int32 state words, then 32 bytes of status a CTA.
K12_LOOKBACK_THREADS = 256
K12_LOOKBACK_LANES_PER_THREAD = 4
_LOOKBACK_STATE_WORDS = 4


class DeltaDecodePlan(NamedTuple):
    """How K12-delta decodes a frame: ``design`` "lookback" (one launch)
    or "two_pass" (K2-delta's sums pass, then the decode as its
    dependent); its CTAs; and the int32 scratch words it reads (the
    two-pass's sums, made anew each call; the look-back's state and
    status, kept per device)."""
    design: str
    ctas: int
    scratch_words: int


def k12_seg_lanes_per_thread(lanes: int) -> int:
    """K12-seg's lanes a thread for a frame of ``lanes`` lanes."""
    return 4 if lanes >= K12_SEG_WIDE_MIN_LANES else 2


def decode_delta_plan(lanes: int, num_banks: int, *,
                      design: Optional[str] = None) -> DeltaDecodePlan:
    """K12-delta's design for ``lanes`` (padded) lanes under a header of
    ``num_banks`` banks: the look-back, except below
    ``K12_LOOKBACK_MIN_LANES`` lanes under a header of one bank (every
    tile's segment runs back to lane 0) or of ``K12_SMALL_HEADER`` + 1
    to ``K12_TWO_PASS_MAX_BANKS`` banks (each CTA scans the header in
    shared memory), where the two-pass design is faster when the frame
    holds padding lanes (PERF.md). ``design`` forces one. Raises on a
    shape the kernels do not take: no lanes, 2^31 lanes or more, or a
    header of no banks or of more than ``NARROW_MAX_BANKS``."""
    _require(1 <= lanes < 1 << 31,
             f"K12-delta takes 1 <= lanes < 2^31, got {lanes}")
    _require(1 <= num_banks <= NARROW_MAX_BANKS,
             f"K12-delta takes 1 to {NARROW_MAX_BANKS} header banks, got "
             f"{num_banks}")
    if design is None:
        two_pass = lanes < K12_LOOKBACK_MIN_LANES and (
            num_banks == 1
            or K12_SMALL_HEADER < num_banks <= K12_TWO_PASS_MAX_BANKS)
        design = "two_pass" if two_pass else "lookback"
    _require(design in K12_DELTA_DESIGNS,
             f"unknown K12-delta design {design!r}")
    if design == "two_pass":
        return DeltaDecodePlan("two_pass", -(-lanes // 256),
                               delta_scratch_words(lanes))
    ctas = -(-lanes // (K12_LOOKBACK_THREADS
                        * K12_LOOKBACK_LANES_PER_THREAD))
    return DeltaDecodePlan("lookback", ctas,
                           _LOOKBACK_STATE_WORDS + 8 * ctas)


# The look-back's scratch, kept per device: its status words carry the
# call's epoch, so it is zeroed only when it is made or grown. Calls on
# one device share it, so they run one at a time (one stream's order, as
# the mesh engine calls them).
_lookback_scratch: dict = {}


def _lookback_state(device: torch.device, words: int) -> torch.Tensor:
    have = _lookback_scratch.get(device)
    if have is None or have.numel() < words:
        have = torch.zeros(words, dtype=torch.int32, device=device)
        _lookback_scratch[device] = have
    return have


def _decode_lanes(name: str, buf: torch.Tensor, width: int, padded: int,
                  num_banks: int, design: Optional[str] = None):
    """The shared wrapper of K12-seg (``name`` "seg") and K12-delta."""
    _check_narrow_wire(name, buf, width, padded, num_banks)
    plan = (decode_delta_plan(padded, num_banks, design=design)
            if name == "delta" else None)
    if buf.device.type == "cpu":
        plain = (decode_seg_lanes_plain if name == "seg"
                 else decode_delta_lanes_plain)
        keys, bank = plain(buf, width, padded, num_banks)
        return to_i32(keys), bank.to(torch.int32)
    _require_cuda(buf)
    _require(num_banks <= NARROW_MAX_BANKS,
             f"{name} kernel takes at most {NARROW_MAX_BANKS} header banks")
    keys = torch.empty(padded, dtype=torch.int32, device=buf.device)
    bank = torch.empty(padded, dtype=torch.int32, device=buf.device)
    with torch.cuda.device(buf.device):
        if name == "seg":
            rc = library().atp_decode_seg(
                buf.data_ptr(), width, padded, num_banks,
                k12_seg_lanes_per_thread(padded), keys.data_ptr(),
                bank.data_ptr(), _stream(buf))
        else:
            lookback = plan.design == "lookback"
            scratch = (_lookback_state(buf.device, plan.scratch_words)
                       if lookback else
                       torch.empty(plan.scratch_words, dtype=torch.int32,
                                   device=buf.device))
            rc = library().atp_decode_delta(
                buf.data_ptr(), width, padded, num_banks, int(lookback),
                scratch.data_ptr(), keys.data_ptr(), bank.data_ptr(),
                _stream(buf))
    _check_launch(rc, f"atp_decode_{name}")
    launches[f"decode_{name}"] += 1
    return keys, bank


def decode_seg(buf: torch.Tensor, *, kb: int, padded: int,
               num_banks: int):
    """K12-seg: (keys, bank) int32[padded] of the seg wire ``buf`` (K2-seg's
    buffer): the real lanes first, in packed (bank-sorted) order; a
    padding lane has the key its bits hold (0 as packed) and bank -1.

    Replaces ``decode_seg_lanes`` (attendance_tpu/models/fused.py:292) in
    B12's ``make_step_narrow`` (attendance_tpu/parallel/sharded.py:446),
    where each mesh device decodes its replica's buffer. Bound: bytes, the
    wire (the header and kb bits a lane) read once and 8 bytes a lane
    written (0.22 us at a (4, 2) replica's 65,536 lanes; what costs there
    is a launch and one trip to memory). Design: one launch of CTAs of
    256 threads, each decoding 2 consecutive lanes (4 from
    ``K12_SEG_WIDE_MIN_LANES``): their fields from at most 3 (5) words,
    their keys and banks stored as one 8-byte (16-byte) vector each. A
    header of at most ``K12_SMALL_HEADER`` banks is read by every warp
    into registers and searched with shuffles (no shared memory, no
    barrier); a longer one, up to ``NARROW_MAX_BANKS``, is scanned by
    each CTA into shared memory. The lanes a thread trade the header's
    cost, paid once a CTA, against each thread's serial work (PERF.md).
    """
    return _decode_lanes("seg", buf, kb, padded, num_banks)


def decode_delta(buf: torch.Tensor, *, db: int, padded: int,
                 num_banks: int, design: Optional[str] = None):
    """K12-delta: (keys, bank) int32[padded] of the delta wire ``buf``
    (K2-delta's buffer), as :func:`decode_seg`; a padding lane's key is
    bank 0's base plus the frame's delta prefix, as in the JAX decode.

    Replaces ``decode_delta_lanes`` (attendance_tpu/models/fused.py:416)
    in ``make_step_narrow`` (attendance_tpu/parallel/sharded.py:446).
    Bound: bytes, the wire (two header words a bank and db bits a lane)
    read once and 8 bytes a lane written (0.20 us at 65,536 lanes); a key
    is its bank's base plus a segmented prefix sum of the deltas, so the
    cost is the chain that carries each tile's sum to the next. Design
    (:func:`decode_delta_plan`; ``design`` forces one): the look-back, one
    launch of CTAs of 256 threads of 4 consecutive lanes: each CTA scans
    its tile in registers, with shuffles and across its warps, publishes
    the tile's sums in a scratch kept per device (status words tagged
    with the call's epoch, so nothing is zeroed between calls), then
    sums the tiles back to the nearest bank head (warp 0, 32 tiles a
    trip; the whole CTA past that) and, for a tile with padding lanes,
    every earlier tile's plain sum; or K2-delta's two-pass decode (a sums
    pass, then the decode as its programmatic dependent). One launch in
    :data:`launches` either way.
    """
    return _decode_lanes("delta", buf, db, padded, num_banks, design)


# ---------------------------------------------------------------------------
# K4: blocked BF.EXISTS from the packed words
# ---------------------------------------------------------------------------

def bloom_contains(words: torch.Tensor, keys: torch.Tensor,
                   params: BloomParams) -> torch.Tensor:
    """Blocked-layout BF.EXISTS of int32[B] keys (uint32 bit patterns)
    against the packed int32[m_bits // 32] filter: bool[B], any B.

    Replaces both Pallas probes, ``bloom_contains_packed``
    (attendance_tpu/ops/pallas_kernels.py:197), which read a transposed
    uint32[16, nb->128k] VMEM table with tiled lane-gathers, and
    ``bloom_contains_hbm`` (:340), which DMAed a 128-lane row of 8
    blocks per key from an HBM uint32[ceil(nb/8), 128] table; and the
    XLA probe of the temporal window add (fast_path.py:999). Those
    tables were TPU layouts (a one-tile lane-gather limit, 128-lane DMA
    alignment); the packed words already hold each block's 16 words
    contiguously, so the kernel reads them in place. Bound: bytes, at
    4B in, B out and 64 bytes per distinct block touched (a 131,072-key
    batch against the 100k-roster filter's 138 KB: about 0.24 us at
    3.35 TB/s), or operations, about B x (3 x 20 + 5k) integer ops
    (0.20 us at 67 TOP/s). Design: one thread per key, through K2's
    warp-wide probe (each block read once, by the four lanes of a quad,
    into shared memory; so the words must start 64-byte aligned): the
    two cannot disagree.
    """
    _require(params.layout == "blocked",
             "the blocked probe requires the blocked layout (as the Pallas "
             "probes did); use models.bloom.bloom_contains_words for flat")
    _require(words.dtype == torch.int32
             and words.shape == (params.m_bits // 32,),
             f"words must be int32[{params.m_bits // 32}]")
    _require(keys.dtype == torch.int32 and keys.dim() == 1,
             "keys must be int32[B] (uint32 bit patterns)")
    if words.device.type == "cpu" and keys.device.type == "cpu":
        return bloom_contains_words(words, keys, params)
    _require_cuda(words, keys)
    _require(words.data_ptr() % 64 == 0, "words must be 64-byte aligned")
    out = torch.empty(keys.shape[0], dtype=torch.bool, device=keys.device)
    if keys.shape[0] == 0:
        return out
    with torch.cuda.device(words.device):
        rc = library().atp_bloom_contains(
            words.data_ptr(), params.m_bits // BLOCK_BITS, params.k,
            keys.data_ptr(), keys.shape[0], out.data_ptr(), _stream(words))
    _check_launch(rc, "atp_bloom_contains")
    launches["bloom_contains"] += 1
    return out


# ---------------------------------------------------------------------------
# K5: windowed PFADD
# ---------------------------------------------------------------------------

def hll_add(regs: torch.Tensor, bank: torch.Tensor, keys: torch.Tensor,
            valid: Optional[torch.Tensor] = None,
            precision: int = 14) -> None:
    """Max each lane's HLL rank into ``regs[bank, bucket]``, in place
    (JAX donated the registers). ``bank`` int32[B]: -1 or a bank past
    the array drops the lane; ``keys`` int32[B] (uint32 bit patterns);
    ``valid`` an optional bool[B] that masks lanes (K4's answer on the
    window add).

    Replaces the ``hll_add`` half of the XLA program ``_t_add``
    (attendance_tpu/pipeline/fast_path.py:991-1004), an XLA scatter-max
    into the shared register array. Bound: bytes, at 9B in plus one
    read and one write of each distinct register a kept lane touches
    (a 131,072-lane window add: about 0.4 us at 3.35 TB/s), or
    operations, about B x 5 + kept x 50 (two murmur3 lanes and the rank
    per kept lane). Design: all lanes fit in one wave of the card, so the
    time is the launch and one thread's chain of memory trips: one
    thread per lane loads its valid byte, bank and key together (one
    trip), hashes in registers, reads the register's 32-bit word and
    only if the rank is higher swaps it with an ``atomicCAS`` loop (CUDA
    has no 8-bit atomic max). 2 or 4 lanes per thread, a warp match that
    folds lanes on one word, and a first CAS on an assumed zero word were
    measured and not kept (PERF.md).
    """
    _require(regs.dtype == torch.uint8 and regs.dim() == 2
             and 4 <= precision <= 18 and regs.shape[1] == 1 << precision,
             f"regs must be uint8[num_banks, 2^{precision}]")
    _require(bank.dtype == torch.int32 and keys.dtype == torch.int32
             and bank.dim() == keys.dim() == 1
             and bank.shape == keys.shape,
             "bank and keys must be int32[B]")
    _require(valid is None or (valid.dtype == torch.bool
                               and valid.shape == keys.shape),
             "valid must be bool[B]")
    tensors = (regs, bank, keys) + (() if valid is None else (valid,))
    if all(t.device.type == "cpu" for t in tensors):
        hll.hll_add_plain(regs, bank, keys, valid, precision)
        return
    _require_cuda(*tensors)
    _require(regs.data_ptr() % 4 == 0, "regs must be 4-byte aligned")
    if keys.shape[0] == 0:
        return
    with torch.cuda.device(regs.device):
        rc = library().atp_hll_add(
            regs.data_ptr(), regs.shape[0], precision, bank.data_ptr(),
            keys.data_ptr(), None if valid is None else valid.data_ptr(),
            keys.shape[0], _stream(regs))
    _check_launch(rc, "atp_hll_add")
    launches["hll_add"] += 1


# ---------------------------------------------------------------------------
# K6: Count-Min update, then query
# ---------------------------------------------------------------------------

def cms_step(counts: torch.Tensor, keys: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count-Min update of ``counts`` int32[depth, width] (uint32 bits)
    in place with every unmasked lane of ``keys`` int32[B], then each
    lane's estimate against the updated counts: est int32[B] (uint32
    bits), masked lanes 0.

    Replaces the XLA program ``cms_step`` (attendance_tpu/models/
    cms.py:116: ``cms_update`` :91, a uint32 scatter-add, then
    ``cms_query`` :107, a gather and a min over rows). Bound: bytes, at
    9B in, 4B out and one read and one write of each distinct counter
    touched (131,072 keys into 4 x 16384 counters: about 0.7 us at
    3.35 TB/s), or operations, about B x depth x 25. Design: one thread per
    lane hashes it per row; the update adds with a 32-bit
    ``atomicAdd`` (wraps at 2^32 as XLA does; duplicates each count);
    the query must see the whole batch, so it is a second launch in
    stream order from the same C entry point. One wrapper call counts
    one launch. The update is bound by L2 atomic throughput: one
    cooperative launch with a grid barrier, and a programmatic-dependent
    launch pair, were measured on an H100 and neither beat this pair in
    every case (PERF.md).
    """
    _require(counts.dtype == torch.int32 and counts.dim() == 2
             and counts.shape[0] >= 1 and counts.shape[1] >= 1,
             "counts must be int32[depth, width]")
    _require(keys.dtype == torch.int32 and keys.dim() == 1,
             "keys must be int32[B] (uint32 bit patterns)")
    _require(mask is None or (mask.dtype == torch.bool
                              and mask.shape == keys.shape),
             "mask must be bool[B]")
    tensors = (counts, keys) + (() if mask is None else (mask,))
    if all(t.device.type == "cpu" for t in tensors):
        return cms.cms_step_plain(counts, keys, mask)
    _require_cuda(*tensors)
    est = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
    if keys.shape[0] == 0:
        return est
    with torch.cuda.device(counts.device):
        rc = library().atp_cms_step(
            counts.data_ptr(), counts.shape[0], counts.shape[1],
            keys.data_ptr(), None if mask is None else mask.data_ptr(),
            keys.shape[0], est.data_ptr(), _stream(counts))
    _check_launch(rc, "atp_cms_step")
    launches["cms_step"] += 1
    return est


# ---------------------------------------------------------------------------
# K7 and K8: the byte-per-bit Bloom filter of the generic sketch store
# ---------------------------------------------------------------------------

# The image paths hold the filter's packed bit image (m_bits / 8 bytes)
# whole in a CTA's dynamic shared memory (csrc/sketch_kernels.cu).
BYTES_IMAGE_MAX_BYTES = 225 * 1024
# From this many keys K8 (by layout) and K7 take their image paths
# (measured on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md); below, one
# thread per key on the bytes.
K8_IMAGE_MIN_KEYS = {"flat": 1 << 17, "blocked": 1 << 15}
K7_IMAGE_MIN_KEYS = 1 << 16
# K7's image path sets bits in at most this many partial images (16 and
# 64 were slower at the 90,000-key preload on the same card, PERF.md).
K7_IMAGE_PARTS = 32


class BytesPlan(NamedTuple):
    """How K7 or K8 runs a batch: through the packed image or directly on
    the bytes, and the int32 scratch words the wrapper allocates (the
    image path's: K8's image, ``m_bits / 32`` words, or K7's partial
    images, ``K7_IMAGE_PARTS`` times that; 0 on the direct path)."""
    image: bool
    scratch_words: int


def bloom_bytes_plan(n: int, m_bits: int, layout: str, *, add: bool = False,
                     image: Optional[bool] = None) -> BytesPlan:
    """The path of K7 (``add``) or K8 for ``n`` keys against a
    byte-per-bit filter of ``m_bits`` bits in ``layout``: the image path
    from ``K7_IMAGE_MIN_KEYS`` / ``K8_IMAGE_MIN_KEYS[layout]`` keys when
    the packed image fits in shared memory, the direct path otherwise.
    ``image`` forces a path (an image that does not fit raises)."""
    _require(layout in ("flat", "blocked"), f"unknown Bloom layout {layout!r}")
    # Whole 16-byte vectors of image (every derived filter is whole
    # 512-bit blocks).
    fits = m_bits % 128 == 0 and m_bits // 8 <= BYTES_IMAGE_MAX_BYTES
    if image is None:
        image = fits and n >= (K7_IMAGE_MIN_KEYS if add
                               else K8_IMAGE_MIN_KEYS[layout])
    _require(fits or not image,
             f"a {m_bits}-bit filter's image does not fit in shared memory")
    if not image:
        return BytesPlan(False, 0)
    return BytesPlan(True, m_bits // 32 * (K7_IMAGE_PARTS if add else 1))


def _check_bytes_filter(bits: torch.Tensor, keys: torch.Tensor,
                        params: BloomParams) -> None:
    _require(params.layout in ("flat", "blocked"),
             f"unknown Bloom layout {params.layout!r}")
    _require(bits.dtype == torch.uint8 and bits.shape == (params.m_bits,),
             f"bits must be uint8[{params.m_bits}]")
    _require(keys.dtype == torch.int32 and keys.dim() == 1,
             "keys must be int32[B] (uint32 bit patterns)")


def bloom_add_bytes(bits: torch.Tensor, keys: torch.Tensor,
                    params: BloomParams,
                    mask: Optional[torch.Tensor] = None, *,
                    image: Optional[bool] = None) -> None:
    """Set the k probe bytes of every key (every key whose ``mask`` is
    True) of int32[B] ``keys`` in the byte-per-bit filter
    uint8[m_bits], in place, flat or blocked layout.

    Replaces the XLA program ``bloom_add`` (attendance_tpu/models/
    bloom.py:143; jitted in sketch/tpu_store.py:59-66 over batches
    padded to a power of two, which the port does not pad). Bound: bytes,
    4 B of key a lane and a 32-byte sector per distinct probe written (the
    90,000-key roster into the 958,976-byte flat filter: about 0.3 us at
    3.35 TB/s), or operations, about B x (2 x 20 + 8k) integer ops (3 x
    20 blocked). Two paths (``bloom_bytes_plan``; ``image`` forces one),
    each one launch in :data:`launches`:

    * direct, for a small batch: one thread per key stores byte 1 at
      each probe (racing stores write the same value, so no atomic). The
      flat probe ``(h1 + j * h2) mod m`` wraps in 32-bit arithmetic
      before the modulo, which is a multiply-high with a precomputed
      magic. At scale its scattered byte stores, about 21 to a 32-byte
      sector, bind it in L2.
    * image: two passes. Up to ``K7_IMAGE_PARTS`` CTAs (one per 1,024
      keys) each set their share of the keys' bits in a zeroed packed
      image in shared memory (``m_bits / 8`` bytes) with shared atomics
      and store it as a partial image in an int32 scratch; the second
      pass, a programmatic dependent, ORs the partials of each 128-bit
      image vector and rewrites the matching 128 filter bytes once,
      coalesced: new bits to byte 1, every other byte kept. A single
      cluster of 8 or 16 CTAs ORing its images through distributed
      shared memory was slower (PERF.md). The filter must start 16-byte
      aligned.
    """
    _check_bytes_filter(bits, keys, params)
    _require(mask is None or (mask.dtype == torch.bool
                              and mask.shape == keys.shape),
             "mask must be bool[B]")
    tensors = (bits, keys) + (() if mask is None else (mask,))
    if all(t.device.type == "cpu" for t in tensors):
        bloom_add_plain(bits, keys, params, mask)
        return
    _require_cuda(*tensors)
    n = keys.shape[0]
    plan = bloom_bytes_plan(n, params.m_bits, params.layout, add=True,
                            image=image)
    _require(not plan.image or bits.data_ptr() % 16 == 0,
             "bits must be 16-byte aligned")
    if n == 0:
        return
    scratch = (torch.empty(plan.scratch_words, dtype=torch.int32,
                           device=bits.device) if plan.image else None)
    with torch.cuda.device(bits.device):
        rc = library().atp_bloom_add_bytes(
            bits.data_ptr(), params.m_bits, params.k,
            int(params.layout == "blocked"), keys.data_ptr(),
            None if mask is None else mask.data_ptr(), n, K7_IMAGE_PARTS,
            None if scratch is None else scratch.data_ptr(), _stream(bits))
    _check_launch(rc, "atp_bloom_add_bytes")
    launches["bloom_add_bytes"] += 1


def bloom_contains_bytes(bits: torch.Tensor, keys: torch.Tensor,
                         params: BloomParams, *,
                         image: Optional[bool] = None) -> torch.Tensor:
    """BF.EXISTS of int32[B] keys against the byte-per-bit filter:
    bool[B], True where all k probe bytes are 1, flat or blocked layout.

    Replaces the XLA program ``bloom_contains`` (attendance_tpu/models/
    bloom.py:158; jitted in sketch/tpu_store.py:68-76). Bound: bytes, 4 B
    in and 1 B out a key and a 32-byte sector per distinct probe read (the
    processor's 8,192-key batch: about 0.02 us, under the launch floor of
    about 1 us), or operations as K7's. Two paths (``bloom_bytes_plan``;
    ``image`` forces one), either one launch in :data:`launches`:

    * direct, for a small batch or a filter too large for the image: one
      thread per key, in CTAs of 128 so that a batch spreads over many
      SMs, ANDs its k probe bytes, loaded with no early exit so they are
      in flight together. At scale each probe's own 32-byte L2 sector
      binds it.
    * image: a pack pass turns the bytes into the packed bit image (the
      layout of ``models.bloom.pack_bloom_bits``) in an int32 scratch of
      ``m_bits / 32`` words, reading the filter once with 16-byte loads;
      then a probe as its programmatic dependent. Flat: the image is
      copied into each CTA's shared memory by TMA bulk copies (clusters
      of 2 CTAs, each fetching a share and multicasting it), and the
      CTAs grid-stride over the keys, testing bits there. Blocked: the
      image is K4's packed layout, and K4's kernel probes it, each key's
      64-byte block read once (faster than the shared-memory image up
      to 262,144 keys and within 2% of it at 1M, PERF.md). The filter
      must start 16-byte aligned.
    """
    _check_bytes_filter(bits, keys, params)
    if bits.device.type == "cpu" and keys.device.type == "cpu":
        return bloom_contains_plain(bits, keys, params)
    _require_cuda(bits, keys)
    n = keys.shape[0]
    plan = bloom_bytes_plan(n, params.m_bits, params.layout, image=image)
    _require(not plan.image or bits.data_ptr() % 16 == 0,
             "bits must be 16-byte aligned")
    out = torch.empty(n, dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    scratch = (torch.empty(plan.scratch_words, dtype=torch.int32,
                           device=bits.device) if plan.image else None)
    with torch.cuda.device(bits.device):
        rc = library().atp_bloom_contains_bytes(
            bits.data_ptr(), params.m_bits, params.k,
            int(params.layout == "blocked"), keys.data_ptr(), n,
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            _stream(bits))
    _check_launch(rc, "atp_bloom_contains_bytes")
    launches["bloom_contains_bytes"] += 1
    return out


def bloom_pack_bytes(bits: torch.Tensor) -> torch.Tensor:
    """K8's pack pass alone: the packed int32[m_bits / 32] image of a
    byte-per-bit filter uint8[m_bits] (``m_bits`` a multiple of 32), bit
    ``pos`` at word ``pos >> 5``, bit ``pos & 31``, set where the byte is
    1. Its plain version is ``models.bloom.pack_bloom_bits``. Counted in
    :data:`launches` as ``bloom_pack_bytes``; K8's image path launches
    the same kernel and counts it as its own."""
    _require(bits.dtype == torch.uint8 and bits.dim() == 1
             and bits.shape[0] % 32 == 0, "bits must be uint8[32 * words]")
    if bits.device.type == "cpu":
        return pack_bloom_bits(bits)
    _require_cuda(bits)
    _require(bits.data_ptr() % 16 == 0, "bits must be 16-byte aligned")
    words = torch.empty(bits.shape[0] // 32, dtype=torch.int32,
                        device=bits.device)
    with torch.cuda.device(bits.device):
        rc = library().atp_bloom_pack_bytes(
            bits.data_ptr(), bits.shape[0], words.data_ptr(), _stream(bits))
    _check_launch(rc, "atp_bloom_pack_bytes")
    launches["bloom_pack_bytes"] += 1
    return words


# ---------------------------------------------------------------------------
# K9-K11: one mesh cell's slice of the state (parallel/sharded.py)
# ---------------------------------------------------------------------------
#
# A grid cell (r, s) of the (dp, sp) mesh holds slice s of the packed
# filter, words [first_word, first_word + words.numel()) (whole 512-bit
# blocks; the allocation may run past params.m_bits // 32 into padding
# that no probe addresses), and slice s of every bank's registers,
# columns [lo, lo + regs.shape[1]). Probe positions and buckets come from
# ``params.m_bits`` and ``2^precision``, never from the slice.

def _slice_keys(keys: torch.Tensor, key_bits: int) -> torch.Tensor:
    """int64 uint32 keys of plain keys, or of the word wire's words."""
    u = as_u32(keys)
    return u & ((1 << key_bits) - 1) if key_bits else u


def _check_filter_slice(words: torch.Tensor, keys: torch.Tensor,
                        params: BloomParams, first_word: int,
                        key_bits: int) -> None:
    _require(params.layout == "blocked",
             "the slice kernels implement the blocked layout only")
    _require(words.dtype == torch.int32 and words.dim() == 1
             and words.shape[0] >= 16 and words.shape[0] % 16 == 0,
             "a filter slice must be int32[16 * blocks]")
    _require(first_word >= 0 and first_word % 16 == 0,
             f"first_word {first_word} must start a 16-word block")
    _require(keys.dtype == torch.int32 and keys.dim() == 1,
             "keys must be int32[B] (uint32 bit patterns)")
    _require(0 <= key_bits <= 31, f"key_bits {key_bits} not in 0..31")


def bloom_contains_slice_plain(words: torch.Tensor, keys: torch.Tensor,
                               params: BloomParams, first_word: int,
                               key_bits: int = 0) -> torch.Tensor:
    """Plain version of K9, JAX's per-probe test (``local_contains``,
    attendance_tpu/parallel/sharded.py:304): uint8[B], 1 where every
    probe that falls in the slice is set (a probe outside counts as
    set)."""
    pos = bloom_positions(_slice_keys(keys, key_bits), params)
    m_local = words.shape[0] * 32
    rel = pos - first_word * 32
    in_range = (rel >= 0) & (rel < m_local)
    word = as_u32(words[(rel >> 5).clamp(0, words.shape[0] - 1)])
    bit = rel.clamp(0, m_local - 1) & 31
    probes = torch.where(in_range, (word >> bit) & 1, 1)
    return (probes == 1).all(dim=1).to(torch.uint8)


def bloom_contains_slice(words: torch.Tensor, keys: torch.Tensor,
                         params: BloomParams, *, first_word: int,
                         key_bits: int = 0,
                         compact: Optional[bool] = None) -> torch.Tensor:
    """K9: a mesh cell's partial BF.EXISTS, uint8[B] (1 where every probe
    of the key that falls in this slice is set, or none falls in it).
    ``key_bits > 0``: ``keys`` is the word wire (int32[B] of ``bank <<
    key_bits | key``), whose key is the low ``key_bits`` bits. The mesh
    ANDs the cells' answers across sp.

    Replaces ``local_contains`` (attendance_tpu/parallel/sharded.py:304),
    in ``step_kernel`` (:384), ``make_step_words`` (:399),
    ``make_step_narrow`` (:446) and ``query_kernel`` (:464). Bound: bytes,
    as K4's (4B in, B out, 64 bytes per distinct block in the slice), or
    operations (the key's block hash for every lane, K4's probe for the
    lanes of this slice). Design: one thread per key; a key's k probes
    lie in one block and a slice is whole blocks, so the slice holds all
    of them or none: one test of the block index, then K4's warp-wide
    probe on the slice's words (the words must start 64-byte aligned).
    Keys hash uniformly over the blocks, so a slice of 1/sp of the filter
    holds about 1/sp of the lanes: on a slice of less than half the
    filter (sp >= 3) each CTA first compacts its in-slice lanes into
    shared memory and only the warps that hold them probe (one
    ``__syncthreads``); on a larger slice every warp probes directly, as
    the compaction lost there at 65,536 lanes (PERF.md). ``compact``
    forces a path. JAX tests each probe; the plain version does, and the
    tests hold the two equal.
    """
    _check_filter_slice(words, keys, params, first_word, key_bits)
    if words.device.type == "cpu" and keys.device.type == "cpu":
        return bloom_contains_slice_plain(words, keys, params, first_word,
                                          key_bits)
    _require_cuda(words, keys)
    _require(words.data_ptr() % 64 == 0, "words must be 64-byte aligned")
    out = torch.empty(keys.shape[0], dtype=torch.uint8, device=keys.device)
    if keys.shape[0] == 0:
        return out
    num_blocks = params.m_bits // BLOCK_BITS
    if compact is None:
        compact = 2 * (words.shape[0] // 16) < num_blocks
    with torch.cuda.device(words.device):
        rc = library().atp_bloom_contains_slice(
            words.data_ptr(), first_word, words.shape[0], num_blocks,
            params.k, keys.data_ptr(), key_bits, keys.shape[0],
            out.data_ptr(), int(compact), _stream(words))
    _check_launch(rc, "atp_bloom_contains_slice")
    launches["bloom_contains_slice"] += 1
    return out


def hll_add_slice_plain(regs: torch.Tensor, keys: torch.Tensor,
                        valid: torch.Tensor, lo: int, precision: int,
                        bank: Optional[torch.Tensor] = None,
                        key_bits: int = 0, n_real: int = 0,
                        counts: Optional[torch.Tensor] = None) -> None:
    """Plain version of K10 (``hll_add_local`` and ``bump_local``,
    attendance_tpu/parallel/sharded.py:342,359), in place."""
    num_banks, regs_local = regs.shape
    u = as_u32(keys)
    if key_bits:
        k = u & ((1 << key_bits) - 1)
        field = u >> key_bits
        b = torch.where(field == (1 << (32 - key_bits)) - 1, -1, field)
        real = b >= 0
    else:
        k = u
        b = bank.to(torch.int64)
        real = torch.arange(k.shape[0], device=k.device) < n_real
    ok = valid.to(torch.bool)
    bucket, rank = hll.hll_bucket_rank(k, precision)
    rel = bucket - lo
    keep = (real & ok & (b >= 0) & (b < num_banks) & (rel >= 0)
            & (rel < regs_local))
    flat = (b * regs_local + rel)[keep]
    # uint8 scatter-max is not implemented for every device (as in
    # hll.hll_add_plain): reduce in int32, then write the bytes back.
    cur = regs.view(-1).to(torch.int32)
    cur.scatter_reduce_(0, flat, rank[keep].to(torch.int32), reduce="amax")
    regs.view(-1).copy_(cur.to(torch.uint8))
    if counts is not None:
        nv = (ok & real).sum()
        _bump_counts(counts, nv, real.sum() - nv)


def hll_add_slice(regs: torch.Tensor, keys: torch.Tensor,
                  valid: torch.Tensor, *, lo: int, precision: int = 14,
                  bank: Optional[torch.Tensor] = None, key_bits: int = 0,
                  n_real: int = 0,
                  counts: Optional[torch.Tensor] = None) -> None:
    """K10: max each kept lane's HLL rank into a mesh cell's register
    slice ``regs`` uint8[num_banks, 2^precision / sp] (columns ``[lo, lo
    + regs.shape[1])`` of every bank), in place; with ``counts``
    (int32[2, 2], the replica's two-lane counters, given to the cell s =
    0 only) also add the valid real lanes and the invalid real lanes, as
    ``_bump_counts`` does. ``valid`` uint8 or bool[B] is the AND of K9's
    answers across sp. Lanes: ``key_bits > 0`` reads ``keys`` as the word
    wire (a lane is real unless its bank field is all ones); else
    ``keys`` and ``bank`` int32[B] with the real lanes first (``n_real``
    of them). A lane is kept when it is real and valid, its bank is in
    ``[0, num_banks)`` and its bucket in the slice.

    Replaces ``hll_add_local`` and ``bump_local``
    (attendance_tpu/parallel/sharded.py:342,359). Bound: bytes, at 9B in
    (word wire: 5B) plus a read and a write of each distinct register a
    kept lane touches, or operations (the HLL hash of every lane). Design:
    K5's (one thread per lane, one trip for its loads, a CAS on the
    register's 32-bit word only when the rank is higher) on the slice,
    and K2's counting tail (warp ballots, one 64-bit atomic per CTA and
    counter). PERF.md records the designs measured against it and not
    kept (several lanes a thread with 16-byte loads, a grid of one wave,
    CTAs of 1024).
    """
    num_banks, regs_local = (regs.shape if regs.dim() == 2 else (0, 0))
    _require(regs.dtype == torch.uint8 and regs.dim() == 2
             and 4 <= precision <= 18 and regs_local >= 1
             and (1 << precision) % regs_local == 0
             and lo % regs_local == 0 and lo + regs_local <= 1 << precision,
             f"regs must be a slice uint8[num_banks, 2^{precision} / sp] "
             f"at a multiple lo of its width, got {tuple(regs.shape)} lo={lo}")
    _require(keys.dtype == torch.int32 and keys.dim() == 1,
             "keys must be int32[B] (uint32 bit patterns)")
    _require(valid.dtype in (torch.uint8, torch.bool)
             and valid.shape == keys.shape, "valid must be uint8 or bool[B]")
    _require(0 <= key_bits <= 31, f"key_bits {key_bits} not in 0..31")
    _require(key_bits > 0 or (bank is not None and bank.dtype == torch.int32
                              and bank.shape == keys.shape),
             "bank must be int32[B] unless the keys are the word wire")
    _require(counts is None or (counts.dtype == torch.int32
                                and counts.shape == (2, 2)),
             "counts must be int32[2, 2]")
    if key_bits:
        bank = None
    tensors = tuple(t for t in (regs, keys, valid, bank, counts)
                    if t is not None)
    if all(t.device.type == "cpu" for t in tensors):
        hll_add_slice_plain(regs, keys, valid, lo, precision, bank,
                            key_bits, n_real, counts)
        return
    _require_cuda(*tensors)
    _require(regs.data_ptr() % 4 == 0
             and (counts is None or counts.data_ptr() % 8 == 0),
             "regs must be 4-byte and counts 8-byte aligned")
    if keys.shape[0] == 0:
        return
    with torch.cuda.device(regs.device):
        rc = library().atp_hll_add_slice(
            regs.data_ptr(), num_banks, precision, lo, regs_local,
            keys.data_ptr(), None if bank is None else bank.data_ptr(),
            key_bits, valid.data_ptr(), keys.shape[0], n_real,
            None if counts is None else counts.data_ptr(), _stream(regs))
    _check_launch(rc, "atp_hll_add_slice")
    launches["hll_add_slice"] += 1


def bloom_add_slice_plain(words: torch.Tensor, keys: torch.Tensor,
                          params: BloomParams, first_word: int,
                          mask: Optional[torch.Tensor] = None) -> None:
    """Plain version of K11 (``bloom_add_kernel``'s scatter,
    attendance_tpu/parallel/sharded.py:323): set the keys' probe bits
    that fall in the slice, through a byte-per-bit copy, in place."""
    rel = bloom_positions(keys, params) - first_word * 32
    keep = (rel >= 0) & (rel < words.shape[0] * 32)
    if mask is not None:
        keep &= mask[:, None]
    bits = unpack_bloom_bits(words)
    bits[rel[keep]] = 1
    words.copy_(pack_bloom_bits(bits))


# Below this many keys K11 runs one thread per key (see bloom_add_slice).
K11_BINNED_MIN_KEYS = 1 << 21


def bloom_add_slice(words: torch.Tensor, keys: torch.Tensor,
                    params: BloomParams, *, first_word: int,
                    mask: Optional[torch.Tensor] = None,
                    binned: Optional[bool] = None) -> None:
    """K11: OR the probe bits of int32[B] keys (of those whose ``mask``
    is True) that fall in a mesh cell's filter slice into it, in place; a
    key whose block lies elsewhere is dropped. The mesh engine gives each
    cell its replica's whole share of the roster in one call and ORs the
    replicas' slices across dp after the preload.

    Replaces the scatter of ``bloom_add_kernel``
    (attendance_tpu/parallel/sharded.py:323, ``packed_or_scatter``,
    attendance_tpu/models/bloom.py:223). Bound: bytes, as K3's (4B a key
    and a read and write of each touched word of the slice), or
    operations (the block hash of every key, the probes of this slice's
    keys). Design: K3's on the slice. A replica's share of a large roster
    (5,000,000 keys of 10,000,000 at dp = 2) goes through K3's binned
    passes (``bloom_add_plan(n, slice blocks)``: tiles over the slice's
    blocks only, the count and scatter passes dropping keys outside the
    slice or masked off, one CTA per tile ORing in shared memory). Those
    cost a fixed chain of launches and scans and hash every key twice,
    so a batch below ``K11_BINNED_MIN_KEYS`` keys (the crossover measured
    on slices of 4 and 8, PERF.md) takes one thread per key, which issues
    one global ``atomicOr`` per distinct word of the key's block.
    ``binned`` forces one path. Either is one launch in
    :data:`launches`. The words must start 64-byte aligned.
    """
    _check_filter_slice(words, keys, params, first_word, 0)
    _require(mask is None or (mask.dtype == torch.bool
                              and mask.shape == keys.shape),
             "mask must be bool[B]")
    tensors = (words, keys) + (() if mask is None else (mask,))
    if all(t.device.type == "cpu" for t in tensors):
        bloom_add_slice_plain(words, keys, params, first_word, mask)
        return
    _require_cuda(*tensors)
    _require(words.data_ptr() % 64 == 0, "words must be 64-byte aligned")
    n = keys.shape[0]
    if n == 0:
        return
    if binned is None:
        binned = n >= K11_BINNED_MIN_KEYS
    log2_bpt, chunk, scratch_words = bloom_add_plan(n, words.shape[0] // 16)
    scratch = (torch.empty(scratch_words, dtype=torch.int32,
                           device=words.device) if binned else None)
    with torch.cuda.device(words.device):
        rc = library().atp_bloom_add_slice(
            words.data_ptr(), first_word, words.shape[0],
            params.m_bits // BLOCK_BITS, params.k, keys.data_ptr(),
            None if mask is None else mask.data_ptr(), n, log2_bpt, chunk,
            None if scratch is None else scratch.data_ptr(), _stream(words))
    _check_launch(rc, "atp_bloom_add_slice")
    launches["bloom_add_slice"] += 1
