"""Bloom filters on torch tensors (BF.RESERVE / BF.ADD / BF.EXISTS).

Counterpart of ``attendance_tpu/models/bloom.py``. Two representations
share one sizing and one set of probe positions, the JAX package's
exactly, so both packages build the same filter bytes and give the same
answers:

* byte per bit, ``uint8[m_bits]`` (the generic sketch store's filters,
  flat or blocked layout): :func:`bloom_add` is the K7 kernel and
  :func:`bloom_contains` the K8 kernel on a CUDA tensor,
  :func:`bloom_add_plain` / :func:`bloom_contains_plain` on a CPU one;
* packed, ``m_bits // 32`` words of 32 filter bits each (the fused
  path's filter), stored as int32 tensors holding uint32 bit patterns:
  bit ``pos`` lives at word ``pos >> 5``, bit ``pos & 31``.

Blocked layout: each key maps to one 512-bit block (``h1 % num_blocks``)
and its k probes land inside it at ``(h2 + j*h3) & 511``.

The roster preload (:func:`bloom_add_packed`) runs the K3 kernel on a
CUDA tensor (``ops/kernels.py``); :func:`bloom_add_packed_plain` is its
plain PyTorch version. The standalone blocked probe
(:func:`bloom_contains_packed`) runs the K4 kernel on a CUDA tensor;
:func:`bloom_contains_words` is its plain version.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from attendance_tpu_torch.device import resolve_device
from attendance_tpu_torch.ops.murmur3 import (
    SEED_BLOCK, SEED_BLOOM_A, SEED_BLOOM_B, as_u32, murmur3_u32,
    murmur3_u32_np, to_i32)

BLOCK_BITS = 512  # one 64-byte block per key in the "blocked" layout

_LN2 = math.log(2.0)


class BloomParams(NamedTuple):
    """Static Bloom configuration."""
    m_bits: int
    k: int
    layout: str  # "flat" | "blocked"
    capacity: int
    error_rate: float


def derive_bloom_params(capacity: int, error_rate: float,
                        layout: str = "flat") -> BloomParams:
    """Size the filter the way RedisBloom sizes BF.RESERVE.

    bits_per_entry = -ln(eps) / ln(2)^2 ; k = ceil(ln(2) * bpe).
    The blocked layout concentrates probes in one 512-bit block which
    costs accuracy, so it derives its bit budget from eps/2.
    """
    if not (0.0 < error_rate < 1.0):
        raise ValueError(f"error_rate must be in (0,1), got {error_rate}")
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    eff_eps = error_rate / 2.0 if layout == "blocked" else error_rate
    bpe = -math.log(eff_eps) / (_LN2 * _LN2)
    k = max(1, math.ceil(_LN2 * bpe))
    m_bits = math.ceil(capacity * bpe)
    # Round up to whole 512-bit blocks.
    m_bits = ((m_bits + BLOCK_BITS - 1) // BLOCK_BITS) * BLOCK_BITS
    if m_bits >= 2 ** 31:
        raise ValueError(
            f"filter of {m_bits} bits exceeds int32 indexing; "
            "shard it instead")
    return BloomParams(m_bits=m_bits, k=k, layout=layout,
                       capacity=capacity, error_rate=error_rate)


def bloom_init(params: BloomParams, device: torch.device) -> torch.Tensor:
    """Fresh all-zero filter state: uint8[m_bits], one byte per bit."""
    return torch.zeros(params.m_bits, dtype=torch.uint8, device=device)


def bloom_packed_init(params: BloomParams,
                      device: torch.device) -> torch.Tensor:
    """Fresh all-zero packed filter: int32[m_bits // 32] (uint32 bits)."""
    return torch.zeros(params.m_bits // 32, dtype=torch.int32,
                       device=device)


def bloom_positions(keys: torch.Tensor, params: BloomParams) -> torch.Tensor:
    """Bit positions probed for each key: int64[B, k].

    flat:    pos_i = (h1 + i * h2) mod m          (h2 forced odd)
    blocked: block = h1 mod num_blocks
             pos_i = block*512 + ((h2 + i * h3) & 511)
    """
    h1 = murmur3_u32(keys, SEED_BLOOM_A)
    h2 = murmur3_u32(keys, SEED_BLOOM_B) | 1
    i = torch.arange(params.k, dtype=torch.int64, device=keys.device)
    if params.layout == "flat":
        probes = (h1[:, None] + i[None, :] * h2[:, None]) & 0xFFFFFFFF
        return probes % params.m_bits
    num_blocks = params.m_bits // BLOCK_BITS
    h3 = murmur3_u32(keys, SEED_BLOCK) | 1
    block = (h1 % num_blocks) * BLOCK_BITS
    off = (h2[:, None] + i[None, :] * h3[:, None]) & (BLOCK_BITS - 1)
    return block[:, None] + off


def bloom_positions_np(keys: np.ndarray, params: BloomParams) -> np.ndarray:
    """Numpy mirror of :func:`bloom_positions` in wrapping uint32
    arithmetic: the same probe positions, uint32[B, k]."""
    with np.errstate(over="ignore"):
        keys = np.asarray(keys).astype(np.uint32)
        h1 = murmur3_u32_np(keys, SEED_BLOOM_A)
        h2 = murmur3_u32_np(keys, SEED_BLOOM_B) | np.uint32(1)
        i = np.arange(params.k, dtype=np.uint32)
        if params.layout == "flat":
            probes = h1[:, None] + i[None, :] * h2[:, None]
            return probes % np.uint32(params.m_bits)
        num_blocks = params.m_bits // BLOCK_BITS
        h3 = murmur3_u32_np(keys, SEED_BLOCK) | np.uint32(1)
        block = (h1 % np.uint32(num_blocks)) * np.uint32(BLOCK_BITS)
        off = ((h2[:, None] + i[None, :] * h3[:, None])
               & np.uint32(BLOCK_BITS - 1))
        return block[:, None] + off


def bloom_add_plain(bits: torch.Tensor, keys: torch.Tensor,
                    params: BloomParams,
                    mask: Optional[torch.Tensor] = None) -> None:
    """Plain version of K7: set the k probe bytes of every key (of every
    key whose ``mask`` is True) to 1, in place (the JAX function returned
    new bits from a donated buffer). Setting 1 is idempotent, so
    duplicate and replayed keys are safe."""
    pos = bloom_positions(keys, params)
    if mask is not None:
        pos = pos[mask]
    bits[pos.reshape(-1)] = 1


def bloom_add(bits: torch.Tensor, keys: torch.Tensor, params: BloomParams,
              mask: Optional[torch.Tensor] = None) -> None:
    """Insert a batch of int32[B] keys (uint32 bit patterns) into the
    byte-per-bit filter, in place: the K7 kernel on a CUDA tensor,
    :func:`bloom_add_plain` on a CPU one."""
    # Imported here: ops.kernels builds its plain versions on this module.
    from attendance_tpu_torch.ops import kernels
    kernels.bloom_add_bytes(bits, keys, params, mask)


def bloom_contains_plain(bits: torch.Tensor, keys: torch.Tensor,
                         params: BloomParams) -> torch.Tensor:
    """Plain version of K8: gather the k probe bytes of each key and AND
    them, bool[B]."""
    return torch.all(bits[bloom_positions(keys, params)] == 1, dim=1)


def bloom_contains(bits: torch.Tensor, keys: torch.Tensor,
                   params: BloomParams) -> torch.Tensor:
    """Membership of a batch of int32[B] keys in the byte-per-bit
    filter, bool[B]: the K8 kernel on a CUDA tensor,
    :func:`bloom_contains_plain` on a CPU one. No false negatives."""
    # Imported here: ops.kernels builds its plain versions on this module.
    from attendance_tpu_torch.ops import kernels
    return kernels.bloom_contains_bytes(bits, keys, params)


def bloom_fill_fraction(bits: torch.Tensor) -> torch.Tensor:
    """Fraction of set bytes of a byte-per-bit filter (float64 scalar
    tensor on the filter's device); drives the FPR estimate."""
    return (torch.count_nonzero(bits).to(torch.float64)
            / float(bits.numel()))


def pack_bloom_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint8[m_bits] (byte per bit) -> packed int32[m_bits // 32]."""
    cols = bits.view(-1, 32)
    words = torch.zeros(cols.shape[0], dtype=torch.int64, device=bits.device)
    for b in range(32):
        words |= cols[:, b].to(torch.int64) << b
    return to_i32(words)


def unpack_bloom_bits(words: torch.Tensor) -> torch.Tensor:
    """Packed int32[m_words] -> uint8[m_words * 32] (byte per bit)."""
    u = as_u32(words)
    bits = torch.empty((words.shape[0], 32), dtype=torch.uint8,
                       device=words.device)
    for b in range(32):
        bits[:, b] = (u >> b) & 1
    return bits.view(-1)


def bloom_add_packed_plain(words: torch.Tensor, keys: torch.Tensor,
                           params: BloomParams) -> None:
    """Plain version of the K3 preload: scatter-set the probe bits into
    a byte-per-bit copy and pack it back. Updates ``words`` in place
    (the JAX function returned new words from a donated buffer)."""
    bits = unpack_bloom_bits(words)
    bits[bloom_positions(keys, params).reshape(-1)] = 1
    words.copy_(pack_bloom_bits(bits))


def bloom_add_packed(words: torch.Tensor, keys: torch.Tensor,
                     params: BloomParams) -> None:
    """Insert a batch of keys into the packed filter, in place: the K3
    kernel on a CUDA tensor, :func:`bloom_add_packed_plain` on a CPU
    one. OR is idempotent, so duplicate and replayed keys are safe."""
    # Imported here: ops.kernels builds its plain versions on this module.
    from attendance_tpu_torch.ops import kernels
    kernels.bloom_add(words, keys, params)


def bloom_or_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bloom union over packed words: bitwise OR (BF.MERGE). A Bloom
    filter is a state-based CRDT under OR (commutative, associative,
    idempotent), which makes the federation's replication convergent.
    Filters of different word counts raise, as the numpy twin does."""
    if a.shape != b.shape:
        raise ValueError(
            f"packed filter shapes differ ({tuple(a.shape)} vs "
            f"{tuple(b.shape)}) — capacity/error-rate/layout must match "
            "across the federation")
    return torch.bitwise_or(a, b)


def bloom_or_words_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`bloom_or_words` (the federation's host merge
    core). Filters must share geometry: OR-ing different word counts
    would break the no-false-negative contract, so it raises."""
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    if a.shape != b.shape:
        raise ValueError(
            f"packed filter shapes differ ({a.shape} vs {b.shape}) — "
            "capacity/error-rate/layout must match across the "
            "federation")
    return a | b


def bloom_contains_words(words: torch.Tensor, keys: torch.Tensor,
                         params: BloomParams) -> torch.Tensor:
    """Membership test against a packed filter: bool[B]. Any layout;
    the plain version of the K4 probe for the blocked one."""
    pos = bloom_positions(keys, params)
    probes = as_u32(words[pos >> 5])               # gather: [B, k]
    return torch.all(((probes >> (pos & 31)) & 1) == 1, dim=1)


def bloom_contains_words_np(words: np.ndarray, keys: np.ndarray,
                            params: BloomParams) -> np.ndarray:
    """Numpy twin of :func:`bloom_contains_words`: the same answers
    against a HOST copy of the packed filter, bool[B]. The query plane's
    batched BF.EXISTS (``serve/``): one vectorized probe pass over the
    batch, no device, positions from the shared
    :func:`bloom_positions_np`."""
    words = np.asarray(words, dtype=np.uint32)
    keys = np.asarray(keys, dtype=np.uint32)
    if len(keys) == 0:
        return np.zeros(0, dtype=bool)
    pos = bloom_positions_np(keys, params).astype(np.int64)
    probes = words[pos >> 5]                       # gather: [B, k]
    bit = (pos & 31).astype(np.uint32)
    return np.all((probes >> bit) & np.uint32(1) == np.uint32(1), axis=1)


def bloom_contains_packed(words: torch.Tensor, keys: torch.Tensor,
                          params: BloomParams) -> torch.Tensor:
    """Blocked BF.EXISTS against the packed filter, bool[B]: the K4
    kernel on a CUDA tensor, :func:`bloom_contains_words` on a CPU one.
    Raises on the flat layout, as the Pallas probes did."""
    # Imported here: ops.kernels builds its plain versions on this module.
    from attendance_tpu_torch.ops import kernels
    return kernels.bloom_contains(words, keys, params)


# Set-bit count of every byte value, for the popcount below.
_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int64)


def bloom_packed_set_bits(words: torch.Tensor) -> torch.Tensor:
    """Set bits of packed words (int64 scalar tensor on their device):
    popcount through a byte table, no unpack. The mesh engine sums it
    over its filter slices."""
    table = _POPCOUNT8.to(words.device)
    return table[words.view(torch.uint8).to(torch.int64)].sum()


def bloom_packed_fill_fraction(words: torch.Tensor) -> torch.Tensor:
    """Fraction of set bits of a packed filter (float64 scalar tensor on
    the filter's device)."""
    return (bloom_packed_set_bits(words).to(torch.float64)
            / float(words.numel() * 32))


# The same byte table on the host (uint16: sums over multi-MB filters
# must not wrap a uint8 accumulator lane).
_POPCOUNT8_NP = _POPCOUNT8.numpy().astype(np.uint16)


def bloom_packed_fill_fraction_np(words: np.ndarray) -> float:
    """Host popcount twin of :func:`bloom_packed_fill_fraction` for
    mirrored (numpy) filter words: the scrape and query paths read the
    fill from the epoch mirror instead of reading the card."""
    words = np.asarray(words, dtype=np.uint32)
    if words.size == 0:
        return 0.0
    set_bits = int(_POPCOUNT8_NP[words.view(np.uint8)].sum(dtype=np.int64))
    return set_bits / float(words.size * 32)


def keys_tensor(keys, device: torch.device) -> torch.Tensor:
    """int32[B] tensor (uint32 bit patterns) on ``device`` of host keys
    (a sequence or array of uint32 values) or of an integer tensor."""
    if isinstance(keys, torch.Tensor):
        return to_i32(as_u32(keys)).to(device)
    arr = np.ascontiguousarray(np.asarray(keys).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


class BloomFilter:
    """Object shell over the byte-per-bit functions, holding the filter
    on a device (the card unless ``device="cpu"``). Updates are in place."""

    def __init__(self, capacity: int, error_rate: float,
                 layout: str = "flat", params: Optional[BloomParams] = None,
                 bits: Optional[torch.Tensor] = None, device=None):
        self.params = params or derive_bloom_params(capacity, error_rate,
                                                    layout)
        self.bits = (bits if bits is not None
                     else bloom_init(self.params, resolve_device(device)))

    @property
    def num_bits(self) -> int:
        return self.params.m_bits

    @property
    def num_hashes(self) -> int:
        return self.params.k

    def add(self, keys, mask=None) -> None:
        keys = keys_tensor(keys, self.bits.device)
        if mask is not None:
            mask = (mask if isinstance(mask, torch.Tensor) else
                    torch.from_numpy(np.asarray(mask, dtype=bool))).to(
                        self.bits.device)
        bloom_add(self.bits, keys, self.params, mask)

    def contains(self, keys) -> np.ndarray:
        keys = keys_tensor(keys, self.bits.device)
        return bloom_contains(self.bits, keys, self.params).cpu().numpy()

    def estimated_fpr(self) -> float:
        """(fill fraction)^k: the occupancy-based FPR estimate."""
        return float(bloom_fill_fraction(self.bits)) ** self.params.k
