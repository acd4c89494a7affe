"""Packed blocked Bloom filter on torch tensors (BF.RESERVE / BF.ADD /
BF.EXISTS for the fused path).

Counterpart of ``attendance_tpu/models/bloom.py`` (packed-words subset).
The filter is ``m_bits // 32`` words of 32 filter bits each, stored as
int32 tensors holding uint32 bit patterns: bit ``pos`` lives at word
``pos >> 5``, bit ``pos & 31``. Sizing and probe positions are the JAX
package's exactly, so both packages build the same words and give the
same answers.

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
from typing import NamedTuple

import torch

from attendance_tpu_torch.ops.murmur3 import (
    SEED_BLOCK, SEED_BLOOM_A, SEED_BLOOM_B, as_u32, murmur3_u32, to_i32)

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


def bloom_contains_words(words: torch.Tensor, keys: torch.Tensor,
                         params: BloomParams) -> torch.Tensor:
    """Membership test against a packed filter: bool[B]. Any layout;
    the plain version of the K4 probe for the blocked one."""
    pos = bloom_positions(keys, params)
    probes = as_u32(words[pos >> 5])               # gather: [B, k]
    return torch.all(((probes >> (pos & 31)) & 1) == 1, dim=1)


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


def bloom_packed_fill_fraction(words: torch.Tensor) -> torch.Tensor:
    """Fraction of set bits of a packed filter (float64 scalar tensor on
    the filter's device): popcount through a byte table, no unpack."""
    table = _POPCOUNT8.to(words.device)
    set_bits = table[words.view(torch.uint8).to(torch.int64)].sum()
    return set_bits.to(torch.float64) / float(words.numel() * 32)
