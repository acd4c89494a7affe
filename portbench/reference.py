"""The plain reference of the attendance sketches, in NumPy.

A straightforward implementation of what the reference service does a
swipe (BF.EXISTS on the roster filter, then PFADD into the lecture-day's
HyperLogLog if the swipe is valid), written from the published
algorithms and independent of the program under test: it imports
nothing of it and takes nothing it made. The roster filter is RedisBloom
sized (BF.RESERVE at the configured error rate), in the blocked layout
(one 512-bit block a key) or RedisBloom's flat one; hashes are
MurmurHash3_x86_32 of the key's four little-endian bytes under the
fixed seeds below; the HLL is Redis's
dense layout at precision p (64-bit hash domain, bucket = low p bits,
rank = trailing zeros of the rest + 1), estimated with Ertl's improved
raw estimator.

``probes`` overrides the number of probes a key sets and tests: the
control (``k - 1``, the cheaper filter a later change might be tempted
by) runs through the same code.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np

_C1, _C2, _N = 0xCC9E2D51, 0x1B873593, 0xE6546B64
_FMIX1, _FMIX2 = 0x85EBCA6B, 0xC2B2AE35

SEED_BLOOM_A = 0x9747B28C
SEED_BLOOM_B = 0x85EBCA6B
SEED_BLOCK = 0x27D4EB2F
SEED_HLL_LO = 0xADC83B19
SEED_HLL_HI = 0x2545F491

BLOCK_BITS = 512


def murmur3(keys: np.ndarray, seed: int) -> np.ndarray:
    """MurmurHash3_x86_32 of each uint32 key's 4 little-endian bytes."""
    u = np.uint32
    with np.errstate(over="ignore"):
        k = np.asarray(keys).astype(np.uint32) * u(_C1)
        k = (k << u(15)) | (k >> u(17))
        k = k * u(_C2)
        h = u(seed) ^ k
        h = (h << u(13)) | (h >> u(19))
        h = h * u(5) + u(_N)
        h = h ^ u(4)
        h = h ^ (h >> u(16))
        h = h * u(_FMIX1)
        h = h ^ (h >> u(13))
        h = h * u(_FMIX2)
        return h ^ (h >> u(16))


class Filter(NamedTuple):
    m_bits: int
    k: int
    layout: str = "blocked"


def filter_params(capacity: int, error_rate: float,
                  layout: str = "blocked") -> Filter:
    """RedisBloom's sizing, bits_per_entry = -ln(eps) / ln(2)^2 and
    k = ceil(ln(2) * bits_per_entry), rounded up to whole 512-bit
    blocks; the blocked layout (a key's probes share one block) sizes
    at eps / 2."""
    eps = error_rate / 2.0 if layout == "blocked" else error_rate
    bpe = -math.log(eps) / (math.log(2.0) ** 2)
    k = max(1, math.ceil(math.log(2.0) * bpe))
    m = math.ceil(capacity * bpe)
    return Filter(-(-m // BLOCK_BITS) * BLOCK_BITS, k, layout)


def probe_bits(keys: np.ndarray, f: Filter,
               probes: Optional[int] = None) -> np.ndarray:
    """Bit positions a key probes, int64[n, probes]. Blocked: its block
    is h1 mod blocks, its bits (h2 + i * h3) mod 512; flat (RedisBloom's
    double hashing): (h1 + i * h2) mod m_bits; h2, h3 forced odd and
    the sums wrapping at 32 bits."""
    keys = np.asarray(keys, np.uint32)
    k = f.k if probes is None else probes
    i = np.arange(k, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h1 = murmur3(keys, SEED_BLOOM_A)
        h2 = murmur3(keys, SEED_BLOOM_B) | np.uint32(1)
        if f.layout == "flat":
            pos = h1[:, None] + i[None, :] * h2[:, None]
            return (pos % np.uint32(f.m_bits)).astype(np.int64)
        h3 = murmur3(keys, SEED_BLOCK) | np.uint32(1)
        off = (h2[:, None] + i[None, :] * h3[:, None]) & np.uint32(511)
    block = (h1 % np.uint32(f.m_bits // BLOCK_BITS)).astype(np.int64)
    return block[:, None] * BLOCK_BITS + off.astype(np.int64)


def build_bits(roster: np.ndarray, f: Filter,
               probes: Optional[int] = None,
               chunk: int = 1 << 20) -> np.ndarray:
    """The filter after BF.ADD of every roster key, one byte a bit (the
    chunks' positions worked out on a thread each)."""
    bits = np.zeros(f.m_bits, np.uint8)
    starts = range(0, len(roster), chunk)
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        for pos in pool.map(lambda s: probe_bits(roster[s:s + chunk], f,
                                                 probes), starts):
            bits[pos.ravel()] = 1
    return bits


def build_filter(roster: np.ndarray, f: Filter,
                 probes: Optional[int] = None,
                 chunk: int = 1 << 20) -> np.ndarray:
    """The same filter as uint32 words, bit b of word w being filter bit
    32 w + b."""
    bits = build_bits(roster, f, probes, chunk)
    return np.packbits(bits, bitorder="little").view("<u4").astype(np.uint32)


def contains(words: np.ndarray, keys: np.ndarray, f: Filter,
             probes: Optional[int] = None) -> np.ndarray:
    """BF.EXISTS of each key: bool[n]."""
    return lookup(words, probe_bits(keys, f, probes))


def lookup(words: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Whether every probed bit of a key is set, from its positions."""
    got = (words[pos >> 5] >> (pos & 31).astype(np.uint32)) & np.uint32(1)
    return np.all(got == 1, axis=1)


def bucket_rank(keys: np.ndarray, p: int):
    """(bucket, rank) of each key in Redis's dense HLL: a 64-bit hash
    (h_hi << 32 | h_lo), bucket its low p bits, rank the trailing zeros
    of the remaining 64 - p bits plus one (64 - p + 1 when all zero)."""
    keys = np.asarray(keys, np.uint32)
    lo = murmur3(keys, SEED_HLL_LO).astype(np.uint64)
    hi = murmur3(keys, SEED_HLL_HI).astype(np.uint64)
    h = (hi << np.uint64(32)) | lo
    bucket = (h & np.uint64((1 << p) - 1)).astype(np.int64)
    rest = h >> np.uint64(p)
    low = rest & (np.uint64(0) - rest)  # lowest set bit, 0 when none
    safe = np.where(low == 0, np.uint64(1), low)
    tz = np.rint(np.log2(safe.astype(np.float64))).astype(np.int64)
    rank = np.where(rest == 0, 64 - p + 1, tz + 1)
    return bucket, rank


def pfadd(regs: np.ndarray, row: np.ndarray, keys: np.ndarray,
          p: int) -> None:
    """Register max of each key's rank, into ``regs`` uint8[rows, 2^p]
    at the key's ``row``."""
    bucket, rank = bucket_rank(keys, p)
    np.maximum.at(regs.reshape(-1), np.asarray(row, np.int64) * (1 << p)
                  + bucket, rank.astype(np.uint8))


def _sigma(x: float) -> float:
    if x == 1.0:
        return math.inf
    y, z = 1.0, x
    while True:
        x *= x
        z_prev = z
        z += x * y
        y += y
        if z == z_prev:
            return z


def _tau(x: float) -> float:
    if x == 0.0 or x == 1.0:
        return 0.0
    y, z = 1.0, 1.0 - x
    while True:
        x = math.sqrt(x)
        z_prev = z
        y *= 0.5
        z -= (1.0 - x) ** 2 * y
        if z == z_prev:
            return z / 3.0


def pfcount(row: np.ndarray, p: int) -> int:
    """PFCOUNT of one register row: Ertl's improved raw estimator
    ("New cardinality estimation algorithms for HyperLogLog sketches",
    2017), rounded to the nearest integer."""
    q = 64 - p
    m = float(1 << p)
    c = np.bincount(np.asarray(row, np.int64), minlength=q + 2)
    z = m * _tau((m - c[q + 1]) / m)
    for k in range(q, 0, -1):
        z = (z + c[k]) * 0.5
    z += m * _sigma(c[0] / m)
    if z == 0.0 or math.isinf(z):
        return 0
    return int(round(m * m / (2.0 * math.log(2.0)) / z))
