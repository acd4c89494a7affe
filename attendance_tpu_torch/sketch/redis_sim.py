"""Hermetic Redis-exact sketch oracle (``--sketch-backend=redis-sim``).

Counterpart of ``attendance_tpu/sketch/redis_sim.py``, a numpy copy. The
parity harness (attendance_tpu_torch.parity) needs a backend that
answers the way a real Redis Stack would, without a server. The memory
store cannot serve that role: it mirrors the card store's hash design
bit for bit, so a bias shared by both would pass parity silently. This
module simulates Redis's actual algorithms in numpy, with a hash family
and sizing math that share nothing with the card's path but the member
values:

* **Bloom**: RedisBloom's published design: ``bits_per_entry =
  -ln(error)/ln(2)^2``; ``hashes = ceil(ln(2)*bpe)``; the bit count
  ``entries*bpe`` rounded UP to the next power of two (which also
  scales the declared capacity up to ``bits/bpe``); probe positions by
  Kirsch-Mitzenmacher double hashing ``(a + i*b) mod bits`` where
  ``a = MurmurHash64A(member, seed=M64)`` and
  ``b = MurmurHash64A(member, seed=a)``. Auto-scaling chains a new
  sub-filter at capacity with expansion 2 and error tightening 0.5.
* **HyperLogLog**: Redis's dense HLL: ``hash = MurmurHash64A(member,
  seed=0xadc83b19)``; register index = low 14 bits; rank = 1 + trailing
  zeros of ``(hash >> 14) | 1<<50`` (so rank <= 51); PFCOUNT by the Ertl
  estimator Redis adopted (models.hll.estimate_from_histogram).
* **Members hash as their byte-string form**: redis-py sends int member
  12345 as the bytes ``b"12345"``, so each normalized uint32 key is
  rendered to its decimal byte string before hashing. Non-numeric
  members enter through the same u32 normalization as every other
  backend (sketch.base.member_to_u32).

Everything is implemented from the published algorithm descriptions;
no code is taken from Redis or RedisBloom.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from attendance_tpu_torch.models.hll import estimate_from_histogram
from attendance_tpu_torch.sketch.base import (
    DEFAULT_CAPACITY, DEFAULT_ERROR_RATE, EXPANSION, ResponseError,
    SketchStore)

# ---------------------------------------------------------------------------
# MurmurHash64A, vectorized over same-length byte strings.
# ---------------------------------------------------------------------------

_M64 = np.uint64(0xC6A4A7935BD1E995)
_R64 = np.uint64(47)
_HLL_SEED = np.uint64(0xADC83B19)  # Redis hyperloglog.c hllPatLen seed

_BYTE_SHIFTS = (np.uint64(8) * np.arange(8, dtype=np.uint64))


def murmur64a_fixed(data: np.ndarray, seed) -> np.ndarray:
    """MurmurHash64A over N byte strings sharing one length.

    data: uint8[N, L]; seed: scalar or uint64[N] (per-element seeds are
    what the Bloom double hash needs for its second lane).
    Returns uint64[N]. Transcribed from Appleby's published algorithm
    (public domain), vectorized: 8-byte little-endian blocks mixed with
    the M64 constant, the <8-byte tail XORed in byte-by-byte, then the
    standard 3-step finalizer.
    """
    n, length = data.shape
    with np.errstate(over="ignore"):
        h = np.full(n, np.uint64(seed), dtype=np.uint64) \
            if np.isscalar(seed) or np.ndim(seed) == 0 \
            else np.asarray(seed, dtype=np.uint64).copy()
        h ^= np.uint64(length) * _M64
        nblocks = length // 8
        for b in range(nblocks):
            k = (data[:, b * 8:(b + 1) * 8].astype(np.uint64)
                 << _BYTE_SHIFTS[None, :]).sum(axis=1, dtype=np.uint64)
            k *= _M64
            k ^= k >> _R64
            k *= _M64
            h ^= k
            h *= _M64
        rem = length & 7
        if rem:
            tail = (data[:, nblocks * 8:].astype(np.uint64)
                    << _BYTE_SHIFTS[None, :rem]).sum(axis=1, dtype=np.uint64)
            h ^= tail
            h *= _M64
        h ^= h >> _R64
        h *= _M64
        h ^= h >> _R64
    return h


def murmur64a_scalar(data: bytes, seed: int) -> int:
    """One-string MurmurHash64A (plain-Python mirror of the vectorized
    path; tests cross-check the two on random inputs)."""
    mask = (1 << 64) - 1
    m = 0xC6A4A7935BD1E995
    h = (seed ^ (len(data) * m)) & mask
    nblocks = len(data) // 8
    for b in range(nblocks):
        k = int.from_bytes(data[b * 8:(b + 1) * 8], "little")
        k = (k * m) & mask
        k ^= k >> 47
        k = (k * m) & mask
        h = ((h ^ k) * m) & mask
    rem = len(data) & 7
    if rem:
        h ^= int.from_bytes(data[nblocks * 8:], "little")
        h = (h * m) & mask
    h ^= h >> 47
    h = (h * m) & mask
    h ^= h >> 47
    return h


_POW10 = np.array([10 ** d for d in range(1, 11)], dtype=np.uint64)


def _decimal_groups(keys: np.ndarray):
    """Group uint32 keys by decimal length; yield (indices, digit bytes).

    Rendering b"12345" for key 12345 — the exact bytes redis-py puts on
    the wire for an integer member — vectorized per digit-count group.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    lengths = np.searchsorted(_POW10, keys, side="right") + 1
    for length in np.unique(lengths):
        idx = np.flatnonzero(lengths == length)
        k = keys[idx]
        digits = np.empty((len(idx), int(length)), dtype=np.uint8)
        for j in range(int(length)):
            digits[:, j] = ((k // np.uint64(10 ** (int(length) - 1 - j)))
                            % np.uint64(10)) + np.uint8(ord("0"))
        yield idx, digits


def hash_members_u64(keys_u32: np.ndarray, seed) -> np.ndarray:
    """MurmurHash64A of each key's decimal byte string: uint64[N]."""
    out = np.empty(len(keys_u32), dtype=np.uint64)
    for idx, digits in _decimal_groups(keys_u32):
        out[idx] = murmur64a_fixed(digits, seed)
    return out


def bloom_hash_pairs(keys_u32: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """RedisBloom's (a, b) double-hash lanes per member.

    a = mm64a(member, M64); b = mm64a(member, a) — the second lane is
    seeded by the first, exactly the bloom.c ``bloom_calc_hash64``
    structure, which is why murmur64a_fixed takes per-element seeds.
    """
    a = np.empty(len(keys_u32), dtype=np.uint64)
    b = np.empty(len(keys_u32), dtype=np.uint64)
    for idx, digits in _decimal_groups(keys_u32):
        ga = murmur64a_fixed(digits, _M64)
        a[idx] = ga
        b[idx] = murmur64a_fixed(digits, ga)
    return a, b


# ---------------------------------------------------------------------------
# RedisBloom-sized Bloom filter + scalable chain.
# ---------------------------------------------------------------------------

_LN2 = 0.693147180559945
_LN2_SQUARED = 0.480453013918201  # the constant bloom.c divides by


class SimBloomParams(NamedTuple):
    """Sizing of one sub-filter, after RedisBloom's power-of-two round.

    ``m_bits`` keeps the base class's field name so SketchStore.BF.INFO
    and estimated_fpr work unchanged on sim chains.
    """
    m_bits: int
    k: int
    capacity: int    # scaled-up entries the rounded filter can hold
    error_rate: float


def sim_bloom_params(entries: int, error: float) -> SimBloomParams:
    """RedisBloom bloom_init sizing: bpe from the error target, bit
    count rounded up to the next power of two, capacity scaled to the
    rounded size, ``hashes = ceil(ln2 * bpe)``."""
    if not (0.0 < error < 1.0):
        raise ResponseError(f"error rate must be in (0,1), got {error}")
    if entries < 1:
        raise ResponseError(f"capacity must be >= 1, got {entries}")
    bpe = -math.log(error) / _LN2_SQUARED
    k = int(math.ceil(_LN2 * bpe))
    raw_bits = float(entries) * bpe
    n2 = int(math.floor(math.log2(raw_bits))) + 1  # always rounds UP
    if n2 > 40:
        raise ResponseError(f"sim filter of 2^{n2} bits is unreasonable")
    m_bits = 1 << n2
    return SimBloomParams(m_bits=m_bits, k=k,
                          capacity=int(m_bits / bpe), error_rate=error)


def sim_bloom_positions(keys_u32: np.ndarray,
                        params: SimBloomParams) -> np.ndarray:
    """Probe positions int64[N, k]: (a + i*b) & (bits-1)."""
    a, b = bloom_hash_pairs(keys_u32)
    i = np.arange(params.k, dtype=np.uint64)
    with np.errstate(over="ignore"):
        probes = a[:, None] + i[None, :] * b[:, None]
        return (probes & np.uint64(params.m_bits - 1)).astype(np.int64)


class _SimChain:
    """Auto-scaling chain of RedisBloom-sized sub-filters.

    Duck-types the attributes SketchStore's BF.INFO / estimated_fpr
    read from a chain (filters, params, item_count, total_capacity).
    Sub-filter i gets capacity*EXPANSION^i and error*0.5^i (RedisBloom's
    expansion=2 / ERROR_TIGHTENING_RATIO=0.5 defaults).
    """

    def __init__(self, capacity: int, error_rate: float):
        self.base_capacity = int(capacity)
        self.base_error = float(error_rate)
        self.filters: List[np.ndarray] = []   # uint8 bit-per-byte arrays
        self.params: List[SimBloomParams] = []
        self.counts: List[int] = []
        self._grow()

    def _grow(self) -> None:
        i = len(self.filters)
        params = sim_bloom_params(self.base_capacity * (EXPANSION ** i),
                                  self.base_error * (0.5 ** i))
        self.filters.append(np.zeros(params.m_bits, dtype=np.uint8))
        self.params.append(params)
        self.counts.append(0)

    def contains_many(self, keys_u32: np.ndarray) -> np.ndarray:
        out = np.zeros(len(keys_u32), dtype=bool)
        for bits, params in zip(self.filters, self.params):
            rem = ~out
            if not rem.any():
                break
            pos = sim_bloom_positions(keys_u32[rem], params)
            out[rem] = bits[pos].all(axis=1)
        return out

    def add_many(self, keys_u32: np.ndarray) -> np.ndarray:
        """Insert; per-key 1 if (probably) new. Like RedisBloom, a key
        found in ANY link is not re-inserted; new keys go to the newest
        link, growing the chain when it reaches declared capacity.

        A real server processes BF.MADD members sequentially, so the
        second copy of a duplicate inside one call sees the bits the
        first just set: BF.MADD k 7 7 answers [1, 0]. Mirror that — only
        the FIRST occurrence of each distinct new member reports added,
        and capacity accounting counts distinct members once, even
        across chunk/grow boundaries. New members are inserted in CALL
        order so grow boundaries split the call exactly where a real
        server would.

        Known deviation (the cost of the vectorized membership check):
        a real server's later members also see bits set by earlier
        DISTINCT members of the same call, so an intra-call false
        positive suppresses that member's insertion ("already present")
        — here membership is evaluated once against the pre-call state,
        so such a member is still inserted and reported added. The
        divergence needs an FP between two members of one call
        (probability ~ eps per member) and only perturbs which exact
        bits/counters a scaling chain carries, never membership
        answers.
        """
        existed = self.contains_many(keys_u32)
        added = np.zeros(len(keys_u32), dtype=np.int64)
        new_idx = np.flatnonzero(~existed)
        if len(new_idx) == 0:
            return added
        uniq, first = np.unique(keys_u32[new_idx], return_index=True)
        added[new_idx[first]] = 1
        # Insert in CALL order, not np.unique's sorted order: when one
        # BF.MADD crosses a grow boundary, which keys land in the old
        # vs the new sub-filter must match a real server's sequential
        # processing (bit-state fidelity for the live-Redis parity
        # gate; membership answers are unaffected either way).
        order = np.argsort(first, kind="stable")
        uniq = uniq[order]
        i = 0
        while i < len(uniq):
            room = self.params[-1].capacity - self.counts[-1]
            if room <= 0:
                self._grow()
                continue
            chunk = uniq[i:i + room]
            self.counts[-1] += len(chunk)
            pos = sim_bloom_positions(chunk, self.params[-1])
            self.filters[-1][pos.reshape(-1)] = 1
            i += len(chunk)
        return added

    @property
    def item_count(self) -> int:
        return sum(self.counts)

    @property
    def total_capacity(self) -> int:
        return sum(p.capacity for p in self.params)


# ---------------------------------------------------------------------------
# Redis dense HLL (p=14, q=50).
# ---------------------------------------------------------------------------

HLL_P = 14                       # Redis hyperloglog.c HLL_P
HLL_Q = 64 - HLL_P               # 50
_HLL_REGISTERS = 1 << HLL_P
_HLL_P_MASK = np.uint64(_HLL_REGISTERS - 1)


def sim_hll_bucket_rank(keys_u32: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(register index, rank) per member, Redis hllPatLen semantics:
    index = low p bits of mm64a(member, 0xadc83b19); rank = 1 + trailing
    zeros of the remaining 50 bits with a guard bit at position 50."""
    h = hash_members_u64(keys_u32, _HLL_SEED)
    with np.errstate(over="ignore"):
        idx = (h & _HLL_P_MASK).astype(np.int64)
        rest = (h >> np.uint64(HLL_P)) | (np.uint64(1) << np.uint64(HLL_Q))
        lsb = rest & (np.uint64(0) - rest)
        # lsb is a power of two <= 2^50: exact in float64, so log2 is too.
        rank = np.log2(lsb.astype(np.float64)).astype(np.int64) + 1
    return idx, rank


class RedisSimSketchStore(SketchStore):
    """Drop-in SketchStore whose answers come from simulated Redis.

    Selected by ``--sketch-backend=redis-sim``; the default hermetic
    oracle for the parity harness and a server-free stand-in anywhere
    the redis backend would be used.
    """

    def __init__(self, config):
        super().__init__(config)
        self._hlls: Dict[str, np.ndarray] = {}

    # Base-class Bloom/HLL primitives are never reached: the public
    # surface below implements Redis's own algorithms wholesale.
    def _filter_create(self, params):  # pragma: no cover
        raise NotImplementedError

    def _filter_add(self, handle, params, keys):  # pragma: no cover
        raise NotImplementedError

    def _filter_contains(self, handle, params, keys):  # pragma: no cover
        raise NotImplementedError

    def _hll_add(self, key, keys_u32, mask=None,
                 want_changed=True):  # pragma: no cover
        raise NotImplementedError

    def _hll_count(self, keys):  # pragma: no cover
        raise NotImplementedError

    # -- Bloom surface ------------------------------------------------------
    def bf_reserve(self, key: str, error_rate, capacity) -> bool:
        if key in self._blooms:
            raise ResponseError("item exists")
        self._blooms[key] = _SimChain(int(capacity), float(error_rate))
        # Structural write: incremental snapshots must carry this key
        # (the base class marks its own bf_reserve the same way).
        self._dirty_blooms.add(key)
        return True

    def _chain_or_create(self, key: str) -> _SimChain:
        chain = self._blooms.get(key)
        if chain is None:
            chain = _SimChain(DEFAULT_CAPACITY, DEFAULT_ERROR_RATE)
            self._blooms[key] = chain
        return chain

    # Overrides land on the base class's _u32 chokepoints, not on the
    # public methods, which keep their dirty-key marks.
    def _bf_add_u32(self, key: str, u32: np.ndarray) -> np.ndarray:
        return self._chain_or_create(key).add_many(u32)

    def _bf_exists_u32(self, key: str, u32: np.ndarray) -> np.ndarray:
        chain = self._blooms.get(key)
        if chain is None:
            return np.zeros(len(u32), dtype=bool)
        return chain.contains_many(u32)

    # -- HLL surface --------------------------------------------------------
    def _regs_of(self, key: str) -> np.ndarray:
        regs = self._hlls.get(key)
        if regs is None:
            regs = self._hlls[key] = np.zeros(_HLL_REGISTERS, dtype=np.uint8)
        return regs

    def _pf_create(self, key: str) -> int:
        # Redis: PFADD with no members creates the key; returns 1 iff
        # it did not exist.
        existed = key in self._hlls
        self._regs_of(key)
        return int(not existed)

    def _pfadd_u32(self, key: str, u32: np.ndarray,
                   mask: Optional[np.ndarray],
                   want_changed: bool) -> int:
        if mask is not None:
            u32 = u32[np.asarray(mask, dtype=bool)]
        regs = self._regs_of(key)
        if len(u32) == 0:
            return 0
        idx, rank = sim_hll_bucket_rank(u32)
        changed = bool((rank > regs[idx]).any())
        np.maximum.at(regs, idx, rank.astype(np.uint8))
        return int(changed)

    def _pfcount_keys(self, keys) -> int:
        known = [self._hlls[k] for k in keys if k in self._hlls]
        if not known:
            return 0
        merged = known[0]
        for r in known[1:]:
            merged = np.maximum(merged, r)
        hist = np.bincount(merged, minlength=HLL_Q + 2)
        return int(round(estimate_from_histogram(hist, HLL_P)))

    def flush(self) -> None:
        super().flush()
        self._hlls.clear()
