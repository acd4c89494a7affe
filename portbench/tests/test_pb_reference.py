"""The plain reference against a hand-worked tiny stream."""

import math

import numpy as np

from portbench import reference as ref


def murmur3_longhand(key: int, seed: int) -> int:
    """MurmurHash3_x86_32 of one 4-byte little-endian key, step by step
    in Python integers."""
    m = 0xFFFFFFFF
    k = (key * 0xCC9E2D51) & m
    k = ((k << 15) | (k >> 17)) & m
    k = (k * 0x1B873593) & m
    h = seed ^ k
    h = ((h << 13) | (h >> 19)) & m
    h = (h * 5 + 0xE6546B64) & m
    h ^= 4
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    return h ^ (h >> 16)


def test_murmur3_published_vectors_and_longhand():
    # MurmurHash3_x86_32("\0\0\0\0", 0) and ("abcd", 0).
    assert int(ref.murmur3(np.array([0], np.uint32), 0)[0]) == 0x2362F9DE
    assert int(ref.murmur3(np.array([0x64636261], np.uint32), 0)[0]) \
        == 0x43ED676A
    keys = np.array([1, 7, 10_001, 409_999, 2**32 - 1], np.uint32)
    for seed in (ref.SEED_BLOOM_A, ref.SEED_BLOCK, ref.SEED_HLL_HI):
        got = ref.murmur3(keys, seed)
        assert [int(g) for g in got] == [murmur3_longhand(int(k), seed)
                                         for k in keys]


def test_filter_sizing_is_redisbloom_at_half_the_rate():
    # bits an entry -ln(0.005) / ln(2)^2 = 11.03; k = ceil(7.64) = 8.
    assert ref.filter_params(100_000, 0.01)[:2] == (1_102_848, 8)
    assert ref.filter_params(10_000_000, 0.01)[:2] == (110_277_632, 8)
    # The flat layout at eps: 9.59 bits an entry, k = ceil(6.64) = 7.
    assert ref.filter_params(100_000, 0.01, "flat")[:2] == (958_976, 7)


def test_tiny_stream_worked_by_hand():
    f = ref.Filter(m_bits=1024, k=3)  # two blocks
    roster = np.array([5, 9], np.uint32)
    words = ref.build_filter(roster, f)
    want = np.zeros(32, np.uint32)
    for key in (5, 9):
        h1 = murmur3_longhand(key, ref.SEED_BLOOM_A)
        h2 = murmur3_longhand(key, ref.SEED_BLOOM_B) | 1
        h3 = murmur3_longhand(key, ref.SEED_BLOCK) | 1
        for i in range(3):
            bit = (h1 % 2) * 512 + ((h2 + i * h3) & 0xFFFFFFFF) % 512
            want[bit // 32] |= np.uint32(1 << (bit % 32))
    assert np.array_equal(words, want)
    assert ref.contains(words, roster, f).all()
    # One probe fewer sets a strict subset of the bits.
    fewer = ref.build_filter(roster, f, probes=2)
    assert np.array_equal(fewer & words, fewer)

    p = 4
    regs = np.zeros((2, 1 << p), np.uint8)
    ref.pfadd(regs, np.array([0, 0, 1]), np.array([5, 5, 9], np.uint32), p)
    for row, key in ((0, 5), (1, 9)):
        h = (murmur3_longhand(key, ref.SEED_HLL_HI) << 32) \
            | murmur3_longhand(key, ref.SEED_HLL_LO)
        rest = h >> p
        rank = (rest & -rest).bit_length() if rest else 64 - p + 1
        expect = np.zeros(1 << p, np.uint8)
        expect[h & 15] = rank
        assert np.array_equal(regs[row], expect)


def test_pfcount_small_and_empty():
    assert ref.pfcount(np.zeros(1 << 14, np.uint8), 14) == 0
    regs = np.zeros((1, 1 << 14), np.uint8)
    keys = np.arange(1, 1001, dtype=np.uint32)
    ref.pfadd(regs, np.zeros(1000, np.int64), keys, 14)
    # Ertl's estimator is within HLL's ~0.8% at p = 14 here.
    assert math.isclose(ref.pfcount(regs[0], 14), 1000, rel_tol=0.02)


def test_no_false_negatives():
    rng = np.random.default_rng(3)
    f = ref.filter_params(5000, 0.01)
    roster = rng.choice(1 << 24, 5000, replace=False).astype(np.uint32)
    words = ref.build_filter(roster, f, chunk=777)
    assert ref.contains(words, roster, f).all()
    others = rng.integers(1 << 24, 1 << 25, 20000).astype(np.uint32)
    assert ref.contains(words, others, f).mean() < 0.02
