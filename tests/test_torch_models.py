"""Parity of the port's sketch models with the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function
(Pallas kernels in interpret mode, as tests/test_pallas_kernels.py runs
them) and through the port's plain PyTorch version on ``device="cpu"``.
Sketches are deterministic under fixed murmur3 seeds: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attendance_tpu.models import bloom as jbloom
from attendance_tpu.models import fused as jfused
from attendance_tpu.models import hll as jhll
from attendance_tpu.ops.pallas_kernels import hll_histogram_pallas
from attendance_tpu_torch.models import bloom as tbloom
from attendance_tpu_torch.models import fused as tfused
from attendance_tpu_torch.models import hll as thll
from attendance_tpu_torch.ops import kernels

CPU = torch.device("cpu")


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy keys -> the port's int32 storage."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _keys(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


# -- Bloom --------------------------------------------------------------------

@pytest.mark.parametrize("capacity,eps,layout", [
    (1, 0.5, "flat"), (1000, 0.01, "flat"), (1000, 0.01, "blocked"),
    (100_000, 0.01, "blocked"), (10_000_000, 0.01, "blocked"),
    (12_345, 0.001, "flat"), (777, 0.2, "blocked")])
def test_derive_bloom_params_matches_jax(capacity, eps, layout):
    assert tuple(tbloom.derive_bloom_params(capacity, eps, layout)) == \
        tuple(jbloom.derive_bloom_params(capacity, eps, layout))


def test_derive_bloom_params_rejects_bad_input():
    with pytest.raises(ValueError):
        tbloom.derive_bloom_params(0, 0.01)
    with pytest.raises(ValueError):
        tbloom.derive_bloom_params(10, 1.0)


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_bloom_positions_match_jax(layout):
    params = tbloom.derive_bloom_params(5000, 0.01, layout)
    keys = _keys(1, 20_000)
    want = np.asarray(jbloom.bloom_positions(
        keys, jbloom.BloomParams(*params)))
    got = tbloom.bloom_positions(_t(keys), params).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


_jax_preload = jax.jit(jbloom.bloom_add_packed, static_argnums=2)


def _roster(kind: str, capacity: int, params, rng) -> np.ndarray:
    """A preload batch: distinct ids, ids repeated within the batch, or
    ids whose Bloom blocks are a few of the filter's."""
    if kind == "duplicates":
        return rng.choice(rng.integers(0, 1 << 22, 300).astype(np.uint32),
                          capacity)
    roster = rng.choice(1 << 22, capacity, replace=False).astype(np.uint32)
    if kind == "few_blocks":
        blocks = tbloom.bloom_positions(_t(roster), params)[:, 0] >> 9
        roster = roster[np.isin(blocks.numpy(), [3, 4, 99])]
    return roster


@pytest.mark.parametrize("capacity,kind", [
    pytest.param(1000, "distinct", id="1000"),
    pytest.param(20_000, "distinct", id="20000"),
    pytest.param(20_000, "duplicates", id="duplicates"),
    pytest.param(20_000, "few_blocks", id="few_blocks"),
    pytest.param(10, "distinct", id="one_block")])
def test_preloaded_words_and_contains_match_jax(capacity, kind):
    params = tbloom.derive_bloom_params(capacity, 0.01, "blocked")
    jparams = jbloom.BloomParams(*params)
    rng = np.random.default_rng(capacity)
    roster = _roster(kind, capacity, params, rng)
    assert len(roster) and (kind != "few_blocks" or len(roster) < 200)
    want = np.asarray(_jax_preload(
        jbloom.bloom_packed_init(jparams), jnp.asarray(roster), jparams))
    words = tbloom.bloom_packed_init(params, CPU)
    tbloom.bloom_add_packed(words, _t(roster), params)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    # Adding again is idempotent (replayed preload).
    tbloom.bloom_add_packed(words, _t(roster[:100]), params)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)

    probe = np.concatenate([roster[:500], rng.integers(
        1 << 22, 1 << 31, 5000).astype(np.uint32)])
    want_in = np.asarray(jbloom.bloom_contains_words(
        jnp.asarray(want), jnp.asarray(probe), jparams))
    got_in = tbloom.bloom_contains_words(words, _t(probe), params).numpy()
    np.testing.assert_array_equal(got_in, want_in)
    assert got_in[:min(500, len(roster))].all()  # no false negatives
    fill = float(tbloom.bloom_packed_fill_fraction(words))
    assert fill == pytest.approx(
        float(jbloom.bloom_packed_fill_fraction(jnp.asarray(want))),
        abs=1e-7)  # float32 mean on the JAX side
    assert fill == jbloom.bloom_packed_fill_fraction_np(want)


def test_pack_unpack_bloom_bits_round_trip():
    bits = torch.from_numpy(
        (np.random.default_rng(5).random(512 * 3) < 0.3).astype(np.uint8))
    words = tbloom.pack_bloom_bits(bits)
    want = np.asarray(jbloom.pack_bloom_bits(jnp.asarray(bits.numpy())))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    assert torch.equal(tbloom.unpack_bloom_bits(words), bits)


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_pack_bloom_bits_matches_jax_on_the_roster_filters(layout):
    """The plain version of K8's pack pass at the image path's real
    shapes: the 100k-roster filters (958,976 bits flat, 1,102,848
    blocked) holding a seeded 90,000-id roster, built by both packages.
    The packed image answers every probe as the bytes do."""
    params = tbloom.derive_bloom_params(100_000, 0.01, layout)
    jparams = jbloom.BloomParams(*params)
    rng = np.random.default_rng(10)
    roster = rng.permutation(np.arange(10_000, 100_000, dtype=np.uint32))
    jbits = jbloom.bloom_add(jnp.zeros(params.m_bits, jnp.uint8),
                             jnp.asarray(roster), jparams)
    bits = tbloom.bloom_init(params, CPU)
    tbloom.bloom_add_plain(bits, _t(roster), params)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    want = np.asarray(jbloom.pack_bloom_bits(jbits))
    words = tbloom.pack_bloom_bits(bits)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    assert torch.equal(kernels.bloom_pack_bytes(bits), words)
    probe = _t(np.concatenate([roster[:5000], rng.integers(
        100_000, 1 << 32, 50_000, dtype=np.uint64).astype(np.uint32)]))
    assert torch.equal(tbloom.bloom_contains_words(words, probe, params),
                       tbloom.bloom_contains_plain(bits, probe, params))


# -- HLL ----------------------------------------------------------------------

@pytest.mark.parametrize("precision", [4, 10, 14, 18])
def test_bucket_rank_matches_jax(precision):
    keys = np.concatenate([np.array([0, 1, 2 ** 31, 2 ** 32 - 1],
                                    np.uint32), _keys(precision, 50_000)])
    jb, jr = jhll.hll_bucket_rank(jnp.asarray(keys), precision)
    tb, tr = thll.hll_bucket_rank(_t(keys), precision)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def _one_word_keys(n: int, seed: int) -> np.ndarray:
    """n keys whose HLL buckets (p=14) are the four registers of one
    32-bit word, 4w..4w+3, with many different ranks."""
    pool = _keys(seed, 1 << 21)
    bucket, _ = thll.hll_bucket_rank(_t(pool), 14)
    return np.random.default_rng(seed).choice(
        pool[(bucket.numpy() >> 2) == 123], n)


@pytest.mark.parametrize("with_mask,case", [
    pytest.param(False, "uniform", id="False"),
    pytest.param(True, "uniform", id="True"),
    pytest.param(False, "one_word", id="one_word"),
    pytest.param(True, "one_word", id="one_word_masked")])
def test_hll_add_matches_jax(with_mask, case):
    rng = np.random.default_rng(7)
    n, banks = 30_000, 6
    keys = _keys(8, n)
    bank_idx = rng.integers(-1, banks + 1, n).astype(np.int32)  # -1, OOB
    if case == "one_word":
        # Lanes that max into the same registers with different ranks.
        keys = _one_word_keys(n, 9)
        bank_idx = np.where(rng.random(n) < 0.9, 2, -1).astype(np.int32)
        assert len(np.unique(np.asarray(jhll.hll_bucket_rank(
            jnp.asarray(keys), 14)[1]))) > 4
    mask = rng.random(n) < 0.7 if with_mask else None
    want = np.asarray(jhll.hll_add(
        jhll.hll_init(banks, 14), jnp.asarray(bank_idx), jnp.asarray(keys),
        None if mask is None else jnp.asarray(mask), 14))
    regs = thll.hll_init(banks, 14, CPU)
    thll.hll_add(regs, torch.from_numpy(bank_idx), _t(keys),
                 None if mask is None else torch.from_numpy(mask), 14)
    np.testing.assert_array_equal(regs.numpy(), want)


def _filled_regs(num_banks: int, seed: int, n: int = 200_000,
                 precision: int = 14):
    rng = np.random.default_rng(seed)
    return np.array(jhll.hll_add(
        jhll.hll_init(num_banks, precision),
        jnp.asarray(rng.integers(0, num_banks, n, dtype=np.int32)),
        jnp.asarray(rng.integers(0, 1 << 31, n).astype(np.uint32)),
        precision=precision))


@pytest.mark.parametrize("num_banks,precision", [
    (1, 14), (8, 14), (1, 4), (3, 4), (1, 18), (3, 18)],
    ids=["1", "8", "1-p4", "3-p4", "1-p18", "3-p18"])
def test_histogram_matches_pallas_kernel(num_banks, precision):
    # p=4: 16 registers a bank, each hit many times (values near q+1);
    # p=18: 262,144 a bank, most still 0.
    regs = _filled_regs(num_banks, num_banks, precision=precision)
    want = np.asarray(hll_histogram_pallas(jnp.asarray(regs), precision))
    got = thll.best_histogram(torch.from_numpy(regs), precision)
    assert got.dtype == torch.int32
    assert got.shape == (num_banks, 64 - precision + 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_of_a_row_slice_drops_values_past_q_plus_1():
    """What count(day) passes (one row of the bank array at an offset),
    holding a register value >= q+2, which both sides drop."""
    regs = _filled_regs(8, 3)
    regs[5, :3] = [62, 63, 255]  # q + 2 = 52 bins at p=14
    want = np.asarray(hll_histogram_pallas(jnp.asarray(regs[5:6])))
    got = kernels.hll_histogram(torch.from_numpy(regs)[5:6], 14)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == (1 << 14) - 3


def test_histogram_matches_xla_bincount_at_256_banks():
    regs = _filled_regs(256, 256, n=400_000)
    want = np.asarray(jhll.hll_histogram(jnp.asarray(regs)))
    got = thll.best_histogram(torch.from_numpy(regs), 14).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum(axis=1).tolist() == [16384] * 256


@pytest.mark.parametrize("precision", [4, 11, 14, 18])
def test_estimator_matches_jax(precision):
    rng = np.random.default_rng(precision)
    q = 64 - precision
    for _ in range(5):
        hist = rng.multinomial(1 << precision, rng.dirichlet(
            np.ones(q + 2)))
        assert thll.estimate_from_histogram(hist, precision) == \
            jhll.estimate_from_histogram(hist, precision)
    empty = np.zeros(q + 2)
    empty[0] = 1 << precision
    assert thll.estimate_from_histogram(empty, precision) == 0.0


# -- fused step ---------------------------------------------------------------

def _start_state(num_banks: int, seed: int):
    """A preloaded filter, partly filled registers and counters whose
    valid lo lane sits just below 2^32 (the carry must propagate)."""
    params = tbloom.derive_bloom_params(5000, 0.01, "blocked")
    jparams = jbloom.BloomParams(*params)
    rng = np.random.default_rng(seed)
    roster = rng.choice(1 << 20, 5000, replace=False).astype(np.uint32)
    bits = np.asarray(_jax_preload(
        jbloom.bloom_packed_init(jparams), jnp.asarray(roster), jparams))
    regs = _filled_regs(num_banks, seed, n=20_000)
    counts = np.array([[0xFFFFFFF0, 7], [0xFFFFFFFF, 0]], np.uint32)
    return params, jparams, roster, bits, regs, counts


def _lanes(roster, num_banks, n, seed):
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(n) < 0.8,
                    roster[rng.integers(0, len(roster), n)],
                    rng.integers(1 << 20, 1 << 21, n).astype(np.uint32))
    banks = rng.integers(0, num_banks, n).astype(np.int32)
    return keys.astype(np.uint32), banks


def _jax_state(bits, regs, counts):
    return jfused.SketchState(jnp.asarray(bits), jnp.asarray(regs),
                              jnp.asarray(counts))


def _assert_same(jstate, jvalid, tstate, tvalid):
    tb, tr, tc = tfused.state_to_numpy(tstate)
    np.testing.assert_array_equal(tb, np.asarray(jstate.bloom_bits))
    np.testing.assert_array_equal(tr, np.asarray(jstate.hll_regs))
    np.testing.assert_array_equal(tc, np.asarray(jstate.counts))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert tfused.decode_counts(tstate.counts) == \
        jfused.decode_counts(jstate.counts)


@pytest.mark.parametrize("key_bits,batch", [
    pytest.param(21, "mixed", id="21"), pytest.param(24, "mixed", id="24"),
    # One roster key in every real lane, one bank, 1096 padding lanes:
    # exactly one register may rise.
    pytest.param(22, "one_key", id="one_key-22")])
def test_fused_step_words_matches_jax(key_bits, batch):
    num_banks, n, padded = 12, 3000, 4096
    params, jparams, roster, bits, regs, counts = _start_state(num_banks, 3)
    keys, banks = _lanes(roster, num_banks, n, 4)
    if batch == "one_key":
        keys = np.full(n, roster[17], np.uint32)
        banks = np.full(n, 5, np.int32)
    words = tfused.pack_words(keys, banks, key_bits, padded)
    np.testing.assert_array_equal(
        words, jfused.pack_words(keys, banks, key_bits, padded))
    jstate, jvalid = jax.jit(jfused.fused_step_words, static_argnums=(2, 3))(
        _jax_state(bits, regs, counts), jnp.asarray(words), jparams,
        key_bits)
    tstate = tfused.state_from_numpy(bits, regs, counts, CPU)
    tvalid = tfused.fused_step_words(tstate, _t(words), params, key_bits)
    _assert_same(jstate, jvalid, tstate, tvalid)
    valid, invalid = tfused.decode_counts(tstate.counts)
    assert valid > 0xFFFFFFFF  # the lo lane carried into hi
    if batch == "one_key":
        assert tvalid[:n].all() and not tvalid[n:].any()
        assert int((tfused.state_to_numpy(tstate)[1] != regs).sum()) <= 1


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
def test_fused_step_bytes_matches_jax(dtype):
    num_banks, n, padded = 12, 3000, 4096
    params, jparams, roster, bits, regs, counts = _start_state(num_banks, 5)
    keys, banks = _lanes(roster, num_banks, n, 6)
    buf = tfused.pack_bytes(keys, banks, dtype, padded)
    np.testing.assert_array_equal(
        buf, jfused.pack_bytes(keys, banks, dtype, padded))
    w = np.dtype(dtype).itemsize
    jstate, jvalid = jax.jit(jfused.fused_step_bytes, static_argnums=(2, 3))(
        _jax_state(bits, regs, counts), jnp.asarray(buf), jparams, w)
    tstate = tfused.state_from_numpy(bits, regs, counts, CPU)
    tvalid = tfused.fused_step_bytes(tstate, torch.from_numpy(buf), params,
                                     w)
    _assert_same(jstate, jvalid, tstate, tvalid)


def test_bank_wire_dtype_and_pack_guard_match_jax():
    for nb in (1, 255, 256, 65535, 65536):
        assert tfused.bank_wire_dtype(nb) is jfused.bank_wire_dtype(nb)
    with pytest.raises(ValueError):
        tfused.pack_words(np.array([1], np.uint32), np.array([15]), 28, 256)


def test_state_round_trip_is_byte_equal():
    _, _, _, bits, regs, counts = _start_state(4, 9)
    state = tfused.state_from_numpy(bits, regs, counts, CPU)
    assert state.bloom_bits.dtype == torch.int32
    for a, b in zip(tfused.state_to_numpy(state), (bits, regs, counts)):
        assert a.tobytes() == b.tobytes()


def test_kernel_wrappers_validate_inputs():
    params = tbloom.derive_bloom_params(1000, 0.01, "blocked")
    words = tbloom.bloom_packed_init(params, CPU)
    regs = thll.hll_init(2, 14, CPU)
    counts = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.hll_histogram(regs.to(torch.int32), 14)
    with pytest.raises(ValueError):
        kernels.bloom_add(words[:-1], _t(np.arange(4)), params)
    with pytest.raises(ValueError):  # word wire needs 1 <= key_bits <= 31
        kernels.fused_step(words, regs, counts, _t(np.arange(4)), params,
                           bank_bytes=0, key_bits=0)
    with pytest.raises(ValueError):  # bytes wire length not (4 + w) * B
        kernels.fused_step(words, regs, counts,
                           torch.zeros(7, dtype=torch.uint8), params,
                           bank_bytes=2)
    with pytest.raises(ValueError, match="tensors on"):  # mixed devices
        kernels.fused_step(words.to("meta"), regs, counts,
                           torch.zeros(6, dtype=torch.uint8), params,
                           bank_bytes=2)
    # The CPU path never launches a kernel.
    kernels.reset_launches()
    kernels.hll_histogram(regs, 14)
    assert kernels.launches == {"hll_histogram": 0, "fused_step": 0,
                                "fused_step_seg": 0, "fused_step_delta": 0,
                                "bloom_add": 0, "bloom_contains": 0,
                                "hll_add": 0, "cms_step": 0,
                                "bloom_add_bytes": 0,
                                "bloom_contains_bytes": 0,
                                "hll_histogram_rows": 0,
                                "hll_union_histogram": 0,
                                "bloom_pack_bytes": 0,
                                "bloom_contains_slice": 0,
                                "hll_add_slice": 0, "bloom_add_slice": 0,
                                "decode_seg": 0, "decode_delta": 0}
