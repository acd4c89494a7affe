"""Parity of the port's generic sketch store with the JAX package, on the
CPU.

The same numpy inputs, made from a seed, go through the JAX store (XLA on
the CPU) and the port's card store on ``device="cpu"`` (every kernel's
plain PyTorch version), and through both packages' numpy memory stores.
Sketches are deterministic under fixed murmur3 seeds: filter bytes,
registers, bank maps, BF answers, PFADD return values, PFCOUNTs and
BF.INFO are equal (tolerance 0); fill fractions and FPR estimates
(float32 in JAX, float64 here) agree to 1e-6 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attendance_tpu.config import Config as JConfig
from attendance_tpu.models import bloom as jbloom
from attendance_tpu.models import hll as jhll
from attendance_tpu.sketch import base as jbase
from attendance_tpu.sketch.memory_store import MemorySketchStore as JMemory
from attendance_tpu.sketch.tpu_store import TpuSketchStore as JTpu
from attendance_tpu.utils import snapshot as jsnap
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models import bloom as tbloom
from attendance_tpu_torch.models import hll as thll
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.sketch import (
    MemorySketchStore, ResponseError, TpuSketchStore, base, make_sketch_store,
    member_to_u32)
from attendance_tpu_torch.utils import snapshot as tsnap

CPU = torch.device("cpu")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _keys(seed: int, n: int, lo: int = 0, hi: int = 2 ** 32) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        lo, hi, n, dtype=np.uint64).astype(np.uint32)


def _stores(**kw):
    """(JAX card store, port card store on the CPU) of one config."""
    return (JTpu(JConfig(**kw)),
            TpuSketchStore(Config(**kw), device="cpu"))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_state(a, b) -> None:
    """Two stores (any backend of either package) hold equal sketches."""
    assert a._blooms.keys() == b._blooms.keys()
    for key in a._blooms:
        ca, cb = a._blooms[key], b._blooms[key]
        assert ca.counts == cb.counts
        assert [tuple(p) for p in ca.params] == [tuple(p) for p in cb.params]
        for fa, fb in zip(ca.filters, cb.filters):
            np.testing.assert_array_equal(_host(fa), _host(fb))
    if hasattr(a, "_hll"):
        assert a._hll._bank_of == b._hll._bank_of
        np.testing.assert_array_equal(_host(a._hll.regs), _host(b._hll.regs))
    else:
        assert a._hll_regs.keys() == b._hll_regs.keys()
        for key in a._hll_regs:
            np.testing.assert_array_equal(a._hll_regs[key],
                                          b._hll_regs[key])


# -- K7 / K8 plain versions ---------------------------------------------------

@pytest.mark.parametrize("capacity,layout", [
    (100_000, "flat"), (100_000, "blocked"), (1000, "flat"),
    (1000, "blocked"), (3, "flat")])
def test_byte_filter_equals_jax(capacity, layout):
    params = jbloom.derive_bloom_params(capacity, 0.01, layout)
    tparams = tbloom.derive_bloom_params(capacity, 0.01, layout)
    assert tuple(params) == tuple(tparams)
    keys = _keys(capacity, 5000)
    pos = tbloom.bloom_positions_np(keys, tparams)
    np.testing.assert_array_equal(pos, jbloom.bloom_positions_np(keys,
                                                                 params))
    mask = np.random.default_rng(1).random(len(keys)) < 0.8
    jbits = jbloom.bloom_add(jbloom.bloom_init(params), jnp.asarray(keys),
                             params, jnp.asarray(mask))
    tbits = tbloom.bloom_init(tparams, CPU)
    tbloom.bloom_add(tbits, _t(keys), tparams, torch.from_numpy(mask))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    probe = np.concatenate([keys, _keys(capacity + 1, 5000)])
    np.testing.assert_array_equal(
        tbloom.bloom_contains(tbits, _t(probe), tparams).numpy(),
        np.asarray(jbloom.bloom_contains(jbits, jnp.asarray(probe), params)))
    fill = float(tbloom.bloom_fill_fraction(tbits))
    assert fill == pytest.approx(float(jbloom.bloom_fill_fraction(jbits)),
                                 rel=1e-6)


def test_flat_probe_wraps_before_the_modulo():
    """A key whose h1 + i*h2 passes 2^32: the position is the wrapped
    sum mod m (as jnp.uint32 computes), not the int64 sum mod m."""
    params = tbloom.derive_bloom_params(100_000, 0.01, "flat")
    keys = _keys(5, 256)
    h1 = tbloom.murmur3_u32_np(keys, tbloom.SEED_BLOOM_A).astype(np.int64)
    h2 = (tbloom.murmur3_u32_np(keys, tbloom.SEED_BLOOM_B)
          | 1).astype(np.int64)
    wraps = h1 + (params.k - 1) * h2 >= 2 ** 32
    assert wraps.any()
    pos = tbloom.bloom_positions(_t(keys), params).numpy()
    i = np.arange(params.k)
    want = ((h1[:, None] + i * h2[:, None]) % 2 ** 32) % params.m_bits
    np.testing.assert_array_equal(pos, want)
    assert (pos != (h1[:, None] + i * h2[:, None]) % params.m_bits)[
        wraps].any()


def test_bloom_filter_shell_equals_jax():
    j = jbloom.BloomFilter(2000, 0.01)
    t = tbloom.BloomFilter(2000, 0.01, device="cpu")
    keys = _keys(9, 1500)
    j.add(keys)
    t.add(keys)
    mask = np.arange(300) % 3 == 0
    j.add(keys[:300] + 7, mask)
    t.add(keys[:300] + 7, mask)
    np.testing.assert_array_equal(t.bits.numpy(), np.asarray(j.bits))
    probe = _keys(10, 3000)
    np.testing.assert_array_equal(t.contains(probe), j.contains(probe))
    assert (t.num_bits, t.num_hashes) == (j.num_bits, j.num_hashes)
    assert t.estimated_fpr() == pytest.approx(j.estimated_fpr(), rel=1e-6)


def test_byte_kernel_wrappers_edge_shapes_on_cpu():
    params = tbloom.derive_bloom_params(1000, 0.01, "flat")
    bits = tbloom.bloom_init(params, CPU)
    empty = torch.zeros(0, dtype=torch.int32)
    kernels.bloom_add_bytes(bits, empty, params)
    assert int(bits.sum()) == 0
    assert kernels.bloom_contains_bytes(bits, empty, params).shape == (0,)
    with pytest.raises(ValueError):
        kernels.bloom_add_bytes(bits[:-1], empty, params)
    with pytest.raises(ValueError):
        kernels.bloom_contains_bytes(bits, empty.to(torch.int64), params)


# -- HLL ----------------------------------------------------------------------

def test_hll_numpy_twins_equal_jax():
    keys = _keys(3, 4000)
    for p in (4, 14):
        tb, tr = thll.hll_bucket_rank_np(keys, p)
        jb, jr = jhll.hll_bucket_rank_np(keys, p)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tr, jr)
    rng = np.random.default_rng(4)
    a = rng.integers(0, 20, (3, 1 << 14), dtype=np.uint8)
    b = rng.integers(0, 20, (5, 1 << 14), dtype=np.uint8)
    np.testing.assert_array_equal(thll.hll_merge_np(a, b),
                                  jhll.hll_merge_np(a, b))
    np.testing.assert_array_equal(thll.hll_histograms_np(b),
                                  jhll.hll_histograms_np(b))
    np.testing.assert_array_equal(thll.estimates_from_rows(b),
                                  jhll.estimates_from_rows(b))
    np.testing.assert_array_equal(
        thll.hll_merge(torch.from_numpy(a), torch.from_numpy(b[:3])
                       ).numpy(),
        np.asarray(jhll.hll_merge(jnp.asarray(a), jnp.asarray(b[:3]))))
    with pytest.raises(ValueError):
        thll.hll_merge_np(a, b[:, :16])


def test_hyperloglog_class_equals_jax():
    """Bank growth by doubling, add, count, count_union and keys."""
    j = jhll.HyperLogLog(initial_banks=2, precision=12)
    t = thll.HyperLogLog(initial_banks=2, precision=12, device="cpu")
    names = [f"k{i}" for i in range(7)]
    for i, name in enumerate(names):
        keys = _keys(20 + i, 500 * (i + 1))
        mask = np.random.default_rng(i).random(len(keys)) < 0.9
        j.add_by_name(name, keys, mask)
        t.add_by_name(name, keys, mask)
    assert t._bank_of == j._bank_of and t.keys() == j.keys()
    assert tuple(t.regs.shape) == tuple(j.regs.shape) == (8, 1 << 12)
    np.testing.assert_array_equal(t.regs.numpy(), np.asarray(j.regs))
    for name in names + ["absent"]:
        assert t.count(name) == j.count(name)
    for sel in (names[:2], names[2:], names[::-1] + ["absent", "k1"],
                ["absent"]):
        assert t.count_union(sel) == j.count_union(sel)
    bank = np.array([0, 1, -1, 3, 0], np.int32)
    keys = _keys(40, 5)
    j.add(bank, keys)
    t.add(bank, keys)
    np.testing.assert_array_equal(t.regs.numpy(), np.asarray(j.regs))


def test_k1_rows_and_union_plain_versions():
    """Unsorted, repeated and out-of-range rows (clamped, as a JAX gather
    clamps); one row; the union of a row with itself."""
    rng = np.random.default_rng(8)
    regs_np = rng.integers(0, 30, (6, 1 << 10), dtype=np.uint8)
    regs = torch.from_numpy(regs_np)
    rows = np.array([3, 0, 3, 5, 1, 7], np.int32)
    got = kernels.hll_histogram_rows(regs, torch.from_numpy(rows), 10)
    want = np.asarray(jhll.hll_histogram(
        jnp.asarray(regs_np)[jnp.asarray(rows)], 10))
    np.testing.assert_array_equal(got.numpy(), want)
    assert kernels.hll_histogram_rows(
        regs, torch.zeros(0, dtype=torch.int32), 10).shape == (0, 56)
    for sel in ([2], [4, 4], [5, 0, 2, 2, 1]):
        merged = np.max(regs_np[sel], axis=0)
        got = kernels.hll_union_histogram(
            regs, torch.tensor(sel, dtype=torch.int32), 10)
        np.testing.assert_array_equal(
            got.numpy(), np.bincount(merged, minlength=56))
    with pytest.raises(ValueError):
        kernels.hll_union_histogram(regs, torch.zeros(0, dtype=torch.int32),
                                    10)


# -- the store ----------------------------------------------------------------

@pytest.mark.parametrize("member,want", [
    (5, 5), ("5", 5), (b"5", 5), (True, 1), (np.uint32(7), 7),
    (2 ** 32 - 1, 2 ** 32 - 1), ("4294967295", 2 ** 32 - 1)])
def test_member_to_u32_integer_members(member, want):
    assert member_to_u32(member) == jbase.member_to_u32(member) == want


@pytest.mark.parametrize("member", [
    -1, 2 ** 32, 2 ** 40, "-3", "4294967296", "test", "LECTURE_x", b"\xff",
    3.5, None, ""])
def test_member_to_u32_hashed_members(member):
    assert member_to_u32(member) == jbase.member_to_u32(member)
    arr = np.array([1, 2, 2 ** 31], np.int64)
    np.testing.assert_array_equal(base.members_to_u32(arr),
                                  jbase.members_to_u32(arr))


@pytest.mark.parametrize("backend", ["tpu", "memory", "redis-sim"])
def test_execute_command_arity_errors_and_info(backend):
    store = make_sketch_store(Config(sketch_backend=backend), device="cpu")
    for args in (("BF.RESERVE", "k", 0.01), ("BF.ADD", "k"),
                 ("BF.EXISTS", "k", "a", "b"), ("NOT.A.COMMAND", "k"),
                 ("PFADD",), ("PFCOUNT",), ("BF.INFO",), ("BF.MADD",),
                 ("BF.MEXISTS",), ("BF.ADD",), ()):
        with pytest.raises(ResponseError):
            store.execute_command(*args)
    with pytest.raises(Exception) as e:
        store.execute_command("BF.RESERVE", "k", "not-a-rate", 100)
    assert "wrong number of arguments" not in str(e.value)
    with pytest.raises(ResponseError, match="not found"):
        store.execute_command("BF.INFO", "missing")
    assert store.execute_command("BF.EXISTS", "bf", "test") == 0
    assert store.execute_command("BF.RESERVE", "bf", 0.01, 1000) is True
    with pytest.raises(ResponseError, match="exists"):
        store.execute_command("BF.RESERVE", "bf", 0.01, 1000)
    assert store.execute_command("BF.MADD", "bf", 1, 2, 2, "x") == [
        1, 1, 0, 1] if backend == "redis-sim" else [1, 1, 1, 1]
    info = store.execute_command("BF.INFO", "bf")
    assert info["Number of filters"] == 1 and info["Expansion rate"] == 2


def test_store_command_sequences_equal_jax():
    """BF.* answers, PFADD return values, PFCOUNTs (single, union and
    batched), BF.INFO, filter bytes, registers and the bank map of the
    card store equal JAX's, through chain growth and bank growth."""
    for layout in ("flat", "blocked"):
        j, t = _stores(bloom_layout=layout, hll_initial_banks=2)
        for s in (j, t):
            assert s.execute_command("BF.RESERVE", "bf", 0.01, 400)
        rng = np.random.default_rng(11)
        out = {"j": [], "t": []}
        for step in range(6):
            batch = rng.integers(10_000, 12_000, 300).astype(np.int64)
            probe = rng.integers(10_000, 14_000, 500).astype(np.int64)
            for name, s in (("j", j), ("t", t)):
                out[name].append(s.bf_add_many("bf", batch).tolist())
                out[name].append(s.bf_exists_many("bf", probe).tolist())
                out[name].append(s.execute_command("BF.INFO", "bf"))
                out[name].append(s.execute_command("BF.ADD", "auto",
                                                   int(batch[0])))
                key = f"hll:unique:L{step % 5}"
                mask = probe % 3 != 0
                out[name].append(s.pfadd_many(key, probe, mask=mask))
                out[name].append(s.pfadd_many(key, probe, mask=mask,
                                              want_changed=True))
                out[name].append([s.pfadd(key, int(m)) for m in probe[:20]])
                out[name].append(s.pfadd(key))
                out[name].append(s.pfadd(key, "str-member", b"7", -4))
                out[name].append(s.pfcount(key))
                out[name].append(s.pfcount(key, "hll:unique:L0", "none"))
                out[name].append(s.pfcount_many(
                    [key, "none", "hll:unique:L0", key]))
                out[name].append(s.execute_command("PFCOUNT", key, key))
        assert out["t"] == out["j"]
        assert j.execute_command("BF.INFO", "bf")["Number of filters"] > 2
        assert len(t.hll._bank_of) == 5 and t.hll.regs.shape[0] == 8
        _same_state(j, t)
        assert t.estimated_fpr("bf") == pytest.approx(
            j.estimated_fpr("bf"), rel=1e-6)
        assert t.estimated_fpr("auto") == pytest.approx(
            j.estimated_fpr("auto"), rel=1e-6)
        assert t.estimated_fpr("none") is j.estimated_fpr("none") is None
        assert t.drain_dirty() == j.drain_dirty()


def test_chain_growth_past_capacity_in_one_batch():
    """One batch larger than the whole chain grows it several times; each
    sub-filter takes at most its capacity, as in JAX."""
    j, t = _stores()
    keys = np.arange(50_000, 52_500, dtype=np.int64)
    keys = np.concatenate([keys, keys[:100]])  # within-batch duplicates
    assert t.bf_add_many("auto", keys).tolist() == \
        j.bf_add_many("auto", keys).tolist()
    info = t.execute_command("BF.INFO", "auto")
    assert info == j.execute_command("BF.INFO", "auto")
    assert info["Number of filters"] == 5
    _same_state(j, t)
    assert t.bf_exists_many("auto", keys).all()


def test_memory_store_equals_jax():
    j, t = JMemory(JConfig()), MemorySketchStore(Config())
    rng = np.random.default_rng(13)
    for s in (j, t):
        s.execute_command("BF.RESERVE", "bf", 0.01, 2000)
    for _ in range(3):
        batch = rng.integers(0, 2 ** 31, 1500)
        assert t.bf_add_many("bf", batch).tolist() == \
            j.bf_add_many("bf", batch).tolist()
        probe = rng.integers(0, 2 ** 31, 2000)
        assert t.bf_exists_many("bf", probe).tolist() == \
            j.bf_exists_many("bf", probe).tolist()
        assert t.pfadd("h", *probe[:50].tolist()) == \
            j.pfadd("h", *probe[:50].tolist())
        assert t.pfadd_many("h2", probe, mask=probe % 2 == 0) == \
            j.pfadd_many("h2", probe, mask=probe % 2 == 0)
    assert t.pfcount("h", "h2") == j.pfcount("h", "h2")
    assert t.pfcount_many(["h", "h2", "x"]) == j.pfcount_many(
        ["h", "h2", "x"])
    assert t.estimated_fpr("bf") == j.estimated_fpr("bf")
    _same_state(j, t)
    t.flush()
    assert t.pfcount("h") == 0 and t._blooms == {}


def test_card_store_and_memory_store_agree():
    cfg = Config(hll_initial_banks=1)
    t = TpuSketchStore(cfg, device="cpu")
    m = MemorySketchStore(cfg)
    keys = _keys(21, 3000, 10_000, 99_999)
    for s in (t, m):
        s.execute_command("BF.RESERVE", "bf", 0.01, 1000)
        s.bf_add_many("bf", keys)
        s.pfadd_many("a", keys[:1000])
        s.pfadd_many("b", keys[500:2500])
    assert (t.bf_exists_many("bf", keys + 1).tolist()
            == m.bf_exists_many("bf", keys + 1).tolist())
    assert t.pfcount_many(["a", "b"]) == m.pfcount_many(["a", "b"])
    assert t.pfcount("a", "b") == m.pfcount("a", "b")
    assert t.estimated_fpr("bf") == pytest.approx(m.estimated_fpr("bf"),
                                                  rel=1e-6)


def test_card_store_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSketchStore(Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sketch_store(Config(sketch_backend="tpu"))
    assert isinstance(make_sketch_store(Config(sketch_backend="memory")),
                      MemorySketchStore)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_one_shot_snapshot_restores_across_packages(tmp_path, direction):
    j, t = _stores(hll_initial_banks=2)
    rng = np.random.default_rng(17)
    for s in (j, t):
        s.execute_command("BF.RESERVE", "bf", 0.01, 300)
        s.bf_add_many("bf", np.arange(10_000, 11_000))
        for i in range(5):
            s.pfadd_many(f"h{i}", rng.integers(0, 10 ** 6, 400))
        rng = np.random.default_rng(17)
    path = tmp_path / "snap.npz"
    if direction == "jax_to_port":
        jsnap.snapshot_sketch_store(j, path)
        fresh = TpuSketchStore(Config(), device="cpu")
        tsnap.restore_sketch_store(fresh, path)
        writer, (a, b) = j, (j, fresh)
    else:
        tsnap.snapshot_sketch_store(t, path)
        fresh = JTpu(JConfig())
        jsnap.restore_sketch_store(fresh, path)
        writer, (a, b) = t, (fresh, t)
    _same_state(writer, fresh)
    # From the moved state both packages compute the same thing: more
    # adds (past the chain's capacity, and a new HLL key that grows the
    # banks) and reads.
    more = np.arange(11_000, 11_700)
    assert (a.bf_add_many("bf", more).tolist()
            == b.bf_add_many("bf", more).tolist())
    for key in ("h1", "h9"):
        assert a.pfadd(key, *more[:40].tolist()) == b.pfadd(
            key, *more[:40].tolist())
    assert a.pfcount_many(["h1", "h9", "h4"]) == b.pfcount_many(
        ["h1", "h9", "h4"])
    assert a.pfcount("h0", "h9") == b.pfcount("h0", "h9")
    _same_state(a, b)
    # The memory stores' per-key layout too.
    jm, tm = JMemory(JConfig()), MemorySketchStore(Config())
    for s in (jm, tm):
        s.bf_add_many("auto", np.arange(300))
        s.pfadd_many("h", np.arange(1000))
    (jsnap if direction == "jax_to_port" else tsnap).snapshot_sketch_store(
        jm if direction == "jax_to_port" else tm, tmp_path / "m.npz")
    back = (MemorySketchStore(Config()) if direction == "jax_to_port"
            else JMemory(JConfig()))
    (tsnap if direction == "jax_to_port" else jsnap).restore_sketch_store(
        back, tmp_path / "m.npz")
    _same_state(jm, back)


def test_config_checks():
    with pytest.raises(ValueError, match="invalid_topic"):
        Config(invalid_topic=Config().pulsar_topic)
    for bad in (dict(sketch_backend="x"), dict(bloom_layout="x"),
                dict(storage_backend="x"), dict(transport_backend="x"),
                dict(batch_size=0)):
        with pytest.raises(ValueError):
            Config(**bad)
    assert dataclasses.replace(Config(), sketch_backend="memory")


def test_filter_fill_of_an_unreadable_handle_raises():
    """The JAX base answered None for any handle np.asarray could not
    read, so a card store without its own fill printed "n/a"; the
    port's base raises, and the card store counts on the device."""

    class Opaque:
        def __array__(self, *args, **kwargs):
            raise TypeError("not a host array")

    store = MemorySketchStore(Config())
    store.execute_command("BF.RESERVE", "bf", 0.01, 100)
    store._blooms["bf"].filters[0] = Opaque()
    with pytest.raises(TypeError):
        store.estimated_fpr("bf")
    jstore = JMemory(JConfig())
    jstore.execute_command("BF.RESERVE", "bf", 0.01, 100)
    jstore._blooms["bf"].filters[0] = Opaque()
    assert jstore.estimated_fpr("bf") is None
    card = TpuSketchStore(Config(), device="cpu")
    card.bf_add_many("bf", np.arange(50))
    assert card.estimated_fpr("bf") > 0
