"""The port's mesh engine (``attendance_tpu_torch/parallel/sharded.py``)
against the JAX package's ``ShardedSketchEngine``.

The JAX engine runs on conftest's 8 virtual CPU devices; the port's on
``make_mesh(..., devices=["cpu"] * n)``, whose cells run the kernels'
plain versions. Inputs are made with numpy from a seed. Every comparison
is exact (tolerance 0), but the fill fraction: JAX sums its popcounts in
float32, so it is held at rel 1e-5 (as the JAX package's own test holds
it, tests/test_sharded_pipeline.py:250).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attendance_tpu.models import fused as jfused
from attendance_tpu.models.bloom import bloom_positions as jax_positions
from attendance_tpu.models.fused import pack_words
from attendance_tpu.models.hll import (
    estimate_from_histogram, hll_bucket_rank_np)
from attendance_tpu.parallel.sharded import (
    ShardedSketchEngine as JaxEngine, make_mesh as jax_mesh)
from attendance_tpu_torch.models.bloom import derive_bloom_params
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.parallel import (
    Mesh, ShardedSketchEngine, make_mesh)

# tests/test_sharded.py's shapes; (3, 2): dp divides neither the preload
# chunk nor a power-of-two batch.
MESH_SHAPES = [(1, 8), (2, 4), (3, 2)]


def engines(dp, sp, **kw):
    """The JAX engine and the port's on the same (dp, sp) shape."""
    capacity = kw.pop("capacity", 20_000)
    num_banks = kw.pop("num_banks", 8)
    jax_eng = JaxEngine(jax_mesh(num_shards=sp, num_replicas=dp),
                        capacity=capacity, error_rate=0.01,
                        num_banks=num_banks, **kw)
    port = ShardedSketchEngine(make_mesh(sp, dp, ["cpu"] * (dp * sp)),
                               capacity=capacity, error_rate=0.01,
                               num_banks=num_banks, **kw)
    return jax_eng, port


def assert_same_engine(jax_eng, port, probe=None):
    """Every answer and every piece of state of the two engines equal."""
    bj, rj = jax_eng.get_state()
    bt, rt = port.get_state()
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(rt, rj)
    assert port.validity_counts() == jax_eng.validity_counts()
    np.testing.assert_array_equal(port.get_counts(), jax_eng.get_counts())
    np.testing.assert_array_equal(port.count_all(), jax_eng.count_all())
    for bank in (0, port.num_banks - 1):
        assert port.count(bank) == jax_eng.count(bank)
    assert port.fill_fraction() == pytest.approx(jax_eng.fill_fraction(),
                                                 rel=1e-5)
    if probe is not None:
        np.testing.assert_array_equal(port.contains(probe),
                                      jax_eng.contains(probe))


def _t(arr) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy (a JAX shard's host view is not)
    return torch.from_numpy(arr.view(np.int32) if arr.dtype == np.uint32
                            else arr)


def _shards(arr):
    """(first index of each axis, host data) of a JAX array's shards (a
    single-device array is one whole shard)."""
    return [(tuple(i.start or 0 for i in sh.index), np.asarray(sh.data))
            for sh in arr.addressable_shards]


def _jax_local_contains(words_loc, keys, params, lo_word):
    """``local_contains`` (attendance_tpu/parallel/sharded.py:304) with
    JAX's own functions, on one slice whose first word is ``lo_word``."""
    m_local = words_loc.shape[0] * 32
    pos = jax_positions(jnp.asarray(keys), params).astype(jnp.int32)
    rel = pos - lo_word * 32
    in_range = (rel >= 0) & (rel < m_local)
    words_loc = jnp.asarray(words_loc)
    word = words_loc[jnp.clip(rel >> 5, 0, words_loc.shape[0] - 1)]
    bit = (jnp.clip(rel, 0, m_local - 1) & 31).astype(jnp.uint32)
    probes = jnp.where(in_range, (word >> bit) & jnp.uint32(1),
                       jnp.uint32(1))
    return np.asarray(jnp.all(probes == jnp.uint32(1), axis=1))


@pytest.mark.parametrize("dp,sp", MESH_SHAPES + [(1, 1)])
def test_slice_plain_versions_equal_jax_per_shard(dp, sp):
    """K9, K10 and K11's plain versions on each shard of the JAX engine's
    own state: K11 of the roster into a zero slice is JAX's preloaded
    shard (``bloom_add_kernel``); K9 on each shard is ``local_contains``
    there, and the AND across sp is JAX's ``contains``; K10 (and the
    counter bump) on each register shard before a step, on both wires,
    is that shard after it (``hll_add_local``, ``bump_local``)."""
    jax_eng, port = engines(dp, sp)
    params = port.params
    wl, rl = jax_eng.m_words // sp, jax_eng.m_regs // sp
    assert (wl, rl) == (port.words_local, port.regs_local)
    rng = np.random.default_rng(dp * 10 + sp)
    roster = rng.choice(1 << 20, 6_000, replace=False).astype(np.uint32)
    jax_eng.preload(roster)

    for (first,), data in _shards(jax_eng.bits):
        words = torch.zeros(wl, dtype=torch.int32)
        kernels.bloom_add_slice_plain(words, _t(roster), params, first)
        np.testing.assert_array_equal(words.numpy().view(np.uint32), data)

    probe = np.concatenate([rng.choice(roster, 1500),
                            rng.integers(1 << 20, 1 << 22, 1500)
                            ]).astype(np.uint32)
    every = np.ones(len(probe), bool)
    for (first,), data in _shards(jax_eng.bits):
        got = kernels.bloom_contains_slice_plain(
            _t(data), _t(probe), params, first).numpy().astype(bool)
        np.testing.assert_array_equal(
            got, _jax_local_contains(data, probe, params, first))
        every &= got
    np.testing.assert_array_equal(every, jax_eng.contains(probe))

    n, kw = 3_000, 22
    keys = np.where(rng.random(n) < 0.6, rng.choice(roster, n),
                    rng.integers(1 << 20, 1 << 21, n)).astype(np.uint32)
    banks = rng.integers(0, 8, n).astype(np.int32)
    padded = jax_eng.padded_size(n)
    local = padded // dp
    for wire in ("arrays", "words"):
        regs_before = _shards(jax_eng.regs)
        counts_before = {i[0]: c for i, c in _shards(jax_eng.counts)}
        if wire == "arrays":
            valid = np.asarray(jax_eng.step(keys, banks))
            lanes = np.zeros(padded, np.uint32)
            lanes[:n] = keys
            bank = np.full(padded, -1, np.int32)
            bank[:n] = banks
        else:
            lanes = pack_words(keys, banks, kw, padded)
            valid = np.asarray(jax_eng.step_words(lanes, n, kw))
            bank = None
        valid_all = np.zeros(padded, bool)
        valid_all[:n] = valid
        after = {i: r for i, r in _shards(jax_eng.regs)}
        counts_after = {i[0]: c for i, c in _shards(jax_eng.counts)}
        for (r, _, lo), before in regs_before:
            sl = slice(r * local, (r + 1) * local)
            regs = torch.from_numpy(before[0].copy())
            counts = _t(counts_before[r][0].copy())
            kernels.hll_add_slice_plain(
                regs, _t(lanes[sl]), torch.from_numpy(valid_all[sl]), lo, 14,
                None if bank is None else _t(bank[sl]),
                kw if wire == "words" else 0,
                min(max(n - r * local, 0), local), counts)
            np.testing.assert_array_equal(regs.numpy(),
                                          after[(r, 0, lo)][0])
            np.testing.assert_array_equal(counts.numpy().view(np.uint32),
                                          counts_after[r][0])


@pytest.mark.parametrize("dp,sp", MESH_SHAPES + [(1, 1)])
def test_one_call_preload_equals_jax_chunked_preload(dp, sp):
    """The port's preload (one K11 call a cell over its replica's whole
    share, or one K3 call on the 1 x 1 mesh) gives the JAX engine's
    words, which it builds from 2^14-key chunks padded with a repeat of
    a key: a 40,000-key roster is more than two chunks and no multiple
    of one."""
    jax_eng, port = engines(dp, sp, capacity=50_000)
    rng = np.random.default_rng(100 + dp * 10 + sp)
    roster = rng.choice(1 << 24, 40_000, replace=False).astype(np.uint32)
    jax_eng.preload(roster)
    port.preload(roster)
    np.testing.assert_array_equal(port.get_state()[0],
                                  jax_eng.get_state()[0])
    # Every replica holds the union, not its own share.
    for s in range(port.sp):
        for r in range(1, port.dp):
            assert torch.equal(port.bits[r][s], port.bits[0][s])
    assert port.contains(roster).all()
    assert_same_engine(jax_eng, port, rng.integers(
        1 << 24, 1 << 25, 5_000).astype(np.uint32))


@pytest.mark.parametrize("dp,sp", MESH_SHAPES + [(1, 1)])
def test_preload_onto_a_filled_filter_equals_jax(dp, sp):
    """A second roster preloaded onto a filter that already holds the
    first (overlapping it, and of another length) gives the JAX
    engine's words: the OR keeps what the filter held."""
    jax_eng, port = engines(dp, sp, capacity=50_000)
    rng = np.random.default_rng(200 + dp * 10 + sp)
    first = rng.choice(1 << 24, 40_000, replace=False).astype(np.uint32)
    second = np.concatenate([
        first[:5_000], rng.integers(1 << 24, 1 << 25, 20_001)
    ]).astype(np.uint32)
    for eng in (jax_eng, port):
        eng.preload(first)
    held = port.get_state()[0]
    for eng in (jax_eng, port):
        eng.preload(second)
    words = port.get_state()[0]
    np.testing.assert_array_equal(words, jax_eng.get_state()[0])
    assert not (held & ~words).any()
    assert port.contains(first).all() and port.contains(second).all()
    assert_same_engine(jax_eng, port)


def _k11_slices(capacity: int, sp: int):
    """(filter blocks, a slice's blocks) of the mesh engine's cut."""
    params = derive_bloom_params(capacity, 0.01, "blocked")
    chunk = sp * 512
    m_alloc = -(-params.m_bits // chunk) * chunk
    return params.m_bits // 512, m_alloc // 512 // sp


@pytest.mark.parametrize("capacity,sp,share", [
    (10_000_000, 4, 5_000_000), (10_000_000, 8, 10_000_000),
    (10_000_000, 1, 10_000_000), (100_000, 4, 50_000),
    (40_000, 3, 13_334), ((1 << 18) + 1, 8, (1 << 18) + 1),
    (1_000, 8, 1)])
def test_k11_binned_plan_covers_the_slice(capacity, sp, share):
    """K11's binned plan for a replica's share into one slice: its tiles
    (at most 2^9 blocks, 32 KB of shared memory in the OR pass) cover the
    slice's blocks and no more tiles than that; its CTAs cover the
    share; its scratch holds the per-tile and per-(CTA, tile) arrays and
    a payload for a share that lies wholly in the slice (sp = 1); the
    scatter pass's shared memory fits a CTA."""
    num_blocks, slice_blocks = _k11_slices(capacity, sp)
    assert slice_blocks * sp >= num_blocks
    log2_bpt, chunk, scratch = kernels.bloom_add_plan(share, slice_blocks)
    per_tile = 1 << log2_bpt
    tiles = -(-slice_blocks // per_tile)
    ctas = -(-share // chunk)
    assert 0 <= log2_bpt <= 9 and 64 * per_tile <= 32 * 1024
    assert tiles * per_tile >= slice_blocks > (tiles - 1) * per_tile
    assert ctas * chunk >= share > (ctas - 1) * chunk
    assert scratch == 2 * tiles + 1 + 2 * ctas * tiles + share
    assert 4 * (3 * tiles + 2 + chunk) <= 227 * 1024


@pytest.mark.parametrize("dp,sp", MESH_SHAPES)
def test_no_false_negatives_any_mesh(dp, sp):
    jax_eng, port = engines(dp, sp, layout="blocked")
    roster = np.arange(10_000, 15_000, dtype=np.uint32)
    jax_eng.preload(roster)
    port.preload(roster)
    assert port.contains(roster).all()
    # The allocation padding (sp x 512 bits) is zero and stripped.
    assert port.m_words * 32 == jax_eng.m_alloc
    pad = torch.cat([b for b in port.bits[0]])[port.params.m_bits // 32:]
    assert not pad.any()
    assert_same_engine(jax_eng, port,
                       np.arange(9_000, 40_000, 7, dtype=np.uint32))


@pytest.mark.parametrize("dp,sp", [(2, 4)])
def test_sharded_matches_single_device(dp, sp):
    """Same inputs -> the same validity and counts on every mesh shape,
    in both packages."""
    jax_eng, port = engines(dp, sp)
    ref = ShardedSketchEngine(make_mesh(1, 1, ["cpu"]), capacity=20_000,
                              error_rate=0.01, num_banks=8)
    roster = np.arange(10_000, 14_000, dtype=np.uint32)
    for eng in (jax_eng, port, ref):
        eng.preload(roster)
    rng = np.random.default_rng(0)
    keys = rng.choice(
        np.concatenate([roster, np.arange(1 << 20, (1 << 20) + 4_000,
                                          dtype=np.uint32)]), size=4_096)
    banks = rng.integers(0, 8, size=4_096).astype(np.int32)
    v_jax = np.asarray(jax_eng.step(keys, banks))
    np.testing.assert_array_equal(port.step(keys, banks).numpy(), v_jax)
    np.testing.assert_array_equal(ref.step(keys, banks).numpy(), v_jax)
    for b in range(8):
        assert port.count(b) == ref.count(b) == jax_eng.count(b)
    assert_same_engine(jax_eng, port)


@pytest.mark.parametrize("dp,sp", [(2, 4)])
def test_step_words_matches_step(dp, sp):
    """The packed word wire onto the mesh is observationally the (keys,
    banks, mask) wire, padded lanes included, in both packages."""
    jax_ref, ref = engines(dp, sp)
    jax_eng, port = engines(dp, sp)
    roster = np.arange(10_000, 14_000, dtype=np.uint32)
    for eng in (jax_ref, ref, jax_eng, port):
        eng.preload(roster)
    rng = np.random.default_rng(7)
    n = 3_000  # pads to 4096
    keys = rng.choice(
        np.concatenate([roster, np.arange(1 << 20, (1 << 20) + 4_000,
                                          dtype=np.uint32)]),
        size=n).astype(np.uint32)
    banks = rng.integers(0, 8, size=n).astype(np.int32)
    v_ref = ref.step(keys, banks).numpy()
    np.testing.assert_array_equal(v_ref, np.asarray(jax_ref.step(keys,
                                                                 banks)))
    kw = int(keys.max()).bit_length()
    words = pack_words(keys, banks, kw, port.padded_size(n))
    v_eng = port.step_words(words, n, kw).numpy()
    np.testing.assert_array_equal(v_ref, v_eng)
    np.testing.assert_array_equal(
        v_eng, np.asarray(jax_eng.step_words(words, n, kw)))
    for b in range(8):
        assert ref.count(b) == port.count(b)
    assert_same_engine(jax_eng, port)
    assert_same_engine(jax_ref, ref)


def test_dp_replicas_converge_to_union_state():
    """Keys processed by replica 0 are counted whichever replica is
    read: the max-union at query time."""
    jax_eng, port = engines(2, 4)
    roster = np.arange(20_000, 24_000, dtype=np.uint32)
    keys = roster[:4_000]
    banks = np.zeros(4_000, dtype=np.int32)
    for eng in (jax_eng, port):
        eng.preload(roster)
        assert np.asarray(eng.step(keys, banks)).all()
    assert port.count(0) == pytest.approx(4_000, rel=0.05)
    assert_same_engine(jax_eng, port)


def test_sharded_hist_matches_numpy_oracle():
    """The mesh histogram (max across dp, K1 per slice, summed across
    sp) + Ertl estimate == the numpy oracle == the JAX engine."""
    rng = np.random.default_rng(2)
    keys = rng.choice(1 << 30, size=50_000, replace=False).astype(np.uint32)
    bucket, rank = hll_bucket_rank_np(keys, 14)
    regs = np.zeros(1 << 14, dtype=np.uint8)
    np.maximum.at(regs, bucket, rank.astype(np.uint8))
    oracle = int(round(estimate_from_histogram(
        np.bincount(regs, minlength=52), 14)))
    jax_eng, port = engines(2, 4, capacity=60_000)
    for eng in (jax_eng, port):
        eng.preload(keys)
        eng.step(keys, np.zeros(len(keys), dtype=np.int32))
    assert port.count(0) == oracle == jax_eng.count(0)
    hist = port._hist()
    np.testing.assert_array_equal(hist[0], np.bincount(
        port.get_state()[1][0], minlength=52))


def test_replica_sync_modes_equivalent():
    """'step' (per-batch union) and 'query' (deferred union): the same
    validity, counts and merged state, in both packages."""
    rng = np.random.default_rng(5)
    roster = rng.choice(1 << 20, 4000, replace=False).astype(np.uint32)
    engs = {}
    for mode in ("step", "query"):
        engs[mode] = engines(4, 2, capacity=10_000, num_banks=4,
                             replica_sync=mode)
        for eng in engs[mode]:
            eng.preload(roster)
    outs = {}
    for i in range(6):
        keys = np.where(rng.random(500) < 0.5,
                        roster[(np.arange(500) * (i + 7)) % len(roster)],
                        (1 << 21) + np.arange(500) * (i + 1)
                        ).astype(np.uint32)
        banks = (np.arange(500) % 4).astype(np.int32)
        for mode, (jax_eng, port) in engs.items():
            v = port.step(keys, banks).numpy()
            np.testing.assert_array_equal(v, np.asarray(jax_eng.step(keys,
                                                                     banks)))
            outs.setdefault(i, []).append(v)
    for a, b in outs.values():
        np.testing.assert_array_equal(a, b)
    step_port, query_port = engs["step"][1], engs["query"][1]
    # In step mode every replica holds the union after each step.
    for s in range(step_port.sp):
        for r in range(1, step_port.dp):
            assert torch.equal(step_port.regs[r][s], step_port.regs[0][s])
    assert not all(torch.equal(query_port.regs[r][0], query_port.regs[0][0])
                   for r in range(1, query_port.dp))
    for bank in range(4):
        assert step_port.count(bank) == query_port.count(bank)
    for a, b in zip(step_port.get_state(), query_port.get_state()):
        np.testing.assert_array_equal(a, b)
    for jax_eng, port in engs.values():
        assert_same_engine(jax_eng, port)


def test_replica_sync_cross_mode_restore():
    """A state taken in one sync mode on one shape restores into the
    other mode on another shape, across the packages both ways."""
    rng = np.random.default_rng(9)
    roster = rng.choice(1 << 20, 2000, replace=False).astype(np.uint32)
    keys = roster[:1000]
    banks = (np.arange(1000) % 4).astype(np.int32)
    jax_src, port_src = engines(2, 4, capacity=10_000, num_banks=4,
                                replica_sync="query")
    for eng in (jax_src, port_src):
        eng.preload(roster)
        eng.step(keys, banks)
    jax_dst, port_dst = engines(4, 2, capacity=10_000, num_banks=4,
                                replica_sync="step")
    bits, regs = jax_src.get_state()
    port_dst.set_state(bits, regs)            # JAX -> port
    bits_t, regs_t = port_src.get_state()
    jax_dst.set_state(bits_t, regs_t)         # port -> JAX
    for bank in range(4):
        assert port_dst.count(bank) == jax_src.count(bank)
        assert jax_dst.count(bank) == port_src.count(bank)
    assert port_dst.contains(keys).all()
    assert_same_engine(jax_dst, port_dst, keys)


def test_single_device_mesh_delegates_bit_identically():
    """The 1 x 1 mesh runs the single-card kernels (K3, K2, K4, K1):
    every answer and state equal to the 2 x 4 mesh and to both JAX
    builds, on the word wire and on the arrays step, whose 1 x 1 form is
    K2's bytes wire with 4-byte bank ids (the padding edge: 2,049 real
    lanes of 4,096)."""
    jax_single, single = engines(1, 1)
    jax_multi, multi = engines(2, 4)
    assert single.single and not multi.single
    roster = np.arange(30_000, 38_000, dtype=np.uint32)
    pairs = ((jax_single, single), (jax_multi, multi))
    for jax_eng, port in pairs:
        jax_eng.preload(roster)
        port.preload(roster)
    rng = np.random.default_rng(3)
    kw = 17
    for n in (2_048, 2_049):
        keys = np.where(rng.random(n) < 0.7, rng.choice(roster, n),
                        rng.integers(1 << 20, 1 << 21, n)).astype(np.uint32)
        banks = rng.integers(0, 8, n).astype(np.int32)
        words = pack_words(keys[:n], banks[:n] % 8, kw, 4096)
        outs = []
        for jax_eng, port in pairs:
            v_words = port.step_words(words, n, kw).numpy()
            np.testing.assert_array_equal(
                v_words, np.asarray(jax_eng.step_words(words, n, kw)))
            v_arrays = port.step(keys, banks).numpy()
            np.testing.assert_array_equal(
                v_arrays, np.asarray(jax_eng.step(keys, banks)))
            outs.append((v_words, v_arrays))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
    probe = np.concatenate([roster[:1000],
                            np.arange(1 << 22, (1 << 22) + 1000,
                                      dtype=np.uint32)])
    np.testing.assert_array_equal(single.contains(probe),
                                  multi.contains(probe))
    np.testing.assert_array_equal(single.count_all(), multi.count_all())
    assert single.validity_counts() == multi.validity_counts()
    assert single.fill_fraction() == multi.fill_fraction()
    for a, b in zip(single.get_state(), multi.get_state()):
        np.testing.assert_array_equal(a, b)
    for jax_eng, port in pairs:
        assert_same_engine(jax_eng, port, probe)
    fresh = ShardedSketchEngine(make_mesh(1, 1, ["cpu"]), capacity=20_000,
                                error_rate=0.01, num_banks=8)
    fresh.set_state(*multi.get_state())
    fresh.set_counts(multi.get_counts())
    np.testing.assert_array_equal(fresh.get_state()[0],
                                  multi.get_state()[0])
    assert fresh.validity_counts() == multi.validity_counts()


def test_grow_banks_keeps_state_and_counts_new_banks():
    """Bank growth zero-extends every cell; the merged state and the
    JAX engine's growth agree, and a step into a new bank counts."""
    jax_eng, port = engines(2, 4, num_banks=4)
    roster = np.arange(10_000, 12_000, dtype=np.uint32)
    keys, banks = roster[:1500], (np.arange(1500) % 4).astype(np.int32)
    for eng in (jax_eng, port):
        eng.preload(roster)
        eng.step(keys, banks)
        eng.grow_banks(8)
        eng.step(keys[:500], np.full(500, 6, np.int32))
    assert port.num_banks == 8
    assert all(r.shape == (8, port.regs_local) and r.is_contiguous()
               for row in port.regs for r in row)
    assert port.count(6) > 0
    assert_same_engine(jax_eng, port)


def _narrow_frame(eng, keys, banks, mode):
    """(bufs uint32[dp, words], width, padded_local): the frame cut into
    dp contiguous slices of ``padded_local`` lanes, each packed on its own
    with the JAX packers and a header of the engine's banks, one shared
    width (the pipeline's ``_dispatch_sharded_narrow``)."""
    n, dp, nb = len(keys), eng.dp, eng.num_banks
    padded_local = eng.padded_size(n) // dp
    bounds = [min(n, r * padded_local) for r in range(dp + 1)]
    parts = [(keys[bounds[r]:bounds[r + 1]], banks[bounds[r]:bounds[r + 1]])
             for r in range(dp)]
    if mode == "seg":
        width = max(int(keys.max()).bit_length(), 1)
        bufs = [jfused.pack_seg(k, b, width, padded_local, nb)[0]
                for k, b in parts]
    else:
        scans = [jfused.delta_scan(k, b, nb) for k, b in parts]
        width = jfused.pick_delta_width(1, max(sc[-1] for sc in scans))
        bufs = [jfused.pack_delta(k, b, width, padded_local, nb, scan=sc)[0]
                for (k, b), sc in zip(parts, scans)]
    return np.stack([np.asarray(b, np.uint32) for b in bufs]), width, \
        padded_local


@pytest.mark.parametrize("mode", ["seg", "delta"])
@pytest.mark.parametrize("dp,sp", [(1, 1), (2, 2), (2, 4), (1, 8)])
def test_step_narrow_equals_jax(dp, sp, mode):
    """``step_narrow`` against JAX's on the same per-replica buffers, in
    both sync modes' default ("query"): validity of every lane in packed
    per-slice order, merged registers, counters and PFCOUNTs equal.
    Frames: 3,000 lanes (the padding fills the last replica's slice, or
    most of it), lanes only in the header's last bank after seven empty
    ones, and a full frame over banks 0-5 (the header's last two
    empty)."""
    jax_eng, port = engines(dp, sp)
    rng = np.random.default_rng(300 + dp * 10 + sp)
    roster = rng.choice(1 << 20, 6_000, replace=False).astype(np.uint32)
    for eng in (jax_eng, port):
        eng.preload(roster)
    for n, bank_set in ((3_000, np.arange(8)), (2_500, np.array([7])),
                        (4_096, np.arange(6))):
        keys = np.where(rng.random(n) < 0.7, rng.choice(roster, n),
                        rng.integers(1 << 20, 1 << 21, n)).astype(np.uint32)
        banks = rng.choice(bank_set, n).astype(np.int32)
        bufs, width, padded_local = _narrow_frame(port, keys, banks, mode)
        got = port.step_narrow(bufs, mode, width, padded_local)
        want = np.asarray(jax_eng.step_narrow(bufs, mode, width,
                                              padded_local))
        assert got.dtype == torch.bool
        assert got.shape == (dp * padded_local,)
        np.testing.assert_array_equal(got.numpy(), want)
    assert sum(port.validity_counts()) == 3_000 + 2_500 + 4_096
    assert_same_engine(jax_eng, port, roster[:500])


@pytest.mark.parametrize("mode", ["seg", "delta"])
def test_decode_wrappers_cpu_route_equals_jax_decode(mode):
    """K12's wrappers on a CPU tensor (their plain versions) give JAX's
    ``decode_seg_lanes`` / ``decode_delta_lanes``: keys, and banks with -1
    on padding, on a frame with padding lanes, empty banks and a delta
    sum past 2^32."""
    rng = np.random.default_rng(11)
    n, padded, nb = 3_001, 4_096, 12
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    banks = rng.choice([1, 2, 5, 6, 7, 8, 9, 10], n).astype(np.int32)
    if mode == "seg":
        width = 32
        buf, _ = jfused.pack_seg(keys, banks, width, padded, nb)
        want = jfused.decode_seg_lanes(jnp.asarray(buf), width, padded, nb)
        decode = kernels.decode_seg
    else:
        scan = jfused.delta_scan(keys, banks, nb)
        width = jfused.pick_delta_width(1, scan[-1])
        buf, _ = jfused.pack_delta(keys, banks, width, padded, nb, scan=scan)
        want = jfused.decode_delta_lanes(jnp.asarray(buf), width, padded, nb)
        decode = kernels.decode_delta
    before = dict(kernels.launches)
    got_keys, got_bank = decode(_t(buf), padded=padded, num_banks=nb,
                                **{"kb" if mode == "seg" else "db": width})
    assert kernels.launches == before  # the plain version launches nothing
    assert got_keys.dtype == got_bank.dtype == torch.int32
    np.testing.assert_array_equal(got_keys.numpy().view(np.uint32),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got_bank.numpy(), np.asarray(want[1]))
    assert (got_bank.numpy()[:n] >= 0).all()
    assert (got_bank.numpy()[n:] == -1).all()


def test_make_mesh_refuses_too_few_devices():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    with pytest.raises(ValueError, match="need 16 devices"):
        make_mesh(num_shards=16, num_replicas=1, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        # devices=None is every CUDA device of the process: none here.
        with pytest.raises(ValueError, match="need 1 devices"):
            make_mesh(1, 1)
    mesh = make_mesh(2, 3, ["cpu"] * 7)
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"dp": 3, "sp": 2} and not mesh.multiprocess


def test_engine_refusals():
    mesh = make_mesh(2, 1, ["cpu"] * 2)
    with pytest.raises(ValueError, match="blocked-only"):
        ShardedSketchEngine(mesh, 1000, 0.01, layout="flat")
    with pytest.raises(ValueError, match="replica_sync"):
        ShardedSketchEngine(mesh, 1000, 0.01, replica_sync="never")
    with pytest.raises(ValueError, match="must divide"):
        ShardedSketchEngine(make_mesh(3, 1, ["cpu"] * 3), 1000, 0.01)
    eng = ShardedSketchEngine(mesh, 1000, 0.01, num_banks=2)
    with pytest.raises(ValueError, match=">= 0"):
        eng.step(np.arange(4, dtype=np.uint32), np.array([0, -1, 0, 0]))
    with pytest.raises(ValueError, match="words"):
        eng.set_state(np.zeros(3, np.uint32), np.zeros((2, 1 << 14),
                                                       np.uint8))


@pytest.mark.parametrize("width", [8, 24, 100, 1 << 15])
def test_histogram_slice_width_check_still_raises(width):
    """K1 takes a register slice whose width divides 2^p and is a
    multiple of 16; any other width raises, naming what it accepts."""
    regs = torch.zeros((2, width), dtype=torch.uint8)
    with pytest.raises(ValueError, match="a divisor of 2\\^14 that is a "
                       "multiple of 16"):
        kernels.hll_histogram(regs, 14)
    for ok in (16, 2048, 1 << 14):
        assert kernels.hll_histogram(torch.zeros((2, ok), dtype=torch.uint8),
                                     14).shape == (2, 52)
