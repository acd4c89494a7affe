"""The port's CUDA kernels against their plain PyTorch versions, on the
card: ``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``
(``--noconftest``: ``tests/conftest.py`` imports jax, which a machine
with only the port need not have).

Every test needs a CUDA card and skips inside the test when there is
none (never at import, so every test worker collects the same tests).
The sketches are integer functions: equality is exact.
"""

import numpy as np
import pytest
import torch

from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models import bloom, cms, fused, hll
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline.events import decode_planar_batch
from attendance_tpu_torch.pipeline.fast_path import (EVENTS_SEGMENTS,
                                                     FusedPipeline)
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

pytestmark = pytest.mark.gpu

LANES = 131_072  # one frame of the main path


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(rng, n, hi=1 << 32):
    return torch.from_numpy(rng.integers(0, hi, n, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))


def _regs(num_banks, cuda, events=1 << 20, seed=0):
    rng = np.random.default_rng(seed)
    regs = hll.hll_init(num_banks, 14, cuda)
    hll.hll_add(regs, torch.from_numpy(rng.integers(
        0, num_banks, events, dtype=np.int32)).to(cuda),
        _keys(rng, events).to(cuda), precision=14)
    return regs


def _filled(num_banks, precision, fill, cuda, seed=0):
    """uint8[num_banks, 2^p] registers: all 0, all q+1 ("saturated"), or
    each register the rank of a Poisson number of keys, 0.25 a register
    ("sparse", mostly 0) or 4 ("dense", mostly 1-5, the main path's
    load), drawn by inverting P(value <= v) = exp(-lambda 2^-v)."""
    q = 64 - precision
    shape = (num_banks, 1 << precision)
    if fill == "zero":
        return torch.zeros(shape, dtype=torch.uint8, device=cuda)
    if fill == "saturated":
        return torch.full(shape, q + 1, dtype=torch.uint8, device=cuda)
    lam = {"sparse": 0.25, "dense": 4.0}[fill]
    g = torch.Generator(device=cuda).manual_seed(seed)
    u = torch.rand(shape, generator=g, device=cuda)
    v = torch.ceil(torch.log2(lam / -torch.log(u)))
    return v.nan_to_num(0.0).clamp(0, q + 1).to(torch.uint8)


@pytest.mark.parametrize("fill", ["zero", "sparse", "dense", "saturated"])
@pytest.mark.parametrize("precision", [4, 14, 18])
@pytest.mark.parametrize("num_banks", [1, 3, 9, 16, 256, 512, 1024])
def test_histogram_kernel_matches_plain(num_banks, precision, fill, cuda):
    """K1 at every bank count the PFCOUNT path launches it at, counts
    that are not a multiple of the cluster split (3, 9), the smallest
    and largest precision, and fills whose counts pile on one value."""
    regs = _filled(num_banks, precision, fill, cuda)
    before = kernels.launches["hll_histogram"]
    got = kernels.hll_histogram(regs, precision)
    torch.cuda.synchronize()
    assert kernels.launches["hll_histogram"] == before + 1
    assert torch.equal(got, hll.hll_histogram(regs, precision))
    assert got.sum(dim=1).eq(1 << precision).all()


@pytest.mark.parametrize("precision", [4, 14, 18])
def test_histogram_kernel_row_slice_drops_values_past_q_plus_1(precision,
                                                               cuda):
    """One row at an offset (what count(day) passes) holding values
    >= q+2, which are dropped."""
    q = 64 - precision
    regs = _filled(16, precision, "dense", cuda, seed=1)
    regs[5, :4] = torch.tensor([q + 1, q + 2, 64, 255], dtype=torch.uint8)
    got = kernels.hll_histogram(regs[5:6], precision)
    torch.cuda.synchronize()
    assert torch.equal(got, hll.hll_histogram(regs[5:6], precision))
    assert int(got.sum()) == (1 << precision) - 3
    assert int(got[0, q + 1]) >= 1


@pytest.mark.parametrize("capacity", [100_000, 10_000_000])
def test_bloom_add_kernel_matches_plain(capacity, cuda):
    params = bloom.derive_bloom_params(capacity, 0.01, "blocked")
    rng = np.random.default_rng(capacity)
    roster = torch.from_numpy(rng.choice(
        np.arange(10_000, 10_000 + 4 * capacity, dtype=np.uint32),
        capacity, replace=False).view(np.int32)).to(cuda)
    words = bloom.bloom_packed_init(params, cuda)
    kernels.bloom_add(words, roster, params)
    plain = bloom.bloom_packed_init(params, cuda)
    bloom.bloom_add_packed_plain(plain, roster, params)
    torch.cuda.synchronize()
    assert torch.equal(words, plain)
    assert bloom.bloom_contains_words(words, roster[:100_000], params).all()
    # The path the wrapper did not pick gives the same words.
    other = bloom.bloom_packed_init(params, cuda)
    kernels.bloom_add(other, roster, params,
                      binned=capacity < kernels.K3_BINNED_MIN_KEYS)
    torch.cuda.synchronize()
    assert torch.equal(other, plain)


def _keys_in_blocks(params, blocks, n, seed):
    """n keys (int32) whose Bloom block (h1 % num_blocks) is in
    ``blocks``, drawn from seeded random keys."""
    rng = np.random.default_rng(seed)
    got = []
    while sum(map(len, got)) < n:
        pool = _keys(rng, 1 << 20)
        block = bloom.bloom_positions(pool, params)[:, 0] >> 9
        got.append(pool[torch.isin(block, torch.tensor(blocks))])
    return torch.cat(got)[:n]


def _bloom_add_case(case):
    """(params, keys, keys already in the filter) of one K3 case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    params = bloom.derive_bloom_params(100_000, 0.01, "blocked")
    if case == "one_block":
        params = bloom.derive_bloom_params(10, 0.01, "blocked")
        return params, _keys(rng, 5000), None
    if case == "one_tile":
        # Every key's block in tile 5 of the binned path's tiles.
        log2_bpt, _, _ = kernels.bloom_add_plan(
            20_000, params.m_bits // bloom.BLOCK_BITS)
        tile = list(range(5 << log2_bpt, 6 << log2_bpt))
        return params, _keys_in_blocks(params, tile, 20_000, 1), None
    if case == "duplicates":
        return params, _keys(rng, 500)[rng.integers(0, 500, 300_000)], None
    if case.startswith("n="):
        return params, _keys(rng, int(case[2:])), None
    assert case == "onto_filter"
    return params, _keys(rng, 60_000), _keys(rng, 60_000)


@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("case", ["one_block", "one_tile", "duplicates",
                                  "n=1", "n=255", "n=257", "onto_filter"])
def test_bloom_add_kernel_cases(case, binned, cuda):
    """K3 by each path on what its structures stress: one block, every
    key in one tile, repeated keys, batches around one CTA, and a
    preload onto a filter that already holds other keys."""
    params, keys, held = _bloom_add_case(case)
    keys = keys.to(cuda)
    words = bloom.bloom_packed_init(params, cuda)
    if held is not None:
        bloom.bloom_add_packed_plain(words, held.to(cuda), params)
        assert words.any()
    plain = words.clone()
    before = kernels.launches["bloom_add"]
    kernels.bloom_add(words, keys, params, binned=binned)
    bloom.bloom_add_packed_plain(plain, keys, params)
    torch.cuda.synchronize()
    assert kernels.launches["bloom_add"] == before + 1
    assert torch.equal(words, plain)
    assert bloom.bloom_contains_words(words, keys, params).all()


@pytest.mark.parametrize("bank_bytes", [0, 1, 2, 4])
def test_fused_step_kernel_matches_plain(bank_bytes, cuda):
    num_banks, n, padded = 200, 100_000, 131_072
    state, params = fused.init_state(100_000, 0.01, "blocked", num_banks,
                                     14, cuda)
    rng = np.random.default_rng(bank_bytes)
    roster = rng.choice(400_000, 100_000, replace=False).astype(np.uint32)
    bloom.bloom_add_packed_plain(
        state.bloom_bits, torch.from_numpy(roster.view(np.int32)).to(cuda),
        params)
    keys = np.where(rng.random(n) < 0.9, rng.choice(roster, n),
                    rng.integers(500_000, 900_000, n)).astype(np.uint32)
    banks = rng.integers(0, num_banks, n).astype(np.int32)
    if bank_bytes == 0:
        wire = torch.from_numpy(
            fused.pack_words(keys, banks, 20, padded).view(np.int32))
    else:
        dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[bank_bytes]
        wire = torch.from_numpy(fused.pack_bytes(keys, banks, dtype, padded))
    wire = wire.to(cuda)
    state.counts.copy_(torch.tensor([[-16, 3], [5, 0]], dtype=torch.int32))
    twin = fused.SketchState(*(t.clone() for t in state))
    valid = kernels.fused_step(*state, wire, params, bank_bytes=bank_bytes,
                               key_bits=20)
    want = kernels.fused_step_plain(*twin, wire, params, bank_bytes, 20, 14)
    torch.cuda.synchronize()
    assert torch.equal(valid, want)
    assert torch.equal(state.hll_regs, twin.hll_regs)
    assert torch.equal(state.counts, twin.counts)
    nv, ni = fused.decode_counts(state.counts)
    assert nv > 2 ** 32 and nv + ni == n + (2 ** 32 - 16 + 3 * 2 ** 32) + 5


def test_empty_inputs_launch_nothing(cuda):
    params = bloom.derive_bloom_params(1000, 0.01, "blocked")
    state, _ = fused.init_state(1000, 0.01, "blocked", 4, 14, cuda)
    kernels.reset_launches()
    kernels.bloom_add(state.bloom_bits, torch.zeros(0, dtype=torch.int32,
                                                    device=cuda), params)
    valid = kernels.fused_step(*state, torch.zeros(0, dtype=torch.int32,
                                                   device=cuda),
                               params, bank_bytes=0, key_bits=20)
    hist = kernels.hll_histogram(state.hll_regs[:0], 14)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    hit = kernels.bloom_contains(state.bloom_bits, empty, params)
    kernels.hll_add(state.hll_regs, empty, empty)
    est = kernels.cms_step(cms.cms_init(4, 64, cuda), empty)
    assert valid.shape == (0,) and hist.shape == (0, 52)
    assert hit.shape == (0,) and est.shape == (0,)
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    params = bloom.derive_bloom_params(1000, 0.01, "blocked")
    state, _ = fused.init_state(1000, 0.01, "blocked", 4, 14, cuda)
    wire = torch.zeros(5 * 256 + 1, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        kernels.fused_step(*state, wire[1:], params, bank_bytes=1)
    with pytest.raises(ValueError, match="tensors on"):
        kernels.fused_step(*state, wire[:-1].cpu(), params, bank_bytes=1)
    with pytest.raises(ValueError, match="tensors on"):
        kernels.bloom_add(state.bloom_bits, torch.zeros(4, dtype=torch.int32),
                          params)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.hll_histogram(hll.hll_init(4, 14, cuda)[::2], 14)
    keys = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tensors on"):
        kernels.hll_add(state.hll_regs, keys.cpu(), keys)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.bloom_contains(state.bloom_bits, keys[::2], params)
    with pytest.raises(ValueError, match="tensors on"):
        kernels.cms_step(cms.cms_init(4, 64, cuda), keys,
                         torch.ones(8, dtype=torch.bool))


def test_pipeline_on_card_equals_cpu(cuda):
    """The whole slice on the card equals its plain run on the CPU, and
    the card's run launched all three kernels."""
    results = []
    for device in (cuda, torch.device("cpu")):
        kernels.reset_launches()
        pipe = FusedPipeline(Config(bloom_filter_capacity=20_000),
                             num_banks=8, device=device)
        roster, frames = generate_frames(80_000, 16_384, roster_size=20_000,
                                         num_lectures=12, seed=1)
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=80_000, idle_timeout_s=0.3)
        counts = pipe.count_all()
        results.append((fused.state_to_numpy(pipe.state),
                        pipe.validity_counts(), counts,
                        pipe.store.to_columns(deduplicate=False)["is_valid"],
                        dict(kernels.launches)))
        pipe.cleanup()
    (card, cpu) = results
    for a, b in zip(card[0], cpu[0]):
        np.testing.assert_array_equal(a, b)
    assert card[1:3] == cpu[1:3]
    np.testing.assert_array_equal(card[3], cpu[3])
    assert card[4] == dict(dict.fromkeys(kernels.launches, 0), bloom_add=1,
                           fused_step=5, hll_histogram=1)
    assert not any(cpu[4].values())


@pytest.mark.parametrize("capacity", [100_000, 10_000_000])
def test_bloom_contains_kernel_matches_plain(capacity, cuda):
    """K4 at a frame's width; half the keys are members."""
    params = bloom.derive_bloom_params(capacity, 0.01, "blocked")
    rng = np.random.default_rng(capacity + 1)
    roster = rng.choice(4 * capacity, capacity, replace=False).astype(
        np.uint32)
    words = bloom.bloom_packed_init(params, cuda)
    kernels.bloom_add(words, torch.from_numpy(roster.view(np.int32)).to(cuda),
                      params)
    keys = np.where(rng.random(LANES) < 0.5, rng.choice(roster, LANES),
                    rng.integers(4 * capacity, 1 << 31, LANES)
                    ).astype(np.uint32)
    keys = torch.from_numpy(keys.view(np.int32)).to(cuda)
    before = kernels.launches["bloom_contains"]
    got = kernels.bloom_contains(words, keys, params)
    want = bloom.bloom_contains_words(words, keys, params)
    torch.cuda.synchronize()
    assert kernels.launches["bloom_contains"] == before + 1
    assert torch.equal(got, want)
    assert 0.49 < float(got.float().mean()) < 0.52
    # An odd length: no padding needed.
    assert torch.equal(kernels.bloom_contains(words, keys[:1001], params),
                       want[:1001])


@pytest.mark.parametrize("masked", [True, False])
def test_hll_add_kernel_matches_plain(masked, cuda):
    """K5 at a frame's width into 512 banks, with -1 and out-of-range
    banks and about 10% of the lanes masked invalid."""
    rng = np.random.default_rng(int(masked))
    regs = _regs(512, cuda, events=1 << 18, seed=3)
    twin = regs.clone()
    bank = torch.from_numpy(rng.integers(-1, 514, LANES).astype(
        np.int32)).to(cuda)
    keys = _keys(rng, LANES).to(cuda)
    valid = (torch.from_numpy(rng.random(LANES) >= 0.1).to(cuda)
             if masked else None)
    kernels.hll_add(regs, bank, keys, valid, 14)
    hll.hll_add_plain(twin, bank, keys, valid, 14)
    torch.cuda.synchronize()
    assert torch.equal(regs, twin)


def _hll_add_case(case, cuda):
    """(start registers, bank, keys, valid) of one K5 case, 512 banks."""
    rng = np.random.default_rng(sum(map(ord, case)))
    regs = hll.hll_init(512, 14, cuda)
    if case == "temporal_hot_mix":
        # The temporal window add's shape: 48 bucket rows after 16 day
        # rows, 8 hot roster keys on 15% of the lanes, 10% invalid.
        roster = rng.choice(400_000, 100_000, replace=False).astype(np.uint32)
        hot = rng.choice(roster, 8, replace=False)
        keys = np.where(rng.random(LANES) < 0.15,
                        hot[rng.integers(0, 8, LANES)],
                        rng.choice(roster, LANES)).astype(np.uint32)
        keys = torch.from_numpy(keys.view(np.int32))
        bank = torch.from_numpy(rng.integers(16, 64, LANES).astype(np.int32))
        valid = torch.from_numpy(rng.random(LANES) >= 0.1)
    elif case == "all_masked":
        regs = _regs(512, cuda, events=1 << 16, seed=4)
        keys = _keys(rng, LANES)
        bank = torch.from_numpy(rng.integers(0, 512, LANES).astype(np.int32))
        valid = torch.zeros(LANES, dtype=torch.bool)
    elif case == "one_lane":
        keys = _keys(rng, 1)
        bank = torch.tensor([300], dtype=torch.int32)
        valid = torch.ones(1, dtype=torch.bool)
    else:
        assert case == "one_word"
        # Many lanes on one 32-bit register word (the 4 registers of
        # buckets 4w..4w+3) of one bank, with many different ranks.
        pool = _keys(rng, 1 << 22)
        bucket, _ = hll.hll_bucket_rank(pool, 14)
        keys = pool[(bucket >> 2) == 777][:4096]
        keys = keys[torch.from_numpy(rng.integers(0, len(keys), LANES))]
        bank = torch.full((LANES,), 9, dtype=torch.int32)
        valid = torch.from_numpy(rng.random(LANES) >= 0.1)
    return regs, bank.to(cuda), keys.to(cuda), valid.to(cuda)


@pytest.mark.parametrize("case", ["temporal_hot_mix", "all_masked",
                                  "one_lane", "one_word"])
def test_hll_add_kernel_cases(case, cuda):
    """K5 on what its lanes stress: the temporal hot-key mix, no lane
    kept, one lane, and many lanes maxing into one register word."""
    regs, bank, keys, valid = _hll_add_case(case, cuda)
    twin = regs.clone()
    start = regs.clone()
    before = kernels.launches["hll_add"]
    kernels.hll_add(regs, bank, keys, valid, 14)
    hll.hll_add_plain(twin, bank, keys, valid, 14)
    torch.cuda.synchronize()
    assert kernels.launches["hll_add"] == before + 1
    assert torch.equal(regs, twin)
    changed = int((regs != start).sum())
    if case == "all_masked":
        assert changed == 0
    elif case == "one_word":
        assert 1 <= changed <= 4
        _, rank = hll.hll_bucket_rank(keys[valid], 14)
        assert int(regs.max()) == int(rank.max())
        assert len(torch.unique(rank)) > 4
    else:
        assert changed >= 1


@pytest.mark.parametrize("masked", [True, False])
def test_cms_step_kernel_matches_plain(masked, cuda):
    """K6 at a frame's width into 4 x 16384 counters, with duplicate keys
    and counters one step from wrapping past 2^32 - 1."""
    rng = np.random.default_rng(10 + int(masked))
    start = rng.integers(0, 2 ** 32, (4, 16384), dtype=np.uint64).astype(
        np.uint32)
    start[:, ::2] = 0xFFFFFFFF
    counts = cms.cms_from_numpy(start, cuda)
    twin = counts.clone()
    keys = torch.from_numpy(rng.choice(_keys(rng, 20_000).numpy(), LANES)
                            ).to(cuda)
    mask = (torch.from_numpy(rng.random(LANES) >= 0.1).to(cuda)
            if masked else None)
    est = kernels.cms_step(counts, keys, mask)
    want = cms.cms_step_plain(twin, keys, mask)
    torch.cuda.synchronize()
    assert torch.equal(counts, twin)
    assert torch.equal(est, want)
    assert (cms.cms_to_numpy(counts) < start).any()  # wrapped


def test_temporal_pipeline_on_card_equals_cpu(cuda):
    """The temporal slice on the card equals its plain run on the CPU,
    evicting ring rows, and the card's run launched K1 and K4-K6."""
    results = []
    for device in (cuda, torch.device("cpu")):
        kernels.reset_launches()
        pipe = FusedPipeline(Config(
            bloom_filter_capacity=20_000, temporal_period_s=1.0,
            allowed_lateness_s=0.6, temporal_ring_banks=16, cms_topk=4,
            audit_sample=1.0), num_banks=8, device=device)
        roster, frames = generate_frames(
            60_000, 8192, roster_size=20_000, num_lectures=4, seed=2,
            disorder_frac=0.25, late_max_s=1.0)
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=60_000, idle_timeout_s=0.3)
        results.append((fused.state_to_numpy(pipe.state),
                        pipe.window_counts(), pipe.temporal_stats(),
                        cms.cms_to_numpy(pipe._temporal.cms_counts),
                        dict(pipe._bank_of), list(pipe._free_banks),
                        dict(kernels.launches)))
        pipe.cleanup()
        obs.disable()  # audit_sample > 0 turned telemetry on
    card, cpu = results
    for a, b in zip(card[0], cpu[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(card[3], cpu[3])
    assert card[1] == cpu[1] and card[1]
    assert card[2] == cpu[2] and card[2]["evictions"] > 0
    assert card[4:6] == cpu[4:6]
    assert all(card[6][k] > 0 for k in ("hll_histogram", "bloom_contains",
                                        "hll_add", "cms_step"))
    assert not any(cpu[6].values())


# Lane counts: one lane, either side of a 256-thread CTA, one short of the
# main path's frame, and a frame longer than the card's resident wave.
LANE_COUNTS = [1, 255, 257, 131_071, 1_048_576]


def _wire(keys, banks, bank_bytes, lanes, key_bits=20):
    if bank_bytes == 0:
        return torch.from_numpy(
            fused.pack_words(keys, banks, key_bits, lanes).view(np.int32))
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[bank_bytes]
    return torch.from_numpy(fused.pack_bytes(keys, banks, dtype, lanes))


def _preloaded(cuda, num_banks=200, seed=0):
    state, params = fused.init_state(100_000, 0.01, "blocked", num_banks, 14,
                                     cuda)
    roster = np.random.default_rng(seed).choice(
        400_000, 100_000, replace=False).astype(np.uint32)
    kernels.bloom_add(state.bloom_bits,
                      torch.from_numpy(roster.view(np.int32)).to(cuda),
                      params)
    return state, params, roster


@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("bank_bytes", [0, 1, 2, 4])
def test_fused_step_kernel_lane_counts(bank_bytes, lanes, cuda):
    """K2 at ragged and long frames, every wire; the last 10% of the
    lanes are padding."""
    state, params, roster = _preloaded(cuda)
    rng = np.random.default_rng(lanes + bank_bytes)
    n = max(1, lanes - lanes // 10)
    keys = np.where(rng.random(n) < 0.9, rng.choice(roster, n),
                    rng.integers(500_000, 900_000, n)).astype(np.uint32)
    banks = rng.integers(0, 200, n).astype(np.int32)
    wire = _wire(keys, banks, bank_bytes, lanes).to(cuda)
    twin = fused.SketchState(*(t.clone() for t in state))
    before = kernels.launches["fused_step"]
    valid = kernels.fused_step(*state, wire, params, bank_bytes=bank_bytes,
                               key_bits=20)
    want = kernels.fused_step_plain(*twin, wire, params, bank_bytes, 20, 14)
    torch.cuda.synchronize()
    assert kernels.launches["fused_step"] == before + 1
    assert torch.equal(valid, want)
    assert torch.equal(state.hll_regs, twin.hll_regs)
    assert torch.equal(state.counts, twin.counts)
    assert sum(fused.decode_counts(state.counts)) == n


@pytest.mark.parametrize("lanes", LANE_COUNTS)
def test_cms_step_kernel_lane_counts(lanes, cuda):
    rng = np.random.default_rng(lanes)
    counts = cms.cms_from_numpy(rng.integers(
        0, 1000, (4, 16384), dtype=np.uint64).astype(np.uint32), cuda)
    twin = counts.clone()
    keys = torch.from_numpy(rng.choice(_keys(rng, 50_000).numpy(), lanes)
                            ).to(cuda)
    before = kernels.launches["cms_step"]
    est = kernels.cms_step(counts, keys)
    want = cms.cms_step_plain(twin, keys)
    torch.cuda.synchronize()
    assert kernels.launches["cms_step"] == before + 1
    assert torch.equal(counts, twin)
    assert torch.equal(est, want)


def test_fused_step_kernel_one_key_batch(cuda):
    """Every lane holds one roster key in one bank: exactly one register
    rises, and every lane reads valid."""
    state, params, roster = _preloaded(cuda)
    lanes = 131_072
    wire = _wire(np.full(lanes, roster[5], np.uint32),
                 np.full(lanes, 7, np.int32), 0, lanes).to(cuda)
    twin = fused.SketchState(*(t.clone() for t in state))
    valid = kernels.fused_step(*state, wire, params, bank_bytes=0,
                               key_bits=20)
    want = kernels.fused_step_plain(*twin, wire, params, 0, 20, 14)
    torch.cuda.synchronize()
    assert torch.equal(valid, want) and bool(valid.all())
    assert torch.equal(state.hll_regs, twin.hll_regs)
    assert int((state.hll_regs != 0).sum()) == 1
    assert fused.decode_counts(state.counts) == (lanes, 0)


@pytest.mark.parametrize("start", [5, 2 ** 32 - 100_000])
def test_cms_step_kernel_one_key_batch(start, cuda):
    """Every lane holds one key: each row's counter for it reads
    start + n (mod 2^32; from 2^32 - 100,000 the adds cross the wrap),
    and every estimate is that value."""
    lanes = 131_072
    counts = cms.cms_from_numpy(np.full((4, 16384), start, np.uint32), cuda)
    twin = counts.clone()
    key = 123_457
    keys = torch.full((lanes,), key, dtype=torch.int32, device=cuda)
    est = kernels.cms_step(counts, keys)
    want = cms.cms_step_plain(twin, keys)
    torch.cuda.synchronize()
    assert torch.equal(counts, twin) and torch.equal(est, want)
    total = (start + lanes) % 2 ** 32
    got = cms.cms_to_numpy(counts)
    pos = cms.cms_positions_np(np.array([key], np.uint32), 4, 16384)[:, 0]
    assert got[np.arange(4), pos].tolist() == [total] * 4
    assert (est.cpu().numpy().view(np.uint32) == total).all()
    assert int((got != start).sum()) == 4


@pytest.mark.parametrize("masked", [True, False])
def test_cms_step_kernel_hot_mix(masked, cuda):
    """The temporal traffic's mix: 8 hot keys on 15% of a frame's lanes,
    the rest drawn from a 100k roster."""
    rng = np.random.default_rng(20 + int(masked))
    roster = rng.choice(400_000, 100_000, replace=False).astype(np.uint32)
    hot = rng.choice(roster, 8, replace=False)
    keys = np.where(rng.random(LANES) < 0.15, hot[rng.integers(0, 8, LANES)],
                    rng.choice(roster, LANES)).astype(np.uint32)
    keys = torch.from_numpy(keys.view(np.int32)).to(cuda)
    mask = (torch.from_numpy(rng.random(LANES) >= 0.1).to(cuda)
            if masked else None)
    counts = cms.cms_init(4, 16384, cuda)
    twin = counts.clone()
    est = kernels.cms_step(counts, keys, mask)
    want = cms.cms_step_plain(twin, keys, mask)
    torch.cuda.synchronize()
    assert torch.equal(counts, twin)
    assert torch.equal(est, want)
    if mask is None:  # an estimate never undercounts
        for h in hot.view(np.int32).tolist():
            lanes_h = keys == h
            assert int(est[lanes_h].min()) >= int(lanes_h.sum()) > 0


# K2-seg and K2-delta cases: (padded lanes, real lanes, header banks, key
# range of the non-roster lanes, empty banks). "frame" and "long" are the
# main path's shapes; "header_past_regs" packs 300 banks against the 200
# register rows (lanes of banks past them are counted, their registers
# dropped); "kb32_wrap" draws keys over all of uint32, so the seg wire is
# 32 bits wide and the delta wire's frame-wide prefix sum wraps;
# "one_bank_long" puts every lane of a long frame in one bank (a delta
# carry over up to 4,095 tiles, summed by groups); "tile_edge_heads" gives the
# banks TILE_EDGE_COUNTS, so segments start on the first and on the last
# lane of tiles (and the padding on a tile's first lane); "no_real_lane"
# is all padding; "header_512" and "header_1024" spread the lanes over
# the temporal plane's grown headers (several banks in every tile).
TILE_EDGE_COUNTS = [255, 257, 256, 255, 1, 511, 513, 512, 767, 769, 1023,
                    1025, 2047, 2049, 256, 1, 255, 4096, 4097, 4095, 256]
NARROW_CASES = {
    "frame": (131_072, 120_000, 16, 1 << 21, ()),
    "long": (1_048_576, 1_000_000, 16, 1 << 21, ()),
    "empty_banks_ragged": (4096, 3001, 12, 1 << 20, (0, 3, 4, 11)),
    "kb32_wrap": (8192, 8000, 64, 1 << 32, ()),
    "one_bank": (1024, 700, 1, 1 << 20, ()),
    "one_lane": (256, 1, 4, 1 << 20, ()),
    "header_past_regs": (2048, 1500, 300, 1 << 20, ()),
    "one_bank_long": (1_048_576, 1_048_576, 1, 1 << 21, ()),
    "tile_edge_heads": (131_072, sum(TILE_EDGE_COUNTS), 64, 1 << 21,
                        tuple(range(1, 64, 2)) + (42, 44, 46, 48)),
    "no_real_lane": (131_072, 0, 16, 1 << 21, ()),
    "header_512": (131_072, 120_000, 512, 1 << 21, ()),
    "header_1024": (131_072, 120_000, 1024, 1 << 21, ()),
}


def _narrow_case(mode, case, roster):
    """(wire buffer, width) of one K2-seg/K2-delta case, widths taken
    from the frame's own pack as the pipeline takes them."""
    lanes, n, nb, key_hi, empty = NARROW_CASES[case]
    rng = np.random.default_rng(sum(map(ord, mode + case)))
    keys = np.where(rng.random(n) < 0.9, rng.choice(roster, n),
                    rng.integers(0, key_hi, n, dtype=np.uint64)
                    ).astype(np.uint32)
    allowed = [b for b in range(nb) if b not in empty]
    if case == "tile_edge_heads":
        banks = np.repeat(allowed[:len(TILE_EDGE_COUNTS)],
                          TILE_EDGE_COUNTS).astype(np.int32)
    else:
        banks = rng.choice(allowed, n).astype(np.int32)
    if mode == "seg":
        width = max(int(keys.max()).bit_length() if n else 0, 1)
        buf, _ = fused.pack_seg(keys, banks, width, lanes, nb)
    else:
        scan = fused.delta_scan(keys, banks, nb)
        width = fused.pick_delta_width(1, scan[4])
        buf, _ = fused.pack_delta(keys, banks, width, lanes, nb, scan=scan)
        if case == "kb32_wrap":
            assert int(scan[3].astype(np.int64).sum()) >= 1 << 32
    return torch.from_numpy(buf.view(np.int32)), width


@pytest.mark.parametrize("case", list(NARROW_CASES))
@pytest.mark.parametrize("mode", ["seg", "delta"])
def test_narrow_step_kernels_match_plain(mode, case, cuda):
    """K2-seg and K2-delta against their plain versions on every lane of
    valid (padding included), the registers and the counters."""
    state, params, roster = _preloaded(cuda)
    lanes, n, nb, _, empty = NARROW_CASES[case]
    wire, width = _narrow_case(mode, case, roster)
    wire = wire.to(cuda)
    twin = fused.SketchState(*(t.clone() for t in state))
    step = kernels.fused_step_seg if mode == "seg" else \
        kernels.fused_step_delta
    plain = kernels.fused_step_seg_plain if mode == "seg" else \
        kernels.fused_step_delta_plain
    name = f"fused_step_{mode}"
    before = kernels.launches[name]
    valid = step(*state, wire, params, padded=lanes, num_banks=nb,
                 **{"kb" if mode == "seg" else "db": width})
    want = plain(*twin, wire, params, width, lanes, nb, 14)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert valid.shape == (lanes,)
    assert torch.equal(valid, want)
    assert torch.equal(state.hll_regs, twin.hll_regs)
    assert torch.equal(state.counts, twin.counts)
    assert sum(fused.decode_counts(state.counts)) == n
    for b in empty:
        assert not state.hll_regs[b].any()


@pytest.mark.parametrize("wire", ["seg", "delta"])
def test_narrow_wire_pipeline_on_card_equals_cpu(wire, cuda):
    """The slice on a narrow wire, on the card and on the CPU, with the
    native pack, through a bank growth (8 -> 16 banks): equal state and
    stored validity, and the card's run launched the wire's kernel."""
    results = []
    for device in (cuda, torch.device("cpu")):
        kernels.reset_launches()
        pipe = FusedPipeline(Config(bloom_filter_capacity=20_000,
                                    wire_format=wire),
                             num_banks=8, device=device)
        roster, frames = generate_frames(80_000, 16_384, roster_size=20_000,
                                         num_lectures=12, seed=1)
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=80_000, idle_timeout_s=0.3)
        results.append((fused.state_to_numpy(pipe.state),
                        pipe.validity_counts(), pipe.count_all(),
                        pipe.store.to_columns(deduplicate=False)["is_valid"],
                        dict(kernels.launches), dict(pipe.metrics.wire_dwell)))
        pipe.cleanup()
    card, cpu = results
    for a, b in zip(card[0], cpu[0]):
        np.testing.assert_array_equal(a, b)
    assert card[1:3] == cpu[1:3]
    np.testing.assert_array_equal(card[3], cpu[3])
    assert card[4][f"fused_step_{wire}"] == 5 and card[4]["fused_step"] == 0
    assert card[5] == cpu[5] == {wire: 5}
    assert not any(cpu[4].values())


@pytest.mark.parametrize("mode", ["seg", "delta"])
def test_narrow_step_kernels_back_to_back_and_in_graph_replays(mode, cuda):
    """Each narrow kernel launched four times back to back, then captured
    once in a CUDA graph replayed three times: valid equals the plain
    version's after every launch, the registers equal one plain step (a
    register max is idempotent) and the counters took the frame's counts
    once per launch that ran (the capture runs nothing). K2-delta's pass
    rewrites its sums on every launch, replays included, and its step is
    a programmatic dependent launch inside the graph."""
    state, params, roster = _preloaded(cuda)
    lanes, _, nb, _, _ = NARROW_CASES["frame"]  # with padding lanes
    wire, width = _narrow_case(mode, "frame", roster)
    wire = wire.to(cuda)
    step = kernels.fused_step_seg if mode == "seg" else \
        kernels.fused_step_delta
    plain = kernels.fused_step_seg_plain if mode == "seg" else \
        kernels.fused_step_delta_plain
    kw = {"kb" if mode == "seg" else "db": width}
    start = fused.SketchState(*(t.clone() for t in state))
    twin = fused.SketchState(*(t.clone() for t in state))
    want = plain(*twin, wire, params, width, lanes, nb, 14)
    for _ in range(4):
        valid = step(*state, wire, params, padded=lanes, num_banks=nb, **kw)
        torch.cuda.synchronize()
        assert torch.equal(valid, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(*state, wire, params, padded=lanes, num_banks=nb, **kw)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert torch.equal(state.hll_regs, twin.hll_regs)
    s_v, s_i = fused.decode_counts(start.counts)
    p_v, p_i = fused.decode_counts(twin.counts)
    assert fused.decode_counts(state.counts) == (s_v + 7 * (p_v - s_v),
                                                 s_i + 7 * (p_i - s_i))


def _k12_cutovers():
    """Lane counts either side of every cut-over of the K12 plans (K12-seg's
    lanes a thread, K12-delta's design)."""
    out = set()
    for cut in (kernels.K12_SEG_WIDE_MIN_LANES,
                kernels.K12_LOOKBACK_MIN_LANES):
        out |= {cut - 1, cut}
    return sorted(out)


# The mesh's lanes a replica (chip_smoke.py MESH_LANES), the plans'
# cut-overs, lanes that are not multiples of 4 or 256, and one lane.
K12_LANES = sorted({1, 3, 257, 1_023, 4_097, 65_536, 131_072, 1_048_576,
                    1_048_573, *_k12_cutovers()})
# Headers of one bank, the mesh's 16, the two-pass design's range (33 to
# 256) and either side of it, and the largest.
K12_BANKS = (1, 16, 32, 33, 256, 257, 4096, kernels.NARROW_MAX_BANKS)


def _noisy_padding(buf, base, width, n, lanes, rng):
    """Sets random bits in the fields of padding lanes n .. lanes - 1 of
    the bitstream at word ``base`` (the kernels take whatever bits a
    padding lane holds: its key on seg, its delta on delta)."""
    lo, hi = n * width, lanes * width
    if lo >= hi:
        return
    w0, w1 = lo // 32, (hi - 1) // 32
    mask = np.full(w1 - w0 + 1, 0xFFFFFFFF, np.uint64)
    mask[0] &= (0xFFFFFFFF << (lo % 32)) & 0xFFFFFFFF
    if hi % 32:
        mask[-1] &= (1 << (hi % 32)) - 1
    bits = rng.integers(0, 1 << 32, w1 - w0 + 1, dtype=np.uint64) & mask
    buf[base + w0:base + w1 + 1] |= bits.astype(np.uint32)


def _k12_wire(mode, lanes, n, nb, *, width=None, banks_used=None, seed=0):
    """(uint32 wire, width) of n real lanes in ``lanes``: banks drawn from
    ``banks_used`` (default all nb), noisy padding. Seg keys take
    ``width`` bits (default 26); delta keys climb in each bank by gaps
    that fit ``width`` bits (default: the pack's own pick)."""
    rng = np.random.default_rng(seed)
    pool = np.arange(nb) if banks_used is None else np.asarray(banks_used)
    banks = rng.choice(pool, n).astype(np.int32)
    if mode == "seg":
        kb = width or 26
        keys = rng.integers(0, 1 << kb, n, dtype=np.uint64).astype(np.uint32)
        buf, _ = fused.pack_seg(keys, banks, kb, lanes, nb)
        _noisy_padding(buf, nb, kb, n, lanes, rng)
        return buf, kb
    if width is None or width >= 27:
        keys = rng.integers(0, 1 << 32 if width else 1 << 26, n,
                            dtype=np.uint64).astype(np.uint32)
    else:  # climbing in lane order, banks sorted: a gap a lane
        banks = np.sort(banks)
        gap = max(1, min(1 << width, (1 << 32) // (n + 1)))
        keys = (np.cumsum(rng.integers(0, gap, n, dtype=np.uint64))
                % (1 << 32)).astype(np.uint32)
    scan = fused.delta_scan(keys, banks, nb)
    db = width or fused.pick_delta_width(1, scan[4])
    buf, _ = fused.pack_delta(keys, banks, db, lanes, nb, scan=scan)
    assert buf is not None
    _noisy_padding(buf, 2 * nb, db, n, lanes, rng)
    return buf, db


def _check_decode(mode, buf, width, lanes, nb, cuda, n=None, **shape):
    """One K12 call against the plain decode: keys and banks equal, int32,
    one launch counted, ``n`` real lanes (when given)."""
    wire = torch.from_numpy(buf.view(np.int32)).to(cuda)
    decode = kernels.decode_seg if mode == "seg" else kernels.decode_delta
    plain = kernels.decode_seg_lanes_plain if mode == "seg" else \
        kernels.decode_delta_lanes_plain
    before = kernels.launches[f"decode_{mode}"]
    got_keys, got_bank = decode(wire, padded=lanes, num_banks=nb,
                                **{"kb" if mode == "seg" else "db": width},
                                **shape)
    want_keys, want_bank = plain(wire, width, lanes, nb)
    torch.cuda.synchronize()
    assert kernels.launches[f"decode_{mode}"] == before + 1
    assert got_keys.dtype == got_bank.dtype == torch.int32
    assert torch.equal(got_keys.to(torch.int64) & 0xFFFFFFFF, want_keys)
    assert torch.equal(got_bank.to(torch.int64), want_bank)
    if n is not None:
        assert int((got_bank >= 0).sum()) == n


@pytest.mark.parametrize("nb", K12_BANKS)
@pytest.mark.parametrize("lanes", K12_LANES)
@pytest.mark.parametrize("mode", ["seg", "delta"])
def test_decode_kernels_match_plain(mode, lanes, nb, cuda):
    """K12-seg and K12-delta (the plan's design) at the mesh's lanes a
    replica, either side of each cut-over of the plan and at lane counts
    that are not multiples of 4 or 256, on headers of 1, 16, 4,096 and
    NARROW_MAX_BANKS banks (many banks a tile, most empty), with noisy
    padding lanes: keys and banks equal to the plain decode, one launch
    each."""
    n = lanes - lanes // 7
    buf, width = _k12_wire(mode, lanes, n, nb, seed=lanes + nb + len(mode))
    _check_decode(mode, buf, width, lanes, nb, cuda, n=n)


@pytest.mark.parametrize("mode,width", [("seg", 1), ("seg", 32)]
                         + [("delta", w) for w in range(1, 33)])
def test_decode_kernels_widths(mode, width, cuda):
    """Seg widths 1 and 32, delta widths 1 to 32, at a lane count past a
    cluster of 4 lanes a thread and not a multiple of 4."""
    lanes = 65_539
    buf, width = _k12_wire(mode, lanes, lanes - 1_000, 16, width=width,
                           seed=width)
    _check_decode(mode, buf, width, lanes, 16, cuda, n=lanes - 1_000)


K12_FRAMES = {
    # (real lanes, header banks, banks used)
    "one_real_lane": (1, 16, None),
    "all_padding": (0, 16, None),
    "no_padding": (None, 16, None),
    # one bank over every tile, empty banks before and after it
    "one_bank_spans_all": (None, 16, (7,)),
    # a few banks of a large header: each spans many CTAs
    "sparse_banks": (None, 4096, (0, 5, 4095)),
}


@pytest.mark.parametrize("lanes", [65_536, 131_075, 1_048_576])
@pytest.mark.parametrize("frame", list(K12_FRAMES))
@pytest.mark.parametrize("mode", ["seg", "delta"])
def test_decode_kernels_edge_frames(mode, frame, lanes, cuda):
    """One real lane, an all-padding frame, a frame with no padding, a bank
    that spans a whole cluster with empty banks around it, a few banks
    of a 4,096-bank header that each span many CTAs."""
    n, nb, used = K12_FRAMES[frame]
    n = lanes if n is None else n
    buf, width = _k12_wire(mode, lanes, n, nb, banks_used=used, seed=n)
    _check_decode(mode, buf, width, lanes, nb, cuda, n=n)


@pytest.mark.parametrize("nb", [1, 16, 256, 4096])
@pytest.mark.parametrize("lanes", [1, 4_097, 65_535, 131_072, 262_144,
                                   1_048_573])
@pytest.mark.parametrize("design", kernels.K12_DELTA_DESIGNS)
def test_decode_delta_designs_match_plain(design, lanes, nb, cuda):
    """Each K12-delta design, forced, at lane counts the plan gives to the
    other too, with padding lanes: equal to the plain decode."""
    n = lanes - lanes // 5
    buf, width = _k12_wire("delta", lanes, n, nb, seed=lanes + nb)
    _check_decode("delta", buf, width, lanes, nb, cuda, n=n, design=design)


@pytest.mark.parametrize("design", [None, *kernels.K12_DELTA_DESIGNS])
def test_decode_delta_back_to_back_on_two_streams(design, cuda):
    """K12-delta called back to back at changing lane counts on the
    default stream, then on a second stream, then replayed from a CUDA
    graph over changing wire contents: each call's keys and banks equal
    the plain decode's (whatever scratch the design keeps is not
    reset between calls)."""
    cases = []
    for i, lanes in enumerate([65_536, 1_000, 131_072, 1_048_576, 3,
                               262_144, 65_536]):
        n = lanes - lanes // 9
        buf, width = _k12_wire("delta", lanes, n, 16, seed=i)
        cases.append((torch.from_numpy(buf.view(np.int32)).to(cuda), width,
                      lanes))
    want = [kernels.decode_delta_lanes_plain(w, db, lanes, 16)
            for w, db, lanes in cases]

    def run_all():
        got = [kernels.decode_delta(w, db=db, padded=lanes, num_banks=16,
                                    design=design)
               for w, db, lanes in cases]
        torch.cuda.synchronize()
        for (k, b), (wk, wb) in zip(got, want):
            assert torch.equal(k.to(torch.int64) & 0xFFFFFFFF, wk)
            assert torch.equal(b.to(torch.int64), wb)

    for _ in range(3):
        run_all()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            run_all()
    torch.cuda.current_stream().wait_stream(side)

    lanes = 65_536
    wires = [_k12_wire("delta", lanes, lanes - 500 * i, 16, width=20,
                       seed=100 + i)[0] for i in range(3)]
    wire = torch.from_numpy(wires[0].view(np.int32)).to(cuda)
    kernels.decode_delta(wire, db=20, padded=lanes, num_banks=16,
                         design=design)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_k, out_b = kernels.decode_delta(wire, db=20, padded=lanes,
                                            num_banks=16, design=design)
    for buf in wires * 2:
        wire.copy_(torch.from_numpy(buf.view(np.int32)).to(cuda))
        graph.replay()
        torch.cuda.synchronize()
        wk, wb = kernels.decode_delta_lanes_plain(wire, 20, lanes, 16)
        assert torch.equal(out_k.to(torch.int64) & 0xFFFFFFFF, wk)
        assert torch.equal(out_b.to(torch.int64), wb)


def test_snapshot_capture_equals_host_copy_after_sync(cuda):
    """B9 on the card: the delta capture's rows and counters, and the
    base copy, equal a host copy taken after a device sync, although the
    next frames' steps update the state in place right after them."""
    roster, frames = generate_frames(3 * LANES, LANES, roster_size=100_000,
                                     num_lectures=16, seed=2)
    params = bloom.derive_bloom_params(100_000, 0.01, "blocked")
    state, _ = fused.init_state(100_000, 0.01, "blocked", 256, 14, cuda)
    kernels.bloom_add(state.bloom_bits,
                      torch.from_numpy(roster.view(np.int32)).to(cuda),
                      params)
    words = []
    for f in frames:
        c = decode_planar_batch(f)
        kw = int(c["student_id"].max()).bit_length()
        words.append((torch.from_numpy(fused.pack_words(
            c["student_id"], (c["lecture_day"] - 20_260_701).astype(
                np.int32), kw, LANES).view(np.int32)).to(cuda), kw))
    fused.fused_step_words(state, words[0][0], params, words[0][1])
    torch.cuda.synchronize()
    want_regs = state.hll_regs.cpu()
    want_counts = state.counts.cpu()
    idx = torch.tensor([5, 0, 15, 3, 0, 0, 0, 0], dtype=torch.int64,
                       device=cuda)
    rows, counts = fused.snapshot_capture_rows(state.hll_regs, idx,
                                               state.counts)
    base, base_counts = fused.snapshot_capture_base(state.hll_regs,
                                                    state.counts)
    for w, kw in words[1:]:
        fused.fused_step_words(state, w, params, kw)
    torch.cuda.synchronize()
    assert not torch.equal(state.counts.cpu(), want_counts)
    assert torch.equal(rows.cpu(), want_regs[idx.cpu()])
    assert torch.equal(base.cpu(), want_regs)
    assert torch.equal(counts.cpu(), want_counts)
    assert torch.equal(base_counts.cpu(), want_counts)


@pytest.mark.parametrize("mode", ["delta", "barrier"])
def test_checkpointed_pipeline_on_card_equals_cpu(mode, cuda, tmp_path):
    """A checkpointed run on the card (the capture's D2H on the writer's
    side stream) writes a chain that restores, on the card, to the CPU
    run's state, registers, counters and store alike."""
    results = []
    for device in (cuda, torch.device("cpu")):
        snap = tmp_path / str(device.type)
        config = Config(bloom_filter_capacity=20_000, snapshot_mode=mode,
                        snapshot_dir=str(snap), snapshot_every_batches=1,
                        snapshot_compact_every=3)
        pipe = FusedPipeline(config, num_banks=8, device=device)
        roster, frames = generate_frames(80_000, 16_384, roster_size=20_000,
                                         num_lectures=12, seed=1)
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=80_000, idle_timeout_s=0.3)
        assert pipe.consumer.backlog() == 0
        pipe.cleanup()
        again = FusedPipeline(config, num_banks=8, device=device)
        results.append((fused.state_to_numpy(pipe.state),
                        fused.state_to_numpy(again.state),
                        pipe.store.to_columns(), again.store.to_columns()))
        again.cleanup()
    (card, cpu) = results
    for a, b, c in zip(card[0], card[1], cpu[1]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    for name in ("student_id", "lecture_day", "micros", "is_valid"):
        np.testing.assert_array_equal(card[2][name], card[3][name])
        np.testing.assert_array_equal(card[3][name], cpu[3][name])


def test_compaction_with_frames_in_flight_keeps_stored_validity(cuda,
                                                                tmp_path):
    """A compaction every delta while later frames' steps are still
    queued on the compute stream: the writer persists only the blocks of
    its own barrier (its side stream is ordered after that capture
    alone), so the segments and the live store hold the CPU run's
    validity, block for block."""
    results = []
    for device in (cuda, torch.device("cpu")):
        snap = tmp_path / str(device.type)
        config = Config(bloom_filter_capacity=20_000, snapshot_mode="delta",
                        snapshot_dir=str(snap), snapshot_every_batches=1,
                        snapshot_compact_every=1)
        pipe = FusedPipeline(config, num_banks=8, device=device)
        roster, frames = generate_frames(98_304, 2_048, roster_size=20_000,
                                         num_lectures=12, seed=4)
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=98_304, idle_timeout_s=0.3)
        assert pipe.consumer.backlog() == 0
        assert pipe._delta_seq >= 2
        pipe.cleanup()
        segs = ColumnarEventStore()
        segs.load_segments(snap / EVENTS_SEGMENTS)
        results.append((pipe.store.to_columns(deduplicate=False),
                        segs.to_columns()))
    (card, cpu) = results
    for name in ("student_id", "lecture_day", "micros", "is_valid"):
        np.testing.assert_array_equal(card[0][name], cpu[0][name])
        np.testing.assert_array_equal(card[1][name], cpu[1][name])


# -- the generic sketch store: K7, K8, K1-rows, K1-union ----------------------

@pytest.mark.parametrize("layout", ["flat", "blocked"])
@pytest.mark.parametrize("n", [0, 1, 8192, 90_000])
def test_bloom_bytes_kernels_match_plain(layout, n, cuda):
    """K7 into the 100k-roster filter (958,976 bytes flat: its probes
    wrap mod 2^32 before the modulo), with and without a mask, then K8
    on members and non-members."""
    params = bloom.derive_bloom_params(100_000, 0.01, layout)
    rng = np.random.default_rng(n)
    keys = _keys(rng, n)
    if n:  # key 0's flat probes: h1 + j*h2 passes 2^32 from j = 1
        keys[0] = 0
    mask = torch.from_numpy(rng.random(n) < 0.7)
    for m in (None, mask):
        bits = bloom.bloom_init(params, cuda)
        plain = bloom.bloom_init(params, torch.device("cpu"))
        before = kernels.launches["bloom_add_bytes"]
        kernels.bloom_add_bytes(bits, keys.to(cuda), params,
                                None if m is None else m.to(cuda))
        bloom.bloom_add_plain(plain, keys, params, m)
        torch.cuda.synchronize()
        assert kernels.launches["bloom_add_bytes"] == before + (n > 0)
        assert torch.equal(bits.cpu(), plain)
    probe = torch.cat([keys, _keys(rng, 8192)])
    got = kernels.bloom_contains_bytes(bits, probe.to(cuda), params)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), bloom.bloom_contains_plain(
        plain, probe, params))
    assert bool(got[:n][mask.to(cuda)].all())


def test_bloom_contains_bytes_kernel_at_a_million_keys(cuda):
    params = bloom.derive_bloom_params(100_000, 0.01, "flat")
    rng = np.random.default_rng(2)
    bits = bloom.bloom_init(params, cuda)
    kernels.bloom_add_bytes(bits, _keys(rng, 90_000).to(cuda), params)
    probe = _keys(rng, 1 << 20).to(cuda)
    got = kernels.bloom_contains_bytes(bits, probe, params)
    torch.cuda.synchronize()
    assert torch.equal(got, bloom.bloom_contains_plain(bits, probe, params))


def _roster_bits(params, cuda, n=20_000):
    """A filter already holding ``n`` ids of its own (201,000 up), so an
    add must keep them."""
    bits = bloom.bloom_init(params, cuda)
    bloom.bloom_add_plain(bits, torch.arange(
        201_000, 201_000 + n, dtype=torch.int32, device=cuda), params)
    return bits


def _probe_mix(rng, members, n):
    """n keys: 90% drawn (with repeats) from ``members``, 10% others."""
    pick = members[torch.from_numpy(rng.integers(0, len(members), n))]
    return torch.where(torch.from_numpy(rng.random(n) < 0.9), pick,
                       _keys(rng, n))


@pytest.mark.parametrize("image", [False, True])
@pytest.mark.parametrize("layout", ["flat", "blocked"])
@pytest.mark.parametrize("size", [0, 1, "crossover-1", "crossover",
                                  "crossover+1", 8192, 1 << 20])
def test_bloom_contains_bytes_each_path_matches_plain(size, layout, image,
                                                      cuda):
    """K8 forced onto each path, at the layout's crossover and either
    side of it, the processor's batch and a million keys, with repeated
    keys."""
    n = size if isinstance(size, int) else (
        kernels.K8_IMAGE_MIN_KEYS[layout]
        + {"crossover-1": -1, "crossover": 0, "crossover+1": 1}[size])
    params = bloom.derive_bloom_params(100_000, 0.01, layout)
    rng = np.random.default_rng(n)
    roster = _keys(rng, 90_000)
    bits = _roster_bits(params, cuda)
    bloom.bloom_add_plain(bits, roster.to(cuda), params)
    probe = _probe_mix(rng, roster, n).to(cuda)
    before = kernels.launches["bloom_contains_bytes"]
    got = kernels.bloom_contains_bytes(bits, probe, params, image=image)
    torch.cuda.synchronize()
    assert kernels.launches["bloom_contains_bytes"] == before + (n > 0)
    assert torch.equal(got, bloom.bloom_contains_plain(bits, probe, params))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("image", [False, True])
@pytest.mark.parametrize("layout", ["flat", "blocked"])
@pytest.mark.parametrize("n", [0, 1, 90_000])
def test_bloom_add_bytes_each_path_matches_plain(n, layout, image, masked,
                                                 cuda):
    """K7 forced onto each path, onto a filter that already holds bits
    (kept), with repeated keys and with a mask."""
    params = bloom.derive_bloom_params(100_000, 0.01, layout)
    rng = np.random.default_rng(n + 1)
    keys = _keys(rng, 60_000)[torch.from_numpy(
        rng.integers(0, 60_000, n))].to(cuda)
    mask = (torch.from_numpy(rng.random(n) < 0.7).to(cuda) if masked
            else None)
    start = _roster_bits(params, cuda)
    got, want = start.clone(), start.clone()
    before = kernels.launches["bloom_add_bytes"]
    kernels.bloom_add_bytes(got, keys, params, mask, image=image)
    bloom.bloom_add_plain(want, keys, params, mask)
    torch.cuda.synchronize()
    assert kernels.launches["bloom_add_bytes"] == before + (n > 0)
    assert torch.equal(got, want)
    assert bool((got >= start).all())


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_bloom_bytes_kernels_on_a_filter_too_large_for_the_image(layout,
                                                                 cuda):
    """The scalable chain's second sub-filter (200,000 at 0.5%, 269 KiB
    packed flat) takes the direct path at any batch length."""
    params = bloom.derive_bloom_params(200_000, 0.005, layout)
    rng = np.random.default_rng(9)
    keys = _keys(rng, 150_000).to(cuda)
    got = _roster_bits(params, cuda)
    want = got.clone()
    kernels.bloom_add_bytes(got, keys, params)
    bloom.bloom_add_plain(want, keys, params)
    probe = _probe_mix(rng, keys.cpu(), 1 << 20).to(cuda)
    answer = kernels.bloom_contains_bytes(got, probe, params)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(answer, bloom.bloom_contains_plain(want, probe,
                                                          params))
    with pytest.raises(ValueError, match="does not fit"):
        kernels.bloom_contains_bytes(got, probe, params, image=True)


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_bloom_pack_bytes_kernel_matches_plain(layout, cuda):
    """K8's pack pass on a roster filter and on random 0/1 bytes."""
    params = bloom.derive_bloom_params(100_000, 0.01, layout)
    rng = np.random.default_rng(4)
    filled = _roster_bits(params, cuda, n=90_000)
    noise = torch.from_numpy((rng.random(params.m_bits) < 0.5).astype(
        np.uint8)).to(cuda)
    for bits in (filled, noise):
        got = kernels.bloom_pack_bytes(bits)
        torch.cuda.synchronize()
        assert torch.equal(got, bloom.pack_bloom_bits(bits))


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_bloom_bytes_image_paths_replayed_in_a_graph(layout, cuda):
    """K7's two passes and K8's pack + dependent probe (each with its
    scratch) captured in one CUDA graph, replayed from two different
    filters: each replay adds onto and answers from the filter it starts
    from."""
    params = bloom.derive_bloom_params(100_000, 0.01, layout)
    rng = np.random.default_rng(5)
    add = _keys(rng, 90_000).to(cuda)
    probe = _probe_mix(rng, add.cpu(), 1 << 17).to(cuda)
    starts = [_roster_bits(params, cuda), bloom.bloom_init(params, cuda)]
    work = starts[0].clone()

    def step():
        kernels.bloom_add_bytes(work, add[:45_000], params, image=True)
        return kernels.bloom_contains_bytes(work, probe, params, image=True)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for start in (starts[1], starts[0], starts[1]):
        work.copy_(start)
        graph.replay()
        want = start.clone()
        bloom.bloom_add_plain(want, add[:45_000], params)
        torch.cuda.synchronize()
        assert torch.equal(work, want)
        assert torch.equal(out, bloom.bloom_contains_plain(want, probe,
                                                           params))


@pytest.mark.parametrize("precision", [4, 14, 18])
@pytest.mark.parametrize("rows", [[0], [3, 1, 3, 0, 7, 2],
                                  list(range(16)), "1024"])
def test_hll_rows_and_union_kernels_match_plain(rows, precision, cuda):
    """Unsorted, repeated and out-of-range rows (clamped), one row, and
    1024 rows of a 1024-bank array; K1-union over the same lists."""
    num_banks = 1024 if rows == "1024" else 16
    regs = _filled(num_banks, precision, "dense", cuda, seed=len(rows))
    if rows == "1024":
        rows = np.random.default_rng(0).integers(0, 1024, 1024).tolist()
    idx = torch.tensor(rows, dtype=torch.int32, device=cuda)
    before = dict(kernels.launches)
    got = kernels.hll_histogram_rows(regs, idx, precision)
    union = kernels.hll_union_histogram(regs, idx, precision)
    torch.cuda.synchronize()
    assert kernels.launches["hll_histogram_rows"] == \
        before["hll_histogram_rows"] + 1
    assert kernels.launches["hll_union_histogram"] == \
        before["hll_union_histogram"] + 1
    assert torch.equal(got, hll.hll_histogram_rows_plain(regs, idx,
                                                         precision))
    assert torch.equal(union, hll.hll_union_histogram_plain(regs, idx,
                                                            precision))
    assert int(union.sum()) == 1 << precision


def test_hll_union_kernel_replayed_in_a_graph(cuda):
    """The union's output is zeroed inside its own launch, so a replay
    gives the same histogram, not a sum of replays."""
    regs = _filled(7, 14, "dense", cuda)
    idx = torch.arange(7, dtype=torch.int32, device=cuda)
    want = hll.hll_union_histogram_plain(regs, idx, 14)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.hll_union_histogram(regs, idx, 14)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.hll_union_histogram(regs, idx, 14)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("fill", ["sparse", "dense", "saturated"])
@pytest.mark.parametrize("num_rows", [2, 7, 32, 64, 1024])
def test_hll_union_matches_plain_at_store_row_counts(num_rows, fill, cuda):
    """K1-union at the store's row counts, with repeated rows and rows
    outside [0, num_banks) (clamped), at p = 14, 4 and 18; each call is
    one launch."""
    rng = np.random.default_rng(num_rows)
    for precision in (14, 4, 18):
        num_banks = 64 if precision == 18 else 1024
        regs = _filled(num_banks, precision, fill, cuda, seed=num_rows)
        rows = rng.integers(-3, num_banks + 3, num_rows)
        rows[: num_rows // 2] = rows[num_rows // 2: 2 * (num_rows // 2)]
        idx = torch.from_numpy(rows.astype(np.int32)).to(cuda)
        before = kernels.launches["hll_union_histogram"]
        got = kernels.hll_union_histogram(regs, idx, precision)
        torch.cuda.synchronize()
        assert kernels.launches["hll_union_histogram"] == before + 1
        assert torch.equal(got, hll.hll_union_histogram_plain(
            regs, idx, precision))


def test_hll_union_replayed_in_a_graph_beside_another_stream(cuda):
    """A replayed union over repeated and out-of-range rows gives the
    histogram again (the memset is in the graph), while an eager union
    runs on another stream."""
    regs = _filled(64, 14, "dense", cuda, seed=5)
    idx = torch.tensor([0, 63, 70, -1, 5, 5, 9], dtype=torch.int32,
                       device=cuda)
    want = hll.hll_union_histogram_plain(regs, idx, 14)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.hll_union_histogram(regs, idx, 14)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kernels.hll_union_histogram(regs, idx, 14) for _ in range(4)]
    other = torch.cuda.Stream()
    for _ in range(3):
        graph.replay()
        with torch.cuda.stream(other):
            eager = kernels.hll_union_histogram(regs, idx, 14)
    torch.cuda.synchronize()
    for out in outs + [eager]:
        assert torch.equal(out, want)


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_sketch_store_on_card_equals_cpu(layout, cuda):
    from attendance_tpu_torch.sketch import TpuSketchStore
    stores = [TpuSketchStore(Config(bloom_layout=layout,
                                    hll_initial_banks=2), device=d)
              for d in (cuda, "cpu")]
    rng = np.random.default_rng(3)
    answers = [[], []]
    for s, out in zip(stores, answers):
        rng = np.random.default_rng(3)
        s.execute_command("BF.RESERVE", "bf", 0.01, 500)
        for step in range(5):
            batch = rng.integers(10_000, 12_000, 400)
            out.append(s.bf_add_many("bf", batch).tolist())
            out.append(s.bf_exists_many("bf", batch + 7).tolist())
            key = f"h{step}"
            out.append(s.pfadd(key, *batch[:10].tolist()))
            out.append(s.pfadd_many(key, batch, mask=batch % 2 == 0))
            out.append(s.pfcount_many(["h0", key, "none", "h0"]))
            out.append(s.pfcount("h0", key))
        out.append(s.execute_command("BF.INFO", "bf"))
        out.append(s.estimated_fpr("bf"))
    assert answers[0][:-1] == answers[1][:-1]
    assert answers[0][-1] == pytest.approx(answers[1][-1], rel=1e-12)
    card, cpu = stores
    assert card.hll._bank_of == cpu.hll._bank_of
    assert torch.equal(card.hll.regs.cpu(), cpu.hll.regs)
    for a, b in zip(card._blooms["bf"].filters, cpu._blooms["bf"].filters):
        assert torch.equal(a.cpu(), b)


def test_processor_pipeline_on_card_equals_cpu(cuda):
    from datetime import datetime

    from attendance_tpu_torch.cli import run_pipeline
    from attendance_tpu_torch.transport.memory_broker import MemoryBroker
    runs = []
    for device in (cuda, "cpu"):
        MemoryBroker.reset_shared()
        proc, report = run_pipeline(
            Config(batch_size=512, batch_timeout_s=0.01), 400, 20, seed=1,
            device=device, now=datetime(2026, 3, 4, 12))
        stats = {lid: proc.get_attendance_stats(lid)["unique_attendees"]
                 for lid in proc.store.distinct_lecture_ids()}
        m = proc.metrics
        runs.append(((m.events, m.valid_events, m.invalid_events,
                      m.batch_sizes), stats,
                     [(r.student_id, r.timestamp, r.is_valid)
                      for r in proc.store.scan_all()],
                     proc.estimated_fpr()))
        assert m.events == report.message_count
        proc.cleanup()
    MemoryBroker.reset_shared()
    assert runs[0][:3] == runs[1][:3]
    assert runs[0][3] == pytest.approx(runs[1][3], rel=1e-12)


# -- K9-K11 and K1 on a slice: the mesh engine's kernels -------------------

def _alloc_slices(params, sp, words=None):
    """The mesh engine's cut of a filter into sp slices of whole blocks
    (the allocation padded to sp x 512 bits, the padding zero)."""
    chunk = sp * 512
    m_words = -(-params.m_bits // chunk) * chunk // 32
    padded = torch.zeros(m_words, dtype=torch.int32, device=(
        words.device if words is not None else "cpu"))
    if words is not None:
        padded[:words.shape[0]] = words
    wl = m_words // sp
    return [padded[s * wl:(s + 1) * wl].clone() for s in range(sp)], wl


@pytest.mark.parametrize("key_bits", [0, 21])
@pytest.mark.parametrize("sp", [1, 2, 3, 4, 8])
def test_bloom_contains_slice_kernel_matches_plain(sp, key_bits, cuda):
    """K9 on every slice of a 100k-roster filter, on plain keys and on
    the word wire (pad lanes included), by the wrapper's pick and by each
    path (direct, compact): equal to its plain version, and the AND
    across slices equal to the whole filter's probe."""
    params = bloom.derive_bloom_params(100_000, 0.01, "blocked")
    rng = np.random.default_rng(sp + key_bits)
    roster = rng.choice(1 << 21, 100_000, replace=False).astype(np.uint32)
    words = bloom.bloom_packed_init(params, cuda)
    kernels.bloom_add(words, torch.from_numpy(roster.view(np.int32)).to(
        cuda), params)
    keys = np.where(rng.random(LANES) < 0.5, rng.choice(roster, LANES),
                    rng.integers(0, 1 << 21, LANES)).astype(np.uint32)
    lanes = keys
    if key_bits:
        lanes = fused.pack_words(keys[:-100], rng.integers(
            0, 16, LANES - 100), key_bits, LANES)
    lanes_t = torch.from_numpy(lanes.view(np.int32)).to(cuda)
    slices, wl = _alloc_slices(params, sp, words)
    before = kernels.launches["bloom_contains_slice"]
    every = None
    for s, words_s in enumerate(slices):
        want = kernels.bloom_contains_slice_plain(words_s, lanes_t, params,
                                                  s * wl, key_bits)
        for compact in (False, True, None):
            got = kernels.bloom_contains_slice(words_s, lanes_t, params,
                                               first_word=s * wl,
                                               key_bits=key_bits,
                                               compact=compact)
            torch.cuda.synchronize()
            assert got.dtype == torch.uint8 and torch.equal(got, want)
        every = got if every is None else every & got
    assert kernels.launches["bloom_contains_slice"] == before + 3 * sp
    whole = bloom.bloom_contains_words(
        words, torch.from_numpy(
            (lanes & ((1 << key_bits) - 1) if key_bits else lanes)
            .view(np.int32)).to(cuda), params)
    assert torch.equal(every.to(torch.bool), whole)


@pytest.mark.parametrize("wire", ["arrays", "words"])
@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_hll_add_slice_kernel_matches_plain(sp, wire, cuda):
    """K10 on every register slice of 16 filled banks: lanes with bank
    -1, a bank past the array, invalid lanes and padding (the last 1,000
    lanes), the counters bumped with a carry by the slice s = 0; equal to
    its plain version, and the slices together equal to K5 on the whole
    banks."""
    rng = np.random.default_rng(sp)
    regs = _regs(16, cuda)
    keys = rng.integers(0, 1 << 20, LANES).astype(np.uint32)
    bank = rng.integers(-1, 18, LANES).astype(np.int32)
    valid = torch.from_numpy(rng.random(LANES) < 0.8).to(cuda)
    n_real = LANES - 1000
    if wire == "words":
        lanes = fused.pack_words(keys[:n_real], np.maximum(bank[:n_real], 0),
                                 20, LANES)
        key_bits, bank_t = 20, None
        bank = np.where(np.arange(LANES) < n_real, np.maximum(bank, 0), -1)
    else:
        lanes, key_bits = keys, 0
        bank_t = torch.from_numpy(bank).to(cuda)
    lanes_t = torch.from_numpy(lanes.view(np.int32)).to(cuda)
    start = torch.tensor([[0xFFFFFFF0 - (1 << 32), 3], [7, 0]],
                         dtype=torch.int32, device=cuda)
    rl = (1 << 14) // sp
    before = kernels.launches["hll_add_slice"]
    out = []
    for s in range(sp):
        a = regs[:, s * rl:(s + 1) * rl].contiguous()
        b = a.clone()
        ca, cb = (start.clone(), start.clone()) if s == 0 else (None, None)
        kernels.hll_add_slice(a, lanes_t, valid, lo=s * rl, bank=bank_t,
                              key_bits=key_bits, n_real=n_real, counts=ca)
        kernels.hll_add_slice_plain(b, lanes_t, valid, s * rl, 14, bank_t,
                                    key_bits, n_real, cb)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        if s == 0:
            assert torch.equal(ca, cb)
            real = np.arange(LANES) < n_real
            v = valid.cpu().numpy()
            nv, ni = fused.decode_counts(ca)
            assert (nv, ni) == (0xFFFFFFF0 + 3 * (1 << 32)
                                + int((v & real).sum()),
                                7 + int((~v & real).sum()))
        out.append(a)
    assert kernels.launches["hll_add_slice"] == before + sp
    whole = regs.clone()
    kept = torch.from_numpy(np.arange(LANES) < n_real).to(cuda) & valid
    kernels.hll_add(whole, torch.from_numpy(bank).to(cuda),
                    torch.from_numpy(keys.view(np.int32)).to(cuda), kept, 14)
    assert torch.equal(torch.cat(out, dim=1), whole)


@pytest.mark.parametrize("capacity", [100_000, 10_000_000])
@pytest.mark.parametrize("sp", [1, 3, 4, 8])
def test_bloom_add_slice_kernel_matches_plain(sp, capacity, cuda):
    """K11 of one preload chunk (2^14 keys, a masked quarter) into every
    slice of a filter already holding half the roster: equal to its
    plain version; the slices of the whole roster together equal K3's
    filter."""
    params = bloom.derive_bloom_params(capacity, 0.01, "blocked")
    rng = np.random.default_rng(capacity + sp)
    roster = rng.choice(4 * capacity, capacity, replace=False).astype(
        np.uint32)
    roster_t = torch.from_numpy(roster.view(np.int32)).to(cuda)
    half = bloom.bloom_packed_init(params, cuda)
    kernels.bloom_add(half, roster_t[:capacity // 2], params)
    slices, wl = _alloc_slices(params, sp, half)
    chunk = roster_t[capacity // 2:capacity // 2 + (1 << 14)]
    mask = torch.from_numpy(rng.random(1 << 14) < 0.75).to(cuda)
    before = kernels.launches["bloom_add_slice"]
    for s, words_s in enumerate(slices):
        a, b = words_s.clone(), words_s.clone()
        kernels.bloom_add_slice(a, chunk, params, first_word=s * wl,
                                mask=mask)
        kernels.bloom_add_slice_plain(b, chunk, params, s * wl, mask)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
    assert kernels.launches["bloom_add_slice"] == before + sp
    full = bloom.bloom_packed_init(params, cuda)
    kernels.bloom_add(full, roster_t, params)
    empty, _ = _alloc_slices(params, sp)
    for s, words_s in enumerate(empty):
        words_s = words_s.to(cuda)
        for i in range(0, capacity, 1 << 20):
            kernels.bloom_add_slice(words_s, roster_t[i:i + (1 << 20)],
                                    params, first_word=s * wl)
        empty[s] = words_s
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(empty)[:full.shape[0]], full)
    assert not torch.cat(empty)[full.shape[0]:].any()  # the padding


@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("share", [(1 << 18) + 1, 3_000_001])
@pytest.mark.parametrize("sp", [1, 3, 4, 8])
def test_bloom_add_slice_each_path_matches_plain(sp, share, binned, cuda):
    """K11 on either path (binned over the slice's tiles, or one thread
    per key) of a replica's whole share (2^18 + 1 keys and several
    million) into every slice of a 10M filter that already holds other
    keys, a quarter of the share masked off: equal to its plain version;
    unmasked, the slices together equal K3 of the share onto the same
    filter."""
    params = bloom.derive_bloom_params(10_000_000, 0.01, "blocked")
    rng = np.random.default_rng(share + sp)
    keys = torch.from_numpy(rng.integers(0, 1 << 32, share, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(cuda)
    held = bloom.bloom_packed_init(params, cuda)
    kernels.bloom_add(held, _keys(rng, 1_000_000).to(cuda), params)
    slices, wl = _alloc_slices(params, sp, held)
    mask = torch.from_numpy(rng.random(share) < 0.75).to(cuda)
    before = kernels.launches["bloom_add_slice"]
    whole = []
    for s, words_s in enumerate(slices):
        a, b = words_s.clone(), words_s.clone()
        kernels.bloom_add_slice(a, keys, params, first_word=s * wl,
                                mask=mask, binned=binned)
        kernels.bloom_add_slice_plain(b, keys, params, s * wl, mask)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        kernels.bloom_add_slice(words_s, keys, params, first_word=s * wl,
                                binned=binned)
        whole.append(words_s)
    assert kernels.launches["bloom_add_slice"] == before + 2 * sp
    kernels.bloom_add(held, keys, params)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(whole)[:held.shape[0]], held)
    assert not torch.cat(whole)[held.shape[0]:].any()  # the padding


def _k10_case(lanes, wire, seed, cuda):
    """(lanes, bank or None, key_bits, valid, n_real) of a K10 input on
    ``wire``: banks -1 to 17 of 16, 80% valid, the last tenth of the
    lanes padding (at least one lane real)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, lanes).astype(np.uint32)
    bank = rng.integers(-1, 18, lanes).astype(np.int32)
    valid = torch.from_numpy(rng.random(lanes) < 0.8).to(cuda)
    n_real = max(1, lanes - lanes // 10)
    if wire == "words":
        words = fused.pack_words(keys[:n_real], np.maximum(bank[:n_real], 0),
                                 20, lanes)
        return (torch.from_numpy(words.view(np.int32)).to(cuda), None, 20,
                valid, n_real)
    return (torch.from_numpy(keys.view(np.int32)).to(cuda),
            torch.from_numpy(bank).to(cuda), 0, valid, n_real)


@pytest.mark.parametrize("counted", [True, False])
@pytest.mark.parametrize("wire", ["arrays", "words"])
@pytest.mark.parametrize("lanes", [1, 255, 65_536, 1_048_576])
def test_hll_add_slice_lane_counts_match_plain(lanes, wire, counted, cuda):
    """K10 at 1 to 1,048,576 lanes on both wires, on slice 0 of 4 with
    the counters (started just under the 2^32 wrap of their low lane, so
    the add carries) and on slice 1 without: registers and counters equal
    to the plain version's."""
    lanes_t, bank_t, key_bits, valid, n_real = _k10_case(lanes, wire,
                                                         lanes, cuda)
    regs = _regs(16, cuda)
    s = 0 if counted else 1
    rl = (1 << 14) // 4
    a = regs[:, s * rl:(s + 1) * rl].contiguous()
    b = a.clone()
    start = torch.tensor([[0xFFFFFF00 - (1 << 32), 1], [5, 0]],
                         dtype=torch.int32, device=cuda)
    ca, cb = (start.clone(), start.clone()) if counted else (None, None)
    before = kernels.launches["hll_add_slice"]
    kernels.hll_add_slice(a, lanes_t, valid, lo=s * rl, bank=bank_t,
                          key_bits=key_bits, n_real=n_real, counts=ca)
    kernels.hll_add_slice_plain(b, lanes_t, valid, s * rl, 14, bank_t,
                                key_bits, n_real, cb)
    torch.cuda.synchronize()
    assert kernels.launches["hll_add_slice"] == before + 1
    assert torch.equal(a, b)
    if counted:
        assert torch.equal(ca, cb)


@pytest.mark.parametrize("sp", [2, 4, 8, 1024])
def test_histogram_kernel_on_register_slices(sp, cuda):
    """K1 on each sp slice [256, 2^14 / sp] of filled registers: equal to
    its plain version, and the slices' histograms sum to the banks'."""
    regs = _filled(256, 14, "dense", cuda, seed=sp)
    rl = (1 << 14) // sp
    total = torch.zeros((256, 52), dtype=torch.int32, device=cuda)
    for s in range(sp):
        part = regs[:, s * rl:(s + 1) * rl].contiguous()
        got = kernels.hll_histogram(part, 14)
        torch.cuda.synchronize()
        assert torch.equal(got, hll.hll_histogram(part, 14))
        total += got
    assert torch.equal(total, kernels.hll_histogram(regs, 14))


@pytest.mark.parametrize("dp,sp", [(2, 4), (3, 2), (1, 8), (1, 1)])
def test_mesh_engine_on_card_equals_cpu(dp, sp, cuda):
    """The engine on a mesh of repeated card cells equals the same mesh
    of CPU cells (the plain versions) in every answer and state, its
    preload launches K11 once a cell (the 1 x 1 mesh: K3 once), and its
    steps launch only the mesh kernels (the 1 x 1 mesh: K3, K2, K4,
    K1)."""
    from attendance_tpu_torch.parallel import (ShardedSketchEngine,
                                               make_mesh)

    rng = np.random.default_rng(dp * 10 + sp)
    roster = rng.choice(1 << 20, 30_000, replace=False).astype(np.uint32)
    keys = np.where(rng.random(5000) < 0.7, rng.choice(roster, 5000),
                    rng.integers(1 << 20, 1 << 21, 5000)).astype(np.uint32)
    banks = rng.integers(0, 8, 5000).astype(np.int32)
    results = []
    for dev in (cuda, torch.device("cpu")):
        kernels.reset_launches()
        eng = ShardedSketchEngine(make_mesh(sp, dp, [dev] * (dp * sp)),
                                  capacity=40_000, error_rate=0.01,
                                  num_banks=8, replica_sync="step")
        eng.preload(roster)
        if dev == cuda:
            # One K11 launch a cell over its share; one K3 on 1 x 1.
            preload = {k: v for k, v in kernels.launches.items() if v}
            assert preload == ({"bloom_add": 1} if dp * sp == 1
                               else {"bloom_add_slice": dp * sp})
        v1 = eng.step(keys, banks).cpu().numpy()
        words = fused.pack_words(keys, banks, 21, eng.padded_size(5000))
        v2 = eng.step_words(words, 5000, 21).cpu().numpy()
        probe = np.arange((1 << 20) - 5000, (1 << 20) + 5000,
                          dtype=np.uint32)
        results.append((v1, v2, eng.contains(probe), *eng.get_state(),
                        eng.validity_counts(), eng.count_all().tolist(),
                        eng.count(3), eng.fill_fraction(),
                        dict(kernels.launches)))
    card, cpu = results
    for a, b in zip(card[:5], cpu[:5]):
        np.testing.assert_array_equal(a, b)
    assert card[5:9] == cpu[5:9]
    used = {k for k, v in card[9].items() if v}
    if dp * sp == 1:
        assert used == {"bloom_add", "fused_step", "bloom_contains",
                        "hll_histogram"}
    else:
        assert used == {"bloom_add_slice", "bloom_contains_slice",
                        "hll_add_slice", "hll_histogram"}
    assert not any(cpu[9].values())


@pytest.mark.parametrize("mode", ["seg", "delta"])
@pytest.mark.parametrize("dp,sp", [(2, 4), (3, 2), (1, 8), (1, 1)])
def test_mesh_narrow_step_on_card_equals_cpu(dp, sp, mode, cuda):
    """``step_narrow`` on a mesh of repeated card cells equals the same
    mesh of CPU cells: validity in packed per-slice order, state,
    counters and PFCOUNTs, over two frames (one with padding lanes in
    the last replica's slice). A mesh launches K12 once a replica (its
    cells share one card), K9 and K10 once a cell; the 1 x 1 mesh
    K2-seg or K2-delta."""
    from attendance_tpu_torch.parallel import (ShardedSketchEngine,
                                               make_mesh)

    rng = np.random.default_rng(dp * 10 + sp + len(mode))
    roster = rng.choice(1 << 20, 30_000, replace=False).astype(np.uint32)
    frames = []
    for n in (5_000, 8_192):
        keys = np.where(rng.random(n) < 0.7, rng.choice(roster, n),
                        rng.integers(1 << 20, 1 << 21, n)).astype(np.uint32)
        frames.append((keys, rng.integers(0, 8, n).astype(np.int32)))
    results = []
    for dev in (cuda, torch.device("cpu")):
        eng = ShardedSketchEngine(make_mesh(sp, dp, [dev] * (dp * sp)),
                                  capacity=40_000, error_rate=0.01,
                                  num_banks=8)
        eng.preload(roster)
        kernels.reset_launches()
        valid = []
        for keys, banks in frames:
            local = eng.padded_size(len(keys)) // dp
            bufs, width = [], 21
            for r in range(dp):
                ks = keys[r * local:(r + 1) * local]
                bs = banks[r * local:(r + 1) * local]
                if mode == "seg":
                    bufs.append(fused.pack_seg(ks, bs, width, local, 8)[0])
                else:
                    width = 32  # every slice's gaps fit, one shared width
                    bufs.append(fused.pack_delta(ks, bs, width, local,
                                                 8)[0])
            valid.append(eng.step_narrow(np.stack(bufs), mode, width,
                                         local).cpu().numpy())
        results.append((np.concatenate(valid), *eng.get_state(),
                        eng.validity_counts(), eng.count_all().tolist(),
                        {k: v for k, v in kernels.launches.items() if v}))
    card, cpu = results
    for a, b in zip(card[:3], cpu[:3]):
        np.testing.assert_array_equal(a, b)
    assert card[3:5] == cpu[3:5]
    assert sum(card[3]) == 5_000 + 8_192
    steps = {"hll_histogram": sp}  # count_all: K1 on each slice
    if dp * sp == 1:
        steps[f"fused_step_{mode}"] = 2
    else:
        steps.update({f"decode_{mode}": 2 * dp,
                      "bloom_contains_slice": 2 * dp * sp,
                      "hll_add_slice": 2 * dp * sp})
    assert card[5] == steps and cpu[5] == {}
