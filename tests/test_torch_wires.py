"""The seg and delta wires of the port against the JAX package, on the
CPU: the numpy packers, the native host pack, the K2-seg and K2-delta
steps (their plain versions on ``device="cpu"``) and the whole slice
with the native pack on in both packages.

The same numpy inputs, made from a seed, go to both packages. Packers,
sketches and the pipelines' bank numbering are deterministic: every
compared value must be equal (tolerance 0).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attendance_tpu import native as jnative
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.models import bloom as jbloom
from attendance_tpu.models import fused as jfused
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.transport.memory_broker import (
    MemoryBroker as JaxBroker, MemoryClient as JaxClient)
from attendance_tpu_torch import native as tnative
from attendance_tpu_torch.cli import main as cli_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models import bloom as tbloom
from attendance_tpu_torch.models import fused as tfused
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline.events import encode_planar_batch
from attendance_tpu_torch.pipeline.fast_path import (
    FusedPipeline, _ScatterValidity)
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

CPU = torch.device("cpu")


def _lanes(seed, n, num_banks, key_hi, empty=()):
    """(uint32 keys below key_hi, int32 banks) with no lane in the banks
    of ``empty``."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_hi, n, dtype=np.uint64).astype(np.uint32)
    allowed = [b for b in range(num_banks) if b not in empty]
    return keys, rng.choice(allowed, n).astype(np.int32)


# -- numpy packers --------------------------------------------------------------

# (kb, n, num_banks, padded, empty banks)
SEG_CASES = {
    "kb1": (1, 3000, 12, 4096, (0, 5, 11)),
    "kb17": (17, 3000, 12, 4096, (3, 4)),
    "kb22_ragged": (22, 1000, 7, 1024, (6,)),
    "kb32_one_bank": (32, 2500, 1, 4096, ()),
    "n0": (5, 0, 4, 256, ()),
}


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_pack_seg_matches_jax(case):
    kb, n, nb, padded, empty = SEG_CASES[case]
    keys, banks = _lanes(kb, n, nb, 1 << kb, empty)
    buf, perm = tfused.pack_seg(keys, banks, kb, padded, nb)
    jbuf, jperm = jfused.pack_seg(keys, banks, kb, padded, nb)
    assert buf.dtype == np.uint32 and perm.dtype == np.uint32
    assert buf.tobytes() == jbuf.tobytes()
    assert perm.tobytes() == jperm.tobytes()
    assert len(buf) == tfused.seg_buf_words(nb, kb, padded) == \
        jfused.seg_buf_words(nb, kb, padded)
    assert tfused.SEG_GUARD_WORDS == jfused.SEG_GUARD_WORDS


def test_pack_seg_rejects_an_overwide_key():
    keys = np.array([5, 1 << 20, 9], np.uint32)  # a 21-bit key
    banks = np.zeros(3, np.int32)
    for pack in (tfused.pack_seg, jfused.pack_seg):
        with pytest.raises(ValueError, match="width"):
            pack(keys, banks, kb=10, padded=256, num_banks=4)


def _delta_keys(case):
    """(keys, banks, num_banks, padded) of one delta-wire case."""
    rng = np.random.default_rng(len(case))
    if case == "narrow":
        keys, banks = _lanes(1, 3000, 12, 1 << 20, (2, 9))
        return keys, banks, 12, 4096
    if case == "db32":
        # One bank spanning 0 .. 2^32 - 1: the widest gap needs 32 bits.
        keys = np.array([0, 7, 0xFFFFFFFF, 3], np.uint32)
        return keys, np.zeros(4, np.int32), 1, 256
    if case == "wrap":
        # 256 banks each spanning most of the uint32 range: the frame-wide
        # cumsum of the deltas wraps many times, every segment's own sum
        # fits 32 bits.
        keys = rng.integers(0, 1 << 32, 16_000, dtype=np.uint64).astype(
            np.uint32)
        return keys, rng.integers(0, 256, 16_000).astype(np.int32), 256, 16384
    if case == "ties":
        keys = rng.integers(0, 50, 900).astype(np.uint32)  # many equal keys
        return keys, rng.integers(0, 3, 900).astype(np.int32), 3, 1024
    assert case == "n0"
    return np.zeros(0, np.uint32), np.zeros(0, np.int32), 4, 256


DELTA_CASES = ["narrow", "db32", "wrap", "ties", "n0"]


@pytest.mark.parametrize("case", DELTA_CASES)
def test_delta_scan_and_pack_match_jax(case):
    keys, banks, nb, padded = _delta_keys(case)
    scan = tfused.delta_scan(keys, banks, nb)
    jscan = jfused.delta_scan(keys, banks, nb)
    for ours, theirs in zip(scan[:4], jscan[:4]):
        assert ours.tobytes() == np.asarray(theirs).tobytes()
    assert scan[4] == jscan[4]
    db = tfused.pick_delta_width(1, scan[4])
    assert db == jfused.pick_delta_width(1, scan[4])
    buf, perm = tfused.pack_delta(keys, banks, db, padded, nb)
    jbuf, jperm = jfused.pack_delta(keys, banks, db, padded, nb)
    assert buf.tobytes() == jbuf.tobytes()
    assert perm.tobytes() == jperm.tobytes()
    assert len(buf) == tfused.delta_buf_words(nb, db, padded)
    if case == "db32":
        assert db == 32
    if case == "wrap":
        assert int(scan[3].astype(np.int64).sum()) >= 1 << 32
    if db > 2:  # a width below the frame's widest gap is refused
        assert tfused.pack_delta(keys, banks, scan[4] - 1, padded, nb,
                                 scan=scan) == (None, None)
        assert jfused.pack_delta(keys, banks, scan[4] - 1, padded, nb,
                                 scan=jscan) == (None, None)


def test_pick_delta_width_matches_jax():
    for hint in range(0, 34):
        for needed in range(1, 34):
            assert tfused.pick_delta_width(hint, needed) == \
                jfused.pick_delta_width(hint, needed)


# -- native host pack -------------------------------------------------------------

@pytest.fixture
def native_pair(monkeypatch):
    """(JAX HostPipe, port HostPipe), both built with the C compiler."""
    monkeypatch.delenv("ATP_NATIVE", raising=False)
    theirs, ours = jnative.load(), tnative.load()
    assert theirs is not None and ours is not None
    return theirs, ours


def _native_frame(stride, n=3000, num_banks=12, seed=3, key_hi=1 << 20):
    """(keys, days, lut, day_base): days 20260700 + 0..11 mapped by a
    shuffled LUT; ``stride`` 4 is planar columns, 20 interleaved records."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_hi, n, dtype=np.uint64).astype(np.uint32)
    days = (20_260_700 + rng.integers(0, num_banks, n)).astype(np.uint32)
    if stride == 20:
        rec = np.zeros((n, 5), np.uint32)
        rec[:, 0], rec[:, 1] = keys, days
        keys, days = rec[:, 0], rec[:, 1]
        assert keys.strides == days.strides == (20,)
    lut = np.full(1 << 14, -1, np.int32)
    lut[:num_banks] = rng.permutation(num_banks)
    return keys, days, lut, 20_260_700


def _same(ours, theirs):
    """Equal results: arrays byte-equal, everything else ==."""
    if isinstance(ours, tuple):
        assert isinstance(theirs, tuple) and len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _same(a, b)
    elif isinstance(ours, np.ndarray):
        assert isinstance(theirs, np.ndarray) and ours.dtype == theirs.dtype
        assert ours.tobytes() == theirs.tobytes()
    else:
        assert ours == theirs


@pytest.mark.parametrize("stride", [4, 20])
@pytest.mark.parametrize("case", ["ok", "miss", "overflow"])
def test_native_pack_matches_jax_native(native_pair, case, stride):
    """Every entry point on the same frame: buffers, permutations and
    return codes byte-equal, including a LUT-miss index and an overflow
    of the width tried (-3)."""
    theirs, ours = native_pair
    keys, days, lut, base = _native_frame(stride)
    kw = 20
    if case == "miss":
        lut[5] = -1  # the first event on day 20260705 misses
    if case == "overflow":
        kw = 12  # 20-bit keys overflow a 12-bit width
    assert ours.max_key(keys) == theirs.max_key(keys) == int(keys.max())
    _same(ours.pack_words(keys, days, lut, base, kw, 4096),
          theirs.pack_words(keys, days, lut, base, kw, 4096))
    for w in (1, 2, 4):
        _same(ours.pack_bytes(keys, days, lut, base, w, 4096),
              theirs.pack_bytes(keys, days, lut, base, w, 4096))
    got = ours.pack_seg(keys, days, lut, base, kw, 4096, 12)
    _same(got, theirs.pack_seg(keys, days, lut, base, kw, 4096, 12))
    scan = ours.delta_scan(keys, days, lut, base, 12)
    _same(scan, theirs.delta_scan(keys, days, lut, base, 12))
    _same(ours.pack_delta(keys, days, lut, base, 3, 4096, 12),
          theirs.pack_delta(keys, days, lut, base, 3, 4096, 12))
    if case == "miss":
        miss = int(np.flatnonzero(days == 20_260_705)[0])
        assert got[2] == scan[1] == miss
    elif case == "overflow":
        assert got[2] == -3
    else:
        # The native buffers are the numpy packers' on the banks the LUT
        # gives.
        banks = lut[days - base]
        buf, perm = tfused.pack_seg(keys, banks, kw, 4096, 12)
        assert got[0].tobytes() == buf.tobytes()
        assert got[1].tobytes() == perm.tobytes()
        for ours_a, numpy_a in zip(scan[0], tfused.delta_scan(keys, banks,
                                                              12)):
            _same(ours_a, numpy_a)


def test_native_bitpack_and_refusals_match_jax(native_pair):
    theirs, ours = native_pair
    keys, days, lut, base = _native_frame(4, key_hi=1 << 32)
    scan, _ = ours.delta_scan(keys, days, lut, base, 12)
    for db in (scan[4], 32, scan[4] - 1):
        _same(ours.bitpack_delta(scan, db, 4096, 12),
              theirs.bitpack_delta(scan, db, 4096, 12))
    assert ours.bitpack_delta(scan, scan[4] - 1, 4096, 12) is None
    # More banks than the u16 scratch holds: the native pass cannot run.
    _same(ours.pack_seg(keys, days, lut, base, 32, 4096, 70_000),
          theirs.pack_seg(keys, days, lut, base, 32, 4096, 70_000))
    assert ours.pack_seg(keys, days, lut, base, 32, 4096, 70_000)[2] == -2
    _same(ours.delta_scan(keys, days, lut, base, 70_000),
          theirs.delta_scan(keys, days, lut, base, 70_000))
    empty = np.zeros(0, np.uint32)
    _same(ours.pack_seg(empty, empty, lut, base, 5, 256, 4),
          theirs.pack_seg(empty, empty, lut, base, 5, 256, 4))
    _same(ours.pack_delta(empty, empty, lut, base, 1, 256, 4),
          theirs.pack_delta(empty, empty, lut, base, 1, 256, 4))


def test_native_pack_checks_sizes_before_the_c_pass(native_pair):
    """Sizes the C passes trust are checked in Python first: more events
    than lanes, columns of unequal length or width, a LUT that is not
    contiguous int32."""
    _, ours = native_pair
    keys, days, lut, base = _native_frame(4, n=300)
    for call in (lambda: ours.pack_words(keys, days, lut, base, 20, 256),
                 lambda: ours.pack_bytes(keys, days, lut, base, 1, 256),
                 lambda: ours.pack_seg(keys, days, lut, base, 20, 256, 12),
                 lambda: ours.pack_delta(keys, days, lut, base, 1, 256, 12),
                 lambda: ours.pack_words(keys, days[:-1], lut, base, 20, 512),
                 lambda: ours.pack_words(keys.astype(np.uint64), days, lut,
                                         base, 20, 512),
                 lambda: ours.delta_scan(keys, days, lut.astype(np.int64),
                                         base, 12),
                 lambda: ours.pack_seg(keys, days, lut[::2], base, 20, 512,
                                       12)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("cc,match", [("/nonexistent/bin/cc", "no C compiler"),
                                      ("false", "build failed")])
def test_native_build_failure_raises(monkeypatch, cc, match):
    """Without ATP_NATIVE=0 a compiler that is missing or fails raises,
    from load() and from a pipeline's constructor: no silent numpy
    pack. ATP_NATIVE=0 selects the numpy pack."""
    monkeypatch.delenv("ATP_NATIVE", raising=False)
    monkeypatch.setattr(tnative, "_cached", None)
    monkeypatch.setenv("CC", cc)
    with pytest.raises(RuntimeError, match=match):
        tnative.load()
    with pytest.raises(RuntimeError, match=match):
        FusedPipeline(Config(), device="cpu")
    monkeypatch.setenv("ATP_NATIVE", "0")
    assert tnative.load() is None
    assert FusedPipeline(Config(), device="cpu")._native is None


# -- the K2-seg and K2-delta steps ---------------------------------------------

def _start_state(num_banks, seed, roster_hi=1 << 20):
    """(params, roster, bits, regs, counts): a preloaded filter of 5000
    ids below ``roster_hi``, registers holding earlier frames, counters
    one step from carrying."""
    params = tbloom.derive_bloom_params(5000, 0.01, "blocked")
    rng = np.random.default_rng(seed)
    roster = rng.choice(roster_hi, 5000, replace=False).astype(np.uint32)
    bits = tbloom.bloom_packed_init(params, CPU)
    tbloom.bloom_add_packed_plain(bits, torch.from_numpy(roster.view(
        np.int32)), params)
    regs = rng.integers(0, 4, (num_banks, 1 << 14)).astype(np.uint8)
    counts = np.array([[0xFFFFFFF0, 7], [0xFFFFFFFF, 0]], np.uint32)
    return params, roster, bits.numpy().view(np.uint32), regs, counts


def _step_lanes(roster, n, num_banks, seed, key_hi, empty=()):
    rng = np.random.default_rng(seed)
    keys, banks = _lanes(seed, n, num_banks, key_hi, empty)
    member = rng.random(n) < 0.7
    keys = np.where(member, roster[rng.integers(0, len(roster), n)],
                    keys).astype(np.uint32)
    return keys, banks


def _compare_steps(jstep, tstep, buf, params, width, padded, nb, bits, regs,
                   counts):
    jstate, jvalid = jax.jit(jstep, static_argnums=(2, 3, 4, 5))(
        jfused.SketchState(jnp.asarray(bits), jnp.asarray(regs),
                           jnp.asarray(counts)),
        jnp.asarray(buf), jbloom.BloomParams(*params), width, padded, nb)
    tstate = tfused.state_from_numpy(bits, regs, counts, CPU)
    kernels.reset_launches()
    tvalid = tstep(tstate, torch.from_numpy(buf.view(np.int32)), params,
                   width, padded, nb)
    assert not any(kernels.launches.values())  # plain versions only
    _, tregs, tcounts = tfused.state_to_numpy(tstate)
    np.testing.assert_array_equal(tregs, np.asarray(jstate.hll_regs))
    np.testing.assert_array_equal(tcounts, np.asarray(jstate.counts))
    assert tvalid.shape == (padded,)  # every padded lane
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    return tvalid, tregs


# Per-bank counts that start segments on the first and on the last lane
# of 256-lane tiles (the kernels' tiles), in every other bank; 7,680 lanes
# (a multiple of 256, so the padding starts a tile too).
TILE_EDGE_COUNTS = [255, 257, 256, 255, 1, 511, 513, 512, 767, 769, 1023,
                    1025, 1535, 1]


def _tile_edge_lanes(roster, seed):
    """(keys, banks) with TILE_EDGE_COUNTS lanes in banks 0, 2, 4, ..."""
    keys, _ = _step_lanes(roster, sum(TILE_EDGE_COUNTS), 1, seed, 1 << 20)
    banks = np.repeat(2 * np.arange(len(TILE_EDGE_COUNTS)), TILE_EDGE_COUNTS)
    return keys, banks.astype(np.int32)


# (kb, n, num_banks, padded, empty banks); "tile_edge_heads" takes its
# lanes from _tile_edge_lanes, "header_1024" spreads them over the
# temporal plane's grown header, "no_real_lane" is all padding.
SEG_STEP_CASES = {
    "kb17": (17, 3000, 12, 4096, ()),
    "kb22_empty_banks": (22, 3000, 12, 4096, (0, 1, 6, 11)),
    "kb32": (32, 2000, 5, 2048, ()),
    "one_bank": (21, 1000, 1, 1024, ()),
    "tile_edge_heads": (20, sum(TILE_EDGE_COUNTS), 28, 8192, ()),
    "header_1024": (20, 6000, 1024, 8192, ()),
    "no_real_lane": (17, 0, 16, 4096, ()),
}


@pytest.mark.parametrize("case", list(SEG_STEP_CASES))
def test_fused_step_seg_matches_jax(case):
    kb, n, nb, padded, empty = SEG_STEP_CASES[case]
    params, roster, bits, regs, counts = _start_state(
        nb, 1, min(1 << kb, 1 << 20))
    if case == "tile_edge_heads":
        keys, banks = _tile_edge_lanes(roster, 2)
    else:
        keys, banks = _step_lanes(roster, n, nb, 2, 1 << kb, empty)
    buf, _ = tfused.pack_seg(keys, banks, kb, padded, nb)
    valid, tregs = _compare_steps(jfused.fused_step_seg, tfused.fused_step_seg,
                                  buf, params, kb, padded, nb, bits, regs,
                                  counts)
    assert n == 0 or (bool(valid[:n].any()) and (tregs != regs).any())
    for b in empty:
        np.testing.assert_array_equal(tregs[b], regs[b])


# (num_banks, padded, how the keys are drawn)
DELTA_STEP_CASES = ["narrow_empty_banks", "db32", "wrap", "one_bank",
                    "tile_edge_heads", "header_1024", "no_real_lane"]


@pytest.mark.parametrize("case", DELTA_STEP_CASES)
def test_fused_step_delta_matches_jax(case):
    nb, padded = {"narrow_empty_banks": (12, 4096), "db32": (3, 1024),
                  "wrap": (64, 8192), "one_bank": (1, 2048),
                  "tile_edge_heads": (28, 8192), "header_1024": (1024, 8192),
                  "no_real_lane": (16, 4096)}[case]
    params, roster, bits, regs, counts = _start_state(nb, 4)
    if case == "wrap":
        keys, banks = _step_lanes(roster, 8000, nb, 5, 1 << 32)
    elif case == "db32":
        keys, banks = _step_lanes(roster, 900, nb, 6, 1 << 20)
        keys[:2], banks[:2] = [0, 0xFFFFFFFF], 1
    elif case == "tile_edge_heads":
        keys, banks = _tile_edge_lanes(roster, 7)
    elif case in ("header_1024", "no_real_lane"):
        keys, banks = _step_lanes(roster, 6000 if nb == 1024 else 0, nb, 7,
                                  1 << 20)
    else:
        keys, banks = _step_lanes(
            roster, padded - 300, nb, 7, 1 << 20,
            (0, 4, 5, 11) if case.endswith("empty_banks") else ())
    scan = tfused.delta_scan(keys, banks, nb)
    db = tfused.pick_delta_width(1, scan[4])
    buf, _ = tfused.pack_delta(keys, banks, db, padded, nb, scan=scan)
    if case == "db32":
        assert db == 32
    if case == "wrap":
        assert int(scan[3].astype(np.int64).sum()) >= 1 << 32
    valid, _ = _compare_steps(jfused.fused_step_delta,
                              tfused.fused_step_delta, buf, params, db,
                              padded, nb, bits, regs, counts)
    assert not len(keys) or bool(valid[:len(keys)].any())


def test_narrow_steps_drop_banks_past_the_registers():
    """A header with more banks than the register rows (the rows a bank
    id indexes): lanes of those banks are probed and counted, and their
    registers dropped, as JAX's scatter drops them."""
    params, roster, bits, regs, counts = _start_state(4, 8)
    keys, banks = _step_lanes(roster, 1500, 8, 9, 1 << 20)
    buf, _ = tfused.pack_seg(keys, banks, 20, 2048, 8)
    _compare_steps(jfused.fused_step_seg, tfused.fused_step_seg, buf, params,
                   20, 2048, 8, bits, regs, counts)


def test_narrow_step_wrappers_validate_inputs():
    params, _, bits, regs, counts = _start_state(2, 0)
    state = tfused.state_from_numpy(bits, regs, counts, CPU)
    good = torch.zeros(tfused.seg_buf_words(2, 10, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tfused.fused_step_seg(state, good[:-1], params, 10, 256, 2)
    with pytest.raises(ValueError, match="width"):
        kernels.fused_step_delta(*state, good, params, db=33, padded=256,
                                 num_banks=2)
    with pytest.raises(ValueError, match="tensors on"):
        kernels.fused_step_seg(*state, good.to("meta"), params, kb=10,
                               padded=256, num_banks=2)
    valid = tfused.fused_step_seg(state, good, params, 10, 256, 2)
    assert valid.shape == (256,)  # an empty frame: every lane padding
    assert tfused.decode_counts(state.counts) == tfused.decode_counts(
        torch.from_numpy(counts.view(np.int32)))


# -- the whole slice ------------------------------------------------------------

def _run_both(wire, monkeypatch, native=True, frames=None, roster=None,
              num_events=24_000, num_banks=8, capacity=3000):
    """The same frames through the JAX and the port pipeline (by default
    8 banks, 12 lectures: the registers grow to 16 banks mid-run)."""
    if native:
        monkeypatch.delenv("ATP_NATIVE", raising=False)
    else:
        monkeypatch.setenv("ATP_NATIVE", "0")
    if frames is None:
        roster, frames = generate_frames(
            num_events, 4096, roster_size=2000, num_lectures=12,
            invalid_fraction=0.2, seed=17)
        frames = list(frames)
    jpipe = JaxPipeline(
        JaxConfig(bloom_filter_capacity=capacity, wire_format=wire,
                  transport_backend="memory"),
        client=JaxClient(JaxBroker()), num_banks=num_banks)
    tpipe = FusedPipeline(
        Config(bloom_filter_capacity=capacity, wire_format=wire),
        num_banks=num_banks, device="cpu")
    assert (jpipe._native is not None) == (tpipe._native is not None) \
        == native
    for pipe in (jpipe, tpipe):
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=num_events, idle_timeout_s=0.3)
    return jpipe, tpipe


def _assert_same_state(jpipe, tpipe, store=True):
    assert tpipe._bank_of == jpipe._bank_of
    _, tregs, tcounts = tfused.state_to_numpy(tpipe.state)
    np.testing.assert_array_equal(tregs, np.asarray(jpipe.state.hll_regs))
    np.testing.assert_array_equal(tcounts, np.asarray(jpipe.state.counts))
    assert tpipe.validity_counts() == jpipe.validity_counts()
    assert tpipe.count_all() == jpipe.count_all()
    if store:
        ours = tpipe.store.to_columns(deduplicate=False)
        theirs = jpipe.store.to_columns(deduplicate=False)
        for name in ("student_id", "lecture_day", "micros", "is_valid",
                     "event_type"):
            np.testing.assert_array_equal(ours[name], np.asarray(theirs[name]))
    assert tpipe.consumer.backlog() == 0


@pytest.mark.parametrize("wire,native", [
    ("word", True), ("bytes", True), ("seg", True), ("delta", True),
    ("seg", False), ("delta", False)])
def test_whole_slice_equals_jax_pipeline(wire, native, monkeypatch):
    jpipe, tpipe = _run_both(wire, monkeypatch, native=native)
    try:
        assert tpipe.metrics.wire_dwell == {wire: 6}
        assert jpipe.metrics.wire_dwell == tpipe.metrics.wire_dwell
        assert tpipe.state.hll_regs.shape[0] == 16  # grew from 8
        _assert_same_state(jpipe, tpipe)
        assert sum(tpipe.validity_counts()) == 24_000
        if wire in ("seg", "delta"):
            assert tpipe._kw_hint == jpipe._kw_hint
            assert tpipe._db_hint == jpipe._db_hint
            blocks = tpipe.store._blocks
            assert all(isinstance(b["is_valid"], (_ScatterValidity,
                                                  np.ndarray))
                       for b in blocks)
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


def test_whole_slice_auto_equals_jax_state(monkeypatch):
    """Under auto the JAX pipeline may block on its deque and climb the
    ladder where the port on the CPU never waits: only the state is
    compared, and the port stays on the word wire."""
    jpipe, tpipe = _run_both("auto", monkeypatch)
    try:
        assert tpipe.metrics.wire_dwell == {"word": 6}
        assert tpipe._auto_level == 0
        _assert_same_state(jpipe, tpipe)
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


def _frame(keys, days, micros=None, event_type=None):
    n = len(keys)
    return encode_planar_batch({
        "student_id": np.asarray(keys, np.uint32),
        "lecture_day": np.asarray(days, np.uint32),
        "micros": (np.arange(n, dtype=np.int64) if micros is None
                   else np.asarray(micros, np.int64)),
        "is_valid": np.ones(n, bool),
        "event_type": (np.zeros(n, np.int8) if event_type is None
                       else np.asarray(event_type, np.int8))})


@pytest.mark.parametrize("wire", ["auto", "seg", "delta", "word"])
def test_out_of_window_days_fall_back(wire, monkeypatch):
    """A frame with a calendar day and a hashed day far outside the dense
    LUT window: the native pack misses twice, the frame takes the numpy
    pack (auto: a wide wire), the bypass is armed, and the port equals
    the JAX pipeline."""
    rng = np.random.default_rng(5)
    n = 512
    roster = np.arange(10_000, 12_000, dtype=np.uint32)
    frame = _frame(rng.choice(roster, n),
                   np.where(rng.random(n) < 0.5, 20260101, 100_000_777))
    jpipe, tpipe = _run_both(wire, monkeypatch, frames=[frame],
                             roster=roster, num_events=n, capacity=5000)
    try:
        assert tpipe.metrics.events == n
        assert tpipe._native_skip == jpipe._native_skip == 32
        assert tpipe.metrics.wire_dwell == jpipe.metrics.wire_dwell
        assert sorted(tpipe.lecture_days()) == [20260101, 100_000_777]
        cols = tpipe.store.to_columns(deduplicate=False)
        assert len(cols["student_id"]) == n and cols["is_valid"].all()
        _assert_same_state(jpipe, tpipe)
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


def test_native_bypass_decays(monkeypatch):
    """The bypass armed by an out-of-window day decays by one per frame,
    as the JAX pipeline's does."""
    monkeypatch.delenv("ATP_NATIVE", raising=False)
    pipe = FusedPipeline(Config(bloom_filter_capacity=5000), num_banks=8,
                         device="cpu")
    pipe.preload(np.arange(100, 600, dtype=np.uint32))
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    producer.send(_frame(np.arange(100, 164), [20260302, 101_234_567] * 32))
    pipe.run(max_events=64, idle_timeout_s=0.3)
    assert pipe._native_skip == 32
    producer.send(_frame(np.arange(100, 164), [20260302] * 64))
    pipe.run(max_events=128, idle_timeout_s=0.3)
    assert pipe._native_skip == 31 and pipe.metrics.events == 128
    pipe.cleanup()


def test_delta_width_hint_decays_after_an_outlier(monkeypatch):
    """One frame with huge sorted-key gaps widens the delta wire; 16
    narrow frames in a row bring the hint back down, on the same frames
    as the JAX pipeline."""
    rng = np.random.default_rng(13)
    wide = rng.choice(1 << 22, 300, replace=False).astype(np.uint32)
    narrow = (10_000 + rng.choice(2_000, 300, replace=False)).astype(
        np.uint32)
    frames = [_frame(keys, np.full(300, 20260101))
              for keys in [wide] + [narrow] * 20]
    jpipe, tpipe = _run_both("delta", monkeypatch, frames=frames,
                             roster=narrow, num_events=300 * 21,
                             num_banks=4, capacity=10_000)
    try:
        assert tpipe._db_hint == jpipe._db_hint
        assert tpipe._db_hint < 10  # back from the outlier's width
        _assert_same_state(jpipe, tpipe)
    finally:
        jpipe.cleanup()
        tpipe.cleanup()
    monkeypatch.delenv("ATP_NATIVE", raising=False)
    pipe = FusedPipeline(Config(bloom_filter_capacity=10_000,
                                wire_format="delta"), num_banks=4,
                         device="cpu")
    pipe.preload(narrow)
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    producer.send(frames[0])
    pipe.run(max_events=300, idle_timeout_s=0.3)
    wide_hint = pipe._db_hint
    assert wide_hint >= 10  # 300 keys over 2^22: double-digit gaps
    for f in frames[1:]:
        producer.send(f)
    pipe.run(max_events=300 * 21, idle_timeout_s=0.3)
    assert pipe._db_hint < wide_hint
    pipe.cleanup()


@pytest.mark.parametrize("wire", ["word", "seg", "delta"])
def test_dedup_ties_keep_append_order(wire, monkeypatch):
    """Duplicate primary keys in one frame: the narrow wires' stable sort
    keeps last-write-wins exactly (student 7's surviving row is the last
    appended, event_type 1)."""
    frame = _frame([7, 7, 8, 7], [20260101] * 4, micros=[100] * 4,
                   event_type=[0, 1, 0, 1])
    jpipe, tpipe = _run_both(wire, monkeypatch, frames=[frame],
                             roster=np.array([7, 8], np.uint32),
                             num_events=4, capacity=100)
    try:
        cols = tpipe.store.to_columns()
        assert len(cols["student_id"]) == 2
        assert cols["event_type"][cols["student_id"] == 7].tolist() == [1]
        theirs = jpipe.store.to_columns()
        for name in cols:
            np.testing.assert_array_equal(cols[name], np.asarray(theirs[name]))
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


def test_auto_wire_ladder_adapts_to_backpressure(monkeypatch):
    """The ladder climbs one level per two forced waits, clamps at delta,
    descends one level per six drained-deque signals, clamps at word,
    and holds under mid-depth frames."""
    monkeypatch.delenv("ATP_NATIVE", raising=False)
    pipe = FusedPipeline(Config(), num_banks=8, device="cpu")

    def drive(frames, waited=False, depth=4):
        pipe._inflight.clear()
        pipe._inflight.extend([(None, None, [])] * depth)
        out = []
        for _ in range(frames):
            pipe._drain_waited = waited
            out.append(pipe._auto_wire())
        return out

    assert pipe._auto_level == 0
    seen = drive(2, waited=True)
    assert pipe._auto_level == 1 and seen[-1] == "seg"
    drive(20, waited=True)
    assert pipe._auto_level == 2 and drive(1, waited=True) == ["delta"]
    drive(5, depth=0)
    assert pipe._auto_level == 2  # not yet
    drive(30, depth=0)
    assert pipe._auto_level == 0 and drive(1, depth=0) == ["word"]
    pipe._auto_level, pipe._auto_pressure = 1, 0
    drive(50, depth=4)
    assert pipe._auto_level == 1
    pipe._inflight.clear()
    pipe.cleanup()


def test_store_puts_packed_validity_back_in_original_order():
    store = ColumnarEventStore()
    n = 5
    perm = np.array([3, 0, 4, 1, 2], np.uint32)  # packed lane -> event
    packed = torch.tensor([True, False, True, True, False, True, True])
    view = _ScatterValidity(packed, perm, n)
    store.insert_columns({
        "student_id": np.arange(n, dtype=np.uint32),
        "lecture_day": np.full(n, 20260101, np.uint32),
        "micros": np.arange(n, dtype=np.int64), "is_valid": view,
        "event_type": np.zeros(n, np.int8)})
    want = np.empty(n, bool)
    want[perm] = packed[:n].numpy()
    assert len(view) == n
    got = store.to_columns(deduplicate=False)["is_valid"]
    assert got.tolist() == want.tolist() == [False, True, False, True, True]
    assert np.asarray(view, dtype=np.int8).tolist() == [0, 1, 0, 1, 1]


@pytest.mark.parametrize("wire", ["seg", "delta"])
def test_cli_narrow_wires_print_the_word_wire_counts(wire, capsys):
    argv = ["fused", "--device", "cpu", "--num-events", "20000",
            "--frame-size", "4096", "--num-lectures", "3"]
    cli_main(argv + ["--wire-format", "word"])
    word = capsys.readouterr().out.strip().splitlines()
    cli_main(argv + ["--wire-format", wire])
    lines = capsys.readouterr().out.strip().splitlines()
    # Insights and per-lecture lines equal; three lecture lines.
    assert lines[:-1] == word[:-1]
    assert sum(ln.startswith("LECTURE_") for ln in lines) == 3
    summary = json.loads(lines[-1])
    assert summary["wire_dwell"] == {wire: 5}
    assert summary["valid"] == json.loads(word[-1])["valid"]
