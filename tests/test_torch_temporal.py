"""The temporal plane of the port against the JAX package, on the CPU.

The K4 blocked probe's plain version is held against both Pallas probes
it replaces (``bloom_contains_packed`` over the transposed table and
``bloom_contains_hbm`` over the row table, interpret mode, as
tests/test_pallas_kernels.py runs them) and against the XLA
``bloom_contains_words``; K5's plain version against the JAX
``hll_add`` with the window add's masking; the host modules (bucket
keys, ``BucketRing``, ``ReorderStage``) on the same sequences; and the
whole slice, the JAX ``FusedPipeline`` with the temporal plane on
(``ATP_NATIVE=0``) against the port's on ``device="cpu"``. Every
compared value is an integer or exact: tolerance 0.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.models import bloom as jbloom
from attendance_tpu.models import hll as jhll
from attendance_tpu.ops.pallas_kernels import (
    bloom_contains_hbm, bloom_contains_packed as b2_contains,
    pack_bits_rows, pack_bits_transposed)
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.pipeline.loadgen import generate_frames as jax_frames
from attendance_tpu.temporal import buckets as jbuckets
from attendance_tpu.temporal.reorder import ReorderStage as JaxReorder
from attendance_tpu.temporal.windows import BucketRing as JaxRing
from attendance_tpu.transport.memory_broker import (
    MemoryBroker as JaxBroker, MemoryClient as JaxClient)
from attendance_tpu_torch.cli import main as cli_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.models import bloom as tbloom
from attendance_tpu_torch.models import cms as tcms
from attendance_tpu_torch.models import hll as thll
from attendance_tpu_torch.models.fused import state_to_numpy
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.temporal import buckets as tbuckets
from attendance_tpu_torch.temporal.reorder import ReorderStage
from attendance_tpu_torch.temporal.windows import BucketRing
from attendance_tpu_torch import obs
from torch_port_fixtures import fresh_shared_broker  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """``audit_sample`` > 0 turns on each package's process-global
    telemetry (and its auditor): every test here leaves both off."""
    yield
    obs.disable()
    jobs.disable()

CPU = torch.device("cpu")


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy keys -> the port's int32 storage."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _filter(capacity: int, seed: int):
    """(params, port words, roster): a preloaded blocked filter."""
    params = tbloom.derive_bloom_params(capacity, 0.01, "blocked")
    rng = np.random.default_rng(seed)
    roster = rng.choice(1 << 22, capacity // 2, replace=False).astype(
        np.uint32)
    words = tbloom.bloom_packed_init(params, CPU)
    tbloom.bloom_add_packed(words, _t(roster), params)
    return params, words, roster


def _probe_keys(roster, n, seed):
    """Members and non-members interleaved, half and half."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < 0.5, rng.choice(roster, n),
                    rng.integers(1 << 22, 1 << 31, n)).astype(np.uint32)


def _padded(keys: np.ndarray, multiple: int) -> np.ndarray:
    return np.concatenate([keys, np.zeros(-len(keys) % multiple, np.uint32)])


# -- K4: the blocked probe ----------------------------------------------------

@pytest.mark.parametrize("capacity,batch", [(2000, 1500), (20_000, 2600)])
def test_k4_plain_matches_both_pallas_probes_and_xla(capacity, batch):
    """Batches that are not a multiple of 512: the port takes them as
    they are; the Pallas probes get them padded and are cut back."""
    params, words, roster = _filter(capacity, capacity)
    jparams = jbloom.BloomParams(*params)
    keys = _probe_keys(roster, batch, batch)
    got = kernels.bloom_contains(words, _t(keys), params).numpy()
    assert got.dtype == np.bool_ and got.shape == (batch,)
    np.testing.assert_array_equal(
        tbloom.bloom_contains_packed(words, _t(keys), params).numpy(), got)

    jwords = jnp.asarray(words.numpy().view(np.uint32))
    bits = jbloom.unpack_bloom_bits(jwords)
    b2 = np.asarray(b2_contains(pack_bits_transposed(bits),
                                jnp.asarray(_padded(keys, 1024)), jparams))
    b3 = np.asarray(bloom_contains_hbm(pack_bits_rows(bits),
                                       jnp.asarray(_padded(keys, 512)),
                                       jparams))
    xla = np.asarray(jbloom.bloom_contains_words(jwords, jnp.asarray(keys),
                                                 jparams))
    np.testing.assert_array_equal(got, b2[:batch])
    np.testing.assert_array_equal(got, b3[:batch])
    np.testing.assert_array_equal(got, xla)
    assert got[np.isin(keys, roster)].all()  # no false negatives
    assert not got.all()                     # and it does reject


def test_k4_rejects_the_flat_layout():
    params = tbloom.derive_bloom_params(1000, 0.01, "flat")
    words = tbloom.bloom_packed_init(params, CPU)
    keys = _t(np.arange(10))
    with pytest.raises(ValueError, match="blocked"):
        kernels.bloom_contains(words, keys, params)
    with pytest.raises(ValueError, match="blocked"):
        tbloom.bloom_contains_packed(words, keys, params)
    # The plain probe itself still answers for the flat layout.
    assert not tbloom.bloom_contains_words(words, keys, params).any()


def test_k4_wrapper_validates_and_launches_nothing_on_cpu():
    params, words, _ = _filter(1000, 1)
    with pytest.raises(ValueError):
        kernels.bloom_contains(words[:-1], _t(np.arange(4)), params)
    with pytest.raises(ValueError):
        kernels.bloom_contains(words, torch.arange(4), params)
    kernels.reset_launches()
    assert kernels.bloom_contains(words, _t(np.zeros(0, np.uint32)),
                                  params).shape == (0,)
    assert kernels.launches["bloom_contains"] == 0


# -- K5: the window add's register max ---------------------------------------

@pytest.mark.parametrize("masked", [True, False])
def test_k5_plain_matches_jax_window_add(masked):
    """The JAX window add: hll_add(regs, where(valid, bank, -1), keys)."""
    params, words, roster = _filter(5000, 3)
    jparams = jbloom.BloomParams(*params)
    rng = np.random.default_rng(4)
    n, num_banks = 6000, 10
    keys = _probe_keys(roster, n, 5)
    bank = rng.integers(-1, num_banks + 2, n).astype(np.int32)  # -1, OOB
    start = np.asarray(jhll.hll_add(
        jhll.hll_init(num_banks), jnp.asarray(rng.integers(
            0, num_banks, 3000, dtype=np.int32)),
        jnp.asarray(_probe_keys(roster, 3000, 6))))
    jvalid = jbloom.bloom_contains_words(
        jnp.asarray(words.numpy().view(np.uint32)), jnp.asarray(keys),
        jparams)
    jbank = jnp.where(jvalid, bank, -1) if masked else jnp.asarray(bank)
    want = np.asarray(jhll.hll_add(jnp.asarray(start), jbank,
                                   jnp.asarray(keys)))
    regs = torch.from_numpy(start.copy())
    valid = kernels.bloom_contains(words, _t(keys), params)
    kernels.hll_add(regs, torch.from_numpy(bank), _t(keys),
                    valid if masked else None, 14)
    np.testing.assert_array_equal(regs.numpy(), want)
    # The routed model function is the same on the CPU.
    regs2 = torch.from_numpy(start.copy())
    thll.hll_add(regs2, torch.from_numpy(bank), _t(keys),
                 valid if masked else None, 14)
    assert torch.equal(regs, regs2)


def test_k5_wrapper_validates():
    regs = thll.hll_init(2, 14, CPU)
    keys = _t(np.arange(4))
    with pytest.raises(ValueError):
        kernels.hll_add(regs, torch.arange(4), keys)  # int64 banks
    with pytest.raises(ValueError):
        kernels.hll_add(regs, torch.zeros(3, dtype=torch.int32), keys)
    with pytest.raises(ValueError):
        kernels.hll_add(regs, torch.zeros(4, dtype=torch.int32), keys,
                        torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.hll_add(regs, torch.zeros(4, dtype=torch.int32), keys,
                        precision=12)


# -- host modules on the same sequences ---------------------------------------

def test_bucket_helpers_match_jax():
    for day, period in [(0, 0), (20_260_701, 12_345),
                        (167_000_000, tbuckets.MAX_PERIOD)]:
        key = tbuckets.bucket_key(day, period)
        assert key == jbuckets.bucket_key(day, period)
        assert tbuckets.is_bucket_key(key) and not \
            tbuckets.is_bucket_key(day)
        assert tbuckets.decode_bucket_key(key) == \
            jbuckets.decode_bucket_key(key) == (day, period)
    for bad in ((1 << 28, 0), (0, tbuckets.MAX_PERIOD + 1), (-1, 0)):
        with pytest.raises(ValueError):
            tbuckets.bucket_key(*bad)
    with pytest.raises(ValueError):
        tbuckets.decode_bucket_key(20_260_701)
    rng = np.random.default_rng(0)
    days = rng.integers(20_260_701, 20_260_720, 500)
    micros = rng.integers(1_753_000_000_000_000, 1_753_100_000_000_000, 500)
    for period_s in (1.0, 2.5, 60.0):
        us = tbuckets.period_micros(period_s)
        assert us == jbuckets.period_micros(period_s)
        np.testing.assert_array_equal(
            tbuckets.bucket_keys(days, micros // us),
            jbuckets.bucket_keys(days, micros // us))
    with pytest.raises(ValueError):
        tbuckets.period_micros(0.5)


class _Alloc:
    """A recording allocator with a free list (popped from its end)."""

    def __init__(self):
        self.next = 0
        self.free_list = []
        self.freed = []

    def alloc(self, key):
        if self.free_list:
            return self.free_list.pop()
        self.next += 1
        return self.next - 1

    def free(self, keys, banks):
        self.freed.append((list(keys), list(banks)))
        self.free_list.extend(banks)


@pytest.mark.parametrize("capacity", [2, 5, 64])
def test_bucket_ring_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    rings = [(cls(1_000_000, capacity, a.alloc, a.free), a)
             for cls, a in ((BucketRing, _Alloc()), (JaxRing, _Alloc()))]
    head = 10_000_000
    for step in range(40):
        n = int(rng.integers(0, 50))
        days = rng.integers(20_260_701, 20_260_704, n)
        micros = head - rng.integers(0, 3_000_000, n)
        head += int(rng.integers(0, 800_000))
        got = [ring.assign(days, micros) for ring, _ in rings]
        np.testing.assert_array_equal(got[0][0], got[1][0])
        assert got[0][1:] == got[1][1:]
        wm = head - int(rng.integers(0, 2_000_000))
        assert rings[0][0].rotate(wm) == rings[1][0].rotate(wm)
        (ours, oa), (theirs, ta) = rings
        assert ours.buckets == theirs.buckets and oa.freed == ta.freed
        assert (ours.open_buckets, len(ours), ours.rotations_total,
                ours.evictions_total) == (
            theirs.open_buckets, len(theirs), theirs.rotations_total,
            theirs.evictions_total)
    assert rings[0][0].rotations_total > 0
    if capacity < 64:
        assert rings[0][0].evictions_total > 0
    with pytest.raises(ValueError):
        BucketRing(1_000_000, 1, _Alloc().alloc, _Alloc().free)


def _cols(micros, rng):
    n = len(micros)
    return {"student_id": rng.integers(0, 1000, n).astype(np.uint32),
            "lecture_day": rng.integers(20_260_701, 20_260_703, n).astype(
                np.uint32),
            "micros": np.asarray(micros, np.int64),
            "event_type": rng.integers(0, 2, n).astype(np.int8)}


@pytest.mark.parametrize("lateness_us", [0, 300_000, 2_000_000])
def test_reorder_stage_matches_jax(lateness_us):
    rng = np.random.default_rng(lateness_us)
    ours, theirs = ReorderStage(lateness_us), JaxReorder(lateness_us)
    assert np.isnan(ours.watermark_lag_s()) and np.isnan(
        theirs.watermark_lag_s())
    head = 5_000_000
    for _ in range(30):
        n = int(rng.integers(0, 300))
        micros = head + np.cumsum(rng.integers(1, 2000, n))
        late = rng.random(n) < 0.3
        micros[late] -= rng.integers(1, 1_500_000, int(late.sum()))
        head = int(micros.max()) if n else head
        cols = _cols(micros, rng)
        np.testing.assert_array_equal(ours.arrival_late_mask(micros),
                                      theirs.arrival_late_mask(micros))
        a, b = ours.offer(cols), theirs.offer(cols)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys()
            for name in a:
                np.testing.assert_array_equal(a[name], b[name])
            assert (np.diff(a["micros"]) >= 0).all()
        assert (ours.watermark_us, ours.effective_watermark_us,
                ours.buffered, ours.late_released_total,
                ours.released_total) == (
            theirs.watermark_us, theirs.effective_watermark_us,
            theirs.buffered, theirs.late_released_total,
            theirs.released_total)
    a, b = ours.flush(), theirs.flush()
    assert (a is None) == (b is None) == (lateness_us == 0)
    for name in b or ():
        np.testing.assert_array_equal(a[name], b[name])
    assert ours.effective_watermark_us == theirs.effective_watermark_us
    assert ours.watermark_lag_s() == theirs.watermark_lag_s() == 0.0
    assert ours.flush() is None and theirs.flush() is None
    assert ours.released_total == theirs.released_total > 0


# -- config and entry points ----------------------------------------------------

def test_temporal_config_defaults_and_checks_match_jax():
    ours, theirs = Config(), JaxConfig()
    for name in ("temporal_period_s", "allowed_lateness_s",
                 "watermark_idle_s", "temporal_ring_banks", "cms_depth",
                 "cms_width", "cms_topk", "audit_sample"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for bad in (dict(temporal_period_s=0.5), dict(temporal_period_s=-1),
                dict(allowed_lateness_s=-1), dict(watermark_idle_s=-1),
                dict(temporal_ring_banks=1), dict(cms_depth=0),
                dict(cms_width=0), dict(cms_topk=0), dict(audit_sample=2)):
        with pytest.raises(ValueError):
            Config(**bad)
        with pytest.raises(ValueError):
            JaxConfig(**bad).validate()
    Config(temporal_period_s=60)  # the happy path


def test_temporal_pipeline_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedPipeline(Config(temporal_period_s=60))


def test_cli_fused_temporal_on_cpu(capsys):
    cli_main(["fused", "--device", "cpu", "--num-events", "12000",
              "--frame-size", "4096", "--num-lectures", "2",
              "--temporal-period-s", "1", "--temporal-ring-banks", "64",
              "--allowed-lateness-s", "2", "--cms-topk", "4"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["events"] == 12_000
    ts = summary["temporal"]
    assert ts["events"] == 12_000
    assert ts["late_folded"] + ts["late_dropped"] > 0
    assert len(ts["topk"]) == 4
    assert summary["stage_seconds"]["temporal"] > 0


# -- the whole slice ------------------------------------------------------------

_SLICE = dict(num_events=20_000, batch=2048,
              gen=dict(roster_size=2000, num_lectures=3, seed=23,
                       disorder_frac=0.3, late_max_s=1.5))


def _run_slice(wire_format, monkeypatch):
    """The same ordered, disordered frames through both pipelines with a
    1 s period, a lateness under the disorder (so some events drop) and
    a ring small enough to evict; the register array grows from 8."""
    monkeypatch.setenv("ATP_NATIVE", "0")
    common = dict(bloom_filter_capacity=3000, wire_format=wire_format,
                  temporal_period_s=1.0, allowed_lateness_s=0.6,
                  temporal_ring_banks=10, cms_depth=3, cms_width=512,
                  cms_topk=5, audit_sample=1.0)
    jobs.disable()
    jpipe = JaxPipeline(JaxConfig(transport_backend="memory", **common)
                        .validate(), client=JaxClient(JaxBroker()),
                        num_banks=8)
    tpipe = FusedPipeline(Config(**common), num_banks=8, device="cpu")
    n = _SLICE["num_events"]
    for pipe, gen in ((jpipe, jax_frames), (tpipe, generate_frames)):
        roster, frames = gen(n, _SLICE["batch"], **_SLICE["gen"])
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=n, idle_timeout_s=0.3)
    return jpipe, tpipe


@pytest.mark.parametrize("wire_format", ["auto", "bytes"])
def test_whole_temporal_slice_equals_jax_pipeline(wire_format, monkeypatch):
    jpipe, tpipe = _run_slice(wire_format, monkeypatch)
    try:
        assert tpipe._bank_of == jpipe._bank_of
        assert tpipe._free_banks == jpipe._free_banks
        assert tpipe._next_bank == jpipe._next_bank
        assert tpipe.state.hll_regs.shape[0] > 8  # grew
        tb, tr, tc = state_to_numpy(tpipe.state)
        np.testing.assert_array_equal(tb, np.asarray(jpipe.state.bloom_bits))
        np.testing.assert_array_equal(tr, np.asarray(jpipe.state.hll_regs))
        np.testing.assert_array_equal(tc, np.asarray(jpipe.state.counts))
        assert tpipe.validity_counts() == jpipe.validity_counts()
        assert tpipe.count_all() == jpipe.count_all()
        assert tpipe.lecture_days() == jpipe.lecture_days()
        assert tpipe.metrics.wire_dwell == jpipe.metrics.wire_dwell
        wc = tpipe.window_counts()
        assert wc == jpipe.window_counts() and wc
        ts, js = tpipe.temporal_stats(), jpipe.temporal_stats()
        assert ts == js
        assert ts["evictions"] > 0 and ts["late_dropped"] > 0
        assert ts["late_folded"] > 0 and ts["rotations"] > 0
        assert ts["events"] == _SLICE["num_events"]
        np.testing.assert_array_equal(
            tcms.cms_to_numpy(tpipe._temporal.cms_counts),
            np.asarray(jpipe._temporal._cms))
        shadow = tpipe._temporal.shadow_truth()
        assert shadow == jpipe._temporal.shadow_truth()
        assert set(wc) <= set(shadow)  # retained buckets hold real events
        np.testing.assert_array_equal(tpipe._temporal.dwell_hist,
                                      jpipe._temporal.dwell_hist)
        assert list(tpipe._temporal.dropped_sample) == \
            list(jpipe._temporal.dropped_sample)
        ours = tpipe.store.to_columns(deduplicate=False)
        theirs = jpipe.store.to_columns(deduplicate=False)
        for name in ("student_id", "lecture_day", "micros", "is_valid"):
            np.testing.assert_array_equal(ours[name], theirs[name])
        assert tpipe.consumer.backlog() == 0
    finally:
        jpipe.cleanup()
        tpipe.cleanup()
        jobs.disable()


def test_window_counts_histogram_only_the_live_rows(monkeypatch):
    """After ring evictions have freed and recycled rows, window_counts()
    and count_all() histogram only the rows below the allocator's
    high-water mark and still equal the JAX pipeline's answers, which
    histogram every row."""
    from attendance_tpu_torch.pipeline import fast_path

    jpipe, tpipe = _run_slice("auto", monkeypatch)
    seen = []
    real = fast_path.best_histogram

    def spy(regs, precision):
        seen.append(regs.shape[0])
        return real(regs, precision)

    monkeypatch.setattr(fast_path, "best_histogram", spy)
    try:
        # Evicted rows were zeroed, freed and given to newer buckets.
        assert tpipe.temporal_stats()["evictions"] > 0
        assert tpipe._next_bank < tpipe.state.hll_regs.shape[0]
        wc = tpipe.window_counts()
        assert wc == jpipe.window_counts() and wc
        assert tpipe.count_all() == jpipe.count_all()
        assert seen == [tpipe._next_bank] * 2
    finally:
        jpipe.cleanup()
        tpipe.cleanup()
        jobs.disable()
