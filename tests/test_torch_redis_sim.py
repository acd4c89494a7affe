"""The port's numpy copy of the hermetic Redis oracle equals the JAX
package's ``sketch/redis_sim.py`` on the same streams: MurmurHash64A,
RedisBloom sizing and probe positions, the scalable chain's answers,
bytes and BF.INFO, the dense-HLL (index, rank), registers, PFADD return
values and PFCOUNTs (tolerance 0)."""

import numpy as np
import pytest

from attendance_tpu.config import Config as JConfig
from attendance_tpu.sketch import redis_sim as jsim
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.parity import run_parity
from attendance_tpu_torch.sketch import ResponseError
from attendance_tpu_torch.sketch import redis_sim as tsim
from attendance_tpu_torch.sketch.tpu_store import TpuSketchStore


def _pair():
    return (jsim.RedisSimSketchStore(JConfig(sketch_backend="redis-sim")),
            tsim.RedisSimSketchStore(Config(sketch_backend="redis-sim")))


@pytest.mark.parametrize("length", [1, 5, 8, 9, 17])
def test_murmur64a_equals_jax(length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, size=(64, length), dtype=np.uint8)
    seeds = rng.integers(0, 2 ** 63, size=64, dtype=np.uint64)
    for seed in (0xADC83B19, seeds):
        np.testing.assert_array_equal(tsim.murmur64a_fixed(data, seed),
                                      jsim.murmur64a_fixed(data, seed))
    assert tsim.murmur64a_scalar(bytes(data[0]), 7) == \
        jsim.murmur64a_scalar(bytes(data[0]), 7) == \
        int(tsim.murmur64a_fixed(data[:1], 7)[0])


def test_hashes_sizing_and_positions_equal_jax():
    keys = np.random.default_rng(3).integers(0, 2 ** 32, 5000,
                                             dtype=np.uint64).astype(
                                                 np.uint32)
    keys[:3] = (0, 9, 4294967295)
    np.testing.assert_array_equal(tsim.hash_members_u64(keys, 5),
                                  jsim.hash_members_u64(keys, 5))
    for a, b in zip(tsim.bloom_hash_pairs(keys), jsim.bloom_hash_pairs(keys)):
        np.testing.assert_array_equal(a, b)
    for entries, error in ((1, 0.5), (100, 0.01), (100_000, 0.01),
                           (1000, 0.001)):
        tp = tsim.sim_bloom_params(entries, error)
        assert tuple(tp) == tuple(jsim.sim_bloom_params(entries, error))
        np.testing.assert_array_equal(
            tsim.sim_bloom_positions(keys, tp),
            jsim.sim_bloom_positions(keys, jsim.sim_bloom_params(
                entries, error)))
    for a, b in zip(tsim.sim_hll_bucket_rank(keys),
                    jsim.sim_hll_bucket_rank(keys)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ResponseError):
        tsim.sim_bloom_params(0, 0.01)


def test_sim_store_streams_equal_jax():
    j, t = _pair()
    rng = np.random.default_rng(5)
    out = {"j": [], "t": []}
    for s, name in ((j, "j"), (t, "t")):
        rng = np.random.default_rng(5)
        out[name].append(s.execute_command("BF.RESERVE", "bf", 0.01, 300))
        for _ in range(4):
            batch = rng.integers(10_000, 11_500, 400)
            out[name].append(s.bf_add_many("bf", batch).tolist())
            out[name].append(s.bf_exists_many(
                "bf", rng.integers(10_000, 13_000, 600)).tolist())
            out[name].append(s.execute_command("BF.INFO", "bf"))
            out[name].append(s.execute_command("BF.MADD", "auto", 7, 7, 8))
            key = f"h{int(batch[0]) % 3}"
            out[name].append(s.pfadd(key))
            out[name].append(s.pfadd(key, *batch[:30].tolist()))
            out[name].append(s.pfadd_many(key, batch, mask=batch % 2 == 0))
            out[name].append(s.pfcount(key))
            out[name].append(s.pfcount("h0", "h1", "h2", "none"))
        out[name].append(s.estimated_fpr("bf"))
    assert out["t"] == out["j"]
    for key in j._blooms:
        for a, b in zip(j._blooms[key].filters, t._blooms[key].filters):
            np.testing.assert_array_equal(a, b)
    assert j._hlls.keys() == t._hlls.keys()
    for key in j._hlls:
        np.testing.assert_array_equal(j._hlls[key], t._hlls[key])
    with pytest.raises(ResponseError, match="exists"):
        t.execute_command("BF.RESERVE", "bf", 0.01, 300)
    t.flush()
    assert t.pfcount("h0") == 0 and t.bf_exists_many("bf", [1]).tolist() == [
        False]


def test_card_store_against_the_sim_oracle():
    """The parity harness on the CPU: no false negatives, FPR and HLL
    error within budget for the card store and the oracle."""
    report = run_parity(TpuSketchStore(Config(), device="cpu"),
                        tsim.RedisSimSketchStore(
                            Config(sketch_backend="redis-sim")),
                        num_events=8000, roster_size=2000, num_lectures=3)
    assert report.ok, report.summary()
    assert report.false_negatives_a == report.false_negatives_b == 0
