"""Parity of the port's Count-Min sketch and top-K with the JAX package,
on the CPU.

The same numpy keys, made from a seed, go through the JAX functions and
the port's plain versions (``device="cpu"``). Count-Min is an integer
sketch under fixed murmur3 row seeds: tolerance 0, including duplicate
keys, masked lanes and counters that wrap past 2^32 - 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attendance_tpu.models import cms as jcms
from attendance_tpu_torch.models import cms as tcms
from attendance_tpu_torch.ops import kernels

CPU = torch.device("cpu")


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy keys -> the port's int32 storage."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _keys(seed: int, n: int, hi: int = 1 << 32) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, hi, n, dtype=np.uint64).astype(np.uint32)


def test_row_seeds_and_constants_match_jax():
    assert [tcms.row_seed(r) for r in range(8)] == [
        int(jcms.row_seed(r)) for r in range(8)]
    assert tcms.SEED_CMS_BASE == int(jcms.SEED_CMS_BASE)
    assert (tcms.DEFAULT_DEPTH, tcms.DEFAULT_WIDTH) == (
        jcms.DEFAULT_DEPTH, jcms.DEFAULT_WIDTH)


@pytest.mark.parametrize("depth,width", [(1, 1), (4, 16384), (3, 1000),
                                         (5, 7)])
def test_positions_match_jax(depth, width):
    keys = np.concatenate([np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32),
                           _keys(depth * width, 5000)])
    want = np.asarray(jcms.cms_positions(jnp.asarray(keys), depth, width))
    got = tcms.cms_positions(_t(keys), depth, width).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcms.cms_positions_np(keys, depth, width),
                                  jcms.cms_positions_np(keys, depth, width))


def _start_counts(depth, width, seed):
    """Counters spread over the uint32 range, some one step from wrap."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 2 ** 32, (depth, width),
                          dtype=np.uint64).astype(np.uint32)
    counts[:, ::3] = 0xFFFFFFFF
    counts[:, 1::3] = 0xFFFFFFFE
    return counts


_jax_step = jax.jit(jcms.cms_step)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("depth,width,batch", [
    pytest.param(4, 16384, "pool", id="4-16384"),
    pytest.param(3, 97, "pool", id="3-97"),
    # Every lane one key, every counter within n of 2^32: the batch's
    # adds to each of the key's counters cross the wrap.
    pytest.param(4, 16384, "one_key", id="4-16384-one_key"),
    # The temporal traffic's mix: 8 hot keys on 15% of the lanes.
    pytest.param(4, 16384, "hot", id="4-16384-hot")])
def test_cms_step_matches_jax(with_mask, depth, width, batch):
    rng = np.random.default_rng(depth + width)
    n = 6000
    # Duplicates: a small key pool, so keys repeat within the batch.
    keys = rng.choice(_keys(width, 800), n)
    mask = rng.random(n) < 0.7 if with_mask else None
    start = _start_counts(depth, width, width)
    if batch == "one_key":
        keys = np.full(n, keys[0], np.uint32)
        start = np.full((depth, width), 2 ** 32 - n // 2, np.uint32)
    elif batch == "hot":
        hot = _keys(width + 1, 8)
        keys = np.where(rng.random(n) < 0.15, hot[rng.integers(0, 8, n)],
                        keys).astype(np.uint32)
    jcounts, jest = _jax_step(jnp.asarray(start), jnp.asarray(keys),
                              None if mask is None else jnp.asarray(mask))
    counts = tcms.cms_from_numpy(start, CPU)
    est = tcms.cms_step(counts, _t(keys),
                        None if mask is None else torch.from_numpy(mask))
    assert est.dtype == torch.int32
    np.testing.assert_array_equal(tcms.cms_to_numpy(counts),
                                  np.asarray(jcounts))
    np.testing.assert_array_equal(est.numpy().view(np.uint32),
                                  np.asarray(jest))
    # Counters did wrap, and masked lanes read 0.
    assert (tcms.cms_to_numpy(counts) < start).any()
    if mask is not None:
        assert (est.numpy()[~mask] == 0).all()


def test_update_and_query_match_jax_and_numpy_twins():
    depth, width = 4, 2048
    keys = np.concatenate([_keys(3, 3000), np.full(50, 7, np.uint32)])
    mask = np.random.default_rng(4).random(len(keys)) < 0.8
    jcounts = np.asarray(jax.jit(jcms.cms_update)(
        jcms.cms_init(depth, width), jnp.asarray(keys), jnp.asarray(mask)))
    counts = tcms.cms_init(depth, width, CPU)
    tcms.cms_update(counts, _t(keys), torch.from_numpy(mask))
    np.testing.assert_array_equal(tcms.cms_to_numpy(counts), jcounts)
    np.testing.assert_array_equal(
        tcms.cms_update_np(tcms.cms_init_np(depth, width), keys, mask),
        jcms.cms_update_np(jcms.cms_init_np(depth, width), keys, mask))
    probe = np.concatenate([keys[:100], _keys(9, 500)])
    want = np.asarray(jcms.cms_query(jnp.asarray(jcounts),
                                     jnp.asarray(probe)))
    np.testing.assert_array_equal(
        tcms.cms_query(counts, _t(probe)).numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tcms.cms_query_np(jcounts, probe),
                                  jcms.cms_query_np(jcounts, probe))
    hits = int(mask[-50:].sum())  # the unmasked repeats of key 7
    assert int(tcms.cms_query(counts, _t(np.array([7], np.uint32)))[0]) \
        >= hits > 0
    assert len(tcms.cms_query_np(jcounts, np.zeros(0, np.uint32))) == 0


def test_counts_carry_across_packages():
    start = _start_counts(4, 64, 1)
    counts = tcms.cms_from_numpy(start, CPU)
    assert counts.dtype == torch.int32 and counts.shape == (4, 64)
    assert tcms.cms_to_numpy(counts).tobytes() == start.tobytes()
    with pytest.raises(ValueError):
        tcms.cms_init(0, 4, CPU)


def _offers(seed):
    """A stream of (keys, estimates) blocks with 4 hot keys."""
    rng = np.random.default_rng(seed)
    hot = np.array([11, 22, 33, 44], np.uint32)
    counts = tcms.cms_init(4, 4096, CPU)
    blocks = []
    for _ in range(12):
        keys = np.where(rng.random(2000) < 0.2,
                        hot[rng.integers(0, 4, 2000)],
                        rng.integers(100, 50_000, 2000)).astype(np.uint32)
        est = tcms.cms_step(counts, _t(keys)).numpy().view(np.uint32)
        blocks.append((keys, est.copy()))
    return hot, blocks


@pytest.mark.parametrize("k", [1, 4, 16])
def test_topk_matches_jax(k):
    hot, blocks = _offers(k)
    ours, theirs = tcms.TopK(k), jcms.TopK(k)
    for keys, est in blocks:
        ours.offer(keys, est)
        theirs.offer(keys, est)
        assert len(ours) == len(theirs)
    assert ours.items() == theirs.items()
    got = {key for key, _ in ours.items()}
    assert got <= set(hot.tolist()) if k <= 4 else set(hot.tolist()) <= got
    with pytest.raises(ValueError):
        tcms.TopK(0)


def test_cms_wrapper_validates_and_launches_nothing_on_cpu():
    counts = tcms.cms_init(4, 64, CPU)
    with pytest.raises(ValueError):
        kernels.cms_step(counts.to(torch.int64), _t(np.arange(4)))
    with pytest.raises(ValueError):
        kernels.cms_step(counts, torch.arange(4))  # int64 keys
    with pytest.raises(ValueError):
        kernels.cms_step(counts, _t(np.arange(4)),
                         torch.ones(3, dtype=torch.bool))
    kernels.reset_launches()
    est = kernels.cms_step(counts, _t(np.arange(4)))
    assert est.tolist() == [1, 1, 1, 1]
    assert kernels.launches["cms_step"] == 0
