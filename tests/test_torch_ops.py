"""Port parity and isolation: murmur3 hash lanes, device selection, and
the rule that the PyTorch port loads no JAX and nothing of the JAX
package.

Inputs are made with numpy from a seed and handed to both packages;
the hashes are integer functions, so the tolerance is 0.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from attendance_tpu.ops import murmur3 as jmurmur
from attendance_tpu_torch.ops import murmur3 as tmurmur
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

EDGE_KEYS = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
SEEDS = [tmurmur.SEED_BLOOM_A, tmurmur.SEED_BLOOM_B, tmurmur.SEED_BLOCK,
         tmurmur.SEED_HLL_LO, tmurmur.SEED_HLL_HI, 0]


def test_seeds_match_jax():
    assert [tmurmur.SEED_BLOOM_A, tmurmur.SEED_BLOOM_B, tmurmur.SEED_BLOCK,
            tmurmur.SEED_HLL_LO, tmurmur.SEED_HLL_HI] == [
        int(jmurmur.SEED_BLOOM_A), int(jmurmur.SEED_BLOOM_B),
        int(jmurmur.SEED_BLOCK), int(jmurmur.SEED_HLL_LO),
        int(jmurmur.SEED_HLL_HI)]


@pytest.mark.parametrize("seed", SEEDS)
def test_murmur3_matches_jax(seed):
    rng = np.random.default_rng(seed)
    keys = np.concatenate([EDGE_KEYS, rng.integers(
        0, 2 ** 32, 100_000, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(jmurmur.murmur3_u32(keys, seed))
    # The port takes uint32 bit patterns in int32 storage (its word type).
    got = tmurmur.murmur3_u32(torch.from_numpy(keys.view(np.int32)), seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF
    np.testing.assert_array_equal(tmurmur.murmur3_u32_np(keys, seed), want)


@pytest.mark.parametrize("key", EDGE_KEYS.tolist())
def test_murmur3_edge_keys_match_host_reference(key):
    for seed in SEEDS:
        got = int(tmurmur.murmur3_u32(torch.tensor([key]), seed)[0])
        assert got == jmurmur.murmur3_u32_host(key, seed)


@pytest.mark.parametrize("data", [b"", b"a", b"ab", b"abc", b"abcd",
                                  b"LECTURE_20260701", b"hello, world"])
def test_murmur3_bytes_matches_jax(data):
    for seed in (0, 1, 0x9747B28C):
        assert tmurmur.murmur3_bytes(data, seed) == \
            jmurmur.murmur3_bytes(data, seed)


def test_u32_int32_round_trip():
    vals = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    as_i32 = tmurmur.to_i32(vals)
    assert as_i32.dtype == torch.int32
    assert tmurmur.as_u32(as_i32).tolist() == vals.tolist()


def test_resolve_device():
    from attendance_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_pipeline_without_card_raises():
    """No card and no explicit device: the port raises instead of
    dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedPipeline()


_ISOLATION_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys

    def forbidden(name):
        # attendance_tpu_torch shares the prefix: match the package and
        # its dotted children only.
        return (name in ("jax", "jaxlib", "attendance_tpu")
                or name.startswith(("jax.", "jaxlib.", "attendance_tpu.")))

    class Block:
        def find_spec(self, name, path=None, target=None):
            if forbidden(name):
                raise ImportError(f"port imported {name}")
            return None

    before = {m for m in sys.modules if forbidden(m)}
    sys.meta_path.insert(0, Block())
    import attendance_tpu_torch
    names = ["attendance_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            attendance_tpu_torch.__path__, "attendance_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted({m for m in sys.modules if forbidden(m)} - before)
    assert not leaked, leaked
    print(" ".join(names))
""")

# Modules that must be among those the probe imported.
_PORT_MODULES = {
    "attendance_tpu_torch.cli", "attendance_tpu_torch.config",
    "attendance_tpu_torch.models.bloom", "attendance_tpu_torch.models.cms",
    "attendance_tpu_torch.models.fused", "attendance_tpu_torch.models.hll",
    "attendance_tpu_torch.native", "attendance_tpu_torch.native.build",
    "attendance_tpu_torch.ops.kernels",
    "attendance_tpu_torch.pipeline.fast_path",
    "attendance_tpu_torch.temporal", "attendance_tpu_torch.temporal.buckets",
    "attendance_tpu_torch.temporal.plane",
    "attendance_tpu_torch.temporal.reorder",
    "attendance_tpu_torch.temporal.windows",
    "attendance_tpu_torch.pipeline.analyzer",
    "attendance_tpu_torch.storage.columnar_store",
    "attendance_tpu_torch.transport.memory_broker",
    "attendance_tpu_torch.utils.integrity",
    "attendance_tpu_torch.utils.snapshot",
    "attendance_tpu_torch.parity",
    "attendance_tpu_torch.pipeline.events",
    "attendance_tpu_torch.pipeline.generator",
    "attendance_tpu_torch.pipeline.processor",
    "attendance_tpu_torch.sketch", "attendance_tpu_torch.sketch.base",
    "attendance_tpu_torch.sketch.memory_store",
    "attendance_tpu_torch.sketch.redis_sim",
    "attendance_tpu_torch.sketch.redis_store",
    "attendance_tpu_torch.sketch.tpu_store",
    "attendance_tpu_torch.storage",
    "attendance_tpu_torch.storage.cassandra_store",
    "attendance_tpu_torch.storage.memory_store",
    "attendance_tpu_torch.transport",
    "attendance_tpu_torch.pipeline.codec",
    "attendance_tpu_torch.pipeline.lanes",
    "attendance_tpu_torch.pipeline.bridge",
    "attendance_tpu_torch.transport.framing",
    "attendance_tpu_torch.transport.quarantine",
    "attendance_tpu_torch.transport.resilience",
    "attendance_tpu_torch.transport.socket_broker",
    "attendance_tpu_torch.transport.shm_ring",
    "attendance_tpu_torch.serve", "attendance_tpu_torch.serve.mirror",
    "attendance_tpu_torch.serve.engine", "attendance_tpu_torch.serve.rpc",
    "attendance_tpu_torch.serve.chain"}


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _ISOLATION_PROBE],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 25  # every module was imported
    assert _PORT_MODULES <= names, _PORT_MODULES - names


# -- the path plan of K7 and K8 (ops/kernels.py bloom_bytes_plan) -------------

def _roster_params(layout, capacity=100_000, error_rate=0.01):
    from attendance_tpu_torch.models.bloom import derive_bloom_params
    return derive_bloom_params(capacity, error_rate, layout)


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_bytes_plan_takes_the_image_for_large_batches(layout):
    """The 100k-roster filters' images fit (117 and 135 KiB): K8 and K7
    take the image path at and above their crossovers, with K8's scratch
    of m_bits / 32 words (the image) and K7's of K7_IMAGE_PARTS times
    that (its partial images)."""
    from attendance_tpu_torch.ops import kernels
    m = _roster_params(layout).m_bits
    cross = kernels.K8_IMAGE_MIN_KEYS[layout]
    for n in (cross, cross + 1, 1 << 20):
        assert kernels.bloom_bytes_plan(n, m, layout) == (True, m // 32)
    for n in (kernels.K7_IMAGE_MIN_KEYS, kernels.K7_IMAGE_MIN_KEYS + 1,
              90_000):
        assert kernels.bloom_bytes_plan(n, m, layout, add=True) == (
            True, kernels.K7_IMAGE_PARTS * m // 32)


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_bytes_plan_stays_direct_for_small_batches(layout):
    from attendance_tpu_torch.ops import kernels
    m = _roster_params(layout).m_bits
    for n in (0, 1, 8192, kernels.K8_IMAGE_MIN_KEYS[layout] - 1):
        assert kernels.bloom_bytes_plan(n, m, layout) == (False, 0)
    for n in (0, 1, kernels.K7_IMAGE_MIN_KEYS - 1):
        assert kernels.bloom_bytes_plan(n, m, layout, add=True) == (False, 0)
    # A forced path wins over the batch length.
    assert kernels.bloom_bytes_plan(1, m, layout, image=True) == (True,
                                                                  m // 32)
    assert kernels.bloom_bytes_plan(1 << 20, m, layout, image=False) == (
        False, 0)


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_bytes_plan_keeps_a_filter_too_large_for_the_image_direct(layout):
    """The scalable chain's second sub-filter (200,000 at 0.5%: 269 KiB
    packed flat) does not fit in shared memory: direct at any length, and
    forcing the image raises."""
    from attendance_tpu_torch.ops import kernels
    m = _roster_params(layout, 200_000, 0.005).m_bits
    assert m // 8 > kernels.BYTES_IMAGE_MAX_BYTES
    for add in (False, True):
        assert kernels.bloom_bytes_plan(1 << 20, m, layout, add=add) == (
            False, 0)
        with pytest.raises(ValueError, match="does not fit"):
            kernels.bloom_bytes_plan(1 << 20, m, layout, add=add,
                                     image=True)


def test_bytes_wrappers_on_the_cpu_take_the_plain_version_on_any_path():
    """A forced path changes nothing on the CPU: the plain versions."""
    from attendance_tpu_torch.models import bloom
    from attendance_tpu_torch.ops import kernels
    params = _roster_params("flat", 1000)
    keys = torch.arange(500, dtype=torch.int32)
    want = bloom.bloom_init(params, torch.device("cpu"))
    bloom.bloom_add_plain(want, keys, params)
    before = dict(kernels.launches)
    for image in (None, False, True):
        bits = bloom.bloom_init(params, torch.device("cpu"))
        kernels.bloom_add_bytes(bits, keys, params, image=image)
        assert torch.equal(bits, want)
        probe = torch.arange(1000, dtype=torch.int32)
        assert torch.equal(
            kernels.bloom_contains_bytes(bits, probe, params, image=image),
            bloom.bloom_contains_plain(want, probe, params))
    assert torch.equal(kernels.bloom_pack_bytes(want),
                       bloom.pack_bloom_bits(want))
    assert kernels.launches == before
