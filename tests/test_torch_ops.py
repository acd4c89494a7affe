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
    "attendance_tpu_torch.transport"}


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
