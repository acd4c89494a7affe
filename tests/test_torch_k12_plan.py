"""K12's plans on the CPU: which design K12-delta takes and how many lanes
a thread K12-seg takes, at the mesh's shapes (``chip_smoke.py``'s
``MESH_LANES`` and ``MESH_BANKS``, read from the script) and either side
of every cut-over; the shapes the kernels refuse; and the wrappers' CPU
route (the plain decode) against JAX's decode on frames with noisy
padding lanes, whatever design is asked for."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attendance_tpu.models import fused as jfused
from attendance_tpu_torch.ops import kernels


def _smoke_constant(name):
    """A constant of chip_smoke.py, read without importing the script."""
    tree = ast.parse((Path(__file__).resolve().parent.parent
                      / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == name:
                    return ast.literal_eval(node.value)
                if isinstance(target, ast.Tuple):
                    names = [t.id for t in target.elts]
                    if name in names:
                        return ast.literal_eval(
                            node.value.elts[names.index(name)])
    raise KeyError(name)


MESH_LANES = _smoke_constant("MESH_LANES")
MESH_BANKS = _smoke_constant("MESH_BANKS")
LOOKBACK_CTA_LANES = (kernels.K12_LOOKBACK_THREADS
                      * kernels.K12_LOOKBACK_LANES_PER_THREAD)


def test_mesh_shapes_are_the_ones_measured():
    assert MESH_LANES == (65_536, 131_072, 1_048_576)
    assert MESH_BANKS == 16


@pytest.mark.parametrize("lanes", MESH_LANES)
def test_delta_plan_at_the_mesh_lanes_is_one_lookback_launch(lanes):
    plan = kernels.decode_delta_plan(lanes, MESH_BANKS)
    assert plan.design == "lookback"
    assert plan.ctas == lanes // LOOKBACK_CTA_LANES
    assert plan.scratch_words == 4 + 8 * plan.ctas


@pytest.mark.parametrize("lanes,lpt", [
    (MESH_LANES[0], 2), (MESH_LANES[1], 2), (MESH_LANES[2], 4),
    (kernels.K12_SEG_WIDE_MIN_LANES - 1, 2),
    (kernels.K12_SEG_WIDE_MIN_LANES, 4), (1, 2), ((1 << 31) - 1, 4)])
def test_seg_lanes_per_thread(lanes, lpt):
    assert kernels.k12_seg_lanes_per_thread(lanes) == lpt


CUT = kernels.K12_LOOKBACK_MIN_LANES


@pytest.mark.parametrize("nb,below", [
    (1, "two_pass"), (2, "lookback"), (MESH_BANKS, "lookback"),
    (kernels.K12_SMALL_HEADER, "lookback"),
    (kernels.K12_SMALL_HEADER + 1, "two_pass"),
    (kernels.K12_TWO_PASS_MAX_BANKS, "two_pass"),
    (kernels.K12_TWO_PASS_MAX_BANKS + 1, "lookback"), (4096, "lookback"),
    (kernels.NARROW_MAX_BANKS, "lookback")])
@pytest.mark.parametrize("lanes", [1, 4_097, CUT - 1, CUT, CUT + 1,
                                   1_048_576])
def test_delta_plan_either_side_of_the_cut_over(lanes, nb, below):
    plan = kernels.decode_delta_plan(lanes, nb)
    assert plan.design == (below if lanes < CUT else "lookback")
    if plan.design == "two_pass":
        assert plan.ctas == -(-lanes // 256)
        assert plan.scratch_words == kernels.delta_scratch_words(lanes)
    else:
        assert plan.ctas == -(-lanes // LOOKBACK_CTA_LANES)
        assert plan.scratch_words == 4 + 8 * plan.ctas


@pytest.mark.parametrize("design", kernels.K12_DELTA_DESIGNS)
def test_delta_plan_forced_design(design):
    for lanes, nb in ((65_536, 16), (65_536, 256), (1_048_576, 1)):
        assert kernels.decode_delta_plan(lanes, nb,
                                         design=design).design == design


@pytest.mark.parametrize("lanes,nb,design,match", [
    (0, 16, None, "lanes"), (1 << 31, 16, None, "lanes"),
    (-5, 16, None, "lanes"), (4096, 0, None, "header banks"),
    (4096, kernels.NARROW_MAX_BANKS + 1, None, "header banks"),
    (4096, 16, "cluster", "unknown K12-delta design"),
    (4096, 16, "bogus", "unknown K12-delta design")])
def test_delta_plan_refuses(lanes, nb, design, match):
    with pytest.raises(ValueError, match=match):
        kernels.decode_delta_plan(lanes, nb, design=design)


def _noisy_frame(mode, n, padded, nb, seed):
    """(wire uint32, width) of a frame with padding lanes whose fields hold
    random bits, packed by the JAX package."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 26, n).astype(np.uint32)
    banks = rng.integers(0, nb, n).astype(np.int32)
    if mode == "seg":
        width, base = 26, nb
        buf, _ = jfused.pack_seg(keys, banks, width, padded, nb)
    else:
        scan = jfused.delta_scan(keys, banks, nb)
        width, base = jfused.pick_delta_width(1, scan[-1]), 2 * nb
        buf, _ = jfused.pack_delta(keys, banks, width, padded, nb, scan=scan)
    lo, hi = n * width, padded * width
    for bit in rng.choice(np.arange(lo, hi), (hi - lo) // 3, replace=False):
        buf[base + bit // 32] |= np.uint32(1) << np.uint32(bit % 32)
    return buf, width


@pytest.mark.parametrize("mode,design", [
    ("seg", None), ("delta", None),
    *(("delta", d) for d in kernels.K12_DELTA_DESIGNS)])
def test_cpu_route_equals_jax_decode_on_noisy_padding(mode, design):
    """On a CPU tensor the wrappers take the plain decode, whatever the
    plan would launch on the card, and launch nothing: keys and banks
    equal JAX's ``decode_seg_lanes`` / ``decode_delta_lanes`` on a frame
    whose padding lanes hold random bits (their keys are those bits on
    seg, bank 0's base plus the frame's running delta sum on delta)."""
    n, padded, nb = 2_900, 4_099, 16
    buf, width = _noisy_frame(mode, n, padded, nb, seed=len(mode))
    if mode == "seg":
        want = jfused.decode_seg_lanes(jnp.asarray(buf), width, padded, nb)
        got = kernels.decode_seg(torch.from_numpy(buf.view(np.int32)),
                                 kb=width, padded=padded, num_banks=nb)
    else:
        want = jfused.decode_delta_lanes(jnp.asarray(buf), width, padded, nb)
        before = dict(kernels.launches)
        got = kernels.decode_delta(torch.from_numpy(buf.view(np.int32)),
                                   db=width, padded=padded, num_banks=nb,
                                   design=design)
        assert kernels.launches == before
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1].numpy()[n:] == -1).all()


def test_cpu_route_refuses_an_unknown_design():
    buf, width = _noisy_frame("delta", 100, 256, 4, seed=0)
    with pytest.raises(ValueError, match="unknown K12-delta design"):
        kernels.decode_delta(torch.from_numpy(buf.view(np.int32)), db=width,
                             padded=256, num_banks=4, design="cluster")
