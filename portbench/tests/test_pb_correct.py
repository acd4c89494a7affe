"""``correct`` fails the control and every fault a cell can have: whole
runs at a tiny size on the CPU, with the harness's look for a card
skipped and the timed path broken underneath."""

import time

import numpy as np
import pytest

from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline import fast_path
from attendance_tpu_torch.pipeline.processor import AttendanceProcessor
from attendance_tpu_torch.sketch.base import SketchStore
from attendance_tpu_torch.sketch.tpu_store import TpuSketchStore
from portbench import reference, registry
from portbench.run import run_cell

CELLS = {"tiny.cell": "tiny-4096", "tiny.proc": "tiny-json"}


def run(root, pkg, cell, seed=11):
    code, res = run_cell(root, cell, seed, 0.3, False, "cpu",
                         time.perf_counter(), pkg=pkg)
    assert code == 0
    return res


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(tiny_bench, cell):
    res = run(*tiny_bench, cell, seed=2**31 + 17)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in res["checks"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(tiny_bench, cell):
    root, pkg = tiny_bench
    config = registry.load_config("tiny", pkg)
    traffic = registry.load_traffic(CELLS[cell], pkg)
    driver = registry.load_driver(traffic)(config, traffic, 5, "cpu")
    driver.setup()
    driver.window(0.2)
    k = reference.filter_params(config["roster_size"],
                                config["bloom_error_rate"],
                                driver.layout).k
    assert all(c["value"] == 0 for c in driver.verify().values())
    control = driver.verify(control_probes=k - 1)
    driver.close()
    # The control has to fail one of the cell's numbers: the filter
    # always; the answers as soon as a swipe falls between the two
    # filters, which the tiny processor window may not feed.
    if cell == "tiny.cell":
        assert control["filter_words"]["value"] > 0
        assert control["validity"]["value"] > 0
    else:
        assert control["filter_bits"]["value"] > 0


def _fused_state_unchanged(monkeypatch):
    orig = kernels.fused_step

    def step(bits, regs, counts, *a, **kw):
        return orig(bits, regs.clone(), counts.clone(), *a, **kw)
    monkeypatch.setattr(kernels, "fused_step", step)


def _fused_half_batch(monkeypatch):
    orig = fast_path.decode_frame

    def half(data, include_truth=True):
        cols = orig(data, include_truth)
        n = len(cols["student_id"]) // 2
        return {k: v[:n] for k, v in cols.items()}
    monkeypatch.setattr(fast_path, "decode_frame", half)


def _fused_answer_altered(monkeypatch):
    orig = kernels.fused_step

    def step(*a, **kw):
        valid = orig(*a, **kw).clone()
        valid[0] = ~valid[0]
        return valid
    monkeypatch.setattr(kernels, "fused_step", step)


def _proc_state_unchanged(monkeypatch):
    monkeypatch.setattr(TpuSketchStore, "_hll_add",
                        lambda self, key, *a, **kw: 0)


def _proc_half_batch(monkeypatch):
    orig = AttendanceProcessor.process_events
    monkeypatch.setattr(AttendanceProcessor, "process_events",
                        lambda self, ev: orig(self, ev[:len(ev) // 2]))


def _proc_answer_altered(monkeypatch):
    orig = SketchStore.bf_exists_many

    def exists(self, key, members):
        out = np.array(orig(self, key, members))
        if len(out) > 1:
            out[0] = ~out[0]
        return out
    monkeypatch.setattr(SketchStore, "bf_exists_many", exists)


@pytest.mark.parametrize("cell,fault,caught", [
    ("tiny.cell", _fused_state_unchanged, ("registers", "counters")),
    ("tiny.cell", _fused_half_batch, ("validity", "counters")),
    ("tiny.cell", _fused_answer_altered, ("validity",)),
    ("tiny.proc", _proc_state_unchanged, ("registers", "pfcount_keys")),
    ("tiny.proc", _proc_half_batch, ("rows", "counters")),
    ("tiny.proc", _proc_answer_altered, ("validity", "counters")),
])
def test_faults_fail(tiny_bench, monkeypatch, cell, fault, caught):
    fault(monkeypatch)
    res = run(*tiny_bench, cell)
    assert not res["correct"]
    for name in caught:
        assert res["checks"][name]["value"] > 0, name
