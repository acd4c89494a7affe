"""The chaos soak on the card: ``python -m pytest --noconftest -m gpu
tests/test_torch_chaos_gpu.py`` (``--noconftest``: ``tests/conftest.py``
imports jax).

``chaos.soak.run_soak`` with the fused pipeline on ``cuda:0``: the JAX
soak's ``DEFAULT_SPEC`` (transport, sink and writer faults) and its
``ROT_SPEC`` (storage rot, ENOSPC, partitions; then a restore onto the
card through the repair ladder) and ``soak.SCRUB_SPEC`` (every chain
write rotted, then the same restore), at the seeds of ``soak.SEEDS``, each
firing every fault its gates read and ending in the state of the same
frames' no-fault run on the card, with zero false negatives. The
process-global injector and telemetry are gone after each soak. Then the
repo's crash soaks at a small size: the fault soak on the COLW wire; the
shm ring's consumer, the temporal worker and the delta-crash worker, each
a process on ``cuda:0`` SIGKILLed once its chain holds a delta, restored
onto the card and drained to the no-crash state; the control soak's
static baseline breaching and its controlled run not. Skips inside the
test without a card.
"""

import pytest
import torch

from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.chaos import delta_crash, soak
from attendance_tpu_torch.control import soak as control_soak
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("spec,restore", [
    ("DEFAULT_SPEC", False), ("ROT_SPEC", True), ("SCRUB_SPEC", True)])
def test_soak_on_the_card_equals_its_no_fault_run(tmp_path, spec, restore):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    report = soak.run_soak(
        soak.SEEDS[spec], spec=getattr(soak, spec), workdir=tmp_path,
        device=torch.device("cuda", 0), num_events=1 << 16, batch=1 << 9,
        roster_size=20_000, lectures=8, max_seconds=240.0,
        restore_check=restore)
    assert report["ok"], report["failures"]
    assert report["fault_run"] == report["no_fault"]
    assert report["bloom_false_negatives"] == 0
    assert report["quarantined"] >= soak.POISON_FRAMES
    # 128 frames at the spec's seed: every fault a gate reads fired.
    for _site, fault, _run, _draws in soak.GATED[spec]:
        assert any(key.endswith(f"/{fault}") for key in report["injected"])
    assert report["run_launches"]["fused_step"] > 0
    if restore:
        assert report["restored"] == report["no_fault"]
    if spec == "ROT_SPEC":
        assert report["enospc_hits"] > 0
    if spec == "SCRUB_SPEC":
        assert report["disk_rot_surviving"] == report["scrub_accounted"] > 0
    assert chaos.get() is None and obs.get() is None


_CARD = torch.device("cuda", 0)
_SMALL = dict(num_events=1 << 14, batch=1 << 8, roster_size=20_000,
              lectures=8, capacity=50_000)
_STEPS = ("fused_step", "fused_step_seg", "fused_step_delta")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _restored_on_the_card(report):
    assert report["ok"], report["failures"]
    assert report["resume_backlog"] > 0
    assert report["restored"] == report["no_fault"]
    got = report["restored_launches"]
    assert sum(got.get(k, 0) for k in _STEPS) >= report["restored_frames"]
    assert got["hll_histogram"] > 0


def test_columnar_soak_on_the_card(tmp_path):
    _need_card()
    report = soak.run_soak(1, wire="columnar", workdir=tmp_path,
                           device=_CARD, max_seconds=240.0, **_SMALL)
    assert report["ok"], report["failures"]
    assert report["fault_run"] == report["no_fault"]
    assert report["dead_lettered"] >= soak.POISON_FRAMES + 1
    assert sum(report["run_launches"][k] for k in _STEPS) >= 64
    assert chaos.get() is None and obs.get() is None


def test_shm_soak_with_a_card_worker_killed(tmp_path):
    _need_card()
    report = soak.run_shm_soak(1, workdir=tmp_path, device=_CARD,
                               max_seconds=240.0, shm_slots=16,
                               shm_slot_bytes=1 << 13, **_SMALL)
    _restored_on_the_card(report)
    assert report["injected"]["shm.slot/torn_slot"] > 0
    assert report["injected"]["shm.slot/writer_stall"] > 0


def test_temporal_soak_with_a_card_worker_killed(tmp_path):
    _need_card()
    report = soak.run_temporal_soak(1, workdir=tmp_path, device=_CARD,
                                    max_seconds=240.0, **_SMALL)
    _restored_on_the_card(report)
    assert report["doctor_ok"] is True
    for name in ("bloom_contains", "hll_add", "cms_step"):
        assert report["restored_launches"][name] > 0


def test_delta_crash_with_a_card_worker_killed(tmp_path):
    _need_card()
    report = delta_crash.run_delta_crash(
        workdir=tmp_path, device=_CARD, max_seconds=240.0,
        **dict(_SMALL, batch=1 << 9))
    _restored_on_the_card(report)
    assert report["doctor_rc"] == 0


def test_control_soak_on_the_card(tmp_path):
    _need_card()
    report = control_soak.run_control_soak(workdir=tmp_path, device=_CARD,
                                           max_seconds=240.0)
    assert report["ok"], report["failures"]
    assert report["baseline"]["dead_lettered"] > 0
    assert report["baseline"]["differs_in"]
    for run in ("no_fault", "baseline", "controlled"):
        assert sum(report["launches"][run].get(k, 0) for k in _STEPS) > 0
    assert chaos.get() is None and obs.get() is None
