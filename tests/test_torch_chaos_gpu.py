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
process-global injector and telemetry are gone after each soak. Skips
inside the test without a card.
"""

import pytest
import torch

from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.chaos import soak
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
