"""The repo's crash soaks on the port, on the CPU, held against the JAX
package's tools and pipeline.

The port's counterparts of ``tools/chaos_soak.py`` (``--wire columnar``,
``--spec shm``, ``--spec temporal``), ``tools/delta_crash_smoke.py`` and
``tools/control_soak.py``:

* their inputs equal the tools' byte for byte at the tools' own sizes and
  seeds (the tools loaded from ``tools/`` with ``sys.path`` set here, as
  ``tests/test_chaos.py`` loads them), and their constants equal the
  tools';
* the port's no-fault state on the COLW wire and its temporal oracle
  equal the JAX package's ``FusedPipeline`` on the same frames, tolerance
  0;
* each of the five soaks ends ``ok`` at a small size on the CPU, the shm,
  temporal and delta-crash ones across a real SIGKILL of a worker
  process (``--device cpu``), each under a deadline;
* the chain the port's killed temporal worker left restores in the JAX
  package to the same window estimates as in the port.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from attendance_tpu import chaos as jchaos
from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.transport.memory_broker import (
    MemoryBroker as JaxBroker, MemoryClient as JaxClient)
from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.chaos import delta_crash, soak
from attendance_tpu_torch.control import soak as control_soak
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

TOOLS = Path(__file__).resolve().parents[1] / "tools"
CAP = 5000
SMALL = dict(num_events=4096, batch=64, roster_size=2000, lectures=4)
# The temporal tail must be more than the 8 s lateness behind the end of
# the stream (about 1 ms of event time an event): 16 s.
TEMPORAL_SMALL = dict(num_events=16_384, batch=256, roster_size=2000,
                      lectures=4)


@pytest.fixture(autouse=True)
def _reset_globals():
    for pkg in (chaos, obs, jchaos, jobs):
        pkg.disable()
    yield
    for pkg in (chaos, obs, jchaos, jobs):
        pkg.disable()


def _tool(name):
    """One of the JAX tools, imported from ``tools/``."""
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    return __import__(name)


# -- the inputs, byte for byte ------------------------------------------------

def _tool_inputs(which):
    """(JAX tool's, port's) input of ``which`` at the tools' sizes and
    seeds."""
    cs = _tool("chaos_soak")
    seed = soak.TOOL_SEED
    if which == "columnar frames":
        return (cs._frames(seed, "columnar"),
                soak.soak_frames(seed, **soak.TOOL_SHAPE, wire="columnar"))
    if which == "columnar poison frames":
        return (cs._poison_frames(seed, "columnar"),
                soak.poison_frames(seed, "columnar"))
    if which == "temporal frames":
        return cs._temporal_frames(seed), soak.temporal_frames(
            seed, **soak.TOOL_SHAPE)
    if which == "delta-crash frames":
        return (_tool("delta_crash_smoke")._frames(),
                delta_crash.crash_frames())
    return (_tool("control_soak")._frames(control_soak.SEED),
            control_soak.control_frames(control_soak.SEED))


@pytest.mark.parametrize("which", [
    "columnar frames", "columnar poison frames", "temporal frames",
    "delta-crash frames", "control frames"])
def test_inputs_equal_the_tools_byte_for_byte(which):
    want, got = _tool_inputs(which)
    if which == "columnar poison frames":
        assert got == want and len(got) == soak.POISON_FRAMES + 1
        return
    (wroster, wframes), (groster, gframes) = want, got
    wframes = list(wframes)
    np.testing.assert_array_equal(groster, wroster)
    assert len(gframes) == len(wframes) > 0
    assert all(g == w for g, w in zip(gframes, wframes))


def test_constants_equal_the_tools():
    cs, dc, ctl = (_tool("chaos_soak"), _tool("delta_crash_smoke"),
                   _tool("control_soak"))
    assert (soak.SHM_SPEC, soak.TEMPORAL_SPEC, soak.TEMPORAL_PERIOD_S,
            soak.TEMPORAL_LATENESS_S, soak.TEMPORAL_TAIL, soak.POISON_FRAMES,
            soak.DATA_SEED_BASE, soak.DEFAULT_SPEC, soak.ROT_SPEC) == (
        cs.SHM_SPEC, cs.TEMPORAL_SPEC, cs.TEMPORAL_PERIOD_S,
        cs.TEMPORAL_LATENESS_S, cs.TEMPORAL_TAIL, cs.POISON_FRAMES,
        cs.DATA_SEED_BASE, cs.DEFAULT_SPEC, cs.ROT_SPEC)
    assert soak.TOOL_SHAPE == dict(num_events=cs.NUM_EVENTS, batch=cs.BATCH,
                                   roster_size=cs.ROSTER,
                                   lectures=cs.LECTURES)
    assert (dc.NUM_EVENTS, dc.BATCH, dc.SEED) == (
        delta_crash.NUM_EVENTS, delta_crash.BATCH, delta_crash.SEED)
    assert (ctl.NUM_EVENTS, ctl.FRAME_SIZE, ctl.LECTURES, ctl.BURST_FRAMES,
            ctl.TRICKLE_S, ctl.HEAL_S, ctl.FAULT_SPEC,
            ctl.MAX_ACTUATIONS) == (
        control_soak.NUM_EVENTS, control_soak.FRAME_SIZE,
        control_soak.LECTURES, control_soak.BURST_FRAMES,
        control_soak.TRICKLE_S, control_soak.HEAL_S, control_soak.FAULT_SPEC,
        control_soak.MAX_ACTUATIONS)


# -- the ground truths against the JAX package ---------------------------------

def _jax_state(pipe, windows=False):
    """``soak.sketch_state`` (and the window estimates) of a JAX
    pipeline."""
    days = sorted(int(d) for d in pipe.lecture_days())
    cols = pipe.store.to_columns()
    state = {"counts": {d: pipe.count(d) for d in days},
             "rows": int(len(cols["student_id"])),
             "valid": int(np.asarray(cols["is_valid"]).sum()),
             # The port keeps the words as int32: the same bits.
             "bloom": np.asarray(pipe.state.bloom_bits).view(np.int32),
             "regs": {d: np.asarray(pipe.state.hll_regs[pipe._bank_of[d]])
                      for d in days}}
    if windows:
        state["windows"] = {str(k): v
                            for k, v in pipe.window_counts().items()}
    return state


def _jax_run(config, roster, frames, lectures, max_events):
    pipe = JaxPipeline(config, client=JaxClient(JaxBroker()),
                       num_banks=lectures)
    try:
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=max_events, idle_timeout_s=2.0)
        return pipe, _jax_state(pipe, windows=config.temporal_period_s > 0)
    finally:
        pipe.cleanup()


def test_columnar_no_fault_state_equals_jax():
    want = soak.no_fault_state(1, device="cpu", capacity=CAP, wire="columnar",
                               **SMALL)
    roster, frames = soak.soak_frames(1, **SMALL, wire="columnar")
    _, jax_want = _jax_run(JaxConfig(bloom_filter_capacity=CAP,
                                     transport_backend="memory"),
                           roster, frames, SMALL["lectures"],
                           SMALL["num_events"])
    assert soak.state_diff(jax_want, want) == []
    # The same events as the binary wire's.
    binary = soak.no_fault_state(1, device="cpu", capacity=CAP, **SMALL)
    assert soak.state_diff(binary, want) == []


def test_temporal_oracle_equals_jax():
    want = soak.temporal_oracle(1, device="cpu", capacity=CAP,
                                **TEMPORAL_SMALL)
    roster, frames = soak.temporal_frames(1, **TEMPORAL_SMALL)
    jconfig = JaxConfig(
        bloom_filter_capacity=CAP, transport_backend="memory",
        temporal_period_s=soak.TEMPORAL_PERIOD_S,
        allowed_lateness_s=soak.TEMPORAL_LATENESS_S,
        temporal_ring_banks=soak.TEMPORAL_RING_BANKS,
        snapshot_mode="delta", snapshot_every_batches=4).validate()
    jpipe, jax_want = _jax_run(jconfig, roster, frames,
                               TEMPORAL_SMALL["lectures"],
                               TEMPORAL_SMALL["num_events"]
                               + soak.TEMPORAL_TAIL)
    assert soak.state_diff(jax_want, want) == []
    assert jax_want["windows"] == want["windows"] and want["windows"]
    jstats = jpipe.temporal_stats()
    for key in ("late_dropped", "rotations", "buckets", "evictions",
                "late_folded"):
        assert want["stats"][key] == jstats[key], key
    assert want["stats"]["late_dropped"] >= soak.TEMPORAL_TAIL


# -- the five soaks, small, on the CPU -------------------------------------------

def test_columnar_soak_dead_letters_the_rotted_frame(tmp_path):
    # 64 frames at the tool's seed: persist_fail twice in a row, a
    # conn_reset and a corrupt delivery all fire within them.
    report = soak.run_soak(1, wire="columnar", workdir=tmp_path,
                           device="cpu", capacity=CAP, max_seconds=90.0,
                           **SMALL)
    assert report["ok"], report["failures"]
    assert report["wire"] == "columnar"
    assert report["fault_run"] == report["no_fault"]
    assert report["quarantined"] >= soak.POISON_FRAMES + 1
    assert report["dead_lettered"] >= soak.POISON_FRAMES + 1
    assert report["circuit_opened"] > 0 and report["reconnects"] > 0
    assert report["doctor_ok"] is True
    assert chaos.get() is None and obs.get() is None


def test_shm_soak_survives_a_sigkilled_consumer(tmp_path):
    report = soak.run_shm_soak(1, workdir=tmp_path, device="cpu",
                               capacity=CAP, max_seconds=90.0, idle_s=1.0,
                               **SMALL)
    assert report["ok"], report["failures"]
    assert report["resume_backlog"] > 0
    assert 0 < report["killed_at_events"] < SMALL["num_events"]
    assert report["restored"] == report["no_fault"]
    assert report["injected"]["shm.slot/torn_slot"] > 0
    assert report["injected"]["shm.slot/writer_stall"] > 0
    assert chaos.get() is None and obs.get() is None


def _restore_windows(pipe_cls, config, client, lectures):
    pipe = pipe_cls(config, client=client, num_banks=lectures,
                    **({"device": "cpu"} if pipe_cls is FusedPipeline
                       else {}))
    try:
        return {str(k): v for k, v in pipe.window_counts().items()}
    finally:
        pipe.cleanup()


def test_temporal_soak_survives_a_sigkilled_worker(tmp_path):
    report = soak.run_temporal_soak(1, workdir=tmp_path, device="cpu",
                                    capacity=CAP, max_seconds=90.0,
                                    idle_s=1.0, **TEMPORAL_SMALL)
    assert report["ok"], report["failures"]
    assert report["doctor_ok"] is True
    assert report["resume_backlog"] > 0
    assert 0 < report["killed_at_events"] < TEMPORAL_SMALL["num_events"]
    assert report["restored"] == report["no_fault"]
    assert report["stats"]["late_dropped"] >= soak.TEMPORAL_TAIL
    # The chain the killed worker left restores in the JAX package to the
    # same window estimates as in the port (each from a copy of its own).
    at_kill = Path(report["chain_at_kill"])
    copies = [shutil.copytree(at_kill, tmp_path / name)
              for name in ("port-copy", "jax-copy")]
    common = dict(bloom_filter_capacity=CAP,
                  temporal_period_s=soak.TEMPORAL_PERIOD_S,
                  allowed_lateness_s=soak.TEMPORAL_LATENESS_S,
                  temporal_ring_banks=soak.TEMPORAL_RING_BANKS,
                  snapshot_mode="delta", snapshot_every_batches=4,
                  transport_backend="memory")
    port = _restore_windows(
        FusedPipeline, soak.temporal_config(copies[0], CAP,
                                            transport_backend="memory"),
        MemoryClient(MemoryBroker()), TEMPORAL_SMALL["lectures"])
    jax = _restore_windows(
        JaxPipeline, JaxConfig(snapshot_dir=str(copies[1]),
                               **common).validate(),
        JaxClient(JaxBroker()), TEMPORAL_SMALL["lectures"])
    assert port == jax and port
    assert chaos.get() is None and obs.get() is None


def test_delta_crash_restores_to_the_uninterrupted_run(tmp_path):
    report = delta_crash.run_delta_crash(
        workdir=tmp_path, device="cpu", num_events=16_384, batch=256,
        roster_size=2000, lectures=4, capacity=CAP, max_seconds=90.0,
        idle_s=1.0)
    assert report["ok"], report["failures"]
    assert report["doctor_rc"] == 0
    assert report["resume_backlog"] > 0
    assert report["chain_at_kill"]["deltas"]
    assert report["restored"] == report["no_fault"]


def test_control_soak_static_baseline_breaches_and_controller_saves(
        tmp_path):
    script = control_soak.Script(num_events=8192, frame_size=128,
                                 burst_frames=16, trickle_s=0.04,
                                 heal_s=1.0)
    report = control_soak.run_control_soak(
        workdir=tmp_path, device="cpu", script=script, capacity=CAP,
        max_seconds=90.0)
    assert report["ok"], report["failures"]
    base, ctl = report["baseline"], report["controlled"]
    assert base["dead_lettered"] > 0 and base["differs_in"]
    assert ctl["circuit_opened"] > 0 and ctl["drained"] == ctl["spilled"]
    assert 0 < ctl["actuations"] <= control_soak.MAX_ACTUATIONS
    assert ctl["peak_rung"] > 0
    assert report["doctor_actuations_rc"] == report["doctor_recompile_rc"] == 0
    assert chaos.get() is None and obs.get() is None
