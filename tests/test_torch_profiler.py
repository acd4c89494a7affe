"""The port's attribution plane (``attendance_tpu_torch/obs/profiler.py``,
``utils/profiling.py``) against the JAX package's (``tests/test_profiler.py``
apart from its trend-gate tests, which drive a JAX tool, and its fleet
headline test, which waits for the port's fleet plane).

The same synthetic samples fold into the same collapsed stacks,
attribution documents and tables in both packages (tolerance 0); the
launch-shape tracker counts the same fingerprints as JAX's recompile
tracker over the same frames on every wire the two share; a profiled
fused run writes the JAX package's three artifacts, which either
package's ``telemetry --attribution`` renders alike. ``--profile-dir`` on
the CPU is a CPU-activity ``torch.profiler`` trace with one
``fused_step_dispatch`` range a frame. Every test leaves both packages'
process-global telemetry disabled.
"""

import json
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.cli import main as jax_main
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.obs import profiler as jprofiler
from attendance_tpu.obs.registry import Registry as JaxRegistry
from attendance_tpu_torch import obs
from attendance_tpu_torch.cli import main as port_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs import profiler
from attendance_tpu_torch.obs.profiler import (
    ATTRIBUTION_FILE, FOLDED_FILE, TRACE_FILE, RecompileTracker,
    SamplingProfiler, StageTracker, format_attribution_table)
from attendance_tpu_torch.obs.registry import Registry
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


# -- stage tracker -----------------------------------------------------------

def test_stage_tracker_set_restore_nesting():
    st = StageTracker()
    ident = threading.get_ident()
    assert st.get(ident) is None
    prev = st.set("dispatch")
    assert prev is None and st.get(ident) == "dispatch"
    prev2 = st.set("device_wait")
    assert prev2 == "dispatch"
    st.restore(prev2)
    assert st.get(ident) == "dispatch"
    st.restore(prev)
    assert st.get(ident) is None


def test_stage_tracker_prunes_dead_thread_marks():
    prof = SamplingProfiler(50)
    t = threading.Thread(target=lambda: prof.stages.set("serve"))
    t.start()
    t.join()
    assert prof.stages.get(t.ident) == "serve"
    prof.sample_once()
    assert prof.stages.get(t.ident) is None


# -- the same samples through both packages ------------------------------------

def _frame(chain):
    """A fake frame stack, root first: ``file.py:func`` entries."""
    f = None
    for entry in chain:
        path, name = entry.split(":")
        f = types.SimpleNamespace(
            f_code=types.SimpleNamespace(co_filename=f"/x/{path}",
                                         co_name=name), f_back=f)
    return f


# (thread ident, thread name, stage or None, stack) for each sample.
THREADS = [
    (101, "MainThread", "dispatch", ["run.py:main", "fast_path.py:run",
                                     "fast_path.py:process_frame"]),
    (102, "ingress-lane-0", "lane_decode", ["lanes.py:_run",
                                            "codec.py:decode"]),
    (103, "snapshot-writer", None, ["fast_path.py:_snap_writer_main"]),
    (104, "fleet-conn-51734", "serve", ["engine.py:pin"]),
]


def _synthetic_profile(pkg, monkeypatch, rounds=12):
    """Fold ``rounds`` samples of THREADS (stages changing part way) into
    a profiler of ``pkg``, on a fake clock."""
    mod = profiler if pkg == "port" else jprofiler
    reg = Registry() if pkg == "port" else JaxRegistry()
    clock = iter(np.arange(0.0, 100.0, 0.01).tolist())
    prof = mod.SamplingProfiler(97, registry=reg,
                                _clock=lambda: next(clock))
    prof._epoch = 1_000.0
    names = [types.SimpleNamespace(ident=i, name=n)
             for i, n, _, _ in THREADS]
    monkeypatch.setattr(threading, "enumerate", lambda: names)
    for r in range(rounds):
        frames = {}
        for ident, _name, stage, stack in THREADS:
            if ident == 101 and r >= rounds // 2:
                stage, stack = "device_wait", stack + ["fast_path.py:wait"]
            frames[ident] = _frame(stack)
            if stage is None:
                prof.stages._stages.pop(ident, None)
            else:
                prof.stages._stages[ident] = stage
        monkeypatch.setattr(sys, "_current_frames", lambda f=frames: f)
        prof.sample_once()
    monkeypatch.undo()
    return prof, reg


def test_collapsed_stacks_and_trace_equal_jax(monkeypatch):
    ours, _ = _synthetic_profile("port", monkeypatch)
    theirs, _ = _synthetic_profile("jax", monkeypatch)
    assert ours.collapsed() == theirs.collapsed()
    lines = ours.collapsed().splitlines()
    assert "MainThread;dispatch;run.py:main;fast_path.py:run;" \
           "fast_path.py:process_frame 6" in lines
    assert "fleet-conn;serve;engine.py:pin 12" in lines
    assert "snapshot-writer;untagged;fast_path.py:_snap_writer_main 12" \
        in lines
    a, b = ours.chrome_trace(), theirs.chrome_trace()
    for doc in (a, b):
        doc["traceEvents"] = [e for e in doc["traceEvents"]
                              if e["name"] != "process_name"]
    assert a == b
    # Six same-stage samples merge into one slice a thread and stage.
    xs = [e for e in a["traceEvents"] if e.get("ph") == "X"]
    assert sorted(e["name"] for e in xs) == [
        "device_wait", "dispatch", "lane_decode", "serve", "untagged"]


def test_attribution_document_and_table_equal_jax(monkeypatch):
    ours, oreg = _synthetic_profile("port", monkeypatch)
    theirs, jreg = _synthetic_profile("jax", monkeypatch)
    rc, jrc = RecompileTracker(), jprofiler.RecompileTracker()
    for tracker in (rc, jrc):
        tracker.observe("step_words", (20, 4096))
        tracker.mark_warm()
        tracker.observe("step_words", (21, 4096))
    a, b = ours.attribution(rc), theirs.attribution(jrc)
    for doc in (a, b):
        for key in ("pid", "duration_s"):
            doc.pop(key)
        for fp in doc["recompiles"]["fingerprints"]:
            fp.pop("ts")
    assert a == b
    assert a["samples_total"] == 48
    a.update(pid=7, duration_s=1.5)
    assert format_attribution_table(a) == \
        jprofiler.format_attribution_table(a)
    # The stage-fraction gauges render alike.
    from attendance_tpu.obs.exposition import render as jrender
    from attendance_tpu_torch.obs.exposition import render
    assert render(oreg) == jrender(jreg)
    assert 'attendance_profile_stage_fraction{stage="dispatch"}' \
        in render(oreg)


def _spin(stop, tracker, stage):
    tracker.set(stage)
    while not stop.is_set():
        sum(i for i in range(200))


def test_collapsed_stacks_two_thread_workload():
    """Two live threads in their own marked stages: every sample of a
    thread's function lands under that thread's stage, never the other's."""
    prof = SamplingProfiler(97)
    stop = threading.Event()
    threads = [threading.Thread(target=_spin, args=(stop, prof.stages, s),
                                name=f"{s}-worker", daemon=True)
               for s in ("alpha", "beta")]
    for t in threads:
        t.start()
    try:
        for _ in range(40):
            prof.sample_once()
            time.sleep(0.002)
    finally:
        stop.set()
        for t in threads:
            t.join()
    for s in ("alpha", "beta"):
        lines = [ln for ln in prof.collapsed().splitlines()
                 if ln.startswith(f"{s}-worker;")]
        assert lines and all(ln.startswith(f"{s}-worker;{s};")
                             for ln in lines)
    att = prof.attribution()
    assert att["stages"]["alpha"]["samples"] >= 10
    assert att["threads"]["alpha-worker"]["alpha"] == \
        att["stages"]["alpha"]["samples"]


def test_sampler_start_stop_hygiene():
    prof = SamplingProfiler(211)
    prof.start()
    deadline = time.monotonic() + 5.0
    while prof.samples == 0:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    prof.stop()
    assert not prof.running
    assert not [t for t in threading.enumerate()
                if t.name == "attendance-profiler"]
    frozen = prof.samples
    time.sleep(3.0 / 211 + 0.05)  # three would-be sampling periods
    assert prof.samples == frozen
    prof.stop()  # idempotent


# -- launch-shape tracker --------------------------------------------------------

def test_recompile_tracker_fires_once_per_fingerprint_like_jax():
    reg, jreg = Registry(), JaxRegistry()
    ours, theirs = RecompileTracker(reg), jprofiler.RecompileTracker(jreg)
    calls = ([("step_words", (20, 4096))] * 50
             + [("step_words", (20, 8192)), ("step_bytes", (4096,))]
             + [None]
             + [("step_words", (20, 4096)), ("step_words", (21, 4096))])
    for call in calls:
        if call is None:
            ours.mark_warm()
            theirs.mark_warm()
            continue
        assert ours.observe(*call) == theirs.observe(*call)
    assert (ours.total, ours.steady) == (theirs.total, theirs.steady) == (4, 1)
    from attendance_tpu.obs.exposition import render as jrender
    from attendance_tpu_torch.obs.exposition import render
    assert render(reg) == jrender(jreg)
    counters = {(m.name, m.labels): m.value
                for _, _, _, members in reg.collect() for m in members}
    assert counters[("attendance_recompiles_steady_total",
                     (("fn", "step_words"),))] == 1


# -- the attribution table --------------------------------------------------------

GOLDEN_DOC = {
    "kind": "attribution", "pid": 7, "hz": 29.0,
    "samples_total": 200, "duration_s": 4.0,
    "stages": {"decode": {"samples": 60, "frac": 0.3},
               "dispatch": {"samples": 120, "frac": 0.6},
               "untagged": {"samples": 20, "frac": 0.1}},
    "threads": {"MainThread": {"decode": 60, "dispatch": 120},
                "snapshot-writer": {"untagged": 20}},
    "recompiles": {"total": 3, "steady": 1, "fingerprints": [
        {"fn": "step_words", "fingerprint": [20, 4096], "steady": False},
        {"fn": "step_words", "fingerprint": [20, 8192], "steady": True},
    ]},
}


def test_attribution_table_golden():
    rendered = format_attribution_table(GOLDEN_DOC)
    assert rendered == (DATA / "attribution_table.golden").read_text(
    ).rstrip("\n")


def test_attribution_sniffed_by_format_file_and_both_verbs(tmp_path,
                                                          capsys):
    from attendance_tpu_torch.obs.exposition import format_file

    p = tmp_path / ATTRIBUTION_FILE
    p.write_text(json.dumps(GOLDEN_DOC))
    out = format_file(str(p))
    assert "dispatch" in out and "60.0%" in out
    for path in (str(p), str(tmp_path)):
        port_main(["telemetry", path, "--attribution"])
        ours = capsys.readouterr().out
        jax_main(["telemetry", path, "--attribution"])
        assert ours == capsys.readouterr().out and "recompiles:" in ours
    port_main(["telemetry", str(p)])
    assert capsys.readouterr().out.strip() == out


@pytest.mark.parametrize("what", ["missing", "not-attribution", "garbage"])
def test_telemetry_attribution_unreadable_exits_2(tmp_path, what):
    path = tmp_path / "nope"
    if what == "not-attribution":
        path.write_text(json.dumps({"records": []}))
    elif what == "garbage":
        path.write_text("{not json")
    with pytest.raises(SystemExit) as exc:
        port_main(["telemetry", str(path), "--attribution"])
    assert exc.value.code == 2


def test_profile_out_without_hz_is_a_config_error(tmp_path):
    with pytest.raises(ValueError, match="profile-hz"):
        Config(profile_out=str(tmp_path))
    with pytest.raises(ValueError, match="profile_hz"):
        Config(profile_hz=-1.0)
    with pytest.raises(ValueError, match="1000"):
        Config(profile_hz=5_000.0)
    Config(profile_out=str(tmp_path), profile_hz=29)


# -- the fused run, both packages ---------------------------------------------------

def _run_both(monkeypatch, tmp_path, port_kw, jax_kw=None, *, events=8_192,
              frame=2_048, runs=2, mesh=None, **common):
    """The same frames through the JAX and the port fused pipeline with
    telemetry on, twice through each (the second run on the same seed's
    frames); returns each package's recompile snapshot after each run."""
    from attendance_tpu.pipeline.fast_path import (
        FusedPipeline as JaxPipeline)
    from attendance_tpu.pipeline.loadgen import generate_frames as jgen
    from attendance_tpu.transport.memory_broker import (
        MemoryBroker as JBroker, MemoryClient as JClient)
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    monkeypatch.setenv("ATP_NATIVE", "0")
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            cfg = JaxConfig(transport_backend="memory",
                            json_chunk_decode=False,
                            **{**common, **(jax_kw or {})})
            t = jobs.enable(cfg)
            client = JClient(JBroker())
            pipe = JaxPipeline(cfg, client=client, num_banks=8)
            gen = jgen
        else:
            cfg = Config(**common, **port_kw)
            t = obs.enable(cfg)
            client = MemoryClient(MemoryBroker())
            if mesh is None:
                pipe = FusedPipeline(cfg, client=client, num_banks=8,
                                     device="cpu")
            else:
                from attendance_tpu_torch.parallel import make_mesh
                pipe = FusedPipeline(cfg, client=client, num_banks=8,
                                     mesh=make_mesh(*mesh,
                                                    ["cpu"] * (mesh[0]
                                                               * mesh[1])))
            gen = generate_frames
        snaps = []
        try:
            producer = client.create_producer(cfg.pulsar_topic)
            for r in range(runs):
                roster, frames = gen(events, frame, roster_size=4_000,
                                     num_lectures=4, seed=3,
                                     **({"disorder_frac": 0.25,
                                         "late_max_s": 0.8}
                                        if common.get("temporal_period_s")
                                        else {}))
                if r == 0:
                    pipe.preload(roster)
                for f in frames:
                    producer.send(f)
                pipe.run(max_events=events * (r + 1), idle_timeout_s=0.3)
                snap = t.recompiles.snapshot()
                snaps.append((snap["total"], snap["steady"], sorted(
                    (fp["fn"], tuple(fp["fingerprint"]), fp["steady"])
                    for fp in snap["fingerprints"])))
            text = t.render()
        finally:
            pipe.cleanup()
            (jobs if pkg == "jax" else obs).disable()
        out[pkg] = (snaps, text)
    return out


WIRES = {
    "word": dict(wire_format="word"),
    "bytes": dict(wire_format="bytes"),
    "seg": dict(wire_format="seg"),
    "delta": dict(wire_format="delta"),
    "temporal": dict(temporal_period_s=60.0, allowed_lateness_s=5.0,
                     temporal_ring_banks=64),
    "delta-snapshots": dict(snapshot_every_batches=2, snapshot_mode="delta"),
}


@pytest.mark.parametrize("case", sorted(WIRES))
def test_recompile_counts_equal_jax(monkeypatch, tmp_path, case):
    kw = dict(WIRES[case])
    if case == "delta-snapshots":
        kw.update(snapshot_dir=str(tmp_path / case))
        got = _run_both(monkeypatch, tmp_path,
                        dict(snapshot_dir=str(tmp_path / "p")),
                        dict(snapshot_dir=str(tmp_path / "j")),
                        bloom_filter_capacity=5_000,
                        snapshot_every_batches=2, snapshot_mode="delta")
    else:
        got = _run_both(monkeypatch, tmp_path, {},
                        bloom_filter_capacity=5_000, **kw)
    assert got["port"][0] == got["jax"][0]
    (total, steady, fps), (total2, steady2, _) = got["port"][0]
    assert total > 0 and steady == steady2 == 0 and total2 == total
    fns = {fn for fn, _, _ in fps}
    want = {"word": {"step_words"}, "bytes": {"step_bytes"},
            "seg": {"step_seg"}, "delta": {"step_delta"},
            "temporal": {"step_words", "temporal_window_add", "cms_step"},
            "delta-snapshots": {"step_words", "snapshot_capture"}}[case]
    assert want <= fns, fns


@pytest.mark.parametrize("wire", ["word", "seg"])
def test_mesh_recompile_counts_equal_jax(monkeypatch, tmp_path, wire):
    got = _run_both(monkeypatch, tmp_path, {}, mesh=(2, 2),
                    bloom_filter_capacity=5_000, num_shards=2,
                    num_replicas=2, wire_format=wire, events=6_000,
                    frame=1_500)
    assert got["port"][0] == got["jax"][0]
    fns = {fn for fn, _, _ in got["port"][0][-1][2]}
    assert fns == {f"sharded_step_{'words' if wire == 'word' else wire}"}


def test_fused_run_profiled_end_to_end(tmp_path, monkeypatch, capsys):
    """tests/test_profiler.py's end-to-end run on the port: warm-up
    shapes, none after the first run on the same seed's frames, flight
    records with per-stage self-times, the dispatch-gap histogram, the
    busy gauges, the three artifacts and the telemetry verb's table."""
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    prof_dir = tmp_path / "profile"
    cfg = Config(profile_hz=97, profile_out=str(prof_dir),
                 flight_recorder=32)
    t = obs.enable(cfg)
    pipe = FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                         device="cpu")
    try:
        producer = pipe.client.create_producer(cfg.pulsar_topic)
        for r in range(2):
            roster, frames = generate_frames(24_576, 4096, roster_size=8_000,
                                             num_lectures=4, seed=3)
            if r == 0:
                pipe.preload(roster)
            for f in frames:
                producer.send(f)
            pipe.run(max_events=24_576 * (r + 1), idle_timeout_s=0.5)
            if r == 0:
                assert t.recompiles.total > 0 and t.recompiles.warm
        assert t.recompiles.steady == 0
        rec = t.flight.snapshot()[-1]
        for key in ("dequeue_wait", "decode", "dispatch", "device_wait"):
            assert key in rec["stages"]
        assert t.registry.histogram(
            "attendance_dispatch_gap_seconds").count > 0
        text = t.render()
        assert ('attendance_dispatch_thread_busy_fraction'
                '{component="device_dispatch"}') in text
        assert 'component="temporal"' not in text
        assert "attendance_recompiles_steady_total" in text
        assert "attendance_profile_samples_total" in text
        # The hot loop's marks reached the sampler (a run that ends on
        # max_events leaves this thread marked "dispatch").
        deadline = time.monotonic() + 10.0
        while "dispatch" not in t.profiler.attribution()["stages"]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        pipe.cleanup()
        obs.disable()
    assert not [th for th in threading.enumerate()
                if th.name == "attendance-profiler"]
    for name in (FOLDED_FILE, TRACE_FILE, ATTRIBUTION_FILE):
        assert (prof_dir / name).exists(), name
    doc = json.loads((prof_dir / ATTRIBUTION_FILE).read_text())
    assert doc["kind"] == "attribution" and doc["samples_total"] > 0
    assert doc["recompiles"]["total"] > 0
    port_main(["telemetry", str(prof_dir), "--attribution"])
    ours = capsys.readouterr().out
    assert "attribution:" in ours and "recompiles:" in ours
    jax_main(["telemetry", str(prof_dir), "--attribution"])
    assert capsys.readouterr().out == ours


def test_run_resets_dispatch_gap_cursor():
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    cfg = Config(flight_recorder=8)
    obs.enable(cfg)
    pipe = FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                         device="cpu")
    try:
        pipe._last_dispatch_t = 123.0  # a stale cursor from a past run
        pipe.run(max_events=0, idle_timeout_s=0.05)
        assert pipe._last_dispatch_t == 0.0
    finally:
        pipe.cleanup()
        obs.disable()


# -- --profile-dir on the CPU ---------------------------------------------------------

def test_profile_dir_cpu_trace_has_a_range_a_frame(tmp_path):
    """A CPU-activity torch.profiler trace of a small fused run: one
    fused_step_dispatch range a frame, the traced batches' trace-id
    ranges with --trace-out, and no device kernel event on the CPU."""
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)
    from attendance_tpu_torch.utils.profiling import (
        TRACE_FILE as TORCH_TRACE, kernel_events, range_count)

    cfg = Config(profile_dir=str(tmp_path / "pd"),
                 trace_out=str(tmp_path / "spans.json"))
    pipe = FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                         device="cpu")
    try:
        roster, frames = generate_frames(6_000, 1_000, roster_size=2_000,
                                         num_lectures=3, seed=2)
        pipe.preload(roster)
        producer = pipe.client.create_producer(cfg.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=6_000, idle_timeout_s=0.3)
    finally:
        pipe.cleanup()
        obs.disable()
    doc = json.loads((tmp_path / "pd" / TORCH_TRACE).read_text())
    names = [e.get("name") for e in doc["traceEvents"]]
    assert range_count(doc, "fused_step_dispatch") == 6
    assert sum(1 for n in names if str(n).startswith("trace:")) == 6
    assert not kernel_events(doc)


def test_profile_dir_processor_trace_names_the_sketch_calls(tmp_path):
    from attendance_tpu_torch.cli import run_pipeline
    from attendance_tpu_torch.utils.profiling import (
        TRACE_FILE as TORCH_TRACE, range_count)

    proc, report = run_pipeline(
        Config(sketch_backend="tpu", batch_size=64,
               profile_dir=str(tmp_path / "pd")), 60, 5, seed=3,
        device="cpu")
    proc.cleanup()
    doc = json.loads((tmp_path / "pd" / TORCH_TRACE).read_text())
    for name in ("bf_exists_batch", "pfadd_batch"):
        assert range_count(doc, name) > 0


def test_profile_hooks_are_nullcontexts_when_off():
    import contextlib
    from attendance_tpu_torch.utils import profiling

    assert isinstance(profiling.maybe_trace(""), contextlib.nullcontext)
    assert isinstance(profiling.maybe_annotate(False, "x"),
                      contextlib.nullcontext)
    assert isinstance(profiling.annotate_trace(True, None),
                      contextlib.nullcontext)


def test_profile_dir_on_a_card_refuses_a_cpu_only_profiler(tmp_path,
                                                          monkeypatch):
    """A card run's trace records CUDA activity or raises: a profiler
    that cannot trace the card is refused before the run starts."""
    import torch
    from attendance_tpu_torch.utils import profiling

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUDA activity"):
        with profiling.maybe_trace(str(tmp_path), torch.device("cuda", 0)):
            pass


def test_kernel_functions_name_every_global_of_the_source():
    """Every launch key maps to __global__ functions that exist in
    csrc/sketch_kernels.cu, and every __global__ function is named by a
    key (what the card's trace check counts)."""
    import re
    from attendance_tpu_torch.ops import kernels

    src = (Path(__file__).resolve().parent.parent / "attendance_tpu_torch"
           / "csrc" / "sketch_kernels.cu").read_text()
    found = set(re.findall(
        r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)", src))
    named = {n for v in kernels.KERNEL_FUNCTIONS.values() for n in v}
    assert set(kernels.KERNEL_FUNCTIONS) == set(kernels.launches)
    assert named == found


def test_kernel_launch_shortfall_reads_device_events_only():
    from attendance_tpu_torch.utils.profiling import (
        kernel_function, kernel_launch_shortfall)

    assert kernel_function(
        "void fused_step_kernel<WordDecode>(WordDecode, int)") == \
        "fused_step_kernel"
    assert kernel_function("hll_histogram_kernel(unsigned char const*)") \
        == "hll_histogram_kernel"
    # The kernels live in an anonymous namespace: demangled and mangled.
    assert kernel_function(
        "void (anonymous namespace)::fused_step_kernel<(anonymous "
        "namespace)::WordDecode>((anonymous namespace)::WordDecode, int)"
    ) == "fused_step_kernel"
    assert kernel_function(
        "_ZN12_GLOBAL__N_117fused_step_kernelINS_10WordDecodeEEEvT_iPj") \
        == "fused_step_kernel"
    assert kernel_function("_Z20hll_histogram_kernelPKhiiPi") == \
        "hll_histogram_kernel"
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel",
         "name": "void fused_step_kernel<WordDecode>(WordDecode, int)"},
        {"ph": "X", "cat": "kernel", "name": "hll_histogram_kernel(int)"},
        # A runtime-API row is not a device kernel event.
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel"},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel"}]}
    assert kernel_launch_shortfall(
        doc, {"fused_step": 1, "hll_histogram": 1, "cms_step": 0}) == {}
    assert kernel_launch_shortfall(doc, {"fused_step": 2}) == {
        "fused_step": (2, 1)}
    assert kernel_launch_shortfall(doc, {"bloom_contains": 1}) == {
        "bloom_contains": (1, 0)}


def test_kernel_launch_shortfall_groups_keys_that_share_a_function():
    """Launch keys that share a ``__global__`` function are checked as one
    group, so one kernel event cannot cover the launches of two keys:
    ``hll_histogram_rows`` launches missing from a trace that holds
    ``hll_histogram``'s are a shortfall."""
    from attendance_tpu_torch.utils.profiling import kernel_launch_shortfall

    def trace(*names):
        return {"traceEvents": [{"ph": "X", "cat": "kernel", "name": n}
                                for n in names]}

    hist = "void (anonymous namespace)::hll_histogram_kernel(int)"
    doc = trace(hist, hist)
    assert kernel_launch_shortfall(doc, {"hll_histogram": 2}) == {}
    assert kernel_launch_shortfall(
        doc, {"hll_histogram": 2, "hll_histogram_rows": 1}) == {
        "hll_histogram+hll_histogram_rows": (3, 2)}
    assert kernel_launch_shortfall(
        trace(hist, hist, hist),
        {"hll_histogram": 2, "hll_histogram_rows": 1}) == {}
    # bloom_contains_bytes also launches bloom_contains_kernel.
    probe = "bloom_contains_kernel(unsigned int const*)"
    assert kernel_launch_shortfall(
        trace(probe), {"bloom_contains": 1, "bloom_contains_bytes": 1}) == {
        "bloom_contains+bloom_contains_bytes": (2, 1)}


def test_busy_seconds_is_a_union_of_device_intervals():
    """The card's busy time counts kernels, copies and memsets once where
    they overlap, and no host or runtime-API row."""
    from attendance_tpu_torch.utils.profiling import (
        busy_seconds, device_events, kernel_events)

    doc = {"traceEvents": [
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 5.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 20.0,
         "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 21.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "fused_step_dispatch",
         "ts": 0.0, "dur": 100.0}]}
    assert len(device_events(doc)) == 4
    assert busy_seconds(device_events(doc)) == 17e-6
    assert busy_seconds(kernel_events(doc)) == 11e-6
    assert busy_seconds([]) == 0.0


@pytest.mark.parametrize("events,raises", [(1, False), (0, True)])
def test_card_trace_holds_its_launches(tmp_path, monkeypatch, events,
                                       raises):
    """A card trace's JSON carries the kernel launches made inside it
    (``LAUNCHES_KEY``), and a trace of a run that launched kernels yet
    holds no device kernel event raises. The profiler is a stand-in that
    exports a fixed document, so this runs without a card."""
    import torch
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.utils import profiling

    class Profile:
        def __init__(self, activities):
            assert torch.profiler.ProfilerActivity.CUDA in activities

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps({"traceEvents": [
                {"ph": "X", "cat": "kernel", "name": "fused_step_kernel"}
            ] * events}))

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU,
                                 torch.profiler.ProfilerActivity.CUDA})
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setitem(kernels.launches, "fused_step",
                        kernels.launches["fused_step"])

    def run():
        with profiling.maybe_trace(str(tmp_path), torch.device("cuda", 0)):
            kernels.launches["fused_step"] += 1

    if raises:
        with pytest.raises(RuntimeError, match="no CUDA kernel event"):
            run()
        return
    run()
    doc = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    launched = profiling.trace_launches(doc)
    assert launched["fused_step"] == 1
    assert sum(launched.values()) == 1
    assert profiling.kernel_launch_shortfall(doc, launched) == {}
