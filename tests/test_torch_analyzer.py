"""The rest of the port's ``fused`` verb against the JAX package, on the
CPU: the analyzer's five insights and their console text, the metrics
summary line, the store reads behind ``get_attendance_stats``, the verb's
printout (insights and one ``LECTURE_`` line per day) and the ``analyze``
verb over a snapshot directory. Everything compared is exact.
"""

import logging

import numpy as np
import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.cli import main as jax_main
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.pipeline import analyzer as janalyzer
from attendance_tpu.pipeline.events import decode_planar_batch
from attendance_tpu.pipeline.fast_path import FusedPipeline as JaxPipeline
from attendance_tpu.pipeline.loadgen import generate_frames as jax_frames
from attendance_tpu.pipeline.processor import ProcessorMetrics
from attendance_tpu.storage.columnar_store import (
    ColumnarEventStore as JaxStore)
from attendance_tpu.transport.memory_broker import (
    MemoryBroker as JaxBroker, MemoryClient as JaxClient)
from attendance_tpu_torch.cli import main as cli_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.analyzer import (
    AttendanceAnalyzer, format_insights)
from attendance_tpu_torch.pipeline.fast_path import (
    FusedMetrics, FusedPipeline)
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.storage.columnar_store import ColumnarEventStore
from attendance_tpu_torch.transport.memory_broker import MemoryBroker
from torch_port_fixtures import fresh_shared_broker  # noqa: F401


@pytest.mark.parametrize("kwargs", [
    dict(num_events=30_000, roster_size=3_000, num_lectures=5, seed=3),
    dict(num_events=6_000, roster_size=200, num_lectures=1, seed=9,
         invalid_fraction=0.4)])
def test_insights_equal_jax(kwargs):
    n = kwargs.pop("num_events")
    _, frames = generate_frames(n, 4096, **kwargs)
    ours, theirs = ColumnarEventStore(), JaxStore()
    for f in frames:
        cols = decode_planar_batch(f)
        ours.insert_columns(cols)
        theirs.insert_columns(cols)
    got = AttendanceAnalyzer(ours).generate_insights()
    want = janalyzer.AttendanceAnalyzer(theirs).generate_insights()
    assert got == want and len(got) == 5
    assert format_insights(got) == janalyzer.format_insights(want)


def test_insights_of_an_empty_store():
    assert AttendanceAnalyzer(ColumnarEventStore()).generate_insights() == []
    assert format_insights([]) == janalyzer.format_insights([])


@pytest.mark.parametrize("fields,kw", [
    (dict(), dict()),
    (dict(events=20_000, batches=5, wall_seconds=0.25, device_seconds=0.125,
          valid_events=17_967, invalid_events=2_033,
          wire_dwell={"word": 4, "seg": 1}),
     dict(estimated_fpr=0.0093, include_validity=True,
          fpr_is_lower_bound=True)),
    (dict(events=8192, batches=2, wall_seconds=1.5),
     dict(estimated_fpr=None, include_validity=False))])
def test_metrics_summary_text_equals_jax(fields, kw):
    ours = FusedMetrics(**fields)
    theirs = ProcessorMetrics(**fields)
    theirs.batch_sizes = ([fields["events"] // fields["batches"]]
                          * fields["batches"] if fields else [])
    assert ours.summary(**kw) == theirs.summary(**kw)


def test_get_attendance_stats_equals_jax(monkeypatch):
    monkeypatch.setenv("ATP_NATIVE", "0")
    jobs.disable()
    jpipe = JaxPipeline(JaxConfig(bloom_filter_capacity=4000,
                                  transport_backend="memory"),
                        client=JaxClient(JaxBroker()), num_banks=8)
    tpipe = FusedPipeline(Config(bloom_filter_capacity=4000), num_banks=8,
                          device="cpu")
    try:
        for pipe, gen in ((jpipe, jax_frames), (tpipe, generate_frames)):
            roster, frames = gen(12_000, 4096, roster_size=3000,
                                 num_lectures=4, seed=13)
            pipe.preload(roster)
            producer = pipe.client.create_producer(pipe.config.pulsar_topic)
            for f in frames:
                producer.send(f)
            pipe.run(max_events=12_000, idle_timeout_s=0.3)
        for day in tpipe.lecture_days() + ["LECTURE_20260702", 19990101]:
            ours = tpipe.get_attendance_stats(day)
            theirs = jpipe.get_attendance_stats(day)
            assert ours["unique_attendees"] == theirs["unique_attendees"]
            assert ours["num_records"] == theirs["num_records"]
            for name in ("student_id", "lecture_day", "micros", "is_valid"):
                np.testing.assert_array_equal(
                    ours["attendance_records"][name],
                    np.asarray(theirs["attendance_records"][name]))
        assert tpipe.get_attendance_stats(
            tpipe.lecture_days()[0])["num_records"] > 0
    finally:
        jpipe.cleanup()
        tpipe.cleanup()


def _split_port_output(out: str):
    """(insights text, LECTURE_ lines) of the port verb's stdout, whose
    last line is the JSON summary."""
    lines = out.rstrip("\n").split("\n")[:-1]
    lectures = [ln for ln in lines if ln.startswith("LECTURE_")]
    return "\n".join(lines[:len(lines) - len(lectures)]), lectures


@pytest.mark.parametrize("snapshot", [False, True])
def test_fused_verb_prints_what_jax_cmd_fused_does(snapshot, tmp_path,
                                                   capsys, caplog):
    args = ["fused", "--num-events", "20000", "--frame-size", "4096",
            "--num-lectures", "3", "--bloom-capacity", "20000"]
    if snapshot:
        args += ["--snapshot-every-batches", "2"]
    jobs.disable()
    # Both verbs subscribe to the process-wide broker, which keeps a
    # topic's messages for late subscribers: start from empty ones.
    JaxBroker.reset_shared()
    MemoryBroker.reset_shared()
    with caplog.at_level(logging.INFO):
        jax_main(args + (["--snapshot-dir", str(tmp_path / "jax")]
                         if snapshot else []))
    jax_out = capsys.readouterr().out
    jax_lectures = [r.getMessage() for r in caplog.records
                    if r.getMessage().startswith("LECTURE_")]
    jax_summary = [r.getMessage() for r in caplog.records
                   if r.getMessage().startswith("Fused: ")]
    caplog.clear()
    with caplog.at_level(logging.INFO):
        cli_main(args + ["--device", "cpu"] + (
            ["--snapshot-dir", str(tmp_path / "port")] if snapshot else []))
    insights, lectures = _split_port_output(capsys.readouterr().out)
    summary = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("Fused: ")]
    assert insights == jax_out.rstrip("\n")
    assert "=== Habitual Latecomers ===" in insights
    assert lectures == jax_lectures and len(lectures) == 3
    # Same counts and FPR; the rates and times differ.
    assert len(summary) == len(jax_summary) == 1
    assert summary[0].split("(")[0] == jax_summary[0].split("(")[0]
    assert summary[0].split("est. bloom FPR")[1] == \
        jax_summary[0].split("est. bloom FPR")[1]
    jobs.disable()


def test_analyze_events_file_equals_jax(tmp_path, capsys):
    snap = tmp_path / "snaps"
    cli_main(["fused", "--device", "cpu", "--num-events", "12000",
              "--frame-size", "4096", "--num-lectures", "2",
              "--snapshot-dir", str(snap), "--snapshot-every-batches", "1"])
    capsys.readouterr()
    for where in (snap, snap / "fused_events_segs",
                  snap / "fused_events.npz"):
        cli_main(["analyze", "--events-file", str(where)])
        ours = capsys.readouterr().out
        jobs.disable()
        jax_main(["analyze", "--events-file", str(where)])
        assert ours == capsys.readouterr().out
        assert "=== Most Consistent Attendees ===" in ours
    # A one-shot save of the same rows gives the same insights.
    store = ColumnarEventStore()
    store.load_segments(snap / "fused_events_segs")
    store.save(tmp_path / "events.npz")
    cli_main(["analyze", "--events-file", str(tmp_path / "events.npz")])
    assert capsys.readouterr().out == ours
    with pytest.raises(FileNotFoundError):
        cli_main(["analyze", "--events-file", str(tmp_path)])
