"""The port's processor path against the JAX package's, on the CPU.

The generator, seeded and given one fixed ``now``, emits the same events
in both packages; each package's AttendanceProcessor drains them from
its own memory broker into its own sketch and event stores (the port's
card store on ``device="cpu"``, every kernel's plain version). Metrics,
stored rows, PFCOUNTs, filter bytes, registers and bank maps are equal
(tolerance 0); ``estimated_fpr`` agrees to 1e-6 relative (float32 fill
in JAX). Snapshot chains restore across the packages both ways, and the
``pipeline``, ``stats`` and ``parity`` verbs print the same lines.
"""

import logging
import re
from datetime import datetime

import numpy as np
import pytest
import torch

from attendance_tpu import obs as jobs
from attendance_tpu.cli import main as jax_main
from attendance_tpu.config import Config as JConfig
from attendance_tpu.pipeline.events import (
    AttendanceEvent as JEvent, encode_event as jencode)
from attendance_tpu.pipeline.generator import (
    generate_student_data as jgenerate)
from attendance_tpu.pipeline.processor import (
    AttendanceProcessor as JProcessor)
from attendance_tpu.storage.memory_store import MemoryEventStore as JRows
from attendance_tpu.transport.memory_broker import (
    MemoryBroker as JBroker, MemoryClient as JClient)
from attendance_tpu_torch.cli import main as cli_main
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.events import (
    AttendanceEvent, decode_event, encode_event)
from attendance_tpu_torch.pipeline.generator import generate_student_data
from attendance_tpu_torch.pipeline.processor import AttendanceProcessor
from attendance_tpu_torch.storage.memory_store import (
    AttendanceRow, MemoryEventStore)
from attendance_tpu_torch.transport import collect_batch
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient, ReceiveTimeout)

NOW = datetime(2026, 3, 4, 12, 0, 0)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_sketch(j, t) -> None:
    assert j._blooms.keys() == t._blooms.keys()
    for key in j._blooms:
        cj, ct = j._blooms[key], t._blooms[key]
        assert cj.counts == ct.counts
        assert [tuple(p) for p in cj.params] == [tuple(p) for p in ct.params]
        for a, b in zip(cj.filters, ct.filters):
            np.testing.assert_array_equal(_host(a), _host(b))
    if hasattr(j, "_hll"):
        assert j._hll._bank_of == t._hll._bank_of
        np.testing.assert_array_equal(_host(j._hll.regs), _host(t._hll.regs))
    else:
        assert j._hll_regs.keys() == t._hll_regs.keys()
        for key in j._hll_regs:
            np.testing.assert_array_equal(j._hll_regs[key], t._hll_regs[key])


def _rows(store):
    """Stored rows as comparable tuples, in scan order."""
    if hasattr(store, "to_columns"):
        cols = store.to_columns()
        return list(zip(*(np.asarray(cols[c]).tolist() for c in (
            "student_id", "lecture_day", "micros", "is_valid",
            "event_type"))))
    return [(r.student_id, r.timestamp, r.lecture_id, r.is_valid,
             r.event_type) for r in store.scan_all()]


def _metrics(m):
    return (m.batches, m.events, m.valid_events, m.invalid_events,
            m.nacked_batches, m.dead_lettered, m.batch_sizes)


@pytest.mark.parametrize("disorder", [0.0, 0.3])
def test_generator_events_equal_jax(disorder):
    kw = dict(num_students=120, num_invalid=12, seed=5, now=NOW,
              disorder_frac=disorder, late_max_s=30.0)
    j = jgenerate(**kw)
    t = generate_student_data(**kw)
    assert [e.to_dict() for e in t.events] == [e.to_dict() for e in j.events]
    assert t.valid_student_ids == j.valid_student_ids
    assert t.invalid_student_ids == j.invalid_student_ids
    assert (t.message_count, t.invalid_attempts) == (
        j.message_count, j.invalid_attempts)
    assert all(encode_event(a) == jencode(b)
               for a, b in zip(t.events, j.events))
    assert decode_event(encode_event(t.events[0])) == t.events[0]


def _run_both(tmp_path=None, num_students=150, jax_kw=None, port_kw=None,
              **kw):
    """Generate and process the same stream in both packages."""
    jcfg = JConfig(batch_size=128, batch_timeout_s=0.01,
                   hll_initial_banks=2, **kw, **(jax_kw or {}))
    tcfg = Config(batch_size=128, batch_timeout_s=0.01, hll_initial_banks=2,
                  **kw, **(port_kw or {}))
    out = []
    for proc_cls, gen, client in (
            (JProcessor, jgenerate, JClient(JBroker())),
            (AttendanceProcessor, generate_student_data,
             MemoryClient(MemoryBroker()))):
        extra = {} if proc_cls is JProcessor else {"device": "cpu"}
        cfg = jcfg if proc_cls is JProcessor else tcfg
        proc = proc_cls(cfg, client=client, **extra)
        proc.setup_bloom_filter()
        report = gen(producer=client.create_producer(cfg.pulsar_topic),
                     sketch_store=proc.sketch, num_students=num_students,
                     num_invalid=15, seed=9, now=NOW, keep_events=True)
        proc.process_attendance(max_events=report.message_count,
                                idle_timeout_s=0.2)
        out.append((proc, report))
    return out


@pytest.mark.parametrize("sketch,storage,layout", [
    ("tpu", "memory", "flat"), ("tpu", "columnar", "blocked"),
    ("memory", "memory", "flat"), ("memory", "columnar", "blocked")])
def test_processor_equals_jax(sketch, storage, layout, tmp_path):
    (jp, jrep), (tp, trep) = _run_both(
        sketch_backend=sketch, storage_backend=storage, bloom_layout=layout,
        bloom_filter_capacity=400, invalid_topic="attendance-invalid",
        jax_kw=dict(metrics_json=str(tmp_path / "j.jsonl")),
        port_kw=dict(metrics_json=str(tmp_path / "t.jsonl")))
    try:
        assert _metrics(tp.metrics) == _metrics(jp.metrics)
        assert tp.metrics.events == trep.message_count == jrep.message_count
        assert tp.metrics.batches > 1
        assert _rows(tp.store) == _rows(jp.store)
        assert (tp.store.distinct_lecture_ids()
                == jp.store.distinct_lecture_ids())
        for lid in tp.store.distinct_lecture_ids():
            ts, js = (tp.get_attendance_stats(lid),
                      jp.get_attendance_stats(lid))
            assert ts["unique_attendees"] == js["unique_attendees"] > 0
        _same_sketch(jp.sketch, tp.sketch)
        assert tp.estimated_fpr() == pytest.approx(jp.estimated_fpr(),
                                                   rel=1e-6)
        assert tp.estimated_fpr() > 0
        # No false negatives against the generator's ground truth.
        valid_ids = trep.valid_student_ids
        rows = _rows(tp.store)
        assert all(r[3] for r in rows if r[0] in valid_ids)
        # The invalid side topic carries the computed-invalid events.
        side = tp.client.subscribe("attendance-invalid", "audit")
        got = collect_batch(side, 10 ** 6, 0.05)
        assert len(got) == tp.metrics.invalid_events
        jline = (tmp_path / "j.jsonl").read_text().strip()
        tline = (tmp_path / "t.jsonl").read_text().strip()
        drop = re.compile(r'"(events_per_second|device_seconds|'
                          r'wall_seconds|estimated_fpr)": [^,]+,')
        assert drop.sub("", tline) == drop.sub("", jline)
    finally:
        jp.cleanup()
        tp.cleanup()


def test_malformed_frame_is_dead_lettered_in_both():
    results = []
    for proc_cls, client, event, rows in (
            (JProcessor, JClient(JBroker()), JEvent, JRows),
            (AttendanceProcessor, MemoryClient(MemoryBroker()),
             AttendanceEvent, MemoryEventStore)):
        cfg = (JConfig if proc_cls is JProcessor else Config)(
            sketch_backend="memory", batch_size=4, batch_timeout_s=0.01,
            max_redeliveries=2)
        proc = proc_cls(cfg, client=client, event_store=rows())
        proc.setup_bloom_filter()
        proc.sketch.bf_add_many(cfg.bloom_filter_key, [111, 222])
        producer = client.create_producer(cfg.pulsar_topic)
        enc = jencode if proc_cls is JProcessor else encode_event
        for sid in (111, 222, 333):
            producer.send(enc(event(sid, "2026-07-27T08:00:00",
                                    "LECTURE_20260727", True, "entry")))
        producer.send(b"not json at all")
        proc.process_attendance(idle_timeout_s=0.3)
        m = proc.metrics
        results.append((m.dead_lettered, m.events, m.valid_events,
                        m.invalid_events, proc.store.count(),
                        proc.consumer.backlog()))
    assert results[0] == results[1] == (1, 3, 2, 1, 3, 0)


def test_batch_failure_is_nacked_and_replayed():
    """A failing batch is nacked whole and redelivered; the replay lands
    each event once (idempotent sinks)."""
    cfg = Config(sketch_backend="memory", batch_size=8, batch_timeout_s=0.01)
    client = MemoryClient(MemoryBroker())
    proc = AttendanceProcessor(cfg, client=client)
    proc.setup_bloom_filter()
    proc.sketch.bf_add_many(cfg.bloom_filter_key, [7, 8])
    producer = client.create_producer(cfg.pulsar_topic)
    for sid in (7, 8, 9):
        producer.send(encode_event(AttendanceEvent(
            sid, "2026-07-27T08:00:00", "LECTURE_20260727", True, "entry")))
    real = proc.store.insert_batch
    fails = [1]

    def flaky(rows):
        if fails[0]:
            fails[0] -= 1
            raise OSError("store down")
        return real(rows)

    proc.store.insert_batch = flaky
    proc.process_attendance(idle_timeout_s=0.3)
    assert proc.metrics.nacked_batches == 1
    assert proc.store.count() == 3 and proc.consumer.backlog() == 0
    assert proc.sketch.pfcount(f"{cfg.hll_key_prefix}LECTURE_20260727") == 2


def test_broker_redelivery_and_retention():
    broker = MemoryBroker()
    client = MemoryClient(broker)
    producer = client.create_producer("t")
    for i in range(3):
        producer.send(bytes([i]), properties={"i": str(i)})
    # A subscription made after the publishes starts at the retained
    # messages.
    c = client.subscribe("t", "s")
    msgs = c.receive_many(10, timeout_millis=10)
    assert [m.data() for m in msgs] == [b"\x00", b"\x01", b"\x02"]
    assert msgs[1].properties() == {"i": "1"}
    assert all(m.redelivery_count == 0 for m in msgs)
    c.negative_acknowledge(msgs[0])
    c.acknowledge_many(msgs[1:])
    again = c.receive(timeout_millis=10)
    assert again.data() == b"\x00" and again.redelivery_count == 1
    c.close()  # unacked -> back to the head, count bumped
    c2 = client.subscribe("t", "s")
    last = c2.receive(timeout_millis=10)
    assert last.redelivery_count == 2 and c2.backlog() == 1
    with pytest.raises(ReceiveTimeout):
        c2.receive(timeout_millis=5)
    assert MemoryBroker.shared() is MemoryBroker.shared()
    first = MemoryBroker.shared()
    MemoryBroker.reset_shared()
    assert MemoryBroker.shared() is not first


@pytest.mark.parametrize("mode", ["delta", "barrier"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_processor_snapshots_restore_across_packages(tmp_path, mode,
                                                     direction):
    """One package's processor checkpoints (a barrier every batch, a
    compaction every 3 deltas); a fresh processor of the other package
    restores the directory equal to the finished one: sub-filter bytes,
    registers, bank map and stored rows."""
    writer_is_jax = direction == "jax_to_port"
    kw = dict(snapshot_dir=str(tmp_path / "snap"), snapshot_every_batches=1,
              snapshot_mode=mode, snapshot_compact_every=3)
    (jp, _), (tp, _) = _run_both(
        sketch_backend="tpu", storage_backend="memory",
        bloom_filter_capacity=400,
        jax_kw=kw if writer_is_jax else {},
        port_kw={} if writer_is_jax else kw)
    writer = jp if writer_is_jax else tp
    try:
        assert writer.metrics.batches >= 4
        chain = tmp_path / "snap" / "processor_sketch_chain"
        assert (chain / "MANIFEST.json").exists() == (mode == "delta")
        if writer_is_jax:
            back = AttendanceProcessor(
                Config(hll_initial_banks=2, **kw), device="cpu",
                client=MemoryClient(MemoryBroker()))
        else:
            jobs.disable()
            back = JProcessor(JConfig(hll_initial_banks=2, **kw),
                              client=JClient(JBroker()))
        _same_sketch(writer.sketch, back.sketch)
        _same_sketch(jp.sketch, tp.sketch)
        assert _rows(back.store) == _rows(writer.store)
        lid = writer.store.distinct_lecture_ids()[0]
        assert (back.get_attendance_stats(lid)["unique_attendees"]
                == writer.get_attendance_stats(lid)["unique_attendees"])
        back.cleanup()
    finally:
        jp.cleanup()
        tp.cleanup()


def _log_lines(caplog, pattern: str):
    return [r.getMessage() for r in caplog.records
            if re.match(pattern, r.getMessage())]


def test_pipeline_verb_prints_what_jax_prints(capsys, caplog):
    args = ["pipeline", "--num-students", "200", "--seed", "4",
            "--batch-size", "256"]
    jobs.disable()
    JBroker.reset_shared()
    MemoryBroker.reset_shared()
    try:
        with caplog.at_level(logging.INFO):
            jax_main(args)
        jax_out = capsys.readouterr().out
        jax_lines = _log_lines(caplog, r"LECTURE_\d+: \d+ unique")
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cli_main(args + ["--device", "cpu"])
        out = capsys.readouterr().out
    finally:
        # The verbs leave their events on the process-wide brokers.
        JBroker.reset_shared()
        MemoryBroker.reset_shared()
    lines = _log_lines(caplog, r"LECTURE_\d+: \d+ unique")
    assert out == jax_out and "=== Lecture Attendance Rankings ===" in out
    assert lines == jax_lines and len(lines) == 7


def test_stats_verb_prints_what_jax_prints(tmp_path, capsys):
    store = MemoryEventStore()
    rep = generate_student_data(num_students=60, num_invalid=5, seed=2,
                                now=NOW)
    store.insert_batch([AttendanceRow(e.student_id, e.timestamp,
                                      e.lecture_id, e.is_valid, e.event_type)
                        for e in rep.events])
    store.save(tmp_path / "rows.jsonl")
    lid = store.distinct_lecture_ids()[0]
    sid = str(rep.events[0].student_id)
    for args in (["stats", lid], ["stats", "--student-id", sid],
                 ["stats", lid, "--storage-backend", "columnar"]):
        args = args + ["--events-file", str(tmp_path / "rows.jsonl"),
                       "--sketch-backend", "memory"]
        jobs.disable()
        jax_main(args)
        want = capsys.readouterr().out
        cli_main(args)
        assert capsys.readouterr().out == want and want.strip()
    with pytest.raises(SystemExit) as e:
        cli_main(["stats", "--sketch-backend", "memory"])
    assert e.value.code == 2
    cli_main(["analyze", "--events-file", str(tmp_path / "rows.jsonl")])
    ours = capsys.readouterr().out
    jax_main(["analyze", "--events-file", str(tmp_path / "rows.jsonl")])
    assert capsys.readouterr().out == ours
    assert "=== Invalid Attendance Attempts ===" in ours


def test_parity_verbs_print_what_jax_prints(capsys):
    args = ["parity", "--oracle", "sim", "--num-events", "6000",
            "--roster-size", "1500", "--num-lectures", "3"]
    jobs.disable()
    jax_main(args)
    want = capsys.readouterr().out
    cli_main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out == want and "PARITY OK" in out
    for main, extra in ((jax_main, []), (cli_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["parity", "--oracle", "redis", "--redis-port", "1"]
                 + extra)
        assert e.value.code == 2


def test_generate_then_process_verbs_share_the_process_broker(caplog):
    MemoryBroker.reset_shared()
    try:
        cli_main(["generate", "--sketch-backend", "memory",
                  "--num-students", "40", "--seed", "1"])
        with caplog.at_level(logging.INFO):
            cli_main(["process", "--sketch-backend", "memory",
                      "--idle-timeout-s", "0.2", "--batch-size", "64"])
        done = _log_lines(caplog, r"Processed \d+ events")
        assert done and not done[0].startswith("Processed 0 ")
    finally:
        MemoryBroker.reset_shared()


@pytest.mark.parametrize("verbs", ["pipeline", "generate+process"])
def test_bloom_filter_key_flag_equals_jax(monkeypatch, verbs):
    """``--bloom-filter-key roster:x`` on the generic-store verbs: the
    port's run equals JAX's in stats and stored rows, its processor's
    filter is the named key (not the default), and in ``pipeline`` the
    named key holds the generated roster."""
    import attendance_tpu.pipeline.generator as jgen_mod
    import attendance_tpu.pipeline.processor as jproc_mod
    import attendance_tpu_torch.cli as tcli
    import attendance_tpu_torch.pipeline.generator as gen_mod
    import attendance_tpu_torch.pipeline.processor as proc_mod

    class FixedNow(datetime):
        @classmethod
        def now(cls, tz=None):
            return NOW

    reports, seen = {}, {}
    for name, gmod, pmod in (("jax", jgen_mod, jproc_mod),
                             ("port", gen_mod, proc_mod)):
        monkeypatch.setattr(gmod, "datetime", FixedNow)

        def generate(*a, _real=gmod.generate_student_data, _name=name,
                     **kw):
            reports[_name] = _real(*a, **kw)
            return reports[_name]

        def cleanup(self, _real=pmod.AttendanceProcessor.cleanup,
                    _name=name):
            roster = np.asarray(sorted(reports[_name].valid_student_ids),
                                np.uint32)
            seen[_name] = (_rows(self.store), _metrics(self.metrics),
                           sorted(self.sketch._blooms),
                           bool(self.sketch.bf_exists_many(
                               "roster:x", roster).all()))
            _real(self)

        monkeypatch.setattr(gmod, "generate_student_data", generate)
        monkeypatch.setattr(pmod.AttendanceProcessor, "cleanup", cleanup)
    # The port's CLI holds the generator by name.
    monkeypatch.setattr(tcli, "generate_student_data",
                        gen_mod.generate_student_data)
    common = ["--sketch-backend", "memory", "--bloom-filter-key",
              "roster:x", "--batch-size", "64"]
    jobs.disable()
    for main, extra, broker in ((jax_main, [], JBroker),
                                (cli_main, ["--device", "cpu"],
                                 MemoryBroker)):
        broker.reset_shared()
        try:
            if verbs == "pipeline":
                main(["pipeline", "--num-students", "60", "--seed", "3"]
                     + common + extra)
            else:
                main(["generate", "--num-students", "60", "--seed", "3"]
                     + common + extra)
                main(["process", "--idle-timeout-s", "0.3"] + common
                     + extra)
        finally:
            broker.reset_shared()
    assert seen["port"] == seen["jax"]
    rows, metrics, keys, holds_roster = seen["port"]
    assert rows and metrics[1] == len(rows)
    assert keys == ["roster:x"]
    # The generate verb preloads its own store, which a separate process
    # verb does not share; in pipeline the processor's store is that store.
    assert holds_roster == (verbs == "pipeline")


def test_bloom_filter_key_only_on_verbs_that_read_it():
    from attendance_tpu_torch.cli import build_parser

    parser = build_parser()
    for verb in ("generate", "process", "pipeline"):
        args = parser.parse_args([verb, "--bloom-filter-key", "roster:x"])
        assert args.bloom_filter_key == "roster:x"
    for verb in ("analyze", "stats", "parity", "fused"):
        with pytest.raises(SystemExit):
            parser.parse_args([verb, "--bloom-filter-key", "roster:x"])
