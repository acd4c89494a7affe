"""Synthetic RFID-swipe load generator (the reference generator's mix).

Counterpart of ``attendance_tpu/pipeline/generator.py`` (without its
tracing span). The reference generator's behavior: unique valid student
IDs in [10000, 99999] preloaded into the Bloom filter, invalid IDs in
[100000, 999999]; per student an 80% punctuality draw (punctual entry
hour 8-9, late 9-11), 3-7 attendance days sampled from the past week, an
entry and an exit event per attended day (exit 3-4 h later), a 15%
chance of an invalid attempt per day, and 20 standalone invalid attempts
at the end. Every event carries the generator's ground-truth
``is_valid`` flag, which the processor ignores and recomputes: the end
to end oracle. Seeded by ``random.Random(seed)``, so for one seed and one
``now`` both packages emit the same events.

Differences from the reference: no per-record sleep by default
(``throttle_s`` restores it), a seedable RNG, one batched Bloom preload
call, and a population that scales past the reference's 1000/50.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import List, Optional, Set

from attendance_tpu_torch.pipeline.events import AttendanceEvent, encode_event

logger = logging.getLogger(__name__)


@dataclass
class GeneratorReport:
    """What was generated — the ground truth the tests assert against."""
    valid_student_ids: Set[int] = field(default_factory=set)
    invalid_student_ids: Set[int] = field(default_factory=set)
    message_count: int = 0
    invalid_attempts: int = 0
    events: List[AttendanceEvent] = field(default_factory=list)


def _sample_unique_ids(rng: random.Random, lo: int, hi: int,
                       n: int) -> Set[int]:
    """n distinct ints in [lo, hi] (the faker.unique.random_int contract,
    reference data_generator.py:53-54,80-81)."""
    if hi - lo + 1 < n:
        raise ValueError("population smaller than requested sample")
    return set(rng.sample(range(lo, hi + 1), n))


def generate_student_data(
        producer=None,
        sketch_store=None,
        bloom_key: str = "bf:students",
        num_students: int = 1000,
        num_invalid: int = 50,
        standalone_invalid: int = 20,
        now: Optional[datetime] = None,
        seed: Optional[int] = None,
        throttle_s: float = 0.0,
        keep_events: bool = True,
        disorder_frac: float = 0.0,
        late_max_s: float = 0.0) -> GeneratorReport:
    """Generate the reference's event mix; returns the ground-truth report.

    producer: transport producer with .send(bytes) (None = don't publish).
    sketch_store: SketchStore for the Bloom preload (None = skip preload).
    disorder_frac/late_max_s: with a nonzero fraction, events are
    EMITTED in event-time order except that a ``disorder_frac`` sample
    has its arrival delayed by up to ``late_max_s`` of event time —
    out-of-order/late swipes, deterministic per ``seed`` (the
    timestamps themselves are untouched). The default (0) keeps the
    reference's per-student emission order.
    """
    rng = random.Random(seed)
    now = now or datetime.now()
    report = GeneratorReport()
    # With tracing on: one "generate" root span over the whole run; each
    # message's own trace roots at its producer's publish span (the
    # producers inject the traceparent property).
    from attendance_tpu_torch import obs
    _t = obs.get()
    tracer = _t.tracer if _t is not None else None
    gen_span = (tracer.start_span(
        "generate", role="generator",
        args={"num_students": num_students}) if tracer is not None
        else None)
    logger.info("Generating valid student IDs...")
    report.valid_student_ids = _sample_unique_ids(
        rng, 10_000, 99_999, num_students)
    report.invalid_student_ids = _sample_unique_ids(
        rng, 100_000, 999_999, num_invalid)
    invalid_list = sorted(report.invalid_student_ids)

    if sketch_store is not None:
        # One batched preload call (vs the reference's per-ID BF.ADD loop).
        sketch_store.bf_add_many(bloom_key, sorted(report.valid_student_ids))
        logger.info("Added %d valid student IDs to Bloom Filter",
                    len(report.valid_student_ids))

    past_week = [now - timedelta(days=i) for i in range(7)]
    staged: list = [] if disorder_frac > 0 else None

    def deliver(event: AttendanceEvent) -> None:
        if producer is not None:
            producer.send(encode_event(event))
        if keep_events:
            report.events.append(event)
        report.message_count += 1
        if not event.is_valid:
            report.invalid_attempts += 1
        if report.message_count % 100 == 0:
            logger.info("Generated %d attendance records (%d invalid "
                        "attempts)", report.message_count,
                        report.invalid_attempts)
        if throttle_s:
            import time
            time.sleep(throttle_s)

    def emit(event: AttendanceEvent) -> None:
        if staged is None:
            deliver(event)
        else:
            staged.append(event)

    def lecture_of(ts: datetime) -> str:
        return f"LECTURE_{ts.strftime('%Y%m%d')}"

    for student_id in sorted(report.valid_student_ids):
        is_punctual = rng.random() > 0.2
        attendance_days = rng.sample(past_week, rng.randint(3, 7))
        for day in attendance_days:
            entry_hour = (rng.randint(8, 9) if is_punctual
                          else rng.randint(9, 11))
            entry_time = day.replace(hour=entry_hour,
                                     minute=rng.randint(0, 59),
                                     second=0, microsecond=0)
            exit_time = entry_time + timedelta(hours=rng.randint(3, 4),
                                               minutes=rng.randint(0, 59))
            emit(AttendanceEvent(student_id, entry_time.isoformat(),
                                 lecture_of(entry_time), True, "entry"))
            emit(AttendanceEvent(student_id, exit_time.isoformat(),
                                 lecture_of(exit_time), True, "exit"))
            if rng.random() < 0.15:
                invalid_id = rng.choice(invalid_list)
                emit(AttendanceEvent(invalid_id, entry_time.isoformat(),
                                     lecture_of(entry_time), False, "entry"))

    for _ in range(standalone_invalid):
        invalid_id = rng.choice(invalid_list)
        day = rng.choice(past_week)
        ts = day.replace(hour=rng.randint(8, 17), minute=rng.randint(0, 59),
                         second=0, microsecond=0)
        emit(AttendanceEvent(invalid_id, ts.isoformat(), lecture_of(ts),
                             False, "entry"))

    if staged is not None:
        # Disordered emission: events flow in event-time order except
        # that a sampled fraction arrives up to late_max_s of event
        # time later (arrival key = timestamp + sampled delay;
        # timestamps themselves untouched). Deterministic: the delay
        # draws ride the same seeded rng, in staged order.
        delays = [
            timedelta(seconds=rng.uniform(0, late_max_s))
            if rng.random() < disorder_frac else timedelta(0)
            for _ in staged]
        arrival = [
            (datetime.fromisoformat(e.timestamp) + d, i)
            for i, (e, d) in enumerate(zip(staged, delays))]
        for _, i in sorted(arrival):
            deliver(staged[i])

    logger.info("Total messages sent: %d (%d invalid attempts)",
                report.message_count, report.invalid_attempts)
    if gen_span is not None:
        tracer.end_span(gen_span, messages=report.message_count)
    return report
