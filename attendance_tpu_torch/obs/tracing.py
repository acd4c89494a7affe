"""Distributed span tracing: per-batch causality on top of the
aggregate metrics.

Counterpart of ``attendance_tpu/obs/tracing.py``: the same context wire
format and the same export, so a trace from either package reads in the
other's ``telemetry`` verb and a context from either parses in the other.

The metrics registry answers "how much" (dequeue_wait p99 is high);
this module answers "where did THIS batch spend its time" across the
generator -> broker -> processor -> card boundary — Dapper-style
spans (Sigelman et al., 2010) with a compact trace context carried in
broker message properties, flushed as Chrome-trace/Perfetto JSON.

Discipline (same as ``obs/__init__``):
instrumented call sites capture the tracer ONCE at construction and
pay exactly one ``is not None`` branch per event when tracing is off.
The hot-path record cost when ON is one Span allocation and one
list-append under a mutex; the buffer is BOUNDED — when full, new
spans are dropped and counted (``dropped``), never reallocated, so a
multi-hour run cannot OOM the process through its own telemetry.

Wire format of the propagated context (message property
``traceparent``): ``"<trace_id 16hex>-<span_id 16hex>-<seq>"`` —
trace_id names the end-to-end trace (one per published batch),
span_id the publishing span new work should parent under, seq the
publisher's batch sequence number. Unparseable values degrade to
"start a fresh trace", never to an error: a traced consumer must
interoperate with an untraced producer and vice versa.

Export is the Chrome trace-event JSON both Perfetto and
``chrome://tracing`` load: one synthetic ``pid`` per process ROLE
(generator/bridge/fused-pipeline/processor may share one OS process in
hermetic runs and must still separate into lanes), one ``tid`` per
worker thread, complete-events (``ph: "X"``) with trace/span/parent
ids in ``args`` so slices group under one trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

DEFAULT_SPAN_LIMIT = 1 << 16  # ~64k completed spans (~15MB exported)

# The single message-property key the trace context travels under.
TRACEPARENT = "traceparent"


class SpanContext(NamedTuple):
    """The compact cross-hop context: everything a downstream hop needs
    to continue the trace (identity + parent link + batch seq)."""
    trace_id: int
    span_id: int
    seq: int


def format_ctx(ctx: SpanContext) -> str:
    return f"{ctx.trace_id:016x}-{ctx.span_id:016x}-{ctx.seq}"


def parse_ctx(value) -> Optional[SpanContext]:
    """Parse a ``traceparent`` property; None on anything malformed
    (an untraced or differently-versioned producer must not crash a
    traced consumer)."""
    if not value:
        return None
    try:
        trace_hex, span_hex, seq = str(value).split("-")
        return SpanContext(int(trace_hex, 16), int(span_hex, 16),
                           int(seq))
    except (ValueError, TypeError):
        return None


class Span:
    """One (possibly still open) span. ``t0``/``dur`` are in the
    tracer's monotonic clock domain (``time.perf_counter`` seconds);
    conversion to wall-anchored microseconds happens once at export."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "role",
                 "tid", "thread_name", "t0", "dur", "args")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: Optional[int], role: str, tid: int,
                 thread_name: str, t0: float, args: Optional[dict]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.role = role
        self.tid = tid
        self.thread_name = thread_name
        self.t0 = t0
        self.dur = 0.0
        self.args = args

    def context(self, seq: int = 0) -> SpanContext:
        """The propagatable context naming THIS span as the parent."""
        return SpanContext(self.trace_id, self.span_id, seq)


class Tracer:
    """Bounded in-memory span collector with Chrome-trace export.

    ``_clock``/``_ids``/``_epoch`` are injectable for deterministic
    tests (the golden-file export); production uses perf_counter,
    a process-local 64-bit PRNG, and a wall-clock anchor captured at
    construction so all spans of one process share one time base.
    """

    def __init__(self, limit: int = DEFAULT_SPAN_LIMIT, *,
                 default_role: str = "process",
                 _clock=time.perf_counter, _ids=None,
                 _epoch: Optional[float] = None):
        if limit <= 0:
            raise ValueError("span buffer limit must be positive")
        self.limit = limit
        self.default_role = default_role
        self._clock = _clock
        self._rng = random.Random()
        self._ids = _ids or (lambda: self._rng.getrandbits(64) or 1)
        # Anchor: wall time at clock()==0, so exported ts are unix-
        # epoch microseconds and two processes' traces roughly align.
        self._epoch = (time.time() - time.perf_counter()
                       if _epoch is None else _epoch)
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._dropped = 0
        self._tls = threading.local()

    # -- ids / clock ---------------------------------------------------------
    def new_id(self) -> int:
        return self._ids()

    def now(self) -> float:
        return self._clock()

    @property
    def epoch(self) -> float:
        """Wall time at clock()==0 — what converts a span's monotonic
        ``t0`` to the unix-epoch microseconds the export (and the
        fleet pusher's cross-process stitching) uses."""
        return self._epoch

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- the explicit start/end API ------------------------------------------
    def start_span(self, name: str, *, trace_id: Optional[int] = None,
                   parent_id: Optional[int] = None,
                   role: Optional[str] = None,
                   args: Optional[dict] = None,
                   start: Optional[float] = None) -> Span:
        """Open a span. With no explicit trace/parent, the span joins
        the thread's active span (see :meth:`activate`) or starts a
        fresh trace."""
        if trace_id is None:
            cur = self.current()
            if cur is not None:
                trace_id = cur.trace_id
                if parent_id is None:
                    parent_id = cur.span_id
                if role is None:
                    role = cur.role
            else:
                trace_id = self.new_id()
        th = threading.current_thread()
        return Span(name, trace_id, self.new_id(), parent_id,
                    role or self.default_role, th.ident or 0, th.name,
                    self._clock() if start is None else start, args)

    def end_span(self, span: Span, *, end: Optional[float] = None,
                 **extra_args) -> None:
        """Close a span and commit it to the (bounded) buffer."""
        span.dur = (self._clock() if end is None else end) - span.t0
        if extra_args:
            span.args = {**(span.args or {}), **extra_args}
        with self._lock:
            if len(self._spans) >= self.limit:
                self._dropped += 1
                return
            self._spans.append(span)

    def add_span(self, name: str, start: float, end: float, *,
                 trace_id: int, parent_id: Optional[int] = None,
                 role: Optional[str] = None,
                 args: Optional[dict] = None) -> Span:
        """Commit a span from an already-measured interval — the shape
        hot loops want: measure with two perf_counter reads as they
        already do, attach the span only if tracing is on."""
        span = self.start_span(name, trace_id=trace_id,
                               parent_id=parent_id, role=role,
                               args=args, start=start)
        self.end_span(span, end=end)
        return span

    # -- context-manager sugar + thread-local activation ---------------------
    @contextlib.contextmanager
    def span(self, name: str, **kwargs):
        """``with tracer.span("decode") as sp:`` — opens, ACTIVATES
        (nested spans on this thread inherit trace/parent), and closes
        on exit; an exception is recorded as ``args.error`` and
        re-raised."""
        sp = self.start_span(name, **kwargs)
        try:
            with self.activate(sp):
                yield sp
        except BaseException as exc:
            self.end_span(sp, error=repr(exc))
            raise
        self.end_span(sp)

    @contextlib.contextmanager
    def activate(self, span: Optional[Span]):
        """Make ``span`` the thread's active span for the duration:
        spans opened without an explicit trace join it (how the
        sharded engine's replica spans nest under the batch span
        without threading a handle through every call)."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)
        try:
            yield span
        finally:
            stack.pop()

    def current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    # -- export --------------------------------------------------------------
    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def snapshot_from(self, start: int, limit: Optional[int] = None
                      ) -> Tuple[List[Span], int]:
        """Up to ``limit`` completed spans appended since cursor
        ``start``, plus the cursor of the buffer END (so a caller can
        tell backlog remains) — the fleet pusher's incremental read.
        The buffer only ever appends (drops past the limit never
        reorder it), so an index cursor is stable across snapshots,
        and a bounded read copies only what it ships."""
        with self._lock:
            end = len(self._spans)
            stop = end if limit is None else min(end, start + limit)
            return list(self._spans[start:stop]), end

    def export(self) -> dict:
        """The Chrome trace-event document (Perfetto /
        ``chrome://tracing`` loadable). Synthetic pids: one per role in
        first-registration order (hermetic runs put several roles in
        one OS process, which must still separate into swimlanes);
        tids: one small int per worker thread."""
        spans = self.snapshot()
        pid_of: Dict[str, int] = {}
        tid_of: Dict[tuple, int] = {}
        events: List[dict] = []
        for s in spans:
            pid = pid_of.setdefault(s.role, len(pid_of) + 1)
            tkey = (s.role, s.tid)
            tid = tid_of.get(tkey)
            if tid is None:
                tid = tid_of[tkey] = (
                    sum(1 for k in tid_of if k[0] == s.role) + 1)
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": s.thread_name}})
            args = {"trace_id": f"{s.trace_id:016x}",
                    "span_id": f"{s.span_id:016x}"}
            if s.parent_id is not None:
                args["parent_span_id"] = f"{s.parent_id:016x}"
            if s.args:
                args.update(s.args)
            events.append({
                "name": s.name, "ph": "X", "pid": pid, "tid": tid,
                "ts": round((self._epoch + s.t0) * 1e6, 3),
                "dur": round(s.dur * 1e6, 3),
                "args": args})
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "tid": 0, "args": {"name": role}}
                for role, pid in pid_of.items()]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"pid": os.getpid(),
                          "dropped_spans": self.dropped,
                          "span_count": len(spans)},
        }

    # -- consumer-side helper (shared by both processors) --------------------
    def begin_consume(self, properties, redelivery: int, *, role: str,
                      start: float, got: float, wait_name: str,
                      args: Optional[dict] = None):
        """Open the per-batch consumer span continuing the trace the
        publisher put in the message properties (fresh trace when
        untraced upstream). A redelivered message becomes a ``retry``
        span parented under the SAME publish span as the original
        attempt — the redelivery chain reads as siblings. The receive
        wait [start, got] is committed as the first child under
        ``wait_name``. Callers end_span() when the batch settles."""
        ctx = parse_ctx((properties or {}).get(TRACEPARENT))
        trace_id = ctx.trace_id if ctx is not None else self.new_id()
        parent = ctx.span_id if ctx is not None else None
        a = dict(args or {})
        if ctx is not None:
            a["seq"] = ctx.seq
        if redelivery:
            a["redelivery"] = redelivery
        span = self.start_span("retry" if redelivery else "batch",
                               trace_id=trace_id, parent_id=parent,
                               role=role, start=start, args=a)
        self.add_span(wait_name, start, got, trace_id=trace_id,
                      parent_id=span.span_id, role=role)
        return span

    # -- producer-side helpers (shared by every transport backend) -----------
    def begin_publish(self, topic: str, seq: int,
                      properties: Optional[dict]):
        """Open a ``publish`` span for one message and return
        ``(span, properties)`` with the traceparent installed.

        An incoming traceparent (the bridge forwarding a consumed
        trace) is CONTINUED — the publish span parents under it and
        the outgoing context is rewritten to name the publish span, so
        downstream hops nest publish -> deliver in one trace. Without
        one, the publish span roots a fresh trace (one trace_id per
        published batch). Callers must end_span() after the publish
        completes."""
        ctx = parse_ctx((properties or {}).get(TRACEPARENT))
        span = self.start_span(
            "publish",
            trace_id=ctx.trace_id if ctx else self.new_id(),
            parent_id=ctx.span_id if ctx else None,
            role="producer", args={"topic": topic, "seq": seq})
        props = dict(properties) if properties else {}
        props[TRACEPARENT] = format_ctx(span.context(seq))
        return span, props

    def begin_publish_many(self, topic: str, seq0: int, count: int):
        """Bulk-lane variant: ONE ``publish_many`` span for the call
        (per-message spans at JSON-wire rates would flood the bounded
        buffer) plus a fresh per-message context list — each message
        still gets its own trace_id, parented to the bulk span."""
        span = self.start_span("publish_many", role="producer",
                               args={"topic": topic, "count": count})
        props = [{TRACEPARENT: format_ctx(SpanContext(
            self.new_id(), span.span_id, seq0 + i))}
            for i in range(count)]
        return span, props

    def flush(self, path) -> Path:
        """Write the export as one JSON document (atomic rename — a
        reader mid-run never sees a torn file). Idempotent: callers
        flush at end-of-run AND at teardown; later flushes rewrite
        with whatever accumulated since."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.export(), f)
        tmp.replace(path)
        return path
