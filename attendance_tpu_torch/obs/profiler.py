"""Continuous profiling & performance attribution.

Counterpart of ``attendance_tpu/obs/profiler.py``: the same stage
marks, sampler, artifacts (``profile.folded``, ``profile_trace.json``,
``attribution.json``) and attribution table, so either package's
``telemetry --attribution`` renders either package's documents. The
metrics answer *what* the system is doing (rates, lag, burn); this
module answers *where the time goes*:

* :class:`StageTracker` — a per-thread "current pipeline stage"
  registry the instrumented hot paths mark at the SAME transitions
  that already feed the stage histograms and span tracer
  (dequeue/decode/dispatch/device_wait/temporal/snapshot/serve/
  lane_decode). One dict write per transition; a plain dict keyed by
  thread ident is GIL-atomic, so the sampler reads it lock-free.
* :class:`SamplingProfiler` — a background thread sampling
  ``sys._current_frames()`` at ``--profile-hz`` (default 0 = off),
  folding each sample into per-thread collapsed stacks attributed to
  the thread's marked stage. Exports: ``profile.folded``
  (flamegraph.pl / speedscope collapsed-stack format),
  ``profile_trace.json`` (a Chrome-trace/Perfetto stage timeline —
  consecutive same-stage samples merge into one slice per thread),
  and ``attribution.json`` (the per-stage self-time document
  ``telemetry --attribution`` renders). Stage self-time fractions are
  also exported live as ``attendance_profile_stage_fraction{stage=}``
  callback gauges, so they ride every existing surface for free: the
  prom file and ``doctor``. The sampler reads host Python frames only;
  the card's own timeline is ``--profile-dir``'s ``torch.profiler``
  trace (``utils/profiling.py``).
* :class:`RecompileTracker` — launch-shape visibility. Nothing
  compiles on the card: the kernels are built once, ahead of the run.
  What the JAX package counts as an XLA (re)compile, a new shape
  fingerprint at a dispatch site, is here a new LAUNCH shape: the
  dispatch sites report the same ``fn`` names and fingerprint tuples
  as the JAX package's, so a run's counts equal JAX's
  (``attendance_recompiles_total{fn=}``, one per new fingerprint),
  and one seen after :meth:`RecompileTracker.mark_warm` (the first
  completed run loop) additionally counts as STEADY-STATE
  (``attendance_recompiles_steady_total{fn=}``) — the number
  ``doctor --recompile-ceiling`` gates at 0. A steady count above 0
  still means unpadded shapes reach a kernel: new allocator blocks and
  new grids on every frame instead of the padded power-of-two shapes
  the caching allocator recycles. Two sites are the exception: the
  temporal window add (``temporal_window_add``, K4 and K5) and the
  count-min step (``cms_step``, K6) report the JAX package's padded
  shape, yet launch at the batch's own length, so their counts say
  nothing of the shapes that reach those kernels.

Discipline (same as the rest of obs/): everything here is off unless
``--profile-hz`` > 0; instrumented sites capture the tracker handles
once at construction and pay one ``is not None`` branch when off.
When ON, the hot threads pay only the stage-mark dict writes and the
per-dispatch fingerprint set lookup — the sampling itself runs
entirely on the profiler's own thread.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Frames kept per sampled stack (deep stacks truncate; the hot
# loops this exists for are far shallower).
MAX_STACK_DEPTH = 48
# Chrome-trace stage slices retained (drops counted, never realloc'd).
MAX_SLICES = 1 << 16
# Distinct collapsed stacks retained; past this, new stacks fold into
# a per-(thread, stage) "(truncated)" row so a pathological workload
# cannot OOM the process through its own profiler.
MAX_STACKS = 1 << 14

FOLDED_FILE = "profile.folded"
TRACE_FILE = "profile_trace.json"
ATTRIBUTION_FILE = "attribution.json"

UNTAGGED = "untagged"


def _role_of(thread_name: str) -> str:
    """Thread name -> bounded role label: strip the per-instance
    numeric suffixes pool threads carry (``fleet-conn-51734``,
    ``Thread-3``) so the attribution table's columns stay a small
    fixed set instead of one per connection."""
    return thread_name.rstrip("0123456789").rstrip("-_") or "thread"


class StageTracker:
    """Per-thread current-stage registry.

    ``set`` returns the previous stage so nested scopes can restore
    it; long-lived single-purpose threads (snapshot writer, serve
    handlers, lane workers) mark once and stay. Reads from the
    sampler thread are lock-free: dict item assignment is atomic
    under the GIL, and a momentarily stale read mislabels at most one
    sample."""

    __slots__ = ("_stages",)

    def __init__(self):
        self._stages: Dict[int, str] = {}

    def set(self, stage: str) -> Optional[str]:
        ident = threading.get_ident()
        prev = self._stages.get(ident)
        self._stages[ident] = stage
        return prev

    def restore(self, prev: Optional[str]) -> None:
        ident = threading.get_ident()
        if prev is None:
            self._stages.pop(ident, None)
        else:
            self._stages[ident] = prev

    def get(self, ident: int) -> Optional[str]:
        return self._stages.get(ident)

    def prune(self, live_idents) -> None:
        """Drop marks of threads no longer alive (the sampler calls
        this with ``sys._current_frames()``'s key set): CPython
        recycles thread idents, so a dead serve handler's sticky mark
        would otherwise mislabel whichever later thread inherits its
        ident — and thread-per-connection churn would grow the dict
        forever. Racing a brand-new thread's first ``set`` can at
        worst drop one mark for one sample; the next transition
        re-marks."""
        for ident in list(self._stages):
            if ident not in live_idents:
                self._stages.pop(ident, None)

    def clear(self) -> None:
        self._stages.pop(threading.get_ident(), None)


class RecompileTracker:
    """Shape-fingerprint ledger over the kernel dispatch sites.

    Dispatch sites call :meth:`observe` with their function name and
    the tuple of shape-determining parameters (key width, padded
    lane count, bank count, ...). A fingerprint's first appearance is
    one new launch shape (where the JAX package compiles a new
    program variant) — the per-frame fast path is one dict lookup plus one set-membership
    test, no lock (dispatch sites all live on the dispatch thread;
    the rare mutation takes the lock for the counters)."""

    _WARN_PER_FN = 8  # steady-recompile WARNINGs logged per fn

    def __init__(self, registry=None):
        self._registry = registry
        self._seen: Dict[str, set] = {}
        self._lock = threading.Lock()
        self._warm = False
        self._log: List[dict] = []  # bounded fingerprint log
        self._warned: Dict[str, int] = {}
        self._counters: Dict[str, object] = {}
        self._steady_counters: Dict[str, object] = {}
        self.total = 0
        self.steady = 0

    def observe(self, fn: str, fingerprint: Tuple) -> bool:
        """Record one dispatch; returns True iff this (fn,
        fingerprint) is a NEW compile."""
        seen = self._seen.get(fn)
        if seen is not None and fingerprint in seen:
            return False
        with self._lock:
            seen = self._seen.setdefault(fn, set())
            if fingerprint in seen:
                return False
            seen.add(fingerprint)
            self.total += 1
            steady = self._warm
            if steady:
                self.steady += 1
            if len(self._log) < 256:
                self._log.append({
                    "fn": fn, "fingerprint": list(fingerprint),
                    "steady": steady, "ts": round(time.time(), 3)})
        if steady:
            # A steady-state recompile is the invisible storm this
            # tracker exists for — name the shape while it happens,
            # BOUNDED per fn: during an actual storm (new shape every
            # frame) an unthrottled warning would add synchronous log
            # I/O to every hot-loop dispatch; the counters and the
            # fingerprint log carry the full count regardless.
            warned = self._warned.get(fn, 0)
            if warned < self._WARN_PER_FN:
                self._warned[fn] = warned + 1
                logger.warning(
                    "steady-state recompile: %s %r (unpadded shape "
                    "reaching a kernel?)%s", fn, fingerprint,
                    " — further warnings for this fn suppressed; "
                    "see attendance_recompiles_steady_total"
                    if warned + 1 == self._WARN_PER_FN else "")
        reg = self._registry
        if reg is not None:
            c = self._counters.get(fn)
            if c is None:
                # The help text is the JAX package's, word for word (the
                # scrape contract); on the card read "compiled" as
                # "launched at a new shape".
                c = self._counters[fn] = reg.counter(
                    "attendance_recompiles_total",
                    help="Jitted program variants compiled, per entry "
                    "point (one per new shape fingerprint)", fn=fn)
                self._steady_counters[fn] = reg.counter(
                    "attendance_recompiles_steady_total",
                    help="Recompiles AFTER the first completed run "
                    "loop (steady state must hold 0: a nonzero count "
                    "means unpadded shapes leak into XLA)", fn=fn)
            c.inc()
            if steady:
                self._steady_counters[fn].inc()
        return True

    def mark_warm(self) -> None:
        """Every fingerprint from here on counts as steady-state.
        Called at the end of the first completed run loop — warmup
        compiles are the expected cost of a fresh process; anything
        after is a leak."""
        self._warm = True

    @property
    def warm(self) -> bool:
        return self._warm

    def snapshot(self) -> dict:
        with self._lock:
            return {"total": self.total, "steady": self.steady,
                    "fingerprints": list(self._log)}


class SamplingProfiler:
    """Low-overhead host sampling profiler (the wall-clock half of
    the attribution plane). One daemon thread; hot threads are only
    ever READ (``sys._current_frames`` + the stage dict)."""

    def __init__(self, hz: float, *, registry=None, out_dir: str = "",
                 _clock=time.perf_counter):
        if hz <= 0:
            raise ValueError("profile hz must be positive")
        self.hz = float(hz)
        self.out_dir = out_dir
        self.stages = StageTracker()
        self._registry = registry
        self._clock = _clock
        self._epoch = time.time() - time.perf_counter()
        self._lock = threading.Lock()
        self._samples = 0
        self._by_stage: Dict[str, int] = {}
        self._by_thread_stage: Dict[Tuple[str, str], int] = {}
        self._stacks: Dict[Tuple[str, str, str], int] = {}
        self._stacks_truncated = 0
        # Per-thread stage timeline -> Chrome-trace slices.
        self._open: Dict[int, tuple] = {}  # ident -> (name, stage, t0)
        self._slices: List[tuple] = []  # (tname, ident, stage, t0, t1)
        self._slices_dropped = 0
        self._t_start: Optional[float] = None
        self._t_stop: Optional[float] = None
        self._stage_gauges: Dict[str, object] = {}
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is not None:
            registry.gauge(
                "attendance_profile_samples_total",
                help="Stack samples folded by the host sampling "
                "profiler").set_function(lambda: float(self.samples))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self._t_start = time.time()
        self._stop_ev.clear()
        self._thread = threading.Thread(
            target=self._loop, name="attendance-profiler", daemon=True)
        self._thread.start()
        logger.info("Sampling profiler on at %.0f Hz%s", self.hz,
                    f" (artifacts -> {self.out_dir})"
                    if self.out_dir else "")
        return self

    def stop(self) -> None:
        """Stop sampling and close open timeline slices. Hygiene
        contract (tested): after stop() returns, the sampler thread
        is joined — no leaked thread, no samples folded after.

        Artifact writing is the OWNER's job (Telemetry.flush_profile,
        which threads the recompile ledger in, or an explicit
        :meth:`write`): writing here too would double every shutdown's
        I/O and transiently publish an attribution.json missing the
        recompiles block."""
        t = self._thread
        if t is None:
            return
        self._stop_ev.set()
        t.join(timeout=5.0)
        self._thread = None
        self._t_stop = time.time()
        now = self._wall()
        with self._lock:
            for ident, (tname, stage, t0) in self._open.items():
                self._push_slice(tname, ident, stage, t0, now)
            self._open.clear()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    # -- sampling ------------------------------------------------------------
    def _wall(self) -> float:
        return self._epoch + self._clock()

    def _loop(self) -> None:
        interval = 1.0 / self.hz
        next_t = self._clock()
        while True:
            next_t += interval
            delay = next_t - self._clock()
            if delay > 0:
                if self._stop_ev.wait(delay):
                    return
            else:
                # Fell behind (GIL-starved host): resync instead of
                # bursting catch-up samples that would overweight the
                # moment the host freed up.
                next_t = self._clock()
                if self._stop_ev.is_set():
                    return
            self.sample_once()

    def sample_once(self) -> None:
        """Take one sample of every live thread (public for tests)."""
        me = threading.get_ident()
        frames = sys._current_frames()
        self.stages.prune(frames.keys())
        names = {t.ident: t.name for t in threading.enumerate()}
        now = self._wall()
        folded = []
        for ident, frame in frames.items():
            if ident == me:
                continue
            parts: List[str] = []
            f, depth = frame, 0
            while f is not None and depth < MAX_STACK_DEPTH:
                code = f.f_code
                parts.append(f"{os.path.basename(code.co_filename)}"
                             f":{code.co_name}")
                f = f.f_back
                depth += 1
            parts.reverse()  # root first (collapsed-stack convention)
            stage = self.stages.get(ident) or UNTAGGED
            tname = names.get(ident, f"tid{ident}")
            folded.append((ident, tname, _role_of(tname), stage,
                           ";".join(parts)))
        del frames  # drop the frame refs promptly
        new_stages = []
        with self._lock:
            for ident, tname, role, stage, stack in folded:
                self._samples += 1
                if stage not in self._by_stage:
                    new_stages.append(stage)
                self._by_stage[stage] = self._by_stage.get(stage, 0) + 1
                tkey = (role, stage)
                self._by_thread_stage[tkey] = \
                    self._by_thread_stage.get(tkey, 0) + 1
                skey = (role, stage, stack)
                if skey in self._stacks or len(self._stacks) < MAX_STACKS:
                    self._stacks[skey] = self._stacks.get(skey, 0) + 1
                else:
                    self._stacks_truncated += 1
                    tk = (role, stage, "(truncated)")
                    self._stacks[tk] = self._stacks.get(tk, 0) + 1
                open_ = self._open.get(ident)
                if open_ is None:
                    self._open[ident] = (tname, stage, now)
                elif open_[1] != stage:
                    self._push_slice(open_[0], ident, open_[1],
                                     open_[2], now)
                    self._open[ident] = (tname, stage, now)
        for stage in new_stages:
            self._register_stage_gauge(stage)

    def _push_slice(self, tname: str, ident: int, stage: str,
                    t0: float, t1: float) -> None:
        # Lock held by caller.
        if len(self._slices) >= MAX_SLICES:
            self._slices_dropped += 1
            return
        self._slices.append((tname, ident, stage, t0, t1))

    def _register_stage_gauge(self, stage: str) -> None:
        reg = self._registry
        if reg is None or stage in self._stage_gauges:
            return

        def read(stage=stage) -> float:
            with self._lock:
                total = self._samples
                n = self._by_stage.get(stage, 0)
            return n / total if total else 0.0

        g = reg.gauge(
            "attendance_profile_stage_fraction",
            help="Self-time fraction of all profiler samples "
            "attributed to this pipeline stage", stage=stage)
        g.set_function(read)
        self._stage_gauges[stage] = g

    # -- exports -------------------------------------------------------------
    def collapsed(self) -> str:
        """flamegraph.pl / speedscope collapsed-stack lines:
        ``thread-role;stage;frame;frame... count``."""
        with self._lock:
            items = sorted(self._stacks.items())
        return "\n".join(
            f"{role};{stage};{stack} {count}"
            for (role, stage, stack), count in items) + ("\n" if items
                                                         else "")

    def chrome_trace(self) -> dict:
        """Stage-timeline Chrome-trace document: one ``X`` slice per
        run of consecutive same-stage samples per thread — loadable
        in Perfetto next to the span tracer's export."""
        now = self._wall()
        with self._lock:
            slices = list(self._slices)
            for ident, (tname, stage, t0) in self._open.items():
                slices.append((tname, ident, stage, t0, now))
            dropped = self._slices_dropped
            total = self._samples
        tid_of: Dict[int, int] = {}
        events: List[dict] = []
        for tname, ident, stage, t0, t1 in slices:
            tid = tid_of.get(ident)
            if tid is None:
                tid = tid_of[ident] = len(tid_of) + 1
                events.append({"name": "thread_name", "ph": "M",
                               "pid": 1, "tid": tid,
                               "args": {"name": tname}})
            events.append({"name": stage, "ph": "X", "pid": 1,
                           "tid": tid, "ts": round(t0 * 1e6, 3),
                           "dur": round(max(t1 - t0, 0.0) * 1e6, 3),
                           "args": {"source": "sampling-profiler"}})
        meta = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                 "args": {"name": f"profiled pid {os.getpid()}"}}]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"sampling_hz": self.hz,
                              "samples": total,
                              "dropped_slices": dropped}}

    def attribution(self, recompiles: Optional[RecompileTracker] = None
                    ) -> dict:
        """The per-stage self-time document: wall %% by stage x thread
        role — what ``telemetry --attribution`` renders."""
        with self._lock:
            total = self._samples
            by_stage = dict(self._by_stage)
            by_ts = dict(self._by_thread_stage)
        t_end = self._t_stop or time.time()
        doc = {
            "kind": "attribution",
            "pid": os.getpid(),
            "hz": self.hz,
            "samples_total": total,
            "duration_s": round(
                max(t_end - (self._t_start or t_end), 0.0), 3),
            "stages": {
                stage: {"samples": n,
                        "frac": round(n / total, 6) if total else 0.0}
                for stage, n in sorted(by_stage.items())},
            "threads": {},
        }
        for (role, stage), n in sorted(by_ts.items()):
            doc["threads"].setdefault(role, {})[stage] = n
        doc["top"] = [
            [stage, doc["stages"][stage]["frac"]]
            for stage in sorted(by_stage,
                                key=lambda s: -by_stage[s])[:3]]
        if recompiles is not None:
            doc["recompiles"] = recompiles.snapshot()
        return doc

    def write(self, out_dir,
              recompiles: Optional[RecompileTracker] = None) -> Path:
        """Write the three artifacts under ``out_dir`` (atomic
        renames; idempotent). Callers: Telemetry.flush_profile — at
        run-end, telemetry stop, and atexit — which threads the
        recompile ledger in. stop() deliberately does NOT write (a
        write here too would double shutdown I/O and transiently
        publish attribution.json without the ledger). Returns the
        attribution path."""
        root = Path(out_dir)
        root.mkdir(parents=True, exist_ok=True)
        for name, payload in (
                (FOLDED_FILE, self.collapsed()),
                (TRACE_FILE, json.dumps(self.chrome_trace())),
                (ATTRIBUTION_FILE,
                 json.dumps(self.attribution(recompiles), indent=1))):
            tmp = root / (name + ".tmp")
            tmp.write_text(payload)
            tmp.replace(root / name)
        return root / ATTRIBUTION_FILE


def format_attribution_table(doc: dict) -> str:
    """Render an attribution document as the per-stage self-time
    table (wall %% by stage x thread role), stages sorted by
    self-time. The golden-file contract of ``telemetry
    --attribution``."""
    from attendance_tpu_torch.obs.exposition import _table

    total = int(doc.get("samples_total", 0))
    stages = doc.get("stages", {})
    threads = doc.get("threads", {})
    roles = sorted(threads)
    headers = ["stage", "self%", "samples"] + roles
    rows: List[List[str]] = []
    for stage in sorted(stages, key=lambda s: -stages[s]["samples"]):
        info = stages[stage]
        row = [stage, f"{info['frac']:.1%}", str(info["samples"])]
        for role in roles:
            n = threads.get(role, {}).get(stage, 0)
            row.append(f"{n / total:.1%}" if total and n else "-")
        rows.append(row)
    head = (f"attribution: {total} samples @ "
            f"{doc.get('hz', 0):g} Hz over "
            f"{doc.get('duration_s', 0):g}s (pid {doc.get('pid')})")
    lines = [head, _table(rows, headers)]
    rec = doc.get("recompiles")
    if rec:
        lines.append(
            f"recompiles: {rec.get('total', 0)} total, "
            f"{rec.get('steady', 0)} steady-state"
            + (" (CEILING BREACH CANDIDATE)" if rec.get("steady")
               else ""))
        for fp in rec.get("fingerprints", [])[:8]:
            lines.append(
                f"  {'steady ' if fp.get('steady') else ''}"
                f"{fp.get('fn')} {tuple(fp.get('fingerprint', ()))}")
    return "\n".join(lines)
