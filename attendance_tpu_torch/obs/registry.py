"""Metrics registry: named Counters, Gauges, and log-bucketed Histograms.

Counterpart of ``attendance_tpu/obs/registry.py`` (a copy: the port
imports nothing of the JAX package). Where ``FusedMetrics`` and
``ProcessorMetrics`` are end-of-run artifacts, these metrics are
readable at any moment by the exposition layer (obs.exposition) without
stopping or perturbing the hot loop. Every value here is a host number:
no metric reads a CUDA tensor.

Design constraints, in order:

* Hot-path record cost is an increment plus a bit-scan. A histogram
  ``observe`` scales the value to integer units and buckets it by
  ``int.bit_length()`` (power-of-2 bucket boundaries) — no bisect, no
  float log. The only synchronization is one per-metric mutex held for
  the increment itself; metrics never share a lock, so two pipeline
  threads recording different stages never contend.
* Disabled cost is zero: nothing in this module runs unless telemetry
  was enabled — instrumented call sites hold ``None`` and pay one
  branch.
* Collection is lock-consistent per metric, not globally atomic: a
  scrape sees each metric at some point during the scrape, exactly like
  a Prometheus client library.

Identity is (name, sorted label items): asking the registry for the
same name+labels returns the same metric object, so call sites may
re-request handles without double-counting.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Histogram geometry: bucket i counts observations whose scaled value u
# satisfies u.bit_length() == i, i.e. u < 2**i — upper bound 2**i units.
# 28 buckets at microsecond scale span 1us .. ~134s, which brackets every
# stage latency this framework can produce (a snapshot stall measured in
# seconds sits mid-range).
NUM_BUCKETS = 28


def quantile_from_buckets(buckets: List[int], count: int, q: float,
                          scale: float = 1e6) -> float:
    """Value at quantile ``q`` of a power-of-2 bucket snapshot, with
    linear interpolation inside the landing bucket (bucket i spans
    [2**(i-1), 2**i) scaled units; bucket 0 is [0, 1)).

    ``count`` is the TOTAL observation count including overflow
    (samples past the last finite bound, which the snapshot's bucket
    list does not carry) — a rank landing there answers +Inf, the same
    "don't claim it was below the bound" honesty as the exposition's
    +Inf bucket. NaN when the snapshot is empty."""
    if count <= 0:
        return float("nan")
    if not (0.0 <= q <= 1.0):
        raise ValueError(f"quantile out of range: {q}")
    # Rank of the target observation, 1-based; q=0 -> first sample.
    rank = max(1, int(math.ceil(q * count)))
    cum = 0
    for i, b in enumerate(buckets):
        if b <= 0:
            continue
        if cum + b >= rank:
            lo = 0.0 if i == 0 else float(1 << (i - 1))
            hi = float(1 << i)
            frac = (rank - cum) / b
            return (lo + (hi - lo) * frac) / scale
        cum += b
    return float("inf")  # rank falls in the overflow tail


class Counter:
    """Monotonic counter. ``inc`` of a negative amount raises — the
    monotonicity contract is what lets consumers compute rates."""

    __slots__ = ("name", "labels", "help", "_lock", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, amount: int = 1) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Set/add gauge, or a callback gauge (``set_function``) whose value
    is read lazily at collection time — queue depths cost the hot path
    nothing this way; only the scrape pays the read."""

    __slots__ = ("name", "labels", "help", "_lock", "_value", "_fn")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            self._fn = None

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += delta

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    def read(self) -> float:
        """Current value; a callback gauge's exception PROPAGATES —
        the exposition layer skips the sample with a warning (a bad
        device read must not render as a silent 0.0, which consumers
        would read as "FPR is zero", the opposite of broken)."""
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        return float(fn())

    @property
    def value(self) -> float:
        try:
            return self.read()
        except Exception:
            # A dead callback (e.g. its subscription was torn down) must
            # not break every future scrape.
            return 0.0


class Histogram:
    """Log-bucketed (power-of-2) histogram.

    ``scale`` converts observed values to integer bucket units before
    the bit-scan; the default 1e6 gives microsecond-resolution buckets
    for values observed in seconds. Upper bound of bucket i is
    ``2**i / scale`` (in observed units); the last bucket is +Inf.
    """

    __slots__ = ("name", "labels", "help", "scale", "_lock", "_buckets",
                 "_overflow", "_sum", "_count", "_exemplar")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 help: str = "", scale: float = 1e6):
        self.name = name
        self.labels = labels
        self.help = help
        self.scale = scale
        self._lock = threading.Lock()
        self._buckets = [0] * NUM_BUCKETS
        # Samples past the last finite bound count ONLY toward +Inf
        # (and sum/count): folding them into the last finite bucket
        # would claim e.g. a 10-minute stall was <= 134s — exactly the
        # forensic lie cumulative-bucket semantics exist to prevent.
        self._overflow = 0
        self._sum = 0.0
        self._count = 0
        # Worst observation carrying a trace id since the last scrape:
        # the OpenMetrics exemplar that links a p99 breach straight to
        # the span tree of the batch that caused it.
        self._exemplar: Optional[Tuple[float, str]] = None

    def observe(self, value: float, trace_id: str = "") -> None:
        u = int(value * self.scale)
        idx = u.bit_length() if u > 0 else 0
        with self._lock:
            if idx >= NUM_BUCKETS:
                self._overflow += 1
            else:
                self._buckets[idx] += 1
            self._sum += value
            self._count += 1
            if trace_id and (self._exemplar is None
                             or value >= self._exemplar[0]):
                self._exemplar = (value, trace_id)

    def exemplar(self, reset: bool = True) -> Optional[Tuple[float, str]]:
        """(value, trace_id) of the worst traced observation in the
        current window, or None. ``reset`` starts a new window (the
        exposition layer resets per scrape, so each block carries that
        interval's worst batch — exemplars are best-effort samples,
        not cumulative state)."""
        with self._lock:
            ex = self._exemplar
            if reset:
                self._exemplar = None
            return ex

    def bucket_bound(self, idx: int) -> float:
        """Upper bound (observed units) of bucket ``idx``."""
        return (1 << idx) / self.scale

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._buckets), self._sum, self._count

    def quantile(self, q: float) -> float:
        """p-quantile estimate from the live buckets (the "dequeue_wait
        p99" the tracing docstring narrates — now computable): linear
        interpolation inside the landing power-of-2 bucket, +Inf when
        the rank falls past the last finite bound, NaN when empty. The
        SLO engine computes WINDOWED quantiles from snapshot deltas
        via :func:`quantile_from_buckets` directly."""
        buckets, _, count = self.snapshot()
        return quantile_from_buckets(buckets, count, q, self.scale)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# Ceiling on distinct label sets per metric name. Per-day gauges (the
# audit/read-error families label by day) grow one series per lecture
# day, which is unbounded on a long multi-day run — and every series
# costs scrape time and exposition bytes FOREVER (a registry never
# forgets). Past the cap, new label sets fold into one per-family
# overflow metric and the overflow is announced ONCE at ERROR.
DEFAULT_MAX_SERIES = 1024

SERIES_GAUGE = "attendance_metric_series_total"


class Registry:
    """Get-or-create registry of metrics keyed by (name, labels).

    ``max_series`` caps distinct label sets per metric NAME (the
    cardinality guard; <= 0 = unlimited): the first overflowing
    registration logs at ERROR, and overflowing call sites receive a
    shared per-family sink metric of the right type — still safe to
    record into, just not exported — so a hot loop never crashes on a
    cardinality leak and the exposition never silently balloons. The
    registry's own series count is exported as the
    ``attendance_metric_series_total`` self-gauge, so the approach to
    the cap is itself observable."""

    def __init__(self, max_series: int = DEFAULT_MAX_SERIES):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, object] = {}
        # name -> (kind, help), pinned by the first registration so a
        # later get with a different kind fails loudly instead of
        # corrupting the exposition.
        self._families: Dict[str, Tuple[str, str]] = {}
        self.max_series = max_series
        self._series_of: Dict[str, int] = {}  # name -> label-set count
        self._overflow: Dict[str, object] = {}  # name -> sink metric
        self._overflow_total = 0
        self.gauge(SERIES_GAUGE,
                   help="Distinct metric series (name+labels) held by "
                   "this registry — the label-cardinality guard's "
                   "self-measurement").set_function(
                       lambda: float(len(self._metrics)))

    def _get(self, kind: str, cls, name: str, help: str,
             labels: Dict[str, str], **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is not None:
                if self._families[name][0] != kind:
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{self._families[name][0]}, not {kind}")
                return m
            fam = self._families.get(name)
            if fam is not None and fam[0] != kind:
                raise ValueError(
                    f"metric {name} already registered as {fam[0]}, "
                    f"not {kind}")
            if (self.max_series > 0
                    and self._series_of.get(name, 0) >= self.max_series):
                return self._overflow_sink(kind, cls, name, help,
                                           **kwargs)
            if fam is None:
                self._families[name] = (kind, help)
            m = cls(name, key[1], help=help or (fam[1] if fam else ""),
                    **kwargs)
            self._metrics[key] = m
            self._series_of[name] = self._series_of.get(name, 0) + 1
            return m

    def _overflow_sink(self, kind: str, cls, name: str, help: str,
                       **kwargs):
        """One shared, UNEXPORTED sink metric per overflowing family
        (lock held by caller). Returning a real metric object keeps
        every call-site contract (inc/set/observe) intact; keeping it
        out of ``_metrics`` is what stops the exposition growing."""
        self._overflow_total += 1
        sink = self._overflow.get(name)
        if sink is None:
            sink = self._overflow[name] = cls(
                name, (("overflow", "true"),), help=help, **kwargs)
            logger.error(
                "metric %s overflowed the label-cardinality cap "
                "(max_series=%d): further label sets fold into one "
                "unexported sink — a label is probably carrying an "
                "unbounded value (day, key, id)", name, self.max_series)
        return sink

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", scale: float = 1e6,
                  **labels) -> Histogram:
        return self._get("histogram", Histogram, name, help, labels,
                         scale=scale)

    def collect(self):
        """(name, kind, help, [metrics]) families, sorted by name —
        deterministic order keeps the exposition golden-testable."""
        with self._lock:
            metrics = list(self._metrics.values())
            families = dict(self._families)
        by_name: Dict[str, list] = {}
        for m in metrics:
            by_name.setdefault(m.name, []).append(m)
        out = []
        for name in sorted(by_name):
            kind, help = families[name]
            members = sorted(by_name[name], key=lambda m: m.labels)
            out.append((name, kind, help, members))
        return out
