"""Deadline + exponential-backoff-with-jitter retry for broker RPCs.

Counterpart of ``attendance_tpu/transport/resilience.py``. Every socket
RPC routes through
:func:`resilient_call`: a transient transport failure reconnects and
retries with jittered backoff, and a broker that stays unreachable fails
with one :class:`BrokerUnavailable` after the configured budget (a
``ConnectionError``, so callers that handled the raw error still do).
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple

logger = logging.getLogger(__name__)


class BrokerUnavailable(ConnectionError):
    """The broker stayed unreachable for the whole retry budget."""


class ChaosDrop(ConnectionError):
    """Injected request loss (``drop``): the request was never sent, so
    a plain retry is always safe."""


# What a retry may safely swallow: transport-level failures (the request
# may or may not have executed — every broker op is safe to repeat:
# publishes duplicate into idempotent sinks, receives requeue via
# connection-drop takeover, acks/nacks of unknown ids are no-ops).
TRANSIENT_ERRORS = (ConnectionError, OSError, TimeoutError)


class RetryPolicy:
    """Deadline + backoff shape for one logical RPC."""

    __slots__ = ("budget_s", "base_s", "cap_s", "multiplier")

    def __init__(self, budget_s: float = 15.0, base_s: float = 0.05,
                 cap_s: float = 2.0, multiplier: float = 2.0):
        self.budget_s = budget_s
        self.base_s = base_s
        self.cap_s = cap_s
        self.multiplier = multiplier

    @classmethod
    def from_config(cls, config) -> "RetryPolicy":
        return cls(budget_s=getattr(config, "retry_budget_s", 15.0))

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter exponential backoff for the Nth retry (1-based):
        uniform in (0, min(cap, base * multiplier**(n-1))] — the AWS
        full-jitter shape, which decorrelates competing retriers."""
        ceiling = min(self.cap_s,
                      self.base_s * self.multiplier ** (attempt - 1))
        return random.random() * ceiling or 1e-4


def _note_retry(site: str, attempt: int, exc: BaseException,
                t0: float) -> None:
    """One retry's telemetry: a counter and, with tracing, an
    ``rpc_retry`` span. Resolved on each call: retries are rare, so the
    hot path carries no handle."""
    from attendance_tpu_torch import obs

    t = obs.get()
    if t is None:
        return
    t.registry.counter(
        "attendance_retry_attempts_total",
        help="Broker RPC retries after a transient failure",
        site=site).inc()
    tracer = t.tracer
    if tracer is not None:
        cur = tracer.current()
        tracer.add_span(
            "rpc_retry", t0, time.perf_counter(),
            trace_id=cur.trace_id if cur is not None else tracer.new_id(),
            parent_id=cur.span_id if cur is not None else None,
            role="transport",
            args={"site": site, "attempt": attempt,
                  "error": type(exc).__name__})


def note_reconnect(site: str = "socket") -> None:
    """Count one transport reconnect (cold path)."""
    from attendance_tpu_torch import obs

    t = obs.get()
    if t is not None:
        t.registry.counter(
            "attendance_reconnects_total",
            help="Broker transport reconnects (incl. session resume)",
        ).inc()


def resilient_call(rpc, op_body: Callable[[], Tuple[int, bytes]], *,
                   site: str, policy: RetryPolicy,
                   ensure_session: Optional[Callable[[], None]] = None,
                   aborted: Optional[Callable[[], bool]] = None
                   ) -> Tuple[int, bytes]:
    """One logical RPC with transparent reconnect + bounded retry.

    ``op_body()`` builds ``(opcode, body)`` fresh per attempt (a
    consumer's body embeds its CURRENT handle, which a session resume
    replaces); ``ensure_session`` runs before each attempt and may
    itself RPC (re-subscribe after a reconnect — its transient failures
    are retried like the call's own). ``aborted`` short-circuits the
    loop when the caller was closed underneath a parked retry (clean
    shutdown must not burn the whole budget reconnecting to a broker
    that was torn down on purpose).
    """
    deadline = time.monotonic() + policy.budget_s
    attempt = 0
    while True:
        try:
            if rpc.broken:
                rpc.reconnect()
            if ensure_session is not None:
                ensure_session()
            return rpc.call(*op_body())
        except TRANSIENT_ERRORS as exc:
            attempt += 1
            t0 = time.perf_counter()
            if aborted is not None and aborted():
                raise
            now = time.monotonic()
            if now >= deadline:
                raise BrokerUnavailable(
                    f"broker RPC at {site!r} failed after {attempt} "
                    f"attempts over {policy.budget_s:.1f}s: {exc!r}"
                ) from exc
            if attempt == 1:
                logger.debug("transient broker failure at %s: %r "
                             "(retrying)", site, exc)
            time.sleep(min(policy.backoff_s(attempt), deadline - now))
            _note_retry(site, attempt, exc, t0)
