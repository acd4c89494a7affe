"""Graceful-degradation ladder — the ordered modes the pipeline may
occupy under pressure, and the hysteresis that keeps it from thrashing
between them.

Counterpart of ``attendance_tpu/control/ladder.py``: the same rungs and
the same transitions, tick for tick.

Rungs (escalation order; each keeps every invariant the rung below it
keeps, trading progressively more observability/latency for headroom):

  0  normal           everything at configured values
  1  audit_wide       audit shadow samples every Nth frame instead of
                      every frame (accuracy plane thins, never lies)
  2  snap_stretch     snapshot cadence stretched (fewer durability
                      barriers; acks batch up but nothing is lost)
  3  temporal_pause   temporal host passes paused (windowed analytics
                      go stale; core marking unaffected)
  4  shed             ingress admission closes: frames spill durably
                      (or nack back to the broker) at the producer edge

Transitions are MONOTONIC (one rung at a time, both directions), gated
by per-rung dwell-time minimums, escalate/clear tick streaks, and a
transitions-per-minute flap limit.  The ladder is a pure state machine
with an injected clock so tests drive it deterministically; the engine
owns mapping rungs to knob values.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Optional

RUNGS = ("normal", "audit_wide", "snap_stretch", "temporal_pause", "shed")


class DegradationLadder:
    """Hysteresis-guarded rung selector."""

    def __init__(self, *, dwell_s: float = 2.0, escalate_ticks: int = 2,
                 clear_ticks: int = 3, max_rung: int = len(RUNGS) - 1,
                 flap_limit: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if dwell_s <= 0:
            raise ValueError("dwell_s must be > 0")
        if escalate_ticks < 1 or clear_ticks < 1:
            raise ValueError("tick streaks must be >= 1")
        self.dwell_s = float(dwell_s)
        self.escalate_ticks = int(escalate_ticks)
        self.clear_ticks = int(clear_ticks)
        self.max_rung = min(int(max_rung), len(RUNGS) - 1)
        self.flap_limit = int(flap_limit)
        self._clock = clock
        self.rung = 0
        self._pressure_streak = 0
        self._clean_streak = 0
        # First transition needs no dwell: the ladder starts "settled".
        self._last_change = self._clock() - self.dwell_s
        self._transitions: Deque[float] = deque()
        self.flap_holds = 0
        self.transitions_total = 0

    @property
    def mode(self) -> str:
        return RUNGS[self.rung]

    def _flap_capped(self, now: float) -> bool:
        while self._transitions and now - self._transitions[0] > 60.0:
            self._transitions.popleft()
        return len(self._transitions) >= self.flap_limit

    def tick(self, pressure: bool, now: Optional[float] = None
             ) -> Optional[int]:
        """One controller tick; returns the new rung on a transition,
        None otherwise."""
        if now is None:
            now = self._clock()
        if pressure:
            self._pressure_streak += 1
            self._clean_streak = 0
        else:
            self._clean_streak += 1
            self._pressure_streak = 0
        want_up = (pressure
                   and self._pressure_streak >= self.escalate_ticks
                   and self.rung < self.max_rung)
        want_down = (not pressure
                     and self._clean_streak >= self.clear_ticks
                     and self.rung > 0)
        if not (want_up or want_down):
            return None
        if now - self._last_change < self.dwell_s:
            return None
        if self._flap_capped(now):
            self.flap_holds += 1
            return None
        self.rung += 1 if want_up else -1
        self._last_change = now
        self._transitions.append(now)
        self.transitions_total += 1
        # A transition consumes its streak: the NEXT move needs a fresh
        # run of pressure/clean ticks, on top of the dwell minimum.
        self._pressure_streak = 0
        self._clean_streak = 0
        return self.rung
