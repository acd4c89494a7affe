"""Bounded, invariant-safe knobs — the only mutation surface the
controller has.

Counterpart of ``attendance_tpu/control/knobs.py`` (the same classes
and outcomes). A :class:`Knob` wraps one runtime-tunable parameter
behind a getter/setter pair plus a *safety envelope*: continuous knobs
clamp to ``[lo, hi]``; discrete knobs (``ladder=...``) accept ONLY
values from a pre-declared ladder and refuse anything else. The ladder
is how the shape-safety contract is enforced mechanically: a knob that
can change a launch shape (``dispatch_size``) declares the shapes the
launch-shape tracker (``obs/profiler.RecompileTracker``) has already
seen as its only legal values, so no controller policy — present or
future — can propose a shape the warm-up did not launch. Refusals are
first-class outcomes, not exceptions: the engine counts them
(``attendance_control_refused_total{knob=}``) and the
zero-steady-recompile doctor gate backstops the whole contract.

Knobs are deliberately pure (no registry, no locks, no clock) so the
state-machine tests can exercise bounds/ladder behaviour without a
pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

# Outcomes of a proposal, in the actuation record's ``outcome`` field.
APPLIED = "applied"      # set() ran with the requested value
CLAMPED = "clamped"      # set() ran, but with the bound-clamped value
REFUSED = "refused"      # out-of-ladder proposal; set() did NOT run
NOOP = "noop"            # proposal equals current value; set() did not run


@dataclass
class Proposal:
    """Result of one :meth:`Knob.propose` — everything the actuation
    record needs about what was asked vs. what happened."""
    knob: str
    requested: Any
    previous: Any
    applied: Optional[Any]   # None when refused / noop
    outcome: str             # APPLIED | CLAMPED | REFUSED | NOOP

    @property
    def changed(self) -> bool:
        return self.outcome in (APPLIED, CLAMPED)


class Knob:
    """One bounded runtime parameter.

    ``ladder`` (when given) is the exhaustive set of legal values —
    proposals outside it are REFUSED, never rounded, because silently
    substituting a "nearby" shape is exactly the kind of helpfulness
    that would let an unseen launch shape sneak past the recompile
    gate.  ``lo``/``hi`` clamp continuous knobs instead.
    """

    def __init__(self, name: str, getter: Callable[[], Any],
                 setter: Callable[[Any], None], *,
                 lo: Optional[float] = None, hi: Optional[float] = None,
                 ladder: Optional[Sequence[Any]] = None,
                 shape_safe: bool = False):
        if ladder is not None and not len(ladder):
            raise ValueError(f"knob {name!r}: empty ladder")
        if shape_safe and ladder is None:
            raise ValueError(
                f"knob {name!r}: shape-affecting knobs must declare a "
                "pre-warmed ladder — continuous mutation of a dispatch "
                "shape cannot be recompile-safe")
        self.name = name
        self._get = getter
        self._set = setter
        self.lo = lo
        self.hi = hi
        self.ladder: Optional[Tuple[Any, ...]] = (
            tuple(ladder) if ladder is not None else None)
        self.shape_safe = shape_safe
        self.refused_total = 0
        self.clamped_total = 0
        self.applied_total = 0

    # -- state ---------------------------------------------------------------
    @property
    def value(self) -> Any:
        return self._get()

    def step(self, direction: int) -> Optional[Any]:
        """Neighbouring ladder value (None at the ladder's edge, or for
        continuous knobs / current values that fell off the ladder)."""
        if self.ladder is None:
            return None
        cur = self._get()
        try:
            i = self.ladder.index(cur)
        except ValueError:
            return None
        j = i + (1 if direction > 0 else -1)
        if j < 0 or j >= len(self.ladder):
            return None
        return self.ladder[j]

    # -- mutation ------------------------------------------------------------
    def propose(self, value: Any) -> Proposal:
        previous = self._get()
        if self.ladder is not None:
            if value not in self.ladder:
                self.refused_total += 1
                return Proposal(self.name, value, previous, None, REFUSED)
            applied = value
            outcome = APPLIED
        else:
            applied = value
            outcome = APPLIED
            if self.lo is not None and applied < self.lo:
                applied, outcome = self.lo, CLAMPED
            if self.hi is not None and applied > self.hi:
                applied, outcome = self.hi, CLAMPED
        if applied == previous:
            return Proposal(self.name, value, previous, None, NOOP)
        self._set(applied)
        if outcome == CLAMPED:
            self.clamped_total += 1
        self.applied_total += 1
        return Proposal(self.name, value, previous, applied, outcome)


class KnobBoard:
    """The controller's registry of bound knobs (built at attach time —
    which knobs exist depends on what the pipeline actually runs)."""

    def __init__(self) -> None:
        self._knobs: Dict[str, Knob] = {}

    def add(self, knob: Knob) -> Knob:
        if knob.name in self._knobs:
            raise ValueError(f"duplicate knob {knob.name!r}")
        self._knobs[knob.name] = knob
        return knob

    def get(self, name: str) -> Optional[Knob]:
        return self._knobs.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._knobs

    def __iter__(self):
        return iter(self._knobs.values())

    def propose(self, name: str, value: Any) -> Optional[Proposal]:
        knob = self._knobs.get(name)
        if knob is None:
            return None
        return knob.propose(value)
