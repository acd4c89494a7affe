"""attendance_tpu_torch.control — the self-driving control plane.

Counterpart of ``attendance_tpu/control``: closes the sense->act loop.
The observability plane (SLO burn rates, lane skew, staleness,
attribution, incidents) already sees every failure mode; this package
gives the process bounded, logged, hysteresis-guarded ways to RESPOND —
ingress admission control, a graceful-degradation ladder, dynamic lane
scaling, snapshot-cadence and watermark adaptation — all under the
standing invariants: no acked-event loss, state equal to an
uncontrolled run over the same acked frames, zero steady-state launch
shapes after warm-up (shape actuations pick only from a ladder of
shapes a warm run has launched), bounded flapping.

Enabled by ``--control-log PATH`` (the schema'd JSONL actuation log is
the plane's defining artifact; ``doctor --actuations`` replays it).
"""

from attendance_tpu_torch.control.actuation import (
    ACTUATION_SCHEMA, ActuationLog, actuation_report, read_actuations,
    validate_actuation)
from attendance_tpu_torch.control.engine import (
    ADVISORY_ACTIONS, ControlEngine, IngressAdmission)
from attendance_tpu_torch.control.knobs import Knob, KnobBoard, Proposal
from attendance_tpu_torch.control.ladder import RUNGS, DegradationLadder

__all__ = [
    "ACTUATION_SCHEMA", "ADVISORY_ACTIONS", "ActuationLog",
    "ControlEngine", "DegradationLadder", "IngressAdmission", "Knob",
    "KnobBoard", "Proposal", "RUNGS", "actuation_report",
    "read_actuations", "validate_actuation",
]
