"""The run loop's wait on the card before an ack, host nanoseconds an
event over the window.

From ``FusedMetrics.stage_seconds`` (the program's own host clock around
each stage of the run loop): stage ``ack_wait``
(``fast_path._drain_inflight``)."""


def read(src):
    stages = src.get("stages")
    if not stages or not src.get("events"):
        return None
    seconds = sum(stages.get(s, 0.0) for s in ("ack_wait",))
    return seconds / src["events"] * 1e9
