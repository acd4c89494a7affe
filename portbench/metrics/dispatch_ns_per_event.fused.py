"""H2D copy and launch, host nanoseconds an event over the window.

From ``FusedMetrics.stage_seconds`` (the program's own host clock around
each stage of the run loop): stage ``dispatch`` (``device.to_device``
and the step's launch)."""


def read(src):
    stages = src.get("stages")
    if not stages or not src.get("events"):
        return None
    seconds = sum(stages.get(s, 0.0) for s in ("dispatch",))
    return seconds / src["events"] * 1e9
