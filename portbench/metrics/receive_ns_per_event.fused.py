"""Transport: the broker's receive, host nanoseconds an event over the window.

From ``FusedMetrics.stage_seconds`` (the program's own host clock around
each stage of the run loop): stage ``receive``
(``transport/memory_broker.py`` through the chunk consumer)."""


def read(src):
    stages = src.get("stages")
    if not stages or not src.get("events"):
        return None
    seconds = sum(stages.get(s, 0.0) for s in ("receive",))
    return seconds / src["events"] * 1e9
