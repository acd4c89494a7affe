"""Day map and host pack, host nanoseconds an event over the window.

From ``FusedMetrics.stage_seconds`` (the program's own host clock around
each stage of the run loop): stages ``pack`` and ``bank_map``
(``fast_path._dispatch_single``, ``native/hostpipe.c``)."""


def read(src):
    stages = src.get("stages")
    if not stages or not src.get("events"):
        return None
    seconds = sum(stages.get(s, 0.0) for s in ("pack", "bank_map"))
    return seconds / src["events"] * 1e9
