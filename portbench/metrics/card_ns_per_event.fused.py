"""Card nanoseconds an event: the union of kernels, copies and memsets
in the traced window, over the window's events."""


def read(src):
    trace = src.get("trace")
    if not trace or not trace["device_events"] or not src.get("events"):
        return None
    return trace["busy_s"] / src["events"] * 1e9
