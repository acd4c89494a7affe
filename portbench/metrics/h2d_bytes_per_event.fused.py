"""Host-to-device bytes an event: the bytes of every host-to-device
copy in the window's device trace, over the window's events (a count)."""


def read(src):
    trace = src.get("trace")
    if not trace or not src.get("events") or not trace["h2d_bytes"]:
        return None
    return trace["h2d_bytes"] / src["events"]
