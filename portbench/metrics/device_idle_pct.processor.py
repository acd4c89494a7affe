"""The card's idle share of the traced window, in percent: one minus
the union of kernels, copies and memsets over the window's host-clock
length."""


def read(src):
    trace = src.get("trace")
    if not trace or not trace["device_events"] or not src.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / src["window_s"])
