"""The fused step's share of its roofline, in percent.

The least time is the least bytes of the window's frames at the HBM
peak (``portbench/roofline.py``): the wire in, as the trace's
host-to-device copies measured it, and for each frame the filter blocks
and register sectors its keys touch and its validity out. It is divided by the
device time of every kernel in the window, whatever their names, so a
step that is fused or replaced reads against the same work."""

from portbench.roofline import HBM_BYTES_PER_S


def read(src):
    trace = src.get("trace")
    if not trace or not trace["kernel_s"] or not src.get("state_bytes"):
        return None
    least = trace["h2d_bytes"] + src["state_bytes"]
    return 100.0 * least / HBM_BYTES_PER_S / trace["kernel_s"]
