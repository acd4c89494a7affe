"""The processor's host nanoseconds an event: its own wall time
(``ProcessorMetrics.wall_seconds``, summed over the window's runs) less
the batched sketch calls' (``device_seconds``), over the window's
events. Decode, rows, the store and the acks are the rest."""


def read(src):
    if not src.get("events") or "processor_wall_s" not in src:
        return None
    host = src["processor_wall_s"] - src["processor_device_s"]
    return host / src["events"] * 1e9
