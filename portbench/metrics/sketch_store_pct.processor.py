"""The sketch store's share of the processor's wall, in percent: the
batched BF.EXISTS and PFADD calls (``device_seconds``, the card's
kernels included) over ``wall_seconds``, both summed over the window."""


def read(src):
    if not src.get("processor_wall_s"):
        return None
    return 100.0 * src["processor_device_s"] / src["processor_wall_s"]
