"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (as the CPU tests do). With no card and no explicit
device they raise: the port never drops to the CPU quietly.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device to run on: ``device`` if given (a CUDA device without
    an index is the current card), else the current CUDA card. Raises
    RuntimeError when a CUDA device is asked for (or defaulted to) and
    none is available."""
    if device is not None:
        dev = torch.device(device)
    elif torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type == "cuda" and dev.index is None:
        # The card current now: a worker thread (the snapshot writer)
        # sets it by index before touching a stream.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(arr: np.ndarray, device: torch.device
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(tensor on ``device``, pinned host copy or None) of a host array.
    On the card the copy is asynchronous from pinned memory; the pinned
    tensor must stay referenced until the work reading it is done. A
    read-only array (a view of a frame's bytes) is copied first: torch
    does not wrap read-only memory."""
    host = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if device.type == "cpu":
        return host, None
    pinned = host.pin_memory()
    return pinned.to(device, non_blocking=True), pinned
