"""Drivers: how a traffic mix drives the program. A traffic file names
its driver (``portbench/drivers/<driver>.py``), whose ``Driver`` sets the
cell up, runs the window and judges the outputs."""

from typing import List

import numpy as np


def chunk_quartiles(chunks: List[float]) -> List[float]:
    """Min, quartiles and max of the window's chunk times: whether a run
    is slow all through or in bursts."""
    q = np.quantile(chunks, [0, 0.25, 0.5, 0.75, 1]) if chunks else []
    return [round(float(x), 6) for x in q]
