"""The card's peaks and the least bytes of the fused step.

Peaks are NVIDIA's data sheet for one H100 SXM (80 GB HBM3): the rates
assume the full 700 W power limit, so a share is stated beside the
card's limit as ``nvidia-smi`` reads it.

The fused step validates each swipe against the roster filter and
max-merges the valid ones into their day's registers. The least DRAM
traffic a frame needs is its wire in, the validity out, and the filter
and the registers once each, as far as the frame's own keys touch them:
each distinct 64-byte filter block its swipes probe and each distinct
32-byte register sector its valid swipes update, counted by the plain
reference from the frame's keys. The wire bytes are measured (the
trace's host-to-device copies).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FILTER_BLOCK_BYTES = 64
SECTOR_BYTES = 32


def step_state_bytes(blocks: int, sectors: int, events: int) -> int:
    """Least bytes of one frame's step besides its wire: the distinct
    filter blocks and register sectors it touches, read once, and one
    validity byte an event written."""
    return FILTER_BLOCK_BYTES * blocks + SECTOR_BYTES * sectors + events
