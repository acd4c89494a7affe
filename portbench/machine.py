"""What the harness reads and sets about the machine it runs on.

Read only: the card's name, clocks and power from ``nvidia-smi``, the
CPUs local to the card and the size of the last-level cache from sysfs.
The one thing set is this process's own CPU affinity.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm",
              "clocks.mem", "temperature.gpu")


def smi_sample() -> Dict[str, str]:
    """One ``nvidia-smi`` reading of card 0 (empty when the tool is
    missing or fails)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0",
             "--query-gpu=" + ",".join(SMI_FIELDS),
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if out.returncode != 0 or not out.stdout.strip():
        return {}
    values = [v.strip() for v in out.stdout.strip().splitlines()[0]
              .split(",")]
    return dict(zip(SMI_FIELDS, values))


def _parse_cpulist(text: str) -> List[int]:
    cpus: List[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.extend(range(int(lo), int(hi or lo) + 1))
    return cpus


def card_cpus(bus: str) -> Optional[List[int]]:
    """The CPUs sysfs lists as local to the card at ``bus``, or None
    when sysfs does not say."""
    if not bus:
        return None
    path = Path(f"/sys/bus/pci/devices/{bus}/local_cpulist")
    try:
        return _parse_cpulist(path.read_text())
    except (OSError, ValueError):
        return None


def bus_id(device) -> str:
    """The card's PCI address as sysfs names it (``0000:cb:00.0``), from
    the CUDA device properties."""
    import torch
    p = torch.cuda.get_device_properties(device)
    return (f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:"
            f"{p.pci_device_id:02x}.0")


def pin_to_card(bus: str) -> Dict[str, object]:
    """Pin this process to the card's local CPUs that it may run on;
    returns what was found and the CPU set it runs on."""
    allowed = sorted(os.sched_getaffinity(0))
    local = card_cpus(bus)
    chosen = sorted(set(local) & set(allowed)) if local else []
    if chosen and chosen != allowed:
        os.sched_setaffinity(0, chosen)
    return {"bus": bus, "local_cpulist": local, "allowed": allowed,
            "cpus": sorted(os.sched_getaffinity(0))}


def llc_bytes() -> Optional[int]:
    """Size of cpu0's last-level cache from sysfs, None when unlisted."""
    best = None
    for d in Path("/sys/devices/system/cpu/cpu0/cache").glob("index*"):
        try:
            level = int((d / "level").read_text())
            size = (d / "size").read_text().strip().upper()
        except (OSError, ValueError):
            continue
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}.get(size[-1:], 1)
        num = int(size.rstrip("KMG")) * mult
        if best is None or level > best[0]:
            best = (level, num)
    return None if best is None else best[1]
