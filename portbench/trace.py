"""The device trace of a window: ``torch.profiler`` with CUDA activity.

The profiler records the card's kernels, copies and memsets and the
host's CUDA runtime and driver calls (no CPU operator events, which
would add host cost to every PyTorch call of the program). The trace is
written as Chrome-trace JSON to a fixed file inside the checkout, read
back and deleted. From it come:

- ``busy_s``: the union of kernel, copy and memset intervals;
- ``kernel_s``: the summed time of the kernels, whatever their names;
- ``h2d_bytes``: the bytes of the host-to-device copies;
- ``device_ops``: device time by operation name;
- ``idle_gaps``: the time between device operations, split by the
  runtime or driver call the host was in, the rest as
  ``host_outside_CUDA_calls``.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: List[dict]) -> Dict[str, object]:
    """Reduce Chrome-trace events (times in microseconds) to the
    window's device numbers (seconds and bytes)."""
    dev, host = [], []
    ops: Dict[str, float] = defaultdict(float)
    kernel_us = 0.0
    h2d = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            ops[e["name"]] += dur
            if cat == "kernel":
                kernel_us += dur
            elif "HtoD" in e["name"]:
                h2d += int(e.get("args", {}).get("bytes", 0))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e["name"]))
    busy = _union(dev)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy and host:
        first = min(h[0] for h in host)
        last = max(h[1] for h in host)
        if first < busy[0][0]:
            gaps.insert(0, (first, busy[0][0]))
        if last > busy[-1][1]:
            gaps.append((busy[-1][1], last))
    idle: Dict[str, float] = defaultdict(float)
    host.sort()
    j = 0
    for a, b in gaps:
        while j < len(host) and host[j][1] <= a:
            j += 1
        covered = []
        k = j
        while k < len(host) and host[k][0] < b:
            lo, hi = max(a, host[k][0]), min(b, host[k][1])
            if hi > lo:
                idle[host[k][2]] += hi - lo
                covered.append((lo, hi))
            k += 1
        inside = sum(hi - lo for lo, hi in _union(covered))
        idle["host_outside_CUDA_calls"] += (b - a) - inside
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "h2d_bytes": h2d,
        "device_ops": [[n, v / 1e6] for n, v in top],
        "idle_gaps": [[n, v / 1e6] for n, v in top_idle],
        "device_events": len(dev),
    }


def traced(fn: Callable[[], object], path: Path):
    """(fn's result, the trace summary) of ``fn`` run under the
    profiler; the profiler starts before and stops after ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    return result, summarize(events)
