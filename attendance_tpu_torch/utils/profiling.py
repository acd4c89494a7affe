"""Flag-gated ``torch.profiler`` hooks (``--profile-dir``).

Counterpart of ``attendance_tpu/utils/profiling.py``, whose
``jax.profiler`` trace becomes a ``torch.profiler`` trace here. When
``--profile-dir`` is set the processing run is wrapped in
:func:`maybe_trace`: CPU activity, plus CUDA activity when the run's
device is a card (CUPTI's kernel records, so the hand-written kernels
launched through ctypes show as device kernel events), exported as one
Chrome-trace JSON, :data:`TRACE_FILE` under the directory (each traced
run replaces the last one's); a card trace's JSON also holds, under
:data:`LAUNCHES_KEY`, the kernel launches made inside it. Each device dispatch carries a
:func:`maybe_annotate` range so kernel time attributes to pipeline
stages, and :func:`annotate_trace` names a traced batch's range after
its span tracer trace id. With the flag unset every hook is a
``nullcontext``: nothing is imported, nothing is timed, the hot loop
pays one branch.

On a card the trace records CUDA activity or raises: a build of PyTorch
whose profiler cannot trace the card is refused up front, and a traced
run that launched kernels yet exported no device kernel event raises
when the trace closes. A CPU-only trace of a card run would hide exactly
what the flag was set to see.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Optional

TRACE_FILE = "torch_trace.json"

# The top-level key of a card trace's JSON that holds the kernel
# launches (``ops.kernels.launches`` counts) made inside the trace: what
# its device kernel events must account for (``kernel_launch_shortfall``).
LAUNCHES_KEY = "attendanceLaunches"


def _launches() -> dict:
    from attendance_tpu_torch.ops.kernels import launches
    return dict(launches)


def trace_launches(doc: dict) -> dict:
    """The kernel launches made inside a card trace, from its exported
    JSON (empty for a CPU trace)."""
    return dict(doc.get(LAUNCHES_KEY, {}))


def kernel_events(doc: dict) -> list:
    """The device kernel events of an exported Chrome trace (not the
    runtime API rows that launch them)."""
    return [e for e in doc.get("traceEvents", [])
            if e.get("cat") == "kernel" and e.get("ph") == "X"]


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(doc: dict) -> list:
    """The events of an exported Chrome trace that occupy the card:
    kernels, copies and memsets (:data:`DEVICE_CATEGORIES`)."""
    return [e for e in doc.get("traceEvents", [])
            if e.get("cat") in DEVICE_CATEGORIES and e.get("ph") == "X"]


def busy_seconds(events: list) -> float:
    """The union of the events' ``[ts, ts + dur]`` intervals, in seconds
    (trace times are microseconds): time in which at least one of them
    ran, with overlaps counted once."""
    total, end = 0.0, None
    for ts, dur in sorted((e["ts"], e.get("dur", 0.0)) for e in events):
        if end is None or ts > end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total / 1e6


def range_count(doc: dict, name: str) -> int:
    """How many host ranges named ``name`` (``record_function``) an
    exported trace holds; the device-side copy a CUDA trace adds for
    each (category ``gpu_user_annotation``) is not counted."""
    return sum(1 for e in doc.get("traceEvents", [])
               if e.get("name") == name and e.get("ph") == "X"
               and e.get("cat") == "user_annotation")


def kernel_function(name: str) -> str:
    """A kernel event's function name without its namespaces, return
    type, template arguments and parameters, from a demangled name
    (``void (anonymous namespace)::fused_step_kernel<...>(...)``) or an
    Itanium-mangled one (``_ZN12_GLOBAL__N_117fused_step_kernelI...``):
    ``fused_step_kernel``."""
    if name.startswith("_Z"):
        i = 3 if name.startswith("_ZN") else 2
        last = ""
        while i < len(name) and name[i].isdigit():
            j = i
            while j < len(name) and name[j].isdigit():
                j += 1
            n = int(name[i:j])
            last, i = name[j:j + n], j + n
        return last
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        name = name.split(stop, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


def _launch_groups(functions: dict) -> list:
    """The launch keys of ``functions`` ({key: its ``__global__``
    names}) grouped so that keys sharing a function share a group:
    [(keys, function names)], each group closed under shared names."""
    groups: list = []
    for key, fns in functions.items():
        keys, names = {key}, set(fns)
        for g in [g for g in groups if g[1] & names]:
            groups.remove(g)
            keys |= g[0]
            names |= g[1]
        groups.append((keys, names))
    return groups


def kernel_launch_shortfall(doc: dict, launched: dict) -> dict:
    """{launch keys: (launches, kernel events)} for every group of
    ``launched``'s keys (``ops.kernels.launches`` counts) whose summed
    launches exceed the trace's device kernel events of the
    ``__global__`` functions they launch (``ops.kernels.
    KERNEL_FUNCTIONS``); empty when the trace holds at least one kernel
    event for each launch. Keys that share a function
    (``hll_histogram`` and ``hll_histogram_rows``, say) are one group,
    so that one event never covers the launches of two keys; a group is
    named by its keys that launched, joined by ``+``."""
    from attendance_tpu_torch.ops.kernels import KERNEL_FUNCTIONS

    seen: dict = {}
    for e in kernel_events(doc):
        fn = kernel_function(e.get("name", ""))
        seen[fn] = seen.get(fn, 0) + 1
    short = {}
    for keys, names in _launch_groups(KERNEL_FUNCTIONS):
        live = sorted(k for k in keys if launched.get(k, 0) > 0)
        n = sum(launched[k] for k in live)
        got = sum(seen.get(fn, 0) for fn in names)
        if n > got:
            short["+".join(live)] = (n, got)
    return short


@contextlib.contextmanager
def _trace(profile_dir: str, device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError(
                "--profile-dir on a CUDA device needs CUDA activity, which "
                "this torch.profiler does not support")
        activities.append(ProfilerActivity.CUDA)
    root = Path(profile_dir)
    root.mkdir(parents=True, exist_ok=True)
    before = _launches() if cuda else {}
    with profile(activities=activities) as prof:
        yield prof
    path = root / TRACE_FILE
    prof.export_chrome_trace(str(path))
    if cuda:
        after = _launches()
        doc = json.loads(path.read_text())
        doc[LAUNCHES_KEY] = {k: after[k] - before.get(k, 0) for k in after}
        path.write_text(json.dumps(doc))
        if sum(doc[LAUNCHES_KEY].values()) and not kernel_events(doc):
            raise RuntimeError(
                f"the trace at {path} holds no CUDA kernel event, yet the "
                "run launched kernels: the profiler did not see the card")


def maybe_trace(profile_dir: Optional[str], device=None):
    """A ``torch.profiler`` trace of the block into ``profile_dir`` when
    set (CUDA activity too when ``device`` is a card), else a
    nullcontext."""
    if not profile_dir:
        return contextlib.nullcontext()
    return _trace(str(profile_dir), device)


def maybe_annotate(enabled: bool, name: str):
    """``torch.profiler.record_function(name)`` when profiling, else a
    nullcontext (a record_function costs a range even with no active
    trace, so the hot loop skips it when the flag is off)."""
    if not enabled:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def annotate_trace(enabled: bool, span):
    """The span tracer's trace id on one batch's range of a profile
    trace, so a profile timeline slice and a ``--trace-out`` span tree
    name the same trace. A nullcontext unless both a profile run and a
    traced batch are active."""
    if not enabled or span is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(f"trace:{span.trace_id:016x}")
