"""Run one cell of the benchmark once.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Earlier lines (standard error) say what the
run found: the CPU set, the card's clocks and power beside the window,
the pool and the wires. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, each number
compared with its limit, which also close standard error.

Without a CUDA card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, the run exits
non-zero and prints no result. It never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

from portbench import machine, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "attendance_tpu")
TRACE_WINDOW_S = 10.0


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``attendance_tpu_torch`` is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             pkg: Path = registry.PKG) -> Tuple[int, Optional[dict]]:
    """(exit code, result) of one run of ``workload``; the harness's
    look for a card is the caller's."""
    import torch

    bench = registry.load_bench(root)
    cell = registry.find_cell(bench, workload)
    config = registry.load_config(cell["config"], pkg)
    traffic = registry.load_traffic(cell["traffic"], pkg)
    cuda = device.startswith("cuda")
    pin = machine.pin_to_card(machine.bus_id(device) if cuda else "")
    log(f"cpus {pin}")
    llc = machine.llc_bytes()
    log(f"last-level cache {llc} bytes (None: sysfs does not list it)")
    driver = registry.load_driver(traffic)(config, traffic, seed, device,
                                           llc=llc)
    trace_path = (root / "build" / "portbench" / "trace.json"
                  if trace else None)
    log(f"imports and CUDA start {time.perf_counter() - t_start:.3f} s")
    log(f"set-up {driver.setup(trace_path)}")
    gc.collect()
    setup_s = time.perf_counter() - t_start
    smi_before = machine.smi_sample() if cuda else {}
    window_s = min(seconds, TRACE_WINDOW_S) if trace else seconds
    out = driver.window(window_s, trace_path)
    smi_after = machine.smi_sample() if cuda else {}
    log(f"nvidia-smi before the window {smi_before}")
    log(f"nvidia-smi after the window {smi_after}")
    log(f"window {out['window_s']:.6f} s {out['notes']}")
    log("window sources " + json.dumps(
        {k: v for k, v in out["sources"].items() if k != "trace"}))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t = time.perf_counter()
    checks = driver.verify()
    log(f"judged in {time.perf_counter() - t:.3f} s")
    driver.close()
    found = forbidden_modules()
    if found:
        log(f"refused: loaded {found}")
        return 3, None

    units = registry.units(bench)
    metrics: Dict[str, dict] = {}
    if not trace:
        for m in registry.reported(bench, workload, "end_to_end"):
            value = (setup_s if m["name"] == "setup_s"
                     else out["e2e"][m["name"]])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in registry.reported(bench, workload, "per_layer"):
            value = registry.load_metric(m["name"], pkg)(out["sources"])
            if value is not None:
                metrics[m["name"]] = {"value": value,
                                      "unit": units[m["name"]]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak),
           "power_limit": smi_before.get("power.limit")}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    summary = out["sources"].get("trace")
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = out["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return 0, result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = registry.find_cell(registry.load_bench(root), args.workload)

    import torch
    if not torch.cuda.is_available():
        log("refused: no CUDA card (torch.cuda.is_available() is False)")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"refused: {torch.cuda.device_count()} cards, the cell asks "
            f"for {cell['chips']}")
        return 2
    code, result = run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda:0", t_start)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
