"""The control: the comparison that decides ``correct`` has to fail it.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 3

For each seed, drives the cell's set-up and a short window of the
program at the cell's own size, then judges the control in the
program's place: the plain reference with one probe fewer a key
(``k - 1``), the cheaper filter a later change might be tempted by,
which breaks the configuration's stated error rate and with it the
validity of the swipes it lets through. The program's own numbers are
judged beside it. One JSON line a seed; the benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

from portbench import reference, registry


def judge(root: Path, workload: str, seed: int, seconds: float,
          device: str, pkg: Path = registry.PKG) -> dict:
    bench = registry.load_bench(root)
    cell = registry.find_cell(bench, workload)
    config = registry.load_config(cell["config"], pkg)
    traffic = registry.load_traffic(cell["traffic"], pkg)
    driver = registry.load_driver(traffic)(config, traffic, seed, device)
    driver.setup()
    out = driver.window(seconds)
    k = reference.filter_params(config["roster_size"],
                                config["bloom_error_rate"],
                                driver.layout).k
    t = time.perf_counter()
    program = driver.verify()
    ref_s = time.perf_counter() - t
    control = driver.verify(control_probes=k - 1)
    driver.close()
    return {"workload": workload, "seed": seed,
            "events": out["attempted"], "window_s": out["window_s"],
            "reference_s": ref_s, "program": program,
            "control": control, "control_probes": k - 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(judge(Path.cwd(), args.workload, seed,
                               args.seconds, "cuda:0")), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
