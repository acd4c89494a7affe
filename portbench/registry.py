"""Everything of a cell is found by its name in ``BENCHMARK.json``.

- a configuration ``<config>``: ``portbench/configs/<config>.json``;
- a traffic mix ``<traffic>``: ``portbench/traffic/<traffic>.json``, which
  names its generator (``portbench/generators/<generator>.py``) and its
  driver (``portbench/drivers/<driver>.py``);
- a per-layer metric ``<metric>``: ``portbench/metrics/<metric>.py``,
  whose ``read(sources)`` returns the value or None when the run gave it
  nothing to read.

A new cell, mix, configuration or metric is new files and new entries;
no file that exists needs an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

PKG = Path(__file__).resolve().parent


def load_bench(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, pkg: Path) -> dict:
    path = pkg / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    with open(path) as f:
        return json.load(f)


def load_config(name: str, pkg: Path = PKG) -> dict:
    return _json("configs", name, pkg)


def load_traffic(name: str, pkg: Path = PKG) -> dict:
    return _json("traffic", name, pkg)


def load_driver(traffic: dict):
    """The driver class the traffic mix names."""
    return importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").Driver


def load_metric(name: str, pkg: Path = PKG) -> Callable[[dict], object]:
    """The ``read`` function of a per-layer metric's own file."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no metric reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reported(bench: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it under ``workloads`` and, for a
    per-layer metric with no list, those whose ``moves`` the cell
    reports."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in reported(bench, cell, "end_to_end")}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def units(bench: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}
