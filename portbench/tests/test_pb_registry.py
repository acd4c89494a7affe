"""Cells, configurations, mixes and metrics are found by name, and new
files add a cell without an edit to any file that exists."""

import json
import re
import time

from conftest import REPO
from portbench import registry
from portbench.run import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench():
    return registry.load_bench(REPO)


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == KEYS
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"] + b["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert len(c["source"]) <= 200 and c["source"].startswith("https://")
    for cell in b["workloads"]:
        assert cell["chips"] == 1 and len(cell["why"]) <= 200


def test_every_cell_resolves_by_name():
    b = bench()
    for cell in b["workloads"]:
        config = registry.load_config(cell["config"])
        traffic = registry.load_traffic(cell["traffic"])
        assert config["name"] == cell["config"]
        assert traffic["name"] == cell["traffic"]
        assert registry.load_driver(traffic).e2e in e2e_names(b, cell)
        per_layer = registry.reported(b, cell["name"], "per_layer")
        assert per_layer and len(e2e_names(b, cell)) >= 2
        for m in per_layer:
            assert callable(registry.load_metric(m["name"]))
            assert m["moves"] in e2e_names(b, cell)


def e2e_names(b, cell):
    return {m["name"] for m in registry.reported(b, cell["name"],
                                                 "end_to_end")}


def test_metric_readers_return_nothing_without_sources():
    for m in bench()["per_layer"]:
        assert registry.load_metric(m["name"])({}) is None


def test_new_files_add_a_cell_without_an_edit(tiny_bench):
    root, pkg = tiny_bench
    (pkg / "metrics" / "frames_seen.tiny.py").write_text(
        "def read(src):\n    return src.get('frames') or None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({
        "name": "frames_seen.tiny", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "run loop and acks",
        "moves": "events_per_s", "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    code, res = run_cell(root, "tiny.cell", 7, 0.3, False, "cpu",
                         time.perf_counter(), pkg=pkg)
    assert code == 0 and res["correct"]
    assert set(res["metrics"]) == {"events_per_s", "setup_s"}
    assert res["metrics"]["events_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    names = [m["name"] for m in registry.reported(b, "tiny.cell",
                                                  "per_layer")]
    assert "frames_seen.tiny" in names
    assert registry.load_metric("frames_seen.tiny", pkg)(
        {"frames": 3}) == 3
