"""Tests of the benchmark harness. Those marked ``gpu`` need a CUDA
card and skip inside their fixture without one; the rest run on the
CPU at a tiny size:

    python3 -m pytest portbench/tests            # here, on the CPU
    python3 -m pytest portbench/tests -m gpu     # on the card
"""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda:0"


@pytest.fixture
def tiny_bench(tmp_path):
    """A checkout-like root in ``tmp_path`` with BENCHMARK.json and a copy
    of the benchmark's data files, plus two tiny cells added as new files
    and entries only: ``tiny.cell`` (the fused backlog) and ``tiny.proc``
    (the processor)."""
    pkg = tmp_path / "pkg"
    for kind in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "portbench" / kind, pkg / kind)
    cfg = json.loads((pkg / "configs" / "campus-100k.json").read_text())
    cfg.update(name="tiny", roster_size=2000, lecture_days=4)
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((pkg / "traffic" / "binary-131072.json").read_text())
    tr.update(name="tiny-4096", frame_events=4096, chunk_frames=4,
              warmup_frames=4, pool_min_bytes=8 * (8 + 17 * 4096),
              pool_llc_multiple=0)
    (pkg / "traffic" / "tiny-4096.json").write_text(json.dumps(tr))
    tj = json.loads((pkg / "traffic" / "json-8192.json").read_text())
    tj.update(name="tiny-json", batch_size=256, pool_messages=4096,
              chunk_batches=2, warmup_batches=2)
    (pkg / "traffic" / "tiny-json.json").write_text(json.dumps(tj))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    like = {"tiny.cell": "campus-100k.binary-backlog",
            "tiny.proc": "campus-100k.processor-json"}
    for name, traffic in (("tiny.cell", "tiny-4096"),
                          ("tiny.proc", "tiny-json")):
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "a CPU-sized cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for name, cell in like.items():
            if cell in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, pkg
