"""On the card: each cell runs through the command as the benchmark's
check runs it, a short window, and comes out correct with its metrics.

    python3 -m pytest portbench/tests -m gpu
"""

import json
import subprocess
import sys

import pytest

from conftest import REPO
from portbench import registry


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_cells_on_the_card(card, trace):
    bench = registry.load_bench(REPO)
    for cell in bench["workloads"]:
        proc = subprocess.run(
            [sys.executable, "-m", "portbench", "--workload", cell["name"],
             "--seed", str(2**31 + 3), "--seconds", "2", "--trace",
             str(trace)], cwd=REPO, capture_output=True, text=True,
            timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]
        assert res["device"]["platform"] == "gpu"
        kind = "per_layer" if trace else "end_to_end"
        want = {m["name"] for m in registry.reported(bench, cell["name"],
                                                     kind)}
        assert set(res["metrics"]) <= want and res["metrics"]
        if trace:
            assert res["device"]["busy_s"] > 0
