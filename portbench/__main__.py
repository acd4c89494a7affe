"""``python3 -m portbench``: see ``portbench/run.py``.

Set-up is timed from here, before the heavy imports. The caches of
everything the run compiles sit at fixed paths inside the checkout, so
only a checkout's first run builds: the kernels (``build/kernels``,
where ``attendance_tpu_torch/ops/build.py`` puts them), the host pack
(``build/native``), and Triton's, PyTorch's extensions' and the CUDA
driver's caches, set here before PyTorch is imported.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_BUILD = Path(__file__).resolve().parents[1] / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(_BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_BUILD / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_BUILD / "cuda")

from portbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
