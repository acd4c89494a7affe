"""portbench: the benchmark of ``attendance_tpu_torch`` on one NVIDIA H100.

One command runs one cell once (``python3 -m portbench --workload ...``,
see ``portbench/run.py``). Cells, configurations, traffic mixes and
per-layer metrics are found by name (``portbench/registry.py``). The
plain reference that decides ``correct`` is ``portbench/reference.py``.
Nothing here imports JAX or the JAX package.
"""
