"""Redis-command-compatible sketch store facade.

Counterpart of ``attendance_tpu/sketch``. The reference talks to its
sketches only through redis-py call shapes:
``execute_command('BF.ADD'|'BF.EXISTS'|'BF.RESERVE', ...)``, ``pfadd``,
``pfcount``. This package keeps those call shapes across four backends
selected by ``--sketch-backend``:

  * "tpu"       the card store: sketches on the CUDA card, one kernel
                per micro-batch (the flag keeps the JAX package's name)
  * "memory"    host numpy sketches with the same hashing (hermetic
                tests, and an oracle for the card store)
  * "redis"     real Redis Stack via redis-py (import-gated)
  * "redis-sim" hermetic simulation of Redis's own algorithms, the
                server-free parity oracle
"""

from attendance_tpu_torch.sketch.base import (  # noqa: F401
    ResponseError, SketchStore, member_to_u32, members_to_u32)
from attendance_tpu_torch.sketch.memory_store import (  # noqa: F401
    MemorySketchStore)
from attendance_tpu_torch.sketch.tpu_store import TpuSketchStore  # noqa: F401


def make_sketch_store(config, device=None) -> SketchStore:
    """Build the sketch store selected by config.sketch_backend. Only
    the card store reads ``device`` (default: the CUDA card).

    With live telemetry on, the inspectable backends (all but the real
    Redis server, whose filters live remotely) also register the
    sketch-health gauges (obs/health.register_store; weakref'd, read at
    scrape time only, refreshed on snapshot restore)."""
    if config.sketch_backend == "tpu":
        store = TpuSketchStore(config, device=device)
    elif config.sketch_backend == "memory":
        store = MemorySketchStore(config)
    elif config.sketch_backend == "redis":
        from attendance_tpu_torch.sketch.redis_store import RedisSketchStore
        return RedisSketchStore(config)  # no inspectable local state
    elif config.sketch_backend == "redis-sim":
        from attendance_tpu_torch.sketch.redis_sim import RedisSimSketchStore
        store = RedisSimSketchStore(config)
    else:
        raise ValueError(
            f"unknown sketch backend {config.sketch_backend!r}")
    from attendance_tpu_torch import obs
    t = obs.ensure(config)
    if t is not None:
        from attendance_tpu_torch.obs import health
        health.register_store(
            t, store, getattr(config, "bloom_filter_key", "bf"),
            backend=config.sketch_backend)
    return store
