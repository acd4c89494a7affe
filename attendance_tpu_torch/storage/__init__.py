"""Event stores with the reference's Cassandra semantics, selected by
``--storage-backend``: "memory" (rows, upsert by primary key),
"columnar" (column blocks, deduplicated at read time) and "cassandra"
(the real service, import-gated). Counterpart of
``attendance_tpu/storage``; :func:`wrap_store` layers the fault plane's
``persist_fail`` and the circuit breaker with its spill
(``storage/resilient.py``) over a sink.
"""

from attendance_tpu_torch.storage.memory_store import (  # noqa: F401
    AttendanceRow, MemoryEventStore)


def make_event_store(config):
    """Build the event store selected by config.storage_backend."""
    if config.storage_backend == "memory":
        return MemoryEventStore()
    if config.storage_backend == "columnar":
        from attendance_tpu_torch.storage.columnar_store import (
            ColumnarEventStore)
        return ColumnarEventStore()
    if config.storage_backend == "cassandra":
        from attendance_tpu_torch.storage.cassandra_store import (
            CassandraEventStore)
        return CassandraEventStore(config)
    raise ValueError(f"unknown storage backend {config.storage_backend!r}")


def wrap_store(store, config, *, sink: str = "events"):
    """Apply the failure-plane layers to a persist sink, innermost
    first: ``persist_fail`` injection (``chaos.ChaosEventStore``) when
    the installed spec carries it, then the circuit breaker and its
    durable spill (``storage.resilient.ResilientEventStore``) when
    ``persist_spill_dir`` is set. With neither the store is returned
    as it is: the hot path keeps its raw sink."""
    from attendance_tpu_torch import chaos

    inj = chaos.ensure(config)
    if inj is not None and inj.active("persist_fail"):
        store = chaos.ChaosEventStore(store, inj)
    if config.persist_spill_dir:
        from attendance_tpu_torch.storage.resilient import (
            CircuitBreaker, ResilientEventStore)
        store = ResilientEventStore(
            store, config.persist_spill_dir, sink=sink,
            breaker=CircuitBreaker(
                failure_threshold=config.persist_breaker_failures,
                cooldown_s=config.persist_breaker_cooldown_s))
    return store
