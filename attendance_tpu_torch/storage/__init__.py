"""Event stores with the reference's Cassandra semantics, selected by
``--storage-backend``: "memory" (rows, upsert by primary key),
"columnar" (column blocks, deduplicated at read time) and "cassandra"
(the real service, import-gated). Counterpart of
``attendance_tpu/storage``.
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
