"""Fixtures shared by the port's test files; a file takes one by
importing it by name."""

import pytest


@pytest.fixture(autouse=True)
def fresh_shared_broker():
    """A FusedPipeline or bridge built without a client takes the
    process's shared memory broker (``transport.make_client``), whose
    topics retain what earlier tests published: each test starts from a
    fresh one."""
    from attendance_tpu_torch.transport.memory_broker import MemoryBroker
    MemoryBroker.reset_shared()
    yield
    MemoryBroker.reset_shared()
