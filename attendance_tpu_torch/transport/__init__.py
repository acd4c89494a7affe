"""Event transport with Pulsar's call shapes, and the micro-batching
consumer's helpers.

Counterpart of ``attendance_tpu/transport/__init__.py``. The reference
drives an external Pulsar broker: ``Client(host).create_producer(topic)
.send(bytes)`` and ``subscribe(topic, sub)`` / ``receive()`` /
``acknowledge()`` / ``negative_acknowledge()``. The port serves those
call shapes from the in-process memory broker (``--transport-backend
memory``); the socket and pulsar transports are not ported yet and
raise.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from attendance_tpu_torch.transport.memory_broker import (  # noqa: F401
    MemoryBroker, MemoryClient, ReceiveTimeout)


def redelivery_count(msg) -> int:
    """Delivery-attempt count of a received message: an attribute on
    the memory broker's messages, a method on ``pulsar.Message``."""
    rc = msg.redelivery_count
    return rc() if callable(rc) else rc


class PoisonTracker:
    """Client-side poison-attempt counts per message id.

    The broker's redelivery count is bumped by every requeue (nacks, but
    also crash takeovers), so a healthy frame can arrive with a high
    count; counting this client's own decode failures bounds retries by
    how often the frame itself failed. Bounded LRU: only failing
    messages are tracked."""

    def __init__(self, cap: int = 4096):
        self._counts: OrderedDict = OrderedDict()
        self._cap = cap

    def bump(self, message_id) -> int:
        """Record one poison attempt; returns the total so far."""
        count = self._counts.pop(message_id, 0) + 1
        self._counts[message_id] = count
        if len(self._counts) > self._cap:
            self._counts.popitem(last=False)
        return count

    def forget(self, message_id) -> None:
        self._counts.pop(message_id, None)


def handle_poison(msg, consumer, metrics, config, logger,
                  tracker: PoisonTracker) -> None:
    """Bounded-retry poison-message policy for one undecodable frame.

    Nack it for redelivery up to ``config.max_redeliveries`` attempts,
    then dead-letter it (ack and count) so one frame cannot livelock the
    subscription (the reference nacks forever). ``tracker`` counts the
    frame's own failures.
    """
    # Completed nacks so far for this frame's own failures.
    attempts = tracker.bump(msg.message_id) - 1
    # Backstop: the tracker's LRU forgets under a poison burst wider than
    # its cap; the broker's count grows regardless, so past a generous
    # multiple of the bound the frame dead-letters anyway.
    backstop = max(4 * config.max_redeliveries, 8)
    attempts = max(attempts, redelivery_count(msg) - backstop
                   + config.max_redeliveries)
    if attempts >= config.max_redeliveries:
        tracker.forget(msg.message_id)
        logger.error("Dead-lettering poison frame after %d redeliveries",
                     attempts)
        metrics.dead_lettered += 1
        consumer.acknowledge(msg)
    else:
        consumer.negative_acknowledge(msg)


def collect_batch(consumer, batch_size: int, timeout_s: float) -> list:
    """Fill a micro-batch from a consumer: up to ``batch_size`` messages,
    or whatever arrived when ``timeout_s`` expires with at least one
    (partial batch)."""
    msgs: list = []
    deadline = time.monotonic() + timeout_s
    while len(msgs) < batch_size:
        remaining = deadline - time.monotonic()
        if remaining <= 0 and msgs:
            break
        timeout_ms = max(1, int(max(remaining, 0) * 1000))
        try:
            msgs.extend(consumer.receive_many(batch_size - len(msgs),
                                              timeout_millis=timeout_ms))
        except ReceiveTimeout:
            break
    return msgs


def acknowledge_all(consumer, msgs) -> None:
    """Ack a batch in one broker call."""
    consumer.acknowledge_many(msgs)


def make_client(config):
    """The transport client selected by config.transport_backend: the
    process's shared memory broker. The socket and pulsar transports
    are not ported yet."""
    if config.transport_backend == "memory":
        return MemoryClient(MemoryBroker.shared())
    if config.transport_backend in ("socket", "pulsar"):
        raise NotImplementedError(
            f"transport backend {config.transport_backend!r} is not in "
            "the port yet; use 'memory'")
    raise ValueError(
        f"unknown transport backend {config.transport_backend!r}")
