"""Event transport with Pulsar's call shapes, and the micro-batching
consumer's helpers.

Counterpart of ``attendance_tpu/transport/__init__.py``. The reference
drives an external Pulsar broker: ``Client(host).create_producer(topic)
.send(bytes)`` and ``subscribe(topic, sub)`` / ``receive()`` /
``acknowledge()`` / ``negative_acknowledge()``. The port serves those
call shapes from two backends (``--transport-backend``): ``memory``, the
process's in-process broker, and ``socket``, a memory broker behind a
TCP front (``transport.socket_broker``) shared by processes; with
``--ingress-wire shm`` the event topic rides the shared-memory ring
(``transport.shm_ring``) instead. The pulsar transport is not ported and
raises.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from attendance_tpu_torch.transport.memory_broker import (  # noqa: F401
    MemoryBroker, MemoryClient, ReceiveTimeout)
from attendance_tpu_torch.transport.resilience import (  # noqa: F401
    BrokerUnavailable, RetryPolicy)


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


def handle_poison(msg, consumer, metrics, config, logger, *,
                  tracker: PoisonTracker, count_nack: bool = True) -> None:
    """Bounded-retry poison-message policy for one undecodable frame.

    Nack it for redelivery up to ``config.max_redeliveries`` attempts,
    then dead-letter it (ack and count) so one frame cannot livelock the
    subscription (the reference nacks forever). With
    ``config.quarantine_dir`` set, the frame's bytes are written to the
    on-disk quarantine (``transport.quarantine``) before the ack; a
    failed quarantine write is logged and the frame dead-letters anyway,
    as in the JAX package (the subscription must not livelock because
    the quarantine disk died). ``count_nack=False`` leaves
    ``metrics.nacked_batches`` alone. ``tracker`` counts the frame's own
    failures (the broker's count grows with every requeue).
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
        if config.quarantine_dir:
            try:
                from attendance_tpu_torch.transport.quarantine import (
                    get_quarantine)
                props = (msg.properties()
                         if hasattr(msg, "properties") else None)
                get_quarantine(config.quarantine_dir).put(
                    msg.data(), topic=config.pulsar_topic,
                    reason="poison-frame",
                    redeliveries=attempts, properties=props)
            except Exception:
                logger.exception(
                    "Quarantine write failed; dead-lettering anyway")
        logger.error("Dead-lettering poison frame after %d redeliveries",
                     attempts)
        metrics.dead_lettered += 1
        consumer.acknowledge(msg)
    else:
        if count_nack:
            metrics.nacked_batches += 1
        consumer.negative_acknowledge(msg)


def _fill_until(batch_size: int, timeout_s: float, step) -> None:
    """The partial-batch timeout rule: call ``step(remaining_n,
    timeout_ms) -> received count`` until ``batch_size`` messages arrived
    or ``timeout_s`` expired with at least one; a ReceiveTimeout from
    ``step`` ends the batch."""
    total = 0
    deadline = time.monotonic() + timeout_s
    while total < batch_size:
        remaining = deadline - time.monotonic()
        if remaining <= 0 and total:
            break
        timeout_ms = max(1, int(max(remaining, 0) * 1000))
        try:
            total += step(batch_size - total, timeout_ms)
        except ReceiveTimeout:
            break


def collect_batch(consumer, batch_size: int, timeout_s: float) -> list:
    """Fill a micro-batch from a consumer: up to ``batch_size`` messages,
    or whatever arrived when ``timeout_s`` expires with at least one
    (partial batch)."""
    msgs: list = []

    def step(n, timeout_ms):
        got = consumer.receive_many(n, timeout_millis=timeout_ms)
        msgs.extend(got)
        return len(got)

    _fill_until(batch_size, timeout_s, step)
    return msgs


def collect_chunks(consumer, batch_size: int, timeout_s: float) -> list:
    """Fill a micro-batch on the chunk lane: ``(chunk_id, raw tuples)``
    handles totalling up to ``batch_size`` messages, or whatever arrived
    when ``timeout_s`` expires (the rule of :func:`collect_batch`)."""
    chunks = []

    def step(n, timeout_ms):
        cid, toks = consumer.receive_chunk(n, timeout_millis=timeout_ms)
        chunks.append((cid, toks))
        return len(toks)

    _fill_until(batch_size, timeout_s, step)
    return chunks


def acknowledge_all(consumer, msgs) -> None:
    """Ack a batch in one broker call."""
    consumer.acknowledge_many(msgs)


def make_client(config):
    """The transport client selected by config: with ``ingress_wire
    shm`` the shared-memory ring client over ``config.shm_dir``
    (``transport.shm_ring``), else by ``transport_backend`` the
    process's shared memory broker, or a SocketClient of the broker at
    ``config.socket_broker`` (retry budget ``config.retry_budget_s``).
    The pulsar transport is not ported."""
    if config.ingress_wire == "shm":
        from attendance_tpu_torch.transport.shm_ring import ShmClient
        return ShmClient.from_config(config)
    if config.transport_backend == "memory":
        return MemoryClient(MemoryBroker.shared())
    if config.transport_backend == "socket":
        from attendance_tpu_torch.transport.socket_broker import (
            SocketClient)
        return SocketClient(config.socket_broker,
                            policy=RetryPolicy.from_config(config))
    if config.transport_backend == "pulsar":
        raise NotImplementedError(
            "transport backend 'pulsar' is not in the port; use 'memory' "
            "or 'socket'")
    raise ValueError(
        f"unknown transport backend {config.transport_backend!r}")
