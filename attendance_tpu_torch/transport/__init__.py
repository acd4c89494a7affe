"""Event transport with Pulsar's call shapes, and the micro-batching
consumer's helpers.

Counterpart of ``attendance_tpu/transport/__init__.py``. The reference
drives an external Pulsar broker: ``Client(host).create_producer(topic)
.send(bytes)`` and ``subscribe(topic, sub)`` / ``receive()`` /
``acknowledge()`` / ``negative_acknowledge()``. The port serves those
call shapes from two backends (``--transport-backend``): ``memory``, the
process's in-process broker, and ``socket``, a memory broker behind a
TCP front (``transport.socket_broker``) shared by processes, and
``pulsar``, a Pulsar service through pulsar-client
(``transport.pulsar_client``, import-gated); with ``--ingress-wire shm``
the event topic rides the shared-memory ring (``transport.shm_ring``)
instead.

The memory and socket consumers add batch calls (``receive_many``,
``acknowledge_many``, the raw and chunk lanes); a pulsar-client consumer
has only the per-message ones, and its messages give their id and
redelivery count as methods. The helpers here detect each batch call
and fall back to the per-message call without it.
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


def message_id(msg):
    """A hashable id of a received message that is the same on every
    redelivery: the memory broker's attribute, or the value of
    ``pulsar.Message.message_id()``, keyed by its ``serialize()`` bytes
    (a ``MessageId`` is a new object on each delivery, and its
    hashability is not part of pulsar-client's surface)."""
    mid = msg.message_id
    if not callable(mid):
        return mid
    mid = mid()
    serialize = getattr(mid, "serialize", None)
    return serialize() if serialize is not None else mid


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
    mid = message_id(msg)
    attempts = tracker.bump(mid) - 1
    # Backstop: the tracker's LRU forgets under a poison burst wider than
    # its cap; the broker's count grows regardless, so past a generous
    # multiple of the bound the frame dead-letters anyway.
    backstop = max(4 * config.max_redeliveries, 8)
    attempts = max(attempts, redelivery_count(msg) - backstop
                   + config.max_redeliveries)
    if attempts >= config.max_redeliveries:
        tracker.forget(mid)
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
    (partial batch). The consumer's ``receive_many`` drains under one
    lock (one RPC on the socket transport); a consumer without it (a
    pulsar-client one) receives message by message."""
    batch_recv = getattr(consumer, "receive_many", None)
    msgs: list = []

    def step(n, timeout_ms):
        if batch_recv is None:
            msgs.append(consumer.receive(timeout_millis=timeout_ms))
            return 1
        got = batch_recv(n, timeout_millis=timeout_ms)
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
    """Ack a batch in one broker call when the consumer has
    ``acknowledge_many``, else message by message."""
    batch_ack = getattr(consumer, "acknowledge_many", None)
    if batch_ack is not None:
        batch_ack(msgs)
        return
    for m in msgs:
        consumer.acknowledge(m)


def make_client(config):
    """The transport client selected by config: with ``ingress_wire
    shm`` the shared-memory ring client over ``config.shm_dir``
    (``transport.shm_ring``), else by ``transport_backend`` the
    process's shared memory broker, a SocketClient of the broker at
    ``config.socket_broker`` (retry budget ``config.retry_budget_s``),
    or a PulsarClient of ``config.pulsar_host`` (raises without
    pulsar-client).

    The chaos chokepoint: with ``config.chaos`` set, the socket client
    gets the injector at its RPC seams (drop, conn_reset and delay on
    real TCP connections) and every broker client is wrapped in the
    backend-agnostic proxies (dup, delay, corrupt, partition), so one
    spec drives the memory broker's soak and the socket broker's. The
    shm ring carries its faults (torn_slot, writer_stall) in its
    producer and is not wrapped: its seqlock owns torn delivery. The
    pulsar client carries none: ``Config`` refuses ``chaos`` with it,
    and an injector another config installed in this process raises
    here."""
    from attendance_tpu_torch import chaos

    inj = chaos.ensure(config)
    if config.ingress_wire == "shm":
        from attendance_tpu_torch.transport.shm_ring import ShmClient
        return ShmClient.from_config(config)
    if config.transport_backend == "memory":
        client = MemoryClient(MemoryBroker.shared())
    elif config.transport_backend == "socket":
        from attendance_tpu_torch.transport.socket_broker import (
            SocketClient)
        client = SocketClient(config.socket_broker, chaos=inj,
                              policy=RetryPolicy.from_config(config))
    elif config.transport_backend == "pulsar":
        if inj is not None:
            raise RuntimeError(
                "the fault plane is on in this process, and the pulsar "
                "transport does not carry it")
        from attendance_tpu_torch.transport.pulsar_client import (
            PulsarClient)
        return PulsarClient(config.pulsar_host)
    else:
        raise ValueError(
            f"unknown transport backend {config.transport_backend!r}")
    return chaos.maybe_wrap(client)
