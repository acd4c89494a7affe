"""Hermetic in-process broker with Pulsar's shared-subscription delivery.

Counterpart of the slice of ``attendance_tpu/transport/memory_broker.py``
that the fused hot loop uses: producer ``send``, consumer
``receive(timeout_millis)`` / ``acknowledge`` / ``close``, and
``ReceiveTimeout``. A message stays in flight from delivery until it is
acknowledged (at-least-once); closing a consumer (a crash takeover)
returns its unacknowledged messages to the subscription. Producers and
consumers may live on different threads.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple


class ReceiveTimeout(Exception):
    """receive(timeout_millis) expired with no message (pulsar.Timeout
    in the real client)."""


class Message:
    __slots__ = ("_data", "message_id")

    def __init__(self, data: bytes, message_id: int):
        self._data = data
        self.message_id = message_id

    def data(self) -> bytes:
        return self._data


class _Subscription:
    """Pending queue plus the delivered-but-unacked messages, each with
    the id of the consumer it was delivered to."""

    def __init__(self):
        self.pending: deque = deque()
        self.inflight: Dict[int, Tuple[bytes, int]] = {}
        self.cond = threading.Condition()

    def enqueue(self, message_id: int, data: bytes) -> None:
        with self.cond:
            self.pending.append((message_id, data))
            self.cond.notify()

    def receive(self, timeout_s: Optional[float], owner: int) -> Message:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self.cond:
            while not self.pending:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise ReceiveTimeout(f"no message within {timeout_s}s")
                self.cond.wait(remaining)
            message_id, data = self.pending.popleft()
            self.inflight[message_id] = (data, owner)
        return Message(data, message_id)

    def acknowledge(self, message_id: int) -> None:
        with self.cond:
            self.inflight.pop(message_id, None)

    def requeue_inflight(self, owner: int) -> None:
        """Crash takeover: return the closing consumer's own unacked
        messages to the HEAD of the pending queue, in publish order, so
        a successor replays the dead consumer's window before the
        undelivered backlog (the order an event-time consumer can bound
        a lateness budget for); other consumers' deliveries stay
        theirs."""
        with self.cond:
            mine = sorted((mid, data) for mid, (data, o)
                          in self.inflight.items() if o == owner)
            for mid, _ in mine:
                del self.inflight[mid]
            if mine:
                self.pending.extendleft(reversed(mine))
                self.cond.notify_all()

    def backlog(self) -> int:
        with self.cond:
            return len(self.pending) + len(self.inflight)


class _Topic:
    def __init__(self):
        self.lock = threading.Lock()
        self.subscriptions: Dict[str, _Subscription] = {}
        self._ids = itertools.count()

    def subscription(self, name: str) -> _Subscription:
        with self.lock:
            return self.subscriptions.setdefault(name, _Subscription())

    def publish(self, data: bytes) -> int:
        with self.lock:
            message_id = next(self._ids)
            subs = list(self.subscriptions.values())
        for sub in subs:
            sub.enqueue(message_id, data)
        return message_id


class MemoryBroker:
    """Topic registry of one in-process broker."""

    def __init__(self):
        self._topics: Dict[str, _Topic] = {}
        self._lock = threading.Lock()

    def topic(self, name: str) -> _Topic:
        with self._lock:
            return self._topics.setdefault(name, _Topic())


class MemoryProducer:
    def __init__(self, topic: _Topic):
        self._topic = topic

    def send(self, data: bytes) -> int:
        return self._topic.publish(bytes(data))


_consumer_ids = itertools.count()


class MemoryConsumer:
    def __init__(self, sub: _Subscription):
        self._sub = sub
        self._closed = False
        self._id = next(_consumer_ids)

    def receive(self, timeout_millis: Optional[int] = None) -> Message:
        if self._closed:
            raise RuntimeError("consumer closed")
        return self._sub.receive(
            None if timeout_millis is None else timeout_millis / 1e3,
            self._id)

    def acknowledge(self, msg: Message) -> None:
        self._sub.acknowledge(msg.message_id)

    def backlog(self) -> int:
        """Messages not yet acknowledged (pending or in flight)."""
        return self._sub.backlog()

    def close(self) -> None:
        """Stop consuming; every message delivered to this consumer and
        not acknowledged goes back to the subscription (redelivery)."""
        if not self._closed:
            self._closed = True
            self._sub.requeue_inflight(self._id)


class MemoryClient:
    """pulsar.Client call shape over the in-process broker."""

    def __init__(self, broker: MemoryBroker):
        self._broker = broker

    def create_producer(self, topic: str) -> MemoryProducer:
        return MemoryProducer(self._broker.topic(topic))

    def subscribe(self, topic: str, subscription_name: str) -> MemoryConsumer:
        return MemoryConsumer(
            self._broker.topic(topic).subscription(subscription_name))

    def close(self) -> None:
        pass
