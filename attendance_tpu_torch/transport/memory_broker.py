"""Hermetic in-process broker with Pulsar's shared-subscription delivery.

Counterpart of ``attendance_tpu/transport/memory_broker.py`` without its
bulk lanes (raw tuples, chunks, ``send_many``) and telemetry: producer
``send``, consumer
``receive(timeout_millis)`` / ``receive_many`` / ``acknowledge`` /
``acknowledge_many`` / ``negative_acknowledge`` / ``close``,
``ReceiveTimeout``, and the process-wide ``MemoryBroker.shared()``. A
message stays in flight from delivery until it is acknowledged
(at-least-once); a negative acknowledgement returns it to the tail of
the subscription's queue and closing a consumer (a crash takeover)
returns its unacknowledged messages to the head, each with its
redelivery count bumped. A topic retains its last ``RETAINED_LIMIT``
messages, and a new subscription starts at the earliest of them (a
generator may publish before the processor subscribes). Producers and
consumers may live on different threads.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# Messages a topic retains for late-joining subscriptions: a late
# subscriber sees the most recent RETAINED_LIMIT messages, as a topic
# with bounded retention.
RETAINED_LIMIT = 1 << 16

class ReceiveTimeout(Exception):
    """receive(timeout_millis) expired with no message (pulsar.Timeout
    in the real client)."""


class Message:
    """A delivered message: payload, broker ids, the number of times it
    was delivered before, and the producer's string properties."""

    __slots__ = ("_data", "message_id", "redelivery_count", "_props")

    def __init__(self, data: bytes, message_id: int,
                 redelivery_count: int = 0,
                 properties: Optional[dict] = None):
        self._data = data
        self.message_id = message_id
        self.redelivery_count = redelivery_count
        self._props = properties

    def data(self) -> bytes:
        return self._data

    def properties(self) -> dict:
        """Producer-attached string properties (pulsar.Message shape)."""
        return self._props or {}


class _Subscription:
    """Pending queue plus the delivered-but-unacked messages, each with
    the id of the consumer it was delivered to."""

    def __init__(self):
        self.pending: deque = deque()
        # message_id -> (payload, redeliveries, owner, properties)
        self.inflight: Dict[int, Tuple[bytes, int, int,
                                       Optional[dict]]] = {}
        self.cond = threading.Condition()

    def enqueue(self, message_id: int, data: bytes,
                properties: Optional[dict] = None) -> None:
        with self.cond:
            self.pending.append((message_id, data, 0, properties))
            self.cond.notify()

    def receive_many(self, max_n: int, timeout_s: Optional[float],
                     owner: int) -> List[Message]:
        """Wait until a message is pending (or the timeout), then take up
        to ``max_n`` pending messages under one lock acquisition."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self.cond:
            while not self.pending:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise ReceiveTimeout(f"no message within {timeout_s}s")
                self.cond.wait(remaining)
            out = []
            for _ in range(min(max_n, len(self.pending))):
                mid, data, red, props = self.pending.popleft()
                self.inflight[mid] = (data, red, owner, props)
                out.append(Message(data, mid, red, props))
        return out

    def acknowledge_many(self, message_ids) -> None:
        with self.cond:
            for mid in message_ids:
                self.inflight.pop(mid, None)

    def negative_acknowledge(self, message_id: int) -> None:
        """Return one in-flight message to the tail of the queue with its
        redelivery count bumped."""
        with self.cond:
            entry = self.inflight.pop(message_id, None)
            if entry is not None:
                data, red, _, props = entry
                self.pending.append((message_id, data, red + 1, props))
                self.cond.notify()

    def requeue_inflight(self, owner: int) -> None:
        """Crash takeover: return the closing consumer's own unacked
        messages to the HEAD of the pending queue, in publish order, so
        a successor replays the dead consumer's window before the
        undelivered backlog (the order an event-time consumer can bound
        a lateness budget for); other consumers' deliveries stay
        theirs."""
        with self.cond:
            mine = sorted((mid, data, red + 1, props)
                          for mid, (data, red, o, props)
                          in self.inflight.items() if o == owner)
            for mid, _, _, _ in mine:
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
        self.retained: Deque[Tuple[int, bytes, Optional[dict]]] = deque(
            maxlen=RETAINED_LIMIT)
        self._ids = itertools.count()

    def subscription(self, name: str) -> _Subscription:
        with self.lock:
            sub = self.subscriptions.get(name)
            if sub is None:
                sub = self.subscriptions[name] = _Subscription()
                for mid, data, props in self.retained:
                    sub.enqueue(mid, data, props)
            return sub

    def publish(self, data: bytes,
                properties: Optional[dict] = None) -> int:
        with self.lock:
            message_id = next(self._ids)
            self.retained.append((message_id, data, properties))
            subs = list(self.subscriptions.values())
        for sub in subs:
            sub.enqueue(message_id, data, properties)
        return message_id


class MemoryBroker:
    """Topic registry of one in-process broker; ``shared()`` is the one
    broker of the process, as a deployment has one Pulsar service."""

    _shared: Optional["MemoryBroker"] = None
    _shared_lock = threading.Lock()

    def __init__(self):
        self._topics: Dict[str, _Topic] = {}
        self._lock = threading.Lock()

    @classmethod
    def shared(cls) -> "MemoryBroker":
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls()
            return cls._shared

    @classmethod
    def reset_shared(cls) -> None:
        with cls._shared_lock:
            cls._shared = None

    def topic(self, name: str) -> _Topic:
        with self._lock:
            return self._topics.setdefault(name, _Topic())


class MemoryProducer:
    def __init__(self, topic: _Topic):
        self._topic = topic

    def send(self, data: bytes, properties: Optional[dict] = None) -> int:
        return self._topic.publish(bytes(data), properties)


_consumer_ids = itertools.count()


class MemoryConsumer:
    def __init__(self, sub: _Subscription):
        self._sub = sub
        self._closed = False
        self._id = next(_consumer_ids)

    def _timeout_s(self, timeout_millis: Optional[int]) -> Optional[float]:
        if self._closed:
            raise RuntimeError("consumer closed")
        return None if timeout_millis is None else timeout_millis / 1e3

    def receive(self, timeout_millis: Optional[int] = None) -> Message:
        return self._sub.receive_many(1, self._timeout_s(timeout_millis),
                                      self._id)[0]

    def receive_many(self, max_n: int,
                     timeout_millis: Optional[int] = None) -> List[Message]:
        """Up to ``max_n`` pending messages in one call (one lock round
        trip instead of one a message)."""
        return self._sub.receive_many(
            max_n, self._timeout_s(timeout_millis), self._id)

    def acknowledge(self, msg: Message) -> None:
        self._sub.acknowledge_many((msg.message_id,))

    def acknowledge_many(self, msgs) -> None:
        self._sub.acknowledge_many([m.message_id for m in msgs])

    def negative_acknowledge(self, msg: Message) -> None:
        self._sub.negative_acknowledge(msg.message_id)

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

    def subscribe(self, topic: str, subscription_name: str,
                  consumer_type=None) -> MemoryConsumer:
        del consumer_type  # shared semantics are the only mode implemented
        return MemoryConsumer(
            self._broker.topic(topic).subscription(subscription_name))

    def close(self) -> None:
        pass
