"""A stand-in for the pulsar-client 3.x Python module, for tests and
``chip_smoke.py``: installed as ``sys.modules["pulsar"]``.

It keeps the documented surface of Apache Pulsar's Python client
(``pulsar.Client``, ``Producer``, ``Consumer``, ``Message``,
``MessageId``, ``ConsumerType``, ``InitialPosition``, the ``Timeout``
exception) and its delivery semantics, over a lock-and-deque queue of its
own that shares nothing with the memory or socket brokers:

* ``Client(service_url)``; clients of one service URL share its topics.
* A subscription created with ``InitialPosition.Latest`` (the default)
  receives what is published after it exists.
* ``Shared`` consumers of one subscription compete for its messages;
  ``Exclusive`` refuses a second consumer; ``Failover`` delivers to the
  first connected consumer only.
* At-least-once: a received message stays unacknowledged until
  ``acknowledge``; ``negative_acknowledge`` redelivers it after
  ``negative_ack_redelivery_delay_ms`` (pulsar-client's default is 60 s;
  tests set the module's ``NACK_DELAY_MS`` short) with
  ``redelivery_count() + 1``, ahead of newer messages; a closed
  consumer's unacknowledged messages go back to the subscription at once,
  counted as a redelivery.
* Each delivery is a new ``Message`` object; ``message_id()`` returns a
  new ``MessageId`` that compares equal across redeliveries, has
  ``serialize()``, and is unhashable (hashability is not part of the
  client's surface).
* ``receive(timeout_millis)`` raises ``Timeout``; the consumer has none
  of the batch calls of this repo's brokers and no ``backlog``.

``pending(topic, subscription, service_url=None)`` and
``subscription_type(topic, subscription, service_url)`` are the tests'
inspection hooks: the subscription's messages not yet acknowledged, and
its consumer type.
"""

from __future__ import annotations

import struct
import threading
import time
from collections import deque

NACK_DELAY_MS = 60_000  # pulsar-client's negative_ack_redelivery_delay_ms

_lock = threading.Lock()
_services: dict = {}  # service_url -> {topic: _Topic}


class PulsarException(Exception):
    pass


class Timeout(PulsarException):
    pass


class AlreadyClosed(PulsarException):
    pass


class ConsumerBusy(PulsarException):
    pass


class ConsumerType:
    Exclusive = "Exclusive"
    Shared = "Shared"
    Failover = "Failover"


class InitialPosition:
    Latest = "Latest"
    Earliest = "Earliest"


class MessageId:
    def __init__(self, ledger_id: int, entry_id: int):
        self._ledger_id = ledger_id
        self._entry_id = entry_id

    def entry_id(self) -> int:
        return self._entry_id

    def serialize(self) -> bytes:
        return struct.pack("<qq", self._ledger_id, self._entry_id)

    def __eq__(self, other):
        return (isinstance(other, MessageId)
                and (self._ledger_id, self._entry_id)
                == (other._ledger_id, other._entry_id))

    __hash__ = None

    def __str__(self) -> str:
        return f"({self._ledger_id},{self._entry_id},-1,-1)"


class Message:
    def __init__(self, entry: "_Entry", topic: str):
        self._entry = entry
        self._topic = topic
        self._redeliveries = entry.redeliveries

    def data(self) -> bytes:
        return self._entry.data

    def properties(self) -> dict:
        return dict(self._entry.properties)

    def message_id(self) -> MessageId:
        return MessageId(0, self._entry.entry_id)

    def redelivery_count(self) -> int:
        return self._redeliveries

    def topic_name(self) -> str:
        return self._topic


class _Entry:
    __slots__ = ("entry_id", "data", "properties", "redeliveries")

    def __init__(self, entry_id, data, properties):
        self.entry_id = entry_id
        self.data = data
        self.properties = properties
        self.redeliveries = 0

    def copy(self) -> "_Entry":
        return _Entry(self.entry_id, self.data, self.properties)


class _Subscription:
    def __init__(self, name: str, consumer_type):
        self.name = name
        self.type = consumer_type
        self.cond = threading.Condition(_lock)
        self.queue: deque = deque()
        self.unacked: dict = {}     # entry_id -> (entry, consumer)
        self.scheduled: list = []   # (due monotonic, entry)
        self.consumers: list = []

    def release_due(self) -> None:
        """Move the nacked entries whose delay passed back to the front
        (under the lock)."""
        if not self.scheduled:
            return
        now = time.monotonic()
        due = sorted((e for t, e in self.scheduled if t <= now),
                     key=lambda e: e.entry_id, reverse=True)
        if due:
            self.scheduled = [(t, e) for t, e in self.scheduled if t > now]
            self.queue.extendleft(due)

    def next_due(self):
        return min((t for t, _ in self.scheduled), default=None)

    def eligible(self, consumer) -> bool:
        if self.type == ConsumerType.Failover:
            return bool(self.consumers) and self.consumers[0] is consumer
        return True


class _Topic:
    def __init__(self, name: str):
        self.name = name
        self.log: list = []
        self.subscriptions: dict = {}
        self.next_id = 0


def _service(url: str) -> dict:
    with _lock:
        return _services.setdefault(url, {})


def _topic(url: str, name: str) -> _Topic:
    topics = _service(url)
    with _lock:
        if name not in topics:
            topics[name] = _Topic(name)
        return topics[name]


class Producer:
    def __init__(self, topic: _Topic):
        self._topic = topic
        self._closed = False

    def send(self, content, properties=None, partition_key=None,
             sequence_id=None, replication_clusters=None,
             disable_replication=False, event_timestamp=None,
             deliver_at=None, deliver_after=None) -> MessageId:
        if not isinstance(content, bytes):
            raise ValueError(f"content: expected bytes, got "
                             f"{type(content).__name__}")
        props = dict(properties or {})
        for k, v in props.items():
            if not isinstance(k, str) or not isinstance(v, str):
                raise ValueError("properties: expected str -> str")
        with _lock:
            if self._closed:
                raise AlreadyClosed("producer closed")
            t = self._topic
            entry = _Entry(t.next_id, content, props)
            t.next_id += 1
            t.log.append(entry)
            for sub in t.subscriptions.values():
                sub.queue.append(entry.copy())
                sub.cond.notify_all()
        return MessageId(0, entry.entry_id)

    def close(self) -> None:
        self._closed = True


class Consumer:
    def __init__(self, topic: _Topic, sub: _Subscription, nack_delay_ms):
        self._topic = topic
        self._sub = sub
        self._nack_delay_s = nack_delay_ms / 1e3
        self._closed = False

    def subscription_name(self) -> str:
        return self._sub.name

    def receive(self, timeout_millis=None) -> Message:
        sub = self._sub
        deadline = (None if timeout_millis is None
                    else time.monotonic() + timeout_millis / 1e3)
        with sub.cond:
            while True:
                if self._closed:
                    raise AlreadyClosed("consumer closed")
                sub.release_due()
                if sub.queue and sub.eligible(self):
                    entry = sub.queue.popleft()
                    sub.unacked[entry.entry_id] = (entry, self)
                    return Message(entry, self._topic.name)
                now = time.monotonic()
                wait = None if deadline is None else deadline - now
                if wait is not None and wait <= 0:
                    raise Timeout("Pulsar error: TimeOut")
                due = sub.next_due()
                if due is not None:
                    wait = (due - now if wait is None
                            else min(wait, due - now))
                sub.cond.wait(None if wait is None else max(wait, 0.0))

    def _entry_id(self, message) -> int:
        mid = (message.message_id() if isinstance(message, Message)
               else message)
        return mid.entry_id()

    def acknowledge(self, message) -> None:
        with _lock:
            if self._closed:
                raise AlreadyClosed("consumer closed")
            self._sub.unacked.pop(self._entry_id(message), None)

    def negative_acknowledge(self, message) -> None:
        with self._sub.cond:
            if self._closed:
                raise AlreadyClosed("consumer closed")
            got = self._sub.unacked.pop(self._entry_id(message), None)
            if got is None:
                return
            entry = got[0]
            entry.redeliveries += 1
            self._sub.scheduled.append(
                (time.monotonic() + self._nack_delay_s, entry))
            self._sub.cond.notify_all()

    def close(self) -> None:
        sub = self._sub
        with sub.cond:
            if self._closed:
                return
            self._closed = True
            mine = sorted((e for e, c in sub.unacked.values() if c is self),
                          key=lambda e: e.entry_id, reverse=True)
            for entry in mine:
                del sub.unacked[entry.entry_id]
                entry.redeliveries += 1
            sub.queue.extendleft(mine)
            sub.consumers.remove(self)
            sub.cond.notify_all()


class Client:
    def __init__(self, service_url: str, **kwargs):
        self.service_url = service_url
        self._owned: list = []
        self._closed = False

    def create_producer(self, topic: str, **kwargs) -> Producer:
        if self._closed:
            raise AlreadyClosed("client closed")
        producer = Producer(_topic(self.service_url, topic))
        self._owned.append(producer)
        return producer

    def subscribe(self, topic: str, subscription_name: str,
                  consumer_type=ConsumerType.Exclusive,
                  initial_position=InitialPosition.Latest,
                  negative_ack_redelivery_delay_ms=None,
                  **kwargs) -> Consumer:
        if self._closed:
            raise AlreadyClosed("client closed")
        t = _topic(self.service_url, topic)
        with _lock:
            sub = t.subscriptions.get(subscription_name)
            if sub is None:
                sub = _Subscription(subscription_name, consumer_type)
                t.subscriptions[subscription_name] = sub
                if initial_position == InitialPosition.Earliest:
                    sub.queue.extend(e.copy() for e in t.log)
            elif sub.type != consumer_type:
                raise ConsumerBusy(
                    f"subscription {subscription_name} is {sub.type}")
            elif (consumer_type == ConsumerType.Exclusive
                  and sub.consumers):
                raise ConsumerBusy(
                    f"exclusive subscription {subscription_name} has a "
                    "consumer")
            delay = (NACK_DELAY_MS if negative_ack_redelivery_delay_ms
                     is None else negative_ack_redelivery_delay_ms)
            consumer = Consumer(t, sub, delay)
            sub.consumers.append(consumer)
        self._owned.append(consumer)
        return consumer

    def close(self) -> None:
        self._closed = True
        for handle in self._owned:
            handle.close()


def pending(topic: str, subscription: str, service_url=None) -> int:
    """Messages of the subscription not yet acknowledged: queued, in
    flight and waiting out a nack delay (of the one service when
    ``service_url`` is None)."""
    with _lock:
        urls = ([service_url] if service_url is not None
                else list(_services))
        total = 0
        for url in urls:
            t = _services.get(url, {}).get(topic)
            sub = t.subscriptions.get(subscription) if t else None
            if sub is not None:
                total += (len(sub.queue) + len(sub.unacked)
                          + len(sub.scheduled))
        return total


def subscription_type(topic: str, subscription: str, service_url: str):
    """The consumer type a subscription was created with."""
    with _lock:
        return _services[service_url][topic].subscriptions[
            subscription].type


def reset() -> None:
    """Forget every service's topics (between tests)."""
    with _lock:
        _services.clear()
