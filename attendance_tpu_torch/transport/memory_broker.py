"""Hermetic in-process broker with Pulsar's shared-subscription delivery.

Counterpart of ``attendance_tpu/transport/memory_broker.py``: producer ``send`` / ``send_many``, consumer
``receive(timeout_millis)`` / ``receive_many`` / ``acknowledge`` /
``acknowledge_many`` / ``negative_acknowledge`` / ``close``, the raw lane
(``receive_many_raw`` + ``acknowledge_ids``: ``(message_id, data,
redeliveries, properties)`` tuples, no wrappers), the chunk lane
(``receive_chunk``: a whole batch is one in-flight entry, settled by
``acknowledge_chunk`` / ``nack_chunk`` or split by ``explode_chunk``),
``ReceiveTimeout`` and the process-wide ``MemoryBroker.shared()``.

A message stays in flight from delivery until it is acknowledged
(at-least-once); a negative acknowledgement returns it to the tail of
the subscription's queue, and closing a consumer (a crash takeover)
returns its unacknowledged messages, per message and chunk alike, to
the head in publish order, each with its redelivery count bumped. A
topic retains its last ``RETAINED_LIMIT`` messages, and a new
subscription starts at the earliest of them (a generator may publish
before the processor subscribes). A bulk enqueue wakes as many waiting
consumers as it can feed. Producers and consumers may live on different
threads.

Telemetry, when ``obs`` is live as a subscription or producer is made:
the ``attendance_queue_depth`` callback gauge (read at scrape time, so
the queue paths pay nothing for it), received, redelivered and sent
message and byte counters, and with tracing a ``publish`` span a send
whose context travels in the message property ``traceparent`` (kept
across nacks, redelivery and takeover like the payload).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

# Messages a topic retains for late-joining subscriptions: a late
# subscriber sees the most recent RETAINED_LIMIT messages, as a topic
# with bounded retention.
RETAINED_LIMIT = 1 << 16


class ReceiveTimeout(Exception):
    """receive(timeout_millis) expired with no message (maps to
    pulsar.Timeout in the real client)."""


class Message:
    """A delivered message: payload, broker ids, the number of times it
    was delivered before, and the producer's string properties (which
    survive redelivery and crash takeover like the payload)."""

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
    """One named subscription on a topic: a shared pending queue plus an
    in-flight (delivered, unacked) map — Pulsar Shared subscription.
    In-flight entries record the owning consumer so a consumer close only
    requeues ITS unacked messages, not those delivered to still-live
    competing consumers (Pulsar crash-takeover semantics)."""

    def __init__(self, name: str, topic: str = ""):
        self.name = name
        # Telemetry handles, resolved once: with telemetry off every
        # hook below is one `is not None` branch.
        from attendance_tpu_torch import obs
        t = obs.get()
        self._obs_redelivered = self._obs_recv_msgs = None
        self._obs_recv_bytes = None
        if t is not None:
            import weakref
            labels = dict(topic=topic, subscription=name)
            ref = weakref.ref(self)  # a dead subscription is not pinned
            t.registry.gauge(
                "attendance_queue_depth",
                help="Pending messages on a broker subscription",
                **labels).set_function(
                    lambda ref=ref: s._count
                    if (s := ref()) is not None else 0)
            self._obs_redelivered = t.registry.counter(
                "attendance_broker_redeliveries_total",
                help="Messages requeued by nack or consumer crash",
                **labels)
            self._obs_recv_msgs = t.registry.counter(
                "attendance_broker_received_messages_total",
                help="Messages delivered to consumers", **labels)
            self._obs_recv_bytes = t.registry.counter(
                "attendance_broker_received_bytes_total",
                help="Payload bytes delivered to consumers", **labels)
        # Pending messages, block-structured: sealed blocks are
        # [entries_list, consumed_offset] pairs; _tail is the open
        # block single-message enqueues append to (sealed lazily).
        # Bulk enqueues hand their WHOLE entries list over as one
        # block, and bulk receives slice blocks back out — so the
        # per-message cost of the bulk lanes is one list-slot copy,
        # not a deque popleft and a tuple each. Block entry lists are
        # immutable by convention: only the offset advances.
        self._blocks: Deque[list] = deque()
        self._tail: list = []
        self._count = 0
        # message_id -> (payload, redeliveries, owner consumer id,
        # properties)
        self.inflight: Dict[int, Tuple[bytes, int, int, Optional[dict]]] = {}
        # chunk_id -> (list of (mid, payload, red, props), owner): the
        # chunk lane's whole-batch in-flight entries (receive_chunk).
        self.chunk_inflight: Dict[int, Tuple[list, int]] = {}
        self._chunk_ids = itertools.count()
        self.cond = threading.Condition()
        # Consumers currently blocked in a wait; producers skip the
        # notify when nobody waits.
        self._waiting = 0

    def _notify_if_waiting(self, n: int = 1) -> None:
        """Wake up to ``n`` blocked consumers — one per enqueued
        message, not one per enqueue call: a bulk block must wake every
        competing consumer it can feed, or all but one sleep through a
        full queue (lost wakeup)."""
        if self._waiting:
            self.cond.notify(min(self._waiting, n))

    # -- pending-queue internals (cond held) --------------------------------
    def _append_one(self, entry: Tuple[int, bytes, int,
                                       Optional[dict]]) -> None:
        self._tail.append(entry)
        self._count += 1

    def _append_block(self, entries: list) -> None:
        if not entries:
            return
        if self._tail:
            self._blocks.append([self._tail, 0])
            self._tail = []
        self._blocks.append([entries, 0])
        self._count += len(entries)

    def _pop_entries(self, max_n: int) -> list:
        """Up to max_n pending tuples in FIFO order (cond held,
        _count > 0). Whole-block handovers return the block's list
        itself (owned by this subscription — see enqueue_many) with
        zero per-message work; receivers treat returned token lists as
        read-only until settled (chunk entries alias them)."""
        k = min(max_n, self._count)
        self._count -= k
        parts = []
        taken = 0
        while taken < k:
            if not self._blocks:
                self._blocks.append([self._tail, 0])
                self._tail = []
            blk = self._blocks[0]
            lst, off = blk
            avail = len(lst) - off
            take = min(k - taken, avail)
            if take == avail:
                self._blocks.popleft()
                parts.append(lst if off == 0 else lst[off:])
            else:
                parts.append(lst[off:off + take])
                blk[1] = off + take
            taken += take
        if len(parts) == 1:
            return parts[0]
        return [t for p in parts for t in p]

    def enqueue(self, message_id: int, data: bytes, redeliveries: int = 0,
                properties: Optional[dict] = None):
        with self.cond:
            self._append_one((message_id, data, redeliveries, properties))
            self._notify_if_waiting()

    def enqueue_many(self, entries) -> None:
        """Bulk enqueue of (mid, data, redeliveries, properties)
        tuples: one lock
        acquisition, one block handover, one notify per waiting
        consumer it can feed. The subscription takes OWNERSHIP of a
        list argument (whole-block pops hand it back out); callers
        sharing one list across subscriptions must pass copies
        (publish_many does)."""
        entries = (entries if isinstance(entries, list)
                   else list(entries))
        with self.cond:
            self._append_block(entries)
            self._notify_if_waiting(len(entries))

    def receive(self, timeout_s: Optional[float],
                owner: int) -> Message:
        return self.receive_many(1, timeout_s, owner)[0]

    def receive_many_raw(self, max_n: int, timeout_s: Optional[float],
                         owner: int) -> list:
        """Drain up to max_n pending messages under ONE lock
        acquisition, returning raw ``(message_id, data, redeliveries,
        properties)`` tuples — the zero-wrapper lane for batching consumers whose
        per-event budget is small (the JSON bridge). Blocks
        until at least one message is available or the timeout
        expires."""
        def register(popped):
            self.inflight.update(
                (mid, (data, red, owner, props))
                for mid, data, red, props in popped)

        return self._pop_pending(max_n, timeout_s, register)

    def _pop_pending(self, max_n: int, timeout_s: Optional[float],
                     register=None) -> list:
        """Block until pending is non-empty (or timeout), then bulk-pop
        up to max_n tuples under one lock acquisition (block handover:
        see _pop_entries). ``register`` runs on the popped list UNDER
        THE SAME LOCK — pop and in-flight registration must be atomic,
        or a concurrent close()'s requeue_inflight could run in the
        window where messages exist in neither pending nor inflight
        and lose them."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self.cond:
            # Loop: a competing consumer may steal the message between
            # notify and wake-up, and waits can wake spuriously.
            while not self._count:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ReceiveTimeout(
                            f"no message within {timeout_s}s "
                            f"on {self.name!r}")
                self._waiting += 1
                try:
                    self.cond.wait(remaining)
                finally:
                    self._waiting -= 1
            popped = self._pop_entries(max_n)
            if register is not None:
                register(popped)
            if self._obs_recv_msgs is not None:
                self._obs_recv_msgs.inc(len(popped))
                self._obs_recv_bytes.inc(sum(len(t[1]) for t in popped))
            return popped

    def receive_chunk(self, max_n: int, timeout_s: Optional[float],
                      owner: int) -> Tuple[int, list]:
        """The chunk lane: like receive_many_raw, but the whole batch
        is tracked as ONE in-flight entry keyed by a chunk id — the
        per-message inflight dict traffic (the dominant broker cost at
        the JSON wire) drops to one dict op per BATCH. The caller
        settles the chunk wholesale (acknowledge_chunk / nack_chunk) or
        explodes it into per-message entries when it needs per-message
        ack/nack (the poison path)."""
        cid_box = []

        def register(popped):
            cid = next(self._chunk_ids)
            self.chunk_inflight[cid] = (popped, owner)
            cid_box.append(cid)

        popped = self._pop_pending(max_n, timeout_s, register)
        return cid_box[0], popped

    def acknowledge_chunk(self, chunk_id: int) -> None:
        with self.cond:
            self.chunk_inflight.pop(chunk_id, None)

    def nack_chunk(self, chunk_id: int) -> None:
        """Wholesale negative-ack: requeue every message of the chunk
        with a bumped redelivery count."""
        with self.cond:
            entry = self.chunk_inflight.pop(chunk_id, None)
            if entry is not None:
                requeued = [(mid, data, red + 1, props)
                            for mid, data, red, props in entry[0]]
                self._append_block(requeued)
                self._notify_if_waiting(len(requeued))
                if self._obs_redelivered is not None:
                    self._obs_redelivered.inc(len(requeued))

    def explode_chunk(self, chunk_id: int) -> None:
        """Convert a chunk's messages into ordinary per-message
        in-flight entries so the per-message ack/nack surface applies
        (rare: the bridge's poison path)."""
        with self.cond:
            entry = self.chunk_inflight.pop(chunk_id, None)
            if entry is not None:
                popped, owner = entry
                self.inflight.update(
                    (mid, (data, red, owner, props))
                    for mid, data, red, props in popped)

    def receive_many(self, max_n: int, timeout_s: Optional[float],
                     owner: int) -> list:
        """Like receive_many_raw, wrapped in Message objects (the
        Pulsar batch_receive shape); receive() is the max_n=1 case."""
        return [Message(data, mid, red, props)
                for mid, data, red, props
                in self.receive_many_raw(max_n, timeout_s, owner)]

    def acknowledge(self, message_id: int) -> None:
        with self.cond:
            self.inflight.pop(message_id, None)

    def acknowledge_many(self, message_ids) -> None:
        with self.cond:
            for mid in message_ids:
                self.inflight.pop(mid, None)

    def negative_acknowledge(self, message_id: int) -> None:
        with self.cond:
            entry = self.inflight.pop(message_id, None)
            if entry is not None:
                data, redeliveries, _, props = entry
                self._append_one((message_id, data, redeliveries + 1,
                                  props))
                self._notify_if_waiting()
                if self._obs_redelivered is not None:
                    self._obs_redelivered.inc()

    def requeue_inflight(self, owner: int) -> None:
        """Crash takeover: return the closing consumer's own unacked
        messages (per-message AND chunk entries) to the queue; other
        consumers' deliveries stay theirs.

        Requeued entries go to the HEAD of the pending queue, in
        publish (message-id) order: a successor consumer then replays
        the dead consumer's window BEFORE the undelivered backlog —
        the order an event-time consumer can bound a lateness budget
        for."""
        with self.cond:
            mine = [(mid, d, r + 1, p)
                    for mid, (d, r, o, p) in self.inflight.items()
                    if o == owner]
            for mid, _, _, _ in mine:
                del self.inflight[mid]
            my_chunks = [cid for cid, (_, o) in self.chunk_inflight.items()
                         if o == owner]
            for cid in my_chunks:
                popped, _ = self.chunk_inflight.pop(cid)
                mine.extend((mid, data, red + 1, props)
                            for mid, data, red, props in popped)
            if mine:
                # Message ids are allocated monotonically at publish,
                # so sorting restores the exact original order across
                # the per-message and chunk in-flight maps.
                mine.sort(key=lambda t: t[0])
                self._blocks.appendleft([mine, 0])
                self._count += len(mine)
                self.cond.notify_all()
                if self._obs_redelivered is not None:
                    self._obs_redelivered.inc(len(mine))

    def backlog(self) -> int:
        with self.cond:
            return (self._count + len(self.inflight)
                    + sum(len(popped) for popped, _
                          in self.chunk_inflight.values()))


class _Topic:
    def __init__(self, name: str):
        self.name = name
        self.lock = threading.Lock()
        self.subscriptions: Dict[str, _Subscription] = {}
        # (mid, data, properties)
        self.retained: Deque[Tuple[int, bytes, Optional[dict]]] = deque(
            maxlen=RETAINED_LIMIT)
        self._ids = itertools.count()

    def subscription(self, name: str) -> _Subscription:
        with self.lock:
            sub = self.subscriptions.get(name)
            if sub is None:
                sub = self.subscriptions[name] = _Subscription(
                    name, topic=self.name)
                # A new subscription starts at the earliest retained
                # message (the generator may run before the processor).
                sub.enqueue_many([(mid, data, 0, props)
                                  for mid, data, props in self.retained])
            return sub

    def publish(self, data: bytes,
                properties: Optional[dict] = None) -> int:
        with self.lock:
            mid = next(self._ids)
            self.retained.append((mid, data, properties))
            subs = list(self.subscriptions.values())
        for sub in subs:
            sub.enqueue(mid, data, properties=properties)
        return mid

    def publish_many(self, datas, properties=None) -> int:
        """Bulk publish: one id/retention pass and one enqueue_many per
        subscription for the whole batch (per-message publish pays a
        lock round-trip per message). ``properties`` is an optional per-message list
        aligned with ``datas``. Returns the FIRST assigned message id;
        ids are consecutive."""
        if properties is None:
            properties = [None] * len(datas)
        with self.lock:
            entries = [(next(self._ids), bytes(d), p)
                       for d, p in zip(datas, properties)]
            self.retained.extend(entries)
            subs = list(self.subscriptions.values())
        tuples = [(mid, d, 0, p) for mid, d, p in entries]
        # Each subscription takes ownership of its block (whole-block
        # pops hand the list back out): one shared list across subs
        # would alias a consumer's returned batch with another sub's
        # live pending queue.
        for i, sub in enumerate(subs):
            sub.enqueue_many(tuples if i == 0 else list(tuples))
        return entries[0][0] if entries else -1


class MemoryBroker:
    """Process-wide topic registry (one per process, like one broker)."""

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
            t = self._topics.get(name)
            if t is None:
                t = self._topics[name] = _Topic(name)
            return t


class MemoryProducer:
    def __init__(self, topic: _Topic):
        self._topic = topic
        self._closed = False
        self._seq = itertools.count()
        from attendance_tpu_torch import obs
        t = obs.get()
        # Captured once: with telemetry off (or metrics only) every send
        # below pays one branch.
        self._tracer = t.tracer if t is not None else None
        self._obs_msgs = self._obs_bytes = None
        if t is not None:
            self._obs_msgs = t.registry.counter(
                "attendance_broker_sent_messages_total",
                help="Messages published", topic=topic.name)
            self._obs_bytes = t.registry.counter(
                "attendance_broker_sent_bytes_total",
                help="Payload bytes published", topic=topic.name)

    def send(self, data: bytes, properties: Optional[dict] = None) -> int:
        if self._closed:
            raise RuntimeError("producer closed")
        if self._obs_msgs is not None:
            self._obs_msgs.inc()
            self._obs_bytes.inc(len(data))
        if self._tracer is not None:
            # Root (or continue) the message's trace and carry its
            # context in the message properties.
            span, properties = self._tracer.begin_publish(
                self._topic.name, next(self._seq), properties)
            try:
                return self._topic.publish(bytes(data), properties)
            finally:
                self._tracer.end_span(span)
        return self._topic.publish(bytes(data), properties)

    def send_many(self, datas, properties=None) -> int:
        """Bulk send (a memory-broker extension; callers feature-detect):
        one broker pass for the whole batch. ``properties`` is an
        optional per-message list. Returns the first id."""
        if self._closed:
            raise RuntimeError("producer closed")
        if self._obs_msgs is not None:
            datas = [bytes(d) for d in datas]
            self._obs_msgs.inc(len(datas))
            self._obs_bytes.inc(sum(len(d) for d in datas))
        if self._tracer is not None and properties is None:
            span, properties = self._tracer.begin_publish_many(
                self._topic.name, next(self._seq), len(datas))
            try:
                return self._topic.publish_many(datas, properties)
            finally:
                self._tracer.end_span(span)
        return self._topic.publish_many(datas, properties)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._closed = True


_consumer_ids = itertools.count()


class MemoryConsumer:
    def __init__(self, sub: _Subscription):
        self._sub = sub
        self._closed = False
        self._id = next(_consumer_ids)

    def receive(self, timeout_millis: Optional[int] = None) -> Message:
        if self._closed:
            raise RuntimeError("consumer closed")
        timeout_s = None if timeout_millis is None else timeout_millis / 1e3
        return self._sub.receive(timeout_s, self._id)

    def receive_many(self, max_n: int,
                     timeout_millis: Optional[int] = None) -> list:
        """Batch receive: up to max_n already-pending messages in one
        call (the batching consumers' fast lane; one lock round-trip
        instead of one per message)."""
        if self._closed:
            raise RuntimeError("consumer closed")
        timeout_s = None if timeout_millis is None else timeout_millis / 1e3
        return self._sub.receive_many(max_n, timeout_s, self._id)

    def receive_many_raw(self, max_n: int,
                         timeout_millis: Optional[int] = None) -> list:
        """Batch receive as raw (message_id, data, redeliveries,
        properties) tuples — no Message wrappers. Ack with
        acknowledge_ids; reconstruct a Message(data, message_id,
        redeliveries) only on the poison path. Memory-broker extension (the real pulsar
        client has no such lane; callers feature-detect)."""
        if self._closed:
            raise RuntimeError("consumer closed")
        timeout_s = None if timeout_millis is None else timeout_millis / 1e3
        return self._sub.receive_many_raw(max_n, timeout_s, self._id)

    def receive_chunk(self, max_n: int,
                      timeout_millis: Optional[int] = None
                      ) -> Tuple[int, list]:
        """Chunk-lane batch receive: (chunk_id, raw tuples). The whole
        chunk is ONE in-flight entry; settle it with acknowledge_chunk
        / nack_chunk, or explode_chunk into per-message entries for the
        per-message ack/nack surface (poison handling). Memory-broker
        extension; callers feature-detect."""
        if self._closed:
            raise RuntimeError("consumer closed")
        timeout_s = None if timeout_millis is None else timeout_millis / 1e3
        return self._sub.receive_chunk(max_n, timeout_s, self._id)

    def acknowledge_chunk(self, chunk_id: int) -> None:
        self._sub.acknowledge_chunk(chunk_id)

    def nack_chunk(self, chunk_id: int) -> None:
        self._sub.nack_chunk(chunk_id)

    def explode_chunk(self, chunk_id: int) -> None:
        self._sub.explode_chunk(chunk_id)

    def acknowledge_ids(self, message_ids) -> None:
        self._sub.acknowledge_many(message_ids)

    def acknowledge(self, msg: Message) -> None:
        self._sub.acknowledge(msg.message_id)

    def acknowledge_many(self, msgs) -> None:
        self._sub.acknowledge_many([m.message_id for m in msgs])

    def negative_acknowledge(self, msg: Message) -> None:
        self._sub.negative_acknowledge(msg.message_id)

    def backlog(self) -> int:
        return self._sub.backlog()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._sub.requeue_inflight(self._id)


class MemoryClient:
    """pulsar.Client call-shape over the in-process broker."""

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
