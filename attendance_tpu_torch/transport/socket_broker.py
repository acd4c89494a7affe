"""Cross-process broker transport: the memory broker behind a TCP front.

Counterpart of ``attendance_tpu/transport/socket_broker.py`` without its
chaos and telemetry hooks, and the same wire byte for byte, so a port
client talks to a JAX :class:`BrokerServer` and the other way round. A
:class:`BrokerServer` hosts a :class:`MemoryBroker` (shared
subscriptions, ack/nack, redelivery, crash takeover) behind a
length-prefixed TCP protocol, and :class:`SocketClient` speaks the
memory client's producer/consumer call shape, raw and chunk lanes
included, so the processor, the bridge and the fused pipeline scale
across processes by pointing at a broker address.

When a client connection drops (crash, kill), the server closes that
connection's consumers, requeueing their unacked messages for the
surviving competitors.

Protocol (little-endian, ``transport.framing``): request = u8 opcode,
u32 body_len, body; reply = u8 status (0 ok / 1 timeout / 2 error), u32
body_len, body. One request in flight per connection; batch receives
amortize the round trip. Message properties ride as a u32-length-
prefixed JSON dict next to each payload in both directions.

Run a standalone broker with ``python -m
attendance_tpu_torch.transport.socket_broker`` (``--port 0`` for an
ephemeral port, printed on startup).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from attendance_tpu_torch.transport.framing import (
    HDR as _HDR, dec_message_batch, dec_props as _dec_props,
    enc_message_batch, enc_props as _enc_props, enc_str,
    recv_exact as _recv_exact, recv_frame as _recv_frame,
    send_frame as _send_frame)
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryConsumer, Message, ReceiveTimeout)
from attendance_tpu_torch.transport.resilience import (  # noqa: F401
    BrokerUnavailable, RetryPolicy, resilient_call)

logger = logging.getLogger(__name__)

_OP_PRODUCE = 1
_OP_SUBSCRIBE = 2
_OP_RECEIVE = 3
_OP_ACK_IDS = 4
_OP_NACK = 5
_OP_BACKLOG = 6
_OP_CLOSE_CONSUMER = 7
_OP_PRODUCE_MANY = 8
_OP_RECEIVE_CHUNK = 9
_OP_ACK_CHUNK = 10
_OP_NACK_CHUNK = 11
_OP_EXPLODE_CHUNK = 12

_ST_OK = 0
_ST_TIMEOUT = 1
_ST_ERROR = 2

# Default port of the standalone broker (python -m ...socket_broker) and
# of Config.socket_broker — one constant so the out-of-box recipe works.
DEFAULT_PORT = 6655

# Server-side cap on one blocking wait; a client "no timeout" receive
# loops these so a dead server can't hang a client thread forever
# (the socket timeout below is the backstop).
_MAX_WAIT_MS = 10_000


class BrokerServer:
    """TCP front over a MemoryBroker; one thread per client connection.

    The per-connection thread model matches the workload: a handful of
    producer/consumer processes each holding one connection, with batch
    receives doing the heavy lifting per round-trip.
    """

    def __init__(self, broker: Optional[MemoryBroker] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.broker = broker or MemoryBroker()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self._stopping = False
        self._accept_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # (topic, subscription) -> live socket-consumer count, for
        # coordination (a test/parent can wait until N competitors
        # joined before publishing).
        self._consumer_counts: Dict[Tuple[str, str], int] = {}

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "BrokerServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="broker-accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stopping = True
        try:
            self._sock.close()
        except OSError:
            pass

    def consumer_count(self, topic: str, subscription: str) -> int:
        with self._lock:
            return self._consumer_counts.get((topic, subscription), 0)

    # -- connection handling -------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_connection,
                             args=(conn, addr),
                             name=f"broker-conn-{addr[1]}",
                             daemon=True).start()

    def _serve_connection(self, conn: socket.socket, addr) -> None:
        # handle -> (MemoryConsumer, topic, subscription) owned by THIS
        # connection; a dropped connection requeues exactly these.
        consumers: Dict[int, tuple] = {}
        # Handles cross the wire as u32; exhausting the range surfaces
        # as a protocol error from alloc() BEFORE any registration, not
        # a struct.error after it.
        handle_counter = iter(range(1 << 32))
        try:
            while True:
                try:
                    op, body = _recv_frame(conn)
                except ConnectionError:
                    break
                try:
                    status, reply = self._handle(
                        op, body, consumers,
                        alloc=lambda: next(handle_counter))
                except Exception as exc:  # protocol keeps flowing
                    status, reply = _ST_ERROR, repr(exc).encode()
                try:
                    _send_frame(conn, status, reply)
                except (ConnectionError, OSError):
                    # Peer dropped mid-reply (fast client teardown
                    # severs connections abruptly): normal shutdown.
                    break
        finally:
            conn.close()
            # Cross-process crash takeover: close every consumer this
            # connection owned (requeues its unacked messages).
            for consumer, topic, sub in consumers.values():
                consumer.close()
                with self._lock:
                    self._consumer_counts[(topic, sub)] -= 1

    def _handle(self, op: int, body: bytes, consumers: Dict[int, tuple],
                alloc) -> Tuple[int, bytes]:
        if op == _OP_PRODUCE:
            (tlen,) = struct.unpack_from("<H", body)
            topic = body[2:2 + tlen].decode()
            props, off = _dec_props(body, 2 + tlen)
            payload = body[off:]
            mid = self.broker.topic(topic).publish(payload, props)
            return _ST_OK, struct.pack("<Q", mid)
        if op == _OP_SUBSCRIBE:
            (tlen,) = struct.unpack_from("<H", body)
            topic = body[2:2 + tlen].decode()
            (slen,) = struct.unpack_from("<H", body, 2 + tlen)
            sub = body[4 + tlen:4 + tlen + slen].decode()
            consumer = MemoryConsumer(
                self.broker.topic(topic).subscription(sub))
            # Allocate the handle only once the consumer exists, and
            # consume it in the same expression that registers the
            # entry: a fresh handle per alloc() means a partially
            # completed subscribe can never hand its handle to the next
            # one and orphan a registered consumer's inflight messages.
            handle = alloc()
            consumers[handle] = (consumer, topic, sub)
            with self._lock:
                key = (topic, sub)
                self._consumer_counts[key] = (
                    self._consumer_counts.get(key, 0) + 1)
            return _ST_OK, struct.pack("<I", handle)
        if op == _OP_PRODUCE_MANY:
            (tlen,) = struct.unpack_from("<H", body)
            topic = body[2:2 + tlen].decode()
            off = 2 + tlen
            (count,) = struct.unpack_from("<I", body, off)
            off += 4
            datas, props = [], []
            for _ in range(count):
                p, off = _dec_props(body, off)
                props.append(p)
                (dlen,) = struct.unpack_from("<I", body, off)
                off += 4
                datas.append(body[off:off + dlen])
                off += dlen
            first = self.broker.topic(topic).publish_many(datas, props)
            return _ST_OK, struct.pack("<q", first)
        if op in (_OP_RECEIVE, _OP_RECEIVE_CHUNK):
            handle, max_n, timeout_ms = struct.unpack("<IIi", body)
            consumer = consumers[handle][0]
            timeout_ms = min(timeout_ms, _MAX_WAIT_MS)
            try:
                if op == _OP_RECEIVE_CHUNK:
                    cid, msgs = consumer.receive_chunk(
                        max_n, timeout_millis=timeout_ms)
                else:
                    cid = 0
                    msgs = consumer.receive_many_raw(
                        max_n, timeout_millis=timeout_ms)
            except ReceiveTimeout:
                return _ST_TIMEOUT, b""
            return _ST_OK, enc_message_batch(cid, msgs)
        if op == _OP_ACK_CHUNK:
            handle, cid = struct.unpack("<IQ", body)
            consumers[handle][0].acknowledge_chunk(cid)
            return _ST_OK, b""
        if op == _OP_NACK_CHUNK:
            handle, cid = struct.unpack("<IQ", body)
            consumers[handle][0].nack_chunk(cid)
            return _ST_OK, b""
        if op == _OP_EXPLODE_CHUNK:
            handle, cid = struct.unpack("<IQ", body)
            consumers[handle][0].explode_chunk(cid)
            return _ST_OK, b""
        if op == _OP_ACK_IDS:
            handle, n = struct.unpack_from("<II", body)
            mids = struct.unpack_from(f"<{n}Q", body, 8)
            consumers[handle][0].acknowledge_ids(mids)
            return _ST_OK, b""
        if op == _OP_NACK:
            handle, mid = struct.unpack("<IQ", body)
            consumers[handle][0].negative_acknowledge(
                Message(b"", mid, 0))
            return _ST_OK, b""
        if op == _OP_BACKLOG:
            (handle,) = struct.unpack("<I", body)
            return _ST_OK, struct.pack(
                "<Q", consumers[handle][0].backlog())
        if op == _OP_CLOSE_CONSUMER:
            (handle,) = struct.unpack("<I", body)
            entry = consumers.pop(handle, None)
            if entry is not None:
                consumer, topic, sub = entry
                consumer.close()
                with self._lock:
                    self._consumer_counts[(topic, sub)] -= 1
            return _ST_OK, b""
        return _ST_ERROR, f"unknown opcode {op}".encode()


class _Rpc:
    """One synchronous request/reply channel to the server. A client's
    producers share the client channel under the lock (their calls are
    short round-trips); each consumer gets a DEDICATED channel, because
    a blocking receive holds its channel for up to a full server wait
    round (~10s) and must not stall producers or sibling consumers used
    from other threads of the same client.

    The channel is RECONNECTABLE: a transport failure marks it broken
    (and severs the socket — the server's connection-drop takeover then
    requeues any in-flight deliveries), and :meth:`reconnect` opens a
    fresh connection and bumps ``generation`` so session-holding
    callers (consumers) know their server-side handle died with the old
    connection and must re-subscribe. The retry loop around both lives
    in transport/resilience.resilient_call."""

    def __init__(self, address: str):
        self._address = address
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.generation = 0
        self.reconnects = 0
        self._connect_locked()

    def _connect_locked(self) -> None:
        host, port = self._address.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Backstop: the server bounds each blocking wait at
        # _MAX_WAIT_MS, so a healthy server always replies well within
        # this; only a dead/hung server trips it.
        sock.settimeout(_MAX_WAIT_MS / 1000 + 30)
        self._sock = sock

    @property
    def broken(self) -> bool:
        return self._sock is None

    def _sever_locked(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def reconnect(self) -> None:
        """Open a fresh connection (idempotent: a sibling thread that
        already reconnected wins). Bumping ``generation`` is what tells
        consumers their server-side session is gone."""
        with self._lock:
            if self._sock is not None:
                return
            self._connect_locked()
            self.generation += 1
            self.reconnects += 1

    def call(self, op: int, body: bytes) -> Tuple[int, bytes]:
        """ONE attempt; transport failures sever the channel and
        propagate (resilient_call owns the retry/reconnect loop)."""
        with self._lock:
            # Local capture: close() nulls self._sock WITHOUT the lock
            # (it must wake a parked recv, never queue behind it), so
            # every use below goes through this snapshot — a racing
            # close turns into an OSError from the closed fd, which is
            # the designed sever-and-retry path, not an AttributeError.
            sock = self._sock
            if sock is None:
                raise ConnectionError("broker connection is down")
            try:
                _send_frame(sock, op, body)
                return _recv_frame(sock)
            except (ConnectionError, OSError):
                self._sever_locked()
                raise

    def try_call(self, op: int, body: bytes
                 ) -> Optional[Tuple[int, bytes]]:
        """call(), but None instead of waiting when another thread
        holds the channel (e.g. parked in a blocking receive) or the
        channel is broken (teardown must not reconnect)."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            sock = self._sock  # close() may null it concurrently
            if sock is None:
                return None
            try:
                _send_frame(sock, op, body)
                return _recv_frame(sock)
            except (ConnectionError, OSError):
                self._sever_locked()
                raise
        finally:
            self._lock.release()

    def close(self) -> None:
        # shutdown() first so a thread parked in recv() on this channel
        # wakes immediately instead of waiting out the server round.
        sock = self._sock
        self._sock = None
        if sock is None:
            return
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass


def _check(status: int, reply: bytes) -> bytes:
    if status == _ST_ERROR:
        raise RuntimeError(f"broker error: {reply.decode(errors='replace')}")
    return reply


class SocketProducer:
    def __init__(self, rpc: _Rpc, topic: str,
                 policy: Optional[RetryPolicy] = None):
        self._rpc = rpc
        self._topic = topic
        self._policy = policy or RetryPolicy()
        self._prefix = enc_str(topic)
        self._closed = False

    def send(self, data: bytes, properties=None) -> int:
        if self._closed:
            raise RuntimeError("producer closed")
        body = self._prefix + _enc_props(properties) + bytes(data)
        # A retried publish whose first attempt did execute (reply lost)
        # duplicates the message; every downstream sink is idempotent.
        status, reply = resilient_call(
            self._rpc, lambda: (_OP_PRODUCE, body),
            site="socket.produce", policy=self._policy,
            aborted=lambda: self._closed)
        (mid,) = struct.unpack("<Q", _check(status, reply))
        return mid

    def send_many(self, datas, properties=None) -> int:
        """Bulk send: one round trip and one broker pass for the whole
        batch. ``properties`` is an optional per-message list. Returns
        the first assigned id."""
        if self._closed:
            raise RuntimeError("producer closed")
        datas = [bytes(d) for d in datas]
        if properties is None:
            properties = [None] * len(datas)
        parts = [self._prefix, struct.pack("<I", len(datas))]
        for d, p in zip(datas, properties):
            parts.append(_enc_props(p))
            parts.append(struct.pack("<I", len(d)))
            parts.append(d)
        body = b"".join(parts)
        status, reply = resilient_call(
            self._rpc, lambda: (_OP_PRODUCE_MANY, body),
            site="socket.produce", policy=self._policy,
            aborted=lambda: self._closed)
        (first,) = struct.unpack("<q", _check(status, reply))
        return first

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._closed = True


class SocketConsumer:
    """Consumer call-shape of MemoryConsumer over the socket protocol,
    including the raw and chunk lanes (the fused pipeline's chunk
    consumer and the bridge read them) and batch acks.

    Single-message ``receive()`` — the fused pipeline's frame loop —
    is PREFETCHED: one server round-trip pulls up to ``prefetch``
    pending messages and the surplus is buffered client-side, so a
    backlog of binary frames costs one RPC per ``prefetch`` frames
    instead of one per frame. Crash semantics are unchanged:
    buffered messages are still in-flight AT THE SERVER, so a dropped
    connection requeues them for the surviving competitors exactly
    like un-received ones.

    Session resume: every RPC rides transport/resilience.resilient_call
    — a severed connection (peer reset, broker restart, injected
    reset) reconnects transparently and, because the
    server-side consumer handle died with the old connection, the
    consumer RE-SUBSCRIBES for a fresh handle before retrying. The
    server's connection-drop takeover requeued everything the old
    session held in flight (prefetch buffer included — it is dropped
    on resume), so redelivery covers exactly what the reconnect could
    have lost: live reconnects reuse the crash-takeover machinery. A
    broker that stays down past the retry budget surfaces ONE
    ``BrokerUnavailable``."""

    PREFETCH = 16

    def __init__(self, rpc: _Rpc, handle: int, owns_rpc: bool = False,
                 owner: "Optional[SocketClient]" = None,
                 topic: str = "", subscription: str = "",
                 prefetch: int = PREFETCH,
                 policy: Optional[RetryPolicy] = None,
                 lane: Optional[int] = None):
        self._rpc = rpc
        self._handle = handle
        self._owns_rpc = owns_rpc
        self._owner = owner
        self._closed = False
        self._prefetch = max(1, prefetch)
        self._buffered: "deque" = deque()
        self._policy = policy or RetryPolicy()
        self._session_gen = rpc.generation
        self._sub_body = _subscribe_body(topic, subscription)
        self.lane = lane  # striped-ingress lane index (None = unlaned)
        self.resubscribes = 0

    def _ensure_session(self) -> None:
        """Re-subscribe after a transport reconnect: the server-side
        consumer handle (and its in-flight state, prefetch buffer
        included) died with the old connection — its unacked messages
        were requeued by the connection-drop takeover and will
        redeliver to the NEW session, so dropping the stale client
        buffer loses nothing and keeps delivery in order."""
        if self._rpc.generation == self._session_gen:
            return
        status, reply = self._rpc.call(_OP_SUBSCRIBE, self._sub_body)
        (self._handle,) = struct.unpack("<I", _check(status, reply))
        self._session_gen = self._rpc.generation
        self._buffered.clear()
        self.resubscribes += 1
        logger.info("socket consumer re-subscribed after reconnect "
                    "(session %d)", self._session_gen)

    def _call(self, op: int, body_fn) -> Tuple[int, bytes]:
        """One consumer RPC through the deadline+retry helper;
        ``body_fn`` rebuilds the body per attempt so it embeds the
        CURRENT handle after a session resume."""
        return resilient_call(
            self._rpc, lambda: (op, body_fn()),
            site="socket.consume", policy=self._policy,
            ensure_session=self._ensure_session,
            aborted=lambda: self._closed)

    def _receive_op(self, op: int, max_n: int,
                    timeout_millis: Optional[int]):
        if self._closed:
            raise RuntimeError("consumer closed")
        # The server bounds one blocking wait at _MAX_WAIT_MS, so both
        # long and absent timeouts are chunked client-side.
        deadline = (None if timeout_millis is None
                    else time.monotonic() + timeout_millis / 1e3)
        while True:
            if self._closed:
                # close()/client.close() from another thread between
                # wait rounds: surface the clean shutdown signal, not
                # the dead handle's server error.
                raise RuntimeError("consumer closed")
            if deadline is None:
                wait = _MAX_WAIT_MS
            else:
                rem_ms = int((deadline - time.monotonic()) * 1000)
                if rem_ms <= 0:
                    raise ReceiveTimeout(
                        f"no message within {timeout_millis}ms")
                wait = min(rem_ms, _MAX_WAIT_MS)
            status, reply = self._call(
                op, lambda: struct.pack("<IIi", self._handle, max_n,
                                        int(wait)))
            if status == _ST_TIMEOUT:
                continue  # deadline not reached yet: wait again
            return dec_message_batch(_check(status, reply))

    def receive_many_raw(self, max_n: int,
                         timeout_millis: Optional[int] = None) -> list:
        # Serve (and fully drain, up to max_n) any prefetched messages
        # first: a consumer mixing receive() with the batch lanes must
        # never see buffered messages reordered behind later ones.
        if self._buffered:
            out = []
            while self._buffered and len(out) < max_n:
                out.append(self._buffered.popleft())
            return out
        return self._receive_op(_OP_RECEIVE, max_n, timeout_millis)[1]

    def receive_chunk(self, max_n: int,
                      timeout_millis: Optional[int] = None
                      ) -> Tuple[int, list]:
        """Chunk-lane batch receive over the wire: one server-side
        in-flight entry for the whole batch, settled with
        acknowledge_chunk / nack_chunk / explode_chunk — the bridge's
        feature-detected fast lane works identically cross-process.

        Incompatible with single-message ``receive()`` on the SAME
        consumer: prefetched messages cannot be folded into a chunk
        handle, so serving the chunk lane past a non-empty buffer
        would deliver out of order (or strand the buffered messages
        until connection drop). No component mixes the lanes; fail
        loudly if one starts to."""
        if self._buffered:
            raise RuntimeError(
                "receive_chunk after receive() left prefetched "
                "messages buffered — don't mix the chunk lane with "
                "single-message receive on one consumer")
        return self._receive_op(_OP_RECEIVE_CHUNK, max_n, timeout_millis)

    def acknowledge_chunk(self, chunk_id: int) -> None:
        # Settling a chunk from a PRE-reconnect session is a server-
        # side no-op: the takeover already requeued it, and those
        # messages redeliver (at-least-once, like every retry here).
        _check(*self._call(
            _OP_ACK_CHUNK,
            lambda: struct.pack("<IQ", self._handle, chunk_id)))

    def nack_chunk(self, chunk_id: int) -> None:
        _check(*self._call(
            _OP_NACK_CHUNK,
            lambda: struct.pack("<IQ", self._handle, chunk_id)))

    def explode_chunk(self, chunk_id: int) -> None:
        _check(*self._call(
            _OP_EXPLODE_CHUNK,
            lambda: struct.pack("<IQ", self._handle, chunk_id)))

    def receive_many(self, max_n: int,
                     timeout_millis: Optional[int] = None) -> list:
        return [Message(data, mid, red, props) for mid, data, red, props
                in self.receive_many_raw(max_n, timeout_millis)]

    def receive(self, timeout_millis: Optional[int] = None) -> Message:
        """One message, served from the prefetch buffer when possible
        (ONE round-trip per ``prefetch`` backlog messages — see the
        class docstring)."""
        if not self._buffered:
            self._buffered.extend(self._receive_op(
                _OP_RECEIVE, self._prefetch, timeout_millis)[1])
        mid, data, red, props = self._buffered.popleft()
        return Message(data, mid, red, props)

    def acknowledge_ids(self, message_ids) -> None:
        mids = list(message_ids)
        _check(*self._call(
            _OP_ACK_IDS,
            lambda: struct.pack(f"<II{len(mids)}Q", self._handle,
                                len(mids), *mids)))

    def acknowledge(self, msg: Message) -> None:
        self.acknowledge_ids([msg.message_id])

    def acknowledge_many(self, msgs) -> None:
        self.acknowledge_ids([m.message_id for m in msgs])

    def negative_acknowledge(self, msg: Message) -> None:
        # Only the id crosses the wire: the subscription re-derives the
        # redelivery count from its own in-flight state on requeue.
        _check(*self._call(
            _OP_NACK,
            lambda: struct.pack("<IQ", self._handle, msg.message_id)))

    def backlog(self) -> int:
        status, reply = self._call(
            _OP_BACKLOG, lambda: struct.pack("<I", self._handle))
        (n,) = struct.unpack("<Q", _check(status, reply))
        return n

    def _abort(self) -> None:
        """Teardown without the graceful RPC: mark closed, sever the
        owned connection (the server's connection-drop takeover
        requeues unacked messages), deregister from the owner."""
        self._closed = True
        if self._owns_rpc:
            self._rpc.close()
        if self._owner is not None:
            self._owner._consumers.discard(self)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            # Graceful close-RPC only when the channel is free RIGHT
            # NOW: a sibling thread parked in a blocking receive holds
            # it for up to a full server wait round, and severing the
            # connection below yields the same requeue semantics.
            res = self._rpc.try_call(
                _OP_CLOSE_CONSUMER, struct.pack("<I", self._handle))
            if res is not None:
                _check(*res)
        except (ConnectionError, OSError):
            # Broker already gone: its connection-drop takeover has
            # (or will have) requeued this consumer's unacked
            # messages; raising here would only mask the original
            # failure in teardown paths.
            pass
        finally:
            # The dedicated connection must close even when the broker
            # replied with a protocol error (_ST_ERROR -> RuntimeError).
            self._abort()


def _subscribe_body(topic: str, subscription: str) -> bytes:
    return enc_str(topic) + enc_str(subscription)


class SocketClient:
    """pulsar.Client call-shape against a BrokerServer address.

    Producers share the client's channel; every consumer gets its own
    TCP connection (see _Rpc), so threaded producer+consumer use works
    like the memory broker's. Consumer connections are closed by
    consumer.close() and swept by client.close(). ``policy`` shapes the
    retry budget all its RPCs share."""

    def __init__(self, address: str, *,
                 policy: Optional[RetryPolicy] = None):
        self._address = address
        self._policy = policy or RetryPolicy()
        self._rpc = _Rpc(address)
        self._consumers: set = set()

    def create_producer(self, topic: str) -> SocketProducer:
        return SocketProducer(self._rpc, topic, policy=self._policy)

    def subscribe(self, topic: str, subscription_name: str,
                  consumer_type=None, *,
                  lane: Optional[int] = None) -> SocketConsumer:
        del consumer_type  # shared semantics, like the memory broker
        site = ("socket.consume" if lane is None
                else f"socket.consume.lane{lane}")
        rpc = _Rpc(self._address)
        body = _subscribe_body(topic, subscription_name)
        try:
            status, reply = resilient_call(
                rpc, lambda: (_OP_SUBSCRIBE, body),
                site=site, policy=self._policy)
            (handle,) = struct.unpack("<I", _check(status, reply))
        except BaseException:
            rpc.close()
            raise
        consumer = SocketConsumer(rpc, handle, owns_rpc=True, owner=self,
                                  topic=topic,
                                  subscription=subscription_name,
                                  policy=self._policy, lane=lane)
        self._consumers.add(consumer)
        return consumer

    def subscribe_lane(self, topic: str, subscription_name: str,
                       lane: int) -> SocketConsumer:
        """Lane-affine subscribe for the striped ingress plane: the lane
        gets its OWN TCP connection and session, so reconnect, resume
        and crash takeover are per lane (one severed lane never stalls
        its siblings), and its own retry site
        (``socket.consume.laneN``)."""
        return self.subscribe(topic, subscription_name, lane=lane)

    def close(self) -> None:
        # Fast teardown: sever every consumer's dedicated connection
        # instead of the graceful close-RPC — the RPC would serialize
        # behind any thread parked in a blocking receive, and the
        # server's connection-drop takeover requeues unacked messages
        # either way.
        for consumer in list(self._consumers):
            consumer._abort()
        self._consumers.clear()
        self._rpc.close()


def spawn_broker(*, cwd=None):
    """Spawn a standalone broker subprocess on an ephemeral port and
    return ``(proc, addr)`` once its startup line names the address.
    The caller owns teardown (``proc.kill()``)."""
    import subprocess
    import sys

    cmd = [sys.executable, "-m",
           "attendance_tpu_torch.transport.socket_broker", "--port", "0"]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, text=True,
        cwd=None if cwd is None else str(cwd))
    line = (proc.stdout.readline() or "").strip()
    if not line:
        rc = proc.poll()
        raise RuntimeError(
            f"broker subprocess died at startup (rc={rc})")
    return proc, line.rsplit(" ", 1)[-1]


def main(argv=None) -> None:
    """Run a standalone broker process:
    ``python -m attendance_tpu_torch.transport.socket_broker`` (listens
    on the Config.socket_broker default; ``--port 0`` for an ephemeral
    port, printed on startup)."""
    import argparse

    p = argparse.ArgumentParser(
        description="attendance_tpu_torch socket broker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    args = p.parse_args(argv)
    server = BrokerServer(host=args.host, port=args.port).start()
    print(f"broker listening on {server.address}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
