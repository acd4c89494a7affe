"""Ingress in front of the fused run loop: the one-consumer chunk decode
and the striped ingress lanes.

Counterpart of ``attendance_tpu/pipeline/lanes.py``.

:class:`JsonChunkConsumer` wraps the pipeline's one consumer (the
memory and socket consumers; the shm ring's frames are planar already
and go unwrapped): bulk frames (ATB1, ATB2, COLW) pass through one at a
time, untouched, while a per-event JSON payload makes it drain a whole
chunk of up to ``config.batch_size`` messages, decode them at once
through the codec seam (the native scan, or the vectorized numpy scan
with ``ATP_NATIVE=0``) and hand the run loop one planar frame, one
device dispatch, whose acks and nacks fan back to every message in it.

:class:`StripedConsumer` (``--ingress-lanes N``) stripes ingress over N
:class:`IngressLane` threads. Each lane owns its broker session (on the
socket backend its own TCP connection, ``SocketClient.subscribe_lane``;
on the shm wire its own ring file), drains it on the chunk lane in
micro-batches and decodes off the dispatch thread: a lone binary frame
passes through raw, JSON goes through the batch scan. Lanes hand blocks
to the dispatcher through a bounded queue each (a deque and two
semaphores; no lock is held across a wait); the dispatcher, the
consumer call shape the run loop speaks, coalesces blocks across lanes
into full device batches. Every coalesced frame remembers its lanes:
acks and nacks, the snapshot writer's group commits included, are
queued to each owning lane and performed by its thread between
receives, so a frame is never acked before its barrier is durable,
whichever lane carried it. Lane threads never touch torch: the H2D
copies and launches stay on the dispatch thread and its stream.

The port's lanes read only the chunk lane, which every port consumer
(memory, socket, shm) has; the JAX package's raw and ``Message``
fallbacks, and its obs counters, gauges and profiler marks, are not
ported.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from attendance_tpu_torch.pipeline import codec as codec_mod
from attendance_tpu_torch.transport import (
    PoisonTracker, acknowledge_all, handle_poison)
from attendance_tpu_torch.transport.memory_broker import (
    Message, ReceiveTimeout)

logger = logging.getLogger(__name__)

_POLL_S = 0.02  # dispatcher wait slice while every lane queue is empty


def _native_prefers_vector() -> bool:
    """The ``auto`` decode engine: the native buffer scan when it is
    loaded, the vectorized numpy scan with ``ATP_NATIVE=0``."""
    from attendance_tpu_torch.native import load as load_native
    return load_native() is None


def _decode_each(toks, consumer, config, metrics, tracker, count_nack):
    """A chunk whose batch decode failed, decoded message by message so
    only the bad payloads take the poison path (nack, then dead-letter
    after ``max_redeliveries``). Returns (merged columns of the good
    messages or None, their tuples)."""
    from attendance_tpu_torch.pipeline.events import (
        columns_from_events, decode_event)
    good, parts = [], []
    for tok in toks:
        payload = tok[1]
        try:
            if codec_mod.codec_for_frame(payload).name != "json":
                # Binary and COLW frames: decode_frame raises on a
                # corrupt frame, which dead-letters alone.
                parts.append(codec_mod.decode_frame(payload))
            else:
                parts.append(columns_from_events(
                    [decode_event(bytes(payload))]))
            good.append(tok)
        except Exception:
            handle_poison(Message(tok[1], tok[0], tok[2], tok[3]),
                          consumer, metrics, config, logger,
                          count_nack=count_nack, tracker=tracker)
    if not good:
        return None, ()
    return codec_mod.merge_columns(parts), good


class _NullMetrics:
    """handle_poison's metrics shape when no pipeline metrics are given
    (a lane's dead letters are not the pipeline's nacked batches)."""

    dead_lettered = 0
    nacked_batches = 0


class CoalescedMessage:
    """One classic-consumer coalesced JSON chunk: ``data()`` is the
    assembled canonical planar frame; acks/nacks fan back to every
    constituent broker message (raw tuples)."""

    __slots__ = ("_data", "toks", "message_id", "redelivery_count",
                 "_props")

    def __init__(self, data: bytes, toks: List[tuple]):
        self._data = data
        self.toks = toks
        self.message_id = (toks[0][0], toks[-1][0], len(toks))
        self.redelivery_count = max(t[2] for t in toks)
        self._props = toks[0][3]

    def data(self) -> bytes:
        return self._data

    def properties(self):
        return self._props


class JsonChunkConsumer:
    """Chunk decode in front of a ``receive_many_raw``-capable consumer,
    behind the one-consumer call shape the run loop speaks.

    ``receive`` drains raw messages in batches (one RPC per batch on the
    socket transport); bulk frames pass through one at a time untouched,
    while a JSON payload triggers a whole-chunk drain and one batched
    decode through the codec seam (the native scan when loaded, else
    ``scan_json_batch_columns``), returning a :class:`CoalescedMessage`
    whose planar frame dispatches as one device batch. Poison payloads
    inside a chunk dead-letter one by one; a coalesced frame's messages
    are acked in one broker op."""

    _BULK_WANT = 16  # bulk-frame prefetch depth (SocketConsumer's)

    def __init__(self, consumer, config, metrics=None):
        self.consumer = consumer
        self.config = config
        self._buf: deque = deque()
        self._want = 1  # learn the wire from the first delivery
        # The owning pipeline's metrics: poison payloads settled inside
        # the wrapper count into its nack and dead-letter totals.
        self._metrics = metrics if metrics is not None \
            else _NullMetrics()
        self._poison = PoisonTracker()
        self._engine = None  # resolved lazily: native scan vs vector
        # Host seconds spent decoding JSON chunks (the pipeline charges
        # them to its decode stage).
        self.decode_seconds = 0.0

    def _prefer_vector(self) -> bool:
        """The vectorized numpy scan when the native scan is off."""
        if self._engine is None:
            self._engine = _native_prefers_vector()
        return self._engine

    def receive(self, timeout_millis: Optional[int] = None):
        deadline = (None if timeout_millis is None
                    else time.monotonic() + timeout_millis / 1e3)
        while True:
            rem_ms = (timeout_millis if deadline is None else
                      max(1, int((deadline - time.monotonic()) * 1e3)))
            if not self._buf:
                self._buf.extend(self.consumer.receive_many_raw(
                    self._want, timeout_millis=rem_ms))
            first = self._buf[0][1]
            if codec_mod.codec_for_frame(first).name != "json":
                self._want = self._BULK_WANT
                mid, data, red, props = self._buf.popleft()
                return Message(data, mid, red, props)
            # JSON wire: coalesce a whole chunk into one decode + one
            # dispatch. Top up the buffer once (near-non-blocking) so
            # a standing backlog fills full chunks even right after
            # the learning request.
            self._want = max(1, self.config.batch_size)
            if len(self._buf) < self.config.batch_size:
                try:
                    self._buf.extend(self.consumer.receive_many_raw(
                        self.config.batch_size - len(self._buf),
                        timeout_millis=1))
                except ReceiveTimeout:
                    pass
            toks = []
            while self._buf and len(toks) < self.config.batch_size:
                toks.append(self._buf.popleft())
            t0 = time.perf_counter()
            block = self._decode(toks)
            self.decode_seconds += time.perf_counter() - t0
            if block is not None:
                return block
            # Every payload in the chunk was poison (each settled
            # individually above). Keep receiving inside the caller's
            # window: an instantly-redelivered poison frame must reach
            # its bounded dead-letter here, not ride a fake timeout
            # out of the run loop's idle budget with backlog pending.
            if deadline is not None and time.monotonic() >= deadline:
                raise ReceiveTimeout(
                    f"only poison within {timeout_millis}ms")

    def _decode(self, toks) -> Optional[CoalescedMessage]:
        payloads = [t[1] for t in toks]
        try:
            cols = codec_mod.CODECS["json"].decode(
                payloads, prefer_gil_release=self._prefer_vector())
        except Exception:
            cols, toks = self._decode_poison(toks)
            if cols is None:
                return None
        return CoalescedMessage(
            codec_mod.CODECS["binary"].assemble(cols), toks)

    def _decode_poison(self, toks):
        """Mixed/poison chunk: only the bad payloads dead-letter; on the
        one consumer the unit of nacking is one message."""
        return _decode_each(toks, self.consumer, self.config,
                            self._metrics, self._poison, count_nack=True)

    # -- settlement ---------------------------------------------------------
    def acknowledge(self, msg) -> None:
        if isinstance(msg, CoalescedMessage):
            self.consumer.acknowledge_ids([t[0] for t in msg.toks])
        else:
            self.consumer.acknowledge(msg)

    def acknowledge_many(self, msgs) -> None:
        ids, singles = [], []
        for m in msgs:
            if isinstance(m, CoalescedMessage):
                ids.extend(t[0] for t in m.toks)
            else:
                singles.append(m)
        if ids:
            self.consumer.acknowledge_ids(ids)
        if singles:
            acknowledge_all(self.consumer, singles)

    def negative_acknowledge(self, msg) -> None:
        if isinstance(msg, CoalescedMessage):
            for mid, data, red, props in msg.toks:
                self.consumer.negative_acknowledge(
                    Message(data, mid, red, props))
        else:
            self.consumer.negative_acknowledge(msg)

    def backlog(self) -> int:
        return self.consumer.backlog() + len(self._buf)

    def close(self) -> None:
        self.consumer.close()


# -- striped ingress -----------------------------------------------------------

class _LaneQueue:
    """Bounded single-producer single-consumer block queue: deque append
    and popleft are atomic under the GIL, and two semaphores carry the
    capacity and occupancy handshake, so neither side holds a lock while
    it waits. ``wake`` is the dispatcher's shared doorbell: every put
    sets it, so the dispatcher parks on one event instead of polling N
    queues."""

    def __init__(self, depth: int, wake: threading.Event):
        self._q: deque = deque()
        self._slots = threading.Semaphore(depth)
        self._items = threading.Semaphore(0)
        self._wake = wake

    def put(self, item, *, stop: threading.Event) -> bool:
        """Producer side; False when ``stop`` fired while the queue was
        full (the block is dropped: its messages were never acked and
        redeliver)."""
        while not self._slots.acquire(timeout=0.1):
            if stop.is_set():
                return False
        self._q.append(item)
        self._items.release()
        self._wake.set()
        return True

    def get(self, timeout_s: float):
        if not self._items.acquire(timeout=timeout_s):
            return None
        item = self._q.popleft()
        self._slots.release()
        return item

    def __len__(self) -> int:
        return len(self._q)


class _Block:
    """One lane micro-batch: decoded columns, or one raw binary frame
    passed through; ``chunks`` are the broker's (chunk_id, tuples)
    handles that settle it (None once the poison path exploded them:
    then ``acks``, its message tuples, settle it by id)."""

    __slots__ = ("lane", "cols", "raw", "n", "acks", "chunks", "props",
                 "redeliveries", "key")

    def __init__(self, lane: int, *, cols=None, raw=None, n: int, acks,
                 chunks, props, redeliveries: int, key):
        self.lane = lane
        # Redelivery-stable identity from broker message ids (never
        # id(self), which changes every redelivery and can be reused):
        # the poison tracker counts a frame's own failures by it.
        self.key = key
        self.cols = cols
        self.raw = raw
        self.n = n
        self.acks = acks
        self.chunks = chunks
        self.props = props
        self.redeliveries = redeliveries


class LaneMessage:
    """Message call shape of one coalesced dispatch frame: ``data()`` is
    the canonical planar frame (or the one raw frame passed through);
    acks and nacks fan back out to each owning lane."""

    __slots__ = ("_data", "parts", "message_id", "redelivery_count",
                 "_props")

    def __init__(self, data, parts: List[Tuple[int, _Block]],
                 redeliveries: int, props):
        self._data = data
        self.parts = parts  # [(lane index, block), ...]
        self.message_id = tuple(block.key for _, block in parts)
        self.redelivery_count = redeliveries
        self._props = props

    def data(self):
        return self._data

    def properties(self):
        return self._props


class IngressLane:
    """One lane: an owned broker session and the thread draining it."""

    # One server wait round per lane receive: short, so queued
    # settlements (drained between rounds) and teardown never wait out
    # the socket server's 10 s cap.
    _RPC_WAIT_MS = 50

    def __init__(self, index: int, consumer, config, queue_depth: int,
                 batch_size: int, stop: threading.Event,
                 prefer_vector: bool, wake: threading.Event):
        self.index = index
        self.consumer = consumer
        self.config = config
        self.queue = _LaneQueue(queue_depth, wake)
        self._paused = threading.Event()
        self._batch = batch_size
        self._stop = stop
        self._prefer_vector = prefer_vector
        # Events per message, learnt from the last block: 1 on the JSON
        # wire, a whole frame on the bulk wires. 0 = unknown: the first
        # request asks for one message, so a bulk backlog never arrives
        # as one giant block.
        self._ev_per_msg = 0
        self._poison = PoisonTracker()
        # Asynchronous settlement: acks and nacks from the dispatcher and
        # the snapshot writer are queued here and performed by this
        # lane's thread between receives, so the lane's session has one
        # user and a settlement never waits behind a receive round.
        # Deferring an ack is safe under at-least-once: a crash before
        # it goes out redelivers the frames.
        self._settle_q: deque = deque()
        self.metrics_events = 0
        # Host seconds this lane spent decoding (off the dispatch
        # thread, so not in the run loop's stages).
        self.decode_seconds = 0.0
        self.thread = threading.Thread(
            target=self._run, name=f"ingress-lane-{index}", daemon=True)

    # -- the lane thread -------------------------------------------------------
    def _drain_settlements(self) -> None:
        while self._settle_q:
            op, block = self._settle_q.popleft()
            try:
                if op == "ack":
                    self._ack_now(block)
                else:
                    self._nack_now(block)
            except Exception:
                # Broker gone or the session churned: the frames were
                # settled server-side already or will redeliver.
                logger.warning("lane %d deferred %s failed (frames will "
                               "redeliver)", self.index, op, exc_info=True)

    def _collect_chunks(self) -> list:
        """Chunks totalling up to ``batch_size`` EVENTS (not messages: a
        bulk message is a whole frame), or what arrived when
        ``batch_timeout_s`` expired with at least one. Each receive waits
        at most _RPC_WAIT_MS, and an idle round drains settlements."""
        chunks: list = []
        total_msgs = total_events = 0
        deadline = time.monotonic() + self.config.batch_timeout_s
        while total_events < self._batch and not self._stop.is_set():
            rem_ms = int((deadline - time.monotonic()) * 1000)
            if rem_ms <= 0 and total_msgs:
                break
            want = (1 if self._ev_per_msg == 0 else
                    max(1, (self._batch - total_events) // self._ev_per_msg))
            try:
                cid, toks = self.consumer.receive_chunk(
                    want, timeout_millis=min(max(rem_ms, 1),
                                             self._RPC_WAIT_MS))
            except ReceiveTimeout:
                self._drain_settlements()  # idle: settle promptly
                if total_msgs:
                    break
                deadline = time.monotonic() + self.config.batch_timeout_s
                continue
            chunks.append((cid, toks))
            if len(toks) < max(1, want // 4):
                # A sliver (the broker popped while a publisher was still
                # sending): linger so the rest arrives as one chunk, one
                # settlement, instead of many.
                time.sleep(0.002)
            total_msgs += len(toks)
            # Sizing sniffs the chunk's first payload only: a topic mixes
            # wires only in tests, and a mixed chunk only makes the next
            # request's size approximate. A payload that looks binary but
            # does not parse counts one event (the poison path owns it).
            if codec_mod.codec_for_frame(toks[0][1]).name != "json":
                for tok in toks:
                    try:
                        total_events += codec_mod.frame_event_count(tok[1])
                    except ValueError:
                        total_events += 1
            else:
                total_events += len(toks)
        if total_msgs:
            self._ev_per_msg = max(1, total_events // total_msgs)
        return chunks

    def pause(self) -> None:
        """Park this lane: it stops receiving but keeps settling (acks of
        dispatched blocks must still reach the broker). Its frames stay
        in the broker, and its queued blocks still drain."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._drain_settlements()
            if self._paused.is_set():
                time.sleep(0.05)
                continue
            try:
                chunks = self._collect_chunks()
            except Exception:
                if self._stop.is_set():
                    return  # teardown severed the session
                logger.exception("ingress lane %d receive failed; "
                                 "retrying", self.index)
                time.sleep(0.05)
                continue
            toks = [t for _, ts in chunks for t in ts]
            if not toks:
                continue
            t0 = time.perf_counter()
            try:
                block = self._decode(toks, chunks)
            except Exception:
                block = self._decode_poison(toks, chunks)
            self.decode_seconds += time.perf_counter() - t0
            if block is None or block.n == 0:
                continue
            self.metrics_events += block.n
            if not self.queue.put(block, stop=self._stop):
                return

    def _block_key(self, toks) -> tuple:
        return (self.index, toks[0][0], toks[-1][0], len(toks))

    def _decode(self, toks, chunks) -> _Block:
        payloads = [t[1] for t in toks]
        first = payloads[0]
        red = max(t[2] for t in toks)
        if (len(payloads) == 1
                and codec_mod.codec_for_frame(first).name == "binary"):
            # One bulk binary frame: passed through raw, never repacked.
            return _Block(self.index, raw=first,
                          n=codec_mod.frame_event_count(first), acks=toks,
                          chunks=chunks, props=toks[0][3],
                          redeliveries=red, key=self._block_key(toks))
        cols = codec_mod.codec_for_frame(first).decode(
            payloads, prefer_gil_release=self._prefer_vector)
        return _Block(self.index, cols=cols, n=len(cols["student_id"]),
                      acks=toks, chunks=chunks, props=toks[0][3],
                      redeliveries=red, key=self._block_key(toks))

    def _decode_poison(self, toks, chunks) -> Optional[_Block]:
        """The batch decode failed: per message, so only the poison
        payloads dead-letter. The chunk handles are exploded into
        per-message in-flight entries first (per-message ack and nack
        need them); the good messages then settle by id."""
        for cid, _ in chunks:
            self.consumer.explode_chunk(cid)
        cols, good = _decode_each(toks, self.consumer, self.config,
                                  _NullMetrics(), self._poison,
                                  count_nack=False)
        if cols is None:
            return None
        return _Block(self.index, cols=cols, n=len(cols["student_id"]),
                      acks=list(good), chunks=None, props=good[0][3],
                      redeliveries=max(t[2] for t in good),
                      key=self._block_key(good))

    # -- settlement: queued by the dispatcher and the writer, performed by
    # -- the lane thread (see _settle_q) -----------------------------------
    def ack(self, block: _Block) -> None:
        self._settle_q.append(("ack", block))

    def nack(self, block: _Block) -> None:
        self._settle_q.append(("nack", block))

    def _ack_now(self, block: _Block) -> None:
        if block.chunks is None:  # exploded by the poison path
            self.consumer.acknowledge_ids([t[0] for t in block.acks])
            return
        for cid, _ in block.chunks:
            self.consumer.acknowledge_chunk(cid)

    def _nack_now(self, block: _Block) -> None:
        if block.chunks is None:
            for mid, data, red, props in block.acks:
                self.consumer.negative_acknowledge(
                    Message(data, mid, red, props))
            return
        for cid, _ in block.chunks:
            self.consumer.nack_chunk(cid)


class StripedConsumer:
    """N ingress lanes behind the one-consumer call shape the fused run
    loop speaks (``receive`` / ``acknowledge`` / ``acknowledge_many`` /
    ``negative_acknowledge`` / ``backlog``).

    ``receive`` coalesces ready lane blocks into one canonical frame of
    up to ``dispatch_size`` events; a lone raw binary block passes
    through without a repack."""

    def __init__(self, config, client, topic: str, subscription: str):
        self.config = config
        num_lanes = max(1, config.ingress_lanes)
        if config.lane_decode == "native":
            # JAX's "native" engine is its CPython list scan
            # (native/hostpipe_py.c), which the port does not have; no
            # other engine stands in for it.
            raise NotImplementedError(
                "lane_decode='native' needs the CPython list scan, which "
                "the port does not have; use 'auto' (the native buffer "
                "scan) or 'vector'")
        prefer_vector = (config.lane_decode == "vector"
                         or _native_prefers_vector())
        self._dispatch_size = config.batch_size
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._rr = itertools.cycle(range(num_lanes))
        subscribe_lane = getattr(client, "subscribe_lane", None)
        self.lanes: List[IngressLane] = []
        for i in range(num_lanes):
            consumer = (subscribe_lane(topic, subscription, i)
                        if subscribe_lane is not None
                        else client.subscribe(topic, subscription))
            self.lanes.append(IngressLane(
                i, consumer, config, config.lane_queue_depth,
                self._dispatch_size, self._stop, prefer_vector, self._wake))
        for lane in self.lanes:
            lane.thread.start()

    # -- lane scaling knobs ----------------------------------------------------
    @property
    def active_lanes(self) -> int:
        return sum(1 for lane in self.lanes if not lane.paused)

    def set_active_lanes(self, n: int) -> None:
        """Run the first ``n`` lanes and park the rest (clamped to
        [1, len(lanes)]); parked lanes keep settling and their queued
        blocks still drain."""
        n = max(1, min(int(n), len(self.lanes)))
        for i, lane in enumerate(self.lanes):
            if i < n:
                lane.resume()
            else:
                lane.pause()

    def set_dispatch_size(self, n: int) -> None:
        """Retarget the coalesce size (events per dispatched frame)."""
        self._dispatch_size = max(1, int(n))

    # -- the dispatcher ----------------------------------------------------------
    def _pop_ready(self) -> List[_Block]:
        """Ready blocks round-robin across lanes until the dispatch size
        is met or every queue is momentarily dry."""
        blocks: List[_Block] = []
        total = dry = 0
        while total < self._dispatch_size and dry < len(self.lanes):
            block = self.lanes[next(self._rr)].queue.get(0.0)
            if block is None:
                dry += 1
                continue
            dry = 0
            blocks.append(block)
            total += block.n
        return blocks

    def receive(self, timeout_millis: Optional[int] = None) -> LaneMessage:
        deadline = (None if timeout_millis is None
                    else time.monotonic() + timeout_millis / 1e3)
        while True:
            # Clear, then scan: a put between the scan and the wait sets
            # the doorbell again, so the wait returns at once.
            self._wake.clear()
            blocks = self._pop_ready()
            if blocks:
                return self._coalesce(blocks)
            if self._stop.is_set():
                raise RuntimeError("striped consumer closed")
            if deadline is None:
                self._wake.wait(_POLL_S)
                continue
            rem = deadline - time.monotonic()
            if rem <= 0:
                raise ReceiveTimeout(
                    f"no lane block within {timeout_millis}ms")
            self._wake.wait(min(_POLL_S, rem))

    @staticmethod
    def _coalesce(blocks: Sequence[_Block]) -> LaneMessage:
        parts = [(b.lane, b) for b in blocks]
        red = max(b.redeliveries for b in blocks)
        props = blocks[0].props
        if len(blocks) == 1 and blocks[0].raw is not None:
            return LaneMessage(blocks[0].raw, parts, red, props)
        cols = codec_mod.merge_columns([
            b.cols if b.cols is not None else codec_mod.decode_frame(b.raw)
            for b in blocks])
        if "is_valid" not in cols:
            # The planar frame carries a flag column; the card recomputes
            # validity anyway.
            cols = dict(cols)
            cols["is_valid"] = np.zeros(len(cols["student_id"]), bool)
        return LaneMessage(codec_mod.CODECS["binary"].assemble(cols), parts,
                           red, props)

    # -- the consumer call shape --------------------------------------------------
    def acknowledge(self, msg: LaneMessage) -> None:
        for lane_idx, block in msg.parts:
            self.lanes[lane_idx].ack(block)

    def acknowledge_many(self, msgs) -> None:
        for msg in msgs:
            self.acknowledge(msg)

    def negative_acknowledge(self, msg: LaneMessage) -> None:
        for lane_idx, block in msg.parts:
            self.lanes[lane_idx].nack(block)

    def backlog(self) -> int:
        return sum(lane.consumer.backlog() for lane in self.lanes)

    def lane_event_totals(self) -> List[int]:
        return [lane.metrics_events for lane in self.lanes]

    def close(self) -> None:
        # Stop and JOIN every lane before closing any session: a running
        # sibling would re-receive what a closing session's takeover just
        # requeued, and a chunk received on a session after its close
        # requeued would stay in flight for good.
        self._stop.set()
        for lane in self.lanes:
            lane.thread.join(timeout=5.0)
        for lane in self.lanes:
            # Settlements the thread did not get to: a graceful close
            # sends them (else the frames redeliver).
            try:
                lane._drain_settlements()
            except Exception:
                pass
            try:
                lane.consumer.close()
            except Exception:
                pass  # teardown: the broker may already be gone
