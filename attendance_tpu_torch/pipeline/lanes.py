"""Chunk decode of the classic (one-consumer) fused pipeline.

Counterpart of the classic-consumer half of
``attendance_tpu/pipeline/lanes.py`` (``_NullMetrics``,
``CoalescedMessage``, ``JsonChunkConsumer``); the striped ingress lanes
are not ported. :class:`JsonChunkConsumer` wraps a consumer with the raw
lane: bulk frames (ATB1, ATB2, COLW) pass through one at a time,
untouched, while a per-event JSON payload makes it drain a whole chunk of
up to ``config.batch_size`` messages, decode them at once through the
codec seam (the native scan, or the vectorized numpy scan with
``ATP_NATIVE=0``) and hand the run loop one planar frame, one device
dispatch, whose acks and nacks fan back to every message in it.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import List, Optional

from attendance_tpu_torch.pipeline import codec as codec_mod
from attendance_tpu_torch.transport import (
    PoisonTracker, acknowledge_all, handle_poison)
from attendance_tpu_torch.transport.memory_broker import (
    Message, ReceiveTimeout)

logger = logging.getLogger(__name__)


class _NullMetrics:
    """handle_poison's metrics shape when no pipeline metrics are given."""

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
            from attendance_tpu_torch.native import load as load_native
            self._engine = load_native() is None
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
        """Mixed/poison chunk: decode per message so only the bad
        payloads dead-letter (bounded by the poison tracker)."""
        from attendance_tpu_torch.pipeline.events import (
            columns_from_events, decode_event)
        good, parts = [], []
        for tok in toks:
            payload = tok[1]
            try:
                if codec_mod.codec_for_frame(payload).name != "json":
                    parts.append(codec_mod.decode_frame(payload))
                else:
                    parts.append(columns_from_events(
                        [decode_event(bytes(payload))]))
                good.append(tok)
            except Exception:
                # count_nack=True: the unit of nacking is one message.
                handle_poison(Message(tok[1], tok[0], tok[2], tok[3]),
                              self.consumer, self._metrics,
                              self.config, logger, count_nack=True,
                              tracker=self._poison)
        if not good:
            return None, ()
        return codec_mod.merge_columns(parts), good

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
