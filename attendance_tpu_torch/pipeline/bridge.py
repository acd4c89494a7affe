"""JSON -> binary ingress bridge: the reference's wire in, the fused
pipeline's wire out.

Counterpart of ``attendance_tpu/pipeline/bridge.py``. The reference's
producers emit one JSON object per broker message; the fused pipeline
consumes bulk binary frames. The bridge drains the JSON topic in
micro-batches, decodes a batch through the codec seam (the native scan,
``ATP_NATIVE=0``: Python), packs the columns into one planar frame,
publishes it on ``<topic>-binary`` and only then acknowledges the JSON
messages, so it is at-least-once end to end: a crash replays JSON
messages into duplicate frames that the idempotent sketches and the
last-write-wins store absorb. It reads the broker's chunk lane where the
consumer has one (memory, socket), else the Message path: per-message
receives (``collect_batch``), payloads by ``data()``, acks message by
message (pulsar-client's consumer). Several bridges on one shared
subscription scale the decode across processes.

A batch with a poison payload is converted message by message, so only
the bad payloads are nacked and, after ``max_redeliveries``,
dead-lettered (into ``quarantine_dir`` when set).

With tracing on the bridge is a trace relay: each forwarded frame's
``bridge_forward`` span continues the trace of the first JSON message it
folded in, and the frame carries that span's context, so generator ->
bridge -> fused pipeline reads as one tree.

The bridge's own fault point is ``bridge.forward`` (an injected delay
before a republish); its transport faults ride the chaos-wrapped client.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.codec import get_codec
from attendance_tpu_torch.pipeline.events import (
    columns_from_events, decode_event)
from attendance_tpu_torch.pipeline.processor import ProcessorMetrics
from attendance_tpu_torch.transport import (
    PoisonTracker, acknowledge_all, collect_batch, collect_chunks,
    handle_poison, make_client)
from attendance_tpu_torch.transport.memory_broker import Message

logger = logging.getLogger(__name__)

BINARY_TOPIC_SUFFIX = "-binary"


class JsonBinaryBridge:
    """Competing-consumer JSON->binary repacker."""

    SUBSCRIPTION = "attendance_bridge"

    def __init__(self, config: Optional[Config] = None, *,
                 client=None, out_topic: Optional[str] = None):
        self.config = config or Config()
        # Telemetry before the transport (broker queues register their
        # depth gauges); one branch a batch when off.
        self._obs = obs.ensure(self.config)
        self._tracer = (self._obs.tracer if self._obs is not None
                        else None)
        # The fault plane before the transport, whose seams take it.
        self._chaos = chaos.ensure(self.config)
        self.client = client or make_client(self.config)
        self.consumer = self.client.subscribe(
            self.config.pulsar_topic, self.SUBSCRIPTION)
        self.out_topic = (out_topic
                          or self.config.pulsar_topic + BINARY_TOPIC_SUFFIX)
        self.producer = self.client.create_producer(self.out_topic)
        self._codec = get_codec("json")
        self.metrics = ProcessorMetrics()
        self._poison = PoisonTracker()
        # The chunk lane where the consumer has it, else the Message
        # path; fixed with the consumer.
        self._chunk = hasattr(self.consumer, "receive_chunk")

    def _forward(self, toks, chunks) -> None:
        """Convert one micro-batch and publish it. On the chunk lane
        ``toks`` are its raw ``(message_id, data, redeliveries,
        properties)`` tuples and ``chunks`` the broker's ``(chunk_id,
        tuples)`` handles holding them (a chunk is one in-flight entry,
        settled at once), exploded into per-message entries only on the
        poison path; on the Message path ``toks`` are the consumer's
        Messages and ``chunks`` is None."""
        if self._chaos is not None:
            d = self._chaos.delay_s("bridge.forward")
            if d:
                time.sleep(d)
        raw = self._chunk
        payloads = ([t[1] for t in toks] if raw
                    else [m.data() for m in toks])
        span = out_props = None
        if self._tracer is not None:
            props = (toks[0][3] if raw else toks[0].properties()
                     if hasattr(toks[0], "properties") else None)
            span, out_props = self._begin_forward_span(props, len(toks))
        try:
            cols = self._codec.decode(payloads)
        except Exception:
            # A poison payload somewhere in the batch: convert message
            # by message (the full conversion: valid JSON with a bad
            # timestamp is poison too) so only the bad ones dead-letter.
            for cid, _ in chunks or ():
                self.consumer.explode_chunk(cid)
            good, parts = [], []
            for payload, tok in zip(payloads, toks):
                try:
                    parts.append(columns_from_events(
                        [decode_event(payload)]))
                    good.append(tok)
                except Exception:
                    msg = (Message(tok[1], tok[0], tok[2], tok[3]) if raw
                           else tok)
                    handle_poison(msg, self.consumer, self.metrics,
                                  self.config, logger, count_nack=False,
                                  tracker=self._poison)
            if good:
                cols = {k: np.concatenate([p[k] for p in parts])
                        for k in parts[0]}
                self._publish(cols, len(good), out_props)
                if raw:
                    self.consumer.acknowledge_ids([t[0] for t in good])
                else:
                    acknowledge_all(self.consumer, good)
            if span is not None:
                if good:
                    self._tracer.end_span(span, messages=len(good))
                else:  # the whole batch dead-lettered
                    self._tracer.end_span(span, error="all-poison")
            return
        self._publish(cols, len(toks), out_props)
        if raw:
            for cid, _ in chunks:
                self.consumer.acknowledge_chunk(cid)
        else:
            acknowledge_all(self.consumer, toks)
        if span is not None:
            self._tracer.end_span(span, messages=len(toks))

    def _begin_forward_span(self, props, n: int):
        """Open the ``bridge_forward`` span continuing the trace in the
        first message's properties, and the outgoing frame's properties
        naming it as the parent."""
        from attendance_tpu_torch.obs.tracing import (
            TRACEPARENT, format_ctx, parse_ctx)

        ctx = parse_ctx((props or {}).get(TRACEPARENT))
        span = self._tracer.start_span(
            "bridge_forward",
            trace_id=ctx.trace_id if ctx is not None else None,
            parent_id=ctx.span_id if ctx is not None else None,
            role="bridge", args={"messages": n})
        return span, {TRACEPARENT: format_ctx(
            span.context(ctx.seq if ctx is not None else 0))}

    def _publish(self, cols, n: int, properties=None) -> None:
        # The caller acks strictly after the binary frame is published:
        # the bridge never holds the only copy of an acknowledged event.
        self.producer.send(self._codec.assemble(cols),
                           properties=properties)
        self.metrics.batches += 1
        self.metrics.events += n
        self.metrics.batch_sizes.append(n)

    def run(self, max_events: Optional[int] = None,
            idle_timeout_s: float = 1.0) -> None:
        """Bridge until ``max_events`` JSON messages were converted or no
        message arrived for ``idle_timeout_s``."""
        t0 = time.perf_counter()
        idle_since = time.monotonic()
        while True:
            if self._chunk:
                chunks = collect_chunks(self.consumer,
                                        self.config.batch_size,
                                        self.config.batch_timeout_s)
                toks = ([t for _, ts in chunks for t in ts]
                        if len(chunks) != 1 else chunks[0][1])
            else:
                chunks = None
                toks = collect_batch(self.consumer, self.config.batch_size,
                                     self.config.batch_timeout_s)
            if not toks:
                if time.monotonic() - idle_since > idle_timeout_s:
                    break
                continue
            idle_since = time.monotonic()
            self._forward(toks, chunks)
            if max_events is not None and self.metrics.events >= max_events:
                break
        self.metrics.wall_seconds = time.perf_counter() - t0
        if logger.isEnabledFor(logging.INFO):
            logger.info("Bridge metrics: %s",
                        self.metrics.summary(None, include_validity=False))
        if self.config.metrics_json:
            self.metrics.write_json_line(self.config.metrics_json)
        if self._obs is not None:
            self._obs.flush_trace("run-end")

    def cleanup(self) -> None:
        self.client.close()
