"""Fence gossip: workers publish merge frames, an aggregator folds them.

Counterpart of ``attendance_tpu/federation/gossip.py``. With telemetry
(``obs``)
the publisher counts frames and failures and, when tracing, opens a
``fence_publish`` span whose context rides the frame's ``traceparent``;
the aggregator counts wire rejects, merged deltas, stale frames,
takeovers and geometry rejects, keeps the merge-lag histogram and the
map-version and per-peer liveness gauges, and nests its ``fed_merge``
span under the worker's fence.

Worker side (:class:`FenceGossip`), hooked onto the fused pipeline's
snapshot fences: every durable delta barrier publishes the SAME
dirty-bank capture the snapshot writer just made durable (no extra
device read), every full base, preload and restore publishes a full
frame (packed Bloom words and every bank), and a background thread
heartbeats between fences so liveness stays observable through ingest
gaps. Gossip rides the configured broker (a socket client of its own
when ``fed_gossip_broker`` names one). A failed publish never fails the
snapshot barrier: durability is local; the publisher marks itself
``full_due`` and upgrades its next publish to a full frame, so a dropped
delta costs freshness, not convergence. A chaos ``partition`` window at
``fed.gossip`` swallows frames silently (the publisher believes the
send): the next full frame converges the view.

Aggregator side (:class:`Aggregator`): one consumer loop decoding frames
into a :class:`federation.merge.MergedView` and publishing the merged
state as read epochs through ``serve.mirror.ReadMirror``, so the query
plane serves federated BF.EXISTS / PFCOUNT / occupancy answers. A peer
silent past ``fed_dead_after_s`` is declared dead, its shards are
orphaned in the versioned shard map, and its durable state is recovered
at once by replaying its base + delta chain through
``fast_path.read_chain_state``, so the view never regresses while a
takeover worker (same id, higher incarnation, restored from the same
chain) starts and re-claims the shard.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from attendance_tpu_torch import chaos
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.federation.frames import (
    MergeFrame, decode_frame, encode_frame)
from attendance_tpu_torch.federation.merge import (
    GeometryMismatch, MergedView, encode_counts)
from attendance_tpu_torch.federation.shard import ShardMap
from attendance_tpu_torch.obs.tracing import format_ctx, parse_ctx
from attendance_tpu_torch.serve.mirror import ReadMirror
from attendance_tpu_torch.transport import (
    PoisonTracker, collect_batch, make_client, message_id)
from attendance_tpu_torch.transport.framing import (
    FrameChecksumError, dec_checksummed, enc_checksummed)
from attendance_tpu_torch.transport.memory_broker import ReceiveTimeout
from attendance_tpu_torch.transport.socket_broker import SocketClient

logger = logging.getLogger(__name__)

DEFAULT_GOSSIP_TOPIC = "attendance-fed-gossip"
GOSSIP_SUBSCRIPTION = "fed-aggregator"


def _gossip_client(config, fallback_client=None):
    """(client, owned): a SocketClient of its own when
    ``fed_gossip_broker`` names an address (never the data plane's
    client, which another thread drives), else the caller's client (the
    gossip shares the data plane's broker), else one from ``config``.
    Either way ``config.chaos`` installs the fault plane (``make_client``
    does for the last)."""
    if config.fed_gossip_broker:
        return SocketClient(config.fed_gossip_broker,
                            chaos=chaos.ensure(config)), True
    if fallback_client is not None:
        return fallback_client, False
    return make_client(config), True


def claim_incarnation(snapshot_dir: str) -> float:
    """An incarnation strictly newer than any earlier owner of the same
    chain directory's.

    The wall clock alone breaks failover across hosts: a takeover minted
    on a host whose clock trails the dead peer's would gossip a LOWER
    incarnation, and all its frames would fold as stale. Workers that
    share a chain directory (the takeover contract) bump a durable
    high-water mark, ``INCARNATION``, beside the chain instead (the
    JAX package's file: each package's takeover of the other's chain
    comes out newer); the clock only seeds the first claim."""
    now = time.time()
    if not snapshot_dir:
        return now
    path = Path(snapshot_dir) / "INCARNATION"
    prev = -1.0
    try:
        prev = float(path.read_text().strip() or -1.0)
    except (OSError, ValueError):
        pass
    inc = max(now, prev + 1.0)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(repr(inc))
        tmp.replace(path)
    except OSError:
        logger.warning("could not persist incarnation mark under %s; "
                       "takeover ordering falls back to wall clock",
                       snapshot_dir, exc_info=True)
    return inc


class FenceGossip:
    """Worker-side merge-frame publisher (one per fused pipeline)."""

    def __init__(self, config, *, client=None, m_bits: int = 0,
                 k: int = 0, obs=None):
        self.worker = config.fed_worker or "w0"
        self.shard = int(config.fed_shard)
        self.topic = config.fed_gossip_topic or DEFAULT_GOSSIP_TOPIC
        self.precision = config.hll_precision
        self.m_bits, self.k = m_bits, k
        self.snapshot_dir = config.snapshot_dir
        self.incarnation = claim_incarnation(self.snapshot_dir)
        self.full_due = False  # a failed publish owes a full frame
        self._seq = itertools.count()
        self._client, self._owns_client = _gossip_client(config, client)
        self._producer = self._client.create_producer(self.topic)
        self._lock = threading.Lock()  # the writer thread + heartbeat
        self._closed = False
        self._hb_s = float(config.fed_heartbeat_s)
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._last_events = 0
        self._c_frames = self._c_failures = None
        self._tracer = obs.tracer if obs is not None else None
        if obs is not None:
            self._c_frames = {
                kind: obs.registry.counter(
                    "attendance_fed_gossip_frames_total",
                    help="Merge frames published to the gossip topic",
                    kind=kind, worker=self.worker)
                for kind in ("full", "delta", "heartbeat",
                             "repair_request")}
            self._c_failures = obs.registry.counter(
                "attendance_fed_gossip_failures_total",
                help="Gossip publishes that failed (the next "
                "successful publish upgrades to a full frame)",
                worker=self.worker)

    def start_heartbeat(self) -> "FenceGossip":
        if self._hb_s > 0 and self._hb_thread is None:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, name="fed-heartbeat", daemon=True)
            self._hb_thread.start()
        return self

    def _hb_loop(self) -> None:
        while not self._hb_stop.wait(self._hb_s):
            self.heartbeat()

    def _send(self, kind: str, encode) -> bool:
        """Publish one frame. ``encode`` builds the payload, allocating
        its seq, UNDER the send lock: seq order must equal wire order,
        or a heartbeat racing a fence would make the aggregator call the
        real delta stale. Every frame ships checksummed, so the
        aggregator rejects in-flight rot at the fold. A chaos
        ``partition`` window swallows the frame silently: gossip is
        fire-and-forget, and the next full frame converges."""
        try:
            with self._lock:
                if self._closed:
                    return False
                data = enc_checksummed(encode())
                inj = chaos.get()
                if inj is None or not inj.blackhole("fed.gossip"):
                    self._producer.send(data)
        except Exception:  # noqa: BLE001 — gossip never fails a fence
            if self._c_failures is not None:
                self._c_failures.inc()
            self.full_due = kind != "heartbeat" or self.full_due
            logger.warning("fed gossip %s publish failed (deferred to "
                           "next fence)", kind, exc_info=True)
            return False
        if self._c_frames is not None:
            self._c_frames[kind].inc()
        return True

    def _encode(self, kind: str, events: int, *, bank_of=None,
                roster_size: int = 0, num_banks: int = 0,
                arrays=None) -> bytes:
        seq = next(self._seq)
        tp = ""
        span = None
        if self._tracer is not None and kind != "heartbeat":
            # The fence-publish span is the cross-process parent: its
            # context ships in the frame header, so the aggregator's
            # fed_merge span nests under it.
            span = self._tracer.start_span(
                "fence_publish",
                args={"kind": kind, "worker": self.worker,
                      "shard": self.shard, "seq": seq})
            tp = format_ctx(span.context(seq))
        data = encode_frame(
            worker=self.worker, kind=kind,
            incarnation=self.incarnation, seq=seq,
            shard=self.shard, fence_ts=time.time(),
            events=int(events),
            bank_of=bank_of, m_bits=self.m_bits, k=self.k,
            precision=self.precision, num_banks=num_banks,
            roster_size=roster_size, snapshot_dir=self.snapshot_dir,
            traceparent=tp, arrays=arrays)
        if span is not None:
            self._tracer.end_span(span)
        return data

    def publish_full(self, bloom_words, regs, counts,
                     bank_of: Dict[int, int], events: int,
                     roster_size: int = 0) -> bool:
        arrays = {"regs": np.asarray(regs, np.uint8),
                  "counts": np.asarray(counts, np.uint32)}
        if bloom_words is not None:
            arrays["bloom"] = np.asarray(bloom_words, np.uint32)
        self._last_events = int(events)
        ok = self._send("full", lambda: self._encode(
            "full", events, bank_of=bank_of, roster_size=roster_size,
            num_banks=arrays["regs"].shape[0], arrays=arrays))
        if ok:
            self.full_due = False
        return ok

    def publish_delta(self, banks, rows, counts,
                      bank_of: Dict[int, int], events: int,
                      num_banks: int, roster_size: int = 0) -> bool:
        self._last_events = int(events)
        return self._send("delta", lambda: self._encode(
            "delta", events, bank_of=bank_of, roster_size=roster_size,
            num_banks=num_banks, arrays={
                "bank_idx": np.asarray(banks, np.int32),
                "rows": np.asarray(rows, np.uint8),
                "counts": np.asarray(counts, np.uint32)}))

    def heartbeat(self) -> bool:
        return self._send("heartbeat", lambda: self._encode(
            "heartbeat", self._last_events))

    def request_reassert(self, timeout_s: float = 10.0
                         ) -> Optional[MergeFrame]:
        """The repair ladder's peer rung: publish a ``repair_request``
        and wait (bounded) for the aggregator to re-assert this worker's
        own retained contribution as a full frame on the reply topic.
        Returns the frame, or None (no aggregator, a timeout, or the
        request itself lost): the caller then repairs locally only."""
        reply_topic = f"{self.topic}.reassert.{self.worker}"
        try:
            consumer = self._client.subscribe(
                reply_topic, f"reassert-{self.worker}")
        except Exception:  # noqa: BLE001 — the local repair still runs
            logger.warning("cannot subscribe the re-assert reply "
                           "topic; repairing locally only",
                           exc_info=True)
            return None
        try:
            if not self._send("repair_request", lambda: self._encode(
                    "repair_request", self._last_events)):
                return None
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                try:
                    msg = consumer.receive(timeout_millis=500)
                except ReceiveTimeout:
                    continue
                except Exception:  # noqa: BLE001
                    logger.warning("re-assert receive failed; "
                                   "repairing locally only",
                                   exc_info=True)
                    return None
                try:
                    body, _ = dec_checksummed(bytes(msg.data()))
                    frame = decode_frame(body)
                except (FrameChecksumError, ValueError):
                    logger.warning("undecodable re-assert frame "
                                   "skipped", exc_info=True)
                    consumer.acknowledge(msg)
                    continue
                consumer.acknowledge(msg)
                if frame.kind == "full" and \
                        frame.worker == self.worker:
                    logger.info("peer re-assert received: %d events, "
                                "%d banks", frame.events,
                                len(frame.bank_of))
                    return frame
            logger.warning("peer re-assert timed out after %.1fs; "
                           "repairing locally only", timeout_s)
            return None
        finally:
            try:
                consumer.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._producer.close()
            finally:
                if self._owns_client:
                    try:
                        self._client.close()
                    except Exception:  # noqa: BLE001
                        pass


class Aggregator:
    """Fold the gossip stream into a queryable global view."""

    _TRACE_ROLE = "fed-aggregator"

    def __init__(self, config=None, *, client=None,
                 topic: Optional[str] = None,
                 num_shards: Optional[int] = None,
                 dead_after_s: Optional[float] = None,
                 precision: Optional[int] = None, obs=None):
        cfg = config if config is not None else Config()
        self.topic = topic or cfg.fed_gossip_topic or DEFAULT_GOSSIP_TOPIC
        self.dead_after_s = (dead_after_s if dead_after_s is not None
                             else float(cfg.fed_dead_after_s))
        self.view = MergedView(precision if precision is not None
                               else cfg.hll_precision)
        self.shard_map = ShardMap(num_shards if num_shards is not None
                                  else max(1, int(cfg.fed_shards)))
        self.mirror = ReadMirror()
        self._client, self._owns_client = _gossip_client(cfg, client)
        self.consumer = self._client.subscribe(self.topic,
                                               GOSSIP_SUBSCRIPTION)
        self._down: set = set()
        self._no_checksum_warned: set = set()
        # Checksum-reject retries bounded by the frame's own failure
        # count, not the broker's redelivery count (which reconnect and
        # takeover requeues inflate).
        self._poison = PoisonTracker()
        self.recovered_chains: Dict[str, int] = {}
        self.geometry_rejects = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._no_traceparent_warned: set = set()
        self._obs = obs
        self._tracer = obs.tracer if obs is not None else None
        self._h_lag = self._c_deltas = self._c_stale = None
        self._c_takeovers = self._g_peers = self._c_geom = None
        self._c_wire = None
        if obs is not None:
            self._c_wire = obs.registry.counter(
                "attendance_integrity_wire_rejects_total",
                help="Frames rejected for a failed payload checksum "
                     "(in-flight rot, never folded)",
                site="fed.gossip")
            self._h_lag = obs.registry.histogram(
                "attendance_fed_merge_lag_seconds",
                help="Fence -> folded-into-global-view latency per "
                "merge frame", scale=1e3)
            self._c_deltas = obs.registry.counter(
                "attendance_fed_merged_deltas_total",
                help="State-carrying merge frames folded into the "
                "global view")
            self._c_stale = obs.registry.counter(
                "attendance_fed_stale_frames_total",
                help="Frames from a superseded incarnation/sequence "
                "(sketch folded idempotently, counters ignored)")
            self._c_takeovers = obs.registry.counter(
                "attendance_fed_takeovers_total",
                help="Dead-peer shard reassignments (failover events)")
            self._c_geom = obs.registry.counter(
                "attendance_fed_geometry_rejects_total",
                help="Gossip frames rejected for incompatible sketch "
                "geometry (a misconfigured peer; doctor fails on any)")
            obs.registry.gauge(
                "attendance_fed_map_version",
                help="Version of the federation shard map (bumps on "
                "every reassignment)").set_function(
                    lambda: float(self.shard_map.version))
            self._g_peers = {}
            self.mirror.register_gauges(obs)

    # -- folding -------------------------------------------------------------
    def _peer_gauge(self, worker: str):
        if self._obs is None:
            return None
        g = self._g_peers.get(worker)
        if g is None:
            g = self._g_peers[worker] = self._obs.registry.gauge(
                "attendance_fed_peer_up",
                help="1 while the peer's gossip is fresh, 0 once it "
                "is declared dead", peer=worker)
        return g

    def fold_frame(self, frame: MergeFrame,
                   now: Optional[float] = None) -> Dict:
        t0 = time.perf_counter()
        info = self.view.fold(frame, now=now)
        worker = frame.worker
        if ("traceparent" not in frame.header
                and frame.kind != "heartbeat"
                and worker not in self._no_traceparent_warned):
            # A worker predating trace stitching: fold its state, and
            # say once that its fences cannot parent fed_merge spans.
            self._no_traceparent_warned.add(worker)
            logger.warning(
                "gossip frames from %s carry no traceparent field "
                "(older worker build?) — folding normally, but its "
                "fences cannot parent fed_merge spans in the "
                "stitched trace", worker)
        ledger = self.view.workers[worker]
        # The aggregator's own chain-recovery fold (header "recovered")
        # re-asserts a dead peer's STATE, never its liveness or its
        # shard claim: the shard stays orphaned until a successor
        # gossips for itself.
        synthetic = bool(frame.header.get("recovered"))
        if worker in self._down and not info["stale"] and not synthetic:
            # A takeover reuses the dead peer's id at a higher
            # incarnation: fresh gossip marks the peer up.
            self._down.discard(worker)
            logger.info("fed peer %s is back up (incarnation %.3f)",
                        worker, ledger.incarnation)
        if ledger.shard >= 0 and not info["stale"] \
                and worker not in self._down:
            self.shard_map.claim(ledger.shard, worker)
        g = self._peer_gauge(worker)
        if g is not None:
            g.set(0.0 if worker in self._down else 1.0)
        if info["lag_s"] is not None:
            if self._h_lag is not None:
                self._h_lag.observe(info["lag_s"])
                self._c_deltas.inc()
            if self._tracer is not None:
                # Continue the trace the worker's fence_publish span
                # started (its context rode the frame header); an
                # untraced worker's frame roots a fresh trace.
                ctx = parse_ctx(frame.header.get("traceparent"))
                self._tracer.add_span(
                    "fed_merge", t0, time.perf_counter(),
                    trace_id=(ctx.trace_id if ctx is not None
                              else self._tracer.new_id()),
                    parent_id=ctx.span_id if ctx is not None else None,
                    role=self._TRACE_ROLE,
                    args={"worker": worker, "kind": frame.kind,
                          "lag_s": round(info["lag_s"], 6)})
        if info["stale"] and self._c_stale is not None:
            self._c_stale.inc()
        return info

    def publish_epoch(self) -> None:
        """Publish the merged view as the next federated read epoch."""
        if self.view.params is None and not self.view.bank_of:
            return  # nothing merged yet
        self.mirror.publish(**self.view.epoch_fields())

    def poll(self, timeout_ms: int = 200) -> int:
        """Drain one receive round; returns the state frames folded (and
        publishes a fresh epoch when any was)."""
        if not hasattr(self.consumer, "receive_many"):
            # A consumer without the batch receive (pulsar-client's):
            # per-message receives within the same window.
            msgs = collect_batch(self.consumer, 64, timeout_ms / 1e3)
        else:
            try:
                msgs = self.consumer.receive_many(
                    64, timeout_millis=timeout_ms)
            except ReceiveTimeout:
                return 0
        folded = 0
        for msg in msgs:
            raw = bytes(msg.data())
            try:
                body, verified = dec_checksummed(raw)
            except FrameChecksumError:
                if self._c_wire is not None:
                    self._c_wire.inc()
                # In-flight rot, rejected at the fold: the broker still
                # holds the original bytes, so a bounded nack
                # redelivers them clean; past the bound the frame is
                # dropped rather than folded mangled.
                mid = message_id(msg)
                failures = self._poison.bump(mid)
                if failures <= 3:
                    logger.error(
                        "gossip frame failed its checksum (attempt "
                        "%d); nacking for clean redelivery", failures)
                    try:
                        self.consumer.negative_acknowledge(msg)
                        continue
                    except Exception:  # noqa: BLE001
                        logger.exception("nack failed; dropping the "
                                         "rotten frame")
                else:
                    logger.error(
                        "gossip frame failed its checksum %d times; "
                        "dropping it (never folded)", failures)
                self._poison.forget(mid)
                self.consumer.acknowledge(msg)
                continue
            try:
                frame = decode_frame(body)
            except Exception:  # noqa: BLE001 — one bad frame, not the loop
                logger.exception("undecodable gossip frame dropped")
                self.consumer.acknowledge(msg)
                continue
            if not verified and \
                    frame.worker not in self._no_checksum_warned:
                # A worker that predates the checksummed wire: fold it,
                # and say so once per worker.
                self._no_checksum_warned.add(frame.worker)
                logger.warning(
                    "gossip frames from %s carry no payload checksum "
                    "(older worker build?) — folding normally, but "
                    "in-flight rot on this peer's frames is "
                    "undetectable", frame.worker)
            if frame.kind == "repair_request":
                try:
                    self._serve_reassert(frame)
                except Exception:  # noqa: BLE001
                    logger.exception("re-assert for %s failed",
                                     frame.worker)
                self.consumer.acknowledge(msg)
                continue
            try:
                info = self.fold_frame(frame)
                folded += info["lag_s"] is not None
            except GeometryMismatch as exc:
                # Loud and attributed, but bounded: one misconfigured
                # peer must not stop the federation's serving.
                self.geometry_rejects += 1
                if self._c_geom is not None:
                    self._c_geom.inc()
                logger.error("gossip frame from %s REJECTED: %s",
                             frame.worker, exc)
            except Exception:  # noqa: BLE001
                logger.exception("gossip frame fold failed; dropped")
            self.consumer.acknowledge(msg)
        if folded:
            self.publish_epoch()
        return folded

    def _serve_reassert(self, request: MergeFrame) -> bool:
        """Serve a ``repair_request``: publish that worker's OWN
        retained contribution (never the global view, which would fatten
        its filter with other shards' keys) as a full frame on
        ``<topic>.reassert.<worker>``. Returns whether one was sent."""
        worker = request.worker
        ws = self.view.worker_state.get(worker)
        ledger = self.view.workers.get(worker)
        if not ws or ws.get("bloom") is None or ledger is None \
                or self.view.params is None:
            logger.warning(
                "repair_request from %s but no retained contribution "
                "to re-assert (fresh aggregator, or retention off) — "
                "the worker repairs locally only", worker)
            return False
        days = sorted(ws["rows"])
        regs = (np.stack([ws["rows"][d] for d in days])
                if days else np.zeros((0, self.view.m), np.uint8))
        data = encode_frame(
            worker=worker, kind="full",
            incarnation=ledger.incarnation, seq=ledger.seq,
            shard=ledger.shard, fence_ts=time.time(),
            events=ledger.events,
            bank_of={d: i for i, d in enumerate(days)},
            m_bits=self.view.params.m_bits, k=self.view.params.k,
            precision=self.view.precision,
            num_banks=regs.shape[0],
            roster_size=ledger.roster_size,
            snapshot_dir=ledger.snapshot_dir, traceparent="",
            arrays={"bloom": np.asarray(ws["bloom"], np.uint32),
                    "regs": np.asarray(regs, np.uint8),
                    "counts": encode_counts(ledger.valid,
                                            ledger.invalid)})
        producer = self._client.create_producer(
            f"{self.topic}.reassert.{worker}")
        try:
            producer.send(enc_checksummed(data))
        finally:
            try:
                producer.close()
            except Exception:  # noqa: BLE001
                pass
        if self._obs is not None:
            self._obs.registry.counter(
                "attendance_fed_reasserts_total",
                help="Peer-assisted chain repairs served (full-frame "
                     "re-asserts of a worker's retained contribution)"
            ).inc()
        logger.warning(
            "served re-assert to %s: %d events, %d banks (chain "
            "repair in progress on the worker)", worker,
            ledger.events, len(days))
        return True

    # -- liveness and failover -----------------------------------------------
    def check_liveness(self, now: Optional[float] = None) -> list:
        """Declare peers silent past the budget dead; returns the newly
        dead worker ids (each already reassigned and chain-recovered)."""
        now = time.time() if now is None else now
        newly_dead = [w for w, ledger in self.view.workers.items()
                      if w not in self._down
                      and now - ledger.last_seen > self.dead_after_s]
        for worker in newly_dead:
            self._on_dead(worker)
        return newly_dead

    def _on_dead(self, worker: str) -> None:
        self._down.add(worker)
        g = self._peer_gauge(worker)
        if g is not None:
            g.set(0.0)
        moved = self.shard_map.reassign(worker, None)
        if self._c_takeovers is not None:
            self._c_takeovers.inc()
        logger.warning(
            "fed peer %s declared dead (silent > %.1fs): shards %s "
            "orphaned at map version %d, recovering its chain",
            worker, self.dead_after_s, moved, self.shard_map.version)
        ledger = self.view.workers[worker]
        if ledger.snapshot_dir:
            try:
                self.recover_chain(worker, ledger.snapshot_dir)
                self.publish_epoch()
            except FileNotFoundError:
                logger.warning("dead peer %s advertised snapshot dir "
                               "%s but no chain exists there", worker,
                               ledger.snapshot_dir)
            except Exception:  # noqa: BLE001 — keep serving
                logger.exception("chain recovery for dead peer %s "
                                 "failed", worker)

    def recover_chain(self, worker: str, snapshot_dir) -> int:
        """Fold the dead peer's durable base + delta chain into the view
        (restore's merge-on-read loader), so what the peer made durable
        is served before a takeover worker exists. Idempotent: the
        takeover's own full frames re-assert the same state. Returns
        the recovered cumulative event count."""
        # Imported here: fast_path builds FenceGossip from this module.
        from attendance_tpu_torch.pipeline.fast_path import (
            read_chain_state)

        state = read_chain_state(Path(snapshot_dir))
        ledger = self.view.workers[worker]
        man = state["manifest"]
        frame = MergeFrame(
            header=dict(
                worker=worker, kind="full",
                incarnation=ledger.incarnation, seq=ledger.seq + 1,
                shard=ledger.shard,
                # Stamped at the fold: the merge lag describes gossip,
                # not how long the peer had been quietly durable.
                fence_ts=time.time(),
                events=int(state["events"]),
                roster_size=ledger.roster_size,
                m_bits=int(man["m_bits"]), k=int(man["k"]),
                precision=int(man["precision"]),
                num_banks=state["regs"].shape[0],
                snapshot_dir=str(snapshot_dir), recovered=True,
                traceparent="",
                bank_of={int(d): int(b)
                         for d, b in state["bank_of"].items()}),
            arrays=dict(
                bloom=np.asarray(state["bits"], np.uint32),
                regs=np.asarray(state["regs"], np.uint8),
                counts=np.asarray(state["counts"], np.uint32)))
        self.fold_frame(frame)
        self.recovered_chains[worker] = int(state["events"])
        logger.info("recovered %d durable events from %s's chain at "
                    "%s", int(state["events"]), worker, snapshot_dir)
        return int(state["events"])

    # -- loop ----------------------------------------------------------------
    def start(self) -> "Aggregator":
        self._thread = threading.Thread(
            target=self._loop, name="fed-aggregator", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll(timeout_ms=200)
                self.check_liveness()
            except Exception:  # noqa: BLE001 — the fold loop keeps running
                if self._stop.is_set():
                    return
                logger.exception("aggregator poll failed (retrying)")
                time.sleep(0.2)

    def pause(self) -> None:
        """Stop the background fold loop but keep the consumer open: the
        caller polls (drain the gossip tail before asserting on the view)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def stop(self) -> None:
        self.pause()
        try:
            self.consumer.close()
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        if self._owns_client:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass

    def stats(self) -> Dict:
        # Callers poll this from other threads while the fold loop
        # mutates the ledgers: dict() copies are atomic under the GIL,
        # a comprehension over the live dict is not.
        workers = dict(self.view.workers)
        return {
            "events": sum(w.events for w in workers.values()),
            "workers": {
                w: {"events": led.events, "shard": led.shard,
                    "up": w not in self._down,
                    "incarnation": led.incarnation}
                for w, led in workers.items()},
            "shard_map": self.shard_map.to_dict(),
            "banks": len(self.view.bank_of),
            "folded_deltas": self.view.folded_deltas,
            "folded_fulls": self.view.folded_fulls,
            "stale_frames": self.view.stale_frames,
            "geometry_rejects": self.geometry_rejects,
            "recovered_chains": dict(self.recovered_chains),
        }
