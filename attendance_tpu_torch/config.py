"""Configuration of the port.

Counterpart of ``attendance_tpu/config.py``, cut to the fields the fused
path, its checkpoint chain, its temporal plane, its ingress lanes and
shared-memory ring, the query plane, the generic sketch store and the
processor read, with the JAX package's defaults and checks
(reference README: a 100k-student roster at a 1% false-positive rate;
Redis dense HLL precision 14).
"""

from __future__ import annotations

import dataclasses
from typing import List

from attendance_tpu_torch.temporal.buckets import period_micros

PULSAR_TOPIC = "attendance-events"
REDIS_HOST = "localhost"
REDIS_PORT = 6379
CASSANDRA_HOSTS = ["localhost"]
CASSANDRA_KEYSPACE = "attendance_system"
BLOOM_FILTER_KEY = "bf:students"
BLOOM_FILTER_ERROR_RATE = 0.01
BLOOM_FILTER_CAPACITY = 100_000
HLL_KEY_PREFIX = "hll:unique:"


@dataclasses.dataclass
class Config:
    pulsar_topic: str = PULSAR_TOPIC
    redis_host: str = REDIS_HOST
    redis_port: int = REDIS_PORT
    cassandra_hosts: List[str] = dataclasses.field(
        default_factory=lambda: list(CASSANDRA_HOSTS))
    cassandra_keyspace: str = CASSANDRA_KEYSPACE
    bloom_filter_key: str = BLOOM_FILTER_KEY
    bloom_filter_error_rate: float = BLOOM_FILTER_ERROR_RATE
    bloom_filter_capacity: int = BLOOM_FILTER_CAPACITY
    hll_key_prefix: str = HLL_KEY_PREFIX
    # Backend of the generic sketch store (BF.*/PFADD/PFCOUNT): "tpu" =
    # the card store (the JAX package's flag value), "memory" = host
    # numpy sketches, "redis" = Redis Stack (import-gated), "redis-sim" =
    # the hermetic simulation of Redis's algorithms.
    sketch_backend: str = "tpu"
    # Transport of the processor, the fused pipeline and the bridge:
    # "memory" (the process's in-process broker) or "socket" (a
    # BrokerServer at socket_broker: python -m
    # attendance_tpu_torch.transport.socket_broker). The pulsar transport
    # is not ported.
    transport_backend: str = "memory"
    # Address of the BrokerServer of --transport-backend socket.
    socket_broker: str = "127.0.0.1:6655"
    # Event store of the processor: "memory" (rows), "columnar" or
    # "cassandra" (import-gated).
    storage_backend: str = "memory"
    # Processor micro-batch: at most this many events, or what arrived
    # when batch_timeout_s expires.
    batch_size: int = 8192
    batch_timeout_s: float = 0.05
    # Striped ingress (pipeline.lanes): 0 = the fused pipeline's one
    # consumer; N >= 1 = N lane threads, each with its own broker session
    # (its own TCP connection on the socket backend), decoding off the
    # dispatch thread, their blocks coalesced into full device batches by
    # one dispatcher. Acks, the snapshot writer's group commits included,
    # route back to each frame's lane.
    ingress_lanes: int = 0
    # Decoded blocks a lane may park in its bounded queue before its
    # thread blocks (backpressure toward the broker).
    lane_queue_depth: int = 4
    # Lane JSON decode engine: "auto" = the native buffer scan
    # (ATP_NATIVE=0: the vectorized numpy scan), "vector" = the numpy
    # scan. "native" names the JAX package's CPython list scan, which the
    # port does not have: a striped consumer asked for it raises.
    lane_decode: str = "auto"
    # Ingress wire: "auto" sniffs each broker payload's codec (json,
    # binary, columnar; so do "json", "binary" and "columnar", which
    # document intent); "shm" replaces the event topic's broker with the
    # shared-memory ring under shm_dir (transport.shm_ring), one ring
    # file per ingress lane.
    ingress_wire: str = "auto"
    # Ring geometry of ingress_wire="shm": a slot holds one planar frame
    # (20 bytes an event + 8), so shm_slot_bytes must cover a frame (the
    # producer raises on one that does not fit); shm_slots bounds the
    # published-but-unacked window.
    shm_dir: str = ""
    shm_slots: int = 64
    shm_slot_bytes: int = 1 << 21
    # Bloom layout of the generic store: "flat" (double-hashed over the
    # whole filter, Redis-parity FPR math) or "blocked" (one 512-bit
    # block per key). The fused path is blocked-only.
    bloom_layout: str = "flat"
    # HLL precision: p=14 -> 16384 registers, matching Redis dense HLL.
    hll_precision: int = 14
    # HLL banks the card store starts with (one per key, doubled on
    # demand).
    hll_initial_banks: int = 8
    # Optional side topic the processor republishes computed-invalid
    # events to ("" = off); the stored row keeps is_valid=false either
    # way.
    invalid_topic: str = ""
    # A frame that fails to decode is nacked for redelivery at most this
    # many times, then dead-lettered (acked and counted).
    max_redeliveries: int = 3
    # Dead-lettered frames are written here (bytes + a JSON sidecar)
    # before the ack; "" drops them on the ack.
    quarantine_dir: str = ""
    # Total retry budget of one broker RPC over the socket transport
    # (reconnects with jittered backoff), then BrokerUnavailable.
    retry_budget_s: float = 15.0
    # Append one JSON metrics line per processor run to this file.
    metrics_json: str = ""
    # Query serving (attendance_tpu_torch/serve): nonzero = the fused
    # pipeline answers BF.EXISTS, PFCOUNT, occupancy, attendance rate and
    # the window verbs from an epoch-pinned host mirror of its sketch
    # state over a binary batch RPC on this port (-1 = an ephemeral port,
    # ``pipeline.query_server.port``). Epochs publish at preload, restore
    # and every snapshot barrier.
    serve_port: int = 0
    # Largest key or day batch one query RPC may carry.
    query_batch_max: int = 1 << 16
    # Read-staleness objective in seconds, reported by ``stats()`` (0 =
    # none).
    read_staleness_ceiling_s: float = 0.0
    # Host->device wire of the fused step: "auto" starts on the 4-byte
    # word wire and, with the native host pack, climbs to the narrower
    # seg (kb bits/event) and delta (db bits/event) wires while the card
    # or the link holds the hot loop back; the (4 + w)-byte bytes wire
    # carries frames whose key and bank bits do not fit one word.
    # "word", "bytes", "seg" and "delta" force one.
    wire_format: str = "auto"
    # Full-population exact shadow of the temporal plane's windows
    # (>= 1.0 keeps per-bucket sets of valid students: the window audit
    # oracle); the JAX package's telemetry auditor is not ported.
    audit_sample: float = 0.0
    # Temporal sketch plane (attendance_tpu_torch/temporal): when
    # temporal_period_s > 0 the fused pipeline grows a windowed-HLL
    # bucket ring (one bank row per (lecture day, period) bucket in the
    # SAME register tensor and bank_of map as the per-day banks), a
    # watermarked reorder stage and a Count-Min + top-K fraud detector.
    temporal_period_s: float = 0.0
    # Event-time lateness budget: the watermark trails the stream head
    # by this much; events behind a rotated bucket are counted and
    # side-channeled instead of misbucketed.
    allowed_lateness_s: float = 5.0
    # Wall-clock silence after which the watermark advances to the
    # stream head. 0 = only end-of-run flushes.
    watermark_idle_s: float = 2.0
    # Bucket rows the ring retains; pressure evicts the oldest CLOSED
    # bucket, zeroing and recycling its bank row.
    temporal_ring_banks: int = 256
    # Count-Min geometry + heavy-hitter set size.
    cms_depth: int = 4
    cms_width: int = 1 << 14
    cms_topk: int = 16
    # Checkpoint directory ("" = disabled). When set, the pipeline
    # restores on construction and snapshots at ack barriers every
    # snapshot_every_batches frames (<= 0 = the default cadence of
    # fast_path.DEFAULT_SNAPSHOT_EVERY: a set dir always checkpoints,
    # since restoring state while acking past it would lose events).
    snapshot_dir: str = ""
    snapshot_every_batches: int = 0
    # "delta" (default): a barrier captures only the HLL banks touched
    # since the last one; the background writer chains delta-NNNN.npz
    # files off the last full base through an fsync'd CHAIN.json whose
    # rename is the durability point, and the barrier's frames are
    # acked when their delta is durable. "barrier": every snapshot
    # writes the full sketch state.
    snapshot_mode: str = "delta"
    # Delta files per chain before the writer folds them into a base.
    snapshot_compact_every: int = 16
    # Record each durable chain file's sha256 in CHAIN.json (verified
    # before restore trusts the file). False skips computing digests at
    # the writer; verification still runs where digests exist.
    integrity: bool = True

    def __post_init__(self):
        if self.sketch_backend not in ("tpu", "memory", "redis",
                                       "redis-sim"):
            raise ValueError(f"unknown sketch backend: {self.sketch_backend}")
        if self.retry_budget_s <= 0:
            raise ValueError("retry_budget_s must be positive")
        if self.transport_backend not in ("memory", "socket", "pulsar"):
            raise ValueError(
                f"unknown transport backend: {self.transport_backend}")
        if self.storage_backend not in ("memory", "columnar", "cassandra"):
            raise ValueError(
                f"unknown storage backend: {self.storage_backend}")
        if self.bloom_layout not in ("flat", "blocked"):
            raise ValueError(f"unknown bloom layout: {self.bloom_layout}")
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.ingress_lanes < 0:
            raise ValueError(
                "ingress_lanes must be >= 0 (0 = one consumer, N = the "
                "striped plane with N lanes)")
        if self.lane_queue_depth < 1:
            raise ValueError("lane_queue_depth must be >= 1")
        if self.lane_decode not in ("auto", "native", "vector"):
            raise ValueError(
                f"unknown lane decode engine: {self.lane_decode}")
        if self.ingress_wire not in ("auto", "json", "binary", "columnar",
                                     "shm"):
            raise ValueError(f"unknown ingress wire: {self.ingress_wire}")
        if self.ingress_wire == "shm" and not self.shm_dir:
            raise ValueError(
                "--ingress-wire=shm needs --shm-dir (the ring-file "
                "directory both ends map)")
        if self.shm_slots < 2:
            raise ValueError("shm_slots must be >= 2 (ring depth)")
        if self.shm_slot_bytes % 8 or self.shm_slot_bytes < 64:
            raise ValueError("shm_slot_bytes must be a multiple of 8, >= 64")
        if not (-1 <= self.serve_port <= 65535):
            raise ValueError(
                f"serve_port out of range: {self.serve_port} "
                "(0 = off, -1 = ephemeral)")
        if self.query_batch_max < 1:
            raise ValueError("query_batch_max must be >= 1")
        if self.read_staleness_ceiling_s < 0:
            raise ValueError(
                "read_staleness_ceiling_s must be >= 0 (0 = no staleness "
                "objective)")
        if self.invalid_topic and self.invalid_topic == self.pulsar_topic:
            # Republishing invalid events onto the processor's own
            # input topic would re-consume and republish them forever.
            raise ValueError(
                "invalid_topic must differ from pulsar_topic (equal "
                "topics make an unbounded reprocessing loop)")
        if not (4 <= self.hll_precision <= 18):
            raise ValueError(
                f"hll precision out of range: {self.hll_precision}")
        if self.wire_format not in ("auto", "delta", "seg", "word",
                                    "bytes"):
            raise ValueError(f"unknown wire format: {self.wire_format}")
        if not (0.0 <= self.audit_sample <= 1.0):
            raise ValueError(
                f"audit_sample out of range: {self.audit_sample} "
                "(a fraction in [0, 1])")
        if self.temporal_period_s < 0:
            raise ValueError("temporal_period_s must be >= 0 (0 = off)")
        if self.temporal_period_s:
            period_micros(self.temporal_period_s)  # >= 1s, loud
        if self.allowed_lateness_s < 0:
            raise ValueError("allowed_lateness_s must be >= 0")
        if self.watermark_idle_s < 0:
            raise ValueError(
                "watermark_idle_s must be >= 0 (0 = only end-of-run "
                "flushes advance an idle watermark)")
        if self.temporal_ring_banks < 2:
            raise ValueError("temporal_ring_banks must be >= 2")
        if self.cms_depth < 1 or self.cms_width < 1:
            raise ValueError(
                f"bad CMS geometry {self.cms_depth}x{self.cms_width}")
        if self.cms_topk < 1:
            raise ValueError("cms_topk must be >= 1")
        if self.snapshot_mode not in ("barrier", "delta"):
            raise ValueError(
                f"unknown snapshot mode: {self.snapshot_mode}")
        if self.snapshot_compact_every <= 0:
            raise ValueError(
                "snapshot_compact_every must be positive (delta files "
                "per chain before the writer folds a full base)")
