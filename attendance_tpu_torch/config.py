"""Configuration of the port.

Counterpart of ``attendance_tpu/config.py``, cut to the fields the fused
path, its mesh, its checkpoint chain, its temporal plane, its ingress
lanes and shared-memory ring, the query plane, the generic sketch store
and the processor, the federation, the fault plane, the persist sink's
circuit breaker, the SLO engine, the profilers, the incident engine, the
fleet plane and the control plane read, with the JAX package's defaults and checks
(reference README: a 100k-student roster at a 1% false-positive rate;
Redis dense HLL precision 14).
"""

from __future__ import annotations

import dataclasses
from typing import List

from attendance_tpu_torch.temporal.buckets import period_micros

PULSAR_HOST = "pulsar://localhost:6650"
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
    pulsar_host: str = PULSAR_HOST
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
    # "memory" (the process's in-process broker), "socket" (a
    # BrokerServer at socket_broker: python -m
    # attendance_tpu_torch.transport.socket_broker) or "pulsar" (a
    # Pulsar service at pulsar_host through pulsar-client, import-gated).
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
    # The fused pipeline's mesh (attendance_tpu_torch/parallel): sketch
    # shards (sp: the filter's blocks and the registers' columns split
    # by hash range) and data-parallel replicas (dp: frames split, each
    # replica with private registers). 1 x 1 = one card.
    num_shards: int = 1
    num_replicas: int = 1
    # Replica register union across dp: "query" (default) defers the max
    # to PFCOUNT and snapshot reads (no per-step cross-replica
    # collective, what lets dp span processes cheaply); "step" unites
    # after every batch. Observationally identical.
    replica_sync: str = "query"
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
    # Deterministic fault injection ("" = no fault plane; "off" = the
    # plane installed with every probability zero, its own cost). Spec
    # grammar (chaos/__init__.py): comma-separated fault=prob tokens,
    # timed faults fault=dur:prob, e.g. "drop=0.01,delay=5ms:0.05,
    # dup=0.005,conn_reset=0.002,persist_fail=0.01,
    # writer_stall=200ms:0.01,corrupt=0.001". Every draw comes from a
    # per-(site, fault) stream derived from chaos_seed, so a failing run
    # replays from its seed.
    chaos: str = ""
    chaos_seed: int = 0
    # Circuit breaker of the persist sink ("" = the raw sink):
    # persist_breaker_failures consecutive insert failures open the
    # circuit, writes then go to fsync'd spill files in this directory,
    # and after persist_breaker_cooldown_s a half-open probe drains them
    # back in order once the sink heals (storage/resilient.py).
    persist_spill_dir: str = ""
    persist_breaker_failures: int = 3
    persist_breaker_cooldown_s: float = 1.0
    # Append one JSON metrics line per processor run to this file.
    metrics_json: str = ""
    # Live telemetry (attendance_tpu_torch/obs): all default OFF, and
    # with every flag unset the instrumented paths pay one branch per
    # event. metrics_prom appends a Prometheus text-exposition block per
    # interval to a file; metrics_port serves GET /metrics from a stdlib
    # HTTP endpoint (-1 = an ephemeral port); flight_recorder keeps a
    # ring of the last N per-batch records, dumped as JSON to
    # flight_path on SIGUSR1, a run-loop crash or an explicit dump;
    # trace_out collects per-batch spans (publish -> dequeue -> decode
    # -> dispatch -> device_wait, the context carried in the broker
    # message property ``traceparent``) and writes them there as
    # Chrome-trace JSON at the end of each run.
    metrics_prom: str = ""
    metrics_port: int = 0
    metrics_interval_s: float = 1.0
    flight_recorder: int = 0
    flight_path: str = "flight_recorder.json"
    trace_out: str = ""
    # Label-cardinality guard: distinct label sets per metric name
    # before new sets fold into an unexported sink (<= 0 = no guard).
    metric_series_max: int = 1024
    # Profiling ("" = disabled): directory for a torch.profiler trace of
    # the processing run (one Chrome-trace JSON, utils/profiling.py; CUDA
    # activity included on a card). Device dispatches are
    # record_function-labelled so kernel time attributes to stages.
    profile_dir: str = ""
    # Continuous host sampling profiler (obs/profiler.py; 0 = off): a
    # background thread samples sys._current_frames() at this rate,
    # folds per-thread collapsed stacks, and attributes every sample to
    # the thread's current pipeline stage (dequeue/decode/dispatch/
    # device_wait/temporal/snapshot/serve/...): the per-stage SELF-TIME
    # table `telemetry --attribution` renders. Stage fractions export
    # live as attendance_profile_stage_fraction{stage=} gauges. Hot
    # threads pay only the stage-mark dict writes; sampling runs on its
    # own thread. 29-97 Hz are good prime choices (avoid aliasing the
    # snapshot cadence).
    profile_hz: float = 0.0
    # Artifact directory for the sampling profiler ("" = in-memory
    # only: live gauges still export): profile.folded (flamegraph
    # collapsed stacks), profile_trace.json (Perfetto stage timeline),
    # attribution.json (the offline attribution table, incl. the
    # launch-shape fingerprint ledger).
    profile_out: str = ""
    # SLO engine ("" = disabled): evaluate declarative objectives
    # (accuracy ceilings, throughput floor, latency quantiles) over fast
    # and slow burn-rate windows and append one JSON line per alert
    # transition (firing/resolved) here: obs/slo.py.
    alert_log: str = ""
    # Extra/override SLO specs, e.g. "fpr<=0.01", "throughput>=1e6",
    # "dequeue_p99<=0.05" (obs.slo.parse_slo has the alias table). The
    # accuracy defaults are always installed when the engine is on.
    slo: List[str] = dataclasses.field(default_factory=list)
    # Burn-rate windows (seconds): the fast window gates alert freshness
    # and hysteresis clearing, the slow window rejects single-window
    # spikes (SRE multi-window multi-burn-rate).
    slo_fast_s: float = 60.0
    slo_slow_s: float = 300.0
    # Incident plane ("" = disabled): correlate live breach conditions
    # (SLO firings, circuit opens, spill growth, steady launch shapes,
    # merge-lag/staleness/watermark breaches, dead peers, lane stalls,
    # integrity rejects) into incident records and write a checksummed
    # evidence bundle per incident under this directory: obs/incident.py.
    incident_dir: str = ""
    # Hysteresis: consecutive clean evaluation ticks before an open
    # incident clears.
    incident_clear_ticks: int = 3
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
    # Accuracy audit (> 0 turns telemetry on): keep an exact shadow of
    # this hash-sampled fraction of the key space, cross-check every
    # sampled BF.EXISTS/PFADD/PFCOUNT answer against it, and export
    # MEASURED accuracy gauges (attendance_bloom_measured_fpr,
    # attendance_bloom_false_negatives_total,
    # attendance_hll_measured_rel_error) beside the occupancy-based
    # estimators: obs/audit.py. At >= 1.0 the temporal plane also keeps
    # per-bucket sets of valid students (the window audit oracle).
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
    # Federated scale-out (attendance_tpu_torch/federation): fed_worker
    # names this ingest worker ("" = federation off). A federated worker
    # owns hash shard fed_shard of fed_shards and, at every snapshot
    # fence, gossips its dirty-bank delta (full frames at preload,
    # restore and base fences) as versioned merge frames on
    # fed_gossip_topic, which an aggregator (the `federate` verb) folds
    # into one queryable view. fed_gossip_broker points the gossip at a
    # socket broker of its own ("" = this pipeline's transport);
    # fed_heartbeat_s keeps liveness observable between fences, and a
    # peer silent past fed_dead_after_s is declared dead (its shard
    # orphaned at a bumped map version, its durable chain recovered by
    # the aggregator).
    fed_worker: str = ""
    fed_shard: int = 0
    fed_shards: int = 1
    fed_gossip_topic: str = "attendance-fed-gossip"
    fed_gossip_broker: str = ""
    fed_heartbeat_s: float = 2.0
    fed_dead_after_s: float = 10.0
    # Fleet plane (obs/fleet.py). fleet_push names a FleetCollector
    # HOST:PORT ("" = off): this process's telemetry bundle then starts
    # a pusher shipping its registry snapshot and bounded span batches
    # there every fleet_push_interval_s (through the transport's
    # retry/reconnect/chaos seams at site "fleet.push"; a dead collector
    # costs log lines, never throughput or correctness).
    # fleet_role/fleet_instance label this process in the merged
    # registry and the stitched trace ("" = derived: the verbs set their
    # role, the instance falls back to fed_worker or the pid).
    fleet_push: str = ""
    fleet_role: str = ""
    fleet_instance: str = ""
    fleet_push_interval_s: float = 2.0
    # Collector side: fleet_port != 0 runs a FleetCollector in this
    # process (-1 = ephemeral; the `federate` verb hosts it), its merged
    # views mounted under /fleet/* on the --metrics-port endpoint;
    # fleet_dir keeps the collected per-role prom files, the stitched
    # trace and the status snapshot for `doctor --fleet`.
    fleet_port: int = 0
    fleet_dir: str = ""
    # Self-driving control plane (attendance_tpu_torch/control): a
    # controller thread that actuates bounded knobs (ingress admission,
    # the degradation ladder, lane scaling, snapshot cadence, watermark/
    # ring sizing) off the signals the obs plane already measures.
    # Enabled by control_log: the schema'd JSONL actuation log is the
    # plane's defining artifact (`doctor --actuations` replays it).
    control_log: str = ""
    # When set, shed-rung admission spills raw ingress frames durably
    # here (checksummed + fsync'd) and acks them; empty = nack back to
    # the broker (retention is the backpressure).
    control_spill_dir: str = ""
    # Minimum seconds between controller moves on the same knob (and
    # between degradation-ladder rung changes).
    control_dwell_s: float = 2.0
    # Consecutive clean controller ticks before de-escalation.
    control_clear_ticks: int = 3
    # Max ladder transitions per rolling minute before the controller
    # holds (anti-flap backstop).
    control_flap_limit: int = 8

    def __post_init__(self):
        if self.sketch_backend not in ("tpu", "memory", "redis",
                                       "redis-sim"):
            raise ValueError(f"unknown sketch backend: {self.sketch_backend}")
        if self.retry_budget_s <= 0:
            raise ValueError("retry_budget_s must be positive")
        if self.chaos:
            # Parsed here: a bad spec fails at flag time with the
            # grammar's message, not mid-run at the first roll.
            from attendance_tpu_torch.chaos import ChaosSpec
            ChaosSpec.parse(self.chaos)
        if self.persist_breaker_failures <= 0:
            raise ValueError("persist_breaker_failures must be positive")
        if self.persist_breaker_cooldown_s <= 0:
            raise ValueError(
                "persist_breaker_cooldown_s must be positive")
        if self.transport_backend not in ("memory", "socket", "pulsar"):
            raise ValueError(
                f"unknown transport backend: {self.transport_backend}")
        if (self.chaos and self.transport_backend == "pulsar"
                and self.ingress_wire != "shm"):
            # The chaos proxies rebuild messages with the memory broker's
            # call shapes, which pulsar-client's consumers do not take:
            # the fault plane cannot ride this transport, and a soak with
            # it quietly off would pass without a fault.
            raise ValueError(
                "chaos is not supported on the pulsar transport (the fault "
                "plane rides the memory, socket and shm transports)")
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
        if (self.ingress_wire == "shm" and self.fed_worker
                and not self.fed_gossip_broker):
            raise ValueError(
                "a federated worker on shm ingress has no broker "
                "transport for gossip frames — set --fed-gossip-broker")
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
        if not (-1 <= self.metrics_port <= 65535):
            raise ValueError(
                f"metrics_port out of range: {self.metrics_port} "
                "(0 = off, -1 = ephemeral)")
        if self.metrics_interval_s <= 0:
            raise ValueError("metrics_interval_s must be positive")
        if self.flight_recorder < 0:
            raise ValueError("flight_recorder must be >= 0 (ring size)")
        if self.profile_hz < 0:
            raise ValueError("profile_hz must be >= 0 (0 = off)")
        if self.profile_hz > 1000:
            raise ValueError(
                "profile_hz above 1000 would make the sampler itself "
                "the hot path — pick something in 10-250")
        if self.profile_out and not self.profile_hz:
            raise ValueError(
                "--profile-out without --profile-hz writes nothing "
                "(the sampler is off) — set a rate, e.g. "
                "--profile-hz 29")
        if self.slo_fast_s <= 0 or self.slo_slow_s <= 0:
            raise ValueError("SLO windows must be positive")
        if self.slo_fast_s > self.slo_slow_s:
            raise ValueError(
                "slo_fast_s must not exceed slo_slow_s (the slow "
                "window is what rejects single-window spikes)")
        if self.slo:
            # Parsed here: a spec naming an unknown stage would sit in
            # the registry and never fire.
            from attendance_tpu_torch.obs.slo import parse_slo
            for spec in self.slo:
                parse_slo(spec)
        if self.read_staleness_ceiling_s < 0:
            raise ValueError(
                "read_staleness_ceiling_s must be >= 0 (0 = no staleness "
                "objective)")
        if self.fleet_push_interval_s <= 0:
            raise ValueError("fleet_push_interval_s must be positive")
        if not (-1 <= self.fleet_port <= 65535):
            raise ValueError(
                f"fleet_port out of range: {self.fleet_port} "
                "(0 = off, -1 = ephemeral)")
        if self.incident_clear_ticks <= 0:
            raise ValueError("incident_clear_ticks must be positive "
                             "(clear hysteresis)")
        if self.control_dwell_s <= 0:
            raise ValueError("control_dwell_s must be positive "
                             "(per-knob/per-rung dwell minimum)")
        if self.control_clear_ticks <= 0:
            raise ValueError("control_clear_ticks must be positive "
                             "(de-escalation hysteresis)")
        if self.control_flap_limit <= 0:
            raise ValueError("control_flap_limit must be positive "
                             "(transitions per minute cap)")
        if self.control_spill_dir and not self.control_log:
            raise ValueError(
                "control_spill_dir without control_log: the ingress "
                "spill is an actuation target — enable the control "
                "plane (and its actuation log) to use it")
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
        if self.replica_sync not in ("step", "query"):
            raise ValueError(f"unknown replica sync: {self.replica_sync}")
        if not (0.0 <= self.audit_sample <= 1.0):
            raise ValueError(
                f"audit_sample out of range: {self.audit_sample} "
                "(a fraction in [0, 1])")
        if self.temporal_period_s < 0:
            raise ValueError("temporal_period_s must be >= 0 (0 = off)")
        if self.temporal_period_s:
            period_micros(self.temporal_period_s)  # >= 1s, loud
            if self.num_shards * self.num_replicas > 1:
                raise ValueError(
                    "the temporal plane is single-chip only (the "
                    "sharded engine has no bank-recycle path): unset "
                    "--temporal-period-s or run 1 shard x 1 replica")
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
        if self.fed_shards < 1:
            raise ValueError("fed_shards must be >= 1")
        if not (0 <= self.fed_shard < self.fed_shards):
            raise ValueError(
                f"fed_shard {self.fed_shard} out of range "
                f"[0, {self.fed_shards})")
        if self.fed_heartbeat_s < 0:
            raise ValueError(
                "fed_heartbeat_s must be >= 0 (0 = no heartbeats)")
        if self.fed_dead_after_s <= 0:
            raise ValueError("fed_dead_after_s must be positive")
        if self.fed_worker and not self.fed_gossip_topic:
            raise ValueError("a federated worker needs a fed_gossip_topic")
