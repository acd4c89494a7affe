"""Deterministic, seed-driven fault injection (``--chaos``).

Counterpart of ``attendance_tpu/chaos/__init__.py``: the same spec
grammar, the same fault sites and the same seeded streams, so one spec
and seed give both packages the same schedule draw for draw. Every
transport hop, writer thread and sink seam carries a named fault point,
and one spec string drives probabilistic faults at those points; a
failing run replays from its seed.

Spec grammar (comma-separated ``fault=prob`` tokens; duration-bearing
faults use ``fault=duration:prob``)::

    drop=0.01,delay=5ms:0.05,dup=0.005,conn_reset=0.002,
    persist_fail=0.01,writer_stall=200ms:0.01,corrupt=0.001,
    snap_fail=0.01,disk_corrupt=0.01,torn_write=0.01,enospc=0.01,
    partition=2s:0.005,torn_slot=0.01

``off`` parses to a spec with every probability zero: the fault plane is
installed (every hook runs against a live injector) but never fires,
which measures the plane's own cost. An empty string means no injector
at all (the default: every seam pays one ``is not None`` branch).

Determinism: each (site, fault) pair draws from its own
``random.Random`` seeded with ``crc32(site/fault) ^ seed``, so the
schedule at every fault point is a function of the seed alone, however
threads interleave across points.

Fault points:

* ``socket.produce`` / ``socket.consume`` / ``socket.control`` (and
  ``socket.consume.laneN``): the socket RPC seams. ``drop`` loses the
  request before it is sent (retried); ``conn_reset`` severs the TCP
  connection before (request lost) or after (reply lost: the op may
  have executed, so the retry duplicates it) the send, a coin flip a
  hit; ``delay`` sleeps before the send.
* ``transport.produce`` / ``transport.consume``: backend-agnostic
  producer and consumer proxies (memory and socket): ``delay`` sleeps,
  ``dup`` publishes a message twice, ``corrupt`` flips bytes of a
  received payload (the broker keeps the original, so a nack redelivers
  clean bytes).
* ``bridge.forward``: ``delay`` before the bridge republishes a frame.
* ``snapshot.writer``: ``writer_stall`` sleeps inside the background
  snapshot writer; ``snap_fail`` fails the write (the bounded backoff
  and forced full base remediate).
* ``persist.insert``: ``persist_fail`` raises :class:`PersistFault` from
  the event-store insert (the circuit breaker and its spill remediate,
  ``storage/resilient.py``).
* ``disk.chain`` / ``disk.manifest`` / ``disk.spill``: the durable-write
  seam (``utils/integrity`` hooks inside the fsync'd writers):
  ``enospc`` raises OSError(ENOSPC) before any byte lands;
  ``disk_corrupt`` flips one mid-file byte after the fsync'd publish
  (storage rot that only digests and ``scrub`` notice); ``torn_write``
  truncates the published file to half. The injector keeps a ledger of
  every disk fault's path (``disk_faults``), so a soak can prove scrub
  detects every injection that survives on disk.
* ``shm.slot``: the shared-memory ring's publish seam: ``torn_slot``
  leaves the slot mid-write (sequence word odd, half the payload
  written) for a beat before completing the publish, which a reader
  must retry, never deliver; ``writer_stall`` parks the producer
  mid-write.
* ``transport.consume`` / ``fed.gossip``: ``partition`` (``dur:p``), a
  one-way blackhole window. A consumer sees silence for the window
  (receives time out; the broker retains everything); a gossip
  publisher's frames vanish without an error, and convergence recovers
  from the next full frame.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import threading
import time
import zlib
from random import Random
from typing import Dict, Optional, Tuple

_PROB_FAULTS = ("drop", "dup", "conn_reset", "persist_fail", "corrupt",
                "snap_fail", "disk_corrupt", "torn_write", "enospc",
                "torn_slot")
_TIMED_FAULTS = ("delay", "writer_stall", "partition")

_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|us)?$")


class PersistFault(RuntimeError):
    """Injected persist-sink failure (``persist_fail``): the transient
    error class the circuit breaker remediates."""


class ChaosFault(RuntimeError):
    """Injected non-transport failure (``snap_fail``)."""


def _parse_duration(raw: str, token: str) -> float:
    m = _DURATION_RE.match(raw.strip())
    if not m:
        raise ValueError(f"bad duration {raw!r} in chaos token {token!r}")
    value = float(m.group(1))
    unit = m.group(2) or "s"
    return value * {"us": 1e-6, "ms": 1e-3, "s": 1.0}[unit]


def _parse_prob(raw: str, token: str) -> float:
    try:
        p = float(raw)
    except ValueError:
        raise ValueError(
            f"bad probability {raw!r} in chaos token {token!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(
            f"chaos probability out of [0,1] in token {token!r}")
    return p


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Parsed ``--chaos`` spec: per-fault probabilities plus the
    durations of the timed faults."""

    drop: float = 0.0
    dup: float = 0.0
    conn_reset: float = 0.0
    persist_fail: float = 0.0
    corrupt: float = 0.0
    snap_fail: float = 0.0
    disk_corrupt: float = 0.0   # post-fsync bit flip (storage rot)
    torn_write: float = 0.0     # post-fsync truncation (torn sector)
    enospc: float = 0.0         # OSError(ENOSPC) at the writer seam
    torn_slot: float = 0.0      # shm ring slot left mid-write a beat
    delay: float = 0.0          # probability
    delay_s: float = 0.0        # duration per hit
    writer_stall: float = 0.0   # probability
    writer_stall_s: float = 0.0
    partition: float = 0.0      # probability a blackhole window opens
    partition_s: float = 0.0    # window duration

    @classmethod
    def parse(cls, spec: str) -> "ChaosSpec":
        spec = (spec or "").strip()
        if not spec or spec == "off":
            return cls()
        fields: Dict[str, float] = {}
        for token in spec.split(","):
            token = token.strip()
            if not token:
                continue
            name, eq, raw = token.partition("=")
            name = name.strip()
            if not eq:
                raise ValueError(f"bad chaos token {token!r} "
                                 "(want fault=prob or fault=dur:prob)")
            if name in _TIMED_FAULTS:
                dur, colon, prob = raw.partition(":")
                if not colon:
                    raise ValueError(
                        f"chaos token {token!r} needs duration:prob "
                        f"(e.g. {name}=5ms:0.05)")
                fields[name + "_s"] = _parse_duration(dur, token)
                fields[name] = _parse_prob(prob, token)
            elif name in _PROB_FAULTS:
                fields[name] = _parse_prob(raw, token)
            else:
                raise ValueError(f"unknown chaos fault {name!r} (known: "
                                 f"{', '.join(_PROB_FAULTS + _TIMED_FAULTS)})")
        return cls(**fields)

    def active(self, fault: str) -> bool:
        return getattr(self, fault) > 0.0


class ChaosInjector:
    """Rolls faults at named sites from per-(site, fault) seeded
    streams and keeps its own injected-fault ledger (mirrored into obs
    counters when telemetry is live) so a soak can compare injected vs
    observed faults without requiring telemetry."""

    def __init__(self, spec: ChaosSpec, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._streams: Dict[Tuple[str, str], Random] = {}
        # (site, fault) -> injected count: the soak's ground truth.
        self.injected: Dict[Tuple[str, str], int] = {}
        # Storage-rot ledger: every (site, fault, path) a disk fault
        # touched — the scrub soak's "every injected corruption is
        # detected" proof is judged against the paths still on disk.
        self.disk_faults: list = []
        # site -> monotonic deadline of an open partition window.
        self._blackhole_until: Dict[str, float] = {}
        self._obs_counters: Dict[Tuple[str, str], object] = {}

    def _rng(self, site: str, fault: str) -> Random:
        key = (site, fault)
        rng = self._streams.get(key)
        if rng is None:
            derived = zlib.crc32(f"{site}/{fault}".encode()) ^ self.seed
            rng = self._streams[key] = Random(derived)
        return rng

    def _count(self, site: str, fault: str) -> None:
        key = (site, fault)
        with self._lock:
            # The ledger is the soak's injected-vs-observed ground
            # truth: an unlocked read-modify-write here could lose
            # concurrent hits from different threads' fault points.
            self.injected[key] = self.injected.get(key, 0) + 1
        counter = self._obs_counters.get(key)
        if counter is None:
            from attendance_tpu_torch import obs
            t = obs.get()
            if t is None:
                return
            counter = self._obs_counters[key] = t.registry.counter(
                "attendance_chaos_injected_total",
                help="Faults injected by the chaos plane",
                site=site, fault=fault)
        counter.inc()

    def active(self, fault: str) -> bool:
        return self.spec.active(fault)

    def roll(self, site: str, fault: str) -> bool:
        """One Bernoulli draw at (site, fault); counts hits."""
        p = getattr(self.spec, fault)
        if p <= 0.0:
            return False
        with self._lock:
            hit = self._rng(site, fault).random() < p
        if hit:
            self._count(site, fault)
        return hit

    def coin(self, site: str, fault: str) -> bool:
        """Uncounted 50/50 draw from the same (site, fault) stream —
        direction choices (e.g. reset before vs after send)."""
        with self._lock:
            return self._rng(site, fault).random() < 0.5

    def delay_s(self, site: str) -> float:
        """Injected delay for this call at ``site`` (0.0 = none)."""
        return self.spec.delay_s if self.roll(site, "delay") else 0.0

    def stall_s(self, site: str) -> float:
        """Injected writer stall at ``site`` (0.0 = none)."""
        return (self.spec.writer_stall_s
                if self.roll(site, "writer_stall") else 0.0)

    def note_disk_fault(self, site: str, fault: str, path,
                        digest: str = "") -> None:
        """Record which durable artifact a disk fault mangled, plus
        the file's POST-fault digest — a soak proves scrub detects
        every injection whose rot is still on disk (a later clean
        rewrite of the same path, e.g. a manifest, heals it)."""
        with self._lock:
            self.disk_faults.append((site, fault, str(path), digest))

    def blackhole(self, site: str) -> bool:
        """Is ``site`` inside a ``partition`` blackhole window? Each
        call outside a window rolls ``partition``; a hit opens a
        window of ``partition_s`` during which every call answers
        True (messages silently vanish / receives see silence)."""
        if self.spec.partition <= 0.0:
            return False
        now = time.monotonic()
        with self._lock:
            if now < self._blackhole_until.get(site, 0.0):
                return True
        if self.roll(site, "partition"):
            with self._lock:
                self._blackhole_until[site] = now + self.spec.partition_s
            return True
        return False

    def in_blackhole(self, site: str) -> bool:
        """Read-only: is a partition window currently open at
        ``site``? (No roll: callers use this to detect that a send
        they just made may have been swallowed.)"""
        with self._lock:
            return time.monotonic() < self._blackhole_until.get(site,
                                                                0.0)

    def injected_total(self, fault: Optional[str] = None) -> int:
        with self._lock:
            return sum(n for (_, f), n in self.injected.items()
                       if fault is None or f == fault)

    @staticmethod
    def corrupt_transform(data: bytes) -> bytes:
        """The deterministic mangling ``corrupt`` applies: the first
        byte (frame magic / JSON ``{``) and a mid-frame byte are XOR-
        flipped, so every decoder raises instead of silently accepting
        altered events — in-flight corruption must surface as a poison
        frame, never as wrong data. Deterministic and involutive on
        purpose: a soak can compute the corrupted variant of a frame
        it published and recognize it in the quarantine."""
        b = bytearray(data)
        b[0] ^= 0xFF
        if len(b) > 8:
            b[len(b) // 2] ^= 0xFF
        return bytes(b)

    def corrupt_bytes(self, site: str, data: bytes) -> bytes:
        """Roll ``corrupt`` at ``site``; on a hit return the mangled
        copy (see :meth:`corrupt_transform`), else ``data`` itself."""
        if not data or not self.roll(site, "corrupt"):
            return data
        return self.corrupt_transform(data)


# ---------------------------------------------------------------------------
# Backend-agnostic transport proxies (memory AND socket): dup / delay /
# corrupt. The socket-specific faults (drop, conn_reset) live inside
# the RPC layer itself (transport/socket_broker._Rpc), where a real TCP
# connection exists to sever.
# ---------------------------------------------------------------------------

def _producer_send(proxy, inner_send, data, properties=None):
    inj = proxy._inj
    d = inj.delay_s("transport.produce")
    if d:
        time.sleep(d)
    result = inner_send(data, properties)
    if inj.roll("transport.produce", "dup"):
        # At-least-once duplicate: the idempotent sketches and the
        # read-time-dedup store absorb it; per-process counters (which
        # are at-least-once by contract) may double-count.
        inner_send(data, properties)
    return result


def _producer_send_many(proxy, inner_send_many, datas, properties=None):
    inj = proxy._inj
    d = inj.delay_s("transport.produce")
    if d:
        time.sleep(d)
    datas = [bytes(x) for x in datas]
    result = inner_send_many(datas, properties)
    dup_idx = [i for i in range(len(datas))
               if inj.roll("transport.produce", "dup")]
    if dup_idx:
        inner_send_many([datas[i] for i in dup_idx],
                        None if properties is None
                        else [properties[i] for i in dup_idx])
    return result


def _maybe_partition_consume(inj, timeout_millis) -> None:
    """Consume-side partition: inside a blackhole window the consumer
    observes SILENCE — the receive waits out (a bounded slice of) its
    timeout and raises ReceiveTimeout, exactly what a healthy broker
    with nothing to deliver looks like. The broker retains every
    message, so delivery resumes when the window closes."""
    if not inj.blackhole("transport.consume"):
        return
    from attendance_tpu_torch.transport.memory_broker import ReceiveTimeout
    wait = 0.05 if timeout_millis is None else timeout_millis / 1000.0
    time.sleep(min(wait, 0.25))
    raise ReceiveTimeout("chaos partition: transport.consume is "
                         "blackholed")


def _corrupt_tuples(inj, toks):
    out = []
    for mid, data, red, props in toks:
        out.append((mid, inj.corrupt_bytes("transport.consume", data),
                    red, props))
    return out


def _consumer_receive(proxy, inner_receive,
                      timeout_millis=None):
    inj = proxy._inj
    _maybe_partition_consume(inj, timeout_millis)
    d = inj.delay_s("transport.consume")
    if d:
        time.sleep(d)
    msg = inner_receive(timeout_millis=timeout_millis)
    data = inj.corrupt_bytes("transport.consume", msg.data())
    if data is not msg.data():
        from attendance_tpu_torch.transport.memory_broker import Message
        msg = Message(data, msg.message_id, msg.redelivery_count,
                      msg.properties() or None)
    return msg


def _consumer_receive_many(proxy, inner, max_n, timeout_millis=None):
    inj = proxy._inj
    _maybe_partition_consume(inj, timeout_millis)
    msgs = inner(max_n, timeout_millis=timeout_millis)
    if not inj.active("corrupt"):
        return msgs
    from attendance_tpu_torch.transport.memory_broker import Message
    out = []
    for msg in msgs:
        data = inj.corrupt_bytes("transport.consume", msg.data())
        if data is not msg.data():
            msg = Message(data, msg.message_id, msg.redelivery_count,
                          msg.properties() or None)
        out.append(msg)
    return out


def _consumer_receive_many_raw(proxy, inner, max_n, timeout_millis=None):
    inj = proxy._inj
    _maybe_partition_consume(inj, timeout_millis)
    toks = inner(max_n, timeout_millis=timeout_millis)
    return _corrupt_tuples(inj, toks) if inj.active("corrupt") else toks


def _consumer_receive_chunk(proxy, inner, max_n, timeout_millis=None):
    inj = proxy._inj
    _maybe_partition_consume(inj, timeout_millis)
    cid, toks = inner(max_n, timeout_millis=timeout_millis)
    return (cid, _corrupt_tuples(inj, toks)
            if inj.active("corrupt") else toks)


_PRODUCER_WRAPPERS = {"send": _producer_send,
                      "send_many": _producer_send_many}
_CONSUMER_WRAPPERS = {"receive": _consumer_receive,
                      "receive_many": _consumer_receive_many,
                      "receive_many_raw": _consumer_receive_many_raw,
                      "receive_chunk": _consumer_receive_chunk}


class _ChaosProxy:
    """Attribute-mirroring proxy: wraps only the methods named in
    ``_wrappers`` and delegates EVERYTHING else — including hasattr
    feature detection (an attribute the inner object lacks stays
    missing here, so capability probes like ``receive_chunk`` answer
    for the real backend, not the proxy)."""

    _wrappers: Dict[str, object] = {}

    def __init__(self, inner, inj: ChaosInjector):
        self._inner = inner
        self._inj = inj

    def __getattr__(self, name):
        inner_attr = getattr(self._inner, name)
        fn = self._wrappers.get(name)
        if fn is None:
            return inner_attr
        wrapped = functools.partial(fn, self, inner_attr)
        self.__dict__[name] = wrapped  # cache; next lookup skips here
        return wrapped


class ChaosProducer(_ChaosProxy):
    _wrappers = _PRODUCER_WRAPPERS


class ChaosConsumer(_ChaosProxy):
    _wrappers = _CONSUMER_WRAPPERS


class ChaosClient:
    """Client proxy handing out chaos-wrapped producers/consumers."""

    def __init__(self, inner, inj: ChaosInjector):
        self._inner = inner
        self._inj = inj

    def create_producer(self, topic: str):
        return ChaosProducer(self._inner.create_producer(topic),
                             self._inj)

    def subscribe(self, topic: str, subscription_name: str,
                  consumer_type=None):
        return ChaosConsumer(
            self._inner.subscribe(topic, subscription_name,
                                  consumer_type), self._inj)

    def subscribe_lane(self, topic: str, subscription_name: str,
                       lane: int):
        """Lane-affine subscribe, chaos-wrapped: the striped ingress
        plane's lanes get dup/delay/corrupt proxies exactly like any
        other consumer (a bare __getattr__ delegation would hand back
        an unwrapped lane and silently exempt it from the fault
        plane). Backends without the lane API (memory broker) fall
        back to a plain chaos-wrapped subscribe — lane affinity there
        is trivially true (no connection to be affine to)."""
        inner_sub = getattr(self._inner, "subscribe_lane", None)
        if inner_sub is None:
            return self.subscribe(topic, subscription_name)
        return ChaosConsumer(inner_sub(topic, subscription_name, lane),
                             self._inj)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ChaosEventStore:
    """Event-store proxy raising :class:`PersistFault` at the
    ``persist.insert`` fault point — what the circuit breaker in
    storage/resilient.py remediates."""

    def __init__(self, inner, inj: ChaosInjector,
                 site: str = "persist.insert"):
        self._inner = inner
        self._inj = inj
        self._site = site

    def _maybe_fail(self) -> None:
        if self._inj.roll(self._site, "persist_fail"):
            raise PersistFault(f"chaos persist_fail at {self._site}")

    def insert_columns(self, cols):
        self._maybe_fail()
        return self._inner.insert_columns(cols)

    def insert_batch(self, rows):
        self._maybe_fail()
        return self._inner.insert_batch(rows)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ---------------------------------------------------------------------------
# Process-wide injector (mirrors the obs/ ensure/get/disable shape).
# ---------------------------------------------------------------------------

INJECTOR: Optional[ChaosInjector] = None
_lock = threading.Lock()


def ensure(config) -> Optional[ChaosInjector]:
    """Create-or-return the process injector from config. Returns None
    when ``config.chaos`` is empty (the fault plane is absent and every
    seam pays one branch); ``--chaos off`` installs a never-firing
    injector (the disabled plane's cost)."""
    global INJECTOR
    if INJECTOR is not None:
        return INJECTOR
    spec_str = getattr(config, "chaos", "") if config is not None else ""
    if not spec_str:
        return None
    with _lock:
        if INJECTOR is None:
            INJECTOR = ChaosInjector(
                ChaosSpec.parse(spec_str),
                getattr(config, "chaos_seed", 0))
    return INJECTOR


def get() -> Optional[ChaosInjector]:
    return INJECTOR


def disable() -> None:
    """Clear the process injector (tests, soak seed boundaries)."""
    global INJECTOR
    with _lock:
        INJECTOR = None


def maybe_wrap(client):
    """Wrap a transport client with the chaos proxies iff an injector
    is installed (the make_client chokepoint; code that builds clients
    by hand calls this to mirror it)."""
    inj = get()
    return client if inj is None else ChaosClient(client, inj)
