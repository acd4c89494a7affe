"""Shared-memory ring transport: ingress for co-located producers.

Counterpart of ``attendance_tpu/transport/shm_ring.py``, file layout bit
for bit, so a JAX producer's ring feeds the port's consumer and the
other way round. An mmap'd ring of fixed-size slots holds one planar
binary frame (``events.PLANAR_MAGIC``) per slot; publish is a header
stamp, consume a bounds-checked view:

* the producer writes the frame bytes into the next free slot and
  stamps the slot's sequence word seqlock-style: ODD before the payload
  write, EVEN (the slot's generation, ``(seq + 1) << 1``) after it, so a
  reader polling the slot sees the stable word for the sequence it
  expects or retries;
* the consumer hands out a ``memoryview`` of the slot (the planar
  columns decode as views of it);
* ack and nack map onto a consumer cursor and a redelivery region: the
  header persists ``ack_cursor`` (every sequence below it is processed
  and durable under the group-commit contract) and a delivery count per
  slot, so a crashed consumer re-attaches, resumes at ``ack_cursor`` and
  redelivers exactly the unacked tail;
* a full ring (``nslots`` published-but-unacked frames) blocks the
  producer: backpressure, never overwrite. A slot is recycled only after
  the consumer acked past it, which also keeps handed-out views stable
  until their frame is acknowledged; whatever must outlive the ack
  (the fused pipeline's stored columns) is copied out before it.

Crash contracts: a producer killed mid-write leaves the slot's word odd,
so the frame was never published; a producer killed between the stable
stamp and the head bump leaves a published slot that the next producer
finds by scanning stable words; a consumer killed mid-run resumes at
the durable ``ack_cursor``. Torn reads are retried, never delivered,
and counted (``ShmRingConsumer.torn_reads``).

Layout (little-endian): a header of ``_header_bytes(nslots)`` bytes
(magic ``ATSHRNG1``, u32 version, u32 nslots, u32 slot_bytes, u32
reserved; u64 head at 24; u64 ack cursor at 32; u32 delivery counts
from 64), then ``nslots`` slots of ``slot_bytes``: u64 sequence word,
u32 payload length, payload. One producer process and one consumer
process per ring file (striped ingress maps one ring per lane).
Ordering relies on x86-TSO store order: the word is written after the
payload on publish and read on both sides of it on consume.

Chaos sites (site ``shm.slot``, on the producer): ``torn_slot`` leaves
the slot mid-write (odd word, half the payload) for a beat before it
completes the publish, which a concurrent reader must retry and never
deliver; ``writer_stall`` parks the producer mid-write for its
duration (readers wait, they do not tear).
"""

from __future__ import annotations

import heapq
import mmap
import os
import struct
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

from attendance_tpu_torch.transport.memory_broker import (
    Message, ReceiveTimeout)

RING_MAGIC = b"ATSHRNG1"
RING_VERSION = 1

_HDR = struct.Struct("<8sIIII")      # magic, version, nslots, slot_bytes, rsv
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_OFF_HEAD = 24                       # u64: next sequence to publish
_OFF_ACK = 32                        # u64: all sequences below are acked
_OFF_RED = 64                        # u32[nslots] delivery counts
_SLOT_HDR = 12                       # u64 seqword + u32 payload length

DEFAULT_SLOTS = 64
DEFAULT_SLOT_BYTES = 1 << 21


class ShmRingFull(RuntimeError):
    """A publish timed out against a full ring (the consumer is not
    draining): the backpressure signal, raised instead of overwriting."""


def ring_path(directory, topic: str, lane: int) -> Path:
    """One ring file per (topic, lane): producer striping and lane
    subscription agree on the mapping here."""
    safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                   for c in topic)
    return Path(directory) / f"{safe}.lane{lane}.ring"


def _header_bytes(nslots: int) -> int:
    raw = _OFF_RED + 4 * nslots
    return (raw + 4095) // 4096 * 4096


class _Ring:
    """The shared mapping: its geometry and the fields both ends use."""

    def __init__(self, path, nslots: int, slot_bytes: int):
        if slot_bytes % 8 or slot_bytes <= _SLOT_HDR:
            raise ValueError(
                f"slot_bytes must be a multiple of 8 > {_SLOT_HDR} "
                f"(got {slot_bytes})")
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        size = _header_bytes(nslots) + nslots * slot_bytes
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            import fcntl
            fcntl.flock(fd, fcntl.LOCK_EX)
            try:
                if os.fstat(fd).st_size == 0:
                    os.ftruncate(fd, size)
                    os.pwrite(fd, _HDR.pack(RING_MAGIC, RING_VERSION,
                                            nslots, slot_bytes, 0), 0)
                else:
                    magic, ver, have_n, have_sb, _ = _HDR.unpack(
                        os.pread(fd, _HDR.size, 0))
                    if magic != RING_MAGIC:
                        raise ValueError(f"{self.path} is not an shm ring "
                                         f"(magic {magic!r})")
                    if ver != RING_VERSION:
                        raise ValueError(
                            f"{self.path}: ring version {ver}, this build "
                            f"speaks {RING_VERSION}")
                    if (have_n, have_sb) != (nslots, slot_bytes):
                        raise ValueError(
                            f"{self.path}: ring geometry is "
                            f"{have_n}x{have_sb}B, configured "
                            f"{nslots}x{slot_bytes}B; both ends must "
                            "agree (--shm-slots/--shm-slot-bytes)")
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._view = memoryview(self._mm)
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        self.payload_cap = slot_bytes - _SLOT_HDR
        self._slot0 = _header_bytes(nslots)

    # -- header fields -----------------------------------------------------------
    def head(self) -> int:
        return _U64.unpack_from(self._mm, _OFF_HEAD)[0]

    def set_head(self, v: int) -> None:
        _U64.pack_into(self._mm, _OFF_HEAD, v)

    def ack_cursor(self) -> int:
        return _U64.unpack_from(self._mm, _OFF_ACK)[0]

    def set_ack_cursor(self, v: int) -> None:
        _U64.pack_into(self._mm, _OFF_ACK, v)

    def delivery_count(self, seq: int) -> int:
        return _U32.unpack_from(self._mm,
                                _OFF_RED + 4 * (seq % self.nslots))[0]

    def set_delivery_count(self, seq: int, v: int) -> None:
        _U32.pack_into(self._mm, _OFF_RED + 4 * (seq % self.nslots), v)

    # -- slots ---------------------------------------------------------------------
    def slot_off(self, seq: int) -> int:
        return self._slot0 + (seq % self.nslots) * self.slot_bytes

    def seqword(self, seq: int) -> int:
        return _U64.unpack_from(self._mm, self.slot_off(seq))[0]

    def set_seqword(self, seq: int, v: int) -> None:
        _U64.pack_into(self._mm, self.slot_off(seq), v)

    @staticmethod
    def stable_word(seq: int) -> int:
        return (seq + 1) << 1

    def payload_view(self, seq: int):
        """A bounds-checked view of the slot's payload, or None when the
        slot is torn or not yet published for ``seq`` (the seqlock read:
        the stable word before AND after the bounds check)."""
        off = self.slot_off(seq)
        want = self.stable_word(seq)
        if _U64.unpack_from(self._mm, off)[0] != want:
            return None
        (ln,) = _U32.unpack_from(self._mm, off + 8)
        if ln > self.payload_cap:
            return None  # torn length: retry until the stamp settles
        view = self._view[off + _SLOT_HDR: off + _SLOT_HDR + ln]
        if _U64.unpack_from(self._mm, off)[0] != want:
            return None
        return view

    def close(self) -> None:
        try:
            self._view.release()
            self._mm.close()
        except (BufferError, ValueError):
            # Views handed to a consumer may still be alive (a block not
            # yet processed): the mapping then stays open until the
            # process exits rather than pulling memory out from under
            # them.
            pass


class ShmRingProducer:
    """The single writer of one ring."""

    def __init__(self, path, *, nslots: int = DEFAULT_SLOTS,
                 slot_bytes: int = DEFAULT_SLOT_BYTES, chaos=None):
        self._ring = _Ring(path, nslots, slot_bytes)
        self._chaos = chaos
        self._head = self._ring.head()  # resume where the file says
        # A producer killed between the stable stamp (the publish point)
        # and the head bump left a PUBLISHED slot the header does not
        # count: resuming at the recorded head would overwrite a frame
        # the consumer may already hold a view of. Scan forward over
        # stable words, at most the ring depth.
        while (self._head - self._ring.ack_cursor() < self._ring.nslots
               and self._ring.seqword(self._head)
               == _Ring.stable_word(self._head)):
            self._head += 1
        if self._head != self._ring.head():
            self._ring.set_head(self._head)
        self._lock = threading.Lock()

    def send(self, data, properties=None, *,
             timeout_s: float = 30.0) -> int:
        """Publish one frame; returns its sequence. Blocks while the ring
        is full (backpressure, never an overwrite). ``properties`` are
        accepted for the producer call shape and dropped: the ring has no
        property channel."""
        del properties
        ring = self._ring
        n = len(data)
        if n > ring.payload_cap:
            raise ValueError(
                f"frame of {n} bytes exceeds the ring's "
                f"{ring.payload_cap}-byte slots; raise --shm-slot-bytes "
                "or shrink the frames")
        with self._lock:
            seq = self._head
            deadline = time.monotonic() + timeout_s
            while seq - ring.ack_cursor() >= ring.nslots:
                if time.monotonic() > deadline:
                    raise ShmRingFull(
                        f"ring {ring.path.name} full for {timeout_s}s "
                        f"(head={seq}, ack={ring.ack_cursor()})")
                time.sleep(0.0002)
            off = ring.slot_off(seq)
            ring.set_seqword(seq, _Ring.stable_word(seq) | 1)  # busy
            inj = self._chaos
            if inj is not None and inj.roll("shm.slot", "torn_slot"):
                # The slot left visibly torn mid-payload for a beat: a
                # concurrent reader must see the odd word and retry,
                # never deliver half a frame.
                half = n // 2
                ring._mm[off + _SLOT_HDR: off + _SLOT_HDR + half] = bytes(
                    data[:half])
                time.sleep(0.001)
            if inj is not None:
                stall = inj.stall_s("shm.slot")
                if stall:
                    time.sleep(stall)
            ring._mm[off + _SLOT_HDR: off + _SLOT_HDR + n] = (
                data if isinstance(data, (bytes, bytearray))
                else bytes(data))
            _U32.pack_into(ring._mm, off + 8, n)
            ring.set_delivery_count(seq, 0)
            # The publish point: payload first, stable word second
            # (x86-TSO keeps the order); head is bookkeeping only.
            ring.set_seqword(seq, _Ring.stable_word(seq))
            self._head = seq + 1
            ring.set_head(self._head)
        return seq

    def send_many(self, datas, properties=None) -> int:
        last = -1
        for d in datas:
            last = self.send(d)
        return last

    def flush(self) -> None:
        pass  # publishes are synchronous stamps

    def close(self) -> None:
        self._ring.close()


class ShmRingConsumer:
    """The single reader of one ring: the broker consumer's call shape
    (receive, batch receive, the chunk lane, acks, nacks, backlog) over
    the cursor and the redelivery region."""

    def __init__(self, path, *, nslots: int = DEFAULT_SLOTS,
                 slot_bytes: int = DEFAULT_SLOT_BYTES, lane: int = 0):
        self._ring = _Ring(path, nslots, slot_bytes)
        # Resume at the durable cursor: everything below it was acked;
        # the unacked tail redelivers.
        self._ack_cursor = self._ring.ack_cursor()
        self._cursor = self._ack_cursor
        self._acked: set = set()
        self._redeliver: List[int] = []  # heap of nacked sequences
        self._chunks: dict = {}
        self._next_chunk = 1
        self._lock = threading.Lock()
        self.torn_reads = 0
        self._c_torn = None
        from attendance_tpu_torch import obs
        t = obs.get()
        if t is not None:
            lane_l = str(lane)
            self._c_torn = t.registry.counter(
                "attendance_shm_torn_reads_total",
                help="Seqlock-retried torn slot reads", lane=lane_l)
            ring = self._ring

            def _depth(r=ring) -> float:
                try:
                    return float(r.head() - r.ack_cursor())
                except ValueError:
                    # A scrape after cleanup unmapped the ring: NaN
                    # (rendered per the text format), never a lying 0.
                    return float("nan")

            t.registry.gauge(
                "attendance_shm_ring_depth",
                help="Published-but-unacked frames in the shm ring",
                lane=lane_l).set_function(_depth)

    # -- receive -----------------------------------------------------------------
    def _next_raw(self) -> Optional[Tuple[int, object, int, None]]:
        """One delivery attempt: the redelivery heap first, then the
        cursor; None when nothing is deliverable now."""
        with self._lock:
            if self._redeliver:
                seq = heapq.heappop(self._redeliver)
            else:
                seq = self._cursor
                view = self._ring.payload_view(seq)
                if view is None:
                    if self._ring.seqword(seq) == (
                            _Ring.stable_word(seq) | 1):
                        # The busy word of exactly this generation: the
                        # writer is mid-payload. Observed and retried,
                        # never delivered.
                        self.torn_reads += 1
                        if self._c_torn is not None:
                            self._c_torn.inc()
                    return None
                self._cursor = seq + 1
                red = self._ring.delivery_count(seq)
                self._ring.set_delivery_count(seq, red + 1)
                return (seq, view, red, None)
        # A redelivery: unacked slots are never recycled, so a slot that
        # no longer reads is a protocol violation.
        view = self._ring.payload_view(seq)
        if view is None:
            raise RuntimeError(
                f"shm ring {self._ring.path.name}: unacked slot {seq} no "
                "longer readable (protocol violation)")
        with self._lock:
            red = self._ring.delivery_count(seq)
            self._ring.set_delivery_count(seq, red + 1)
        return (seq, view, red, None)

    def _collect_raw(self, max_n: int,
                     timeout_millis: Optional[int]) -> list:
        deadline = time.monotonic() + (
            (timeout_millis if timeout_millis is not None else 50) / 1000.0)
        out = []
        while len(out) < max_n:
            tok = self._next_raw()
            if tok is not None:
                out.append(tok)
                continue
            if out or time.monotonic() >= deadline:
                break
            time.sleep(0.0002)
        if not out:
            raise ReceiveTimeout(f"no shm frame within {timeout_millis}ms")
        return out

    def receive(self, timeout_millis: Optional[int] = None) -> Message:
        seq, view, red, props = self._collect_raw(1, timeout_millis)[0]
        return Message(view, seq, red, props)

    def receive_many(self, max_n: int,
                     timeout_millis: Optional[int] = None) -> list:
        return [Message(d, s, r, p) for s, d, r, p
                in self._collect_raw(max_n, timeout_millis)]

    # -- the chunk lane (what the striped ingress lanes read) -------------------
    def receive_chunk(self, max_n: int,
                      timeout_millis: Optional[int] = None):
        toks = self._collect_raw(max_n, timeout_millis)
        with self._lock:
            cid = self._next_chunk
            self._next_chunk += 1
            self._chunks[cid] = [t[0] for t in toks]
        return cid, toks

    def acknowledge_chunk(self, chunk_id: int) -> None:
        self.acknowledge_ids(self._chunks.pop(chunk_id, ()))

    def nack_chunk(self, chunk_id: int) -> None:
        seqs = self._chunks.pop(chunk_id, ())
        with self._lock:
            for s in seqs:
                heapq.heappush(self._redeliver, s)

    def explode_chunk(self, chunk_id: int) -> None:
        # Acks and nacks are per sequence already.
        self._chunks.pop(chunk_id, None)

    # -- settlement: the consumer cursor ------------------------------------------
    def acknowledge_ids(self, seqs) -> None:
        with self._lock:
            for s in seqs:
                if s >= self._ack_cursor:
                    self._acked.add(s)
            # Advance over the contiguous acked prefix only: an unacked
            # frame holds the cursor back, so a crash before ITS ack
            # still redelivers it on resume.
            moved = False
            while self._ack_cursor in self._acked:
                self._acked.discard(self._ack_cursor)
                self._ack_cursor += 1
                moved = True
            if moved:
                self._ring.set_ack_cursor(self._ack_cursor)

    def acknowledge(self, msg) -> None:
        self.acknowledge_ids((msg.message_id,))

    def acknowledge_many(self, msgs) -> None:
        self.acknowledge_ids([m.message_id for m in msgs])

    def negative_acknowledge(self, msg) -> None:
        with self._lock:
            heapq.heappush(self._redeliver, msg.message_id)

    def backlog(self) -> int:
        with self._lock:
            return (self._ring.head() - self._cursor
                    + len(self._redeliver))

    def close(self) -> None:
        # Unacked sequences stay unacked in the mapping: the next attach
        # redelivers them (crash takeover, with the file as the broker).
        self._ring.close()


class _StripedShmProducer:
    """Whole frames round-robin across the topic's lane rings."""

    def __init__(self, rings: List[ShmRingProducer]):
        self._rings = rings
        self._i = 0

    def send(self, data, properties=None) -> int:
        ring = self._rings[self._i]
        self._i = (self._i + 1) % len(self._rings)
        return ring.send(data, properties)

    def send_many(self, datas, properties=None) -> int:
        last = -1
        for d in datas:
            last = self.send(d)
        return last

    def flush(self) -> None:
        pass

    def close(self) -> None:
        for r in self._rings:
            r.close()


class ShmClient:
    """The client call shape over a directory of ring files, one ring
    per (topic, lane): ``subscribe_lane`` serves the striped ingress
    plane, ``subscribe`` the one-consumer run loop (lane 0)."""

    def __init__(self, directory, *, lanes: int = 1,
                 nslots: int = DEFAULT_SLOTS,
                 slot_bytes: int = DEFAULT_SLOT_BYTES, chaos=None):
        if not directory:
            raise ValueError(
                "--ingress-wire=shm needs --shm-dir (the directory holding "
                "the ring files; /dev/shm/... for a memory-backed ring)")
        self.directory = Path(directory)
        self.lanes = max(1, lanes)
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        self._chaos = chaos
        self._owned: list = []

    @classmethod
    def from_config(cls, config) -> "ShmClient":
        from attendance_tpu_torch import chaos
        return cls(config.shm_dir, lanes=max(1, config.ingress_lanes),
                   nslots=config.shm_slots, slot_bytes=config.shm_slot_bytes,
                   chaos=chaos.ensure(config))

    def _track(self, obj):
        self._owned.append(obj)
        return obj

    def create_producer(self, topic: str):
        rings = [ShmRingProducer(ring_path(self.directory, topic, i),
                                 nslots=self.nslots,
                                 slot_bytes=self.slot_bytes,
                                 chaos=self._chaos)
                 for i in range(self.lanes)]
        if len(rings) == 1:
            return self._track(rings[0])
        return self._track(_StripedShmProducer(rings))

    def subscribe(self, topic: str, subscription_name: str,
                  **_kw) -> ShmRingConsumer:
        return self.subscribe_lane(topic, subscription_name, 0)

    def subscribe_lane(self, topic: str, subscription_name: str,
                       lane: int) -> ShmRingConsumer:
        del subscription_name  # one consumer per ring; no registry
        return self._track(ShmRingConsumer(
            ring_path(self.directory, topic, lane), nslots=self.nslots,
            slot_bytes=self.slot_bytes, lane=lane))

    def close(self) -> None:
        for obj in self._owned:
            try:
                obj.close()
            except Exception:
                pass
        self._owned.clear()


__all__ = [
    "ShmRingProducer", "ShmRingConsumer", "ShmClient", "ShmRingFull",
    "ring_path", "DEFAULT_SLOTS", "DEFAULT_SLOT_BYTES",
]
