"""Length-prefixed binary batch RPC of the query plane.

Counterpart of ``attendance_tpu/serve/rpc.py``, byte for byte: a JAX
``QueryClient`` gets the same answers from the port's server, and the
other way round. The wire is the socket broker's (little-endian ``u8
opcode, u32 body_len, body``; reply ``u8 status, u32 body_len, body``,
the shared ``transport.framing`` helpers), one thread per client
connection, one request in flight per connection. Client RPCs ride the
broker's retry seam (``resilience.resilient_call`` over a reconnectable
``socket_broker._Rpc``), chaos sites included (``chaos=``: ``drop``,
``conn_reset`` and ``delay`` at ``serve.query``).

Ops (bodies little-endian):

* ``Q_EXISTS``: body ``u32 n, n*u32 keys``; reply a bitmask of
  ``ceil(n/8)`` bytes, LSB first (``np.packbits(bitorder="little")``).
* ``Q_PFCOUNT``: body ``u32 n, n*i64 days``; reply ``n*u64`` counts.
* ``Q_OCCUPANCY``: empty body; reply ``u32 n, n*(i64 day, u64 c)``.
* ``Q_RATE``: body ``u64 roster_size`` (0 = the epoch's preload size);
  reply ``u32 n, n*(i64 day, f64 rate)``.
* ``Q_STATS``: empty body; reply JSON bytes.
* ``Q_WINDOW``: body ``i64 day (-1 = all), i64 p_lo (-1 = open), i64
  p_hi (-1 = open)``; reply ``u64 estimate``.
* ``Q_WOCC``: empty body; reply ``u32 n, n*(i64 day, i64 period, u64
  est)``.
* ``Q_RATESERIES``: body ``i64 day (-1 = all), u64 roster_size``; reply
  ``u32 n, n*(i64 period, f64 rate)``.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
from typing import Optional

import numpy as np

from attendance_tpu_torch.transport.framing import recv_frame, send_frame
from attendance_tpu_torch.transport.resilience import (
    RetryPolicy, resilient_call)

logger = logging.getLogger(__name__)

Q_EXISTS = 1
Q_PFCOUNT = 2
Q_OCCUPANCY = 3
Q_RATE = 4
Q_STATS = 5
Q_WINDOW = 6
Q_WOCC = 7
Q_RATESERIES = 8

_ST_OK = 0
_ST_ERROR = 2

DEFAULT_BATCH = 4096


def _table(rows, fmt: str) -> bytes:
    """``u32 n`` then one ``fmt`` record a row."""
    return struct.pack("<I", len(rows)) + b"".join(
        struct.pack(fmt, *row) for row in rows)


def _untable(reply: bytes, fmt: str) -> list:
    (n,) = struct.unpack_from("<I", reply)
    size = struct.calcsize(fmt)
    return [struct.unpack_from(fmt, reply, 4 + size * i) for i in range(n)]


class QueryServer:
    """TCP front over a :class:`serve.engine.QueryEngine`, one thread a
    connection (a handful of reader clients sending batches: the broker
    server's model)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self._stopping = False
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "QueryServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="query-accept", daemon=True)
        self._accept_thread.start()
        logger.info("Query plane serving on %s", self.address)
        return self

    def stop(self) -> None:
        self._stopping = True
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_connection, args=(conn,),
                             name=f"query-conn-{addr[1]}",
                             daemon=True).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        try:
            while True:
                try:
                    op, body = recv_frame(conn)
                except (ConnectionError, OSError):
                    break
                try:
                    reply = self._handle(op, body)
                    status = _ST_OK
                except Exception as exc:  # the protocol keeps flowing
                    status, reply = _ST_ERROR, repr(exc).encode()
                try:
                    send_frame(conn, status, reply)
                except (ConnectionError, OSError):
                    break
        finally:
            conn.close()

    def _handle(self, op: int, body: bytes) -> bytes:
        eng = self.engine
        if op == Q_EXISTS:
            (n,) = struct.unpack_from("<I", body)
            keys = np.frombuffer(body, dtype="<u4", count=n, offset=4)
            return np.packbits(eng.bf_exists(keys),
                               bitorder="little").tobytes()
        if op == Q_PFCOUNT:
            (n,) = struct.unpack_from("<I", body)
            days = np.frombuffer(body, dtype="<i8", count=n, offset=4)
            return eng.pfcount(days).astype("<u8").tobytes()
        if op == Q_OCCUPANCY:
            table = eng.occupancy()
            return _table([(d, table[d]) for d in sorted(table)], "<qQ")
        if op == Q_RATE:
            (roster,) = struct.unpack_from("<Q", body)
            table = eng.attendance_rate(roster)
            return _table([(d, table[d]) for d in sorted(table)], "<qd")
        if op == Q_WINDOW:
            day, p_lo, p_hi = struct.unpack_from("<qqq", body)
            return struct.pack("<Q", eng.window_pfcount(
                None if day < 0 else day, None if p_lo < 0 else p_lo,
                None if p_hi < 0 else p_hi))
        if op == Q_WOCC:
            table = eng.window_occupancy()
            return _table([(d, p, table[(d, p)]) for d, p in sorted(table)],
                          "<qqQ")
        if op == Q_RATESERIES:
            day, roster = struct.unpack_from("<qQ", body)
            series = eng.rate_series(None if day < 0 else day, roster)
            return _table([(p, series[p]) for p in sorted(series)], "<qd")
        if op == Q_STATS:
            return json.dumps(eng.stats()).encode()
        raise ValueError(f"unknown query opcode {op}")


class QueryClient:
    """Batched query client on the transport's retry seam.

    ``batch_max`` chunks a long key or day vector client-side so every
    request fits the server's ``--query-batch-max``; answers come back
    in order. One connection a client (a reader wanting parallelism
    opens more clients)."""

    def __init__(self, address: str, *, chaos=None,
                 batch_max: int = DEFAULT_BATCH):
        from attendance_tpu_torch.transport.socket_broker import _Rpc

        self._rpc = _Rpc(address, chaos=chaos, site="serve.query")
        self._policy = RetryPolicy()
        self.batch_max = max(1, batch_max)
        self._closed = False

    def _call(self, op: int, body: bytes) -> bytes:
        status, reply = resilient_call(
            self._rpc, lambda: (op, body), site="serve.query",
            policy=self._policy, aborted=lambda: self._closed)
        if status != _ST_OK:
            raise RuntimeError(
                f"query error: {reply.decode(errors='replace')}")
        return reply

    def _batched(self, op: int, values: np.ndarray, out: np.ndarray,
                 decode) -> np.ndarray:
        for i in range(0, len(values), self.batch_max):
            chunk = values[i:i + self.batch_max]
            body = struct.pack("<I", len(chunk)) + chunk.tobytes()
            out[i:i + len(chunk)] = decode(self._call(op, body), len(chunk))
        return out

    def bf_exists(self, keys) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype="<u4")
        return self._batched(
            Q_EXISTS, keys, np.empty(len(keys), dtype=bool),
            lambda reply, n: np.unpackbits(np.frombuffer(reply, np.uint8),
                                           bitorder="little")[:n])

    def pfcount(self, days) -> np.ndarray:
        days = np.ascontiguousarray(days, dtype="<i8")
        return self._batched(
            Q_PFCOUNT, days, np.empty(len(days), dtype=np.int64),
            lambda reply, n: np.frombuffer(reply, dtype="<u8"))

    def occupancy(self) -> dict:
        return dict(_untable(self._call(Q_OCCUPANCY, b""), "<qQ"))

    def attendance_rate(self, roster_size: int = 0) -> dict:
        return dict(_untable(
            self._call(Q_RATE, struct.pack("<Q", roster_size)), "<qd"))

    def window_pfcount(self, day=None, period_lo=None,
                       period_hi=None) -> int:
        body = struct.pack("<qqq", -1 if day is None else int(day),
                           -1 if period_lo is None else int(period_lo),
                           -1 if period_hi is None else int(period_hi))
        (est,) = struct.unpack("<Q", self._call(Q_WINDOW, body))
        return int(est)

    def window_occupancy(self) -> dict:
        return {(d, p): est for d, p, est
                in _untable(self._call(Q_WOCC, b""), "<qqQ")}

    def rate_series(self, day=None, roster_size: int = 0) -> dict:
        body = struct.pack("<qQ", -1 if day is None else int(day),
                           int(roster_size))
        return dict(_untable(self._call(Q_RATESERIES, body), "<qd"))

    def stats(self) -> dict:
        return json.loads(self._call(Q_STATS, b""))

    def close(self) -> None:
        self._closed = True
        self._rpc.close()
