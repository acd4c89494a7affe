"""Fleet observability plane: cross-process telemetry collection.

Counterpart of ``attendance_tpu/obs/fleet.py``, with the same push frame
byte for byte: a JAX pusher feeds the port's collector and the port's
pusher feeds JAX's, and the collector writes the same artifacts.

* :class:`FleetPusher`: every process role (worker, aggregator, serve
  reader, processor) pushes its registry snapshot and bounded span
  batches as length-prefixed frames over the :mod:`transport.framing`
  wire, through ``resilient_call``'s retry, reconnect and chaos seams at
  the ``fleet.push`` site. A dead collector never hurts the pushing
  process: pushing is telemetry, not durability.
* :class:`FleetCollector`: accepts pushes, keeps a role- and
  instance-labelled merged registry re-exposed on the metrics endpoint
  under ``/fleet/*`` (``/fleet/metrics`` merged exposition,
  ``/fleet/status`` JSON summary, ``/fleet/trace`` stitched trace), and
  stitches every process's span batches into one Perfetto-loadable
  export (trace and span ids are process-global 64-bit randoms and the
  federation gossip carries ``traceparent``, so an aggregator's
  ``fed_merge`` span parents under the worker's ``fence_publish``).
* Artifacts: with a directory, the collector appends each instance's
  exposition blocks to ``<role>@<instance>.prom`` (the FileReporter block
  format) and writes ``fleet_trace.json`` and ``FLEET.json`` (the status
  snapshot), the inputs of ``doctor --fleet``.

Wire: one opcode (``F_PUSH = 1``), body = ``enc_checksummed(enc_props(
header) + payload)``; the header names ``role``, ``instance``, ``kind``
(``metrics`` | ``spans``), ``seq``, ``boot`` (the pusher's construction
time: with ``seq`` it makes pushes idempotent, since ``resilient_call``
may re-send a frame whose reply was lost) and ``ts``. ``metrics``
payloads are the rendered exposition; ``spans`` payloads are a JSON
array of rows ``[name, role, tid, thread, ts_us, dur_us, trace_id,
span_id, parent_id|null, args|null]`` with ``ts``/``dur`` in unix-epoch
microseconds.

On a pipeline with no published read epoch, each push's render reads the
accuracy gauges from the card: K4 and K1 launch from the
``fleet-pusher`` thread on the default stream.

Departure from JAX: its ``push_now`` takes any exception as "collector
down?". The port's takes only a transport failure (``OSError``, which
``BrokerUnavailable`` is) and the collector's reject (:class:`PushRejected`)
as a failed push; a failure of the local render or of the span rows
leaves ``push_now``, and the pusher's thread logs it as what it is.
"""

from __future__ import annotations

import json
import logging
import math
import os
import socket
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from attendance_tpu_torch.transport.framing import (
    dec_props, enc_props, recv_frame, send_frame)

logger = logging.getLogger(__name__)

F_PUSH = 1

_ST_OK = 0
_ST_ERROR = 2

# Bound on spans per periodic push frame (a push is a telemetry
# heartbeat, not a bulk transfer), the larger frame the stop()-time full
# drain uses, and the spans kept per instance at the collector.
SPAN_BATCH = 512
DRAIN_BATCH = 4096
COLLECTOR_SPAN_LIMIT = 1 << 16

FLEET_ROUTES = ("/fleet/metrics", "/fleet/status", "/fleet/trace")

TRACE_FILE = "fleet_trace.json"
STATUS_FILE = "FLEET.json"


class PushRejected(RuntimeError):
    """The collector answered a push with its error status."""


def default_instance(config=None) -> str:
    """Instance label: the federated worker id when one is configured,
    else the pid."""
    fed = getattr(config, "fed_worker", "") if config is not None else ""
    return fed or f"pid{os.getpid()}"


def _span_rows(spans, epoch: float) -> list:
    """Completed Spans -> compact wire rows, ts/dur wall-anchored."""
    return [[s.name, s.role, s.tid, s.thread_name,
             round((epoch + s.t0) * 1e6, 3),
             round(s.dur * 1e6, 3),
             s.trace_id, s.span_id, s.parent_id, s.args]
            for s in spans]


def _row_args(row: list) -> dict:
    """One wire row -> the Perfetto ``args`` dict (the shape
    Tracer.export writes: hex ids + the span's own args)."""
    args = {"trace_id": f"{row[6]:016x}", "span_id": f"{row[7]:016x}"}
    if row[8] is not None:
        args["parent_span_id"] = f"{row[8]:016x}"
    if row[9]:
        args.update(row[9])
    return args


# ---------------------------------------------------------------------------
# Push side
# ---------------------------------------------------------------------------

class FleetPusher:
    """Background thread (``fleet-pusher``) pushing one process's
    telemetry to the collector: a rendered registry snapshot every
    interval plus the spans completed since the last push (bounded per
    frame).

    Takes the registry and tracer handles directly, not the telemetry
    bundle, so tests run several pushers with independent registries in
    one process."""

    def __init__(self, registry, tracer, address: str, *, role: str,
                 instance: str, interval_s: float = 2.0,
                 policy=None, span_batch: int = SPAN_BATCH):
        from attendance_tpu_torch import chaos
        # The exposition import here, not inside the first push: a pusher
        # starts before the hot loop and must never hiccup it.
        from attendance_tpu_torch.obs.exposition import render
        from attendance_tpu_torch.transport.resilience import RetryPolicy
        from attendance_tpu_torch.transport.socket_broker import _Rpc

        self._render = render
        self.registry = registry
        self.tracer = tracer
        self.address = address
        self.role = role
        self.instance = instance
        self.interval_s = interval_s
        self.span_batch = span_batch
        # Short budget: a push that cannot land within a couple of
        # seconds yields to the next interval.
        self._policy = policy or RetryPolicy(budget_s=2.0)
        self._rpc = None
        self._rpc_factory = lambda: _Rpc(address, chaos=chaos.get(),
                                         site="fleet.push")
        self._seq = 0
        self._boot = round(time.time(), 3)
        self._span_cursor = 0
        self._down_logged = False
        self._stop = threading.Event()
        self._push_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FleetPusher":
        self._thread = threading.Thread(
            target=self._loop, name="fleet-pusher", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.push_now()
            except Exception:
                logger.exception("fleet push failed before the wire "
                                 "(local snapshot)")

    def _call(self, header: dict, payload: bytes) -> None:
        from attendance_tpu_torch.transport.framing import enc_checksummed
        from attendance_tpu_torch.transport.resilience import resilient_call

        if self._rpc is None:
            self._rpc = self._rpc_factory()
        # Checksummed push frame: the collector verifies the digest
        # before folding; a rotted push is rejected and the retry
        # re-sends fresh bytes, idempotent per (boot, seq).
        body = enc_checksummed(enc_props(header) + payload)
        status, reply = resilient_call(
            self._rpc, lambda: (F_PUSH, body), site="fleet.push",
            policy=self._policy, aborted=self._stop.is_set)
        if status != _ST_OK:
            raise PushRejected(
                f"collector rejected push: "
                f"{reply.decode(errors='replace')}")

    def _send(self, header: dict, payload: bytes) -> bool:
        """One frame to the collector; False (one warning an outage) when
        the transport failed or the collector rejected it."""
        try:
            self._call(header, payload)
        except (OSError, PushRejected) as exc:
            if self._rpc is not None:
                self._rpc.close()
            self._rpc = None
            if not self._down_logged:
                self._down_logged = True
                logger.warning(
                    "fleet push to %s failed (%r) — collector "
                    "down? pushing keeps retrying every %.1fs",
                    self.address, exc, self.interval_s)
            return False
        return True

    def push_now(self, *, drain: bool = False) -> bool:
        """One push round (metrics + fresh spans); returns whether it
        landed. Spans ship at most ONE bounded frame a round, so a big
        backlog paces out over successive intervals; ``drain=True`` (the
        stop() path) loops until empty. A collector outage logs one
        warning and the pusher keeps trying every interval."""
        with self._push_lock:
            self._seq += 1
            header = {"role": self.role, "instance": self.instance,
                      "kind": "metrics", "seq": self._seq,
                      "boot": self._boot,
                      "ts": round(time.time(), 3)}
            if not self._send(header,
                              self._render(self.registry).encode()):
                return False
            if self.tracer is not None:
                epoch = self.tracer.epoch
                limit = DRAIN_BATCH if drain else self.span_batch
                while True:
                    batch, end = self.tracer.snapshot_from(
                        self._span_cursor, limit)
                    if not batch:
                        break
                    self._seq += 1
                    rows = json.dumps(_span_rows(batch, epoch)).encode()
                    if not self._send({**header, "kind": "spans",
                                       "seq": self._seq}, rows):
                        return False
                    self._span_cursor += len(batch)
                    if not drain:
                        break  # backlog: next interval's problem
                    if self._span_cursor >= end:
                        break
            if self._down_logged:
                self._down_logged = False
                logger.info("fleet push to %s recovered", self.address)
            return True

    def stop(self) -> None:
        """Final push (short runs must still report), then teardown."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.push_now(drain=True)
        if self._rpc is not None:
            self._rpc.close()
            self._rpc = None


# ---------------------------------------------------------------------------
# Collector side
# ---------------------------------------------------------------------------

class _Instance:
    __slots__ = ("role", "instance", "prom", "spans", "last_seen",
                 "pushes", "span_count", "boot", "last_seq")

    def __init__(self, role: str, instance: str):
        self.role = role
        self.instance = instance
        self.prom = ""  # latest rendered exposition
        self.spans: List[list] = []
        self.last_seen = 0.0
        self.pushes = 0
        self.span_count = 0
        # Duplicate window: pushes are idempotent per (boot, seq).
        self.boot = None
        self.last_seq = 0

    @property
    def key(self) -> str:
        return f"{self.role}@{self.instance}"


def _safe_stem(key: str) -> str:
    return "".join(c if (c.isalnum() or c in "@._-") else "_"
                   for c in key)


class FleetCollector:
    """TCP collector for :class:`FleetPusher` frames.

    One thread per pushing connection (the broker server's model).
    State per (role, instance): the latest exposition text, a bounded
    span list, and liveness and volume counters. ``attach(server)``
    mounts the ``/fleet/*`` routes on a :class:`MetricsServer`;
    ``directory`` keeps artifacts for ``doctor --fleet``."""

    def __init__(self, *, directory: str = "", host: str = "127.0.0.1",
                 port: int = 0, obs=None,
                 flush_interval_s: float = 2.0,
                 span_limit: int = COLLECTOR_SPAN_LIMIT):
        self.directory = directory
        if directory:
            Path(directory).mkdir(parents=True, exist_ok=True)
        self.span_limit = span_limit
        self.flush_interval_s = flush_interval_s
        self._lock = threading.Lock()
        self._instances: Dict[str, _Instance] = {}
        self._no_checksum_warned: set = set()
        self._last_flush = 0.0
        self._stopping = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self.host, self.port = self._sock.getsockname()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._c_pushes = None
        if obs is not None:
            self.bind_obs(obs)

    def bind_obs(self, obs) -> None:
        """Register the collector's own metrics on a telemetry bundle
        (apart from __init__ for the `federate` verb, which makes the
        collector first, to learn its address, and the bundle second,
        pushing to it)."""
        self._c_pushes = {
            kind: obs.registry.counter(
                "attendance_fleet_pushes_total",
                help="Telemetry frames accepted by the fleet "
                "collector", kind=kind)
            for kind in ("metrics", "spans")}
        obs.registry.gauge(
            "attendance_fleet_instances",
            help="Distinct role@instance pushers the collector "
            "has heard from").set_function(
                lambda: float(len(self._instances)))

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "FleetCollector":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-collector",
            daemon=True)
        self._accept_thread.start()
        logger.info("Fleet collector listening on %s%s", self.address,
                    f" (artifacts -> {self.directory})"
                    if self.directory else "")
        return self

    def stop(self) -> None:
        self._stopping = True
        try:
            # shutdown() wakes the accept thread parked in accept().
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            # Ends each connection's thread: its receive sees EOF.
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.flush(trace=True)

    # -- wire ----------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_connection,
                             args=(conn,),
                             name=f"fleet-conn-{addr[1]}",
                             daemon=True).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.add(conn)
        try:
            while True:
                try:
                    op, body = recv_frame(conn)
                except (ConnectionError, OSError):
                    break
                try:
                    if op != F_PUSH:
                        raise ValueError(f"unknown fleet opcode {op}")
                    self._ingest(body)
                    status, reply = _ST_OK, b""
                except Exception as exc:
                    # The pusher gets the error back as its reject.
                    status, reply = _ST_ERROR, repr(exc).encode()
                try:
                    send_frame(conn, status, reply)
                except (ConnectionError, OSError):
                    break
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    def _ingest(self, body: bytes) -> None:
        from attendance_tpu_torch.transport.framing import dec_checksummed

        # FrameChecksumError propagates: the push is rejected with an
        # error status and the pusher's retry re-sends clean bytes.
        # Pushers without the checksum magic fold normally, one warning
        # per instance.
        body, verified = dec_checksummed(body)
        header, off = dec_props(body, 0)
        if not header or "role" not in header:
            raise ValueError("malformed fleet push header")
        if not verified:
            key0 = (f"{header['role']}"
                    f"@{header.get('instance', '?')}")
            if key0 not in self._no_checksum_warned:
                self._no_checksum_warned.add(key0)
                logger.warning(
                    "fleet pushes from %s carry no payload checksum "
                    "(older pusher build?) — folding normally, but "
                    "in-flight rot on its pushes is undetectable",
                    key0)
        payload = body[off:]
        kind = header.get("kind")
        key = f"{header['role']}@{header.get('instance', '?')}"
        boot, seq = header.get("boot"), header.get("seq")
        persist = None
        with self._lock:
            inst = self._instances.get(key)
            if inst is None:
                inst = self._instances[key] = _Instance(
                    header["role"], str(header.get("instance", "?")))
            if boot is not None and seq is not None:
                if inst.boot == boot and seq <= inst.last_seq:
                    # A re-sent frame whose reply was lost: already
                    # folded; the OK reply is what the pusher waits for.
                    inst.last_seen = time.time()
                    return
                if inst.boot != boot:  # restarted pusher: new window
                    inst.boot, inst.last_seq = boot, 0
                inst.last_seq = max(inst.last_seq, seq)
            inst.last_seen = time.time()
            inst.pushes += 1
            if kind == "metrics":
                inst.prom = payload.decode(errors="replace")
                persist = (inst.key, inst.prom)
            elif kind == "spans":
                rows = json.loads(payload)
                inst.spans.extend(rows)
                inst.span_count += len(rows)
                if len(inst.spans) > self.span_limit:
                    # Keep the newest: a live forensic surface, not an
                    # archive.
                    del inst.spans[:len(inst.spans) - self.span_limit]
            else:
                raise ValueError(f"unknown fleet push kind {kind!r}")
        if persist is not None:
            # File I/O outside the collector-wide lock: one slow append
            # must not stall every other pusher and the /fleet/* routes.
            self._persist_prom(*persist)
        if self._c_pushes is not None and kind in self._c_pushes:
            self._c_pushes[kind].inc()
        if (self.directory
                and time.time() - self._last_flush
                >= self.flush_interval_s):
            self.flush()

    def _persist_prom(self, key: str, prom: str) -> None:
        """Append the pushed block to the instance's prom file (the
        FileReporter block format: ``parse_prom`` and the ``telemetry``
        verb read it unchanged)."""
        if not self.directory:
            return
        path = Path(self.directory) / f"{_safe_stem(key)}.prom"
        try:
            with open(path, "a") as f:
                f.write(f"# scrape {time.time():.3f}\n" + prom)
        except OSError:
            logger.exception("fleet prom persist failed for %s", key)

    # -- merged views --------------------------------------------------------
    def merged_exposition(self) -> str:
        """One Prometheus exposition over every instance's latest
        snapshot, each sample labelled ``role=``/``instance=``, samples
        regrouped per family so the merged text stays valid exposition
        (TYPE before samples, families contiguous)."""
        with self._lock:
            blocks = [(i.role, i.instance, i.prom)
                      for i in self._instances.values()]
        families: Dict[str, dict] = {}
        for role, instance, text in sorted(blocks):
            extra = (f'role="{role}",instance="{instance}"')
            fam = None
            for line in text.splitlines():
                if line.startswith("# TYPE "):
                    _, _, name, kind = line.split(" ", 3)
                    fam = families.setdefault(
                        name, {"kind": kind, "help": "", "samples": []})
                    fam["kind"] = kind  # HELP may have pre-created it
                elif line.startswith("# HELP "):
                    _, _, name, help_text = line.split(" ", 3)
                    families.setdefault(
                        name, {"kind": "untyped", "help": "",
                               "samples": []})["help"] = help_text
                elif line and not line.startswith("#"):
                    try:
                        metric, value = line.rsplit(" ", 1)
                    except ValueError:
                        continue
                    if "{" in metric:
                        name_part, rest = metric.split("{", 1)
                        metric = f"{name_part}{{{extra},{rest}"
                    else:
                        metric = f"{metric}{{{extra}}}"
                    # render() emits samples directly under their
                    # family's TYPE line; a stray untyped sample gets
                    # its own family.
                    target = fam if fam is not None else \
                        families.setdefault(
                            metric.split("{", 1)[0],
                            {"kind": "untyped", "help": "",
                             "samples": []})
                    target["samples"].append(f"{metric} {value}")
        lines: List[str] = []
        for name in sorted(families):
            fam = families[name]
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            lines.extend(fam["samples"])
        return "\n".join(lines) + "\n"

    def export_trace(self) -> dict:
        """Every instance's span batches stitched into one Chrome-trace
        document: one synthetic pid per (role, instance), one tid per
        pushing thread, span args untouched (ids are process-global, so
        the gossip-carried ``traceparent`` nests an aggregator's
        ``fed_merge`` under the worker's ``fence_publish``)."""
        with self._lock:
            per = [(i.role, i.instance, list(i.spans))
                   for i in self._instances.values()]
        meta: List[dict] = []
        events: List[dict] = []
        pid = 0
        for role, instance, spans in sorted(per, key=lambda p: p[:2]):
            pid += 1
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0,
                         "args": {"name": f"{role}:{instance}"}})
            tid_of: Dict[tuple, int] = {}
            for row in spans:
                tkey = (row[1] or role, row[2])
                tid = tid_of.get(tkey)
                if tid is None:
                    tid = tid_of[tkey] = len(tid_of) + 1
                    events.append({
                        "name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": row[3] or ""}})
                events.append({"name": row[0], "ph": "X",
                               "pid": pid, "tid": tid,
                               "ts": row[4], "dur": row[5],
                               "args": _row_args(row)})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"stitched": True,
                              "instances": len(per),
                              "span_count": sum(len(s)
                                                for _, _, s in per)}}

    def status(self) -> dict:
        """The summary the ``fleet`` verb renders: per instance,
        liveness, volume and headline samples of its latest
        exposition."""
        now = time.time()
        with self._lock:
            per = [(i.role, i.instance, i.prom, i.last_seen, i.pushes,
                    i.span_count) for i in self._instances.values()]
        doc = {"collected_at": round(now, 3), "instances": {}}
        for role, instance, prom, last_seen, pushes, span_count in per:
            doc["instances"][f"{role}@{instance}"] = {
                "role": role, "instance": instance,
                "age_s": round(now - last_seen, 3),
                "pushes": pushes, "spans": span_count,
                **_headline(prom),
            }
        return doc

    # -- persistence ---------------------------------------------------------
    def flush(self, *, trace: bool = False) -> None:
        """Write the status snapshot (atomic rename; prom files are
        appended per push), and the stitched trace when ``trace=True``
        (once, at stop(): serializing every span is O(total spans))."""
        self._last_flush = time.time()
        if not self.directory:
            return
        root = Path(self.directory)
        docs = [(STATUS_FILE, self.status())]
        if trace:
            docs.append((TRACE_FILE, self.export_trace()))
        try:
            for name, doc in docs:
                tmp = root / (name + ".tmp")
                with open(tmp, "w") as f:
                    json.dump(doc, f)
                tmp.replace(root / name)
        except OSError:
            logger.exception("fleet artifact flush failed")

    # -- HTTP ----------------------------------------------------------------
    def attach(self, server) -> None:
        """Mount ``/fleet/*`` on a MetricsServer (the ``--metrics-port``
        endpoint: fleet-wide views beside the local ones)."""

        def metrics(method, path, query, body):
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    self.merged_exposition().encode())

        def status(method, path, query, body):
            return (200, "application/json; charset=utf-8",
                    json.dumps(self.status()).encode())

        def trace(method, path, query, body):
            return (200, "application/json; charset=utf-8",
                    json.dumps(self.export_trace()).encode())

        server.add_route("/fleet/metrics", metrics)
        server.add_route("/fleet/status", status)
        server.add_route("/fleet/trace", trace)

    def detach(self, server) -> None:
        for path in FLEET_ROUTES:
            server.remove_route(path)


def _headline(prom_text: str) -> dict:
    """A few cross-role headline numbers from one exposition snapshot
    (absent families simply do not appear), through
    ``exposition.fold_headline_samples``, which ``doctor --fleet``'s
    fleet-wide rows also use."""
    from attendance_tpu_torch.obs.exposition import (
        fold_headline_samples, parse_prom, quantiles_from_cumulative,
        rank_profile_stages)

    out: dict = {}
    if not prom_text:
        return out
    acc = fold_headline_samples(parse_prom(prom_text))
    if acc["have_events"]:
        out["events"] = int(acc["events"])
    out["slo_firing"] = acc["firing"]
    if acc["staleness"]:
        out["read_staleness_s"] = round(max(acc["staleness"]), 3)
    if acc["series"] is not None:
        out["series"] = acc["series"]
    if acc.get("incidents") is not None:
        out["incidents"] = acc["incidents"]
    if acc["prof_stages"]:
        # The role's busiest profiled stage.
        stage, frac = rank_profile_stages(acc["prof_stages"], 1)[0]
        out["top_stage"] = f"{stage} {frac:.0%}"
    pairs = sorted(acc["lag_by_le"].items())
    if pairs and max(c for _, c in pairs) > 0:
        (p99,) = quantiles_from_cumulative(pairs, (0.99,))
        out["merge_lag_p99_s"] = (round(p99, 4)
                                  if math.isfinite(p99) else p99)
    return out
