"""The port's JSON query routes (``serve/http.py``) against the JAX
package's (``tests/test_serve.py``'s HTTP routes): the same epoch behind
both packages' routes answers the same JSON bodies, on a live fused
pipeline that serves and on the ``serve`` verb over a snapshot chain,
whose staleness gauges report, as the federation aggregator's do; every
telemetry verb takes ``--audit-sample``. Tolerance 0, apart from the
stats route's clock fields. Every test leaves both packages' process-global telemetry
disabled, and every wait on a server or thread has a deadline.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.models.bloom import BloomParams as JaxParams
from attendance_tpu.obs.exposition import MetricsServer as JaxServer
from attendance_tpu.obs.registry import Registry as JaxRegistry
from attendance_tpu.serve import chain as jchain
from attendance_tpu.serve import engine as jengine
from attendance_tpu.serve import http as jhttp
from attendance_tpu.serve import mirror as jmirror
from attendance_tpu_torch import obs
from attendance_tpu_torch.cli import main as port_main
from attendance_tpu_torch.obs.exposition import parse_prom
from attendance_tpu_torch.serve import http
from test_torch_serve import _run_port
from torch_port_fixtures import fresh_shared_broker  # noqa: F401

_CLOCK = ("published_at", "age_s", "epoch", "source")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _get(base, path, data=None):
    req = urllib.request.Request(f"{base}{path}", data=data,
                                 method="POST" if data is not None
                                 else "GET")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.headers["Content-Type"].startswith("application/json")
        return json.loads(r.read())


def _bodies(base, roster, days):
    """Every route's JSON body for the same requests (stats without its
    clock fields)."""
    wocc = _get(base, "/query/window_occupancy")
    first = sorted(wocc)[0].split(":")[0] if wocc else str(days[0])
    keys = ",".join(str(int(k)) for k in list(roster[:50]) + [1 << 31, 7])
    out = {
        "occupancy": _get(base, "/query/occupancy"),
        "rate": _get(base, "/query/rate"),
        "rate_given": _get(base, "/query/rate?roster=1000"),
        "exists": _get(base, f"/query/exists?keys={keys}"),
        "pfcount": _get(base, "/query/pfcount?days="
                        + ",".join([f"LECTURE_{days[0]}"]
                                   + [str(d) for d in days[1:]] + ["123"])),
        "window": _get(base, "/query/window"),
        "window_day": _get(base, f"/query/window?day={first}&from=0&to=5"),
        "window_occupancy": wocc,
        "rate_series": _get(base, f"/query/rate_series?day={first}"
                            "&roster=500"),
        "stats": {k: v for k, v in _get(base, "/query/stats").items()
                  if k not in _CLOCK},
    }
    for verb, doc in (("pfcount", {"days": [int(days[0]), "123"]}),
                      ("exists", {"keys": [int(roster[0]), 1 << 31]}),
                      ("occupancy", {}), ("window_occupancy", {}),
                      ("rate", {"roster_size": 100}),
                      ("window_pfcount", {"day": first}),
                      ("rate_series", {"day": first})):
        out[f"post_{verb}"] = _get(base, "/query", json.dumps(
            dict(doc, verb=verb)).encode())
    return out


def _jax_routes_on(epoch):
    """JAX's routes over a JAX engine on the same epoch, on a JAX metrics
    server of its own: (base URL, server)."""
    mirror = jmirror.ReadMirror()
    mirror.publish(regs=epoch.hll_regs, events=epoch.events,
                   bank_of=epoch.bank_of, params=JaxParams(*epoch.params),
                   precision=epoch.precision, bloom_words=epoch.bloom_words,
                   counts=epoch.counts, roster_size=epoch.roster_size)
    server = JaxServer(JaxRegistry(), 0).start()
    jhttp.attach(server, jengine.QueryEngine(mirror))
    return f"http://127.0.0.1:{server.port}", server


def test_http_query_routes_equal_jax(tmp_path):
    """A fused pipeline that serves with a metrics port mounts the
    routes: each answers what the engine and the pipeline answer, the
    same JSON as JAX's routes over the same epoch; the scrape surface
    still works beside them; cleanup unmounts them."""
    pipe, roster = _run_port(seed=11, temporal=True,
                             snap_dir=tmp_path / "s", serve_port=-1,
                             metrics_port=-1)
    t = obs.get()
    base = f"http://127.0.0.1:{t.http_port}"
    try:
        days = pipe.lecture_days()
        ours = _bodies(base, roster, days)
        assert {int(k): v for k, v in ours["occupancy"].items()} == (
            pipe.query_engine.occupancy())
        assert ours["exists"][:50] == [True] * 50
        assert ours["pfcount"] == [pipe.count(d) for d in days] + [0]
        assert ours["post_pfcount"]["result"] == [pipe.count(days[0]), 0]
        assert ours["window_occupancy"]
        jbase, jserver = _jax_routes_on(pipe.read_mirror.pin())
        try:
            assert ours == _bodies(jbase, roster, days)
        finally:
            jserver.stop()
        body = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=10).read().decode()
        assert "attendance_read_staleness_seconds" in body
        assert "attendance_query_requests_total" in body
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/query", timeout=10)
        assert err.value.code == 405
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base, "/query", json.dumps({"verb": "nope"}).encode())
        assert err.value.code == 500
    finally:
        pipe.cleanup()
    assert not set(http.QUERY_ROUTES) & set(t._server.routes)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{base}/query/occupancy", timeout=10)
    assert err.value.code == 404


def test_serve_verb_routes_and_staleness_equal_jax(tmp_path):
    """The ``serve`` verb over a chain with ``--metrics-port -1`` mounts
    the routes beside its scrape surface: the same JSON as JAX's routes
    over a JAX chain reader of the same directory; its staleness and
    epoch gauges are finite and equal to its reader's epoch."""
    snap = tmp_path / "s"
    pipe, roster = _run_port(seed=23, temporal=True, snap_dir=snap)
    days = pipe.lecture_days()
    pipe.cleanup()
    done = threading.Event()

    def serve():
        try:
            port_main(["serve", "--snapshot-dir", str(snap),
                       "--serve-port", "-1", "--metrics-port", "-1",
                       "--serve-seconds", "4"])
        finally:
            done.set()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    deadline = time.monotonic() + 30
    while True:
        t = obs.get()
        if (t is not None and t._server is not None
                and "/query/stats" in t._server.routes):
            break
        assert time.monotonic() < deadline and not done.is_set()
        time.sleep(0.01)
    base = f"http://127.0.0.1:{t.http_port}"
    ours = _bodies(base, roster, days)
    text = urllib.request.urlopen(f"{base}/metrics",
                                  timeout=10).read().decode()
    jt = jobs.enable(None)
    source = jchain.ChainEpochSource(snap, obs=jt)
    server = JaxServer(JaxRegistry(), 0).start()
    try:
        jhttp.attach(server, jengine.QueryEngine(source))
        assert ours == _bodies(f"http://127.0.0.1:{server.port}", roster,
                               days)
    finally:
        server.stop()
    samples = {n: float(v) for n, _, v in parse_prom(text)}
    assert np.isfinite(samples["attendance_read_staleness_seconds"])
    assert samples["attendance_read_staleness_seconds"] >= 0.0
    jsamples = {n: float(v) for n, _, v in parse_prom(jt.render())}
    assert samples["attendance_read_epoch_seq"] == (
        jsamples["attendance_read_epoch_seq"]) == 1.0
    assert np.isfinite(jsamples["attendance_read_staleness_seconds"])
    assert ours["stats"]["events"] == source.pin().events
    assert done.wait(timeout=30)
    thread.join(timeout=30)


def test_aggregator_exports_the_staleness_gauges_equal_jax():
    """The federation's aggregator registers its mirror's staleness and
    epoch gauges, as JAX's does: NaN and 0 before a publish; after the
    same full frame folded and published, the same sequence and a finite
    age in both packages."""
    from attendance_tpu.federation import frames as jframes
    from attendance_tpu.federation.gossip import Aggregator as JaxAgg
    from attendance_tpu.transport import memory_broker as jbroker
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.federation import frames
    from attendance_tpu_torch.federation.gossip import Aggregator
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)
    from test_torch_federation import _frame_kwargs

    payload = frames.encode_frame(**_frame_kwargs(
        "full", np.random.default_rng(21)))
    got = []
    for pkg in ("jax", "port"):
        port = pkg == "port"
        t = (obs if port else jobs).enable(
            Config(metrics_port=-1) if port else None)
        agg = (Aggregator(client=MemoryClient(MemoryBroker()), topic="st",
                          num_shards=3, dead_after_s=1e9, obs=t)
               if port else
               JaxAgg(client=jbroker.MemoryClient(jbroker.MemoryBroker()),
                      topic="st", num_shards=3, dead_after_s=1e9, obs=t))
        try:
            before = {n: float(v) for n, _, v in parse_prom(t.render())}
            assert np.isnan(before["attendance_read_staleness_seconds"])
            assert before["attendance_read_epoch_seq"] == 0.0
            agg.fold_frame((frames if port else jframes).decode_frame(
                payload), now=2e9)
            agg.publish_epoch()
            after = {n: float(v) for n, _, v in parse_prom(t.render())}
            stale = after["attendance_read_staleness_seconds"]
            assert np.isfinite(stale)
            got.append(after["attendance_read_epoch_seq"])
        finally:
            agg.stop()
            (obs if port else jobs).disable()
    assert got[0] == got[1] == 1.0


@pytest.mark.parametrize("verb", ["fused", "process", "pipeline", "bridge",
                                  "serve", "federate"])
def test_audit_sample_flag_on_every_telemetry_verb(verb):
    """``--audit-sample`` sits with the other telemetry flags on each verb
    that has them, with JAX's default, and reaches the verb's config."""
    from attendance_tpu.config import Config as JaxConfig
    from attendance_tpu_torch.cli import _telemetry_config, build_parser

    args = build_parser().parse_args([verb, "--audit-sample", "0.25"])
    assert _telemetry_config(args)["audit_sample"] == 0.25
    args = build_parser().parse_args([verb])
    assert args.audit_sample == JaxConfig().audit_sample == 0.0
