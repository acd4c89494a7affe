"""The port's accuracy auditor (``obs/audit.py``, ``serve/audit.py``)
against the JAX package's (the audit half of ``tests/test_audit_slo.py``
and ``tests/test_serve.py``'s read audit).

The same seeded keys, stores and frames go through both packages: the
sample masks, the store path's counters and gauges (memory, card store
on the CPU, redis-sim), the fused pipeline's scrape-time gauges and the
read path's are equal at tolerance 0 (integers and ratios of integers),
and each is held against an exact recount made without the auditor.
Every test leaves both packages' process-global telemetry disabled.
"""

import re

import numpy as np
import pytest

from attendance_tpu import obs as jobs
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.obs import audit as jaudit
from attendance_tpu.obs.registry import Registry as JaxRegistry
from attendance_tpu.sketch import make_sketch_store as jax_store
from attendance_tpu_torch import obs
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.obs import audit
from attendance_tpu_torch.obs.audit import ShadowAuditor
from attendance_tpu_torch.obs.exposition import parse_prom
from attendance_tpu_torch.obs.health import HEALTH_HELP
from attendance_tpu_torch.obs.registry import Registry
from attendance_tpu_torch.serve.audit import QUERY_AUDIT_HELP
from attendance_tpu_torch.sketch import make_sketch_store
from torch_port_fixtures import fresh_shared_broker  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Telemetry is process-global in both packages: bare in, bare out."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _samples(text):
    return {(n, l): float(v) for n, l, v in parse_prom(text)}


def _same(a: float, b: float) -> bool:
    return a == b or (np.isnan(a) and np.isnan(b))


# -- sampling ----------------------------------------------------------------

@pytest.mark.parametrize("sample", [0.01, 0.1, 1.0])
def test_sample_mask_is_a_hash_partition_equal_to_jax(sample):
    """Sequential keys (the reference's roster shape) sample at about
    the requested fraction, the mask is a pure function of the key, and
    it is JAX's mask bit for bit."""
    aud = ShadowAuditor(Registry(), sample)
    keys = np.concatenate([np.arange(100_000, dtype=np.uint32),
                           np.random.default_rng(0).integers(
                               0, 1 << 32, 100_000).astype(np.uint32)])
    mask = aud.sample_mask(keys)
    assert abs(mask.mean() - sample) < max(0.2 * sample, 0.002)
    np.testing.assert_array_equal(mask, aud.sample_mask(keys))
    jmask = jaudit.ShadowAuditor(JaxRegistry(), sample).sample_mask(keys)
    np.testing.assert_array_equal(mask, jmask)
    with pytest.raises(ValueError):
        ShadowAuditor(Registry(), 0.0)


# -- store-path auditing -----------------------------------------------------

def _audited_store(pkg, backend: str, sample: float, **kw):
    cfg_cls, enable, make = ((Config, obs.enable, make_sketch_store)
                             if pkg == "port" else
                             (JaxConfig, jobs.enable, jax_store))
    cfg = cfg_cls(sketch_backend=backend, audit_sample=sample,
                  bloom_filter_capacity=2_000, **kw)
    t = enable(cfg)
    store = (make(cfg, device="cpu") if pkg == "port" else make(cfg))
    return t, cfg, store


def _store_counters(t):
    aud = t.auditor
    return dict(checks=aud._checks.value, fp=aud._fp.value,
                fn=aud._fn.value, negatives=aud._negatives.value,
                overflow=aud._overflow.value,
                members=aud._shadow_size(), fpr=aud.measured_fpr())


@pytest.mark.parametrize("backend", ["memory", "tpu", "redis-sim"])
def test_measured_fpr_agrees_with_exact_offline_recount(backend):
    """The measured FPR equals an independent recount over the sampled
    keys (negatives by true roster membership, false positives by the
    store's own answers), and every counter equals JAX's on the same
    commands."""
    roster = np.arange(1_000, dtype=np.int64)
    queries = np.arange(500, 3_000, dtype=np.int64)
    got = {}
    for pkg in ("jax", "port"):
        t, cfg, store = _audited_store(pkg, backend, 0.25)
        store.bf_add_many(cfg.bloom_filter_key, roster)
        answers = np.asarray(
            store.bf_exists_many(cfg.bloom_filter_key, queries))
        mask = t.auditor.sample_mask(queries.astype(np.uint32))
        in_roster = queries < 1_000  # exact membership, by construction
        negatives = int((mask & ~in_roster).sum())
        fps = int((mask & ~in_roster & answers).sum())
        assert negatives > 0
        assert t.auditor._negatives.value == negatives
        assert t.auditor._fp.value == fps
        assert t.auditor.measured_fpr() == fps / negatives
        # An added key can never answer absent.
        assert t.auditor._fn.value == 0
        got[pkg] = _store_counters(t), answers
        text = t.render()
        assert "attendance_bloom_false_negatives_total 0" in text
        (obs if pkg == "port" else jobs).disable()
    assert got["port"][0] == got["jax"][0]
    np.testing.assert_array_equal(got["port"][1], got["jax"][1])


@pytest.mark.parametrize("backend", ["memory", "tpu"])
def test_hll_measured_rel_error_agrees_with_exact_recount(backend):
    """At sample=1.0 the shadow is the whole truth: the gauge equals
    |PFCOUNT - exact| / exact, and JAX's gauge, on every path that
    counts (pfcount, pfcount_many, the union)."""
    members = np.arange(5_000, dtype=np.int64)
    got = {}
    for pkg in ("jax", "port"):
        t, cfg, store = _audited_store(pkg, backend, 1.0)
        key = f"{cfg.hll_key_prefix}LECTURE_1"
        other = f"{cfg.hll_key_prefix}LECTURE_2"
        store.pfadd_many(key, members)
        store.pfadd_many(key, members[:1_000])  # duplicates change nothing
        store.pfadd(other, *range(4_000, 7_000))
        est = store.pfcount(key)
        g = t.registry.gauge("attendance_hll_measured_rel_error", key=key)
        assert g.value == abs(est - 5_000) / 5_000
        assert g.value < 0.02  # the accuracy target holds on this run
        many = store.pfcount_many([key, other, "hll:unknown"])
        union = store.pfcount(key, other)
        gu = t.registry.gauge("attendance_hll_measured_rel_error",
                              key="union:2")
        assert gu.value == abs(union - 7_000) / 7_000
        got[pkg] = (_samples(t.render()), est, many, union)
        (obs if pkg == "port" else jobs).disable()
    assert got["port"][1:] == got["jax"][1:]
    names = set(audit.AUDIT_HELP)
    jax_s = {k: v for k, v in got["jax"][0].items() if k[0] in names}
    port_s = {k: v for k, v in got["port"][0].items() if k[0] in names}
    assert jax_s.keys() == port_s.keys()
    for k in jax_s:
        assert _same(port_s[k], jax_s[k]), k


def test_false_negative_is_detected_and_screamed(caplog):
    """A lying sketch (absent for added keys) increments the
    must-stay-zero counter and logs an error."""
    aud = ShadowAuditor(Registry(), 1.0)
    keys = np.arange(100, dtype=np.uint32)
    aud.record_bf_add("bf", keys)
    aud.check_bf_exists("bf", keys, np.zeros(100, dtype=bool))
    assert aud._fn.value == 100
    assert "FALSE NEGATIVE" in caplog.text


def test_unaudited_runs_pay_nothing():
    """audit_sample=0 leaves no auditor anywhere: stores hold None and
    pay one branch per command; the query engine has no read auditor."""
    from attendance_tpu_torch.serve.engine import QueryEngine
    from attendance_tpu_torch.serve.mirror import ReadMirror

    store = make_sketch_store(Config(sketch_backend="memory"))
    assert store._auditor is None
    assert obs.get() is None
    t = obs.enable(Config(metrics_port=-1))
    assert t.auditor is None
    assert QueryEngine(ReadMirror(), obs=t)._auditor is None


def test_redis_sim_answers_are_audited_too():
    """The simulated-Redis backend reimplements the command surface
    wholesale; its overrides sit under the audited chokepoints, so the
    audit still sees every answer."""
    cfg = Config(sketch_backend="redis-sim", audit_sample=1.0)
    t = obs.enable(cfg)
    store = make_sketch_store(cfg)
    store.bf_add_many("bf:students", np.arange(500, dtype=np.int64))
    store.bf_exists_many("bf:students", np.arange(1_000, dtype=np.int64))
    assert t.auditor._negatives.value == 500
    assert t.auditor._fn.value == 0


def test_roster_shadow_overflow_disables_fused_audit(monkeypatch):
    """A roster past the shadow cap STOPS the fused measurement (empty
    probe sets, no day truth, no read classification), never classifies
    traffic against the vanished ground truth."""
    monkeypatch.setattr(audit, "SHADOW_CAP", 100)
    aud = ShadowAuditor(Registry(), 1.0)
    aud.record_roster(np.arange(1_000, dtype=np.uint32))
    assert aud._overflow.value == 1
    aud.observe_fused_frame(np.arange(500, dtype=np.uint32),
                            np.zeros(500, dtype=np.int64))
    roster, negatives = aud.fused_probe_sets()
    assert len(roster) == 0 and len(negatives) == 0
    assert aud.fused_day_truth() == {}
    assert aud.roster_membership(np.arange(10, dtype=np.uint32)) == (
        None, None)


def test_traffic_reservoir_freezes_at_cap(monkeypatch):
    """The traffic probe population freezes at the cap (one overflow
    count, no per-frame eviction) and keeps measuring over the frozen
    set, as JAX's does."""
    monkeypatch.setattr(audit, "SHADOW_CAP", 200)
    monkeypatch.setattr(jaudit, "SHADOW_CAP", 200)
    sets = []
    for cls, reg in ((ShadowAuditor, Registry),
                     (jaudit.ShadowAuditor, JaxRegistry)):
        aud = cls(reg(), 1.0)
        aud.record_roster(np.arange(50, dtype=np.uint32))
        for lo in (0, 300, 600):
            aud.observe_fused_frame(np.arange(lo, lo + 300, dtype=np.uint32),
                                    np.zeros(300, dtype=np.int64))
        assert aud._overflow.value == 1  # once, not per frame
        roster, negatives = aud.fused_probe_sets()
        assert len(roster) == 50
        assert 0 < len(negatives) <= 300
        sets.append((sorted(roster.tolist()), sorted(negatives.tolist()),
                     aud.fused_day_truth()))
    assert sets[0] == sets[1]


# -- fused-path auditing -----------------------------------------------------

_FUSED_KW = dict(bloom_filter_capacity=5_000)


def _fused_pair(monkeypatch, sample: float, **extra):
    """The same seeded frames through both packages' fused pipelines
    with the audit on: (jax text, jax pipe, port text, port pipe), the
    pipelines cleaned up, their state kept."""
    from test_torch_obs import _jax_fused, _port_fused

    monkeypatch.setenv("ATP_NATIVE", "0")
    kw = dict(_FUSED_KW, audit_sample=sample, **extra)
    jt = jobs.enable(JaxConfig(**kw))
    jpipe = _jax_fused(JaxConfig(transport_backend="memory", **kw))
    jpipe.run(max_events=4_096, idle_timeout_s=0.3)
    jtext = jt.render()
    jpipe.cleanup()
    jobs.disable()
    pt = obs.enable(Config(**kw))
    pipe = _port_fused(Config(**kw))
    pipe.run(max_events=4_096, idle_timeout_s=0.3)
    ptext = pt.render()
    return jtext, jpipe, ptext, pipe, pt


def test_fused_audit_gauges_agree_with_exact_recount(monkeypatch):
    """Sample 1.0: the HLL error equals |sum(count_all) - exact| / exact
    over the stored traffic recounted against the roster, the measured
    FPR equals a re-query of the observed outsiders, no roster key reads
    absent, and every audit and health value equals JAX's."""
    from attendance_tpu_torch.models.bloom import bloom_contains_words_np

    jtext, jpipe, ptext, pipe, t = _fused_pair(monkeypatch, 1.0)
    try:
        cols = pipe.store.to_columns(deduplicate=False)
        sids = np.asarray(cols["student_id"], dtype=np.uint32)
        days = np.asarray(cols["lecture_day"])
        roster = t.auditor.fused_probe_sets()[0]
        roster_set = set(roster.tolist())
        valid = np.fromiter((int(s) in roster_set for s in sids),
                            dtype=bool, count=len(sids))
        exact = {}
        for d, s in zip(days[valid], sids[valid]):
            exact.setdefault(int(d), set()).add(int(s))
        truth_total = sum(len(v) for v in exact.values())
        est_total = sum(pipe.count_all().values())
        assert t.auditor.fused_day_truth() == {
            d: float(len(v)) for d, v in exact.items()}
        ps = _samples(ptext)
        assert ps[("attendance_hll_measured_rel_error", 'key="fused"')] == (
            abs(est_total - truth_total) / truth_total)
        negatives = np.fromiter(set(sids.tolist()) - roster_set, np.uint32)
        answers = bloom_contains_words_np(
            pipe.state.bloom_bits.numpy().view(np.uint32), negatives,
            pipe.params)
        assert ps[("attendance_bloom_measured_fpr", 'surface="fused"')] == (
            answers.sum() / len(negatives))
        assert ps[("attendance_bloom_false_negatives_total", "")] == 0
        assert ps[("attendance_hll_estimate", "")] == est_total
        js = _samples(jtext)
        names = set(audit.AUDIT_HELP) | set(HEALTH_HELP)
        live_fill = {"attendance_bloom_fill_fraction",
                     "attendance_bloom_estimated_fpr"}
        for key, v in js.items():
            if key[0] in names and key[0] not in live_fill:
                assert _same(ps[key], v), key
    finally:
        pipe.cleanup()


def test_audited_fused_exposition_equals_jax_line_for_line(monkeypatch):
    """A seeded audited run that serves (so both packages' gauges read
    the published epoch): every line of the health, audit, read-audit
    and epoch-sequence families is the same text in both packages, and
    the series sets differ only by the documented ones."""
    jtext, _, ptext, pipe, _ = _fused_pair(monkeypatch, 0.25, serve_port=-1)
    try:
        assert pipe.read_mirror.pin().bloom_words is not None
    finally:
        pipe.cleanup()
    families = (set(audit.AUDIT_HELP) | set(HEALTH_HELP)
                | {"attendance_read_epoch_seq"})

    def lines(text):
        out = []
        for line in text.splitlines():
            m = re.match(r"(?:# (?:HELP|TYPE) )?([a-z_]+)", line)
            if m and m.group(1) in families:
                out.append(line)
        return out

    assert lines(ptext) == lines(jtext)
    # HELP, TYPE and at least one sample of each family.
    assert len(lines(ptext)) >= 3 * len(families)
    js, ps = _samples(jtext), _samples(ptext)
    # Every JAX series is the port's too: the launch-shape tracker emits
    # the recompile tracker's series, with JAX's counts.
    assert {n for n, _ in js} - {n for n, _ in ps} == set()
    for key in js:
        if key[0].startswith("attendance_recompiles"):
            assert ps[key] == js[key], key
    # The port's own: each frame's wire bytes, and the preload's read of
    # the filter and registers for the first epoch (JAX reads them
    # uncounted there).
    assert set(ps) - set(js) == {
        ("attendance_device_transfer_bytes_total",
         'direction="h2d",site="frame",wire="word"'),
        ("attendance_device_transfer_bytes_total",
         'direction="d2h",site="mirror_gather"')}


# -- read-path auditing ------------------------------------------------------

def test_read_audit_zero_fn_and_measured_fpr_equal_jax(tmp_path):
    """Sampled read answers cross-check against the exact shadow: roster
    queries give no read-path false negatives, outsider probes a finite
    measured read FPR within budget, per-day HLL errors against the
    epoch's truth snapshot. A JAX engine and read auditor over the same
    epoch and a JAX shadow fed the same roster and frames count and
    gauge the same numbers."""
    from attendance_tpu.models.bloom import BloomParams as JaxParams
    from attendance_tpu.serve import engine as jengine
    from attendance_tpu.serve import mirror as jmirror
    from test_torch_serve import _run_port

    pipe, roster = _run_port(seed=13, snap_dir=tmp_path / "s",
                             serve_port=-1, audit_sample=1.0)
    try:
        epoch = pipe.read_mirror.pin()
        assert epoch.day_truth  # the barrier epochs carry the truth
        assert epoch.day_truth == pipe._auditor.fused_day_truth()
        cols = pipe.store.to_columns(deduplicate=False)
        jt = jobs.enable(JaxConfig(audit_sample=1.0))
        jt.auditor.record_roster(roster)
        frame = 2_048
        sid = np.asarray(cols["student_id"], np.uint32)
        day = np.asarray(cols["lecture_day"])
        for lo in range(0, len(sid), frame):
            jt.auditor.observe_fused_frame(sid[lo:lo + frame],
                                           day[lo:lo + frame])
        assert jt.auditor.fused_day_truth() == epoch.day_truth
        mirror = jmirror.ReadMirror()
        mirror.publish(regs=epoch.hll_regs, events=epoch.events,
                       bank_of=epoch.bank_of,
                       params=JaxParams(*epoch.params),
                       precision=epoch.precision,
                       bloom_words=epoch.bloom_words, counts=epoch.counts,
                       roster_size=epoch.roster_size,
                       day_truth=epoch.day_truth)
        engines = (pipe.query_engine,
                   jengine.QueryEngine(mirror, obs=jt))
        probes = np.random.default_rng(5).integers(
            1 << 31, 1 << 32, 20_000).astype(np.uint32)
        days = np.array(pipe.lecture_days(), np.int64)
        for engine in engines:
            engine.bf_exists(roster)
            engine.bf_exists(probes)
            engine.pfcount(days)
            engine.occupancy()
        names = set(QUERY_AUDIT_HELP) | {
            "attendance_query_false_positives_total",
            "attendance_query_negative_trials_total",
            "attendance_query_hll_rel_error"}
        ps = {k: v for k, v in _samples(obs.get().render()).items()
              if k[0] in names}
        js = {k: v for k, v in _samples(jt.render()).items()
              if k[0] in names}
        assert ps == js
        assert ps[("attendance_query_false_negatives_total", "")] == 0
        assert ps[("attendance_query_audited_total", "")] > 0
        fpr = ps[("attendance_query_measured_fpr", "")]
        assert np.isfinite(fpr) and fpr <= 0.01
        errs = [v for k, v in ps.items()
                if k[0] == "attendance_query_hll_rel_error"]
        assert len(errs) == len(days) and max(errs) <= 0.05
    finally:
        pipe.cleanup()
