"""Differential parity harness: two sketch backends, one event stream.

Counterpart of ``attendance_tpu/parity.py``. The bar is statistical
parity with Redis Stack (no false negatives, Bloom FPR <= 1%, HLL
estimate within 2%) on identical streams driven through the reference's
call shapes: the ``BF.EXISTS key 'test'`` probe, ``BF.RESERVE``, the
``BF.ADD`` preload, ``BF.EXISTS`` per event, ``pfadd`` per valid event
and ``pfcount``. Parity is statistical, not bit-level: the card store
hashes uint32 little-endian key bytes with its own murmur3 seeds, Redis
hashes the decimal-string bytes with its own seeding, so individual
false positives differ; the error budgets must agree.

:func:`run_parity` drives any two SketchStores. The default hermetic
oracle is the Redis-algorithm simulation (:func:`run_sim_parity`: the
card store against sketch.redis_sim); ``parity --oracle redis`` pairs
the card store with a reachable Redis Stack (:func:`check_redis`).
Scalar command shapes run on a sample of the stream (one round trip
each against a real server); the rest flows through the batched
equivalents, as the processors drive the store.
"""

from __future__ import annotations

import dataclasses
import logging
import uuid
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

SCALAR_SAMPLE = 200  # events driven through the exact one-RTT shapes

BLOOM_FN_LIMIT = 0  # false negatives allowed (Bloom guarantee: none)
HLL_ERROR_LIMIT = 0.02  # each backend vs exact (BASELINE.md)
# Cross-backend gate: two INDEPENDENT estimators each within sigma of
# exact differ with sigma*sqrt(2), so the divergence budget carries the
# sqrt(2) allowance.
HLL_CROSS_LIMIT = HLL_ERROR_LIMIT * 2.0 ** 0.5


class RedisUnavailable(RuntimeError):
    """No Redis Stack (with RedisBloom) reachable at the configured host."""


def parity_key_names(key_suffix: str, num_lectures: int) -> List[str]:
    """Every key :func:`run_parity` creates for this suffix — the exact
    set a caller must clean up on a shared server."""
    return ([f"bf:students{key_suffix}"]
            + [f"hll:unique:LECTURE_2026010{lec + 1}{key_suffix}"
               for lec in range(num_lectures)])


@dataclasses.dataclass
class ParityReport:
    """Everything the parity assertions saw, per backend 'a' and 'b'."""

    events: int = 0
    roster_size: int = 0
    invalid_seen: int = 0
    invalid_unique: int = 0
    error_rate: float = 0.01
    fpr_limit: float = 0.01
    false_negatives_a: int = 0
    false_negatives_b: int = 0
    fpr_a: float = 0.0
    fpr_b: float = 0.0
    validity_mismatches: int = 0
    pfcounts_a: Dict[str, int] = dataclasses.field(default_factory=dict)
    pfcounts_b: Dict[str, int] = dataclasses.field(default_factory=dict)
    exact_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    hll_err_a: float = 0.0
    hll_err_b: float = 0.0
    hll_cross_err: float = 0.0
    failures: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        lines = [
            f"events={self.events} roster={self.roster_size} "
            f"invalid_seen={self.invalid_seen}",
            f"false_negatives: a={self.false_negatives_a} "
            f"b={self.false_negatives_b} (limit {BLOOM_FN_LIMIT})",
            f"fpr over {self.invalid_unique} unique invalid ids: "
            f"a={self.fpr_a:.4%} b={self.fpr_b:.4%} "
            f"(limit {self.fpr_limit:.3%} = {self.error_rate:.2%} "
            "configured error rate + 3-sigma sampling allowance)",
            f"validity mismatches (differing false positives): "
            f"{self.validity_mismatches}",
            f"hll err vs exact: a={self.hll_err_a:.3%} "
            f"b={self.hll_err_b:.3%} (limit {HLL_ERROR_LIMIT:.0%}); "
            f"cross-backend {self.hll_cross_err:.3%} "
            f"(limit {HLL_CROSS_LIMIT:.1%} = sqrt(2) allowance for two "
            "independent estimators)",
        ]
        if self.failures:
            lines.append("FAILURES: " + "; ".join(self.failures))
        else:
            lines.append("PARITY OK")
        return "\n".join(lines)


def _drive_bloom(store, key: str, error_rate: float, capacity: int,
                 roster: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Reference setup + validity sequence against one store."""
    # Probe-then-reserve bootstrap (attendance_processor.py:74-92).
    # RedisBloom's BF.EXISTS on a missing key returns 0 on current
    # servers but raised on the versions the reference tolerates — treat
    # any outcome as "filter absent".
    try:
        store.execute_command("BF.EXISTS", key, "test")
    except Exception:  # noqa: BLE001 - mirroring the reference's catch
        pass
    store.execute_command("BF.RESERVE", key, error_rate, capacity)

    # Generator preload (data_generator.py:57-64): exact scalar shape for
    # a sample, batched for the bulk.
    for sid in roster[:SCALAR_SAMPLE].tolist():
        store.execute_command("BF.ADD", key, sid)
    if len(roster) > SCALAR_SAMPLE:
        store.bf_add_many(key, roster[SCALAR_SAMPLE:])

    # Validity checks (attendance_processor.py:109-113).
    scalar = np.array(
        [bool(store.execute_command("BF.EXISTS", key, sid))
         for sid in queries[:SCALAR_SAMPLE].tolist()], dtype=bool)
    bulk = store.bf_exists_many(key, queries[SCALAR_SAMPLE:])
    return np.concatenate([scalar, np.asarray(bulk, dtype=bool)])


def _drive_hll(store, hll_key: str, members: np.ndarray,
               valid: np.ndarray) -> int:
    """PFADD-per-valid-event + PFCOUNT (attendance_processor.py:127-152)."""
    for sid, ok in zip(members[:SCALAR_SAMPLE].tolist(),
                       valid[:SCALAR_SAMPLE].tolist()):
        if ok:
            store.pfadd(hll_key, sid)
    store.pfadd_many(hll_key, members[SCALAR_SAMPLE:],
                     mask=valid[SCALAR_SAMPLE:])
    return int(store.pfcount(hll_key))


def run_parity(store_a, store_b, *,
               num_events: int = 50_000,
               roster_size: int = 10_000,
               num_lectures: int = 4,
               error_rate: float = 0.01,
               capacity: Optional[int] = None,
               invalid_fraction: float = 0.15,
               seed: int = 0,
               key_suffix: str = "") -> ParityReport:
    """Drive identical streams through two stores; return the report.

    ``key_suffix`` namespaces the Bloom/HLL keys (essential against a
    shared Redis server; the caller deletes them afterwards).
    """
    rng = np.random.default_rng(seed)
    capacity = capacity or roster_size
    bloom_key, *hll_keys = parity_key_names(key_suffix, num_lectures)

    report = ParityReport(events=num_events, roster_size=roster_size,
                          error_rate=error_rate)

    # Reference populations (data_generator.py:53-54,80-81): valid ids in
    # [10000, 99999] when they fit, invalid ids strictly disjoint above.
    hi = max(99_999, 10_000 + 10 * roster_size)
    roster = rng.choice(np.arange(10_000, hi, dtype=np.uint32),
                        size=roster_size, replace=False)
    invalid_pool = np.arange(hi + 1, hi + 1 + 2 * roster_size,
                             dtype=np.uint32)

    is_invalid = rng.random(num_events) < invalid_fraction
    stream = np.where(
        is_invalid,
        invalid_pool[rng.integers(0, len(invalid_pool), num_events)],
        roster[rng.integers(0, len(roster), num_events)]).astype(np.uint32)
    truth = ~is_invalid
    report.invalid_seen = int(is_invalid.sum())

    valid_a = _drive_bloom(store_a, bloom_key, error_rate, capacity,
                           roster, stream)
    valid_b = _drive_bloom(store_b, bloom_key, error_rate, capacity,
                           roster, stream)

    report.false_negatives_a = int(np.sum(truth & ~valid_a))
    report.false_negatives_b = int(np.sum(truth & ~valid_b))
    # FPR over UNIQUE invalid ids: whether a key false-positives is fixed
    # by the hash, so repeated draws of the same key are one Bernoulli
    # trial, not independent evidence.
    inv_ids, first_idx = np.unique(stream[is_invalid], return_index=True)
    inv_pos = np.flatnonzero(is_invalid)[first_idx]
    report.invalid_unique = len(inv_ids)
    n_invalid = max(1, report.invalid_unique)
    report.fpr_a = float(np.sum(valid_a[inv_pos])) / n_invalid
    report.fpr_b = float(np.sum(valid_b[inv_pos])) / n_invalid
    # The gate is the error rate actually reserved on both backends,
    # plus a 3-sigma binomial allowance on the finite unique-key sample.
    report.fpr_limit = error_rate + 3.0 * float(
        np.sqrt(error_rate * (1 - error_rate) / n_invalid))
    report.validity_mismatches = int(np.sum(valid_a != valid_b))

    # Per-lecture HLL: same lecture axis on both backends.
    lecture_of = rng.integers(0, num_lectures, num_events)
    for lec, hll_key in enumerate(hll_keys):
        lecture_id = f"LECTURE_2026010{lec + 1}"
        sel = lecture_of == lec
        members = stream[sel]
        report.pfcounts_a[lecture_id] = _drive_hll(
            store_a, hll_key, members, valid_a[sel])
        report.pfcounts_b[lecture_id] = _drive_hll(
            store_b, hll_key, members, valid_b[sel])
        # Exact distinct members each backend *should* have counted is
        # conditioned on its own validity verdicts; false positives make
        # the two ideals differ by a handful of members, which is inside
        # the HLL error budget, so compare both to the shared truth.
        report.exact_counts[lecture_id] = int(
            len(np.unique(members[truth[sel]])))

    errs_a, errs_b, errs_x = [], [], []
    for lec_id, exact in report.exact_counts.items():
        a, b = report.pfcounts_a[lec_id], report.pfcounts_b[lec_id]
        errs_a.append(abs(a - exact) / max(1, exact))
        errs_b.append(abs(b - exact) / max(1, exact))
        errs_x.append(abs(a - b) / max(1, b))
    report.hll_err_a = max(errs_a)
    report.hll_err_b = max(errs_b)
    report.hll_cross_err = max(errs_x)

    if report.false_negatives_a > BLOOM_FN_LIMIT:
        report.failures.append(
            f"backend a has {report.false_negatives_a} false negatives")
    if report.false_negatives_b > BLOOM_FN_LIMIT:
        report.failures.append(
            f"backend b has {report.false_negatives_b} false negatives")
    if report.fpr_a > report.fpr_limit:
        report.failures.append(f"backend a FPR {report.fpr_a:.4%} > limit")
    if report.fpr_b > report.fpr_limit:
        report.failures.append(f"backend b FPR {report.fpr_b:.4%} > limit")
    if report.hll_err_a > HLL_ERROR_LIMIT:
        report.failures.append(
            f"backend a HLL error {report.hll_err_a:.3%} > limit")
    if report.hll_err_b > HLL_ERROR_LIMIT:
        report.failures.append(
            f"backend b HLL error {report.hll_err_b:.3%} > limit")
    if report.hll_cross_err > HLL_CROSS_LIMIT:
        report.failures.append(
            f"cross-backend HLL divergence {report.hll_cross_err:.3%}"
            " > limit")
    return report


# ---------------------------------------------------------------------------
# Redis gating
# ---------------------------------------------------------------------------

def check_redis(config, timeout_s: float = 1.0) -> None:
    """Raise :class:`RedisUnavailable` unless a Redis Stack server with
    the RedisBloom module answers at config.redis_host:config.redis_port."""
    try:
        import redis
    except ImportError as e:
        raise RedisUnavailable("redis-py is not installed") from e
    probe_key = f"bf:parity:probe:{uuid.uuid4().hex}"
    try:
        client = redis.Redis(host=config.redis_host, port=config.redis_port,
                             socket_connect_timeout=timeout_s,
                             socket_timeout=timeout_s)
        client.ping()
    except Exception as e:  # connection refused / timeout / auth
        raise RedisUnavailable(
            f"no usable Redis server at {config.redis_host}:"
            f"{config.redis_port}: {e}") from e
    try:
        # BF.* requires the RedisBloom module (Redis Stack). Only a
        # command-level error HERE (after a successful ping) means the
        # module is missing.
        client.execute_command("BF.RESERVE", probe_key, 0.01, 100)
        client.delete(probe_key)
    except redis.exceptions.ResponseError as e:
        raise RedisUnavailable(
            f"server at {config.redis_host}:{config.redis_port} lacks "
            f"the RedisBloom module: {e}") from e
    except Exception as e:
        raise RedisUnavailable(
            f"Redis probe at {config.redis_host}:{config.redis_port} "
            f"failed: {e}") from e
    finally:
        client.close()


def run_sim_parity(config, device=None, **kwargs) -> ParityReport:
    """Card-store-vs-simulated-Redis parity: hermetic, no server.

    Same pairing scaffold as :func:`run_redis_parity` with the
    RedisSimSketchStore oracle (sketch.redis_sim): Redis's actual
    sizing/hashing/estimator algorithms without a Redis Stack. The card
    store runs on ``device`` (default: the CUDA card).
    """
    import dataclasses as dc

    from attendance_tpu_torch.sketch.redis_sim import RedisSimSketchStore
    from attendance_tpu_torch.sketch.tpu_store import TpuSketchStore

    kwargs.setdefault("error_rate", config.bloom_filter_error_rate)
    tpu = TpuSketchStore(dc.replace(config, sketch_backend="tpu"),
                         device=device)
    sim = RedisSimSketchStore(dc.replace(config,
                                         sketch_backend="redis-sim"))
    try:
        return run_parity(tpu, sim, **kwargs)
    finally:
        sim.close()
        tpu.close()


def run_redis_parity(config, device=None, **kwargs) -> ParityReport:
    """Card-store-vs-Redis parity on a reachable Redis Stack server.

    Creates run-unique keys on the server and deletes them afterwards
    (never flushes — the server may be shared).
    """
    import dataclasses as dc

    from attendance_tpu_torch.sketch.redis_store import RedisSketchStore
    from attendance_tpu_torch.sketch.tpu_store import TpuSketchStore

    check_redis(config)
    suffix = f":parity:{uuid.uuid4().hex[:8]}"
    kwargs.setdefault("error_rate", config.bloom_filter_error_rate)
    kwargs.setdefault("num_lectures", 4)
    tpu = TpuSketchStore(dc.replace(config, sketch_backend="tpu"),
                         device=device)
    red = RedisSketchStore(dc.replace(config, sketch_backend="redis"))
    try:
        report = run_parity(tpu, red, key_suffix=suffix, **kwargs)
    finally:
        try:
            # Delete exactly the keys this run created (no KEYS scan —
            # the server may be shared and KEYS blocks it).
            red.client.delete(
                *parity_key_names(suffix, kwargs["num_lectures"]))
        except Exception:  # noqa: BLE001 - cleanup best-effort
            logger.warning("could not clean up parity keys %s", suffix)
        red.close()
        tpu.close()
    return report
