"""SketchStore interface, member normalization, and scalable-Bloom logic.

Counterpart of ``attendance_tpu/sketch/base.py``. Semantics contract,
as Redis Stack behaves at the reference's call sites:
  * BF.EXISTS on a missing key returns 0 (no error).
  * BF.ADD on a missing key auto-creates a filter with RedisBloom defaults
    (capacity 100, error 0.01) and auto-scales by chaining sub-filters
    (expansion x2, halved error) when a sub-filter reaches capacity.
  * BF.RESERVE on an existing key raises ResponseError("item exists").
  * PFADD returns 1 iff some register changed; PFCOUNT of a missing key
    is 0; multi-key PFCOUNT is the union estimate.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from attendance_tpu_torch.models.bloom import BloomParams, derive_bloom_params
from attendance_tpu_torch.ops.murmur3 import murmur3_bytes

# RedisBloom's defaults for an implicitly-created filter.
DEFAULT_CAPACITY = 100
DEFAULT_ERROR_RATE = 0.01
EXPANSION = 2

_STR_SEED = 0x9E3779B9


class ResponseError(Exception):
    """Command-level error, mirroring redis.exceptions.ResponseError."""


def member_to_u32(member: Any) -> int:
    """Normalize a sketch member to the uint32 key domain.

    Redis hashes the byte-string form of every member, so int 5 and "5"
    are the same member: integer-valued members (ints or numeric
    strings) in [0, 2^32) map to their value, everything else maps to a
    murmur3 digest of its bytes.
    """
    if isinstance(member, (bool,)):
        member = int(member)
    if isinstance(member, (int, np.integer)):
        v = int(member)
        if 0 <= v < 2 ** 32:
            return v
        return murmur3_bytes(str(v).encode(), _STR_SEED)
    if isinstance(member, bytes):
        data = member
    else:
        data = str(member).encode()
    try:
        v = int(data)
        if 0 <= v < 2 ** 32:
            return v
    except ValueError:
        pass
    return murmur3_bytes(data, _STR_SEED)


def members_to_u32(members: Sequence[Any]) -> np.ndarray:
    """Vector form of member_to_u32; integer arrays convert directly."""
    if isinstance(members, np.ndarray) and members.dtype.kind in "iu":
        return members.astype(np.uint32)
    return np.array([member_to_u32(x) for x in members], dtype=np.uint32)


class ScalableBloom:
    """RedisBloom-style auto-scaling chain of fixed-size Bloom filters.

    Sub-filter i has capacity c0 * EXPANSION^i and error e0 / 2^i, so the
    whole chain's FPR stays <= 2*e0. The backend supplies the three
    per-filter primitives; chaining logic is shared across backends.
    """

    def __init__(self, store: "SketchStore", capacity: int,
                 error_rate: float, layout: str):
        self.store = store
        self.base_capacity = capacity
        self.base_error = error_rate
        self.layout = layout
        self.filters: List[Any] = []  # backend filter handles
        self.params: List[BloomParams] = []
        self.counts: List[int] = []  # approx distinct inserts per filter
        self._grow()

    def _grow(self) -> None:
        i = len(self.filters)
        params = derive_bloom_params(
            self.base_capacity * (EXPANSION ** i),
            self.base_error / (2.0 ** i),
            self.layout)
        self.filters.append(self.store._filter_create(params))
        self.params.append(params)
        self.counts.append(0)

    def contains_many(self, keys: np.ndarray) -> np.ndarray:
        out = np.zeros(len(keys), dtype=bool)
        for handle, params in zip(self.filters, self.params):
            rem = ~out
            if not rem.any():
                break
            out[rem] = self.store._filter_contains(handle, params, keys[rem])
        return out

    def add_many(self, keys: np.ndarray) -> np.ndarray:
        """Insert keys; returns per-key 1 if (probably) new, else 0.

        Inserts are sliced across sub-filters so no sub-filter ever takes
        more distinct keys than its declared capacity: a batch larger
        than the whole remaining chain grows the chain as many times as
        needed instead of overfilling the newest sub-filter.
        """
        existed = self.contains_many(keys)
        new_keys = keys[~existed]
        i = 0
        while i < len(new_keys):
            room = self.params[-1].capacity - self.counts[-1]
            if room <= 0:
                self._grow()
                continue
            chunk = new_keys[i:i + room]
            # Distinct inserts, counting within-batch duplicates once
            # (duplicates crossing a slice boundary re-add idempotently
            # to the newer sub-filter; membership stays correct).
            self.counts[-1] += len(np.unique(chunk))
            self.filters[-1] = self.store._filter_add(
                self.filters[-1], self.params[-1], chunk)
            i += len(chunk)
        return (~existed).astype(np.int64)

    @property
    def item_count(self) -> int:
        return sum(self.counts)

    @property
    def total_capacity(self) -> int:
        return sum(p.capacity for p in self.params)


class SketchStore(abc.ABC):
    """Abstract sketch store exposing the redis-py call shapes.

    Concrete stores implement the per-filter primitives (_filter_*) and
    the HLL primitives; the Redis backend overrides the public methods
    wholesale and never touches the primitives.
    """

    def __init__(self, config):
        self.config = config
        self._blooms: Dict[str, ScalableBloom] = {}
        # Dirty-key tracking for incremental (base + delta) snapshots
        # (utils/snapshot.snapshot_sketch_store_chain): the public
        # command surface marks keys written since the last drain.
        # _dirty_all forces the next chain snapshot to write a full base
        # (fresh store, flush, or a restore mismatch).
        self._dirty_blooms: set = set()
        self._dirty_hll: set = set()
        self._dirty_all = True
        # Accuracy auditor (obs/audit.py): captured ONCE here, one
        # `is not None` branch per public command when auditing is off.
        # The hooks live on the PUBLIC command surface (not the
        # _filter_*/_hll_* primitives), so internal membership probes
        # (ScalableBloom.add_many's dedup contains) never enter the
        # measured-FPR denominator, and every backend routed through
        # this dispatch (memory / tpu / redis-sim) is audited alike.
        from attendance_tpu_torch import obs
        t = obs.ensure(config) if config is not None else None
        self._auditor = t.auditor if t is not None else None

    # -- backend primitives -------------------------------------------------
    @abc.abstractmethod
    def _filter_create(self, params: BloomParams):
        ...

    @abc.abstractmethod
    def _filter_add(self, handle, params: BloomParams, keys: np.ndarray):
        """Returns the (possibly replaced) filter handle."""

    @abc.abstractmethod
    def _filter_contains(self, handle, params: BloomParams,
                         keys: np.ndarray) -> np.ndarray:
        ...

    @abc.abstractmethod
    def _hll_add(self, key: str, keys_u32: np.ndarray,
                 mask: Optional[np.ndarray] = None,
                 want_changed: bool = True) -> int:
        """Batched PFADD; returns 1 if any register changed.

        want_changed=False lets device backends skip the host round-trip
        that computing the flag costs; the return value is then 0 and
        meaningless (the micro-batch hot loop never reads it)."""

    @abc.abstractmethod
    def _hll_count(self, keys: Sequence[str]) -> int:
        ...

    # -- Bloom command surface (redis-py execute_command shapes) ------------
    def bf_reserve(self, key: str, error_rate, capacity) -> bool:
        if key in self._blooms:
            raise ResponseError("item exists")
        self._blooms[key] = ScalableBloom(
            self, int(capacity), float(error_rate),
            getattr(self.config, "bloom_layout", "flat"))
        self._dirty_blooms.add(key)
        return True

    def _bloom_or_create(self, key: str) -> ScalableBloom:
        bloom = self._blooms.get(key)
        if bloom is None:
            bloom = ScalableBloom(self, DEFAULT_CAPACITY, DEFAULT_ERROR_RATE,
                                  getattr(self.config, "bloom_layout", "flat"))
            self._blooms[key] = bloom
        return bloom

    def bf_add_many(self, key: str, members) -> np.ndarray:
        u32 = members_to_u32(members)
        out = self._bf_add_u32(key, u32)
        self._dirty_blooms.add(key)
        if self._auditor is not None:
            self._auditor.record_bf_add(key, u32)
        return out

    def bf_exists_many(self, key: str, members) -> np.ndarray:
        u32 = members_to_u32(members)
        out = self._bf_exists_u32(key, u32)
        if self._auditor is not None:
            self._auditor.check_bf_exists(key, u32, out)
        return out

    # Backend chokepoints under the audited surface: subclasses that
    # reimplement the command semantics wholesale (redis_sim) override
    # these, so the audit above still sees their answers.
    def _bf_add_u32(self, key: str, u32: np.ndarray) -> np.ndarray:
        return self._bloom_or_create(key).add_many(u32)

    def _bf_exists_u32(self, key: str, u32: np.ndarray) -> np.ndarray:
        bloom = self._blooms.get(key)
        if bloom is None:
            return np.zeros(len(u32), dtype=bool)
        return bloom.contains_many(u32)

    # -- HLL command surface ------------------------------------------------
    def pfadd(self, key: str, *members) -> int:
        self._dirty_hll.add(key)
        if not members:
            return self._pf_create(key)
        u32 = members_to_u32(members)
        out = self._pfadd_u32(key, u32, None, True)
        if self._auditor is not None:
            self._auditor.record_pfadd(key, u32)
        return out

    def pfadd_many(self, key: str, members,
                   mask: Optional[np.ndarray] = None,
                   want_changed: bool = False) -> int:
        self._dirty_hll.add(key)
        u32 = members_to_u32(members)
        out = self._pfadd_u32(key, u32, mask, want_changed)
        if self._auditor is not None:
            self._auditor.record_pfadd(key, u32, mask)
        return out

    def pfcount(self, *keys: str) -> int:
        out = self._pfcount_keys(keys)
        if self._auditor is not None:
            self._auditor.check_pfcount(keys, out)
        return out

    def pfcount_many(self, keys: Sequence[str]) -> List[int]:
        """Batched per-key PFCOUNT: one estimate per key (NOT the union
        ``pfcount(*keys)`` computes). The default loops :meth:`pfcount`,
        so every answer crosses the audit chokepoint; banked backends
        override it with one histogram pass (TpuSketchStore)."""
        return [self.pfcount(k) for k in keys]

    def _pf_create(self, key: str) -> int:
        """PFADD with no members (create-only form); the generic
        backends treat it as a no-op returning 0."""
        return 0

    def _pfadd_u32(self, key: str, u32: np.ndarray,
                   mask: Optional[np.ndarray],
                   want_changed: bool) -> int:
        return self._hll_add(key, u32, mask, want_changed)

    def _pfcount_keys(self, keys: Sequence[str]) -> int:
        return self._hll_count(keys)

    # -- observability ------------------------------------------------------
    def _filter_fill(self, handle, params: BloomParams) -> float:
        """Fraction of set bits of one sub-filter whose handle is a host
        0/1 byte-per-bit array (memory, redis-sim). The card store
        overrides it with a device count. The JAX base caught every
        exception here and returned None, which hid a device handle's
        failure as a missing estimate; only the redis store, which has
        no local filters, is opaque."""
        return float(np.mean(np.asarray(handle, dtype=np.float32)))

    def estimated_fpr(self, key: str) -> Optional[float]:
        """Occupancy-based FPR estimate for one Bloom key: per sub-filter
        fill^k, combined across the scalable chain as
        1 - prod(1 - fpr_i) (a query false-positives if ANY sub-filter
        does). None when the key is absent (always, on the redis store,
        whose filters live on the server)."""
        bloom = self._blooms.get(key)
        if bloom is None:
            return None
        miss = 1.0
        for handle, params in zip(bloom.filters, bloom.params):
            miss *= 1.0 - self._filter_fill(handle, params) ** params.k
        return 1.0 - miss

    # -- redis-py compatible entry point ------------------------------------
    def execute_command(self, *args):
        """The exact call shape the reference uses for BF.* commands.

        Arity mistakes raise :class:`ResponseError` like a real server
        ("wrong number of arguments"); the check is explicit per command,
        so a backend fault is never relabelled as an arity mistake.
        """
        if not args:
            raise ResponseError("empty command")
        cmd = str(args[0]).upper()
        n = len(args) - 1

        def need(lo: int, hi: Optional[float] = None) -> None:
            """hi=None means exactly ``lo`` args; pass float('inf')
            for variadic commands."""
            top = lo if hi is None else hi
            if n < lo or n > top:
                raise ResponseError(
                    f"wrong number of arguments for {cmd!r}")

        if cmd == "BF.RESERVE":
            need(3)
            return self.bf_reserve(str(args[1]), args[2], args[3])
        if cmd == "BF.ADD":
            need(2)
            return int(self.bf_add_many(str(args[1]), [args[2]])[0])
        if cmd == "BF.MADD":
            need(2, float("inf"))
            key = str(args[1])
            return [int(x) for x in self.bf_add_many(key, list(args[2:]))]
        if cmd == "BF.EXISTS":
            need(2)
            return int(self.bf_exists_many(str(args[1]), [args[2]])[0])
        if cmd == "BF.MEXISTS":
            need(2, float("inf"))
            key = str(args[1])
            return [int(x) for x in self.bf_exists_many(key, list(args[2:]))]
        if cmd == "BF.INFO":
            need(1)
            key = str(args[1])
            bloom = self._blooms.get(key)
            if bloom is None:
                raise ResponseError("not found")
            return {
                "Capacity": bloom.total_capacity,
                "Size": sum(p.m_bits // 8 for p in bloom.params),
                "Number of filters": len(bloom.filters),
                "Number of items inserted": bloom.item_count,
                "Expansion rate": EXPANSION,
            }
        if cmd == "PFADD":
            need(1, float("inf"))
            return self.pfadd(str(args[1]), *args[2:])
        if cmd == "PFCOUNT":
            need(1, float("inf"))
            return self.pfcount(*[str(k) for k in args[1:]])
        raise ResponseError(f"unknown command {cmd!r}")

    # -- incremental-snapshot support ---------------------------------------
    def drain_dirty(self):
        """(dirty_all, bloom_keys, hll_keys) written since the last
        drain, clearing the marks: the chain snapshotter's capture
        point (utils/snapshot.snapshot_sketch_store_chain)."""
        out = (self._dirty_all, self._dirty_blooms, self._dirty_hll)
        self._dirty_all = False
        self._dirty_blooms = set()
        self._dirty_hll = set()
        return out

    def mark_clean(self) -> None:
        """After restore: disk chain == memory state, nothing dirty."""
        self._dirty_all = False
        self._dirty_blooms.clear()
        self._dirty_hll.clear()

    # -- lifecycle ----------------------------------------------------------
    def flush(self) -> None:
        self._blooms.clear()
        self._dirty_all = True
        self._dirty_blooms.clear()
        self._dirty_hll.clear()

    def close(self) -> None:
        pass
