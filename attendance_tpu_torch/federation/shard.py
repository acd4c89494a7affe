"""Versioned hash-shard map: which worker owns which key shard.

Counterpart of ``attendance_tpu/federation/shard.py``. The key space is
partitioned by a murmur3 hash of the student id (:func:`shard_of_keys`)
into ``num_shards`` shards; each ingest worker owns one and runs the
fused pipeline unchanged over its shard's topic. The :class:`ShardMap`
is the aggregator's versioned ownership document: every reassignment
(failover) bumps ``version``, and merge frames of an older incarnation
than the owner's current one are stale: their sketch content still
folds (Bloom-OR and HLL-max are idempotent) but their counters are
ignored, so a late frame from a dead owner never double-counts.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from attendance_tpu_torch.ops.murmur3 import murmur3_u32_np

# Hash seed of key -> shard routing, distinct from every sketch seed
# (ops.murmur3): shard routing must be independent of Bloom and HLL
# placement, or shards would systematically share register buckets.
SHARD_SEED = 0x5EED_FEDE


def shard_of_keys(keys, num_shards: int) -> np.ndarray:
    """int64[B] shard index of each uint32 key (host, vectorized)."""
    keys = np.asarray(keys).astype(np.uint32)
    h = murmur3_u32_np(keys, SHARD_SEED & 0xFFFFFFFF)
    return (h % np.uint32(num_shards)).astype(np.int64)


def shard_topic(base_topic: str, shard: int) -> str:
    """The per-shard ingest topic: ``<base>.s<shard>``."""
    return f"{base_topic}.s{shard}"


class ShardMap:
    """shard -> owner worker id, versioned.

    Owned by the aggregator; the map starts unassigned and learns owners
    from the workers' frames (the first live claimer wins). ``reassign``
    is the failover path: a dead worker's shards move to a surviving
    owner, or to None (orphaned until a takeover worker claims them),
    and the version bumps."""

    def __init__(self, num_shards: int):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards
        self.version = 1
        self._owner: List[Optional[str]] = [None] * num_shards

    def owner_of(self, shard: int) -> Optional[str]:
        return self._owner[shard]

    def shards_of(self, worker: str) -> List[int]:
        return [s for s, w in enumerate(self._owner) if w == worker]

    def claim(self, shard: int, worker: str) -> bool:
        """Record ``worker`` as the shard's owner; True when the map
        changed. Claiming an unowned shard does not bump the version
        (start-up is not a reassignment); claiming over another owner
        does."""
        if not (0 <= shard < self.num_shards):
            raise ValueError(
                f"shard {shard} out of range [0, {self.num_shards})")
        prev = self._owner[shard]
        if prev == worker:
            return False
        self._owner[shard] = worker
        if prev is not None:
            self.version += 1
        return True

    def reassign(self, dead_worker: str,
                 new_owner: Optional[str] = None) -> List[int]:
        """Move every shard of ``dead_worker`` to ``new_owner`` (None =
        orphaned) and bump the version once; returns the shards moved."""
        moved = self.shards_of(dead_worker)
        for s in moved:
            self._owner[s] = new_owner
        if moved:
            self.version += 1
        return moved

    def to_dict(self) -> Dict:
        return {"version": self.version, "num_shards": self.num_shards,
                "owners": list(self._owner)}
