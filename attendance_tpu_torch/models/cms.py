"""Count-Min sketch + top-K heavy hitters on torch tensors (the temporal
plane's gate-fraud detector).

Counterpart of ``attendance_tpu/models/cms.py``. State is ONE tensor
``int32[depth, width]`` holding uint32 counters (the JAX array's bytes;
:func:`cms_from_numpy` / :func:`cms_to_numpy` carry it across). Row r
hashes each key with murmur3 under :func:`row_seed` (r); a batch update
adds one per (row, bucket), duplicate keys each counting, and wraps at
2^32 like XLA's uint32 scatter-add. A query is the min over rows of the
key's buckets (one-sided: never undercounts).

:func:`cms_step` (update, then query, in place) runs the K6 kernel on a
CUDA tensor and :func:`cms_step_plain` on a CPU one. The plain versions
carry uint32 values in int64 lanes masked to 32 bits (PyTorch has no
uint32 ``%`` or ``>>``). The numpy twins (``*_np``) and :class:`TopK`
are host code, copied as they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from attendance_tpu_torch.ops.murmur3 import (
    MASK32, as_u32, murmur3_u32, murmur3_u32_np, to_i32)

# Base seed of the CMS hash-lane family, well separated from the
# Bloom/HLL seeds in ops/murmur3; row r hashes with SEED_CMS_BASE
# advanced by r golden-ratio steps (odd constant -> distinct lanes).
SEED_CMS_BASE = 0x7F4A7C15
_SEED_STEP = 0x9E3779B9

DEFAULT_DEPTH = 4
DEFAULT_WIDTH = 1 << 14


def row_seed(row: int) -> int:
    return (SEED_CMS_BASE + row * _SEED_STEP) & MASK32


def cms_init(depth: int, width: int, device: torch.device) -> torch.Tensor:
    """Fresh all-zero counts: int32[depth, width] (uint32 bits)."""
    if depth < 1 or width < 1:
        raise ValueError(f"bad CMS geometry {depth}x{width}")
    return torch.zeros((depth, width), dtype=torch.int32, device=device)


def cms_from_numpy(counts: np.ndarray, device: torch.device) -> torch.Tensor:
    """Counts from the JAX package's uint32[depth, width] array."""
    return torch.from_numpy(
        np.array(counts, dtype=np.uint32).view(np.int32)).to(device)


def cms_to_numpy(counts: torch.Tensor) -> np.ndarray:
    """uint32[depth, width] on the host, byte-equal to the JAX array."""
    return counts.cpu().numpy().view(np.uint32)


def cms_positions(keys: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """Per-key bucket per row: int64[depth, B]."""
    return torch.stack([murmur3_u32(keys, row_seed(r)) % width
                        for r in range(depth)])


def cms_update(counts: torch.Tensor, keys: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> None:
    """Plain batched increment, in place (JAX donated the counts): +1
    per (row, key bucket) of every unmasked lane; duplicates each
    count, and a counter wraps at 2^32."""
    depth, width = counts.shape
    if mask is not None:
        keys = keys[mask]
    flat = (cms_positions(keys, depth, width)
            + torch.arange(depth, device=keys.device)[:, None] * width)
    cur = as_u32(counts.view(-1))
    cur.index_add_(0, flat.reshape(-1),
                   torch.ones(flat.numel(), dtype=torch.int64,
                              device=keys.device))
    counts.view(-1).copy_(to_i32(cur & MASK32))


def cms_query(counts: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Plain point-frequency estimates: int32[B] (uint32 bits), the min
    over rows of the gathered buckets."""
    depth, width = counts.shape
    pos = cms_positions(keys, depth, width)
    gathered = torch.stack([as_u32(counts[r, pos[r]]) for r in range(depth)])
    return to_i32(gathered.min(dim=0).values)


def cms_step_plain(counts: torch.Tensor, keys: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K6: update, then query the updated counts;
    masked lanes read 0. Updates ``counts`` in place; returns est
    int32[B] (uint32 bits)."""
    cms_update(counts, keys, mask)
    est = cms_query(counts, keys)
    if mask is not None:
        est = torch.where(mask, est, 0)
    return est


def cms_step(counts: torch.Tensor, keys: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Update-then-query: the K6 kernel on a CUDA tensor,
    :func:`cms_step_plain` on a CPU one. ``keys`` int32[B] (uint32 bit
    patterns), ``mask`` an optional bool[B]; returns est int32[B]."""
    # Imported here: ops.kernels builds its plain versions on this module.
    from attendance_tpu_torch.ops import kernels
    return kernels.cms_step(counts, keys, mask)


# ---------------------------------------------------------------------------
# Numpy twin (read path / oracle)
# ---------------------------------------------------------------------------

def cms_positions_np(keys: np.ndarray, depth: int,
                     width: int) -> np.ndarray:
    """Numpy mirror of :func:`cms_positions` (the same murmur3 lanes)."""
    with np.errstate(over="ignore"):
        keys = np.asarray(keys).astype(np.uint32)
        rows = [
            (murmur3_u32_np(keys, row_seed(r)) % np.uint32(width))
            .astype(np.int64)
            for r in range(depth)]
    return np.stack(rows)


def cms_init_np(depth: int = DEFAULT_DEPTH,
                width: int = DEFAULT_WIDTH) -> np.ndarray:
    return np.zeros((depth, width), dtype=np.uint32)


def cms_update_np(counts: np.ndarray, keys: np.ndarray,
                  mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Host twin of :func:`cms_update` (in place; returns counts)."""
    depth, width = counts.shape
    keys = np.asarray(keys)
    if mask is not None:
        keys = keys[np.asarray(mask, bool)]
    if len(keys) == 0:
        return counts
    pos = cms_positions_np(keys, depth, width)
    for r in range(depth):
        np.add.at(counts[r], pos[r], np.uint32(1))
    return counts


def cms_query_np(counts: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Host twin of :func:`cms_query`: uint32[B] min-over-rows."""
    depth, width = counts.shape
    keys = np.asarray(keys)
    if len(keys) == 0:
        return np.zeros(0, np.uint32)
    pos = cms_positions_np(keys, depth, width)
    gathered = np.stack([counts[r][pos[r]] for r in range(depth)])
    return np.min(gathered, axis=0)


class TopK:
    """Bounded heavy-hitter candidate set over CMS estimates.

    Every observed (key, estimate) pair is offered; keys keep their
    LARGEST estimate seen (estimates are monotone in stream position);
    the set trims to the K largest. A true heavy hitter is present in
    every batch that contains it, so it is never evicted for good.
    """

    def __init__(self, k: int):
        if k < 1:
            raise ValueError("top-K needs k >= 1")
        self.k = k
        self._best: dict = {}
        # Admission threshold: once K candidates exist, a key must
        # estimate ABOVE the current K-th best to enter (monotone
        # estimates keep this lossless for true heavy hitters).
        self._thresh = 0

    def offer(self, keys: np.ndarray, ests: np.ndarray) -> None:
        """Fold a batch of (key, estimate) pairs (vectorized threshold
        filter + one groupby-max pass per distinct surviving key)."""
        keys = np.asarray(keys, np.uint32)
        ests = np.asarray(ests, np.uint64)
        if len(keys) == 0:
            return
        if self._thresh:
            m = ests > np.uint64(self._thresh)
            keys, ests = keys[m], ests[m]
            if len(keys) == 0:
                return
        order = np.argsort(keys, kind="stable")
        sk, se = keys[order], ests[order]
        starts = np.concatenate([[True], sk[1:] != sk[:-1]])
        idx = np.flatnonzero(starts)
        grouped = np.maximum.reduceat(se, idx)
        if len(idx) > 8 * self.k:
            # Only the batch's own top slice can displace anything in a
            # K-bounded set.
            top = np.argpartition(grouped, -8 * self.k)[-8 * self.k:]
            sk_idx, grouped = sk[idx][top], grouped[top]
        else:
            sk_idx = sk[idx]
        best = self._best
        for key, est in zip(sk_idx.tolist(), grouped.tolist()):
            prev = best.get(key)
            if prev is None or est > prev:
                best[key] = est
        if len(best) > 4 * self.k:
            self._trim()

    def _trim(self) -> None:
        keep = sorted(self._best.items(), key=lambda kv: -kv[1])[:self.k]
        self._best = dict(keep)
        if len(keep) >= self.k:
            self._thresh = keep[-1][1]

    def items(self):
        """[(key, estimate)] sorted hottest first, trimmed to K."""
        self._trim()
        return sorted(self._best.items(), key=lambda kv: -kv[1])

    def __len__(self) -> int:
        return min(len(self._best), self.k)
