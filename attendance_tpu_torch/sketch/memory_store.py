"""Pure-host numpy sketch store (``--sketch-backend memory``).

Counterpart of ``attendance_tpu/sketch/memory_store.py``: the hashing
and layout of the card store (the shared parameter derivation and the
numpy mirrors of the position and rank math) with no device at all,
the hermetic backend of the tests and an independent oracle for the
card store's kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from attendance_tpu_torch.models.bloom import BloomParams, bloom_positions_np
from attendance_tpu_torch.models.hll import (
    estimate_from_histogram, hll_bucket_rank_np)
from attendance_tpu_torch.sketch.base import SketchStore


class MemorySketchStore(SketchStore):
    def __init__(self, config):
        super().__init__(config)
        self.precision = getattr(config, "hll_precision", 14)
        self._hll_regs: Dict[str, np.ndarray] = {}

    # -- Bloom primitives ---------------------------------------------------
    def _filter_create(self, params: BloomParams):
        return np.zeros(params.m_bits, dtype=np.uint8)

    def _filter_add(self, handle, params: BloomParams, keys: np.ndarray):
        pos = bloom_positions_np(keys, params)
        handle[pos.reshape(-1).astype(np.int64)] = 1
        return handle

    def _filter_contains(self, handle, params: BloomParams,
                         keys: np.ndarray) -> np.ndarray:
        pos = bloom_positions_np(keys, params).astype(np.int64)
        return handle[pos].all(axis=1)

    # -- HLL primitives -----------------------------------------------------
    def _hll_add(self, key: str, keys_u32: np.ndarray,
                 mask: Optional[np.ndarray] = None,
                 want_changed: bool = True) -> int:
        regs = self._hll_regs.get(key)
        if regs is None:
            regs = self._hll_regs[key] = np.zeros(
                1 << self.precision, dtype=np.uint8)
        bucket, rank = hll_bucket_rank_np(keys_u32, self.precision)
        if mask is not None:
            rank = np.where(mask, rank, 0)
        changed = bool((rank > regs[bucket]).any())
        np.maximum.at(regs, bucket, rank.astype(np.uint8))
        return int(changed)

    def _hll_count(self, keys: Sequence[str]) -> int:
        known = [self._hll_regs[k] for k in keys if k in self._hll_regs]
        if not known:
            return 0
        merged = known[0]
        for r in known[1:]:
            merged = np.maximum(merged, r)
        q = 64 - self.precision
        hist = np.bincount(merged, minlength=q + 2)
        return int(round(estimate_from_histogram(hist, self.precision)))

    # -- snapshot/restore hooks (attendance_tpu_torch.utils.snapshot) -------
    def _restore_filter(self, params: BloomParams, bits: np.ndarray):
        return np.array(bits, dtype=np.uint8)

    def _restore_hll_per_key(self, regs: Dict[str, np.ndarray],
                             precision: int) -> None:
        self.precision = precision
        self._hll_regs = {k: np.array(v, dtype=np.uint8)
                          for k, v in regs.items()}

    def flush(self) -> None:
        super().flush()
        self._hll_regs.clear()
