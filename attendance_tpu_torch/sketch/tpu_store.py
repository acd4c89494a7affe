"""The card's sketch store (``--sketch-backend tpu``).

Counterpart of ``attendance_tpu/sketch/tpu_store.py``; the flag value
keeps the JAX package's name and selects the CUDA card here. Filters
are byte-per-bit ``uint8[m_bits]`` tensors and the HLL keys are rows of
one ``uint8[num_banks, 2^p]`` register tensor, all on the device, so the
per-event BF.EXISTS / PFADD round trips of the reference's loop become
one kernel per micro-batch: K8 probes a batch, K7 adds one, K5 maxes a
PFADD batch into its bank, K1-rows histograms the banks of a batched
PFCOUNT and K1-union the register max of a multi-key PFCOUNT. Batches
go to the kernels at their exact length (the JAX store padded them to a
power of two for XLA's shapes). On the CPU (``device="cpu"``) every
kernel is its plain PyTorch version.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from attendance_tpu_torch.device import resolve_device
from attendance_tpu_torch.models.bloom import (
    BloomParams, bloom_add, bloom_contains, bloom_fill_fraction, bloom_init,
    keys_tensor)
from attendance_tpu_torch.models.hll import (
    HyperLogLog, estimate_from_histogram, hll_bucket_rank_np)
from attendance_tpu_torch.sketch.base import SketchStore


class TpuSketchStore(SketchStore):
    def __init__(self, config, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self._hll = self._new_hll()

    def _new_hll(self) -> HyperLogLog:
        return HyperLogLog(
            initial_banks=getattr(self.config, "hll_initial_banks", 8),
            precision=getattr(self.config, "hll_precision", 14),
            device=self.device)

    # -- Bloom primitives ---------------------------------------------------
    def _filter_create(self, params: BloomParams):
        return bloom_init(params, self.device)

    def _filter_add(self, handle, params: BloomParams, keys: np.ndarray):
        bloom_add(handle, keys_tensor(keys, self.device), params)
        return handle

    def _filter_contains(self, handle, params: BloomParams,
                         keys: np.ndarray) -> np.ndarray:
        return bloom_contains(handle, keys_tensor(keys, self.device),
                              params).cpu().numpy()

    def _filter_fill(self, handle, params: BloomParams) -> float:
        """The sub-filter's fill from one device count (the base's host
        mean cannot read a device tensor)."""
        return float(bloom_fill_fraction(handle))

    # -- HLL primitives -----------------------------------------------------
    def _hll_add(self, key: str, keys_u32: np.ndarray,
                 mask: Optional[np.ndarray] = None,
                 want_changed: bool = True) -> int:
        idx = self._hll.bank_index(key)
        changed = False
        if want_changed:
            # "Did any register change?" computed on the host from the
            # row before the update: a blocking copy of the row, which
            # only the scalar redis-compatible pfadd() pays for.
            bucket, rank = hll_bucket_rank_np(keys_u32, self._hll.precision)
            if mask is not None:
                rank = np.where(mask, rank, 0)
            row = self._hll.regs[idx].cpu().numpy()
            changed = bool((rank > row[bucket]).any())
        self._hll.add(np.full(len(keys_u32), idx, dtype=np.int32), keys_u32,
                      mask)
        return int(changed)

    def pfcount_many(self, keys: Sequence[str]):
        """Batched per-key PFCOUNT: one K1-rows launch over every
        requested bank instead of a launch per key. Each answer is still
        cross-checked per key by the auditor, as the scalar path's."""
        idxs = [self._hll.bank_index(k, create=False) for k in keys]
        known = sorted({i for i in idxs if i >= 0})
        by_bank = {}
        if known:
            hists = self._hll.histograms(known)
            by_bank = {b: int(round(estimate_from_histogram(
                h, self._hll.precision)))
                for b, h in zip(known, hists)}
        out = [by_bank.get(idx, 0) for idx in idxs]
        if self._auditor is not None:
            for key, v in zip(keys, out):
                self._auditor.check_pfcount((key,), v)
        return out

    def _hll_count(self, keys: Sequence[str]) -> int:
        known = [k for k in keys if self._hll.bank_index(k, create=False) >= 0]
        if not known:
            return 0
        if len(known) == 1:
            return self._hll.count(known[0])
        return self._hll.count_union(known)

    @property
    def hll(self) -> HyperLogLog:
        """The register banks and the key name -> bank map."""
        return self._hll

    # -- snapshot/restore hooks (attendance_tpu_torch.utils.snapshot) -------
    def _restore_filter(self, params: BloomParams, bits: np.ndarray):
        return torch.from_numpy(np.array(bits, dtype=np.uint8)).to(
            self.device)

    def _restore_hll_banked(self, regs: np.ndarray, bank_of: Dict[str, int],
                            precision: int) -> None:
        self._hll = HyperLogLog(initial_banks=regs.shape[0],
                                precision=precision, device=self.device)
        self._hll.regs = torch.from_numpy(
            np.array(regs, dtype=np.uint8)).to(self.device)
        self._hll._bank_of = {str(k): int(v) for k, v in bank_of.items()}

    def flush(self) -> None:
        super().flush()
        self._hll = self._new_hll()
