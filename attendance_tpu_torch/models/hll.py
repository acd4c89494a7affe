"""HyperLogLog register banks on torch tensors (PFADD / PFCOUNT).

Counterpart of ``attendance_tpu/models/hll.py``. All HLL keys live in one
``uint8[num_banks, 2^p]`` tensor, bank b being HLL key b. The 64-bit hash
domain of Redis dense HLL is assembled from two murmur3 lanes: bucket =
low p bits of h1; rank = 1 + count-trailing-zeros of the (64-p)-bit
pattern (bits p..31 of h1, then h2), capped at q + 1 = 65 - p.

PFADD outside the fused step (the temporal plane's window add, the
generic store's PFADD) is the K5 kernel on a CUDA tensor,
:func:`hll_add_plain` on a CPU one. PFCOUNT is a register-value
histogram per bank (the K1 kernel, or over a list of banks K1-rows, on a
CUDA tensor; :func:`hll_histogram` on a CPU one) followed by Ertl's
improved raw estimator on the host; a multi-key PFCOUNT histograms the
register max over its banks (K1-union). :class:`HyperLogLog` holds the
banks and the key name -> bank map of the generic store.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from attendance_tpu_torch.device import resolve_device
from attendance_tpu_torch.ops.murmur3 import (
    MASK32, SEED_HLL_HI, SEED_HLL_LO, murmur3_u32, murmur3_u32_np)


def hll_init(num_banks: int, precision: int,
             device: torch.device) -> torch.Tensor:
    """Fresh all-zero register banks: uint8[num_banks, 2^precision]."""
    return torch.zeros((num_banks, 1 << precision), dtype=torch.uint8,
                       device=device)


def _ctz32(x: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of int64 lanes holding uint32 values > 0.
    The lowest set bit is a power of two <= 2^31, whose log2 is exact in
    float64 (torch has no ctz/clz op)."""
    lsb = x & (-x)
    return torch.round(torch.log2(lsb.to(torch.float64))).to(torch.int64)


def hll_bucket_rank(keys: torch.Tensor,
                    precision: int = 14) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-key (bucket, rank) in the Redis dense-HLL sense, as int64:
    bucket in [0, 2^p), rank in [1, 64-p+1]."""
    p = precision
    q = 64 - p
    h1 = murmur3_u32(keys, SEED_HLL_LO)
    h2 = murmur3_u32(keys, SEED_HLL_HI)
    bucket = h1 & ((1 << p) - 1)
    lo = (h1 >> p) | ((h2 << (32 - p)) & MASK32)  # 32 bits
    hi = h2 >> p                                   # remaining 32-p bits
    safe_lo = torch.where(lo != 0, lo, 1)
    safe_hi = torch.where(hi != 0, hi, 1)
    rank = torch.where(
        lo != 0, _ctz32(safe_lo) + 1,
        torch.where(hi != 0, 32 + _ctz32(safe_hi) + 1,
                    torch.full_like(lo, q + 1)))
    return bucket, rank


def hll_bucket_rank_np(keys: np.ndarray, precision: int = 14):
    """Numpy mirror of :func:`hll_bucket_rank`: the same (bucket, rank),
    int64."""
    p = precision
    q = 64 - p
    with np.errstate(over="ignore"):
        keys = np.asarray(keys).astype(np.uint32)
        h1 = murmur3_u32_np(keys, SEED_HLL_LO)
        h2 = murmur3_u32_np(keys, SEED_HLL_HI)
        bucket = (h1 & np.uint32((1 << p) - 1)).astype(np.int64)
        lo = (h1 >> np.uint32(p)) | (h2 << np.uint32(32 - p))
        hi = h2 >> np.uint32(p)

        def ctz(x):
            lsb = x & (np.uint32(0) - x)
            # log2 of a power of two <= 2^31 is exact in float64.
            safe = np.where(lsb == 0, 1, lsb)
            return np.log2(safe.astype(np.float64)).astype(np.int64)

        rank = np.where(
            lo != 0, ctz(lo) + 1,
            np.where(hi != 0, 32 + ctz(hi) + 1, q + 1))
    return bucket, rank


def hll_add_plain(regs: torch.Tensor, bank_idx: torch.Tensor,
                  keys: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  precision: int = 14) -> None:
    """Plain version of the K5 windowed PFADD: max-merge each key's rank
    into its bank register, in place (the JAX function returned new
    registers from a donated buffer). Lanes with ``bank_idx < 0``, a
    bank past the array, or a False ``mask`` are dropped."""
    num_banks, m = regs.shape
    bucket, rank = hll_bucket_rank(keys, precision)
    bank = bank_idx.to(torch.int64)
    keep = (bank >= 0) & (bank < num_banks)
    if mask is not None:
        keep = keep & mask
    flat = (bank * m + bucket)[keep]
    # uint8 scatter-max is not implemented for every device: reduce in
    # int32, then write the bytes back in place.
    cur = regs.view(-1).to(torch.int32)
    cur.scatter_reduce_(0, flat, rank[keep].to(torch.int32), reduce="amax")
    regs.view(-1).copy_(cur.to(torch.uint8))


def hll_add(regs: torch.Tensor, bank_idx: torch.Tensor, keys: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            precision: int = 14) -> None:
    """Batched PFADD into ``regs``, in place: the K5 kernel on a CUDA
    tensor, :func:`hll_add_plain` on a CPU one. ``bank_idx`` and
    ``keys`` are int32[B] (keys as uint32 bit patterns), ``mask`` an
    optional bool[B]."""
    # Imported here: ops.kernels builds its plain versions on this module.
    from attendance_tpu_torch.ops import kernels
    kernels.hll_add(regs, bank_idx, keys, mask, precision)


def hll_histogram(regs: torch.Tensor, precision: int = 14) -> torch.Tensor:
    """Plain version of the K1 histogram: int32[num_banks, q+2], one
    compare-and-sum per register value (the Pallas kernel's shape)."""
    num_bins = 64 - precision + 2
    return torch.stack([(regs == v).sum(dim=1, dtype=torch.int32)
                        for v in range(num_bins)], dim=1)


def best_histogram(regs: torch.Tensor, precision: int = 14) -> torch.Tensor:
    """Register-value histogram per bank: the K1 kernel on a CUDA
    tensor at any bank count, :func:`hll_histogram` on a CPU one."""
    # Imported here: ops.kernels builds its plain versions on this module.
    from attendance_tpu_torch.ops import kernels
    return kernels.hll_histogram(regs, precision)


def hll_histogram_rows_plain(regs: torch.Tensor, rows: torch.Tensor,
                            precision: int = 14) -> torch.Tensor:
    """Plain version of K1-rows: int32[R, q+2] histograms of banks
    ``rows`` (clamped into the bank range, as a JAX gather clamps)."""
    idx = rows.to(torch.int64).clamp(0, regs.shape[0] - 1)
    return hll_histogram(regs[idx], precision)


def hll_union_histogram_plain(regs: torch.Tensor, rows: torch.Tensor,
                              precision: int = 14) -> torch.Tensor:
    """Plain version of K1-union: int32[q+2] histogram of the register
    max over banks ``rows`` (clamped as in K1-rows)."""
    idx = rows.to(torch.int64).clamp(0, regs.shape[0] - 1)
    return hll_histogram(regs[idx].amax(dim=0, keepdim=True), precision)[0]


def hll_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PFMERGE: element-wise register max."""
    return torch.maximum(a, b)


def hll_merge_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`hll_merge` with bank-growth reconciliation:
    the shorter bank stack is zero-extended to the longer one (register
    0 is the identity of max)."""
    a = np.atleast_2d(np.asarray(a, dtype=np.uint8))
    b = np.atleast_2d(np.asarray(b, dtype=np.uint8))
    if a.shape[1] != b.shape[1]:
        raise ValueError(
            f"register widths differ ({a.shape[1]} vs {b.shape[1]}) — "
            "HLL precisions are not convertible")
    if a.shape[0] == b.shape[0]:
        return np.maximum(a, b)
    hi, lo = (a, b) if a.shape[0] > b.shape[0] else (b, a)
    out = hi.copy()
    np.maximum(out[:lo.shape[0]], lo, out=out[:lo.shape[0]])
    return out


def hll_histograms_np(rows: np.ndarray, precision: int = 14) -> np.ndarray:
    """Register-value histograms of host register rows: int64[n, q+2]
    from uint8[n, 2^p], in one bincount pass (each row's values offset
    into a disjoint bin range)."""
    rows = np.atleast_2d(np.asarray(rows, dtype=np.uint8))
    bins = 64 - precision + 2
    n = rows.shape[0]
    offsets = (np.arange(n, dtype=np.int64) * bins)[:, None]
    flat = np.bincount((rows.astype(np.int64) + offsets).ravel(),
                       minlength=n * bins)
    return flat.reshape(n, bins)


def estimates_from_rows(rows: np.ndarray, precision: int = 14
                        ) -> np.ndarray:
    """Ertl estimates of host register rows: float64[n]."""
    hists = hll_histograms_np(rows, precision)
    return np.array([estimate_from_histogram(h, precision)
                     for h in hists], dtype=np.float64)


def _sigma(x: float) -> float:
    """Ertl's sigma: sum used by the linear-counting-range correction."""
    if x == 1.0:
        return math.inf
    y = 1.0
    z = x
    while True:
        x = x * x
        z_prev = z
        z += x * y
        y += y
        if z == z_prev:
            return z


def _tau(x: float) -> float:
    """Ertl's tau: correction for saturated (rank > q) registers."""
    if x == 0.0 or x == 1.0:
        return 0.0
    y = 1.0
    z = 1.0 - x
    while True:
        x = math.sqrt(x)
        z_prev = z
        y *= 0.5
        z -= (1.0 - x) ** 2 * y
        if z == z_prev:
            return z / 3.0


def estimate_from_histogram(hist: np.ndarray, precision: int = 14) -> float:
    """Ertl improved raw estimator from a register histogram (host-side).

    hist[k] = number of registers whose value is k, k in [0, q+1].
    """
    p = precision
    q = 64 - p
    m = float(1 << p)
    C = np.asarray(hist, dtype=np.float64)
    if C.shape[-1] != q + 2:
        raise ValueError(f"expected {q + 2} bins, got {C.shape}")
    z = m * _tau((m - C[q + 1]) / m)
    for k in range(q, 0, -1):
        z += C[k]
        z *= 0.5
    z += m * _sigma(C[0] / m)
    alpha_inf = 1.0 / (2.0 * math.log(2.0))
    if z == 0.0 or math.isinf(z):
        return 0.0
    return alpha_inf * m * m / z


class HyperLogLog:
    """Register banks of named HLL keys on a device (the card unless
    ``device="cpu"``), with the host-side name -> bank map; the bank
    array grows by doubling when a new key needs a row. Bank numbering
    and growth are the JAX class's exactly (snapshots carry the map)."""

    def __init__(self, initial_banks: int = 8, precision: int = 14,
                 device=None):
        if not (4 <= precision <= 18):
            raise ValueError(f"precision out of range: {precision}")
        self.precision = precision
        self.regs = hll_init(max(1, initial_banks), precision,
                             resolve_device(device))
        self._bank_of: dict = {}

    def bank_index(self, name: str, create: bool = True) -> int:
        """The bank row of an HLL key, growing the array on demand; -1
        for an unknown key when ``create`` is False."""
        idx = self._bank_of.get(name)
        if idx is not None:
            return idx
        if not create:
            return -1
        idx = len(self._bank_of)
        if idx >= self.regs.shape[0]:
            # A fresh allocation, so the rows stay 16-byte aligned.
            grown = hll_init(self.regs.shape[0] * 2, self.precision,
                             self.regs.device)
            grown[:self.regs.shape[0]] = self.regs
            self.regs = grown
        self._bank_of[name] = idx
        return idx

    def _rows(self, idxs) -> torch.Tensor:
        return torch.tensor(idxs, dtype=torch.int32, device=self.regs.device)

    def add(self, bank_idx, keys, mask=None) -> None:
        """Max each key's rank into its bank's register (K5); a lane with
        bank -1 or a False ``mask`` is dropped."""
        dev = self.regs.device
        bank = torch.as_tensor(np.asarray(bank_idx, dtype=np.int32)).to(dev)
        keys = torch.from_numpy(np.ascontiguousarray(
            np.asarray(keys).astype(np.uint32)).view(np.int32)).to(dev)
        if mask is not None:
            mask = torch.from_numpy(np.asarray(mask, dtype=bool)).to(dev)
        hll_add(self.regs, bank, keys, mask, self.precision)

    def add_by_name(self, name: str, keys, mask=None) -> None:
        idx = self.bank_index(name)
        self.add(np.full(len(keys), idx, dtype=np.int32), keys, mask)

    def histograms(self, idxs) -> np.ndarray:
        """Host int32[len(idxs), q+2] histograms of the listed banks, one
        K1-rows launch on the card."""
        # Imported here: ops.kernels builds its plain versions on this
        # module.
        from attendance_tpu_torch.ops import kernels
        return kernels.hll_histogram_rows(
            self.regs, self._rows(idxs), self.precision).cpu().numpy()

    def count(self, name: str) -> int:
        """PFCOUNT of one HLL key (0 for an unknown key, as Redis)."""
        idx = self._bank_of.get(name)
        if idx is None:
            return 0
        hist = self.histograms([idx])[0]
        return int(round(estimate_from_histogram(hist, self.precision)))

    def count_union(self, names) -> int:
        """Multi-key PFCOUNT: register max over the keys' banks, then the
        estimate (one K1-union launch on the card)."""
        from attendance_tpu_torch.ops import kernels
        idxs = [self._bank_of[n] for n in names if n in self._bank_of]
        if not idxs:
            return 0
        hist = kernels.hll_union_histogram(
            self.regs, self._rows(idxs), self.precision).cpu().numpy()
        return int(round(estimate_from_histogram(hist, self.precision)))

    def keys(self):
        return list(self._bank_of)
