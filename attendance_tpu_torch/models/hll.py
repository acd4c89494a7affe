"""HyperLogLog register banks on torch tensors (PFADD / PFCOUNT).

Counterpart of ``attendance_tpu/models/hll.py``. All HLL keys live in one
``uint8[num_banks, 2^p]`` tensor, bank b being HLL key b. The 64-bit hash
domain of Redis dense HLL is assembled from two murmur3 lanes: bucket =
low p bits of h1; rank = 1 + count-trailing-zeros of the (64-p)-bit
pattern (bits p..31 of h1, then h2), capped at q + 1 = 65 - p.

PFADD outside the fused step (the temporal plane's window add) is the K5
kernel on a CUDA tensor, :func:`hll_add_plain` on a CPU one. PFCOUNT is
a register-value histogram per bank (the K1 kernel on a CUDA tensor,
:func:`hll_histogram` on a CPU one) followed by Ertl's improved raw
estimator on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from attendance_tpu_torch.ops.murmur3 import (
    MASK32, SEED_HLL_HI, SEED_HLL_LO, murmur3_u32)


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
