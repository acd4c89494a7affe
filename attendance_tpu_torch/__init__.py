"""attendance_tpu_torch: the PyTorch/CUDA port of attendance_tpu.

The JAX package ``attendance_tpu`` stays the reference; this package runs
the same fused hot path (roster preload, one fused Bloom + HLL step per
frame, PFCOUNT) and its temporal plane (windowed HLL buckets, watermarked
reorder, Count-Min top-K) on an NVIDIA Hopper card, with hand-written
CUDA kernels for the device programs (``csrc/sketch_kernels.cu``). It imports torch
and numpy, never jax and nothing of ``attendance_tpu``.

Entry points run on the CUDA card unless given ``device="cpu"``; see
:mod:`attendance_tpu_torch.device`.
"""

from attendance_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
