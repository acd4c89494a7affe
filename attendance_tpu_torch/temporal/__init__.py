"""Temporal sketch plane of the port: windowed HLL buckets, watermarked
disorder handling and the Count-Min gate-fraud detector.

Counterpart of ``attendance_tpu/temporal``. Buckets are (day, period)
pairs encoded as synthetic bank keys (:mod:`.buckets`) living in the
same ``uint8[num_banks, 2^p]`` register tensor and the same ``bank_of``
map as the per-day banks. The reorder stage (:mod:`.reorder`) and the
ring bookkeeping (:mod:`.windows`) are host code; :mod:`.plane` wires
them into the fused pipeline behind one ``is not None`` branch.
"""

from attendance_tpu_torch.temporal.buckets import (  # noqa: F401
    BUCKET_KEY_BASE, bucket_key, decode_bucket_key, is_bucket_key)
