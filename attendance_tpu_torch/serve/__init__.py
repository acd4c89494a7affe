"""The query-serving plane: reads off an epoch-pinned host mirror.

Counterpart of ``attendance_tpu/serve/``, its core:

* :mod:`serve.mirror`: the epoch-pinned read view. The fused pipeline's
  host register mirror and its host Bloom words are published as
  immutable :class:`Epoch` objects; a publish is one reference swap, and
  a reader pins an epoch by holding it (no locks, nothing for the hot
  loop to wait on). Register buffers are double-buffered.
* :mod:`serve.engine`: a vectorized executor answering whole request
  batches from one pinned epoch, in host numpy (no device): BF.EXISTS
  through ``models.bloom.bloom_contains_words_np``, PFCOUNT and
  occupancy through one batched histogram pass over the mirrored rows,
  and the temporal window verbs.
* :mod:`serve.rpc`: the length-prefixed binary batch RPC, byte-compatible
  with the JAX package's, on the socket broker's framing and retry seam.
* :mod:`serve.http`: the same verbs as JSON routes behind the
  ``--metrics-port`` HTTP endpoint.
* :mod:`serve.chain`: merge-on-read over the on-disk snapshot chain, so
  a separate reader process serves without joining the ingest process
  (the ``serve`` verb).
* :mod:`serve.audit`: sampled read answers cross-checked against the
  exact shadow (``obs/audit``), the read path's measured FPR, false
  negatives and HLL error beside the write path's.

An epoch is published at preload, restore and every snapshot barrier,
so read staleness is bounded by the barrier cadence; answers always come
from one consistent epoch, never a mix; the
``attendance_read_staleness_seconds`` gauge exposes the current epoch's
age.
"""

from attendance_tpu_torch.serve.engine import NoEpoch, QueryEngine  # noqa: F401
from attendance_tpu_torch.serve.mirror import Epoch, ReadMirror  # noqa: F401
