"""Multi-device sketch state: the (dp, sp) mesh engine.

Counterpart of ``attendance_tpu/parallel``. Two axes:

  * "dp" (data parallel): batches split across replicas, each with its
    own copy of the filter (kept equal by an OR at preload) and private
    HLL registers (united by an element-wise max when read, or after
    every step with ``replica_sync="step"``);
  * "sp" (sketch parallel): the filter's blocks and the registers'
    columns split across shards; each shard answers for its slice and
    the replica ANDs the answers.

``sharded.py`` holds the engine on a grid of torch devices,
``multihost.py`` the ``torch.distributed`` (gloo) setup that lets dp span
processes.
"""

from attendance_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh, ShardedSketchEngine, make_mesh)
