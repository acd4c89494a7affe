"""Multi-process meshes and ``torch.distributed`` initialization.

Counterpart of ``attendance_tpu/parallel/multihost.py``, on
``torch.distributed`` with the gloo backend. The sketch state is laid
out so the slow link does the least work:

  * "sp" (sketch shards) stays inside a process: the per-step validity
    AND never leaves it;
  * "dp" (replicas) spans processes: each process holds its own
    replicas' grid cells, and the cross-process legs of the collectives
    (the filter OR at preload, the register max, the counters' sum, the
    validity gather) run over gloo on host copies. With the deferred
    replica sync (``replica_sync="query"``, the default) no step runs a
    cross-process collective but the validity gather.

Multi-controller convention, as in JAX: every process feeds the same
full batch, and replica r takes lanes ``[r * local, (r + 1) * local)``.
No NCCL: two NCCL ranks cannot share one card, and the card's machine
has one. Single-process runs fall through to ``make_mesh``; the entry
points are no-ops outside a process group.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from attendance_tpu_torch.parallel.sharded import Mesh, make_mesh

logger = logging.getLogger(__name__)

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join (or form) a gloo process group; True when more than one
    process is in it afterwards.

    With ``coordinator_address`` ("host:port" or "tcp://host:port"),
    ``num_processes`` and ``process_id`` it joins that group, and a
    failed join raises. With no arguments it reads torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), as JAX reads its cluster environment, and without
    one it is a logged no-op that returns False. Safe to call again: an
    existing group is reported, not re-joined.
    """
    explicit = (num_processes, process_id)
    if coordinator_address is None and any(a is not None for a in explicit):
        raise ValueError(
            "num_processes/process_id require coordinator_address")
    if coordinator_address is not None and any(a is None for a in explicit):
        raise ValueError(
            "coordinator_address requires num_processes and process_id")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is not None:
        addr = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        dist.init_process_group("gloo", init_method=addr,
                                world_size=num_processes, rank=process_id)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group("gloo", init_method="env://")
    else:
        logger.debug("no process-group environment: running single-process")
        return False
    return dist.get_world_size() > 1


def make_multihost_mesh(num_shards: int = 1,
                        num_replicas: Optional[int] = None,
                        devices=None) -> Mesh:
    """A (dp, sp) mesh whose sp axis stays inside each process and whose
    dp axis spans the process group.

    ``devices`` are this process's devices (default: its CUDA devices).
    Multi-process: ``num_shards`` must divide their count (a shard group
    must not straddle processes), and ``num_replicas`` defaults to every
    process's replicas together (and must equal it). Single-process: as
    ``make_mesh``, with ``num_replicas`` defaulting to every device.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n_procs = dist.get_world_size() if dist.is_initialized() else 1
    if n_procs <= 1:
        if num_replicas is None:
            num_replicas = max(1, len(devices) // num_shards)
        return make_mesh(num_shards, num_replicas, devices)
    per_process = len(devices)
    if per_process == 0 or per_process % num_shards:
        raise ValueError(
            f"num_shards={num_shards} must divide the per-process device "
            f"count ({per_process}): a sharded sketch's per-step AND must "
            "stay inside a process")
    replicas_each = per_process // num_shards
    total = replicas_each * n_procs
    if num_replicas is None:
        num_replicas = total
    if num_replicas != total:
        raise ValueError(
            f"num_replicas={num_replicas} != processes * per-process "
            f"replicas ({total}); leave it unset to use every device")
    rank = dist.get_rank()
    mesh = Mesh([devices[r * num_shards:(r + 1) * num_shards]
                 for r in range(replicas_each)], dp=total,
                first_replica=rank * replicas_each, group=dist.group.WORLD)
    logger.info("multi-process mesh: %d processes x %d devices -> dp=%d "
                "sp=%d", n_procs, per_process, total, num_shards)
    return mesh
