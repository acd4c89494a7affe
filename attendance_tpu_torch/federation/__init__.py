"""Federated scale-out: sketch-native CRDT replication.

Counterpart of ``attendance_tpu/federation``. K ingest workers each own
a hash shard of the key space (``federation.shard``) and run the fused
pipeline unchanged; their sketch state replicates through fence gossip
(``federation.gossip``): every snapshot fence publishes the dirty-bank
delta its capture already made durable as a versioned merge frame
(``federation.frames``), and an aggregator folds the stream into one
global view (``federation.merge``) published as read epochs, which the
query plane serves. Bloom filters join under OR and HLL banks under
register max, so frame order, duplication and replay are harmless; only
the cumulative counters need ordering, newest (incarnation, seq) wins
per worker. Failover: a peer silent past the budget is declared dead,
its shard orphaned in the versioned shard map, its durable chain
recovered by the aggregator, and a takeover worker (same id, higher
incarnation) restores the same chain and drains the broker's requeued
remainder (``federation.worker --takeover``).
"""

from attendance_tpu_torch.federation.frames import (  # noqa: F401
    FRAME_VERSION, MergeFrame, decode_frame, encode_frame)
from attendance_tpu_torch.federation.gossip import (  # noqa: F401
    Aggregator, DEFAULT_GOSSIP_TOPIC, FenceGossip, GOSSIP_SUBSCRIPTION)
from attendance_tpu_torch.federation.merge import (  # noqa: F401
    GeometryMismatch, MergedView)
from attendance_tpu_torch.federation.shard import (  # noqa: F401
    ShardMap, shard_of_keys, shard_topic)
