"""Multi-device parallelism: replica fan-in and key-space sharding over a
mesh of torch devices. See `crdt_tpu_torch.parallel.fanin` for the
design; it also holds the sharded digest tree and compaction, and the
typed fan-in of a sharded store with typed slots.
`crdt_tpu_torch.parallel.collective` holds the pod-local group join
over a 1-D member mesh."""

from .collective import (MEMBER_AXIS, CollectiveJoinResult,
                         make_collective_join, make_collective_mesh)
from .fanin import (KEY_AXIS, REPLICA_AXIS, SLICE_AXIS, FaninMesh,
                    ShardedChangeset, ShardedFaninResult, ShardedStore,
                    gather_lane, gather_store, make_fanin_mesh,
                    make_multislice_fanin_mesh, make_sharded_compact,
                    make_sharded_digest, make_sharded_fanin,
                    make_sharded_ingest, make_sharded_typed_fanin,
                    replica_extent, shard_changeset,
                    shard_store, sharded_delta_mask,
                    sharded_max_logical_time)

__all__ = [
    "KEY_AXIS", "MEMBER_AXIS", "REPLICA_AXIS", "SLICE_AXIS", "FaninMesh",
    "CollectiveJoinResult", "make_collective_join", "make_collective_mesh",
    "ShardedChangeset", "ShardedFaninResult", "ShardedStore",
    "gather_lane", "gather_store", "make_fanin_mesh",
    "make_multislice_fanin_mesh", "make_sharded_fanin",
    "make_sharded_compact", "make_sharded_digest",
    "make_sharded_ingest", "make_sharded_typed_fanin", "replica_extent",
    "shard_changeset",
    "shard_store", "sharded_delta_mask",
    "sharded_max_logical_time",
]
