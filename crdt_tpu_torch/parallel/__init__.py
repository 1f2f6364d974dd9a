"""Multi-device parallelism: replica fan-in and key-space sharding over a
mesh of torch devices. See `crdt_tpu_torch.parallel.fanin` for the
design; it also holds the sharded digest tree and compaction, and the
typed fan-in of a sharded store with typed slots. The
collective group join of the JAX package
(``crdt_tpu/parallel/collective.py``) is not ported yet."""

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
    "KEY_AXIS", "REPLICA_AXIS", "SLICE_AXIS", "FaninMesh",
    "ShardedChangeset", "ShardedFaninResult", "ShardedStore",
    "gather_lane", "gather_store", "make_fanin_mesh",
    "make_multislice_fanin_mesh", "make_sharded_fanin",
    "make_sharded_compact", "make_sharded_digest",
    "make_sharded_ingest", "make_sharded_typed_fanin", "replica_extent",
    "shard_changeset",
    "shard_store", "sharded_delta_mask",
    "sharded_max_logical_time",
]
