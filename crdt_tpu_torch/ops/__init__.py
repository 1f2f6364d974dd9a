"""Tensor operations of the port: lanes, folds and the kernel wrappers.

Everything here works on the columnar HLC form: an HLC is carried as
``lt`` (int64, ``(millis << 16) | counter``, the reference's own
logicalTime packing, hlc.dart:16) and ``node`` (int32, the ordinal of
the node id in a per-store `NodeTable`, order-preserving, so the
lexicographic ``(lt, node)`` compare is ``Hlc.compareTo``,
hlc.dart:158-161).

The package surface is ``crdt_tpu.ops``'s without its Pallas entries:
the general-key `Store` ops (`merge`), the dense store and its fan-in
(`dense`; `fanin_step` and `fanin_stream` are the wrappers of
`stream_kernel`, the hand kernel on the card), and the Merkle digest
(`digest`). The split wire lanes the Pallas entries carried are in
`ops.split`.
"""

from .packing import (NodeTable, pack_logical_time,
                      unpack_logical_time)
from .merge import (Changeset, MergeResult, Store, delta_mask, empty_store,
                    grow_store, max_logical_time, merge_step)
from .dense import (DenseChangeset, DenseStore, FaninResult,
                    dense_delta_mask, dense_max_logical_time,
                    dense_range_delta_mask, empty_dense_store,
                    store_to_changeset)
from .stream_kernel import fanin_step, fanin_stream
from .digest import (DEFAULT_LEAF_WIDTH, DigestTree, build_digest_tree,
                     coalesce_leaf_ranges, digest_tree_device,
                     walk_divergent_leaves)

__all__ = [
    "NodeTable", "pack_logical_time", "unpack_logical_time",
    "Store", "Changeset", "MergeResult", "merge_step", "empty_store",
    "grow_store", "max_logical_time", "delta_mask",
    "DenseStore", "DenseChangeset", "FaninResult", "empty_dense_store",
    "fanin_step", "fanin_stream", "dense_delta_mask",
    "dense_range_delta_mask", "dense_max_logical_time",
    "store_to_changeset",
    "DigestTree", "DEFAULT_LEAF_WIDTH", "digest_tree_device",
    "build_digest_tree", "walk_divergent_leaves",
    "coalesce_leaf_ranges",
]
