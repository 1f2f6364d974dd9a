"""HLC lane packing: scalar Hlc <-> (int64 lt, int32 node ordinal).

A numpy-only copy of ``crdt_tpu/ops/packing.py`` (its Python paths).
The hard part is an order-preserving node-id encoding: ``Hlc.compareTo``
tie-breaks on the node id's natural comparison (hlc.dart:160), which for
arbitrary strings cannot be embedded into a fixed-width integer. Each
store keeps a :class:`NodeTable` — a sorted dictionary of every node id
it has seen — and carries the *ordinal* in the lane, so ordinal
comparison equals id comparison. When a new id lands between existing
ones, ordinals shift; the table reports a remap vector so stored lanes
can be re-encoded with one gather.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np


class NodeTable:
    """Order-preserving node-id interning for one store: ordinals are
    indices into the sorted id list (hlc.dart:158-161 tie-break)."""

    def __init__(self, ids: Optional[Sequence[Any]] = None):
        self._sorted: List[Any] = sorted(set(ids)) if ids else []
        self._omap = {v: i for i, v in enumerate(self._sorted)}

    def __len__(self) -> int:
        return len(self._sorted)

    def __contains__(self, node_id: Any) -> bool:
        return node_id in self._omap

    def ordinal(self, node_id: Any) -> int:
        """Ordinal of an already-interned id."""
        return self._omap[node_id]

    def ids(self) -> List[Any]:
        """All interned ids in ordinal order (a copy)."""
        return list(self._sorted)

    def intern(self, node_ids: Sequence[Any]) -> Optional[np.ndarray]:
        """Add any unseen ids. Returns an int32 remap vector mapping old
        ordinal -> new ordinal if existing ordinals shifted, else None.
        Apply it to stored node lanes via ``remap[lane]``."""
        new = sorted(set(node_ids) - set(self._sorted))
        if not new:
            return None
        old = self._sorted
        merged = sorted(old + new)
        positions = {v: i for i, v in enumerate(merged)}
        remap = np.fromiter((positions[v] for v in old), np.int32,
                            count=len(old))
        self._sorted = merged
        self._omap = positions
        if np.array_equal(remap, np.arange(len(old), dtype=np.int32)):
            return None  # new ids all sort after existing ones
        return remap

    def encode(self, node_ids: Sequence[Any]) -> np.ndarray:
        """Ordinals for already-interned ids (KeyError otherwise)."""
        omap = self._omap
        return np.fromiter((omap[n] for n in node_ids), np.int32,
                           count=len(node_ids))


class PackedDelta(NamedTuple):
    """Incremental columnar wire form: ONE row per modified slot, host
    numpy lanes in the exact wire dtypes. ``node`` carries ordinals into
    the ``node_ids`` list that travels beside the delta; ``modified``
    stamps are local-only and never serialized (record.dart:28-31).
    (The JAX form's optional ``sem`` tag lane comes with typed slots in
    a later slice.)"""

    slots: np.ndarray   # int32[k], unique
    lt: np.ndarray      # int64[k] packed logical times
    node: np.ndarray    # int32[k] ordinals into the wire node_ids
    val: np.ndarray     # int64[k] (0 where tombstoned)
    tomb: np.ndarray    # uint8[k] 0/1 tombstone flags

    @property
    def k(self) -> int:
        return len(self.slots)

    @property
    def nbytes(self) -> int:
        return sum(lane.nbytes for lane in self)


def pack_into_arena(slots: np.ndarray, lt: np.ndarray, node: np.ndarray,
                    val: np.ndarray, tomb: np.ndarray) -> PackedDelta:
    """Land already-selected rows in ONE preallocated arena; the
    returned delta's lanes are aligned views into it, in the exact wire
    dtypes. Unlike ``crdt_tpu``'s version, which gathers ``idx`` out of
    whole host columns, the rows arrive gathered: the port selects them
    on the device and copies only those ``k`` rows to the host."""
    specs = [("slots", np.dtype(np.int32)),
             ("lt", np.dtype(np.int64)),
             ("node", np.dtype(np.int32)),
             ("val", np.dtype(np.int64)),
             ("tomb", np.dtype(np.uint8))]
    k = int(len(slots))
    offs = []
    total = 0
    for _, dt in specs:
        total = -(-total // 8) * 8      # 8-byte-align every lane
        offs.append(total)
        total += k * dt.itemsize
    arena = np.empty(total, np.uint8)
    views = {name: arena[off:off + k * dt.itemsize].view(dt)
             for (name, dt), off in zip(specs, offs)}
    for name, lane in zip(("slots", "lt", "node", "val", "tomb"),
                          (slots, lt, node, val, tomb)):
        views[name][:] = lane           # cast-assign into the arena
    return PackedDelta(**views)
