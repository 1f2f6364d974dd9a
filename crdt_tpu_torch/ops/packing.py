"""HLC lane packing: scalar Hlc <-> (int64 lt, int32 node ordinal),
and the packed wire form.

A numpy-only copy of ``crdt_tpu/ops/packing.py`` (its Python paths):
`pack_rows`/`unpack_rows` frame a `PackedDelta` as the same bytes the
JAX package ships, so a torch replica and a JAX replica gossip through
either package's `pack_since` and `merge_packed`.
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

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..hlc import MAX_COUNTER, SHIFT, Hlc


def pack_logical_time(millis: int, counter: int) -> int:
    """(millis, counter) -> int64 logicalTime (hlc.dart:16)."""
    return (millis << SHIFT) + counter


def unpack_logical_time(lt: int) -> Tuple[int, int]:
    return lt >> SHIFT, lt & MAX_COUNTER


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

    def id_of(self, ordinal: int) -> Any:
        return self._sorted[ordinal]

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
        """Ordinals for already-interned ids (KeyError otherwise): one
        dict lookup per id, through the C codec's batch lookup where it
        loaded (`crdt_tpu_torch.native`), else the exact Python
        fallback."""
        from .. import native
        codec = native.load()
        if codec is not None:
            if not isinstance(node_ids, list):
                node_ids = list(node_ids)
            return np.frombuffer(
                codec.ordinals(node_ids, self._omap), np.int32)
        omap = self._omap
        return np.fromiter((omap[n] for n in node_ids), np.int32,
                           count=len(node_ids))


# Exact host lane dtypes of the PACKED wire form, in field order.
# Anything else from a peer is a protocol violation. The optional sixth
# lane (``sem``, uint8 semantics tags) rides only between peers that
# both have typed slots (``pack_since(sem_mode="include")``).
PACKED_LANE_DTYPES = ("int32", "int64", "int32", "int64", "uint8")
PACKED_SEM_DTYPE = "uint8"


class PackedDelta(NamedTuple):
    """Incremental columnar wire form: ONE row per modified slot, host
    numpy lanes in the exact wire dtypes. ``node`` carries ordinals into
    the ``node_ids`` list that travels beside the delta; ``modified``
    stamps are local-only and never serialized (record.dart:28-31).
    ``sem`` (None on all-LWW deltas) carries each row's semantics tag:
    the receiver checks the tags against its own per-slot column before
    merging, so two replicas never join one slot under two lattices."""

    slots: np.ndarray   # int32[k], unique
    lt: np.ndarray      # int64[k] packed logical times
    node: np.ndarray    # int32[k] ordinals into the wire node_ids
    val: np.ndarray     # int64[k] (0 where tombstoned)
    tomb: np.ndarray    # uint8[k] 0/1 tombstone flags
    sem: Optional[np.ndarray] = None  # uint8[k] semantics tags

    @property
    def k(self) -> int:
        return len(self.slots)

    @property
    def nbytes(self) -> int:
        return sum(lane.nbytes for lane in self if lane is not None)


def arena_of(lane: np.ndarray):
    """Walk a lane view's base chain to its owning allocation: the one
    uint8 arena for the lanes `pack_into_arena` produced, so a test can
    prove that every lane of a delta, and `pack_rows`' memoryviews,
    share that storage (no copy between pack and frame)."""
    a = lane
    while getattr(a, "base", None) is not None:
        a = a.base
    return a


def pack_into_arena(slots: np.ndarray, lt: np.ndarray, node: np.ndarray,
                    val: np.ndarray, tomb: np.ndarray,
                    sem: Optional[np.ndarray] = None) -> PackedDelta:
    """Land already-selected rows in ONE preallocated arena; the
    returned delta's lanes are aligned views into it, in the exact wire
    dtypes (``sem``, the rows' semantics tags, as a sixth lane when
    given). Unlike ``crdt_tpu``'s version, which gathers ``idx`` out of
    whole host columns, the rows arrive gathered: the port selects them
    on the device and copies only those ``k`` rows to the host."""
    specs = [("slots", np.dtype(np.int32)),
             ("lt", np.dtype(np.int64)),
             ("node", np.dtype(np.int32)),
             ("val", np.dtype(np.int64)),
             ("tomb", np.dtype(np.uint8))]
    lanes = [slots, lt, node, val, tomb]
    if sem is not None:
        specs.append(("sem", np.dtype(np.uint8)))
        lanes.append(sem)
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
    for (name, _), lane in zip(specs, lanes):
        views[name][:] = lane           # cast-assign into the arena
    return PackedDelta(**views)


def pack_rows(delta) -> Tuple[dict, List[memoryview]]:
    """``(meta, bufs)`` for a packed delta: lane descriptors plus host
    buffers in field order, the JAX package's raw binary frame; the
    ``sem`` lane is appended only when present. A lane already in its
    wire dtype, flat and contiguous (every `pack_into_arena` lane) is
    framed as a view of its own storage; any other lane is copied once
    into its wire dtype."""
    lanes = list(delta[:5])
    fields = list(PackedDelta._fields[:5])
    dtypes = list(PACKED_LANE_DTYPES)
    sem = getattr(delta, "sem", None)
    if sem is not None:
        lanes.append(sem)
        fields.append("sem")
        dtypes.append(PACKED_SEM_DTYPE)
    arrs = []
    copied = 0
    for lane, dtype in zip(lanes, dtypes):
        want = np.dtype(dtype)
        if not (isinstance(lane, np.ndarray) and lane.dtype == want
                and lane.ndim == 1 and lane.flags.c_contiguous):
            # crdtlint: disable=pack-path-extra-copy -- normalizing a foreign lane (wrong dtype/layout) is the one legitimate pack-path copy; counted below so regressions still surface
            lane = np.ascontiguousarray(np.asarray(lane), want)
            copied += lane.nbytes
        arrs.append(lane)
    if copied:
        from ..obs.registry import default_registry
        default_registry().counter(
            "crdt_tpu_pack_copy_bytes_total",
            "bytes copied between pack and frame (zero on the "
            "arena fast path)").inc(copied, stage="pack_rows")
    meta = {"form": "packed",
            "lanes": [[f, str(a.dtype), [len(a)]]
                      for f, a in zip(fields, arrs)]}
    return meta, [a.data.cast("B") for a in arrs]


def unpack_rows(meta: Any, blob: bytes) -> PackedDelta:
    """Validate and rebuild the packed delta a peer announced. Raises
    ValueError on any structural violation (wrong fields or dtypes,
    ragged lane lengths, frame size mismatch) BEFORE the replica is
    touched. ``k == 0`` is a legal empty delta. Takes the 5-lane form
    and the 6-lane form with the trailing ``sem`` tag lane. The lanes
    are read-only views of ``blob``."""
    if not isinstance(meta, dict) or meta.get("form") != "packed":
        raise ValueError("bad packed meta")
    lanes_meta = meta.get("lanes")
    base = list(PackedDelta._fields[:5])
    if not isinstance(lanes_meta, list) \
            or [l[0] for l in lanes_meta] not in (base, base + ["sem"]):
        raise ValueError("packed lane fields mismatch")
    want_dtypes = PACKED_LANE_DTYPES + (
        (PACKED_SEM_DTYPE,) if len(lanes_meta) == 6 else ())
    lanes = []
    off = 0
    k = None
    for (_, dt, shape), want in zip(lanes_meta, want_dtypes):
        if dt != want:
            raise ValueError(f"lane dtype {dt!r} != expected {want!r}")
        if not isinstance(shape, list) or len(shape) != 1 \
                or int(shape[0]) < 0:
            raise ValueError("bad packed lane shape")
        n = int(shape[0])
        if k is None:
            k = n
        elif n != k:
            raise ValueError("ragged packed lanes")
        a = np.frombuffer(blob, np.dtype(dt), count=n, offset=off)
        off += a.nbytes
        lanes.append(a)
    if off != len(blob):
        raise ValueError(f"packed frame size mismatch: lanes describe "
                         f"{off} bytes, frame holds {len(blob)}")
    return PackedDelta(*lanes)


def pack_hlcs(hlcs: Sequence[Hlc], table: NodeTable
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar Hlcs -> (lt int64, node int32) lanes. Ids must be interned."""
    lt = np.array([h.logical_time for h in hlcs], dtype=np.int64)
    node = table.encode([h.node_id for h in hlcs])
    return lt, node


def unpack_hlc(lt: int, node_ord: int, table: NodeTable) -> Hlc:
    return Hlc.from_logical_time(int(lt), table.id_of(int(node_ord)))
