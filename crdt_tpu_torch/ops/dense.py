"""Dense slot-aligned store + N-replica fan-in lattice join, in torch.

Port of ``crdt_tpu/ops/dense.py``: the same lanes, the same sentinels
and the same tie rules, written as plain tensor functions. Slot ``i`` of
the store holds key ``i``; an ``[R, N]`` changeset batch (R replica
rows × N key slots) fans into the store in one fused reduction:

1. **Replica reduce**: per key slot, the winning remote record is the
   lexicographic ``(lt, node)`` maximum over the R axis, with the
   LOWEST replica index winning exact ties — what sequential pairwise
   merging produces (crdt.dart:77-94).
2. **LWW vs local** (crdt.dart:83-84): strict ``(lt, node)`` compare so
   local wins exact ties.
3. **Clock absorption + guards** (crdt.dart:82, hlc.dart:80-97):
   ``new_canonical = max(canonical, max valid lt)``; the guard masks run
   against the running canonical (`ops.merge.recv_guards`).
4. **Re-stamp** (crdt.dart:86-87): winners keep the remote event hlc;
   ``modified`` lanes get the final canonical time.

`fanin_step` is the exact-guard fold: the CPU oracle that the
hand-written kernel (`ops.fanin_kernel`) is held against. The local
write scatters update the store IN PLACE (the JAX versions donate the
old buffers to the same effect); the model clones a store it has handed
out before writing into it (`DenseCrdt._writable_store`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..obs import device as _obs_device
from .merge import recv_guards

_NEG = -(2 ** 62)
_I32_NEG = -(2 ** 31)

Scalar = Union[int, torch.Tensor]


class DenseStore(NamedTuple):
    """Key-slot-aligned columnar record store: slot i holds key i."""
    lt: torch.Tensor        # int64[N] record hlc logicalTime (0 = never set)
    node: torch.Tensor      # int32[N] record hlc node ordinal
    val: torch.Tensor       # int64[N] payload (scalar or host-table index)
    mod_lt: torch.Tensor    # int64[N] modified logicalTime (local-only)
    mod_node: torch.Tensor  # int32[N] modified node ordinal
    occupied: torch.Tensor  # bool[N]
    tomb: torch.Tensor      # bool[N] value is None (record.dart:17)

    @property
    def n_slots(self) -> int:
        return self.lt.shape[0]


class DenseChangeset(NamedTuple):
    """R replica changesets over the same N key slots, padded with
    ``valid=False``. Lane [r, k] is replica r's record for key k."""
    lt: torch.Tensor     # int64[R, N]
    node: torch.Tensor   # int32[R, N]
    val: torch.Tensor    # int64[R, N]
    tomb: torch.Tensor   # bool[R, N]
    valid: torch.Tensor  # bool[R, N]


class FaninResult(NamedTuple):
    new_canonical: torch.Tensor      # int64 scalar (pre final-send-bump)
    win_count: torch.Tensor          # int32 number of adopted records
    win: torch.Tensor                # bool[N] per-slot adopted mask
    any_bad: torch.Tensor            # bool — some recv guard tripped
    first_bad: torch.Tensor          # flat r-major index of first offender
    first_is_dup: torch.Tensor       # bool — duplicate-node (vs drift)
    canonical_at_fail: torch.Tensor  # int64 canonical BEFORE the offender


STORE_DTYPES: Dict[str, torch.dtype] = {
    "lt": torch.int64, "node": torch.int32, "val": torch.int64,
    "mod_lt": torch.int64, "mod_node": torch.int32,
    "occupied": torch.bool, "tomb": torch.bool}
CHANGESET_DTYPES: Dict[str, torch.dtype] = {
    "lt": torch.int64, "node": torch.int32, "val": torch.int64,
    "tomb": torch.bool, "valid": torch.bool}


def check_lanes(kernel: str, lanes: Dict[str, torch.Tensor],
                dtypes: Dict[str, torch.dtype], shape: Tuple[int, ...],
                device: torch.device) -> None:
    """Refuse what a kernel does not take: every lane must be a
    contiguous tensor of its dtype and ``shape`` on ``device``."""
    for name, lane in lanes.items():
        if lane.device != device or lane.dtype != dtypes[name] \
                or tuple(lane.shape) != shape or not lane.is_contiguous():
            raise ValueError(
                f"{kernel}: lane {name} must be a contiguous "
                f"{dtypes[name]} tensor of shape {shape} on {device}; got "
                f"{lane.dtype} {tuple(lane.shape)} on {lane.device}")


def check_rows(kernel: str, lanes: Dict[str, torch.Tensor],
               dtypes: Dict[str, torch.dtype], shape: Tuple[int, int],
               device: torch.device) -> int:
    """`check_lanes` for ``[R, N]`` lanes that may be column blocks of
    wider lanes (a key shard's block, taken in place): every row
    contiguous, every lane at one row stride ``ld >= N``. Returns
    ``ld``. Lanes with no rows hold nothing to read, whatever their
    strides."""
    r, n = shape
    ld = next(iter(lanes.values())).stride(0) if r > 1 else n
    for name, lane in lanes.items():
        if lane.device != device or lane.dtype != dtypes[name] \
                or tuple(lane.shape) != shape or ld < n \
                or (r and n > 1 and lane.stride(1) != 1) \
                or (r > 1 and lane.stride(0) != ld):
            raise ValueError(
                f"{kernel}: lane {name} must be a {dtypes[name]} tensor of "
                f"shape {shape} on {device} with contiguous rows at one "
                f"row stride; got {lane.dtype} {tuple(lane.shape)} strides "
                f"{lane.stride()} on {lane.device}")
    return ld


def empty_dense_store(n_slots: int, device="cpu") -> DenseStore:
    return DenseStore(**{
        f: torch.zeros((n_slots,), dtype=dt, device=device)
        for f, dt in STORE_DTYPES.items()})


def store_from_numpy(lanes, device="cpu") -> DenseStore:
    """The seven lanes as numpy arrays (the keys `checkpoint.save_dense`
    writes, in either package) -> a store on ``device``. Always copies:
    the store is written in place later and must not alias the
    caller's arrays."""
    return DenseStore(**{
        f: torch.tensor(np.asarray(lanes[f]), dtype=dt, device=device)
        for f, dt in STORE_DTYPES.items()})


def store_to_numpy(store: DenseStore) -> Dict[str, np.ndarray]:
    """A store -> its seven lanes as host numpy copies."""
    return {f: getattr(store, f).to("cpu", copy=True).numpy()
            for f in DenseStore._fields}


def lex_fold(cs: DenseChangeset, lt: torch.Tensor, node: torch.Tensor,
             val: torch.Tensor, tomb: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor]:
    """Fold the replica rows into per-key running-best lanes via the
    strict lexicographic (lt, node) compare, seeded with ``(lt, node,
    val, tomb)`` — the local store lanes (local keeps exact ties) or
    sentinels (pure reduce). Ties between rows go to the LOWEST row.

    Returns ``(lt, node, val, tomb, from_row)`` where ``from_row``
    marks keys whose running best came from a replica row."""
    from_row = torch.zeros(lt.shape, dtype=torch.bool, device=lt.device)
    for r in range(cs.lt.shape[0]):
        lt_r = torch.where(cs.valid[r], cs.lt[r], _NEG)
        # Mask node as well: at sentinel lt an invalid row must not win
        # the node tie-break against the sentinel seed.
        node_r = torch.where(cs.valid[r], cs.node[r], _I32_NEG)
        better = (lt_r > lt) | ((lt_r == lt) & (node_r > node))
        lt = torch.where(better, lt_r, lt)
        node = torch.where(better, cs.node[r], node)
        val = torch.where(better, cs.val[r], val)
        tomb = torch.where(better, cs.tomb[r], tomb)
        from_row = from_row | better
    return lt, node, val, tomb, from_row


def reduce_replicas(cs: DenseChangeset):
    """Stable lexicographic (lt, node) max over the replica axis:
    per-key ``(best_lt, best_node, best_val, best_tomb, any_valid)``.
    Keys with no valid record report ``(_NEG, _I32_NEG)``."""
    n = cs.lt.shape[1]
    dev = cs.lt.device
    return lex_fold(
        cs,
        torch.full((n,), _NEG, dtype=torch.int64, device=dev),
        torch.full((n,), _I32_NEG, dtype=torch.int32, device=dev),
        torch.zeros((n,), dtype=torch.int64, device=dev),
        torch.zeros((n,), dtype=torch.bool, device=dev))


def fanin_step(store: DenseStore, cs: DenseChangeset,
               canonical_lt: Scalar, local_node: int, wall_millis: int
               ) -> Tuple[DenseStore, FaninResult]:
    """One fused R-replica fan-in lattice join with EXACT recv guards
    (see module docstring) — the plain oracle of the batch kernel.
    Winners' ``modified`` lanes get the post-absorption canonical."""
    dev = store.lt.device
    any_bad, first_bad, first_is_dup, canonical_at_fail = recv_guards(
        cs.lt, cs.node, cs.valid, canonical_lt, local_node, wall_millis)
    canon = torch.as_tensor(canonical_lt, dtype=torch.int64, device=dev)
    new_canonical = torch.maximum(
        canon, torch.where(cs.valid, cs.lt, _NEG).amax())

    # Replica reduce + LWW join in ONE fold: seed the running best with
    # the local lanes (empty slots as _NEG so any valid remote beats
    # them; occupied slots win exact ties — the compare is strict).
    lt, node, val, tomb, win = lex_fold(
        cs, torch.where(store.occupied, store.lt, _NEG),
        store.node, store.val, store.tomb)
    new_store = DenseStore(
        lt=torch.where(win, lt, store.lt),
        node=torch.where(win, node, store.node),
        val=val,
        mod_lt=store.mod_lt.masked_fill(win, new_canonical),
        mod_node=store.mod_node.masked_fill(win, local_node),
        occupied=store.occupied | win,
        tomb=tomb,
    )
    return new_store, FaninResult(
        new_canonical=new_canonical,
        win_count=win.sum().to(torch.int32),
        win=win, any_bad=any_bad, first_bad=first_bad,
        first_is_dup=first_is_dup, canonical_at_fail=canonical_at_fail)


def dense_delta_mask(store: DenseStore, since_lt: Scalar) -> torch.Tensor:
    """modifiedSince filter — INCLUSIVE bound on the modified lane
    (map_crdt.dart:44-45)."""
    return store.occupied & (store.mod_lt >= since_lt)


def span_mask(n: int, los: torch.Tensor, his: torch.Tensor) -> torch.Tensor:
    """bool[n] on the spans' device: the union of the half-open slot
    spans ``[los[i], his[i])`` (``0 <= lo <= hi <= n``; empty and
    overlapping spans allowed). The JAX package tests every slot
    against every span, an ``[S, N]`` matrix that XLA fuses away and
    eager torch would not (16,384 spans over 2^20 slots are 16 GB of
    bools); a difference array (+1 at each ``lo``, -1 at each ``hi``)
    and its running sum give the same union in O(N + S)."""
    edges = torch.zeros(n + 1, dtype=torch.int32, device=los.device)
    one = torch.ones(los.shape, dtype=torch.int32, device=los.device)
    edges.index_add_(0, los, one)
    edges.index_add_(0, his, -one)
    return edges[:n].cumsum(0) > 0


def range_delta_mask(delta: torch.Tensor, los: torch.Tensor,
                     his: torch.Tensor) -> torch.Tensor:
    """A delta mask restricted to the union of the spans ``[los[i],
    his[i])``, the anti-entropy range pack: after a Merkle walk has
    localized divergence to a few leaf ranges, only those slots feed
    the pack. Counted as one ``range_delta_mask`` op."""
    _obs_device.note_op("range_delta_mask")
    return delta & span_mask(delta.shape[0], los, his)


def dense_range_delta_mask(store: DenseStore, since_lt: Scalar,
                           los: torch.Tensor, his: torch.Tensor
                           ) -> torch.Tensor:
    """`dense_delta_mask` restricted to the union of the half-open slot
    spans ``[los[i], his[i])``. ``since_lt = 0`` is a clock-unbounded
    range scan (every occupied slot has ``mod_lt > 0``)."""
    return range_delta_mask(dense_delta_mask(store, since_lt), los, his)


# --- columnar wire joins (merge_packed / merge_json / merge_records) ---
#
# The JAX package runs these through XLA: it scatters losing rows to the
# ``n_slots`` sentinel with ``mode="drop"``. Torch has no drop mode, and
# on the card an index of ``n_slots`` is a device-side assert, so the
# winning rows are selected with a mask before the indexed writes. The
# store is updated IN PLACE (the JAX versions donate it): the caller
# passes lanes it may write (`DenseCrdt._writable_store`). Slots must be
# unique among valid rows (the callers collapse repeats last-wins
# first); clock absorption and the recv guards are the caller's, run
# host-side in the payload's visit order before the join, and
# ``stamp_lt`` is the post-absorption canonical that winners' modified
# lanes take (crdt.dart:86-87).


def _sparse_fanin_body(store: DenseStore, slot: torch.Tensor,
                       lt: torch.Tensor, node: torch.Tensor,
                       val: torch.Tensor, tomb: torch.Tensor,
                       valid: torch.Tensor, stamp_lt: Scalar,
                       local_node: int) -> torch.Tensor:
    # Invalid (padding) rows read slot 0 and never win: the JAX gather's
    # fill, without an out-of-range index.
    at = torch.where(valid, slot, 0)
    l_lt, l_node = store.lt[at], store.node[at]
    # Strict (lt, node) compare: local wins exact ties (crdt.dart:84).
    remote_newer = (lt > l_lt) | ((lt == l_lt) & (node > l_node))
    win = valid & (~store.occupied[at] | remote_newer)
    s = slot[win]
    store.lt[s] = lt[win]
    store.node[s] = node[win]
    store.val[s] = val[win]
    store.mod_lt[s] = stamp_lt
    store.mod_node[s] = local_node
    store.occupied[s] = True
    store.tomb[s] = tomb[win]
    return win


def sparse_fanin_step(store: DenseStore, slot: torch.Tensor,
                      lt: torch.Tensor, node: torch.Tensor,
                      val: torch.Tensor, tomb: torch.Tensor,
                      valid: torch.Tensor, stamp_lt: Scalar,
                      local_node: int) -> Tuple[DenseStore, torch.Tensor]:
    """O(k) slot-indexed join of a k-row delta (``slot`` int64, rows
    with ``valid`` False are padding) into ``store``, in place: the
    wire-delta shape, where a 10-record sync into a 1M-slot replica
    must not touch 1M-wide lanes. Returns ``(store, win)``, ``win``
    over the k rows."""
    return store, _sparse_fanin_body(store, slot, lt, node, val, tomb,
                                     valid, stamp_lt, local_node)


def wire_join_step(store: DenseStore, lt: torch.Tensor, node: torch.Tensor,
                   val: torch.Tensor, tomb: torch.Tensor,
                   valid: torch.Tensor, stamp_lt: Scalar, local_node: int
                   ) -> Tuple[DenseStore, torch.Tensor]:
    """Elementwise N-wide join of a SLOT-ALIGNED delta (lane i is slot
    i's record, ``valid`` masking absent slots), in place: the large-k
    companion of `sparse_fanin_step`, no gather and no scatter. ``node``
    and ``val`` may arrive narrower (the JAX package's int16 / int32
    wire transfers) and widen here. Returns ``(store, win)``, ``win``
    over the N slots."""
    lt = torch.where(valid, lt, _NEG)
    node = node.to(torch.int32)
    # Strict (lt, node) compare: local wins exact ties (crdt.dart:84).
    remote_newer = (lt > store.lt) | ((lt == store.lt) & (node > store.node))
    win = valid & (~store.occupied | remote_newer)
    torch.where(win, lt, store.lt, out=store.lt)
    torch.where(win, node, store.node, out=store.node)
    torch.where(win, val.to(torch.int64), store.val, out=store.val)
    store.mod_lt.masked_fill_(win, stamp_lt)
    store.mod_node.masked_fill_(win, local_node)
    store.occupied.logical_or_(win)
    torch.where(win, tomb, store.tomb, out=store.tomb)
    return store, win


def merge_repack_step(store: DenseStore, slot: torch.Tensor,
                      lt: torch.Tensor, node: torch.Tensor,
                      val: torch.Tensor, tomb: torch.Tensor,
                      valid: torch.Tensor, stamp_lt: Scalar,
                      local_node: int, since_lt: Scalar
                      ) -> Tuple[DenseStore, torch.Tensor, torch.Tensor]:
    """`sparse_fanin_step` with the NEXT pack's delta mask (``occupied &
    mod_lt >= since_lt`` over the merged store, the inclusive bound of
    map_crdt.dart:44-45): the gossip relay's merge and repack in one
    call. Returns ``(store, win, mask)``, ``mask`` over the N slots."""
    win = _sparse_fanin_body(store, slot, lt, node, val, tomb, valid,
                             stamp_lt, local_node)
    return store, win, dense_delta_mask(store, since_lt)


def store_to_changeset(store: DenseStore,
                       since_lt: Optional[Scalar] = None
                       ) -> DenseChangeset:
    """Export a store as a 1-replica changeset (the outbound half of the
    anti-entropy round, crdt.dart:124-135): full state, or the delta of
    records with ``modified >= since_lt``. The lanes are views of the
    store's own."""
    valid = (store.occupied if since_lt is None
             else dense_delta_mask(store, since_lt))
    return DenseChangeset(lt=store.lt[None], node=store.node[None],
                          val=store.val[None], tomb=store.tomb[None],
                          valid=valid[None])


def dense_max_logical_time(store: DenseStore) -> torch.Tensor:
    """refreshCanonicalTime's reduction (crdt.dart:114-121): max stored
    logicalTime, 0 for an empty store."""
    if store.n_slots == 0:
        return torch.zeros((), dtype=torch.int64, device=store.lt.device)
    return torch.where(store.occupied, store.lt, 0).amax()


# --- local-write scatters (putAll/delete, crdt.dart:46-58), in place ---


def put_scatter(store: DenseStore, slots: torch.Tensor,
                values: torch.Tensor, t: int, me: int,
                tombs: Optional[torch.Tensor] = None) -> DenseStore:
    """Batch put: one shared HLC ``t`` + values at ``slots``. ``tombs``
    marks entries written as tombstones under the SAME batch stamp (a
    mixed putAll, crdt.dart:46-54 + delete-as-put-None)."""
    store.lt[slots] = t
    store.node[slots] = me
    store.val[slots] = values
    store.mod_lt[slots] = t
    store.mod_node[slots] = me
    store.occupied[slots] = True
    store.tomb[slots] = False if tombs is None else tombs
    return store


def delete_scatter(store: DenseStore, slots: torch.Tensor, t: int,
                   me: int) -> DenseStore:
    """Batch tombstone: one shared HLC at ``slots``; ``val`` keeps its
    old contents."""
    store.lt[slots] = t
    store.node[slots] = me
    store.mod_lt[slots] = t
    store.mod_node[slots] = me
    store.occupied[slots] = True
    store.tomb[slots] = True
    return store


def ingest_scatter(store: DenseStore, slots: torch.Tensor,
                   lt: torch.Tensor, val: torch.Tensor, tomb: torch.Tensor,
                   me: int) -> DenseStore:
    """Write-combiner commit, the plain version of the ingest kernel:
    every row whose slot is in range overwrites its slot with a PER-ROW
    hlc ``lt``, ``node = me``, ``val``, ``tomb``, ``mod_lt = lt``,
    ``mod_node = me`` and occupied. Rows with ``slot == n_slots`` are
    the power-of-two padding and write nothing. Slots must be unique
    (the combiner dedups last-wins)."""
    live = slots < store.n_slots
    s = slots[live]
    lt = lt[live]
    store.lt[s] = lt
    store.node[s] = me
    store.val[s] = val[live]
    store.mod_lt[s] = lt
    store.mod_node[s] = me
    store.occupied[s] = True
    store.tomb[s] = tomb[live]
    return store


def record_scatter(store: DenseStore, slots: torch.Tensor,
                   lt: torch.Tensor, node: torch.Tensor, val: torch.Tensor,
                   mod_lt: torch.Tensor, mod_node: torch.Tensor,
                   tomb: torch.Tensor) -> DenseStore:
    """Raw record writes keeping the given hlc and modified stamps, in
    place: the putRecords storage primitive (crdt.dart:151-155), no LWW
    compare and no clock. ``slots`` are unique and in range; the JAX
    package pads the rows to a power of two with ``n_slots`` sentinels
    that its scatter drops, and the port pads nothing, so no row can
    reach an index that on the card is a device-side assert."""
    store.lt[slots] = lt
    store.node[slots] = node
    store.val[slots] = val
    store.mod_lt[slots] = mod_lt
    store.mod_node[slots] = mod_node
    store.occupied[slots] = True
    store.tomb[slots] = tomb
    return store


# --- tombstone epoch GC and online compaction ---
#
# A tombstone is lattice state (the delete must dominate concurrent
# writes), so it can leave the store only once the fleet's stability
# watermark proves every peer's durable state dominates it. `gc_purge`
# clears those stable tombstones from every lane; `compact_remap` then
# packs the survivors to a dense prefix and rebuilds the digest tree.
# Plain torch on the store's device: the JAX package runs both through
# XLA, not Pallas.


def gc_purge(store: DenseStore, floor_lt: int
             ) -> Tuple[DenseStore, torch.Tensor, torch.Tensor]:
    """Epoch tombstone purge, in place: every lane of the tombstones
    whose record stamp is at or below ``floor_lt`` (inclusive: a durable
    watermark means delivered THROUGH the stamp) returns to the
    all-zero never-written state. ``floor_lt`` must come from a fleet
    stability watermark, and the caller arms its merge-side fence
    (`DenseCrdt.gc_purge`): this op alone cannot stop a delayed
    pre-purge delta from re-occupying the slot. Returns ``(store,
    purged_count int32, purged_mask)``; counted as one ``gc_purge``
    op."""
    _obs_device.note_op("gc_purge")
    purged = store.occupied & store.tomb & (store.lt <= floor_lt)
    for lane in store:
        lane.masked_fill_(purged, 0)
    return store, purged.sum(dtype=torch.int32), purged


def compact_targets(keep: torch.Tensor, los: torch.Tensor,
                    his: torch.Tensor) -> torch.Tensor:
    """int64[N]: where each slot's row goes when the kept rows of each
    span ``[los[i], his[i])`` (sorted, disjoint, non-empty) pack to the
    span's prefix; a slot outside every span stays where it is. The JAX
    package builds an ``[S, N]`` membership matrix; here each slot finds
    its span by ``searchsorted`` on the sorted ``los``, and its rank is
    a segmented count: the running count of kept rows less its value
    at the span's start."""
    n = keep.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=keep.device)
    if not len(los):
        return idx
    span = (torch.searchsorted(los, idx, right=True) - 1).clamp_(min=0)
    lo = los[span]
    inside = (idx >= lo) & (idx < his[span])
    before = torch.cumsum(keep, 0) - keep.to(torch.int64)  # kept in [0, i)
    return torch.where(inside, lo + before - before[lo], idx)


def remap_rows(store: DenseStore, keep: torch.Tensor,
               new_slot: torch.Tensor) -> DenseStore:
    """A new store holding the ``keep`` rows of ``store`` at
    ``new_slot`` (unique among kept rows) and empty slots elsewhere.
    The rows are selected before the indexed write: no row goes to a
    sentinel."""
    return DenseStore(*(remap_lane(lane, keep, new_slot) for lane in store))


def remap_lane(lane: torch.Tensor, keep: torch.Tensor,
               new_slot: torch.Tensor) -> torch.Tensor:
    """One lane of `remap_rows`: the ``keep`` entries at ``new_slot``,
    zeros elsewhere."""
    out = torch.zeros_like(lane)
    out[new_slot[keep]] = lane[keep]
    return out


def compact_remap(store: DenseStore, los: torch.Tensor, his: torch.Tensor,
                  sem: Optional[torch.Tensor] = None, *, leaf_width: int):
    """Online compaction: the surviving rows of each span ``[los[i],
    his[i])`` (sorted, disjoint: the caller validates) move to the dense
    prefix of their span, rows outside every span keep their slot, and
    the digest-tree levels of the result come back with it. ``sem`` is
    the optional per-slot semantics tag column, moved with the rows so
    typed lanes keep their joins (and mixed into the digest). Returns
    ``(new_store[, new_sem], translation, live_count, digest_levels)``:
    ``translation[old] = new`` (int32, ``-1`` for unoccupied slots) is
    what every external slot reference must be rewritten through.
    Counted as one ``compact_remap`` op."""
    from .digest import digest_levels_from_lanes
    _obs_device.note_op("compact_remap")
    keep = store.occupied
    new_slot = compact_targets(keep, los, his)
    out = remap_rows(store, keep, new_slot)
    new_sem = None if sem is None else remap_lane(sem, keep, new_slot)
    translation = torch.where(keep, new_slot, -1).to(torch.int32)
    levels = digest_levels_from_lanes(out.lt, out.val, out.tomb,
                                      out.occupied, sem=new_sem,
                                      leaf_width=leaf_width)
    live = keep.sum(dtype=torch.int32)
    if sem is None:
        return out, translation, live, levels
    return out, new_sem, translation, live, levels
