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


def pad_replica_rows(cs: DenseChangeset, multiple: int) -> DenseChangeset:
    """Pad the replica axis with ``valid=False`` rows (all-zero lanes)
    up to a multiple of ``multiple``."""
    pad = (-cs.lt.shape[0]) % multiple
    if not pad:
        return cs
    return DenseChangeset(*(
        torch.cat([lane, lane.new_zeros((pad,) + lane.shape[1:])])
        for lane in cs))


def dense_delta_mask(store: DenseStore, since_lt: Scalar) -> torch.Tensor:
    """modifiedSince filter — INCLUSIVE bound on the modified lane
    (map_crdt.dart:44-45)."""
    return store.occupied & (store.mod_lt >= since_lt)


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
