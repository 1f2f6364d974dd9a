"""Typed per-lane joins: one elementwise join for mixed semantics.

Port of ``crdt_tpu/semantics/kernels.py``. `ops.dense` joins every slot
by the LWW rule: a strict ``(lt, node)`` lexicographic compare, the
winner takes all lanes. A per-slot type tag lane (``sem``: int8, 0 =
LWW) generalizes that while the columnar store layout and the HLC
machinery stay as they are (the semidirect-product composition):

- the **clock lanes** (lt, node) always join by the strict lex max, so
  watermarks, ``pack_since`` deltas, recv guards and the canonical
  clock work unchanged on typed stores;
- the **value lane** joins by the tag's own sub-semilattice when both
  sides are present (counter max, per-half max, per-nibble max, top-4
  union), and by presence otherwise; for ``sem == 0`` the value follows
  the clock winner bit for bit (`ops.dense.wire_join_step`);
- the **tomb flag** is the clock winner's: deletion stays an
  LWW-resettable action on top of the typed state.

Value-lane encodings (one int64; value_width must be 64):

====== === ===========================================================
name   tag encoding
====== === ===========================================================
lww      0 opaque payload; clock winner takes the lane
gcount   1 non-negative count; join = max
pncount  2 pos in bits 32..62, neg in bits 0..30; join = per-half max;
           user value = pos - neg
orset    3 causal-length set over 16 elements: 4-bit causal length per
           element; join = per-nibble max; element present iff its
           length is ODD; lengths saturate at 15
mvreg    4 top-4 concurrent 16-bit values (1..65535, 0 = empty) packed
           descending (bits 63:48 hold the largest); strictly newer lt
           wins outright, equal lt joins by dedup-union-top-4
====== === ===========================================================

These are plain torch functions on tensors (no hand kernel): the JAX
package runs them through XLA, not Pallas, and routes every typed store
away from its Pallas kernels. Each step counts one op in
`obs.device.OPS`. Where the JAX version donates the store, the wire
and sparse steps here update it in place; the fan-in step builds a new
store, since its caller may still refuse the merge on a guard.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..obs import device as _obs_device
from ..ops.dense import _NEG, DenseChangeset, DenseStore, Scalar
from ..ops.fanin_kernel import BatchResult
from ..ops.merge import recv_guards

# Wire tags. LWW MUST be 0: a store with no semantics column is
# all-zeros by construction, and the packed wire form omits the sem
# lane entirely for all-LWW stores.
SEM_LWW = 0
SEM_GCOUNTER = 1
SEM_PNCOUNTER = 2
SEM_ORSET = 3
SEM_MVREG = 4

_PN_HALF = (1 << 31) - 1     # 31-bit pos/neg halves; bit 63 stays 0
ORSET_UNIVERSE = 16          # elements per orset lane (4-bit lengths)
ORSET_MAX_LEN = 15           # causal-length saturation point
MVREG_K = 4                  # concurrent values kept per mvreg lane
MVREG_MAX = 0xFFFF           # 16-bit values, 0 reserved for "empty"

_NIBBLE_SHIFTS = tuple(range(0, 64, 4))
_MVREG_SHIFTS = (48, 32, 16, 0)


@functools.lru_cache(maxsize=None)
def _shift_lane(shifts: Tuple[int, ...], device: torch.device
                ) -> torch.Tensor:
    """The field shifts as an int64 lane on ``device``, made once."""
    return torch.tensor(shifts, dtype=torch.int64, device=device)


def _fields(val: torch.Tensor, shifts, mask: int) -> torch.Tensor:
    """``[..., len(shifts)]``: the ``mask``-wide fields of each lane at
    ``shifts`` (an arithmetic shift, then the mask: the top field comes
    out right whatever bit 63 holds)."""
    return (val.unsqueeze(-1) >> _shift_lane(shifts, val.device)) & mask


def _pack_fields(fields: torch.Tensor, shifts) -> torch.Tensor:
    """The inverse of `_fields` for fields that fit their width: each
    field shifted into place and summed. The fields occupy disjoint
    bits, so the wrapping sum is their OR (bit 63 included)."""
    return (fields << _shift_lane(shifts, fields.device)).sum(-1)


def _pn_join(l_val: torch.Tensor, r_val: torch.Tensor) -> torch.Tensor:
    pos = torch.maximum((l_val >> 32) & _PN_HALF, (r_val >> 32) & _PN_HALF)
    neg = torch.maximum(l_val & _PN_HALF, r_val & _PN_HALF)
    return (pos << 32) | neg


def _orset_join(l_val: torch.Tensor, r_val: torch.Tensor) -> torch.Tensor:
    """Per-nibble max of 16 packed causal lengths. The JAX version
    unrolls 16 shift/mask/max steps; here the nibbles are one trailing
    axis, so the join is a few launches whatever the universe."""
    return _pack_fields(torch.maximum(_fields(l_val, _NIBBLE_SHIFTS, 0xF),
                                      _fields(r_val, _NIBBLE_SHIFTS, 0xF)),
                        _NIBBLE_SHIFTS)


def _mvreg_union(l_val: torch.Tensor, r_val: torch.Tensor) -> torch.Tensor:
    """Dedup-union of two top-4 packs, keeping the 4 largest. Top-k
    after a union is a closure (top4(top4(a∪b)∪c) == top4(a∪b∪c)), so
    the equal-lt branch stays associative."""
    cand = torch.cat([_fields(l_val, _MVREG_SHIFTS, MVREG_MAX),
                      _fields(r_val, _MVREG_SHIFTS, MVREG_MAX)], -1)
    cand = torch.sort(cand, dim=-1, descending=True).values
    prev = torch.cat([torch.full_like(cand[..., :1], -1), cand[..., :-1]],
                     -1)
    keep = (cand != prev) & (cand > 0)        # first occurrence, nonzero
    # The running count of kept candidates. torch.cumsum along this short
    # innermost axis runs a slow scan per row on an H100 (6.7 ms at 2^20 x
    # 8); seven column adds give the same counts.
    rank = keep.to(torch.int64)
    for i in range(1, rank.shape[-1]):
        rank[..., i] += rank[..., i - 1]
    rank -= 1
    sel = keep & (rank < MVREG_K)
    shift = torch.clamp(48 - 16 * rank, 0, 48)
    return torch.where(sel, cand << shift, 0).sum(-1)


def _typed_val(sem: torch.Tensor, l_lt: torch.Tensor, r_lt: torch.Tensor,
               l_val: torch.Tensor, r_val: torch.Tensor,
               winner_val: torch.Tensor) -> torch.Tensor:
    """Value join for BOTH-PRESENT lanes by tag; unknown tags fall back
    to the clock winner's value (still a semilattice)."""
    mv = torch.where(l_lt == r_lt, _mvreg_union(l_val, r_val),
                     torch.where(r_lt > l_lt, r_val, l_val))
    out = winner_val
    out = torch.where(sem == SEM_GCOUNTER, torch.maximum(l_val, r_val), out)
    out = torch.where(sem == SEM_PNCOUNTER, _pn_join(l_val, r_val), out)
    out = torch.where(sem == SEM_ORSET, _orset_join(l_val, r_val), out)
    return torch.where(sem == SEM_MVREG, mv, out)


def typed_join_lanes(sem, l_lt, l_node, l_val, l_occ, l_tomb,
                     r_lt, r_node, r_val, r_tomb, r_valid
                     ) -> Tuple[torch.Tensor, ...]:
    """One elementwise typed join of remote lanes into local lanes.

    Returns ``(lt, node, val, tomb, occupied, win)``. ``win`` is the
    adoption mask LWW lanes use (strictly newer remote, exactly
    `ops.dense.wire_join_step`) and the CHANGED mask for typed lanes (a
    re-delivered or dominated typed row is a no-op, so its ``mod``
    stamp and its watch event must not fire)."""
    lt_m = torch.where(r_valid, r_lt, _NEG)
    node32 = r_node.to(torch.int32)
    val64 = r_val.to(torch.int64)
    # Strict (lt, node) compare: local wins exact ties (crdt.dart:84).
    remote_newer = (lt_m > l_lt) | ((lt_m == l_lt) & (node32 > l_node))
    take = r_valid & (~l_occ | remote_newer)

    lt_out = torch.where(take, lt_m, l_lt)
    node_out = torch.where(take, node32, l_node)
    tomb_out = torch.where(take, r_tomb, l_tomb)
    occ_out = l_occ | r_valid

    winner_val = torch.where(take, val64, l_val)
    both = l_occ & r_valid
    tval = torch.where(
        both, _typed_val(sem, l_lt, lt_m, l_val, val64, winner_val),
        torch.where(r_valid & ~l_occ, val64, l_val))
    lww = sem == SEM_LWW
    val_out = torch.where(lww, winner_val, tval)

    changed = r_valid & ((lt_out != l_lt) | (node_out != l_node)
                         | (val_out != l_val) | (tomb_out != l_tomb)
                         | ~l_occ)
    win = torch.where(lww, take, changed)
    return lt_out, node_out, val_out, tomb_out, occ_out, win


def typed_wire_join_step(store: DenseStore, sem: torch.Tensor,
                         lt: torch.Tensor, node: torch.Tensor,
                         val: torch.Tensor, tomb: torch.Tensor,
                         valid: torch.Tensor, stamp_lt: Scalar,
                         local_node: int
                         ) -> Tuple[DenseStore, torch.Tensor]:
    """Elementwise N-wide typed join of a slot-aligned wire delta, in
    place: `ops.dense.wire_join_step` plus the per-slot ``sem`` tag
    lane. Clock absorption and the recv guards are the caller's;
    ``stamp_lt`` stamps winners' ``modified`` lanes. For an all-zero
    ``sem`` lane the result equals `wire_join_step`'s. Returns
    ``(store, win)``, ``win`` over the N slots."""
    _obs_device.note_op("typed_wire_join_step")
    lt_o, node_o, val_o, tomb_o, occ_o, win = typed_join_lanes(
        sem, store.lt, store.node, store.val, store.occupied, store.tomb,
        lt, node, val, tomb, valid)
    for lane, new in ((store.lt, lt_o), (store.node, node_o),
                      (store.val, val_o), (store.occupied, occ_o),
                      (store.tomb, tomb_o)):
        lane.copy_(new)
    store.mod_lt.masked_fill_(win, stamp_lt)
    store.mod_node.masked_fill_(win, local_node)
    return store, win


def typed_sparse_join_step(store: DenseStore, sem_rows: torch.Tensor,
                           slot: torch.Tensor, lt: torch.Tensor,
                           node: torch.Tensor, val: torch.Tensor,
                           tomb: torch.Tensor, valid: torch.Tensor,
                           stamp_lt: Scalar, local_node: int
                           ) -> Tuple[DenseStore, torch.Tensor]:
    """O(k) typed slot-indexed join, in place: `ops.dense.
    sparse_fanin_step` with a per-ROW ``sem_rows`` tag lane (the caller
    gathers the store's tags at the delta's slots). Gathers the local
    rows, joins row-wise, and writes the MERGED rows back at the
    winning slots. The JAX version gathers with ``mode="fill"`` and
    scatters losing rows to the ``n_slots`` sentinel with
    ``mode="drop"``; here invalid (padding) rows read slot 0 and never
    win, and the winning rows are selected before the indexed writes,
    so no index of ``n_slots`` reaches the store (on the card it would
    be a device-side assert). Slots must be unique among valid rows.
    Returns ``(store, win)``, ``win`` over the k rows."""
    _obs_device.note_op("typed_sparse_join_step")
    at = torch.where(valid, slot, 0)
    lt_o, node_o, val_o, tomb_o, _occ, win = typed_join_lanes(
        sem_rows, store.lt[at], store.node[at], store.val[at],
        store.occupied[at], store.tomb[at], lt, node, val, tomb, valid)
    s = slot[win]
    store.lt[s] = lt_o[win]
    store.node[s] = node_o[win]
    store.val[s] = val_o[win]
    store.mod_lt[s] = stamp_lt
    store.mod_node[s] = local_node
    store.occupied[s] = True
    store.tomb[s] = tomb_o[win]
    return store, win


def typed_fold(store: DenseStore, sem: torch.Tensor, cs: DenseChangeset,
               stamp: Scalar, local_node: int
               ) -> Tuple[DenseStore, torch.Tensor]:
    """The typed join of every changeset row into ``store``, in row
    order (join associativity makes this the union join), as a NEW
    store: winners' ``modified`` lanes take ``stamp``. ``win`` is the
    changed-vs-original mask. One `typed_join_lanes` per row: the JAX
    version unrolls the same fold under jit. ``cs`` has at least one
    row, so every returned lane is a fresh tensor."""
    lt, node, val = store.lt, store.node, store.val
    occ, tomb = store.occupied, store.tomb
    for r in range(cs.lt.shape[0]):
        lt, node, val, tomb, occ, _w = typed_join_lanes(
            sem, lt, node, val, occ, tomb, cs.lt[r], cs.node[r],
            cs.val[r], cs.tomb[r], cs.valid[r])
    win = ((lt != store.lt) | (node != store.node) | (val != store.val)
           | (tomb != store.tomb) | (occ & ~store.occupied))
    return DenseStore(lt=lt, node=node, val=val,
                      mod_lt=store.mod_lt.masked_fill(win, stamp),
                      mod_node=store.mod_node.masked_fill(win, local_node),
                      occupied=occ, tomb=tomb), win


def typed_fanin_step(store: DenseStore, sem: torch.Tensor,
                     cs: DenseChangeset, canonical_lt: Scalar,
                     local_node: int, wall_millis: int,
                     stamp_lt: Optional[Scalar] = None
                     ) -> Tuple[DenseStore, BatchResult]:
    """R-replica typed fan-in: `ops.dense.fanin_step` plus the per-slot
    ``sem`` lane. The recv guards and the canonical absorption are the
    LWW fold's (the clock lanes are the same across semantics), and
    they are EXACT here; the fold applies the typed join per row.
    Returns ``(new_store, result)`` in the shape of the batch kernel's
    result (`ops.fanin_kernel.BatchResult`), the exact recv flag as
    ``any_dup`` and ``any_drift`` False, so the model's merge tail
    takes either route alike."""
    _obs_device.note_op("typed_fanin_step")
    new_canonical, flag = typed_guards(cs, canonical_lt, local_node,
                                       wall_millis)
    stamp = new_canonical if stamp_lt is None else stamp_lt
    new_store, win = typed_fold(store, sem, cs, stamp, local_node)
    return new_store, typed_result(new_canonical, win, cs, flag)


def typed_guards(cs: DenseChangeset, canonical_lt: Scalar, local_node: int,
                 wall_millis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(new_canonical, any_bad)`` of a changeset: the exact recv
    guards in row-major visit order and the absorbed canonical."""
    any_bad = recv_guards(cs.lt, cs.node, cs.valid, canonical_lt,
                          local_node, wall_millis)[0]
    canon = torch.as_tensor(canonical_lt, dtype=torch.int64,
                            device=cs.lt.device)
    return torch.maximum(canon, torch.where(cs.valid, cs.lt, _NEG).amax()
                         ), any_bad


def typed_result(new_canonical: torch.Tensor, win: torch.Tensor,
                 cs: DenseChangeset, any_bad: torch.Tensor) -> BatchResult:
    """A typed fold's outcome as a `BatchResult`."""
    return BatchResult(new_canonical=new_canonical, win=win,
                       basemax=torch.where(cs.valid, cs.lt, _NEG).amax(),
                       any_dup=any_bad,
                       any_drift=torch.zeros_like(any_bad))


def combine_wire_deltas(sem, a: dict, b: dict) -> dict:
    """Join two slot-aligned wire deltas into one by the SAME typed
    join the steps apply: the associativity ``combine`` of the law
    tests (a combine that disagrees with the join is exactly what the
    law search must catch). Takes and returns numpy lanes."""
    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype))

    lt, node, val, tomb, occ, _w = typed_join_lanes(
        t(sem), t(a["lt"], np.int64), t(a["node"], np.int32),
        t(a["val"], np.int64), t(a["valid"], bool), t(a["tomb"], bool),
        t(b["lt"], np.int64), t(b["node"]), t(b["val"]),
        t(b["tomb"], bool), t(b["valid"], bool))
    return {"lt": lt.numpy(), "node": node.numpy().astype(np.int32),
            "val": val.numpy(), "tomb": tomb.numpy(),
            "valid": occ.numpy()}
