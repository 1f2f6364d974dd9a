"""The slot-indexed lattice-join merge, and clock absorption on device.

Port of ``crdt_tpu/ops/merge.py``. The reference's sequential
three-pass merge loop (crdt.dart:77-94) collapses into data-parallel
stages with no sequential carry:

1. **Clock absorption** (crdt.dart:82): the per-record ``Hlc.recv`` fold
   reduces to ``new_canonical = max(canonical, max(remote_lt))``; the
   recv guards (`recv_guards`) run as masks against the running
   canonical, and the caller raises from the reduced flags.
2. **LWW filter** (crdt.dart:83-84): gather the local lanes at the
   remote slots; a remote record wins iff the local slot is absent or
   ``(l_lt, l_node) < (r_lt, r_node)``, so local keeps an exact tie.
3. **Re-stamp and scatter** (crdt.dart:86-90): winners keep the remote
   event hlc, their ``modified`` lanes take the final canonical time.

`Store` is the general-key layout: one slot per key, the key-to-slot
map on the host (`TpuMapCrdt.store` is such a mirror). Its ops are
plain functions on tensors, on the lanes' own device, each counted in
`obs.device.OPS`:

- `merge_step` and `scatter_put` address slots through a changeset.
  The JAX versions gather with ``mode="fill"`` and scatter with
  ``mode="drop"``; here the indices are masked instead, so no tensor
  is ever indexed out of range (a CPU raise, a device-side assert on
  the card). An index in ``[-capacity, 0)`` counts from the end, as
  JAX's indexing does; anything else out of range reads as an absent
  slot and writes nothing. Both ops take UNIQUE slots among the entries
  they write (the JAX audit declares them unique-slot): which of two
  writes to one slot lands is unspecified in both packages.
- `max_logical_time` and `delta_mask` are the clock rebuild's reduction
  and the delta filter.

`recv_guards` and `send_step` serve the dense replication loop: the
vectorized recv guard masks (a record reaches recv's slow path iff its
lt exceeds the running canonical, the exclusive cumulative max, because
the fast path skips every check when the clock is already ahead,
hlc.dart:85) and ``Hlc.send`` on a packed logicalTime, returning guard
flags instead of raising so a pipelined window keeps the clock on the
device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from ..hlc import MAX_COUNTER, MAX_DRIFT, SHIFT
from ..obs import device as _obs_device
from ..utils.devices import resolve_device

_NEG = -(2 ** 62)

Scalar = Union[int, torch.Tensor]


class Store(NamedTuple):
    """Columnar record store: one slot per key, the key <-> slot map on
    the host. Values live in a host payload table indexed by slot; they
    never enter the join."""
    lt: torch.Tensor        # int64[C] record hlc logicalTime
    node: torch.Tensor      # int32[C] record hlc node ordinal
    mod_lt: torch.Tensor    # int64[C] modified logicalTime (local-only)
    mod_node: torch.Tensor  # int32[C] modified node ordinal
    occupied: torch.Tensor  # bool[C]
    tomb: torch.Tensor      # bool[C] value is None (record.dart:17)

    @property
    def capacity(self) -> int:
        return self.lt.shape[0]


class Changeset(NamedTuple):
    """A padded batch of remote records addressed to store slots."""
    slot: torch.Tensor   # int32[M] target slot; ignored when ~valid
    lt: torch.Tensor     # int64[M]
    node: torch.Tensor   # int32[M]
    tomb: torch.Tensor   # bool[M]
    valid: torch.Tensor  # bool[M]


class MergeResult(NamedTuple):
    win: torch.Tensor            # bool[M] remote record was adopted
    new_canonical: torch.Tensor  # int64 scalar (before the final send)
    any_bad: torch.Tensor        # bool: some recv guard tripped
    first_bad: torch.Tensor      # int32 index of the first offender
    first_is_dup: torch.Tensor   # bool: duplicate node (vs drift) there
    canonical_at_fail: torch.Tensor  # int64 canonical BEFORE it


STORE_DTYPES = {"lt": torch.int64, "node": torch.int32,
                "mod_lt": torch.int64, "mod_node": torch.int32,
                "occupied": torch.bool, "tomb": torch.bool}


def empty_store(capacity: int, device=None) -> Store:
    """An all-absent store of ``capacity`` slots on ``device`` (None
    means the card, and raises without one)."""
    dev = resolve_device(device)
    return Store(**{f: torch.zeros(capacity, dtype=dt, device=dev)
                    for f, dt in STORE_DTYPES.items()})


def grow_store(store: Store, capacity: int) -> Store:
    """The store padded with absent slots up to ``capacity``."""
    pad = capacity - store.capacity
    assert pad >= 0
    if pad == 0:
        return store
    return Store(*(torch.cat([lane, lane.new_zeros(pad)]) for lane in store))


def _slot_index(slot: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(index, in_range)``: slots in ``[-capacity, 0)`` count from the
    end, as JAX's indexing does; ``index`` is clamped into the store
    wherever ``in_range`` is False, so a gather never leaves it."""
    idx = slot.long()
    idx = torch.where(idx < 0, idx + capacity, idx)
    ok = (idx >= 0) & (idx < capacity)
    return torch.where(ok, idx, 0), ok


def _scatter(store: Store, idx: torch.Tensor, write: torch.Tensor,
             rows: dict) -> Store:
    """A new store with ``rows[f][i]`` written at ``idx[i]`` wherever
    ``write[i]``. Skipped entries aim at one spare slot past the end,
    which is cut off again: no host sync to select the rows."""
    cap = store.capacity
    target = torch.where(write, idx, cap)
    out = {}
    for f, lane in zip(Store._fields, store):
        ext = torch.cat([lane, lane.new_zeros(1)])
        src = rows[f]
        if not isinstance(src, torch.Tensor) or src.dim() == 0:
            src = torch.as_tensor(src, dtype=lane.dtype,
                                  device=lane.device).expand(target.shape)
        ext.index_put_((target,), src.to(lane.device, lane.dtype))
        out[f] = ext[:cap]
    return Store(**out)


def recv_guards(lt: torch.Tensor, node: torch.Tensor, valid: torch.Tensor,
                canonical_lt: Scalar, local_node: Scalar,
                wall_millis: Scalar
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Guard masks over a record batch (any shape; visited flattened in
    row-major order). It trips duplicate-node if a slow-path record
    carries the local ordinal (hlc.dart:88-90), else drift if it is
    more than 60 s ahead of the wall (hlc.dart:92-94). Returns
    ``(any_bad, first_bad, first_is_dup, canonical_at_fail)`` with a
    flat row-major ``first_bad`` index."""
    flat_lt = torch.where(valid, lt, _NEG).reshape(-1)
    incl = torch.cummax(flat_lt, 0).values
    excl = torch.cat([incl.new_full((1,), _NEG), incl[:-1]])
    running = torch.maximum(excl, torch.as_tensor(
        canonical_lt, dtype=torch.int64, device=lt.device))

    slow = valid.reshape(-1) & (flat_lt > running)
    dup = slow & (node.reshape(-1) == local_node)
    drift = slow & ~dup & ((flat_lt >> SHIFT) - wall_millis > MAX_DRIFT)
    bad = dup | drift
    # argmax returns the FIRST maximal index: the first offender.
    first_bad = torch.argmax(bad.to(torch.uint8))
    return bad.any(), first_bad, dup[first_bad], running[first_bad]


def merge_step(store: Store, cs: Changeset, canonical_lt: Scalar,
               local_node: Scalar, wall_millis: Scalar
               ) -> Tuple[Store, MergeResult]:
    """One lattice-join step of a changeset into a store (the staging
    in the module docstring). Returns the new store (the input is not
    written) and the `MergeResult` flags; the caller raises on
    ``any_bad``. Slots must be unique among the valid entries."""
    _obs_device.note_op("merge_step")
    dev = store.lt.device
    canonical = torch.as_tensor(canonical_lt, dtype=torch.int64, device=dev)
    masked_lt = torch.where(cs.valid, cs.lt, _NEG)

    # --- stage 1: clock absorption and the recv guard masks ---
    any_bad, first_bad, first_is_dup, canonical_at_fail = recv_guards(
        cs.lt, cs.node, cs.valid, canonical, local_node, wall_millis)
    new_canonical = torch.maximum(canonical, masked_lt.max())

    # --- stage 2: LWW compare, strict (local wins ties); an absent or
    # out-of-range slot reads as (0, 0, unoccupied) ---
    idx, ok = _slot_index(cs.slot, store.capacity)
    l_lt = torch.where(ok, store.lt[idx], 0)
    l_node = torch.where(ok, store.node[idx], 0)
    l_occ = ok & store.occupied[idx]
    remote_newer = (cs.lt > l_lt) | ((cs.lt == l_lt) & (cs.node > l_node))
    win = cs.valid & (~l_occ | remote_newer)

    # --- stage 3: re-stamp winners and scatter (losers write nothing) ---
    new_store = _scatter(store, idx, win & ok, {
        "lt": cs.lt, "node": cs.node, "mod_lt": new_canonical,
        "mod_node": local_node, "occupied": True, "tomb": cs.tomb})
    return new_store, MergeResult(
        win=win, new_canonical=new_canonical, any_bad=any_bad,
        first_bad=first_bad.to(torch.int32), first_is_dup=first_is_dup,
        canonical_at_fail=canonical_at_fail)


def scatter_put(store: Store, cs: Changeset, mod_lt, mod_node) -> Store:
    """Raw storage-slot write (putRecords, crdt.dart:150-155): the valid
    records land with no clock logic and the given ``modified`` lanes
    (per entry, or one scalar each). Slots must be unique among the
    valid entries."""
    _obs_device.note_op("scatter_put")
    idx, ok = _slot_index(cs.slot, store.capacity)
    return _scatter(store, idx, cs.valid & ok, {
        "lt": cs.lt, "node": cs.node, "mod_lt": mod_lt,
        "mod_node": mod_node, "occupied": True, "tomb": cs.tomb})


def max_logical_time(store: Store) -> torch.Tensor:
    """refreshCanonicalTime's reduction (crdt.dart:114-121): the largest
    stored record logicalTime, 0 for an empty store."""
    _obs_device.note_op("max_logical_time")
    return torch.where(store.occupied, store.lt, 0).max()


def delta_mask(store: Store, since_lt: Scalar) -> torch.Tensor:
    """modifiedSince filter: INCLUSIVE bound on the modified lane
    (map_crdt.dart:44-45)."""
    _obs_device.note_op("delta_mask")
    return store.occupied & (store.mod_lt >= since_lt)


def send_step(lt: torch.Tensor, wall_millis: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``Hlc.send`` on a packed int64 logicalTime, on device
    (hlc.dart:51-74 on the lane encoding): millis = max(stored, wall),
    the counter increments iff millis is unchanged, else resets — on
    the packed form ``lt + 1`` vs ``wall << 16``. Returns ``(new_lt,
    overflow, drift)`` guard FLAGS instead of raising; on overflow the
    clock stays put, as the host path leaves it when it raises."""
    ms = lt >> SHIFT
    stay = ms >= wall_millis
    overflow = stay & ((lt & MAX_COUNTER) == MAX_COUNTER)
    new_lt = torch.where(overflow, lt,
                         torch.where(stay, lt + 1,
                                     torch.full_like(lt,
                                                     wall_millis << SHIFT)))
    drift = ms - wall_millis > MAX_DRIFT
    return new_lt, overflow, drift
