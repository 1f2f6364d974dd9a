"""The split 32-bit wire lanes: how two dense JAX replicas talk.

Port's own copy of the interchange pieces of
``crdt_tpu/ops/pallas_merge.py``. The TPU kernels carried the 64-bit
logicalTime and payload as SPLIT ``(hi int32, lo uint32)`` lanes and
narrowed node/tomb to int16/int8; `DenseCrdt.export_split_delta` ships
that form to peers and `merge_split` reads it back with no conversion.
The port's store stays wide (int64 lanes on Hopper), but it speaks the
same wire lanes, in the same dtypes, so the two packages exchange the
same arrays:

- `SplitChangeset`: ``hi`` int32, ``lo`` uint32, ``node`` int16,
  ``val_hi`` int32, ``val_lo`` uint32, ``tomb`` int8;
- `NarrowSplitChangeset` (value-ref mode, ``value_width=32``): one
  int32 ``val`` lane, sign-extended into the 64-bit payload;
- `SplitStore`: the store in the same words (``tomb`` as int32), the
  form the kernel probes (`ops.probe`) read and write.

There is no valid lane: an invalid entry is the sentinel ``hi ==
NEG_HI`` (with ``lo == 0``, ``node == I16_NEG``). Lanes are ``[R, N]``
or tiled ``[R, N // lane, lane]``; in torch tiling is a reshape of a
contiguous tensor, a view, kept so the port emits the shapes JAX does.

Torch on the CPU has no comparisons or arithmetic on uint32, so every
plain function here widens ``lo`` to int64 before it computes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .dense import _NEG, DenseChangeset, DenseStore

# Sentinel words of _NEG = -(2**62): anything real compares greater.
NEG_HI = _NEG >> 32
NEG_LO = _NEG & 0xFFFFFFFF
# Node ordinals ride an int16 wire lane; I16_NEG marks an invalid entry.
I16_NEG = -(2 ** 15)
MAX_NODE_ORDINAL = 2 ** 15 - 1

# The TPU kernels' tile geometry (sublanes x lanes): the wire form is
# tiled at this lane width when n_slots is a multiple of TILE.
_SB = 8
_LANE = 512
TILE = _SB * _LANE

_U32 = 0xFFFFFFFF


class SplitChangeset(NamedTuple):
    """[R, N] split wire lanes, invalid entries pre-masked to sentinels."""
    hi: torch.Tensor      # int32 (NEG_HI = invalid)
    lo: torch.Tensor      # uint32
    node: torch.Tensor    # int16 (I16_NEG when invalid)
    val_hi: torch.Tensor  # int32
    val_lo: torch.Tensor  # uint32
    tomb: torch.Tensor    # int8


class NarrowSplitChangeset(NamedTuple):
    """[R, N] split wire lanes of the value-ref mode: one int32 ``val``
    lane, sign-extended into the store's int64 payload."""
    hi: torch.Tensor    # int32 (NEG_HI = invalid)
    lo: torch.Tensor    # uint32
    node: torch.Tensor  # int16 (I16_NEG when invalid)
    val: torch.Tensor   # int32
    tomb: torch.Tensor  # int8


class SplitStore(NamedTuple):
    """`DenseStore` with its 64-bit lanes split into 32-bit words.
    Slot empty iff ``hi == NEG_HI``."""
    hi: torch.Tensor        # int32 lt >> 32 (NEG_HI = empty)
    lo: torch.Tensor        # uint32 lt & 0xFFFFFFFF
    node: torch.Tensor      # int32
    val_hi: torch.Tensor    # int32
    val_lo: torch.Tensor    # uint32
    tomb: torch.Tensor      # int32 0/1
    mod_hi: torch.Tensor    # int32
    mod_lo: torch.Tensor    # uint32
    mod_node: torch.Tensor  # int32


SPLIT_STORE_DTYPES = {
    "hi": torch.int32, "lo": torch.uint32, "node": torch.int32,
    "val_hi": torch.int32, "val_lo": torch.uint32, "tomb": torch.int32,
    "mod_hi": torch.int32, "mod_lo": torch.uint32, "mod_node": torch.int32}

SPLIT_DTYPES = {"hi": torch.int32, "lo": torch.uint32, "node": torch.int16,
                "val_hi": torch.int32, "val_lo": torch.uint32,
                "val": torch.int32, "tomb": torch.int8}


def _split64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (x >> 32).to(torch.int32), (x & _U32).to(torch.uint32)


def join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``(hi << 32) | lo`` as int64 (``lo`` widened first)."""
    return (hi.long() << 32) | lo.long()


def split_store(store: DenseStore) -> SplitStore:
    """Wide store -> split words; an unoccupied slot's key becomes the
    sentinel ``_NEG``."""
    hi, lo = _split64(torch.where(store.occupied, store.lt, _NEG))
    val_hi, val_lo = _split64(store.val)
    mod_hi, mod_lo = _split64(store.mod_lt)
    return SplitStore(hi=hi, lo=lo, node=store.node, val_hi=val_hi,
                      val_lo=val_lo, tomb=store.tomb.to(torch.int32),
                      mod_hi=mod_hi, mod_lo=mod_lo, mod_node=store.mod_node)


def join_store(s: SplitStore) -> DenseStore:
    """The inverse of `split_store`: a slot is occupied iff ``hi !=
    NEG_HI``, and an empty slot's lt reads 0."""
    occupied = s.hi != NEG_HI
    return DenseStore(
        lt=torch.where(occupied, join64(s.hi, s.lo), 0), node=s.node,
        val=join64(s.val_hi, s.val_lo), mod_lt=join64(s.mod_hi, s.mod_lo),
        mod_node=s.mod_node, occupied=occupied, tomb=s.tomb.bool())


def split_changeset(cs: DenseChangeset) -> SplitChangeset:
    """Wide lanes -> split wire lanes. Node ordinals are cast to int16
    as JAX casts them (wrapping past `MAX_NODE_ORDINAL`); callers bound
    them first."""
    lt = torch.where(cs.valid, cs.lt, _NEG)
    hi, lo = _split64(lt)
    val_hi, val_lo = _split64(cs.val)
    return SplitChangeset(
        hi=hi, lo=lo,
        node=torch.where(cs.valid, cs.node, I16_NEG).to(torch.int16),
        val_hi=val_hi, val_lo=val_lo, tomb=cs.tomb.to(torch.int8))


def split_changeset_narrow(cs: DenseChangeset
                           ) -> Tuple[NarrowSplitChangeset, torch.Tensor]:
    """`split_changeset` for the value-ref mode. Returns the narrow
    lanes and a ``val_overflow`` flag: True iff a valid value does not
    round-trip through int32. Such entries are masked INVALID, never
    truncated."""
    v32 = cs.val.to(torch.int32)
    fits = v32.long() == cs.val
    overflow = (cs.valid & ~fits).any()
    ok = cs.valid & fits
    hi, lo = _split64(torch.where(ok, cs.lt, _NEG))
    return NarrowSplitChangeset(
        hi=hi, lo=lo,
        node=torch.where(ok, cs.node, I16_NEG).to(torch.int16),
        val=v32, tomb=cs.tomb.to(torch.int8)), overflow


def tile_changeset(scs, lane: int = _LANE):
    """Split lanes ``[R, N]`` -> the tiled ``[R, N // lane, lane]`` wire
    layout (a view)."""
    r, n = scs.hi.shape
    if n % (_SB * lane):
        raise ValueError(f"n={n} not tileable at lane={lane}")
    return type(scs)(*(x.reshape(r, n // lane, lane) for x in scs))


def _cs_shape(cs) -> Tuple[int, int]:
    """(r, n) for 2-D or tiled 3-D split lanes."""
    if cs.hi.dim() == 3:
        r, rows, lane = cs.hi.shape
        return r, rows * lane
    return tuple(cs.hi.shape)


def flat_lanes(cs):
    """The lanes of a 2-D or tiled changeset as ``[R, N]`` (views of
    contiguous lanes)."""
    r, n = _cs_shape(cs)
    return type(cs)(*(x.reshape(r, n) for x in cs))


def split_guard_lanes(hi: torch.Tensor, lo: torch.Tensor,
                      node: torch.Tensor, node_map: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Just the ``(lt, node, valid)`` lanes the recv guards read, with
    LOCAL ordinals (``node_map`` rewrites peer ordinals), from split
    wire lanes, without rebuilding the payload."""
    r = hi.shape[0]
    hi2 = hi.reshape(r, -1)
    valid = hi2 != NEG_HI
    lt = join64(hi2, lo.reshape(r, -1))
    idx = node.reshape(r, -1).long().clamp(0, node_map.shape[0] - 1)
    return lt, node_map.to(torch.int32)[idx], valid


def split_to_wide(cs) -> DenseChangeset:
    """Split wire lanes (either width, 2-D or tiled) -> wide lanes: the
    inverse of `split_changeset`[`_narrow`] up to the content of
    invalid entries, which no consumer reads."""
    flat = flat_lanes(cs)
    valid = flat.hi != NEG_HI
    if isinstance(cs, NarrowSplitChangeset):
        val = flat.val.long()
    else:
        val = join64(flat.val_hi, flat.val_lo)
    return DenseChangeset(
        lt=torch.where(valid, join64(flat.hi, flat.lo), 0),
        node=torch.where(valid, flat.node.to(torch.int32), 0),
        val=val, tomb=flat.tomb.bool(), valid=valid)
