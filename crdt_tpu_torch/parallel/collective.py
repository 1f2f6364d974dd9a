"""Pod-local collective anti-entropy: the lattice join of a whole group
of co-located replicas in one call.

Port of ``crdt_tpu/parallel/collective.py``. The socket path
replicates co-located members the way it replicates remote peers:
pack, frame, loopback, unpack, merge, once per peer pair. But the
state-based merge discipline makes the lattice join the whole protocol,
so N replicas that share a mesh can converge in one group join instead
of N(N-1) wire exchanges. The join applies the rules of the pairwise
joins:

- **clock lanes**: the lexicographic ``(lt, node)`` max over the
  members; ties on identical HLCs go to the LOWEST member rank
  (identical events carry identical payloads, so the pick is
  payload-neutral);
- **value lane**: per tag, a G-ary join equal to a pairwise fold of
  `semantics.kernels.typed_join_lanes`: LWW takes the clock winner's
  payload; gcounter is a max (0 is the join identity); pncounter takes
  the max of each 31-bit half; orset of each of its 16 causal-length
  nibbles; mvreg folds `_mvreg_union` over the packs of the members
  that hold the winning lt, in rank order (the empty pack 0 is its
  identity);
- **tomb / occupied**: the clock winner's flag; presence is the OR over
  the members.

The JAX package runs this as one ``shard_map`` program over a 1-D
member mesh, its per-member blocks joined with ``pmax`` / ``psum``
collectives. Here the members' lanes are stacked ``[G, N]`` on the
mesh's home device (members on other devices are copied there with
``.to()``) and every collective becomes a reduction over the member
axis, in plain torch: XLA code in the JAX package, so no hand kernel
replaces it (`obs.device.OPS` counts each call as
``parallel.collective_join``). The same call returns per-member ``mod``
stamps and repack masks, the new canonical, and the post-join digest
levels, which are the same for every member (the replicated lanes are
equal by construction), so they are computed once, from rank 0's row.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..obs import device as _obs_device
from ..ops.dense import _I32_NEG, _NEG, DenseStore
from ..ops.digest import fold_leaves, slot_digests, tree_levels_from_leaves
from ..semantics.kernels import (ORSET_UNIVERSE, SEM_GCOUNTER, SEM_MVREG,
                                 SEM_ORSET, SEM_PNCOUNTER, _PN_HALF,
                                 _mvreg_union)
from .fanin import FaninMesh, _make_mesh

#: The 1-D replica-group axis. Distinct from fanin's REPLICA_AXIS on
#: purpose: a fan-in mesh shards changeset rows; a collective mesh
#: places one whole member replica per device.
MEMBER_AXIS = "member"


class CollectiveJoinResult(NamedTuple):
    new_canonical: torch.Tensor     # int64 scalar
    win: torch.Tensor               # bool[G, N] per-member changed mask
    repack: torch.Tensor            # bool[G, N] mod_lt >= since mask
    levels: Tuple[torch.Tensor, ...]  # post-join digest levels, root-first


def make_collective_mesh(n_members: int, devices=None) -> FaninMesh:
    """A 1-D ``(member,)`` mesh over ``devices`` (names or
    ``torch.device`` s). ``None`` takes the visible CUDA cards round
    robin, so one card repeats ``cuda:0``; without a card that raises
    (pass ``devices=["cpu"] * n_members`` for the plain torch path)."""
    return _make_mesh((n_members,), (MEMBER_AXIS,), devices)


def _typed_group_val(sem: torch.Tensor, occ: torch.Tensor,
                     l_lt: torch.Tensor, l_val: torch.Tensor,
                     m1: torch.Tensor, w_val: torch.Tensor) -> torch.Tensor:
    """G-ary value join by tag over the member axis (dim 0), equal to
    folding `typed_join_lanes`'s pairwise value rule over the group in
    any order: each branch is a commutative, associative join with 0
    as the absent member's identity."""
    gmax = l_val.amax(0)
    pn = (((l_val >> 32) & _PN_HALF).amax(0) << 32) | (
        (l_val & _PN_HALF).amax(0))
    ors = torch.zeros_like(gmax)
    for i in range(ORSET_UNIVERSE):
        ors = ors | (((l_val >> (4 * i)) & 0xF).amax(0) << (4 * i))
    # mvreg: a strictly newer lt wins outright, equal lts union, so only
    # the members holding the winning lt contribute their pack.
    packs = torch.where(occ & (l_lt == m1), l_val, 0)
    mv = packs[0]
    for g in range(1, packs.shape[0]):
        mv = _mvreg_union(mv, packs[g])
    out = w_val
    out = torch.where(sem == SEM_GCOUNTER, gmax, out)
    out = torch.where(sem == SEM_PNCOUNTER, pn, out)
    out = torch.where(sem == SEM_ORSET, ors, out)
    return torch.where(sem == SEM_MVREG, mv, out)


def _join_stacked(leaf_width: int, st: DenseStore, sem, since: torch.Tensor,
                  me: torch.Tensor, canonical_in: torch.Tensor):
    """The join over stacked ``[G, N]`` lanes: ``since`` and ``me`` are
    ``[G]``, ``sem`` is the shared ``[N]`` tag column or None."""
    lt, node, val = st.lt, st.node, st.val
    occ, tomb = st.occupied, st.tomb
    # Mask absent slots to the join identities so an unoccupied member
    # can never win a lane.
    l_lt = torch.where(occ, lt, _NEG)
    l_node = torch.where(occ, node, _I32_NEG)
    l_val = torch.where(occ, val, 0)

    # Lexicographic (lt, node) max over the group; the lowest rank
    # among the members holding it is the winner.
    m1 = l_lt.amax(0)
    m2 = torch.where(l_lt == m1, l_node, _I32_NEG).amax(0)
    has = (l_lt == m1) & (l_node == m2)
    # The winner's payload and flag, folded from the highest rank down
    # so the lowest rank holding the max has the last word. (A fold
    # over G rows: an argmax over the short member axis is a slow scan
    # on the CPU.)
    l_tomb = occ & tomb
    w_val, w_tomb = l_val[-1], l_tomb[-1]
    for g in range(has.shape[0] - 2, -1, -1):
        w_val = torch.where(has[g], l_val[g], w_val)
        w_tomb = torch.where(has[g], l_tomb[g], w_tomb)
    g_occ = occ.any(0)
    v = w_val if sem is None else _typed_group_val(sem, occ, l_lt, l_val,
                                                   m1, w_val)

    # Slots no member holds keep each member's own (zero) lanes, never
    # the _NEG / _I32_NEG sentinels.
    lt_out = torch.where(g_occ, m1, lt)
    node_out = torch.where(g_occ, m2, node)
    val_out = torch.where(g_occ, v, val)
    tomb_out = torch.where(g_occ, w_tomb, tomb)
    occ_out = occ | g_occ

    # Per-member adoption is changed-vs-own-input (the typed joins'
    # `win`; for LWW lanes the strict take mask, since adoption always
    # moves lt, node or presence).
    win = ((lt_out != lt) | (node_out != node) | (val_out != val)
           | (tomb_out != tomb) | (occ_out & ~occ))
    new_canonical = torch.maximum(canonical_in,
                                  torch.where(occ, lt, _NEG).amax())
    mod_lt_out = torch.where(win, new_canonical, st.mod_lt)
    mod_node_out = torch.where(win, me[:, None], st.mod_node)
    repack = occ_out & (mod_lt_out >= since[:, None])

    h = slot_digests(lt_out[0], val_out[0], tomb_out[0], occ_out[0], sem=sem)
    levels = tree_levels_from_leaves(fold_leaves(h, leaf_width))
    out = DenseStore(lt=lt_out, node=node_out, val=val_out,
                     mod_lt=mod_lt_out, mod_node=mod_node_out,
                     occupied=occ_out, tomb=tomb_out)
    return out, CollectiveJoinResult(new_canonical=new_canonical, win=win,
                                     repack=repack, levels=levels)


def make_collective_join(mesh: FaninMesh, has_sem: bool, leaf_width: int):
    """The group join for a member mesh.

    Returns ``step(stores, [sem,] since, me, canonical_in) ->
    (stacked_store, CollectiveJoinResult)``: ``stores`` is a G-tuple of
    per-member `DenseStore` s (G = the mesh's member extent), ``sem``
    the shared ``[N]`` int8 tag column (only when ``has_sem``),
    ``since`` and ``me`` the ``[G]`` per-member watermark lts and node
    ordinals, ``canonical_in`` the max of the members' pre-join
    canonical lts. The returned store is stacked ``[G, N]`` on the
    mesh's home device; its replicated lanes are equal across members,
    its ``mod`` lanes per member. The inputs are not written."""
    g = mesh.shape[MEMBER_AXIS]
    home = mesh.home

    def step(stores: Sequence[DenseStore], *args):
        if len(stores) != g:
            raise ValueError(
                f"collective join over a {g}-member mesh got "
                f"{len(stores)} stores")
        if has_sem:
            sem, since, me, canonical_in = args
            sem = sem.to(home)
        else:
            since, me, canonical_in = args
            sem = None
        _obs_device.note_op("parallel.collective_join")
        stacked = DenseStore(*(torch.stack([lane.to(home) for lane in lanes])
                               for lanes in zip(*stores)))
        return _join_stacked(
            leaf_width, stacked, sem,
            torch.as_tensor(since, dtype=torch.int64, device=home),
            torch.as_tensor(me, dtype=torch.int32, device=home),
            torch.as_tensor(canonical_in, dtype=torch.int64, device=home))

    return step
