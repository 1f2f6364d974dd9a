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
member mesh, its per-member blocks joined with ``pmax`` / ``pmin`` /
``psum`` / ``all_gather`` collectives. Here the body is the same step
for step, over each group of members that share a device (their lanes
stacked ``[g, N]`` there, a view for a group of one), and each
collective is a `parallel.comm` one: a reduction over the group, then
NCCL across the cards (or the funnel, its plain twin). Every member's
lanes stay on its own device; no member is copied to another card.
The group join is XLA code in the JAX package, so no hand kernel
replaces it (`obs.device.OPS` counts each call as
``parallel.collective_join``). The same call returns each member's
``mod`` stamps and repack mask, computed on its own device, the new
canonical, and the post-join digest levels, which are the same for
every member (the replicated lanes are equal by construction), so they
are computed once, from rank 0's lanes.
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
from . import comm
from .fanin import FaninMesh, _make_mesh

#: The 1-D replica-group axis. Distinct from fanin's REPLICA_AXIS on
#: purpose: a fan-in mesh shards changeset rows; a collective mesh
#: places one whole member replica per device.
MEMBER_AXIS = "member"


class CollectiveJoinResult(NamedTuple):
    new_canonical: torch.Tensor     # int64 scalar, on rank 0's device
    win: Tuple[torch.Tensor, ...]   # bool[N] per member: changed mask
    repack: Tuple[torch.Tensor, ...]  # bool[N] per member: mod_lt >= since
    levels: Tuple[torch.Tensor, ...]  # post-join digest levels, root-first


_obs_device.register("parallel.collective_join")


def make_collective_mesh(n_members: int, devices=None, *, groups=None,
                         funnel: bool = False) -> FaninMesh:
    """A 1-D ``(member,)`` mesh over ``devices`` (names or
    ``torch.device`` s). ``None`` takes the visible CUDA cards round
    robin, so one card repeats ``cuda:0``; without a card that raises
    (pass ``devices=["cpu"] * n_members`` for the plain torch path).
    ``groups`` labels each member's collective group (default: its
    device) and ``funnel=True`` joins the groups through the funnel, the
    plain twin of NCCL (`parallel.fanin.FaninMesh`)."""
    return _make_mesh((n_members,), (MEMBER_AXIS,), devices, groups, funnel)


def _typed_group_val(layout: comm.Layout, sem, occ, l_lt, l_val, m1, w_val):
    """G-ary value join by tag over the member axis, each argument a list
    with one entry per group (``[g, N]`` blocks, ``[N]`` collective
    results, ``sem`` the tag column on each group's device). Equal to
    folding `typed_join_lanes`'s pairwise value rule over the group in
    any order: each branch is a commutative, associative join with 0 as
    the absent member's identity, which is what lets it ride
    collectives instead of a fold."""
    # gcounter and the pncounter halves in ONE stacked pmax.
    gpn = comm.pmax(layout, [torch.stack(
        [v, (v >> 32) & _PN_HALF, v & _PN_HALF], 1) for v in l_val])
    # orset: all 16 causal-length nibbles in ONE stacked pmax (uint8).
    nibs = comm.pmax(layout, [torch.stack(
        [((v >> (4 * i)) & 0xF).to(torch.uint8)
         for i in range(ORSET_UNIVERSE)], 1) for v in l_val])
    # mvreg: a strictly newer lt wins outright, equal lts union, so only
    # the members holding the winning lt contribute their pack, folded
    # in rank order over a G-row gather (0, the empty pack, is the
    # identity of `_mvreg_union`).
    packs = comm.all_gather(layout, [
        torch.where(o & (lt == m), v, 0)
        for o, lt, m, v in zip(occ, l_lt, m1, l_val)])
    out = []
    for j in range(len(layout.groups)):
        gmax = gpn[j][0]
        pn = (gpn[j][1] << 32) | gpn[j][2]
        ors = torch.zeros_like(gmax)
        for i in range(ORSET_UNIVERSE):
            ors = ors | (nibs[j][i].long() << (4 * i))
        mv = packs[j][0]
        for g in range(1, packs[j].shape[0]):
            mv = _mvreg_union(mv, packs[j][g])
        v = w_val[j]
        v = torch.where(sem[j] == SEM_GCOUNTER, gmax, v)
        v = torch.where(sem[j] == SEM_PNCOUNTER, pn, v)
        v = torch.where(sem[j] == SEM_ORSET, ors, v)
        out.append(torch.where(sem[j] == SEM_MVREG, mv, v))
    return out


def _join_groups(layout: comm.Layout, leaf_width: int,
                 blocks: Sequence[DenseStore], sem, since, me,
                 canonical_in: int):
    """The per-member body (crdt_tpu/parallel/collective.py's
    `_join_block`), over each group's stacked ``[g, N]`` lanes:
    ``blocks``, ``since`` and ``me`` (``[g]``) per group, ``sem`` the
    tag column on each group's device or None. Returns each group's
    output block, win and repack ``[g, N]``, the new canonical on each
    group's device, and the digest levels from rank 0's row."""
    # Mask absent slots to the join identities so an unoccupied member
    # can never win a lane.
    occ = [b.occupied for b in blocks]
    l_lt = [torch.where(b.occupied, b.lt, _NEG) for b in blocks]
    l_node = [torch.where(b.occupied, b.node, _I32_NEG) for b in blocks]
    l_val = [torch.where(b.occupied, b.val, 0) for b in blocks]
    l_tomb = [b.occupied & b.tomb for b in blocks]

    # Lexicographic (lt, node) max over the group; the lowest rank
    # holding it is the winner.
    m1, m2, mine = comm.lex_winner(layout, l_lt, l_node)
    w_val = comm.psum(layout, [torch.where(m, v, 0)
                               for m, v in zip(mine, l_val)])
    w_tomb = comm.psum(layout, [m & t for m, t in zip(mine, l_tomb)])
    g_occ = comm.pmax(layout, occ)
    v = w_val if sem is None else _typed_group_val(
        layout, sem, occ, l_lt, l_val, m1, w_val)
    new_canonical = [torch.maximum(torch.tensor(canonical_in, device=d), c)
                     for d, c in zip(layout.devices, comm.pmax(layout, [
                         lt.amax().reshape(1, 1) for lt in l_lt]))]

    outs, wins, repacks = [], [], []
    for j, b in enumerate(blocks):
        # Slots no member holds keep each member's own (zero) lanes,
        # never the _NEG / _I32_NEG sentinels.
        go = g_occ[j]
        lt_out = torch.where(go, m1[j], b.lt)
        node_out = torch.where(go, m2[j], b.node)
        val_out = torch.where(go, v[j], b.val)
        tomb_out = torch.where(go, w_tomb[j] > 0, b.tomb)
        occ_out = b.occupied | go
        # Per-member adoption is changed-vs-own-input (the typed joins'
        # `win`; for LWW lanes the strict take mask, since adoption
        # always moves lt, node or presence).
        win = ((lt_out != b.lt) | (node_out != b.node) | (val_out != b.val)
               | (tomb_out != b.tomb) | (occ_out & ~b.occupied))
        mod_lt = torch.where(win, new_canonical[j][0], b.mod_lt)
        outs.append(DenseStore(
            lt=lt_out, node=node_out, val=val_out, mod_lt=mod_lt,
            mod_node=torch.where(win, me[j][:, None], b.mod_node),
            occupied=occ_out, tomb=tomb_out))
        wins.append(win)
        repacks.append(occ_out & (mod_lt >= since[j][:, None]))
    first = outs[0]
    h = slot_digests(first.lt[0], first.val[0], first.tomb[0],
                     first.occupied[0], sem=None if sem is None else sem[0])
    levels = tree_levels_from_leaves(fold_leaves(h, leaf_width))
    return outs, wins, repacks, new_canonical, levels


def make_collective_join(mesh: FaninMesh, has_sem: bool, leaf_width: int):
    """The group join for a member mesh.

    Returns ``step(stores, [sem,] since, me, canonical_in) ->
    (member_stores, CollectiveJoinResult)``: ``stores`` is a G-tuple of
    per-member `DenseStore` s (G = the mesh's member extent), ``sem``
    the shared ``[N]`` int8 tag column (only when ``has_sem``),
    ``since`` and ``me`` the ``[G]`` per-member watermark lts and node
    ordinals, ``canonical_in`` the max of the members' pre-join
    canonical lts. Member i's new store comes back on its mesh
    position's device (its own device, on the default mesh), as row i
    of its group's stacked output: rows never overlap, so no member's
    store aliases another's. The replicated lanes are equal across
    members, the ``mod`` lanes per member. The inputs are not
    written."""
    g = mesh.shape[MEMBER_AXIS]
    layout = mesh.layout

    def step(stores: Sequence[DenseStore], *args):
        if len(stores) != g:
            raise ValueError(
                f"collective join over a {g}-member mesh got "
                f"{len(stores)} stores")
        if has_sem:
            sem, since, me, canonical_in = args
            sem = [sem.to(d) for d in layout.devices]
        else:
            since, me, canonical_in = args
            sem = None
        since = torch.as_tensor(since, dtype=torch.int64)
        me = torch.as_tensor(me, dtype=torch.int32)
        _obs_device.note_op("parallel.collective_join")
        with _obs_device.record("parallel.collective_join",
                                dim=stores[0].lt.shape[0]):
            blocks = [DenseStore(*lanes) for lanes in zip(*(
                layout.stack(lanes) for lanes in zip(*stores)))]
            outs, wins, repacks, canonical, levels = _join_groups(
                layout, leaf_width, blocks, sem,
                [since[ps].to(d) for ps, d in zip(layout.groups,
                                                  layout.devices)],
                [me[ps].to(d) for ps, d in zip(layout.groups,
                                               layout.devices)],
                int(canonical_in))
            members: list = [None] * g
            win: list = [None] * g
            repack: list = [None] * g
            for j, ps in enumerate(layout.groups):
                rows = zip(*(lane.unbind(0) for lane in outs[j]))
                for p, row, w, r in zip(ps, rows, wins[j].unbind(0),
                                        repacks[j].unbind(0)):
                    members[p], win[p], repack[p] = DenseStore(*row), w, r
            return tuple(members), CollectiveJoinResult(
                new_canonical=canonical[0][0], win=tuple(win),
                repack=tuple(repack), levels=levels)

    return step
