"""Pod-local replica groups: N co-located `DenseCrdt` s converged by
ONE group join (docs/COLLECTIVE.md).

Port of ``crdt_tpu/collective.py``. `CollectiveGroup` owns the
`parallel.collective.make_collective_join` step: it places the member
replicas on a 1-D member mesh, keeps their node tables and semantics
columns aligned (two replicas must never join one slot under two
different lattices, the contract `merge_packed` enforces on the wire),
and exposes :meth:`join`, after which every member's replicated lanes
are bit-identical to the socket-path merge of the same deltas.

One ``join()`` is one call of the group join. Everything the pairwise
relay gets from `merge_and_repack` comes out of it: per-member ``mod``
stamps, the next round's repack masks (each member's pack cache is
seeded under its pre-join watermark) and the post-join digest levels
(each digest cache is seeded too), so a follow-up cross-pod socket
round packs and walks from warm caches.

Group membership is declared at construction, optionally with the
``"host:port"`` addresses the members' `GossipNode` servers answer on,
so a `GossipNode` can recognize co-located peers by address and route
their rounds here while remote peers keep the merkle, packed, dense
and JSON ladder.

Differences from the JAX package:

- The default mesh places member i on member i's own device (JAX's
  takes the first N devices); a mesh given explicitly is used as is.
- JAX donates the members' old store buffers to the join where the
  backend honors donation. Torch has no donation: the join reads the
  old stores and writes new lanes, and the old stores are freed when
  the members drop them.
- Member i's joined lanes come back on its mesh position's device,
  which on the default mesh is its own: the join moves no member's
  lanes to another card (``.to(m.device)`` is then a no-op). Members
  that share a device are rows of one stacked tensor there, taken with
  ``unbind``: rows never overlap, so no member's store aliases
  another's, and an in-place write of one member touches no other
  member's slots.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .hlc import Hlc
from .ops.dense import DenseStore
from .ops.digest import build_digest_tree
from .parallel.collective import (MEMBER_AXIS, make_collective_join,
                                  make_collective_mesh)


class CollectiveJoinReport:
    """What one collective round did, the in-process accounting twin of
    `sync.MerkleSyncReport`. ``bytes_to_wire`` is identically 0: the
    lattice join moved over the mesh, not a socket."""

    __slots__ = ("new_canonical", "win_counts", "digest_root",
                 "members")
    bytes_to_wire = 0

    def __init__(self, new_canonical: int, win_counts: List[int],
                 digest_root: int, members: int):
        self.new_canonical = new_canonical
        self.win_counts = win_counts
        self.digest_root = digest_root
        self.members = members

    @property
    def adopted(self) -> int:
        return sum(self.win_counts)


class CollectiveGroup:
    """N co-located `DenseCrdt` replicas joined as one collective.

    ``members`` are the live replica objects (>= 2, equal geometry,
    distinct node ids). ``mesh`` defaults to a 1-D member mesh over the
    members' own devices. ``addresses`` optionally maps each member's
    node id to the ``"host:port"`` its `GossipNode` server answers on,
    the identity co-location detection keys on."""

    # The collective path holds NO host locks: the join runs on the
    # device stream, and member stores are quiesced by the caller
    # (docs/COLLECTIVE.md).
    _CRDTLINT_LOCK_ORDER: tuple = ()

    def __init__(self, members: Sequence[Any], mesh=None,
                 addresses: Optional[Dict[Any, str]] = None):
        members = list(members)
        if len(members) < 2:
            raise ValueError(
                f"a collective group needs >= 2 members, got "
                f"{len(members)}")
        ids = [m.node_id for m in members]
        if len(set(ids)) != len(ids):
            raise ValueError(
                f"collective group members must carry distinct node "
                f"ids, got {ids}")
        first = members[0]
        for m in members[1:]:
            if m.n_slots != first.n_slots:
                raise ValueError(
                    f"collective group members disagree on n_slots: "
                    f"{first.n_slots} vs {m.n_slots}")
            if m._value_width != first._value_width:
                raise ValueError(
                    "collective group members disagree on value_width")
            if m.DIGEST_LEAF_WIDTH != first.DIGEST_LEAF_WIDTH:
                raise ValueError(
                    "collective group members disagree on digest "
                    "leaf width")
        if mesh is None:
            mesh = make_collective_mesh(len(members),
                                        [m.device for m in members])
        if mesh.shape[MEMBER_AXIS] != len(members):
            raise ValueError(
                f"mesh member extent {mesh.shape[MEMBER_AXIS]} != "
                f"{len(members)} members")
        self.members = members
        self.mesh = mesh
        self.addresses = dict(addresses or {})
        unknown = set(self.addresses) - set(ids)
        if unknown:
            raise ValueError(
                f"addresses name non-member node ids: {sorted(unknown)}")
        self._member_ids = set(id(m) for m in members)
        self._align_tables()

    # --- membership surface (what GossipNode's fast lane keys on) ---

    def contains(self, crdt: Any) -> bool:
        """Is this live replica object a group member (identity, not
        equality: a copy with the same node id is NOT co-located)."""
        return id(crdt) in self._member_ids

    def address_of(self, node_id: Any) -> Optional[str]:
        return self.addresses.get(node_id)

    def member_addresses(self) -> frozenset:
        """The declared ``"host:port"`` identities of the group:
        `GossipNode.add_peer` marks a peer collective when its address
        lands in this set."""
        return frozenset(self.addresses.values())

    # --- alignment: shared table, shared lattice ---

    def _align_tables(self) -> None:
        """Union-intern every member's node ids into every member. Node
        ordinals are replica-local (`ops.packing.NodeTable`), so the
        compare of node lanes means something only once all members
        hold the SAME sorted table; `_intern_ids` re-encodes stored
        lanes when ordinals shift, and steady-state rounds, whose
        tables already agree, skip it."""
        union: set = set()
        for m in self.members:
            union.update(m._table.ids())
        union_list = sorted(union, key=lambda x: (str(type(x)), str(x)))
        for m in self.members:
            if len(m._table) != len(union):
                m._intern_ids(union_list)

    def _check_semantics(self) -> bool:
        """All members must govern every slot by the same lattice before
        lanes may join: the collective twin of the packed wire's
        tag-mismatch refusal."""
        sems = [m._sem_host() for m in self.members]
        ref = sems[0]
        for m, sem in zip(self.members[1:], sems[1:]):
            mism = sem != ref
            if bool(mism.any()):
                slot = int(np.nonzero(mism)[0][0])
                raise ValueError(
                    f"semantics tag mismatch at slot {slot}: member "
                    f"{self.members[0].node_id!r} holds tag "
                    f"{int(ref[slot])}, member {m.node_id!r} holds "
                    f"{int(sem[slot])}; run the same set_semantics "
                    "migration on every group member before joining")
        return bool(ref.any())

    # --- the round ---

    def join(self, seed_packs: bool = True) -> CollectiveJoinReport:
        """One collective anti-entropy round: drain ingest overlays, run
        the group join, land every member on the joined store with its
        canonical clock, digest cache and (when ``seed_packs``) pack
        cache seeded: the `merge_and_repack` contract, over the whole
        group in one call."""
        from .obs.trace import round_id, span, tracer
        members = self.members
        for m in members:
            m.drain_ingest()
        self._align_tables()
        has_sem = self._check_semantics()

        watermarks = [m.canonical_time for m in members]
        table = members[0]._table
        me = np.asarray([table.ordinal(m.node_id) for m in members],
                        np.int32)
        since = np.asarray([w.logical_time for w in watermarks],
                           np.int64)
        canonical_in = max(w.logical_time for w in watermarks)
        leaf_width = members[0].DIGEST_LEAF_WIDTH
        step = make_collective_join(self.mesh, has_sem, leaf_width)

        node = str(members[0].node_id)
        rid = {"rid": round_id(node)} if tracer().enabled else {}
        with span("collective_join", kind="sync", node=node,
                  hlc=lambda: members[0].canonical_time,
                  members=len(members), **rid):
            stores = tuple(m._store for m in members)
            args = ((members[0]._sem_device(),) if has_sem else ())
            rows, res = step(stores, *args, torch.from_numpy(since),
                             torch.from_numpy(me), canonical_in)
            # ONE small fetch: the clock and the per-member win counts.
            home = res.new_canonical.device
            head = torch.stack([res.new_canonical] + [
                w.sum().to(home) for w in res.win]).cpu().tolist()
            canonical, win_counts = int(head[0]), head[1:]
            tree = build_digest_tree(members[0].n_slots, leaf_width,
                                     res.levels)

        for i, m in enumerate(members):
            # The setter clears both caches.
            m._store = DenseStore(*(lane.to(m.device) for lane in rows[i]))
            m._store_escaped = False
            # The clock lands without a refresh: the join's canonical IS
            # max(member canonicals, every lt joined).
            m._canonical_time = Hlc.from_logical_time(canonical,
                                                      m.node_id)
            # Keyed after the setter bumped the store generation.
            m._digest_cache = (m._digest_key(), tree)
            m.stats.merges += 1
            if seed_packs:
                self._seed_pack(m, watermarks[i], res.repack[i].to(m.device),
                                has_sem)
        del rows, res
        return CollectiveJoinReport(
            new_canonical=canonical, win_counts=win_counts,
            digest_root=tree.root, members=len(members))

    @staticmethod
    def _seed_pack(m, watermark: Hlc, mask: torch.Tensor,
                   has_sem: bool) -> None:
        """Seed the member's pack cache under its pre-join watermark: the
        key the next watermark-aligned `pack_since` (a cross-pod peer
        resuming delta sync) presents. The rows are selected on the
        device and only they cross to the host; no wire stage runs, so
        ``crdt_tpu_pack_copy_bytes_total`` does not move."""
        resolved = m._resolve_sem_mode("include" if has_sem else "auto")
        out = m._pack_rows_at(mask, resolved)
        m._pack_cache_store(m._pack_key(watermark, resolved), out)
