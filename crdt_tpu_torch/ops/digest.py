"""Segment-tree digests over dense store lanes, in torch.

Port of ``crdt_tpu/ops/digest.py``, the anti-entropy half of the
delta-state design: watermark deltas (`pack_since`) assume a peer you
have talked to before, so a fresh or long-partitioned replica would
force a full-store scan. A Merkle-style digest tree lets two replicas
localize divergence in O(log n) round trips instead: exchange the root,
walk only the subtrees whose digests differ, ship the divergent slot
ranges through the range pack (``pack_since(ranges=...)``).

The reduction runs on the store's device: a per-slot 64-bit mix over the
replicated lanes (``lt``, ``val``, ``tomb``, and a semantics tag where
one is given; NOT ``node``/``mod_*``, which are replica-local ordinals
and bookkeeping and differ between converged stores), a wrapping-sum
fold into fixed-width leaves, then pairwise order-sensitive combines up
to the root. Leaves are padded to a power of two with the all-empty
digest (0), so equal stores give equal trees whatever the slot count.

The mix is splitmix64's finalizer on uint64. Torch has no uint64
``>>`` or ``+`` on the CPU, so the port carries the same bits in int64:
the constants are their two's-complement int64 views, multiply and add
wrap mod 2^64 exactly as uint64 does, and a logical right shift is an
arithmetic one masked to its low ``64 - k`` bits (`_shr`). The fold's
wrapping sum is order-free, so a device reduction gives the same leaf
in any order. The host tree (`DigestTree`) holds the levels as numpy
uint64, so a tree of this package and one of the JAX package answer
``values()`` with the same Python ints, and either package's
`walk_divergent_leaves` walks the other's tree.

This is plain torch (no hand kernel): the JAX package runs it through
XLA, not Pallas. `digest_tree_device` counts one ``digest_tree`` op per
tree (`obs.device.OPS`).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import device as obs_device
from .dense import DenseStore

obs_device.register("digest.digest_tree_device")

#: Slots folded into one leaf digest. Under uniformly scattered
#: divergence at rate p the share of leaves hit is ``1 - (1 - p)^W``, so
#: narrow leaves keep the re-shipped rows close to the divergent ones
#: (W=8 at 1% scatter: 7.7% of the leaves) at the cost of a deeper walk.
#: Both peers must agree (the walk checks geometry).
DEFAULT_LEAF_WIDTH = 8

#: Tree levels probed per round trip when the fetch side takes batched
#: (multi-level) probes: each round asks for the frontier and its
#: descendants for the next ``PREFETCH_LEVELS - 1`` levels, so a walk
#: costs ``ceil(depth / PREFETCH_LEVELS)`` round trips instead of
#: ``depth``.
PREFETCH_LEVELS = 3

#: Speculative expansion stops growing a batch past this many indices
#: per level, so one probe frame cannot rival the payload it localizes.
PREFETCH_MAX_BATCH = 512


def _i64(c: int) -> int:
    """A uint64 constant as its two's-complement int64 value."""
    return int(np.uint64(c).view(np.int64))


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX_A = _i64(0xBF58476D1CE4E5B9)
_MIX_B = _i64(0x94D049BB133111EB)
_TOMB_SALT = _i64(0xD6E8FEB86659FD93)
_SEM_SALT = _i64(0xFF51AFD7ED558CCD)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes read as uint64: the
    arithmetic shift with the copied sign bits masked off."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 lanes holding uint64 bits."""
    x = (x ^ _shr(x, 30)) * _MIX_A
    x = (x ^ _shr(x, 27)) * _MIX_B
    return x ^ _shr(x, 31)


def slot_digests(lt: torch.Tensor, val: torch.Tensor, tomb: torch.Tensor,
                 occupied: torch.Tensor, sem: Optional[torch.Tensor] = None,
                 idx_offset: int = 0) -> torch.Tensor:
    """Per-slot digests (int64 lanes of uint64 bits) over the replicated
    lanes, zero where unoccupied. ``idx_offset`` shifts the mixed-in
    slot index, so a key shard digests its window against global
    positions (`parallel.make_sharded_digest`)."""
    idx = torch.arange(lt.shape[0], dtype=torch.int64, device=lt.device)
    h = _mix64(lt + _GOLDEN * (idx + (idx_offset + 1)))
    h = h ^ _mix64(val ^ _MIX_B)
    h = h ^ torch.where(tomb, _TOMB_SALT, 0)
    if sem is not None:
        h = h ^ _mix64(sem.to(torch.int64) + _SEM_SALT)
    return torch.where(occupied, _mix64(h), 0)


def _pow2_at_least(n: int) -> int:
    p2 = 1
    while p2 < max(1, n):
        p2 *= 2
    return p2


def fold_leaves(digests: torch.Tensor, leaf_width: int) -> torch.Tensor:
    """Wrapping-sum fold of per-slot digests into ``ceil(n /
    leaf_width)`` leaf digests, the ragged tail padded with zeros (an
    empty slot's digest). No power-of-two padding here, so per-shard
    folds concatenate into the global leaf row."""
    n = digests.shape[0]
    n_leaves = max(1, -(-n // leaf_width))
    pad = n_leaves * leaf_width - n
    if pad:
        digests = torch.cat([digests, digests.new_zeros(pad)])
    return digests.reshape(n_leaves, leaf_width).sum(1)


def combine_level(children: torch.Tensor) -> torch.Tensor:
    """One interior level: the order-sensitive pairwise combine."""
    return _mix64(children[0::2] + _GOLDEN * children[1::2] + _MIX_A)


def tree_levels_from_leaves(leaves: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """Pad the leaf row to a power of two with the all-empty digest, then
    build every interior level. Returns the levels ROOT-FIRST
    (``levels[0]`` of shape (1,), ``levels[-1]`` the padded leaves)."""
    pad = _pow2_at_least(int(leaves.shape[0])) - int(leaves.shape[0])
    if pad:
        leaves = torch.cat([leaves, leaves.new_zeros(pad)])
    levels = [leaves]
    while levels[-1].shape[0] > 1:
        levels.append(combine_level(levels[-1]))
    return tuple(reversed(levels))


def digest_levels_from_lanes(lt, val, tomb, occupied, sem=None,
                             leaf_width: int = DEFAULT_LEAF_WIDTH,
                             idx_offset: int = 0
                             ) -> Tuple[torch.Tensor, ...]:
    """The whole reduction straight from store lanes: per-slot mix, leaf
    fold, every interior combine. `ops.dense.compact_remap` runs it
    after its remap, so a compacted store comes with its tree."""
    h = slot_digests(lt, val, tomb, occupied, sem=sem,
                     idx_offset=idx_offset)
    return tree_levels_from_leaves(fold_leaves(h, leaf_width))


def digest_tree_device(store: DenseStore, sem=None,
                       leaf_width: int = DEFAULT_LEAF_WIDTH
                       ) -> Tuple[torch.Tensor, ...]:
    """Digest-tree levels (root-first) of a store, on its device.
    ``sem`` is an optional per-slot semantics tag column."""
    with obs_device.record("digest.digest_tree_device", dim=store.lt.shape[0]):
        obs_device.note_op("digest_tree")
        return digest_levels_from_lanes(store.lt, store.val, store.tomb,
                                        store.occupied, sem=sem,
                                        leaf_width=leaf_width)


class DigestTree(NamedTuple):
    """Host view of the fetched levels and the walk geometry. Two trees
    are comparable only when ``n_slots`` and ``leaf_width`` agree."""

    n_slots: int
    leaf_width: int
    levels: Tuple[np.ndarray, ...]  # root-first uint64; levels[-1] leaves

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def root(self) -> int:
        return int(self.levels[0][0])

    @property
    def n_leaves(self) -> int:
        return int(self.levels[-1].shape[0])

    def values(self, level: int, idxs: Sequence[int]) -> List[int]:
        if not 0 <= level < self.depth:
            raise ValueError(f"digest level {level} out of range "
                             f"[0, {self.depth})")
        row = self.levels[level]
        out = []
        for i in idxs:
            i = int(i)
            if not 0 <= i < row.shape[0]:
                raise ValueError(f"digest index {i} out of range for "
                                 f"level {level} (width {row.shape[0]})")
            out.append(int(row[i]))
        return out

    def values_levels(self, groups: Sequence[Tuple[int, Sequence[int]]]
                      ) -> List[List[int]]:
        """Batched :meth:`values`: one result row per ``(level, idxs)``
        group, the in-process mirror of a multi-level digest probe."""
        return [self.values(level, idxs) for level, idxs in groups]

    def same_geometry(self, n_slots: int, leaf_width: int,
                      depth: int) -> bool:
        return (self.n_slots == n_slots
                and self.leaf_width == leaf_width
                and self.depth == depth)

    def leaf_range(self, leaf_idx: int) -> Tuple[int, int]:
        lo = leaf_idx * self.leaf_width
        return lo, min(lo + self.leaf_width, self.n_slots)


def build_digest_tree(n_slots: int, leaf_width: int,
                      levels: Sequence[torch.Tensor]) -> DigestTree:
    """Every level in ONE device-to-host copy, viewed as uint64."""
    flat = torch.cat([lvl.reshape(-1) for lvl in levels]).cpu().numpy()
    flat = flat.view(np.uint64)
    out, off = [], 0
    for lvl in levels:
        w = int(lvl.shape[0])
        out.append(flat[off:off + w])
        off += w
    return DigestTree(n_slots=int(n_slots), leaf_width=int(leaf_width),
                      levels=tuple(out))


def walk_divergent_leaves(
        tree: DigestTree,
        fetch: Optional[Callable[[int, List[int]], Sequence[int]]],
        fetch_levels: Optional[
            Callable[[List[Tuple[int, List[int]]]],
                     Sequence[Sequence[int]]]] = None,
        prefetch: int = PREFETCH_LEVELS,
) -> Tuple[List[int], int, int]:
    """Top-down walk against a remote tree reachable only through a
    fetch callback (the JAX package's walk, line for line):

    - ``fetch(level, idxs) -> values``: one level per call (one round
      trip), so a walk takes at most ``depth`` rounds;
    - ``fetch_levels(groups) -> [values, ...]``, ``groups`` a list of
      ``(level, idxs)``: each call probes the frontier and the
      speculative descendants of the whole frontier for the next
      ``prefetch - 1`` levels (capped at `PREFETCH_MAX_BATCH` indices a
      level), ``ceil(depth / prefetch)`` rounds; every next frontier is
      a subset of what was prefetched.

    Returns ``(divergent_leaf_idxs, rounds, values_fetched)``; no leaves
    means the trees, and so the replicated lanes, agree.
    ``values_fetched`` counts every digest asked for, speculative ones
    included.
    """
    if fetch_levels is None:
        if fetch is None:
            raise ValueError("walk needs fetch or fetch_levels")
        frontier = [0]
        rounds = 0
        fetched = 0
        for level in range(tree.depth):
            remote = fetch(level, frontier)
            rounds += 1
            fetched += len(frontier)
            local = tree.levels[level]
            diff = [i for i, v in zip(frontier, remote)
                    if int(local[i]) != int(v)]
            if not diff:
                return [], rounds, fetched
            if level == tree.depth - 1:
                return diff, rounds, fetched
            frontier = [c for i in diff for c in (2 * i, 2 * i + 1)]
        return [], rounds, fetched  # pragma: no cover — loop returns

    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1; got {prefetch}")
    frontier = [0]
    level = 0
    rounds = 0
    fetched = 0
    while level < tree.depth:
        groups: List[Tuple[int, List[int]]] = []
        idxs = list(frontier)
        for lvl in range(level, min(level + prefetch, tree.depth)):
            if groups and len(idxs) > PREFETCH_MAX_BATCH:
                break
            groups.append((lvl, idxs))
            if lvl + 1 < tree.depth:
                idxs = [c for i in idxs for c in (2 * i, 2 * i + 1)]
        results = fetch_levels(groups)
        rounds += 1
        fetched += sum(len(ix) for _, ix in groups)
        if len(results) != len(groups):
            raise ValueError(
                f"fetch_levels returned {len(results)} groups for "
                f"{len(groups)} requested")
        for (lvl, g_idxs), vals in zip(groups, results):
            if len(vals) != len(g_idxs):
                raise ValueError(
                    f"fetch_levels group {lvl} returned {len(vals)} "
                    f"values for {len(g_idxs)} indices")
            remote = {i: int(v) for i, v in zip(g_idxs, vals)}
            local = tree.levels[lvl]
            diff = [i for i in frontier if int(local[i]) != remote[i]]
            if not diff:
                return [], rounds, fetched
            if lvl == tree.depth - 1:
                return diff, rounds, fetched
            frontier = [c for i in diff for c in (2 * i, 2 * i + 1)]
        level = groups[-1][0] + 1
    return [], rounds, fetched  # pragma: no cover — loop returns


def coalesce_leaf_ranges(leaf_idxs: Sequence[int], leaf_width: int,
                         n_slots: int) -> Tuple[Tuple[int, int], ...]:
    """Divergent leaves -> the fewest sorted ``(lo, hi)`` slot spans for
    the range pack: adjacent leaves merge into one span, and the tail
    span clips to ``n_slots`` so padding leaves never widen the pack."""
    spans: List[Tuple[int, int]] = []
    for leaf in sorted(set(int(i) for i in leaf_idxs)):
        lo = leaf * leaf_width
        hi = min(lo + leaf_width, n_slots)
        if lo >= n_slots or hi <= lo:
            continue  # pure padding leaf
        if spans and spans[-1][1] == lo:
            spans[-1] = (spans[-1][0], hi)
        else:
            spans.append((lo, hi))
    return tuple(spans)
