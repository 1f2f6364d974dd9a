"""Sharded replica fan-in over a mesh of torch devices.

Port of ``crdt_tpu/parallel/fanin.py``. The store's key slots are
sharded over the mesh's ``key`` axis, each key shard replicated over the
other axes; an incoming ``[R, N]`` changeset is sharded over both, its
rows over the replica axes (``replica``, or ``slice`` then ``replica``
on a multislice mesh) and its slots over ``key``. One merge is the
sharded step (K1p): the K1 kernel (``csrc/fanin_batch.cu``) folds each
mesh position's block of rows into its copy of the store shard, in one
launch per device over all of that device's blocks, then a
lexicographic ``(lt, node)`` max combines the partial stores of each key
column, the lowest flat rank keeping exact ties — the earliest rows, as
in the sequential merge.

The JAX package runs one program per device under ``shard_map`` with
XLA collectives. The port is a single controller too, but plain: a mesh
is a grid of ``torch.device`` s (one device may appear several times —
one card, or ``"cpu"`` in the tests), and each replica-axis reduction
copies the column's blocks to the column's first device with ``.to``,
reduces there, and copies the result back to every copy. On one card
the blocks' joins are one launch and the combine queues on the same
stream; nothing syncs with the host between them.

Representation: a sharded store holds ``blocks[rank][k]``, the copy at
replica flat rank ``rank`` (outer-major over the replica axes,
`_flat_rank`) of key shard ``k``, each a `DenseStore` of the shard's
width on that position's device. A sharded changeset holds the
matching ``[R_blk, N_blk]`` blocks: contiguous row ranges in rank
order (uneven R is fine, no padding), each a view of the home lanes
where the position's device is the home device, else a copy.

Guard flags are the closed-form superset flags of the K1 kernel: some
valid local-node record above the pre-merge canonical, or the largest
record past the drift threshold. The model recomputes the exact guards
on the unsharded changeset when one trips.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..hlc import MAX_COUNTER, MAX_DRIFT, SHIFT
from ..obs import device as obs_device
from ..ops.dense import (_I32_NEG, _NEG, DenseChangeset, DenseStore,
                         compact_targets, dense_delta_mask,
                         dense_max_logical_time, remap_lane, remap_rows)
from ..ops.digest import fold_leaves, slot_digests, tree_levels_from_leaves
from ..ops.fanin_kernel import fanin_cuda_many, fanin_join_reference
from ..ops.ingest_kernel import ingest_scatter
from ..semantics.kernels import typed_fold, typed_guards, typed_result

REPLICA_AXIS = "replica"
KEY_AXIS = "key"
# Outer replica axis of a multislice mesh: the fan-in runs over
# ("slice", "replica") jointly, slice-major.
SLICE_AXIS = "slice"

# The rank a position that does not hold the column's lex max offers to
# the stable min-rank tie (parallel/fanin.py:89 of the JAX package).
_BIG_RANK = 2 ** 30


class FaninMesh:
    """A grid of torch devices with named axes, the counterpart of a
    ``jax.sharding.Mesh``: ``devices`` (a numpy object array of
    ``torch.device``), ``axis_names`` and ``shape`` (axis -> size). The
    key axis is the last one."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @functools.cached_property
    def grid(self) -> np.ndarray:
        """``grid[rank, k]``: the device holding replica flat rank
        ``rank`` of key shard ``k``."""
        grid = np.empty((replica_extent(self), self.shape[KEY_AXIS]), object)
        for pos in np.ndindex(*self.devices.shape):
            grid[_flat_rank(self, pos[:-1]), pos[-1]] = self.devices[pos]
        return grid

    @property
    def home(self) -> torch.device:
        """The first device: where the model keeps its clock, scalars and
        incoming changesets, and where global views are gathered."""
        return self.devices.flat[0]


def _make_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
               devices) -> FaninMesh:
    want = int(np.prod(shape))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a fan-in mesh takes the CUDA cards by default and this host "
                f"has none; pass devices=['cpu'] * {want} for the plain "
                "torch path")
        count = torch.cuda.device_count()
        devices = [f"cuda:{i % count}" for i in range(want)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != want:
        raise ValueError(f"{len(devices)} devices != "
                         + "x".join(str(s) for s in shape))
    grid = np.empty(want, object)
    for i, d in enumerate(devices):
        grid[i] = d
    return FaninMesh(grid.reshape(shape), axis_names)


def make_fanin_mesh(n_replica_shards: int, n_key_shards: int,
                    devices=None) -> FaninMesh:
    """A (replica, key) mesh. ``devices`` (names or ``torch.device`` s,
    row-major) defaults to the visible CUDA cards taken round robin, so
    one card repeats ``cuda:0``; without a card that raises."""
    return _make_mesh((n_replica_shards, n_key_shards),
                      (REPLICA_AXIS, KEY_AXIS), devices)


def make_multislice_fanin_mesh(n_slices: int, n_replica_shards: int,
                               n_key_shards: int, devices=None
                               ) -> FaninMesh:
    """A (slice, replica, key) mesh: the replica fan-in runs over
    ``(slice, replica)``, slice-major."""
    return _make_mesh((n_slices, n_replica_shards, n_key_shards),
                      (SLICE_AXIS, REPLICA_AXIS, KEY_AXIS), devices)


def _replica_axes(mesh: FaninMesh) -> Tuple[str, ...]:
    """Every axis but the key axis fans replicas in, in mesh order."""
    return tuple(n for n in mesh.axis_names if n != KEY_AXIS)


def replica_extent(mesh: FaninMesh) -> int:
    """Replica shards: the product of every non-key axis size."""
    extent = 1
    for a in _replica_axes(mesh):
        extent *= mesh.shape[a]
    return extent


def _flat_rank(mesh: FaninMesh, coords: Sequence[int]) -> int:
    """Flat rank of replica-axis coordinates, outer-major: the order the
    changeset rows are laid out over the mesh, so the lowest rank holds
    the earliest rows."""
    axes = _replica_axes(mesh)
    rank = int(coords[0])
    for a, c in zip(axes[1:], coords[1:]):
        rank = rank * mesh.shape[a] + int(c)
    return rank


class ShardedStore(NamedTuple):
    """Store lanes over a mesh: ``blocks[rank][k]`` (module docstring)."""
    blocks: List[List[DenseStore]]

    @property
    def n_slots(self) -> int:
        return sum(b.n_slots for b in self.blocks[0])

    @property
    def width(self) -> int:
        """Slots per key shard."""
        return self.blocks[0][0].n_slots

    def column(self, k: int) -> List[DenseStore]:
        """Every copy of key shard ``k``, in rank order."""
        return [row[k] for row in self.blocks]

    def map(self, fn: Callable[[DenseStore], DenseStore]) -> "ShardedStore":
        return ShardedStore([[fn(b) for b in row] for row in self.blocks])


class ShardedChangeset(NamedTuple):
    """Changeset blocks over a mesh: ``blocks[rank][k]``, ``[R_blk,
    N_blk]`` each (module docstring)."""
    blocks: List[List[DenseChangeset]]


class ShardedFaninResult(NamedTuple):
    new_canonical: torch.Tensor  # int64 scalar (pre final-send-bump)
    win_count: torch.Tensor      # int32 adopted records across all shards
    win: torch.Tensor            # bool[N] adopted mask, gathered
    any_bad: torch.Tensor        # bool — some recv guard tripped
    any_dup: torch.Tensor        # bool — a duplicate-node guard tripped
    any_drift: torch.Tensor      # bool — a drift guard tripped


def shard_store(store: DenseStore, mesh: FaninMesh) -> ShardedStore:
    """Cut a store into key shards, one real copy per mesh position
    (``copy=True``: copies on one device must not alias)."""
    k_shards = mesh.shape[KEY_AXIS]
    n = store.n_slots
    if n % k_shards:
        raise ValueError(f"n_slots={n} not divisible by the mesh's "
                         f"{k_shards} key shards")
    w = n // k_shards
    return ShardedStore([
        [DenseStore(*(lane[k * w:(k + 1) * w].to(dev, copy=True)
                      for lane in store))
         for k, dev in enumerate(row)]
        for row in mesh.grid])


def _row_ranges(rows: int, extent: int) -> List[Tuple[int, int]]:
    """Contiguous row blocks in rank order: rank ``i`` takes
    ``[i*b, (i+1)*b)`` clipped to R, ``b = ceil(R / extent)`` — the
    blocks of the JAX package's padded changeset, without the padding
    rows."""
    b = -(-rows // extent)
    return [(min(i * b, rows), min((i + 1) * b, rows))
            for i in range(extent)]


def shard_changeset(cs: DenseChangeset, mesh: FaninMesh) -> ShardedChangeset:
    """The ``[R_blk, N_blk]`` block of every mesh position: a view of
    the lanes (row stride N) where the position's device holds them,
    else a copy on that device."""
    grid = mesh.grid
    r, n = cs.lt.shape
    w = n // grid.shape[1]
    blocks = []
    for rank, (r0, r1) in enumerate(_row_ranges(r, grid.shape[0])):
        blocks.append([
            DenseChangeset(*(lane[r0:r1, k * w:(k + 1) * w].to(dev)
                             for lane in cs))
            for k, dev in enumerate(grid[rank])])
    return ShardedChangeset(blocks)


def gather_lane(store: ShardedStore, name: str) -> torch.Tensor:
    """One lane in global slot order, on the first device."""
    home = store.blocks[0][0].lt.device
    return torch.cat([getattr(b, name).to(home) for b in store.blocks[0]])


def gather_store(store: ShardedStore) -> DenseStore:
    """The whole store in global slot order, on the first device."""
    return DenseStore(*(gather_lane(store, f) for f in DenseStore._fields))


def block_joins(store: ShardedStore, cs: ShardedChangeset,
                canonical: torch.Tensor, local_node: int,
                join: Optional[Callable] = None) -> List[List[tuple]]:
    """K1 on every mesh position's block against its store copy: the
    kernel's own outputs ``(lt, node, val, tomb, occupied, win,
    basemax, any_dup)`` per position. ``join=None`` takes the K1 kernel
    for CUDA blocks, one launch per device over all of that device's
    blocks (counted as ``fanin_batch_sharded``), and the plain version
    for CPU blocks; a ``join`` given is called per position."""
    out: List[List[Optional[tuple]]] = [[None] * len(row)
                                        for row in store.blocks]
    by_device = {}
    for rank, (s_row, c_row) in enumerate(zip(store.blocks, cs.blocks)):
        for k, (blk, cblk) in enumerate(zip(s_row, c_row)):
            dev = blk.lt.device
            if join is None and blk.lt.is_cuda:
                by_device.setdefault(dev, []).append((rank, k))
            else:
                out[rank][k] = (join or fanin_join_reference)(
                    blk, cblk, canonical.to(dev), local_node)
    for dev, where in by_device.items():
        joins = fanin_cuda_many(
            [store.blocks[r][k] for r, k in where],
            [cs.blocks[r][k] for r, k in where], canonical.to(dev),
            local_node, count_as="fanin_batch_sharded")
        for (r, k), part in zip(where, joins):
            out[r][k] = part
    return out


def combine_blocks(store: ShardedStore, parts: List[List[tuple]],
                   canonical: torch.Tensor, local_node: int,
                   wall_millis: int
                   ) -> Tuple[ShardedStore, ShardedFaninResult]:
    """The replica-axis combine of `block_joins`' partial stores and the
    global scalars: the JAX block's pmax / masked pmax / stable pmin
    rank / one-hot psum (parallel/fanin.py:318-351), then the winners
    stamped with the GLOBAL canonical (each block's own stamp is never
    made). Every partial is at least the store record (the kernel adopts
    strictly), so their lex max is the whole join."""
    home = store.blocks[0][0].lt.device
    extent = len(parts)
    # One reduction over every position: the canonical absorbs the
    # largest valid record; the flags are its closed-form bounds.
    basemax = torch.stack([p[6].to(home) for row in parts for p in row]
                          ).amax()
    any_dup = torch.stack([p[7].to(home) for row in parts for p in row]
                          ).any()
    new_canonical = torch.maximum(canonical, basemax)
    any_drift = basemax > (((wall_millis + MAX_DRIFT) << SHIFT)
                           | MAX_COUNTER)
    new_blocks: List[List[Optional[DenseStore]]] = [
        [None] * len(parts[0]) for _ in range(extent)]
    wins = []
    for k, blk in enumerate(store.blocks[0]):
        dev = blk.lt.device
        lt, node, val, tomb, occ, win = (
            torch.stack([parts[r][k][i].to(dev) for r in range(extent)])
            for i in range(6))
        p_lt = torch.where(occ, lt, _NEG)
        m1 = p_lt.amax(0)
        m2 = torch.where(p_lt == m1, node, _I32_NEG).amax(0)
        has = (p_lt == m1) & (node == m2)
        rank = torch.arange(extent, device=dev)[:, None]
        mine = has & (rank == torch.where(has, rank, _BIG_RANK).amin(0))
        # The slot is adopted iff the winning position's kernel adopted it.
        g_win = (mine & win).any(0)
        new = DenseStore(
            lt=torch.where(g_win, m1, blk.lt),
            node=torch.where(g_win, m2, blk.node),
            val=torch.where(g_win, torch.where(mine, val, 0).sum(0),
                            blk.val),
            mod_lt=torch.where(g_win, new_canonical.to(dev), blk.mod_lt),
            mod_node=blk.mod_node.masked_fill(g_win, local_node),
            occupied=blk.occupied | g_win,
            tomb=torch.where(g_win, (mine & tomb).any(0), blk.tomb))
        for r, row in enumerate(store.blocks):
            new_blocks[r][k] = new if r == 0 else DenseStore(
                *(x.to(row[k].lt.device, copy=True) for x in new))
        wins.append(g_win.to(home))
    win = torch.cat(wins)
    return ShardedStore(new_blocks), ShardedFaninResult(
        new_canonical=new_canonical,
        win_count=win.sum().to(torch.int32), win=win,
        any_bad=any_dup | any_drift, any_dup=any_dup, any_drift=any_drift)


def make_sharded_fanin(mesh: FaninMesh, *, reference: bool = False):
    """The sharded fan-in step (K1p): ``step(store, cs, canonical_lt,
    local_node, wall_millis) -> (new_store, ShardedFaninResult)`` for a
    `shard_store` store and a `shard_changeset` changeset of this mesh.
    The store is not written: the result is a new sharded store.
    ``reference=True`` is its plain version, the plain per-block join on
    any device (what the card is held against)."""
    join = fanin_join_reference if reference else None

    def step(store: ShardedStore, cs: ShardedChangeset, canonical_lt,
             local_node: int, wall_millis: int):
        canonical = torch.as_tensor(canonical_lt, dtype=torch.int64,
                                    device=mesh.home)
        parts = block_joins(store, cs, canonical, local_node, join)
        return combine_blocks(store, parts, canonical, local_node,
                              wall_millis)

    return step


def make_sharded_ingest(mesh: FaninMesh):
    """The write combiner's commit over a sharded store, IN PLACE:
    ``step(store, slot, lt, val, tomb, me) -> store``. Each key shard
    translates the global slots (a sentinel-padded flush, any device) to
    its local rows; out-of-shard rows and the ``n_slots`` sentinel become
    the local ``n_local`` sentinel and write nothing. The K2 wrapper
    (`ops.ingest_kernel.ingest_scatter`) then commits on every copy of
    the shard: one launch per key shard and copy."""

    def step(store: ShardedStore, slot: torch.Tensor, lt: torch.Tensor,
             val: torch.Tensor, tomb: torch.Tensor, me: int) -> ShardedStore:
        w = store.width
        rows, local = {}, {}      # the flush per device, its slots per shard
        for k in range(mesh.shape[KEY_AXIS]):
            for blk in store.column(k):
                dev = blk.lt.device
                if dev not in rows:
                    rows[dev] = tuple(x.to(dev) for x in (slot, lt, val, tomb))
                if (dev, k) not in local:
                    loc = rows[dev][0] - k * w
                    local[dev, k] = torch.where((loc < 0) | (loc >= w), w,
                                                loc)
                ingest_scatter(blk, local[dev, k], *rows[dev][1:], me)
        return store

    return step


def sharded_delta_mask(mesh: FaninMesh):
    """modifiedSince filter over the sharded store — INCLUSIVE bound —
    computed shard-local: ``fn(store, since_lt) -> bool[N]`` gathered on
    the first device."""

    def fn(store: ShardedStore, since_lt) -> torch.Tensor:
        return torch.cat([dense_delta_mask(b, since_lt).to(mesh.home)
                          for b in store.blocks[0]])

    return fn


def sharded_max_logical_time(mesh: FaninMesh):
    """refreshCanonicalTime's reduction over the sharded store:
    ``fn(store) -> int64 scalar``, each position's max, then one max
    over the mesh."""

    def fn(store: ShardedStore) -> torch.Tensor:
        return torch.stack([dense_max_logical_time(b).to(mesh.home)
                            for row in store.blocks for b in row]).amax()

    return fn


def _check_leaf_width(width: int, leaf_width: int) -> None:
    if width % leaf_width:
        raise ValueError(f"shard width {width} not a multiple of "
                         f"leaf_width {leaf_width}")


def _shard_leaves(blk: DenseStore, k: int, leaf_width: int,
                  home: torch.device,
                  sem: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Key shard ``k``'s leaf digests, mixed against its global slot
    positions (and with the shard's slice of the tag column ``sem``,
    on ``blk``'s device, where the store is typed), on the first
    device."""
    h = slot_digests(blk.lt, blk.val, blk.tomb, blk.occupied, sem=sem,
                     idx_offset=k * blk.n_slots)
    return fold_leaves(h, leaf_width).to(home)


def _shard_sem(sem: Optional[torch.Tensor], k: int, blk: DenseStore
               ) -> Optional[torch.Tensor]:
    """Key shard ``k``'s slice of a global tag column, on ``blk``'s
    device (None stays None)."""
    if sem is None:
        return None
    w = blk.n_slots
    return sem[k * w:(k + 1) * w].to(blk.lt.device)


def make_sharded_digest(mesh: FaninMesh, leaf_width: int):
    """Merkle digest-tree levels over a sharded store: ``fn(store) ->
    levels`` (root-first, on the first device). Each key shard's leaves
    are computed on its rank-0 copy against GLOBAL slot positions
    (``idx_offset``) and concatenated in key order; the interior
    combines then run on the first device. The shard width must be a
    multiple of ``leaf_width``, so no leaf straddles two shards
    (`ShardedDenseCrdt._digest_levels` falls back to the gathered store
    otherwise). The levels equal `ops.digest.digest_tree_device` of the
    gathered store, ``sem`` (a typed store's global tag column) mixed in
    alike; one ``digest_tree`` op a call."""

    def fn(store: ShardedStore, sem: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, ...]:
        _check_leaf_width(store.width, leaf_width)
        obs_device.note_op("digest_tree")
        return tree_levels_from_leaves(torch.cat([
            _shard_leaves(blk, k, leaf_width, mesh.home,
                          _shard_sem(sem, k, blk))
            for k, blk in enumerate(store.blocks[0])]))

    return fn


def make_sharded_compact(mesh: FaninMesh, leaf_width: int):
    """Whole-store compaction over a sharded store: ``fn(store, sem=None)
    -> (new_store, new_sem, translation, levels)``. Each key shard packs
    its rows to its OWN prefix, on every copy alike, so no row crosses a
    shard and every copy stays equal; a typed store's global tag column
    ``sem`` moves with the rows (``new_sem``, else None), and
    ``translation`` (int32, global slots, ``-1`` for empty slots) and
    ``levels`` (the digest tree of the compacted store, leaves against
    global positions as in `make_sharded_digest`) come back on the first
    device. The shard width must be a multiple of ``leaf_width``; one
    ``compact_remap`` op a call."""

    def fn(store: ShardedStore, sem: Optional[torch.Tensor] = None):
        w = store.width
        _check_leaf_width(w, leaf_width)
        obs_device.note_op("compact_remap")
        new_blocks = [[None] * len(row) for row in store.blocks]
        translation, leaves, new_sem = [], [], []
        for k in range(len(store.blocks[0])):
            for rank, blk in enumerate(store.column(k)):
                keep = blk.occupied
                whole = torch.tensor([0, w], device=keep.device)
                new_slot = compact_targets(keep, whole[:1], whole[1:])
                new_blocks[rank][k] = remap_rows(blk, keep, new_slot)
                if rank == 0:
                    translation.append(torch.where(
                        keep, new_slot + k * w, -1).to(torch.int32)
                        .to(mesh.home))
                    sem_k = _shard_sem(sem, k, blk)
                    if sem_k is not None:
                        sem_k = remap_lane(sem_k, keep, new_slot)
                        new_sem.append(sem_k.to(mesh.home))
            leaves.append(_shard_leaves(new_blocks[0][k], k, leaf_width,
                                        mesh.home, sem_k))
        return (ShardedStore(new_blocks),
                torch.cat(new_sem) if new_sem else None,
                torch.cat(translation),
                tree_levels_from_leaves(torch.cat(leaves)))

    return fn


def make_sharded_typed_fanin(mesh: FaninMesh):
    """The typed fan-in over a sharded store: ``fn(store, sem, cs,
    canonical_lt, local_node, wall_millis) -> (new_store,
    BatchResult)``. The recv guards (exact, in row-major visit order)
    and the absorbed canonical come from the whole changeset on the
    first device; then every copy of each key shard folds the
    changeset's columns of that shard into itself
    (`semantics.kernels.typed_fold`: one typed join per row, no store
    gathered, no kernel). The typed joins are elementwise, so each copy
    ends equal to the unsharded fold's slice. ``win`` comes back
    gathered on the first device; one ``typed_fanin_step`` op a
    call."""

    def fn(store: ShardedStore, sem: torch.Tensor, cs: DenseChangeset,
           canonical_lt, local_node: int, wall_millis: int):
        obs_device.note_op("typed_fanin_step")
        new_canonical, any_bad = typed_guards(cs, canonical_lt,
                                              local_node, wall_millis)
        w = store.width
        blocks = [[None] * len(row) for row in store.blocks]
        wins = []
        for k in range(len(store.blocks[0])):
            for rank, blk in enumerate(store.column(k)):
                dev = blk.lt.device
                part = DenseChangeset(*(lane[:, k * w:(k + 1) * w].to(dev)
                                        for lane in cs))
                blocks[rank][k], win = typed_fold(
                    blk, _shard_sem(sem, k, blk), part,
                    new_canonical.to(dev), local_node)
                if rank == 0:
                    wins.append(win.to(mesh.home))
        return ShardedStore(blocks), typed_result(
            new_canonical, torch.cat(wins), cs, any_bad)

    return fn
