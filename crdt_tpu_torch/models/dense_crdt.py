"""DenseCrdt — a device-resident LWW map over a dense integer key space.

Port of the unsharded ``crdt_tpu.models.dense_crdt.DenseCrdt`` main
path: keys ARE slot indices ``[0, n_slots)`` and values are int64
scalars (or indices into an application-side table), so every operation
is a batched tensor op. The replication loop:

- **Local writes.** ``put_batch``/``delete_batch`` stamp one HLC per
  call; inside ``ingest()`` they stage in a `WriteCombiner` whose flush
  commits through the ingest kernel (`ops.ingest_kernel`).
- **Remote merges.** ``merge``/``merge_many`` run one fan-in join per
  merge through the batch kernel (`ops.fanin_kernel`); a tripped
  superset guard flag is recomputed exactly (`ops.merge.recv_guards`)
  and raises the reference's exception types (hlc.dart:164-189). A
  ``pipelined()`` window threads the clock on the device: coarse, or
  with ``exact_guards=True`` one exact guard pass per merge.
- **The JAX peers' wire form.** ``export_split_delta`` ships the split
  32-bit lanes (`ops.split`) that ``merge_split`` takes back through the
  pre-split kernel, with no conversion to wide lanes.
- **Deltas out.** ``export_delta``, ``pack_since``, ``record_map`` and
  ``to_json`` select rows through `ops.dense.dense_delta_mask`;
  ``pack_since`` keeps a clock-keyed cache of its packs.
- **Columnar deltas in.** ``merge_packed`` (a peer's ``pack_since``,
  either package), ``merge_json``, ``merge_records`` and the gossip
  relay ``merge_and_repack`` validate on the host, fold the recv guards
  in the payload's visit order (`utils.host_guards`), then join through
  `ops.dense.sparse_fanin_step` (or `wire_join_step` when the delta
  covers a quarter of the slots or more), in place.
- **Anti-entropy.** ``digest_tree`` builds the Merkle digest tree of
  the replicated lanes (`ops.digest`, cached until the store changes,
  persisted by ``save``), which `crdt_tpu_torch.sync.sync_merkle` walks
  against a peer's before it ships the divergent leaf ranges through
  ``pack_since(ranges=...)``.
- **Storage.** ``gc_purge`` drops the tombstones a fleet stability
  watermark has passed and arms the resurrection fence that the merge
  paths apply; ``compact`` packs the surviving rows to a dense prefix
  and returns the slot translation.
- **Typed slots.** ``set_semantics`` gives slots a registered semantics
  (`crdt_tpu_torch.semantics`: counters, an OR-set, a multi-value
  register) kept as a host tag column; the typed ops (``counter_add``,
  ``orset_add``, ``mvreg_put``, ...) write encoded lanes through the
  ordinary writes (so the ingest kernel still carries them), and every
  merge of a typed store takes the typed joins (plain torch, as the
  JAX package takes XLA code there): never the LWW fan-in kernels.
  ``pack_since(sem_mode=...)`` attaches the tag lane or withholds typed
  rows, and ``merge_packed`` refuses a tag that differs from the local
  column before it touches the clock.

`ShardedDenseCrdt` is the same model with its key space sharded over a
device mesh (`crdt_tpu_torch.parallel`); `sync_dense` is one
anti-entropy round between two replicas.

Device rule: the store lives on ``device``, which defaults to
``"cuda"``; without a card the constructor raises unless the caller
asks for ``device="cpu"``. Each op wrapper takes the hand-written
kernel for CUDA tensors and its plain torch version for CPU tensors.
"""

from __future__ import annotations

import sys
from collections import OrderedDict
from contextlib import contextmanager
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import crdt_json
from ..analysis import sanitizer as _sanitizer
from ..obs.registry import default_registry
from ..obs.trace import span
from ..hlc import (MAX_COUNTER, MAX_DRIFT, SHIFT, ClockDriftException,
                   DuplicateNodeException, Hlc, wall_clock_millis)
from ..ops.dense import (CHANGESET_DTYPES, DenseChangeset, DenseStore,
                         compact_remap, delete_scatter, dense_delta_mask,
                         dense_max_logical_time, dense_range_delta_mask,
                         empty_dense_store, gc_purge, merge_repack_step,
                         put_scatter, range_delta_mask, record_scatter,
                         sparse_fanin_step, store_to_changeset,
                         wire_join_step)
from ..ops.digest import (DEFAULT_LEAF_WIDTH, build_digest_tree,
                          digest_tree_device)
from ..ops.fanin_kernel import (STAMP_SPAN, mask_value_width,
                                model_fanin_join, model_fanin_split_join)
from ..ops.fanin_tail import PipeState, Stamped, merge_tail
from ..ops.ingest_kernel import ingest_scatter
from ..ops.merge import recv_guards
from ..ops.packing import NodeTable, PackedDelta, pack_into_arena
from ..parallel.fanin import (KEY_AXIS, gather_lane, gather_store,
                              make_sharded_compact, make_sharded_digest,
                              make_sharded_fanin, make_sharded_ingest,
                              make_sharded_typed_fanin, shard_changeset,
                              shard_store, sharded_delta_mask,
                              sharded_max_logical_time)
from ..ops.split import (MAX_NODE_ORDINAL, SPLIT_DTYPES, TILE,
                         NarrowSplitChangeset, SplitChangeset, _cs_shape,
                         split_changeset, split_changeset_narrow,
                         split_guard_lanes, split_to_wide, tile_changeset)
from ..record import (KeyDecoder, KeyEncoder, Record, ValueDecoder,
                      ValueEncoder)
from ..semantics import (ORSET_MAX_LEN, ORSET_UNIVERSE, SemanticsSpec,
                         by_tag, get_semantics)
from ..semantics.kernels import (_PN_HALF, typed_fanin_step,
                                 typed_sparse_join_step,
                                 typed_wire_join_step)
from ..utils.devices import resolve_device  # noqa: F401 (re-exported)
from ..utils.host_guards import recv_fold_columns
from ..utils.stats import MergeStats, merge_annotation
from ..watch import ChangeHub, ChangeStream


# The merge step's spans (`obs.trace.span`: nothing unless the tracer
# is on or a profiler records), beside `merge_annotation`'s
# ``crdt_tpu_torch.dense_merge`` around the dispatch and
# `ops.fanin_kernel`'s mask, join and stamp spans inside it.
MERGE_SPAN = "crdt_tpu_torch.merge"
PREPARE_SPAN = "crdt_tpu_torch.merge.prepare"
FENCE_SPAN = "crdt_tpu_torch.window.fence"


class PipelinedGuardError(Exception):
    """A clock guard tripped inside a ``DenseCrdt.pipelined()`` window.

    Pipelined merges trade first-offender diagnostics for zero
    per-merge host synchronization: guard flags accumulate on device
    and are checked once at the window's end, so all this error can
    say is WHICH guard class fired. Re-run the same batches
    unpipelined for the exact diagnosis (the store already holds the
    merged state — merge is idempotent, a re-run is safe).
    """


def reencode(store: DenseStore, remap: np.ndarray) -> DenseStore:
    """The store with its ordinal lanes rewritten old -> new through
    ``remap`` (a node table re-sorted by newly interned ids)."""
    rd = torch.from_numpy(remap).to(store.lt.device)
    return store._replace(node=rd[store.node.long()],
                          mod_node=rd[store.mod_node.long()])


class DenseCrdt:
    """LWW-map CRDT over slots ``[0, n_slots)`` with int64 values."""

    def __init__(self, node_id: Any, n_slots: int, *, device=None,
                 wall_clock: Optional[Callable[[], int]] = None,
                 node_ids: Optional[Sequence[Any]] = None,
                 value_width: int = 64,
                 store: Optional[DenseStore] = None):
        if value_width not in (64, 32):
            raise ValueError(f"value_width must be 64 or 32, got "
                             f"{value_width}")
        # value_width=32 — the value-ref mode: values are int32-range
        # scalars or payload-table indices; wider values are rejected
        # on writes and masked out of merges (never truncated).
        self._value_width = value_width
        self._device = resolve_device(device)
        self._node_id = node_id
        self._wall_clock = wall_clock or wall_clock_millis
        # A seeded store's ordinal lanes index sorted(node_ids): build
        # that table first, then intern our own id (re-encoding lanes
        # if it sorts into the middle).
        self._table = NodeTable(node_ids or [])
        # pack_since cache (watermark key -> packed delta) and the
        # digest_tree cache (one (key, DigestTree) pair); both must exist
        # before the first store assignment, which clears them.
        self._pack_cache: "OrderedDict[Any, Any]" = OrderedDict()
        self._digest_cache: Optional[Tuple[Any, Any]] = None
        self._store_gen = 0
        # The per-slot semantics tags (host int8, None while every slot
        # is LWW), their device mirror, and the version the pack, digest
        # and snapshot keys carry.
        self._sem: Optional[np.ndarray] = None
        self._sem_dev: Optional[torch.Tensor] = None
        self._sem_version = 0
        # Tombstone GC: the armed fence floor (a packed logical time),
        # the last floor purged at (an unadvanced watermark costs
        # nothing), and the fence mask of the slots GC purged, on the
        # store's device (`_fence_add`). The merge paths drop sub-floor
        # rows onto fenced slots; compaction retires the fence.
        self._gc_floor_lt = 0
        self._last_gc_floor_lt = 0
        self._gc_fence = None
        # Under the sanitizer: ``(purged slots, floor)`` of the GC passes
        # since the last compaction, on the device, or None.
        self._gc_purged: Optional[Tuple[torch.Tensor, int]] = None
        self._store = self._adopt_store(n_slots, store)
        if self._store.n_slots != n_slots:
            raise ValueError(f"store holds {self._store.n_slots} slots but "
                             f"n_slots={n_slots}")
        # Writes update the lanes in place; a store the caller may still
        # hold (a seed, or one handed out by `store`/`values`/
        # `export_delta`) is cloned before the next write instead.
        self._store_escaped = store is not None
        if node_id not in self._table:
            self._intern_ids([node_id])
        self.stats = MergeStats().register(backend="DenseCrdt",
                                           node=str(node_id))
        self._hub = ChangeHub()
        self._pipe: Optional[PipeState] = None
        self._ingest = None     # active WriteCombiner (models/ingest.py)
        self.refresh_canonical_time()

    def _adopt_store(self, n_slots: int, store: Optional[DenseStore]):
        """The store lanes this replica starts from, on its device."""
        if store is None:
            return empty_dense_store(n_slots, self._device)
        return DenseStore(*(lane.to(self._device) for lane in store))

    # --- clock (crdt.dart:8-33,114-121) ---

    @property
    def node_id(self) -> Any:
        return self._node_id

    @property
    def n_slots(self) -> int:
        return self._store.n_slots

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def canonical_time(self) -> Hlc:
        return self._canonical_time

    @property
    def _store(self) -> DenseStore:
        return self._store_lanes

    @_store.setter
    def _store(self, store: DenseStore) -> None:
        # Every store replacement (merges, grow, ordinal remaps) passes
        # here, every in-place write through `_touch_store`: either
        # drops the cached packs.
        self._store_lanes = store
        self._touch_store()

    def _touch_store(self) -> None:
        self._store_gen += 1
        self._pack_cache.clear()
        self._digest_cache = None

    @property
    def store_generation(self) -> int:
        """Count of store changes: every replacement and in-place write
        bumps it, `gc_purge` and `compact` included, which do not
        advance the canonical clock; the pack and digest cache keys
        carry it."""
        return self._store_gen

    @property
    def gc_floor(self) -> int:
        """The armed resurrection fence: the highest purge floor (a
        packed logical time) any `gc_purge` ran at, or 0. The merge
        paths drop inbound rows at or below it that target a purged
        slot."""
        return self._gc_floor_lt

    @property
    def store(self) -> DenseStore:
        """Live store lanes. Reading this marks the snapshot as handed
        out: the next local write clones it instead of writing in
        place, so a snapshot you hold stays as it was."""
        self.drain_ingest()
        self._store_escaped = True
        return self._store

    def refresh_canonical_time(self) -> None:
        self.drain_ingest()
        self._canonical_time = Hlc.from_logical_time(
            int(dense_max_logical_time(self._store)), self._node_id)

    def _canonical_lt(self) -> torch.Tensor:
        """The canonical logicalTime as a device scalar — the live
        pipeline clock inside a ``pipelined()`` window."""
        if self._pipe is not None:
            return self._pipe.canonical
        return torch.tensor(self._canonical_time.logical_time,
                            dtype=torch.int64, device=self._device)

    def _local_ordinal(self) -> int:
        return self._table.ordinal(self._node_id)

    @contextmanager
    def pipelined(self, exact_guards: bool = False):
        """Zero-host-sync merge window: inside it, ``merge`` /
        ``merge_many`` / ``merge_split`` thread the canonical clock as a
        DEVICE scalar (the final send bump runs on device,
        `ops.merge.send_step`) and accumulate guard flags instead of
        fetching them. On exit, ONE readback materializes the clock and
        raises if a guard fired. Each merge takes the route it takes
        unpipelined up to its join; its tail (`ops.fanin_tail`: the
        stamp, then the window's step in `PipeState`: flags, the first
        flagged merge, the send bump) follows it on the device, in one
        kernel launch after a K1 or K1s join on the card.

        Merges land optimistically (a guard violation is already in the
        store when the flush reports it). In a coarse window the recv
        flags are the kernels' superset flags, so a `PipelinedGuardError`
        may be spurious: re-run the batches unpipelined to find out.
        ``exact_guards=True`` spends one exact guard pass per merge
        (`ops.merge.recv_guards`, seeded with the threaded canonical —
        the unpipelined path's flags) and the flush raises the
        reference's own `DuplicateNodeException`/`ClockDriftException`
        with the unpipelined payloads; a value-ref overflow is reported
        before them, and both before the send flags. Store lanes and the
        canonical clock equal the same merges issued unpipelined. Local
        writes are refused inside the window (they need the host clock).
        An active watch subscriber costs one readback per merge."""
        if self._pipe is not None:
            raise RuntimeError("pipelined() windows do not nest")
        # Staged ingest rows would otherwise commit with stamps the
        # window never sees — barrier first.
        self.drain_ingest()
        self._pipe = PipeState(self._canonical_time.logical_time,
                               self._device, exact=exact_guards,
                               value_width=self._value_width)
        try:
            yield self
        finally:
            pipe, self._pipe = self._pipe, None
            # Never shadow an exception already leaving the window body.
            leaving = sys.exc_info()[0] is not None
            with span(FENCE_SPAN):
                self._close_window(pipe, report=not leaving)

    def _close_window(self, pipe: PipeState, report: bool) -> None:
        """A window's end: ONE readback materializes the clock, and the
        flags are reported when ``report``."""
        (lt, any_bad, overflow, drift, val_ovf, first_idx, ex_have,
         ex_dup, ex_lt, ex_wall) = torch.stack(
            [pipe.canonical, pipe.any_bad.long(), pipe.overflow.long(),
             pipe.drift.long(), pipe.val_overflow.long(),
             pipe.first_flag_idx.long(), pipe.ex_have.long(),
             pipe.ex_dup.long(), pipe.ex_lt, pipe.ex_wall]).tolist()
        self._canonical_time = Hlc.from_logical_time(lt, self._node_id)
        if report:
            self._flush_report(pipe, any_bad, overflow, drift, val_ovf,
                               first_idx, ex_have, ex_dup, ex_lt, ex_wall)

    def _flush_report(self, pipe: PipeState, any_bad, overflow, drift,
                      val_ovf, first_idx, ex_have, ex_dup, ex_lt,
                      ex_wall) -> None:
        def coarse(include_recv: bool) -> None:
            kinds = [k for k, f in (
                ("recv-guard (duplicate-node or drift)",
                 any_bad and include_recv),
                ("recv-guard (exact: " + ("duplicate-node" if ex_dup
                                          else "drift") + ")",
                 pipe.exact and ex_have),
                ("send counter overflow", overflow),
                ("send drift", drift),
                ("value-ref overflow (records with values past int32 "
                 "were SKIPPED, not merged; re-sync from the peer with a "
                 "value_width=64 replica)", val_ovf)) if f]
            raise PipelinedGuardError(
                f"guards tripped in pipelined window: {', '.join(kinds)}; "
                f"first flagged at merge #{first_idx} of {pipe.merges} "
                "(0-based, window order)"
                + ("" if pipe.exact else
                   "; possibly spurious (superset flags) — re-run from "
                   "that batch unpipelined for the exact diagnosis, or "
                   "open the window with exact_guards=True"))

        if not pipe.exact:
            if any_bad or overflow or drift or val_ovf:
                coarse(include_recv=True)
            return
        # Exact mode keeps the unpipelined priority: a value overflow
        # (records SKIPPED) is never eaten by a typed raise, and the recv
        # guard preempts the send flags of the merge it let through.
        if val_ovf:
            coarse(include_recv=False)
        if ex_have:
            if ex_dup:
                raise DuplicateNodeException(str(self._node_id))
            raise ClockDriftException(ex_lt >> SHIFT, ex_wall)
        if overflow or drift:
            coarse(include_recv=False)

    # --- ingest fast lane (models/ingest.py) ---

    @contextmanager
    def ingest(self, auto_flush_rows: int = 1 << 16):
        """Write-combining window: inside it, ``put_batch`` /
        ``delete_batch`` stage into host buffers instead of launching a
        scatter per call. Staged rows commit as ONE ingest-kernel
        launch stamped by ONE `Hlc.send_batch` — each staged call keeps
        its own strictly later HLC, so per-record LWW order is exactly
        the unbatched outcome. Flushes happen when the backlog reaches
        ``auto_flush_rows``, at any barrier (`drain_ingest`), on
        ``wc.flush()`` and at window exit.

        Point reads (``get``/``contains_slot``/``is_deleted``) answer
        from the staging overlay; every other surface drains first.
        Change events fire at COMMIT. Staged calls share one flush-time
        wall read, so injected clocks tick differently than unbatched
        writes. Yields the `WriteCombiner`."""
        self._refuse_in_pipeline("ingest")
        if self._ingest is not None:
            raise RuntimeError("ingest() windows do not nest")
        from .ingest import WriteCombiner
        wc = WriteCombiner(self, auto_flush_rows=auto_flush_rows)
        self._ingest = wc
        try:
            yield wc
        finally:
            try:
                wc.flush("exit")
            except Exception:
                # Never shadow the exception that interrupted the body;
                # with none in flight the flush failure IS the error.
                if sys.exc_info()[0] is None:
                    raise
            finally:
                self._ingest = None

    def drain_ingest(self) -> bool:
        """Commit any staged ingest-window writes NOW. No-op outside a
        window (returns False)."""
        ing = self._ingest
        return False if ing is None else ing.flush("barrier")

    @staticmethod
    def _last_wins_order(slots: np.ndarray
                         ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """``(keep, order)`` from ONE sort: ``keep`` the indices keeping
        the LAST occurrence per duplicate slot in payload order (None
        when already unique), ``order`` the same rows' indices in slot
        order, which the ingest kernel's stores want."""
        slots = np.asarray(slots, np.int64)
        k = len(slots)
        lo, hi = (int(slots.min()), int(slots.max())) if k else (0, 0)
        if -(1 << 62) // max(k, 1) <= lo and hi < (1 << 62) // max(k, 1):
            # (slot, position) in one int64 key: the keys are unique, so
            # the unstable sort (a quarter of a stable sort's time here)
            # orders each slot's rows by position.
            by_slot = np.argsort(slots * k + np.arange(k))
        else:   # slots far outside any store, which validation refuses
            by_slot = np.argsort(slots, kind="stable")
        ordered = slots[by_slot]
        last = np.ones(k, bool)     # the last row of each slot's run
        np.not_equal(ordered[1:], ordered[:-1], out=last[:-1])
        order = by_slot[last]
        return (None if len(order) == k else np.sort(order)), order

    @classmethod
    def _last_wins_keep(cls, slots: np.ndarray) -> Optional[np.ndarray]:
        """Indices keeping the LAST occurrence per duplicate slot, or
        None when already unique."""
        return cls._last_wins_order(slots)[0]

    def _commit_scatter(self, slots: np.ndarray, lt: np.ndarray,
                        vals: np.ndarray, tombs: np.ndarray,
                        order: np.ndarray) -> None:
        """ONE ingest-kernel launch committing rows ``order`` (unique
        slots, in slot order) of a flush."""
        # crdtlint: disable=scatter-combiner-bypass -- only reached from the combiner's own flush, which IS the barrier
        ingest_scatter(self._writable_store(),
                       *self._flush_lanes(slots, lt, vals, tombs, order),
                       self._local_ordinal())

    def _flush_lanes(self, slots: np.ndarray, lt: np.ndarray,
                     vals: np.ndarray, tombs: np.ndarray, order: np.ndarray
                     ) -> Tuple[torch.Tensor, ...]:
        """Rows ``order`` of a flush as ingest-kernel rows on the device,
        padded to a power of two with ``slot == n_slots`` sentinels, so a
        steady stream of flushes reuses a few allocation sizes. The
        gather into the padded lanes is the copy the padding makes
        anyway."""
        d = len(order)
        padded = 1 << max(d - 1, 1).bit_length()
        slot_l = np.full(padded, self.n_slots, np.int64)
        lt_l = np.zeros(padded, np.int64)
        val_l = np.zeros(padded, np.int64)
        tomb_l = np.zeros(padded, bool)
        for src, dst in ((slots, slot_l), (lt, lt_l), (vals, val_l),
                         (tombs, tomb_l)):
            np.take(src, order, out=dst[:d], mode="clip")
        return tuple(self._to_device(a) for a in (slot_l, lt_l, val_l, tomb_l))

    # --- local ops: one send per batch (crdt.dart:39-54) ---

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # A copy even on the host: the lanes must not alias the
        # caller's (or the combiner's reusable) numpy buffers.
        return torch.tensor(arr, device=self._device)

    def _writable_store(self) -> DenseStore:
        """The live lanes, safe to update in place: a store that has
        been handed out is cloned first."""
        if self._store_escaped:
            self._store = DenseStore(*(lane.clone() for lane in self._store))
            self._store_escaped = False
        self._touch_store()
        return self._store

    def _gathered(self) -> DenseStore:
        """The store as one `DenseStore` in slot order, on this
        replica's device (the sharded model gathers a copy)."""
        return self._store

    def _refuse_in_pipeline(self, op: str) -> None:
        if self._pipe is not None:
            raise RuntimeError(
                f"{op} needs the host clock; it cannot run inside a "
                "pipelined() merge window — exit the window first")

    def _check_slots(self, slots: np.ndarray) -> None:
        if slots.size and (slots.min() < 0 or slots.max() >= self.n_slots):
            raise IndexError(
                f"slot indices must be within [0, {self.n_slots}); got "
                f"range [{slots.min()}, {slots.max()}]")

    def _check_value_width(self, values) -> None:
        if self._value_width == 32:
            v = np.asarray(values, np.int64)
            if v.size and (v.min() < -(2 ** 31) or v.max() >= 2 ** 31):
                raise ValueError(
                    "value_width=32 replica got a value outside int32 "
                    "range; use value_width=64 or store a payload-"
                    "table index instead")

    def put_batch(self, slots, values, tombs=None) -> None:
        """Write values at slot indices; the whole batch shares ONE
        freshly sent HLC (putAll semantics, crdt.dart:46-54). ``tombs``
        (bool per entry) tombstones those entries under the same stamp.
        A slot repeated within the batch takes its last entry, every
        lane from that one entry."""
        self._refuse_in_pipeline("put_batch")
        slots = np.asarray(slots, np.int64).reshape(-1)
        self._check_slots(slots)
        self._check_value_width(values)
        values = np.ascontiguousarray(np.broadcast_to(
            np.asarray(values, np.int64), slots.shape))
        tombs = None if tombs is None else np.ascontiguousarray(
            np.broadcast_to(np.asarray(tombs, bool), slots.shape))
        if self._ingest is not None:
            # Validation ran eagerly; the rows wait for the flush stamp.
            self._ingest.stage(slots, values, tombs)
            return
        self._canonical_time = Hlc.send(self._canonical_time,
                                        millis=self._wall_clock())
        self._write_local(slots, values, tombs)
        self.stats.puts += 1
        self.stats.records_put += int(slots.shape[0])
        self._emit_put(slots, values, tombs)

    def delete_batch(self, slots) -> None:
        """Tombstone slots (delete = put None, crdt.dart:58)."""
        self._refuse_in_pipeline("delete_batch")
        slots = np.asarray(slots, np.int64).reshape(-1)
        self._check_slots(slots)
        if self._ingest is not None:
            self._ingest.stage(slots, np.zeros(slots.shape[0], np.int64),
                               np.ones(slots.shape[0], bool))
            return
        self._canonical_time = Hlc.send(self._canonical_time,
                                        millis=self._wall_clock())
        self._write_local(slots, None, None)
        self.stats.puts += 1
        self.stats.records_put += int(slots.shape[0])
        self._emit_delete(slots)

    def _last_wins(self, slots: np.ndarray, values: Optional[np.ndarray],
                   tombs: Optional[np.ndarray]):
        """A local batch with only the last entry of each repeated slot.
        Each lane is scattered on its own, and on the card the winner
        among repeated indices is unspecified lane by lane, so a put
        could keep one entry's ``val`` and another's ``tomb``. A delete
        (``values=None``) writes the same words for every entry and
        cannot tear: it goes through as it is."""
        keep = None if values is None else self._last_wins_keep(slots)
        if keep is None:
            return slots, values, tombs
        return (slots[keep], values[keep],
                None if tombs is None else tombs[keep])

    def _write_local(self, slots: np.ndarray, values: Optional[np.ndarray],
                     tombs: Optional[np.ndarray]) -> None:
        """Scatter one local batch under the freshly sent stamp: a put,
        or with ``values=None`` a delete."""
        slots, values, tombs = self._last_wins(slots, values, tombs)
        t, me = self._canonical_time.logical_time, self._local_ordinal()
        store, idx = self._writable_store(), self._to_device(slots)
        if values is None:
            # crdtlint: disable=scatter-combiner-bypass -- only reached from put_batch / delete_batch after their ingest() branch staged the rows and returned, so no window is open here
            delete_scatter(store, idx, t, me)
        else:
            # crdtlint: disable=scatter-combiner-bypass -- only reached from put_batch / delete_batch after their ingest() branch staged the rows and returned, so no window is open here
            put_scatter(store, idx, self._to_device(values), t, me,
                        tombs=None if tombs is None
                        else self._to_device(tombs))

    # --- views (tombstones excluded, crdt.dart:16-29) ---

    @property
    def values(self) -> torch.Tensor:
        """int64[n_slots]; only occupied, non-tombstoned slots are live.
        Hands out the live lane, so (like ``store``) it marks the
        snapshot as handed out."""
        self.drain_ingest()
        self._store_escaped = True
        return self._store.val

    @property
    def live_mask(self) -> torch.Tensor:
        """bool[n_slots]: occupied and not tombstoned."""
        self.drain_ingest()
        store = self._gathered()
        return store.occupied & ~store.tomb

    def __len__(self) -> int:
        return int(self.live_mask.sum())

    def clear(self, purge: bool = False) -> None:
        """Tombstone every LIVE slot with one batch HLC, or physically
        purge (crdt.dart:67-73: clear = putAll(None for live keys))."""
        if purge:
            return self.purge()
        slots = torch.nonzero(self.live_mask).reshape(-1).cpu().numpy()
        if slots.size:            # an empty putAll never touches the clock
            self.delete_batch(slots)

    def purge(self) -> None:
        """Physically drop every record (crdt.dart:168-169). The
        canonical clock, the node table and the GC fence are
        untouched."""
        self.drain_ingest()
        self._store = self._adopt_store(self.n_slots, None)
        self._store_escaped = False

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise IndexError(
                f"slot {slot} out of range [0, {self.n_slots})")

    def _slot_fields(self, slot: int, *names: str) -> List[int]:
        """Lanes ``names`` at ``slot`` in ONE device→host copy."""
        return torch.stack([getattr(self._store, f)[slot].long()
                            for f in names]).tolist()

    def get(self, slot: int) -> Optional[int]:
        self._check_slot(slot)
        if self._ingest is not None:
            # Read-your-writes: a staged row's later flush stamp beats
            # anything the store holds, so this IS the committed answer.
            staged, v = self._ingest.pending_value(slot)
            if staged:
                return v
        occ, tomb, val = self._slot_fields(slot, "occupied", "tomb", "val")
        return val if occ and not tomb else None

    def get_slot_record(self, slot: int) -> Optional[Record]:
        """Single-slot `Record` fetch (getRecord, crdt.dart:146)."""
        self._check_slot(slot)
        # Staged rows only get stamps at flush — drain first.
        self.drain_ingest()
        occ, lt, node, val, mod_lt, mod_node, tomb = self._slot_fields(
            slot, "occupied", "lt", "node", "val", "mod_lt", "mod_node",
            "tomb")
        if not occ:
            return None
        ids = self._table.ids()
        return Record(Hlc._raw(lt >> SHIFT, lt & MAX_COUNTER, ids[node]),
                      None if tomb else val,
                      Hlc._raw(mod_lt >> SHIFT, mod_lt & MAX_COUNTER,
                               ids[mod_node]))

    def contains_slot(self, slot: int) -> bool:
        """True if the slot holds a record, live OR tombstoned
        (containsKey, crdt.dart:141)."""
        self._check_slot(slot)
        if self._ingest is not None \
                and self._ingest.pending_value(slot)[0]:
            return True
        return bool(self._slot_fields(slot, "occupied")[0])

    def is_deleted(self, slot: int) -> Optional[bool]:
        """None for never-written slots, else the tombstone flag
        (crdt.dart:61-64)."""
        self._check_slot(slot)
        if self._ingest is not None:
            staged, v = self._ingest.pending_value(slot)
            if staged:
                return v is None
        occ, tomb = self._slot_fields(slot, "occupied", "tomb")
        return bool(tomb) if occ else None

    # --- per-slot semantics (crdt_tpu_torch.semantics) ---

    def _sem_host(self) -> np.ndarray:
        """The per-slot tag column as host int8 (all zeros when every
        slot is LWW). Changed only through `_set_sem`, which versions
        it."""
        if self._sem is None:
            return np.zeros(self.n_slots, np.int8)
        return self._sem

    def _sem_device(self) -> torch.Tensor:
        """The tag column on this replica's device, rebuilt after each
        change."""
        if self._sem_dev is None:
            self._sem_dev = self._to_device(self._sem_host())
        return self._sem_dev

    def _set_sem(self, sem: np.ndarray) -> None:
        """Install a new tag column (None once every slot is LWW again)
        and bump the version the cache and snapshot keys carry."""
        self._sem = sem if sem.any() else None
        self._sem_dev = None
        self._sem_version += 1

    def set_semantics(self, slots, semantics) -> None:
        """Assign a registered semantics (`crdt_tpu_torch.semantics`) to
        slots, by spec, name or tag. Typed slots join through their
        tag's sub-semilattice instead of the LWW winner-takes-all rule;
        the clock lanes, watermarks and guards are unchanged.

        This is replica-local configuration, not replicated state: every
        peer runs the same migration before it syncs typed slots (the
        packed wire form carries the tags and refuses a mismatch).
        Migrating a slot does not rewrite its lane: migrate before the
        first write."""
        self._refuse_in_pipeline("set_semantics")
        self.drain_ingest()
        if isinstance(semantics, SemanticsSpec):
            spec = semantics
        elif isinstance(semantics, str):
            spec = get_semantics(semantics)
        else:
            spec = by_tag(int(semantics))
        if spec.tag != 0 and self._value_width != 64:
            raise ValueError(
                "typed semantics pack state into the full int64 value "
                "lane; this replica was built with value_width=32")
        slots = np.asarray(slots, np.int32).reshape(-1)
        self._check_slots(slots)
        sem = self._sem_host().copy()
        sem[slots] = np.int8(spec.tag)
        self._set_sem(sem)
        # Cached packs may hold rows under the old tags (or withhold rows
        # now LWW), and the digests mix the tags.
        self._pack_cache.clear()
        self._digest_cache = None

    def semantics_of(self, slot: int) -> SemanticsSpec:
        """The registered `SemanticsSpec` governing a slot."""
        self._check_slot(slot)
        return by_tag(0 if self._sem is None else int(self._sem[slot]))

    def _lane_value(self, slot: int) -> int:
        """The raw int64 lane at a slot, ingest-overlay aware: what a
        typed read-modify-write builds on. A tombstone does not zero a
        typed lane (deletion is the LWW action on top; un-deleting
        reveals the converged state), so this reads the lane itself."""
        if self._ingest is not None:
            staged, v = self._ingest.pending_value(slot)
            if staged:
                return 0 if v is None else int(v)
        occ, val = self._slot_fields(slot, "occupied", "val")
        return val if occ else 0

    def _typed_spec(self, slot: int, *names: str) -> SemanticsSpec:
        self._check_slot(slot)
        spec = self.semantics_of(slot)
        if spec.name not in names:
            raise TypeError(
                f"slot {slot} holds {spec.name!r} semantics; this op "
                f"needs {' / '.join(names)} (set_semantics first)")
        return spec

    def counter_add(self, slot: int, delta: int) -> int:
        """Add ``delta`` to a counter slot and return the new decoded
        value. ``gcounter`` slots refuse negative deltas; ``pncounter``
        slots credit the pos or neg half. Inside ``ingest()`` the staged
        overlay makes consecutive adds accumulate. One writer per slot:
        the join is a per-lane max, so concurrent writers on one slot
        lose increments (give each replica its own slot and sum)."""
        spec = self._typed_spec(slot, "gcounter", "pncounter")
        delta = int(delta)
        lane = self._lane_value(slot)
        if spec.name == "gcounter":
            if delta < 0:
                raise ValueError(
                    "gcounter is grow-only; use pncounter semantics "
                    "for decrements")
            lane = lane + delta
            if lane >= 1 << 63:
                raise OverflowError("gcounter lane overflow")
        else:
            pos = (lane >> 32) & _PN_HALF
            neg = lane & _PN_HALF
            if delta >= 0:
                pos += delta
            else:
                neg -= delta
            if pos > _PN_HALF or neg > _PN_HALF:
                raise OverflowError(
                    "pncounter half overflow (31 bits per direction)")
            lane = (pos << 32) | neg
        self.put_batch([slot], [lane])
        return int(spec.decode(lane))

    def counter_value(self, slot: int) -> int:
        """Decoded counter value at a slot (pos - neg for pncounter)."""
        spec = self._typed_spec(slot, "gcounter", "pncounter")
        return int(spec.decode(self._lane_value(slot)))

    def _orset_step(self, slot: int, element: int, odd: bool) -> frozenset:
        """Bump an element's causal length to the next ``odd`` (add) or
        even (remove) value; a no-op when it already is. Returns the
        membership."""
        spec = self._typed_spec(slot, "orset")
        e = int(element)
        if not 0 <= e < ORSET_UNIVERSE:
            raise ValueError(
                f"orset element out of universe [0, {ORSET_UNIVERSE}): "
                f"{e}")
        lane = self._lane_value(slot)
        n = (lane >> (4 * e)) & 0xF
        if n % 2 == int(odd):
            return spec.decode(lane)
        if n >= ORSET_MAX_LEN:
            raise OverflowError(
                f"orset causal length saturated at {ORSET_MAX_LEN} "
                f"for element {e} (no further add/remove cycles)")
        lane = (lane & ~(0xF << (4 * e))) | ((n + 1) << (4 * e))
        self.put_batch([slot], [lane])
        return spec.decode(lane)

    def orset_add(self, slot: int, element: int) -> frozenset:
        """Add an element (``[0, ORSET_UNIVERSE)``) to an OR-set slot:
        its causal length goes even to odd. Adding a present element is
        a no-op (no write, no clock tick). Returns the membership."""
        return self._orset_step(slot, element, odd=True)

    def orset_remove(self, slot: int, element: int) -> frozenset:
        """Remove an element: its causal length goes odd to even.
        Removing an absent element is a no-op. Returns the
        membership."""
        return self._orset_step(slot, element, odd=False)

    def orset_members(self, slot: int) -> frozenset:
        """Current members of an OR-set slot (odd causal lengths)."""
        spec = self._typed_spec(slot, "orset")
        return spec.decode(self._lane_value(slot))

    def mvreg_put(self, slot: int, value: int) -> None:
        """Write a multi-value register. The write's fresh HLC is newer
        than anything this replica has seen, so it replaces the local
        values; concurrent peer writes (equal lt, other nodes) union on
        merge up to the top ``MVREG_K``."""
        spec = self._typed_spec(slot, "mvreg")
        self.put_batch([slot], [spec.encode(value)])

    def mvreg_get(self, slot: int) -> Tuple[int, ...]:
        """Concurrent values at an mvreg slot, largest first."""
        spec = self._typed_spec(slot, "mvreg")
        return spec.decode(self._lane_value(slot))

    def _watch_decode(self, slot: int, value):
        """One committed lane value as a watch event carries it: a typed
        slot emits what its reads return (`spec.decode`), never the raw
        lane."""
        if value is None or self._sem is None:
            return value
        tag = int(self._sem[slot])
        return value if tag == 0 else by_tag(tag).decode(int(value))

    # --- watch/reactivity (C13, crdt.dart:162-164) ---

    def watch(self, slot: Optional[int] = None) -> ChangeStream:
        """Per-slot or whole-store change stream of ``(slot, value)``
        events, value ``None`` for deletes, emitted host-side after the
        device writes land."""
        return self._hub.stream(slot)

    def _emit_put(self, slots: np.ndarray, values: np.ndarray,
                  tombs: Optional[np.ndarray]) -> None:
        if not self._hub.active:
            return
        sl = slots.tolist()
        vals = [None if tombs is not None and tombs[i]
                else self._watch_decode(sl[i], v)
                for i, v in enumerate(values.tolist())]
        self._emit_slots(sl, vals)

    def _emit_delete(self, slots: np.ndarray) -> None:
        if self._hub.active:
            self._emit_slots(slots.tolist(), [None] * len(slots))

    def _emit_slots(self, sl: List[int], vals: List[Any]) -> None:
        # A raw slot array may repeat a slot; keyed streams must then
        # see every occurrence, so the O(1) keyed lookup only serves
        # duplicate-free batches.
        pos = {s: i for i, s in enumerate(sl)}
        unique = len(pos) == len(sl)

        def get(k):
            i = pos.get(k) if isinstance(k, (int, np.integer)) else None
            return (False, None) if i is None else (True, vals[i])

        self._hub.add_batch((sl, vals), get if unique else None)

    def _emit_merge_wins(self, store: DenseStore, win: torch.Tensor
                         ) -> None:
        """Winner change events from the merge's win mask — one
        readback of the winners, only when someone listens."""
        if not self._hub.active:
            return
        idx = torch.nonzero(win).reshape(-1)
        tomb = store.tomb[idx].tolist()
        val = store.val[idx].tolist()
        sl = idx.tolist()
        self._emit_slots(sl, [None if t else self._watch_decode(s, v)
                              for s, v, t in zip(sl, val, tomb)])

    # --- deltas out (crdt.dart:124-169, map_crdt.dart:44-45) ---

    def _delta_mask(self, modified_since: Optional[Hlc]) -> torch.Tensor:
        if modified_since is None:
            return self._store.occupied
        return dense_delta_mask(self._store, modified_since.logical_time)

    def _rows_at(self, mask: torch.Tensor, *names: str
                 ) -> Tuple[np.ndarray, ...]:
        """Slots where ``mask`` is set and lanes ``names`` at those
        slots, selected on the device: only those rows cross to the
        host."""
        idx = torch.nonzero(mask).reshape(-1)
        return (idx.cpu().numpy(),
                *(getattr(self._store, f)[idx].cpu().numpy()
                  for f in names))

    def _delta_rows(self, modified_since: Optional[Hlc], *names: str
                    ) -> Tuple[np.ndarray, ...]:
        """Slots of the delta and lanes ``names`` at those slots."""
        return self._rows_at(self._delta_mask(modified_since), *names)

    def count_modified_since(self, modified_since: Optional[Hlc] = None
                             ) -> int:
        """Delta-backlog size: occupied slots with ``mod_lt >=
        modified_since`` (tombstones included), one masked sum on the
        device. Inside an ingest window the staged slots count too
        (their flush stamp is at or after the canonical head), without
        a flush."""
        mask = self._delta_mask(modified_since)
        ing = self._ingest
        if ing is not None and ing.pending_rows:
            mask = mask.index_fill(0, torch.from_numpy(
                ing.pending_slot_array()).to(mask.device), True)
        return int(mask.sum())

    @staticmethod
    def _check_int_values(slots, values: List[Any]) -> None:
        """The payload lane is int64: any other value type (a bool too,
        which would store as 0/1) would diverge under the peer's hlc.
        None is a tombstone."""
        bad = next((i for i, v in enumerate(values)
                    if v is not None
                    and (isinstance(v, bool)
                         or not isinstance(v, (int, np.integer)))), None)
        if bad is not None:
            raise TypeError(
                f"DenseCrdt values must be ints; slot {slots[bad]} got "
                f"{type(values[bad]).__name__}")

    def put_slot_records(self, record_map: Dict[int, Record]) -> None:
        """Raw record writes keeping each record's own ``hlc`` and
        ``modified`` stamps, the putRecords storage primitive
        (crdt.dart:151-155): records land verbatim, with no LWW compare
        and no canonical clock. Values must be ints, or None for
        tombstones. For restoring a record dump or seeding a replica."""
        if not record_map:
            return
        # Verbatim stamps must not interleave with a pending flush's.
        self.drain_ingest()
        k = len(record_map)
        slots = np.fromiter(record_map.keys(), np.int64, count=k)
        self._check_slots(slots)
        recs = list(record_map.values())
        self._check_int_values(slots, [r.value for r in recs])
        self._check_value_width(
            [0 if r.value is None else int(r.value) for r in recs])
        self._intern_ids({r.hlc.node_id for r in recs}
                         | {r.modified.node_id for r in recs})
        ords = {nid: i for i, nid in enumerate(self._table.ids())}
        rows = dict(
            lt=np.fromiter((r.hlc.logical_time for r in recs), np.int64,
                           count=k),
            node=np.fromiter((ords[r.hlc.node_id] for r in recs),
                             np.int32, count=k),
            val=np.fromiter((0 if r.value is None else int(r.value)
                             for r in recs), np.int64, count=k),
            mod_lt=np.fromiter((r.modified.logical_time for r in recs),
                               np.int64, count=k),
            mod_node=np.fromiter((ords[r.modified.node_id] for r in recs),
                                 np.int32, count=k),
            tomb=np.fromiter((r.is_deleted for r in recs), bool, count=k))
        self._scatter_records(slots, rows)
        self.stats.puts += 1
        self.stats.records_put += k
        if self._hub.active:
            for slot, rec in record_map.items():
                self._hub.add(int(slot),
                              None if rec.is_deleted
                              else self._watch_decode(int(slot),
                                                      int(rec.value)))

    def _scatter_records(self, slots: np.ndarray,
                         rows: Dict[str, np.ndarray]) -> None:
        # crdtlint: disable=scatter-combiner-bypass -- only reached from put_slot_records, which drained the ingest window first
        record_scatter(self._writable_store(), self._to_device(slots),
                       **{f: self._to_device(a) for f, a in rows.items()})

    def record_map(self, modified_since: Optional[Hlc] = None
                   ) -> Dict[int, Record]:
        """Slot→Record export (recordMap, crdt.dart:140-169; inclusive
        ``modified_since`` bound)."""
        self.drain_ingest()
        idx, lt, node, val, mod_lt, mod_node, tomb = self._delta_rows(
            modified_since, "lt", "node", "val", "mod_lt", "mod_node",
            "tomb")
        if idx.size == 0:
            return {}
        ids = np.array(self._table.ids(), object)
        raw = Hlc._raw
        return {
            slot: Record(raw(ms, c, n), None if tb else v,
                         raw(mms, mc, mn))
            for slot, ms, c, n, v, tb, mms, mc, mn in zip(
                idx.tolist(), (lt >> SHIFT).tolist(),
                (lt & MAX_COUNTER).tolist(), ids[node], val.tolist(),
                tomb.tolist(), (mod_lt >> SHIFT).tolist(),
                (mod_lt & MAX_COUNTER).tolist(), ids[mod_node])
        }

    def to_json(self, modified_since: Optional[Hlc] = None,
                key_encoder: Optional[KeyEncoder] = None,
                value_encoder: Optional[ValueEncoder] = None) -> str:
        """Wire JSON export (crdt.dart:124-135): slots stringify as int
        keys, the reference's int-key golden format. With the default
        coders and the C codec loaded it is assembled straight from the
        lanes (`_to_json_fast`), byte-identical to the generic encoder
        without a `Record` per slot."""
        self.drain_ingest()
        if key_encoder is None and value_encoder is None:
            fast = self._to_json_fast(modified_since)
            if fast is not None:
                return fast
        return crdt_json.encode(self.record_map(modified_since),
                                key_encoder=key_encoder,
                                value_encoder=value_encoder)

    def _to_json_fast(self, modified_since: Optional[Hlc]) -> Optional[str]:
        """Lane-direct wire export through the C codec (batch HLC
        formatting, one-pass assembly), or None to defer to the generic
        path: no codec, an out-of-range year, a node id that is not
        UTF-8 encodable."""
        from .. import native
        codec = native.load()
        if codec is None:
            return None
        idx, lt, node, val, tomb = self._delta_rows(
            modified_since, "lt", "node", "val", "tomb")
        if idx.size == 0:
            return "{}"
        ids = np.array([str(n) for n in self._table.ids()], object)
        hlcs = codec.format_hlc_batch((lt >> SHIFT).tolist(),
                                      (lt & MAX_COUNTER).tolist(),
                                      ids[node].tolist())
        if None in hlcs:
            return None
        values = [None if tb else v
                  for v, tb in zip(val.tolist(), tomb.tolist())]
        return codec.format_wire(idx.tolist(), hlcs, values,
                                 crdt_json.compact_dumps)

    # pack_since cache depth: a replica gossiping with a few peers at a
    # few watermarks reuses this many packs; LRU eviction past it.
    PACK_CACHE_SLOTS = 4

    def _pack_key(self, since: Optional[Hlc], resolved: str = "plain",
                  ranges=None):
        return (None if since is None else since.logical_time,
                self._canonical_time.logical_time, self._sem_version,
                self._store_gen, resolved, ranges)

    def _pack_cache_store(self, key, out) -> None:
        """Insert a finished pack, LRU-evicting past PACK_CACHE_SLOTS
        with the eviction counter: churn stays bounded and visible."""
        self._pack_cache[key] = out
        if len(self._pack_cache) > self.PACK_CACHE_SLOTS:
            ev = default_registry().counter(
                "crdt_tpu_pack_cache_evictions_total",
                "pack_since cache entries LRU-evicted at the "
                "PACK_CACHE_SLOTS depth bound")
            while len(self._pack_cache) > self.PACK_CACHE_SLOTS:
                self._pack_cache.popitem(last=False)
                ev.inc(node=str(self._node_id))

    def _pack_rows_at(self, mask: torch.Tensor, resolved: str
                      ) -> Tuple[PackedDelta, List[Any]]:
        """The rows at ``mask`` in the packed form of mode ``resolved``
        (`_resolve_sem_mode`): ``"withhold"`` drops the typed rows,
        ``"include"`` attaches the tag lane."""
        rows = self._rows_at(mask, "lt", "node", "val", "tomb")
        sem = None
        if resolved == "withhold":
            lww = self._sem[rows[0]] == 0
            if not lww.all():
                default_registry().counter(
                    "crdt_tpu_sync_semantics_downgrade_total",
                    "typed rows withheld from LWW-only wire forms "
                    "by direction").inc(int((~lww).sum()),
                                        direction="outbound",
                                        node=str(self._node_id))
                rows = tuple(lane[lww] for lane in rows)
        elif resolved == "include":
            sem = self._sem[rows[0]]
        return pack_into_arena(*rows, sem=sem), self._table.ids()

    def _resolve_sem_mode(self, sem_mode: str) -> str:
        """``"auto"``, ``"include"`` or ``"withhold"`` (anything else
        raises) -> what the pack does: ``"plain"`` on an untyped store
        (no lane to attach, nothing to withhold, whatever was asked),
        else ``"withhold"`` for ``"auto"`` and the mode itself
        otherwise."""
        if sem_mode not in ("auto", "include", "withhold"):
            raise ValueError(f"unknown sem_mode {sem_mode!r}")
        if self._sem is None:
            return "plain"
        return "withhold" if sem_mode == "auto" else sem_mode

    def _normalize_ranges(self, ranges):
        """A range pack's spans: a sequence of half-open ``(lo, hi)``
        slot spans -> a sorted tuple, empty spans dropped; None means
        unrestricted."""
        if ranges is None:
            return None
        out = []
        for pair in ranges:
            lo, hi = pair
            lo, hi = int(lo), int(hi)
            if not 0 <= lo <= hi <= self.n_slots:
                raise ValueError(
                    f"pack range ({lo}, {hi}) out of bounds for "
                    f"{self.n_slots} slots")
            if lo < hi:
                out.append((lo, hi))
        return tuple(sorted(out))

    def _span_lanes(self, spans) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalized spans as ``(los, his)`` int64 lanes on the device."""
        lanes = np.array(spans, np.int64).reshape(-1, 2)
        return self._to_device(lanes[:, 0]), self._to_device(lanes[:, 1])

    def _range_delta_mask(self, since: Optional[Hlc], spans) -> torch.Tensor:
        """The mask of `pack_since(ranges=...)`: the delta mask (``since
        = None`` scans every occupied slot) AND the union of the spans."""
        since_lt = 0 if since is None else since.logical_time
        return dense_range_delta_mask(self._store, since_lt,
                                      *self._span_lanes(spans))

    def pack_since(self, since: Optional[Hlc] = None, sem_mode: str = "auto",
                   ranges=None) -> Tuple[PackedDelta, List[Any]]:
        """Outbound O(k) columnar delta: the rows with ``modified >=
        since`` (inclusive, the `export_delta` bound) in the packed wire
        form, plus the node-id list its ordinals index into — what
        ``merge_packed`` takes, here or on a JAX replica.

        ``sem_mode`` says what a typed store ships (any other value
        raises ``ValueError``): ``"include"`` attaches the uint8
        ``sem`` tag lane, for a peer with typed slots of its own;
        ``"withhold"`` drops the typed rows instead (withheld, never
        sent as LWW rows); ``"auto"`` withholds on a typed store. An
        all-LWW store gives the same 5-lane pack under every mode.
        ``ranges`` restricts the
        pack to a union of half-open ``(lo, hi)`` slot spans (validated
        against ``n_slots``, overlaps allowed), the Merkle walk's tail:
        only the divergent leaf ranges re-ship; ``ranges=((0,
        n_slots),)`` gives the unrestricted pack's bytes.

        Results are cached on ``(since, canonical, semantics version,
        store generation, mode, ranges)``; every store replacement or
        in-place write drops the cache, and ``merge_and_repack`` seeds
        it."""
        resolved = self._resolve_sem_mode(sem_mode)
        spans = self._normalize_ranges(ranges)
        # Drain BEFORE the key reads the canonical: a flush advances it.
        self.drain_ingest()
        key = self._pack_key(since, resolved, spans)
        counter = default_registry().counter(
            "crdt_tpu_pack_cache_total",
            "pack_since cache lookups by outcome")
        cached = self._pack_cache.get(key)
        if cached is not None:
            self._pack_cache.move_to_end(key)
            counter.inc(outcome="hit", node=str(self._node_id))
            return cached
        counter.inc(outcome="miss", node=str(self._node_id))
        with span("pack_since", kind="pack",
                  hlc=lambda: self._canonical_time,
                  node=str(self._node_id)):
            mask = (self._delta_mask(since) if spans is None
                    else self._range_delta_mask(since, spans))
            out = self._pack_rows_at(mask, resolved)
        self._pack_cache_store(key, out)
        return out

    def export_delta(self, since: Optional[Hlc] = None
                     ) -> Tuple[DenseChangeset, List[Any]]:
        """Outbound changeset: full state, or records with ``modified >=
        since`` (inclusive), plus the node-id list its ordinals index
        into. Its lanes are views of the store (handed out)."""
        self.drain_ingest()
        self._store_escaped = True
        cs = store_to_changeset(
            self._store, None if since is None else since.logical_time)
        return cs, self._table.ids()

    # --- Merkle digest tree (ops/digest.py) ---

    #: Slots per digest leaf: where the walk localizes divergence and how
    #: much a range pack re-ships. Both peers must agree (the walk checks
    #: geometry); the JAX package's value.
    DIGEST_LEAF_WIDTH = DEFAULT_LEAF_WIDTH

    def _digest_key(self):
        """Clock head, semantics version and store generation: the
        generation keeps a tree after `gc_purge` / `compact`, which
        change the store without advancing the clock, apart."""
        return (self._canonical_time.logical_time, self._sem_version,
                self._store_gen)

    def _digest_levels(self) -> Tuple[torch.Tensor, ...]:
        """Digest-tree levels (root-first) of the store, on its device,
        the tags mixed in on a typed store."""
        return digest_tree_device(self._store, self._sem_or_none(),
                                  self.DIGEST_LEAF_WIDTH)

    def _sem_or_none(self) -> Optional[torch.Tensor]:
        """The device tag column of a typed store, None on an untyped
        one."""
        return None if self._sem is None else self._sem_device()

    def digest_tree(self):
        """The Merkle digest tree of the replicated lanes (`ops.digest`),
        built on the store's device and fetched in one copy: two
        replicas compare roots, walk only the subtrees that differ, and
        re-ship just the divergent leaf ranges through
        ``pack_since(ranges=...)``. Cached like the packs: an unchanged
        store builds nothing (no ``digest_tree`` op), and every store
        change drops the tree."""
        # Drain BEFORE the key reads the canonical clock.
        self.drain_ingest()
        key = self._digest_key()
        counter = default_registry().counter(
            "crdt_tpu_digest_cache_total",
            "digest_tree cache lookups by outcome")
        cached = self._digest_cache
        if cached is not None and cached[0] == key:
            counter.inc(outcome="hit", node=str(self._node_id))
            return cached[1]
        counter.inc(outcome="miss", node=str(self._node_id))
        with span("digest_tree", kind="digest",
                  hlc=lambda: self._canonical_time,
                  node=str(self._node_id)):
            tree = build_digest_tree(self.n_slots, self.DIGEST_LEAF_WIDTH,
                                     self._digest_levels())
        self._digest_cache = (key, tree)
        return tree

    # --- tombstone epoch GC and online compaction ---

    def gc_purge(self, stability: Hlc, *,
                 drift_slack_ms: Optional[int] = None) -> int:
        """Epoch tombstone GC: physically drop every tombstone whose
        delete stamp the fleet's stability watermark has passed.
        ``stability`` MUST be such a watermark (every peer's durable
        state past it). The floor is the watermark less a clock-drift
        slack (``hlc.MAX_DRIFT`` unless given; a single replica whose
        watermark is its own head passes 0), so every row a peer may
        still hold undelivered sits above it: inbound rows at or below
        the floor that target a slot purged here are replays of purged
        state, and the merge paths drop them (the fence). Slots never
        purged here take such rows as first-time deliveries. A
        watermark that has not advanced returns 0 before any op runs.
        Returns the number of slots purged."""
        self._refuse_in_pipeline("gc_purge")
        self.drain_ingest()
        slack = MAX_DRIFT if drift_slack_ms is None else int(drift_slack_ms)
        if slack < 0:
            raise ValueError(f"drift_slack_ms must be >= 0, got {slack}")
        floor = int(stability.logical_time) - (slack << SHIFT)
        if floor <= 0 or floor <= self._last_gc_floor_lt:
            return 0  # the watermark has not advanced: no op
        n_purged, purged = self._purge_stable(floor)
        self._last_gc_floor_lt = floor
        self._gc_floor_lt = max(self._gc_floor_lt, floor)
        self._fence_add(purged)
        if _sanitizer.enabled():
            # Arm the post-purge resurrection check: every later merge
            # asserts no recorded slot re-occupies at or below the floor
            # (sanitizer.check_dense_no_resurrection). The record stays
            # on the device; compaction remaps slots and retires it.
            slots = torch.nonzero(self._fence_mask()).reshape(-1)
            self._gc_purged = (slots, floor)
        if n_purged and self._sem is not None:
            typed = self._purged_host(purged) & (self._sem != 0)
            if typed.any():
                # A purged slot returns to LWW: its tag described the
                # tombstoned record, which is gone.
                sem = self._sem.copy()
                sem[typed] = 0
                self._set_sem(sem)
        default_registry().counter(
            "crdt_tpu_gc_purged_slots_total",
            "tombstoned slots physically reclaimed by epoch GC").inc(
                n_purged, node=str(self._node_id))
        default_registry().counter(
            "crdt_tpu_gc_passes_total",
            "gc_purge dispatches (watermark advanced)").inc(
                node=str(self._node_id))
        return n_purged

    def _purge_stable(self, floor: int):
        """``(slots purged, purged mask)`` of one `ops.dense.gc_purge`
        on the writable store."""
        _, count, purged = gc_purge(self._writable_store(), floor)
        return int(count), purged

    def _purged_host(self, purged) -> np.ndarray:
        """A `_purge_stable` mask as one host bool array over the
        slots."""
        return purged.cpu().numpy()

    def _fence_add(self, purged) -> None:
        self._gc_fence = (purged if self._gc_fence is None
                          else self._gc_fence | purged)

    def _fence_mask(self) -> Optional[torch.Tensor]:
        """The fence over every slot on this replica's device, or None."""
        return self._gc_fence

    def _set_fence(self, fence: Optional[torch.Tensor]) -> None:
        self._gc_fence = fence

    def _fence_rows(self, slots: np.ndarray, lt: np.ndarray) -> np.ndarray:
        """Rows of a validated columnar delta that the GC fence drops:
        at or below the floor, onto a purged slot."""
        fenced = self._fence_mask()[self._to_device(slots)]
        return (lt <= self._gc_floor_lt) & fenced.cpu().numpy()

    @staticmethod
    def _check_disjoint(spans) -> None:
        """Compaction spans must not overlap: a slot in two spans would
        have two destinations (the JAX package sums them, and loses
        records)."""
        for (lo0, hi0), (lo1, hi1) in zip(spans, spans[1:]):
            if lo1 < hi0:
                raise ValueError(
                    f"compact ranges ({lo0}, {hi0}) and ({lo1}, {hi1}) "
                    "overlap; each slot may be in one span only")

    def compact(self, ranges=None) -> np.ndarray:
        """Online compaction: the surviving rows move to a dense prefix
        of their span (by default one span, the whole store) and the
        digest tree is rebuilt with them (`ops.dense.compact_remap`).
        Returns the translation ``int32[n_slots]``, ``translation[old] =
        new`` for occupied rows and ``-1`` for empty slots, which the
        caller MUST apply to every slot reference it holds. ``ranges``
        restricts compaction to disjoint half-open ``(lo, hi)`` spans
        (overlapping spans raise ``ValueError``); rows outside keep
        their slots. The digest cache is seeded with the rebuilt tree,
        and the GC fence retires (slot identity changed)."""
        self._refuse_in_pipeline("compact")
        self.drain_ingest()
        spans = self._normalize_ranges(
            ((0, self.n_slots),) if ranges is None else ranges)
        self._check_disjoint(spans)
        new_store, new_sem, translation, levels = self._compact_store(
            spans, whole=ranges is None)
        translation = translation.cpu().numpy()
        self._store = new_store
        self._store_escaped = False
        if new_sem is not None:
            self._set_sem(new_sem.cpu().numpy())
        self._set_fence(None)
        self._gc_purged = None   # the slots it recorded moved
        # Seed AFTER the store swap (which cleared the cache) and the
        # tags' version bump, under the key the next `digest_tree`
        # builds.
        self._digest_cache = (self._digest_key(), build_digest_tree(
            self.n_slots, self.DIGEST_LEAF_WIDTH, levels))
        default_registry().counter(
            "crdt_tpu_compact_passes_total",
            "compact_remap dispatches").inc(node=str(self._node_id))
        return translation

    def _compact_store(self, spans, whole: bool):
        """``(new store lanes, new tag column or None, translation,
        digest levels)`` of one compaction over ``spans`` (``whole``:
        the caller gave no ranges)."""
        return self._compact_remap(self._store, spans)

    def _compact_remap(self, store: DenseStore, spans):
        """`ops.dense.compact_remap` of ``store`` (in global slot order)
        over ``spans``, the tag column moved with the rows on a typed
        store."""
        if self._sem is None:
            new_store, translation, _, levels = compact_remap(
                store, *self._span_lanes(spans),
                leaf_width=self.DIGEST_LEAF_WIDTH)
            return new_store, None, translation, levels
        new_store, new_sem, translation, _, levels = compact_remap(
            store, *self._span_lanes(spans), self._sem_device(),
            leaf_width=self.DIGEST_LEAF_WIDTH)
        return new_store, new_sem, translation, levels

    # --- checkpoint/resume ---

    def save(self, path: str) -> None:
        """Columnar npz snapshot including the node-id table and the
        digest tree under its cache key (the format of
        ``crdt_tpu.checkpoint.save_dense``; either package loads it).
        A restored replica answers its first walk from the saved tree."""
        self.drain_ingest()
        from ..checkpoint import save_dense
        tree = self.digest_tree()
        save_dense(self._gathered(), path, node_ids=self._table.ids(),
                   digest=(tree, self._canonical_time.logical_time,
                           self._sem_version))

    @classmethod
    def load(cls, node_id: Any, path: str, **kwargs) -> "DenseCrdt":
        """Resume from a snapshot; the canonical clock rebuilds from the
        lanes (refreshCanonicalTime, crdt.dart:31-33) and writer
        attribution survives via the persisted node table. A persisted
        digest tree seeds the digest cache when its key still matches
        the rebuilt state (clock, semantics version, geometry); any
        other tree is ignored and rebuilt on the first walk. Snapshots
        hold no tag column: a loaded replica is untyped until
        ``set_semantics`` runs again. The lanes load straight onto the
        device the keyword arguments name."""
        from ..checkpoint import load_dense_digest, load_dense_with_node_ids
        store, ids = load_dense_with_node_ids(path, cls._load_device(kwargs))
        if ids is None:
            raise ValueError(
                f"{path} has no node-id table (store-level snapshot); "
                "pass store=load_dense(path) with the original node_ids")
        crdt = cls(node_id, store.n_slots, store=store, node_ids=ids,
                   **kwargs)
        restored = load_dense_digest(path)
        if restored is not None:
            tree, logical_time, sem_version = restored
            if (logical_time == crdt._canonical_time.logical_time
                    and sem_version == crdt._sem_version
                    and tree.n_slots == crdt.n_slots
                    and tree.leaf_width == crdt.DIGEST_LEAF_WIDTH):
                # Keyed under the LIVE generation: the guards above
                # prove the tree matches the state it names.
                crdt._digest_cache = (crdt._digest_key(), tree)
        return crdt

    @staticmethod
    def _load_device(kwargs) -> Any:
        """The device `load` puts a snapshot's lanes on: the one the
        constructor's keyword arguments name (None: the card)."""
        return kwargs.get("device")

    # --- capacity ---

    def grow(self, n_slots: int) -> None:
        """Grow the slot capacity to ``n_slots`` (records keep their
        slots; new slots start empty and outside the GC fence), as
        ``crdt_tpu``'s ``DenseCrdt.grow``. Shrinking would drop records;
        it is refused. Peers at the old capacity keep syncing with this
        replica (their narrower changesets are padded on merge); merging
        this replica's wider changesets into an ungrown peer raises
        there until the peer grows too.

        New slots take the LWW tag. Not carried over: the reference's
        executor tile check (the card's kernels take any
        ``n_slots``)."""
        if n_slots < self.n_slots:
            raise ValueError(
                f"cannot shrink {self.n_slots} -> {n_slots} slots "
                "(records would be dropped); build a new replica and "
                "merge instead")
        if n_slots == self.n_slots:
            return
        self.drain_ingest()
        extra = n_slots - self.n_slots
        if self._sem is not None:
            # New slots start as LWW (tag 0).
            self._sem = np.concatenate([self._sem, np.zeros(extra, np.int8)])
            self._sem_dev = None
        fence = self._fence_mask()
        pad = empty_dense_store(extra, self._device)
        self._store = self._adopt_store(n_slots, DenseStore(*(
            torch.cat([lane, pad_lane])
            for lane, pad_lane in zip(self._gathered(), pad))))
        self._store_escaped = False
        if fence is not None:
            self._set_fence(torch.cat([fence, fence.new_zeros(extra)]))

    # --- replication (C9/C10) ---

    def _fit_slots(self, cs: DenseChangeset) -> DenseChangeset:
        """Bring a peer changeset onto this replica's device and lane
        types, and its slot width to this replica's capacity: a
        NARROWER peer pads with invalid lanes; a WIDER one raises."""
        cs = DenseChangeset(*(
            torch.as_tensor(lane).to(self._device, CHANGESET_DTYPES[f])
            for f, lane in zip(DenseChangeset._fields, cs)))
        width = cs.lt.shape[1]
        if width > self.n_slots:
            raise ValueError(
                f"peer changeset covers {width} slots but this replica "
                f"holds {self.n_slots}; call grow({width}) first")
        if width == self.n_slots:
            return cs
        pad = self.n_slots - width
        return DenseChangeset(*(
            torch.cat([lane, lane.new_zeros((lane.shape[0], pad))], 1)
            for lane in cs))

    def _intern_ids(self, node_ids: Sequence[Any]) -> None:
        """Intern ids into the table, re-encoding stored lanes when new
        ids shift existing ordinals."""
        remap = self._table.intern(list(node_ids))
        if remap is not None:
            self._store = reencode(self._store, remap)

    def _encode_peer(self, cs: DenseChangeset, node_ids: Sequence[Any]
                     ) -> DenseChangeset:
        """Rewrite a changeset's ordinals into this replica's table
        (every id already interned)."""
        remap = [self._table.ordinal(n) for n in node_ids]
        if remap == list(range(len(self._table))):
            return cs   # peer table == local table: nothing to rewrite
        peer_to_local = torch.tensor(remap, dtype=torch.int32,
                                     device=self._device)
        # The JAX package's gather: an ordinal in -len..-1 counts from
        # the end (a valid entry's, too), then every ordinal is clamped
        # into range.
        idx = cs.node.long()
        idx = torch.where(idx < 0, idx + len(remap), idx).clamp_(
            0, len(remap) - 1)
        return cs._replace(node=peer_to_local[idx])

    def merge(self, cs: DenseChangeset, node_ids: Sequence[Any]) -> None:
        """Fan-in a peer changeset whose ``node`` ordinals index
        ``node_ids``; they are remapped into this replica's table."""
        self.merge_many([(cs, node_ids)])

    def merge_many(self, changesets: Sequence[
            Tuple[DenseChangeset, Sequence[Any]]]) -> None:
        """N-replica fan-in: concatenate peer changesets along the
        replica axis (earlier entries win identical-HLC ties, the
        sequential-merge order) and run ONE fused lattice join: the
        fan-in kernel, or on a typed store the typed fold (one typed
        join per row), in every window."""
        with span(MERGE_SPAN):
            with span(PREPARE_SPAN):
                self.drain_ingest()
                self.stats.merges += 1
                if not changesets:
                    self._merge_nothing()
                    return
                cs = self._merge_lanes(changesets)
            wall = self._wall_clock()
            with merge_annotation("crdt_tpu_torch.dense_merge",
                                  hlc=lambda: self._canonical_time):
                merged, cs = self._dispatch_fanin(cs, wall)
            self._finish_merge(merged, wall,
                               lambda: (cs.lt, cs.node, cs.valid))

    def _merge_nothing(self) -> None:
        """A merge of no changesets still spends the absorption-phase
        wall read AND the final send bump (crdt.dart:77-94)."""
        self._wall_clock()
        if self._pipe is not None:
            self._pipe.send_bump(self._wall_clock())
            return
        self._canonical_time = Hlc.send(self._canonical_time,
                                        millis=self._wall_clock())

    def _merge_lanes(self, changesets: Sequence[
            Tuple[DenseChangeset, Sequence[Any]]]) -> DenseChangeset:
        """The peer changesets as one changeset in this replica's table,
        slots and device, the GC fence folded into ``valid``. The UNION
        of every peer's ids is interned first (one table mutation), then
        each changeset is encoded against the final table."""
        union: set = set()
        for _, ids in changesets:
            union.update(ids)
        self._intern_ids(union)
        parts = [self._encode_peer(self._fit_slots(cs), ids)
                 for cs, ids in changesets]
        cs = parts[0] if len(parts) == 1 else DenseChangeset(
            *(torch.cat([getattr(p, f) for p in parts])
              for f in DenseChangeset._fields))
        fence = self._fence_mask()
        if self._gc_floor_lt and fence is not None:
            # The GC fence, folded into ``valid`` before the kernel (the
            # columnar paths' predicate, `_fence_rows`): a row at or
            # below the floor onto a purged slot replays purged state.
            cs = cs._replace(valid=cs.valid & ~(
                (cs.lt <= self._gc_floor_lt) & fence[None, :]))
        return cs

    def _dispatch_fanin(self, cs: DenseChangeset, wall: int):
        """One merge of a changeset in this replica's table, up to its
        tail: ``(merged, guard_cs)``, ``merged`` what `merge_tail` takes
        (the kernel's join, or the typed fold's stamped merge: a typed
        store never takes the kernel) and ``guard_cs`` the changeset
        whose lanes the exact guards read."""
        if self._sem is not None:
            cs, voverflow = mask_value_width(cs, self._value_width)
            seen = cs.valid.sum()
            new_store, res = typed_fanin_step(
                self._store, self._sem_device(), cs, self._canonical_lt(),
                self._local_ordinal(), wall)
            return Stamped(new_store, res, seen, voverflow), cs
        join = model_fanin_join(self._store, cs, self._canonical_lt(),
                                self._local_ordinal(),
                                value_width=self._value_width)
        return join, join.cs

    def _finish_merge(self, merged, wall: int,
                      guard_lanes: Callable[[], Tuple[torch.Tensor, ...]]
                      ) -> None:
        """The end shared by ``merge_many`` and ``merge_split``: the
        merge's tail (`ops.fanin_tail.merge_tail`: the stamp, and in a
        window the window's step), then outside a window its one
        readback, guards and clock. ``guard_lanes`` returns the ``(lt,
        node, valid)`` lanes the exact guards read, with local ordinals:
        every merge in an exact window needs them, an unpipelined one
        only when a flag trips."""
        local = self._local_ordinal()
        pipe = self._pipe
        with span(STAMP_SPAN):
            new_store, win, scalars = merge_tail(
                merged, local, wall, pipe, self.stats, self._wall_clock,
                guard_lanes)
        if pipe is not None:
            # The window's step ran in the tail; nothing leaves the
            # device.
            self._store = new_store
            self._store_escaped = False
            self._emit_merge_wins(new_store, win)
            return

        # The result scalars come back in ONE copy; the [N] win mask
        # stays on device unless a watch subscriber needs it.
        any_bad, win_count, new_canonical, val_ovf = \
            scalars[:4].tolist()
        if val_ovf:
            # Rejected before the store swap: the replica is untouched.
            raise ValueError(
                "value_width=32 replica merged a changeset holding "
                "values outside int32 range; use a value_width=64 "
                "replica (or payload-table indices) for such data")
        if any_bad:
            # The kernel's flags are a superset: recompute exactly in
            # the sequential visit order (crdt.dart:80-94); a shielded
            # record clears and the merge proceeds.
            g_lt, g_node, g_valid = guard_lanes()
            bad, first_bad, first_is_dup, caf = recv_guards(
                g_lt, g_node, g_valid, self._canonical_time.logical_time,
                local, wall)
            if bool(bad):
                # Store untouched; canonical rolled to the pre-failure
                # value (crdt.dart:77-94 throw path).
                self._canonical_time = Hlc.from_logical_time(
                    int(caf), self._node_id)
                if bool(first_is_dup):
                    raise DuplicateNodeException(str(self._node_id))
                bad_lt = int(g_lt.reshape(-1)[first_bad])
                raise ClockDriftException(bad_lt >> SHIFT, wall)
        self._store = new_store
        self._store_escaped = False
        if _sanitizer.enabled():
            # Wide post-state check against the merged rows. The window
            # branch above is exempt BY CONTRACT: it promises no host
            # sync per merge, which a verdict on the host would break —
            # sanitize soaks run unpipelined.
            g_lt, g_node, g_valid = guard_lanes()
            store = self._gathered()
            _sanitizer.check_dense_join(store, SimpleNamespace(
                lt=g_lt, node=g_node, valid=g_valid))
            if self._gc_purged is not None:
                _sanitizer.check_dense_no_resurrection(
                    store, *self._gc_purged)
        self.stats.records_adopted += win_count
        self._emit_merge_wins(new_store, win)
        self._canonical_time = Hlc.send(
            Hlc.from_logical_time(new_canonical, self._node_id),
            millis=self._wall_clock())

    # --- the JAX peers' wire form (ops/split.py) ---

    def export_split_delta(self, since: Optional[Hlc] = None,
                           tiled: bool = True):
        """Outbound changeset in the split wire form that JAX peers
        exchange (`ops.split.SplitChangeset`, or the narrow value-ref
        lanes on a ``value_width=32`` replica), tiled to ``[1, N // 512,
        512]`` when ``n_slots % TILE == 0``: what ``merge_split`` — here
        or on a JAX replica — takes with no conversion. Returns
        ``(split_changeset, node_ids)``. Raises ``ValueError`` when a
        node ordinal would not fit the int16 wire lane."""
        if len(self._table) - 1 > MAX_NODE_ORDINAL:
            raise ValueError(
                f"node table holds {len(self._table)} ids; the split wire "
                f"form carries ordinals up to {MAX_NODE_ORDINAL} only "
                "(use export_delta)")
        cs, ids = self.export_delta(since)
        if self._value_width == 32:
            # Every write path range-checks values: no overflow here.
            scs, _ = split_changeset_narrow(cs)
        else:
            scs = split_changeset(cs)
        if tiled and self.n_slots % TILE == 0:
            scs = tile_changeset(scs)
        return scs, ids

    def _fit_split(self, scs):
        """A peer's split lanes — this package's lane types or any named
        tuple with the same fields (a JAX peer's, say), as tensors or
        host arrays, 2-D or tiled — on this replica's device in their
        wire dtypes."""
        cls = NarrowSplitChangeset if "val" in scs._fields \
            else SplitChangeset
        return cls(*(
            (lane if isinstance(lane, torch.Tensor)
             else torch.tensor(np.asarray(lane))
             ).to(self._device, SPLIT_DTYPES[f])
            for f, lane in ((f, getattr(scs, f)) for f in cls._fields)))

    def merge_split(self, scs, node_ids: Sequence[Any]) -> None:
        """Fan-in a PRE-SPLIT changeset (`export_split_delta`'s wire
        form, from either package; 2-D or tiled, wide or narrow) whose
        ordinals index ``node_ids``. The lanes go to the pre-split kernel
        as they arrive; the ordinal remap runs inside it. Semantics —
        guards, value-width enforcement, pipelined windows, watch, stats,
        clock — are those of ``merge``. The changeset must cover exactly
        ``n_slots``. A typed store widens the lanes and merges them as
        ``merge`` does (the typed fold has no split form), the JAX
        package's route off its kernel."""
        scs = self._fit_split(scs)
        self.drain_ingest()
        _, n = _cs_shape(scs)
        if n != self.n_slots:
            raise ValueError(
                f"pre-split changeset covers {n} slots but this replica "
                f"holds {self.n_slots}; use merge() (the wide path pads"
                "/refuses capacity mismatches)")
        if self._sem is not None:
            return self.merge(split_to_wide(scs), node_ids)
        self.stats.merges += 1
        self._intern_ids(node_ids)
        node_map = torch.tensor([self._table.ordinal(i) for i in node_ids],
                                dtype=torch.int32, device=self._device)
        wall = self._wall_clock()
        with merge_annotation("crdt_tpu_torch.dense_merge",
                              hlc=lambda: self._canonical_time):
            join = model_fanin_split_join(
                self._store, scs, node_map, self._canonical_lt(),
                self._local_ordinal(), value_width=self._value_width)
        # The kernel remaps as it reads, so ``scs`` keeps peer ordinals:
        # the guard lanes apply the remap.
        self._finish_merge(
            join, wall,
            lambda: split_guard_lanes(scs.hi, scs.lo, scs.node, node_map))

    # --- columnar deltas in: packed, JSON, record dicts ---

    def merge_records(self, record_map: Dict[int, Record]) -> None:
        """Fan-in a slot -> `Record` dict (a map peer's records, or a
        JSON decode). Values must be ints, or None for tombstones: the
        payload lane is int64. Clock absorption and the recv guards run
        on the host in the dict's order, the reference's visit order
        (crdt.dart:80-85); the join is O(k) in the delta."""
        self._refuse_in_pipeline("merge_records")  # host recv fold
        self.drain_ingest()
        if not record_map:
            self.merge_many([])
            return
        k = len(record_map)
        slots = np.fromiter(record_map.keys(), np.int64, count=k)
        recs = list(record_map.values())
        from .. import native
        codec = native.load()
        if codec is not None:
            lt_buf, nodes, values = codec.records_to_columns(recs, False)
            lt = np.frombuffer(lt_buf, np.int64)
        else:
            lt = np.fromiter((r.hlc.logical_time for r in recs), np.int64,
                             count=k)
            nodes = [r.hlc.node_id for r in recs]
            values = [r.value for r in recs]
        self._merge_columns(slots, lt, nodes, values)

    def merge_json(self, json_str: str,
                   key_decoder: Optional[KeyDecoder] = None,
                   value_decoder: Optional[ValueDecoder] = None) -> None:
        """Columnar wire JSON ingest (crdt.dart:100-109): the decode
        (`crdt_json.decode_columns`) feeds `merge_records`' columnar
        core with no per-record objects. Keys decode to int slots by
        default."""
        self._refuse_in_pipeline("merge_json")  # host recv fold
        self.drain_ingest()
        # The JAX package's decode stamps `modified` with one wall read
        # (its Crdt.merge_json contract); the merge re-stamps winners,
        # so only the read must happen, for the clocks to tick alike.
        self._wall_clock()
        if (key_decoder is None or key_decoder is int) \
                and value_decoder is None and self._merge_json_fast(json_str):
            return
        keys, lt, nodes, values = crdt_json.decode_columns(
            json_str, key_decoder=key_decoder or int,
            value_decoder=value_decoder)
        if not keys:
            self.merge_many([])
            return
        self._merge_columns(np.asarray(keys, np.int64), lt, nodes, values)

    def _merge_json_fast(self, json_str: str) -> bool:
        """The C codec's dense wire scan (`parse_wire_dense`): raw
        columnar buffers, no key strings or value ints, validated and
        joined as `_merge_columns` does. False (nothing touched) when
        the codec is absent or defers the payload to the generic
        decode."""
        from .. import native
        codec = native.load()
        scanned = (codec.parse_wire_dense(json_str)
                   if codec is not None else None)
        if scanned is None:
            return False
        sbuf, ltbuf, nibuf, uniq, vbuf, tbuf, vmin, vmax = scanned
        k = len(tbuf)
        if not k:
            self.merge_many([])
            return True
        slots = np.frombuffer(sbuf, np.int32)
        lt = np.frombuffer(ltbuf, np.int64)
        ni = np.frombuffer(nibuf, np.int32)
        val = np.frombuffer(vbuf, np.int64)
        tomb = np.frombuffer(tbuf, np.uint8).astype(bool)
        keep = self._last_wins_keep(slots)
        if keep is not None:
            # Repeated wire keys collapse last-wins (decode-dict parity)
            # before anything counts or validates the dropped rows.
            slots, lt, ni, val, tomb = (slots[keep], lt[keep], ni[keep],
                                        val[keep], tomb[keep])
            k = len(slots)
        self.stats.merges += 1
        self.stats.add_seen_lazy(k)
        self._check_slots(slots)
        self._check_value_width(np.array([vmin, vmax], np.int64)
                                if keep is None else val)
        self._intern_ids(uniq)
        self._merge_validated(slots, lt, self._table.encode(uniq)[ni], val,
                              tomb)
        return True

    def _merge_columns(self, slots: np.ndarray, lt: np.ndarray,
                       node_ids: List[Any], values: List[Any]) -> None:
        """The columnar core of `merge_records` / `merge_json`: ``lt``
        holds packed logical times aligned with ``slots``, ``node_ids``
        and ``values``. Repeated slots collapse last-wins first (the
        dropped rows are never validated or counted, as a decode dict
        drops them), and every validation runs BEFORE the first clock
        mutation, so a refused payload leaves the replica untouched."""
        keep = self._last_wins_keep(slots)
        if keep is not None:
            slots, lt = slots[keep], lt[keep]
            node_ids = [node_ids[i] for i in keep]
            values = [values[i] for i in keep]
        k = len(slots)
        self.stats.merges += 1
        self.stats.add_seen_lazy(k)
        self._check_slots(slots)
        from .. import native
        codec = native.load()
        if codec is not None:
            tomb = np.frombuffer(codec.none_mask(values), bool)
        else:
            tomb = np.fromiter((v is None for v in values), bool, count=k)
        self._check_int_values(slots, values)
        val = np.fromiter((0 if v is None else v for v in values),
                          np.int64, count=k)
        self._check_value_width(val)
        self._intern_ids(set(node_ids))
        self._merge_validated(slots, lt, self._table.encode(node_ids), val,
                              tomb)

    def merge_packed(self, packed: PackedDelta,
                     node_ids: Sequence[Any]) -> None:
        """Fan-in a `pack_since` delta (this package's or the JAX
        package's, e.g. through `ops.packing.unpack_rows`):
        ``packed.node`` holds ordinals into ``node_ids``. Validation —
        aligned lanes, ordinal range, slot bounds, value width — runs
        BEFORE the first clock mutation, and repeated slots collapse
        last-wins. O(k) in the delta."""
        self._merge_packed_impl(packed, node_ids, None)

    def merge_and_repack(self, packed: PackedDelta,
                         node_ids: Sequence[Any],
                         since: Optional[Hlc] = None,
                         sem_mode: str = "auto"
                         ) -> Tuple[PackedDelta, List[Any]]:
        """`merge_packed` and then `pack_since(since, sem_mode)`, the
        gossip relay: the sparse join returns the next pack's delta mask
        from the same call (`ops.dense.merge_repack_step`), and the pack
        seeds the cache under `pack_since`'s key, so the next
        `pack_since(since)` hits. An empty delta, one the GC fence or
        the typed-row withholding empties, the wide join or a typed
        store takes `pack_since`. An unknown
        ``sem_mode`` raises before the merge."""
        resolved = self._resolve_sem_mode(sem_mode)
        since_lt = 0 if since is None else int(since.logical_time)
        mask = self._merge_packed_impl(packed, node_ids, since_lt)
        if mask is None:
            return self.pack_since(since, sem_mode)
        default_registry().counter(
            "crdt_tpu_fused_repack_total",
            "gossip relays served by the fused merge+repack "
            "dispatch").inc(node=str(self._node_id))
        out = self._pack_rows_at(mask, resolved)
        self._pack_cache_store(self._pack_key(since, resolved), out)
        return out

    def _merge_packed_impl(self, packed: PackedDelta,
                           node_ids: Sequence[Any],
                           repack_since_lt: Optional[int]
                           ) -> Optional[torch.Tensor]:
        self._refuse_in_pipeline("merge_packed")  # host recv fold
        self.drain_ingest()
        slots = np.asarray(packed.slots)
        lt = np.asarray(packed.lt, np.int64)
        ni = np.asarray(packed.node)
        val = np.asarray(packed.val, np.int64)
        tomb = np.asarray(packed.tomb).astype(bool)
        sem = getattr(packed, "sem", None)
        sem = None if sem is None else np.asarray(sem).astype(np.int8)
        k = len(slots)
        if not len(lt) == len(ni) == len(val) == len(tomb) == k \
                or (sem is not None and len(sem) != k):
            raise ValueError("packed delta lanes are ragged")
        if k == 0:
            self.merge_many([])
            return None
        if int(ni.min()) < 0 or int(ni.max()) >= len(node_ids):
            raise ValueError(
                f"packed node ordinal out of range for {len(node_ids)} "
                "wire node ids")
        keep = self._last_wins_keep(slots)
        if keep is not None:
            slots, lt, ni, val, tomb = (slots[keep], lt[keep], ni[keep],
                                        val[keep], tomb[keep])
            if sem is not None:
                sem = sem[keep]
            k = len(slots)
        self.stats.merges += 1
        self.stats.add_seen_lazy(k)
        self._check_slots(slots)
        if sem is not None:
            # Never join one slot under two lattices: the peer's tags
            # must match the local column exactly (LWW rows included),
            # refused before the first clock mutation.
            local = self._sem_host()[slots]
            mism = sem != local
            if mism.any():
                i = int(np.nonzero(mism)[0][0])
                raise ValueError(
                    f"semantics tag mismatch at slot {int(slots[i])}: "
                    f"peer sent tag {int(sem[i])}, local column holds "
                    f"{int(local[i])}; run the same set_semantics "
                    "migration on both replicas before syncing")
        self._check_value_width(val)
        self._intern_ids(node_ids)
        node = self._table.encode(node_ids)[ni]
        return self._merge_validated(slots, lt, node, val, tomb,
                                     sem_ok=sem is not None,
                                     repack_since_lt=repack_since_lt)

    def _merge_validated(self, slots: np.ndarray, lt: np.ndarray,
                         node: np.ndarray, val: np.ndarray,
                         tomb: np.ndarray, sem_ok: bool = False,
                         repack_since_lt: Optional[int] = None
                         ) -> Optional[torch.Tensor]:
        """The columnar merge tail on validated lanes (``node`` in local
        ordinals, slots unique): the recv fold, the store join, watch
        events in payload order, the final send bump. With
        ``repack_since_lt`` the sparse join also returns the next pack's
        delta mask; None on every other route.

        ``sem_ok`` says the caller checked the payload's semantics tags
        against the local column (`merge_packed` with a ``sem`` lane).
        Without it, rows landing on typed slots are WITHHELD: an
        LWW-framed payload (record dicts, JSON, a 5-lane pack) cannot
        prove it joins under the right lattice, and joining a counter
        lane by LWW would corrupt it."""
        drop = np.zeros(len(slots), bool)
        if not sem_ok and self._sem is not None:
            drop |= self._sem[slots] != 0
            if drop.any():
                default_registry().counter(
                    "crdt_tpu_sync_semantics_downgrade_total",
                    "typed rows withheld from LWW-only wire forms by "
                    "direction").inc(int(drop.sum()),
                                     direction="inbound",
                                     node=str(self._node_id))
        if self._gc_floor_lt and self._fence_mask() is not None \
                and not drop.all():
            # The GC fence: a row at or below the floor onto a slot this
            # replica PURGED replays purged state (the stability
            # watermark proves every peer delivered everything below the
            # floor), and is dropped. Rows for never-purged slots
            # (first-time deliveries) pass.
            stale = self._fence_rows(slots, lt) & ~drop
            if stale.any():
                default_registry().counter(
                    "crdt_tpu_gc_fenced_rows_total",
                    "inbound rows dropped by the post-GC resurrection "
                    "fence").inc(int(stale.sum()),
                                 node=str(self._node_id))
                drop |= stale
        if drop.any():
            keep = ~drop
            slots, lt, node, val, tomb = (slots[keep], lt[keep], node[keep],
                                          val[keep], tomb[keep])
            if not len(slots):
                # The two clock ticks of an empty merge.
                self._wall_clock()
                self._canonical_time = Hlc.send(
                    self._canonical_time, millis=self._wall_clock())
                return None
        k = len(slots)
        my_ord = self._local_ordinal()
        wall = self._wall_clock()
        # Recv guards and clock absorption against the RUNNING canonical
        # (hlc.dart:85's fast path shields records the clock already
        # dominates), in payload visit order.
        fold = recv_fold_columns(lt, node == my_ord,
                                 self._canonical_time.logical_time, wall)
        if fold.bad_index is not None:
            # Canonical partially advanced to just before the offender
            # (crdt.dart:77-94 throw path); store untouched.
            self._canonical_time = Hlc.from_logical_time(
                fold.canonical_at_fail, self._node_id)
            if fold.bad_is_dup:
                raise DuplicateNodeException(str(self._node_id))
            raise ClockDriftException(int(lt[fold.bad_index]) >> SHIFT,
                                      wall)
        new_canonical = fold.new_canonical
        with merge_annotation("crdt_tpu_torch.dense_merge",
                              hlc=lambda: self._canonical_time):
            win, slot_aligned, repack_mask = self._dispatch_columns(
                slots, lt, node, val, tomb, new_canonical, my_ord,
                repack_since_lt)
        if _sanitizer.enabled():
            # Slots are unique on this path (the merge's own contract),
            # so the payload-order domination check is well-defined.
            store = self._gathered()
            _sanitizer.check_dense_sparse_join(store, slots, lt, node)
            if self._gc_purged is not None:
                _sanitizer.check_dense_no_resurrection(
                    store, *self._gc_purged)
        if self._hub.active:
            win_h = win.cpu().numpy()
            # The wide join's win is per SLOT: back to payload order.
            win_h = win_h[slots] if slot_aligned else win_h[:k]
            self.stats.records_adopted += int(win_h.sum())
            widx = np.nonzero(win_h)[0]

            def value_at(i):
                return None if tomb[i] else int(val[i])

            # Slots are unique here, so a queried slot matches at most
            # one payload row.
            # crdtlint: disable=add-batch-unique-keys -- duplicate slots are collapsed last-wins by the callers before reaching here (the unique-slot contract above)
            self._hub.add_batch(
                lambda: ([int(slots[i]) for i in widx],
                         [value_at(i) for i in widx]),
                lambda q: ((True,
                            value_at(int(np.nonzero(slots == q)[0][-1])))
                           if isinstance(q, (int, np.integer))
                           and bool(np.any(slots[widx] == q))
                           else (False, None)))
        else:
            self.stats.add_adopted_lazy(win.sum())
        self._canonical_time = Hlc.send(
            Hlc.from_logical_time(new_canonical, self._node_id),
            millis=self._wall_clock())
        return repack_mask

    # A delta covering at least 1 / WIDE_JOIN_FRACTION of the slots joins
    # as the elementwise N-wide sweep (`wire_join_step`), a smaller one
    # as the k-row join (`sparse_fanin_step`): the JAX package's cutover,
    # kept so that both packages take the same route on the same delta.
    WIDE_JOIN_FRACTION = 4

    def _dispatch_columns(self, slots: np.ndarray, lt: np.ndarray,
                          node: np.ndarray, val: np.ndarray,
                          tomb: np.ndarray, new_canonical: int,
                          my_ord: int, repack_since_lt: Optional[int]):
        """A validated columnar delta through the store join, IN PLACE
        on the writable store; on a typed store the typed joins, with
        the tag lane per slot (wide) or per row (sparse). Returns
        ``(win, slot_aligned, repack_mask)``: ``win`` per slot (N-wide)
        when ``slot_aligned``, else per padded row; ``repack_mask`` only
        from the untyped sparse join asked for it (a relay on a typed
        store packs afresh, as the JAX package's does)."""
        k, n = len(slots), self.n_slots
        store = self._writable_store()
        typed = self._sem is not None
        if k * self.WIDE_JOIN_FRACTION >= n:
            # The k rows cross to the card, which lays them out N-wide.
            at = self._to_device(slots.astype(np.int64))

            def wide(rows, dtype):
                lane = torch.zeros(n, dtype=dtype, device=self._device)
                lane[at] = self._to_device(rows).to(dtype)
                return lane

            lanes = (wide(lt, torch.int64), wide(node, torch.int32),
                     wide(val, torch.int64), wide(tomb, torch.bool),
                     wide(np.ones(k, bool), torch.bool), new_canonical,
                     my_ord)
            if typed:
                _, win = typed_wire_join_step(store, self._sem_device(),
                                              *lanes)
            else:
                _, win = wire_join_step(store, *lanes)
            return win, True, None
        # Padded to a power of two with invalid rows at the n_slots
        # sentinel, so a steady stream of deltas reuses a few sizes.
        padded = 1 << max(k - 1, 1).bit_length()

        def pad(rows, fill, dtype):
            lane = np.full(padded, fill, dtype)
            lane[:k] = rows
            return self._to_device(lane)

        rows = (pad(slots, n, np.int64), pad(lt, 0, np.int64),
                pad(node, 0, np.int32), pad(val, 0, np.int64),
                pad(tomb, False, bool), pad(True, False, bool))
        if typed:
            _, win = typed_sparse_join_step(
                store, pad(self._sem[slots], 0, np.int8), *rows,
                new_canonical, my_ord)
            return win, False, None
        if repack_since_lt is not None:
            _, win, mask = merge_repack_step(store, *rows, new_canonical,
                                             my_ord, repack_since_lt)
            return win, False, mask
        _, win = sparse_fanin_step(store, *rows, new_canonical, my_ord)
        return win, False, None


class ShardedDenseCrdt(DenseCrdt):
    """`DenseCrdt` with its key space sharded over a device mesh
    (`parallel.make_fanin_mesh`): each key shard lives on the mesh's key
    axis, one real copy per replica position. ``merge``/``merge_many``
    shard the incoming rows over the replica axes and run the sharded
    step (`parallel.make_sharded_fanin`: K1 per block, then the
    lexicographic max over the replica axes); flushes commit with one K2
    launch per key shard and copy (`parallel.make_sharded_ingest`).

    It is one object over one mesh, as in the JAX package: clock,
    scalars and incoming changesets live on the mesh's first device,
    global views (``store``, ``values``, exports, snapshots) are gathered
    there. Value-width masking and the seen count run on the whole
    changeset before sharding; the sharded step's flags are the
    closed-form superset flags, and when one trips the exact guards run
    on the unsharded changeset in row order, so raised exceptions carry
    the single-device payloads and per-block false positives never
    reject a merge. A ``pipelined()`` window's merges take the sharded
    step too, with `DenseCrdt`'s window bookkeeping.

    The columnar merges (``merge_packed``, ``merge_json``,
    ``merge_records``, ``merge_and_repack``) and ``put_slot_records``
    route each row to its key shard and write every copy of that shard
    alike; ``gc_purge`` purges every copy and keeps one fence slice per
    key shard; ``digest_tree`` and ``compact`` work shard by shard
    (`parallel.make_sharded_digest`, `make_sharded_compact`), with the
    JAX sharded model's fallbacks to the whole store when a leaf would
    straddle two shards or ``compact`` is given ranges.

    A typed store's merges fold per key shard on every copy of that
    shard (`parallel.make_sharded_typed_fanin`; the columnar merges
    take the typed joins shard by shard), never K1p, and the digest and
    compaction carry the tag column. The host tag column and its device
    mirror are global, on the first device; each block takes its slice.
    """

    def __init__(self, node_id: Any, n_slots: int, mesh, *,
                 wall_clock: Optional[Callable[[], int]] = None,
                 node_ids: Optional[Sequence[Any]] = None,
                 value_width: int = 64,
                 store: Optional[DenseStore] = None):
        self._mesh = mesh
        self._sharded_step = make_sharded_fanin(mesh)
        self._sharded_ingest = make_sharded_ingest(mesh)
        self._typed_step = make_sharded_typed_fanin(mesh)
        super().__init__(node_id, n_slots, device=mesh.home,
                         wall_clock=wall_clock, node_ids=node_ids,
                         value_width=value_width, store=store)

    def _adopt_store(self, n_slots: int, store: Optional[DenseStore]):
        if store is None:
            store = empty_dense_store(n_slots, self._device)
        return shard_store(store, self._mesh)

    @property
    def store(self) -> DenseStore:
        """The store gathered in global slot order on the first device
        (a copy: later writes do not reach it)."""
        self.drain_ingest()
        return gather_store(self._store)

    @property
    def values(self) -> torch.Tensor:
        """The val lane, gathered (a copy)."""
        return self.store.val

    def refresh_canonical_time(self) -> None:
        self.drain_ingest()
        self._canonical_time = Hlc.from_logical_time(
            int(sharded_max_logical_time(self._mesh)(self._store)),
            self._node_id)

    def _slot_fields(self, slot: int, *names: str) -> List[int]:
        w = self._store.width
        blk = self._store.blocks[0][slot // w]
        return torch.stack([getattr(blk, f)[slot % w].long()
                            for f in names]).tolist()

    def _intern_ids(self, node_ids: Sequence[Any]) -> None:
        remap = self._table.intern(list(node_ids))
        if remap is not None:
            self._store = self._store.map(lambda b: reencode(b, remap))

    def _writable_store(self):
        """The sharded lanes, written in place block by block (the
        gathered views are copies, so nothing escapes)."""
        self._touch_store()
        return self._store

    def _gathered(self) -> DenseStore:
        return gather_store(self._store)

    def _by_shard(self, slots: np.ndarray):
        """``(k, rows)`` for each key shard that the global ``slots``
        touch, ``rows`` the indices of its slots in ``slots``."""
        shard = slots // self._store.width
        for k in np.unique(shard).tolist():
            yield k, np.nonzero(shard == k)[0]

    def _write_local(self, slots: np.ndarray, values: Optional[np.ndarray],
                     tombs: Optional[np.ndarray]) -> None:
        """The local batch scattered into every copy of each key shard
        it touches, at shard-local slots."""
        slots, values, tombs = self._last_wins(slots, values, tombs)
        t, me = self._canonical_time.logical_time, self._local_ordinal()
        w = self._writable_store().width
        for k, sel in self._by_shard(slots):
            for blk in self._store.column(k):
                dev = blk.lt.device
                idx = torch.tensor(slots[sel] - k * w, device=dev)
                if values is None:
                    # crdtlint: disable=scatter-combiner-bypass -- only reached from put_batch / delete_batch after their ingest() branch staged the rows and returned, so no window is open here
                    delete_scatter(blk, idx, t, me)
                else:
                    # crdtlint: disable=scatter-combiner-bypass -- only reached from put_batch / delete_batch after their ingest() branch staged the rows and returned, so no window is open here
                    put_scatter(blk, idx, torch.tensor(values[sel],
                                                       device=dev), t, me,
                                tombs=None if tombs is None
                                else torch.tensor(tombs[sel], device=dev))

    def _scatter_records(self, slots: np.ndarray,
                         rows: Dict[str, np.ndarray]) -> None:
        w = self._writable_store().width
        for k, sel in self._by_shard(slots):
            for blk in self._store.column(k):
                dev = blk.lt.device
                # crdtlint: disable=scatter-combiner-bypass -- only reached from put_slot_records, which drained the ingest window first
                record_scatter(
                    blk, torch.tensor(slots[sel] - k * w, device=dev),
                    **{f: torch.tensor(a[sel], device=dev)
                       for f, a in rows.items()})

    def _dispatch_columns(self, slots: np.ndarray, lt: np.ndarray,
                          node: np.ndarray, val: np.ndarray,
                          tomb: np.ndarray, new_canonical: int,
                          my_ord: int, repack_since_lt: Optional[int]):
        """A validated columnar delta joined shard by shard: each key
        shard's rows go to every copy of that shard, at shard-local
        slots, through the route the unsharded model takes for the
        whole delta (the wide join when it covers a quarter of the
        slots, else the sparse join; their typed forms on a typed
        store); no store is gathered. ``win`` comes back on the first
        device, per slot when wide, else per payload row;
        ``repack_mask`` is the shard-local delta mask over the joined
        untyped store."""
        k_rows, n = len(slots), self.n_slots
        wide = k_rows * self.WIDE_JOIN_FRACTION >= n
        typed = self._sem is not None
        w = self._writable_store().width
        win = torch.zeros(n if wide else k_rows, dtype=torch.bool,
                          device=self._device)
        for k, sel in self._by_shard(slots):
            for rank, blk in enumerate(self._store.column(k)):
                dev = blk.lt.device
                at = torch.tensor(slots[sel] - k * w, device=dev)
                rows = [torch.tensor(a[sel], device=dev)
                        for a in (lt, node, val, tomb)]
                valid = torch.ones(len(sel), dtype=torch.bool, device=dev)
                if wide:
                    def lane(r):
                        out = r.new_zeros(w)
                        out[at] = r
                        return out

                    lanes = [lane(r) for r in rows + [valid]]
                    if typed:
                        _, part = typed_wire_join_step(
                            blk, self._sem_device()[k * w:(k + 1) * w]
                            .to(dev), *lanes, new_canonical, my_ord)
                    else:
                        _, part = wire_join_step(blk, *lanes,
                                                 new_canonical, my_ord)
                elif typed:
                    _, part = typed_sparse_join_step(
                        blk, torch.tensor(self._sem[slots[sel]], device=dev),
                        at, *rows, valid, new_canonical, my_ord)
                else:
                    _, part = sparse_fanin_step(blk, at, *rows, valid,
                                                new_canonical, my_ord)
                if rank == 0:
                    if wide:
                        win[k * w:(k + 1) * w] = part.to(self._device)
                    else:
                        win[torch.from_numpy(sel).to(self._device)] = \
                            part.to(self._device)
        mask = None
        if repack_since_lt is not None and not wide and not typed:
            mask = self._since_mask(repack_since_lt)
        return win, wide, mask

    def _commit_scatter(self, slots: np.ndarray, lt: np.ndarray,
                        vals: np.ndarray, tombs: np.ndarray,
                        order: np.ndarray) -> None:
        self._touch_store()
        self._sharded_ingest(self._store,
                             *self._flush_lanes(slots, lt, vals, tombs,
                                                order),
                             self._local_ordinal())

    def _dispatch_fanin(self, cs: DenseChangeset, wall: int):
        # The whole changeset's count, before sharding: K1p's per-block
        # counts are not read.
        cs, voverflow = mask_value_width(cs, self._value_width)
        seen = cs.valid.sum()
        if self._sem is not None:
            new_store, res = self._typed_step(
                self._store, self._sem_device(), cs, self._canonical_lt(),
                self._local_ordinal(), wall)
        else:
            new_store, res = self._sharded_step(
                self._store, shard_changeset(cs, self._mesh),
                self._canonical_lt(), self._local_ordinal(), wall)
        return Stamped(new_store, res, seen, voverflow), cs

    def _emit_merge_wins(self, store, win: torch.Tensor) -> None:
        if self._hub.active:
            super()._emit_merge_wins(gather_store(store), win)

    def merge_split(self, scs, node_ids: Sequence[Any]) -> None:
        """A pre-split changeset merged as ``merge`` merges it: the lanes
        are widened first (the JAX sharded model's route)."""
        scs = self._fit_split(scs)
        self.drain_ingest()
        _, n = _cs_shape(scs)
        if n != self.n_slots:
            raise ValueError(
                f"pre-split changeset covers {n} slots but this replica "
                f"holds {self.n_slots}; use merge() (the wide path pads"
                "/refuses capacity mismatches)")
        self.merge(split_to_wide(scs), node_ids)

    # --- deltas out, through the shard-local delta mask ---

    def _delta_mask(self, modified_since: Optional[Hlc]) -> torch.Tensor:
        if modified_since is None:
            return gather_lane(self._store, "occupied")
        return self._since_mask(modified_since.logical_time)

    def _since_mask(self, since_lt: int) -> torch.Tensor:
        """The inclusive delta mask, shard-local, on the first device."""
        return sharded_delta_mask(self._mesh)(self._store, since_lt)

    def _range_delta_mask(self, since: Optional[Hlc], spans) -> torch.Tensor:
        since_lt = 0 if since is None else since.logical_time
        return range_delta_mask(self._since_mask(since_lt),
                                *self._span_lanes(spans))

    def _rows_at(self, mask: torch.Tensor, *names: str
                 ) -> Tuple[np.ndarray, ...]:
        idx = torch.nonzero(mask).reshape(-1)
        return (idx.cpu().numpy(),
                *(gather_lane(self._store, f)[idx].cpu().numpy()
                  for f in names))

    def export_delta(self, since: Optional[Hlc] = None
                     ) -> Tuple[DenseChangeset, List[Any]]:
        self.drain_ingest()
        store = gather_store(self._store)
        valid = self._delta_mask(since)
        return DenseChangeset(lt=store.lt[None], node=store.node[None],
                              val=store.val[None], tomb=store.tomb[None],
                              valid=valid[None]), self._table.ids()

    # --- digest, GC and compaction, shard by shard ---

    def _digest_levels(self) -> Tuple[torch.Tensor, ...]:
        """Per-shard leaves against global positions
        (`parallel.make_sharded_digest`); when a leaf would straddle two
        shards, the digest of the gathered store."""
        if self._store.width % self.DIGEST_LEAF_WIDTH:
            return digest_tree_device(self._gathered(), self._sem_or_none(),
                                      self.DIGEST_LEAF_WIDTH)
        return make_sharded_digest(self._mesh, self.DIGEST_LEAF_WIDTH)(
            self._store, self._sem_or_none())

    def _purge_stable(self, floor: int):
        """`ops.dense.gc_purge` on every copy of every key shard; the
        count and the fence slices from the rank-0 copies."""
        n_purged, masks = 0, []
        for k in range(len(self._writable_store().blocks[0])):
            for rank, blk in enumerate(self._store.column(k)):
                _, count, purged = gc_purge(blk, floor)
                if rank == 0:
                    n_purged += int(count)
                    masks.append(purged)
        return n_purged, masks

    def _purged_host(self, purged) -> np.ndarray:
        return torch.cat([m.cpu() for m in purged]).numpy()

    # The GC fence is one slice per key shard, on its rank-0 copy's
    # device.

    def _fence_add(self, purged) -> None:
        self._gc_fence = (purged if self._gc_fence is None else
                          [a | b for a, b in zip(self._gc_fence, purged)])

    def _fence_mask(self) -> Optional[torch.Tensor]:
        if self._gc_fence is None:
            return None
        return torch.cat([m.to(self._device) for m in self._gc_fence])

    def _set_fence(self, fence: Optional[torch.Tensor]) -> None:
        w = self._store.width
        self._gc_fence = None if fence is None else [
            fence[k * w:(k + 1) * w].to(blk.lt.device)
            for k, blk in enumerate(self._store.blocks[0])]

    def _compact_store(self, spans, whole: bool):
        """Without ``ranges``, each key shard packs to its own prefix
        (`parallel.make_sharded_compact`), as the JAX sharded model
        does; with ``ranges``, or when a leaf would straddle two
        shards, the gathered store compacts as one and is sharded
        again."""
        if whole and not self._store.width % self.DIGEST_LEAF_WIDTH:
            return make_sharded_compact(self._mesh, self.DIGEST_LEAF_WIDTH)(
                self._store, self._sem_or_none())
        new_store, new_sem, translation, levels = self._compact_remap(
            self._gathered(), spans)
        return (self._adopt_store(self.n_slots, new_store), new_sem,
                translation, levels)

    @staticmethod
    def _load_device(kwargs) -> Any:
        """A sharded snapshot loads onto the mesh's first device."""
        mesh = kwargs.get("mesh")
        return None if mesh is None else mesh.home

    def grow(self, n_slots: int) -> None:
        """`DenseCrdt.grow` on the gathered store, sharded again at the
        new width; ``n_slots`` must divide over the key shards."""
        k = self._mesh.shape[KEY_AXIS]
        if n_slots % k:
            raise ValueError(f"n_slots={n_slots} not divisible by the "
                             f"mesh's {k} key shards")
        super().grow(n_slots)


def sync_dense(local: DenseCrdt, remote: DenseCrdt) -> None:
    """One anti-entropy round between two dense replicas
    (test/map_crdt_test.dart:273-279 semantics)."""
    time = local.canonical_time
    cs, ids = local.export_delta()
    remote.merge(cs, ids)
    cs, ids = remote.export_delta(since=time)
    local.merge(cs, ids)
