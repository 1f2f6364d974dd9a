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
  coarse ``pipelined()`` window threads the clock on the device.
- **Deltas out.** ``export_delta``, ``pack_since``, ``record_map`` and
  ``to_json`` select rows through `ops.dense.dense_delta_mask`.

Device rule: the store lives on ``device``, which defaults to
``"cuda"``; without a card the constructor raises unless the caller
asks for ``device="cpu"``. Each op wrapper takes the hand-written
kernel for CUDA tensors and its plain torch version for CPU tensors.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import crdt_json
from ..hlc import (MAX_COUNTER, SHIFT, ClockDriftException,
                   DuplicateNodeException, Hlc, wall_clock_millis)
from ..ops.dense import (CHANGESET_DTYPES, DenseChangeset, DenseStore,
                         delete_scatter, dense_delta_mask,
                         dense_max_logical_time, empty_dense_store,
                         put_scatter, store_to_changeset)
from ..ops.fanin_kernel import model_fanin_batch, pipelined_model_step
from ..ops.ingest_kernel import ingest_scatter
from ..ops.merge import recv_guards, send_step
from ..ops.packing import NodeTable, PackedDelta, pack_into_arena
from ..record import KeyEncoder, Record, ValueEncoder
from ..utils.stats import MergeStats, merge_annotation
from ..watch import ChangeHub, ChangeStream


class PipelinedGuardError(Exception):
    """A clock guard tripped inside a ``DenseCrdt.pipelined()`` window.

    Pipelined merges trade first-offender diagnostics for zero
    per-merge host synchronization: guard flags accumulate on device
    and are checked once at the window's end, so all this error can
    say is WHICH guard class fired. Re-run the same batches
    unpipelined for the exact diagnosis (the store already holds the
    merged state — merge is idempotent, a re-run is safe).
    """


class _PipeState:
    """Device-resident clock state threaded across a pipelined window."""

    __slots__ = ("canonical", "any_bad", "overflow", "drift",
                 "val_overflow", "first_flag_idx", "merges")

    def __init__(self, canonical_lt: int, device: torch.device):
        self.canonical = torch.tensor(canonical_lt, dtype=torch.int64,
                                      device=device)
        false = torch.zeros((), dtype=torch.bool, device=device)
        self.any_bad = self.overflow = self.drift = false
        self.val_overflow = false
        # Index (0-based, window order) of the first merge that set ANY
        # flag — the flush names it so a re-run can start there.
        self.first_flag_idx = torch.tensor(-1, dtype=torch.int32,
                                           device=device)
        self.merges = 0

    def note(self, flags: torch.Tensor, idx: int) -> None:
        """Attribute freshly raised flags to window slot ``idx``."""
        self.first_flag_idx = torch.where(
            (self.first_flag_idx < 0) & flags, idx, self.first_flag_idx)


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card, and raises without one: the port
    never carries on silently on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DenseCrdt runs on the CUDA card by default and this host "
                "has none; pass device='cpu' to run the plain torch path")
        device = "cuda"
    return torch.device(device)


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
        if store is None:
            self._store = empty_dense_store(n_slots, self._device)
        else:
            self._store = DenseStore(*(lane.to(self._device)
                                       for lane in store))
        if self._store.n_slots != n_slots:
            raise ValueError(f"store holds {self._store.n_slots} slots but "
                             f"n_slots={n_slots}")
        # Writes update the lanes in place; a store the caller may still
        # hold (a seed, or one handed out by `store`/`values`/
        # `export_delta`) is cloned before the next write instead.
        self._store_escaped = store is not None
        if node_id not in self._table:
            self._intern_ids([node_id])
        self.stats = MergeStats()
        self._hub = ChangeHub()
        self._pipe: Optional[_PipeState] = None
        self._ingest = None     # active WriteCombiner (models/ingest.py)
        self.refresh_canonical_time()

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
    def pipelined(self):
        """Zero-host-sync merge window: inside it, ``merge`` /
        ``merge_many`` thread the canonical clock as a DEVICE scalar
        (the final send bump runs on device, `ops.merge.send_step`) and
        accumulate guard flags instead of fetching them. On exit, ONE
        readback materializes the clock and raises
        `PipelinedGuardError` if any recv/send guard fired.

        Merges land optimistically (a guard violation is already in the
        store when the flush reports it), and the recv flags are the
        kernel's superset flags, so a report may be spurious: re-run
        the batches unpipelined to find out. Store lanes and the
        canonical clock equal the same merges issued unpipelined. Local
        writes are refused inside the window (they need the host
        clock). An active watch subscriber costs one readback per
        merge."""
        if self._pipe is not None:
            raise RuntimeError("pipelined() windows do not nest")
        # Staged ingest rows would otherwise commit with stamps the
        # window never sees — barrier first.
        self.drain_ingest()
        self._pipe = _PipeState(self._canonical_time.logical_time,
                                self._device)
        try:
            yield self
        finally:
            pipe, self._pipe = self._pipe, None
            lt, any_bad, overflow, drift, val_ovf, first_idx = torch.stack(
                [pipe.canonical, pipe.any_bad.long(), pipe.overflow.long(),
                 pipe.drift.long(), pipe.val_overflow.long(),
                 pipe.first_flag_idx.long()]).tolist()
            self._canonical_time = Hlc.from_logical_time(lt, self._node_id)
            kinds = [k for k, f in (
                ("recv-guard (duplicate-node or drift)", any_bad),
                ("send counter overflow", overflow),
                ("send drift", drift),
                ("value-ref overflow (records with values past int32 "
                 "were SKIPPED, not merged; re-sync from the peer with a "
                 "value_width=64 replica)", val_ovf)) if f]
            # Never shadow an exception already leaving the window body.
            if kinds and sys.exc_info()[0] is None:
                raise PipelinedGuardError(
                    f"guards tripped in pipelined window: "
                    f"{', '.join(kinds)}; first flagged at merge "
                    f"#{first_idx} of {pipe.merges} (0-based, window "
                    "order); possibly spurious (superset flags) — re-run "
                    "from that batch unpipelined for the exact diagnosis")

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
                wc.flush()
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
        return False if ing is None else ing.flush()

    @staticmethod
    def _last_wins_keep(slots: np.ndarray) -> Optional[np.ndarray]:
        """Indices keeping the LAST occurrence per duplicate slot, or
        None when already unique."""
        k = len(slots)
        # First occurrence in the reversed view = last in the payload.
        _, idx = np.unique(slots[::-1], return_index=True)
        if len(idx) == k:
            return None
        return np.sort(k - 1 - idx)

    def _commit_scatter(self, slots: np.ndarray, lt: np.ndarray,
                        vals: np.ndarray, tombs: np.ndarray) -> None:
        """ONE ingest-kernel launch committing a deduped flush. The rows
        pad to a power of two with ``slot == n_slots`` sentinels, so a
        steady stream of flushes reuses a few allocation sizes."""
        d = len(slots)
        padded = 1 << max(d - 1, 1).bit_length()
        slot_l = np.full(padded, self.n_slots, np.int64)
        lt_l = np.zeros(padded, np.int64)
        val_l = np.zeros(padded, np.int64)
        tomb_l = np.zeros(padded, bool)
        slot_l[:d] = slots
        lt_l[:d] = lt
        val_l[:d] = vals
        tomb_l[:d] = tombs
        ingest_scatter(self._writable_store(), self._to_device(slot_l),
                       self._to_device(lt_l), self._to_device(val_l),
                       self._to_device(tomb_l), self._local_ordinal())

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
        Slots must be unique within a batch."""
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
        put_scatter(self._writable_store(), self._to_device(slots),
                    self._to_device(values),
                    self._canonical_time.logical_time,
                    self._local_ordinal(),
                    tombs=None if tombs is None else self._to_device(tombs))
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
        delete_scatter(self._writable_store(), self._to_device(slots),
                       self._canonical_time.logical_time,
                       self._local_ordinal())
        self.stats.puts += 1
        self.stats.records_put += int(slots.shape[0])
        self._emit_delete(slots)

    # --- views (tombstones excluded, crdt.dart:16-29) ---

    @property
    def values(self) -> torch.Tensor:
        """int64[n_slots]; only occupied, non-tombstoned slots are live.
        Hands out the live lane, so (like ``store``) it marks the
        snapshot as handed out."""
        self.drain_ingest()
        self._store_escaped = True
        return self._store.val

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
        return bool(self._store.occupied[slot])

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
        vals = [None if tombs is not None and tombs[i] else v
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
        get = None
        if len(pos) == len(sl):
            def get(k):
                i = pos.get(k) if isinstance(k, (int, np.integer)) else None
                return (False, None) if i is None else (True, vals[i])
        self._hub.add_batch((sl, vals), get)

    def _emit_merge_wins(self, store: DenseStore, win: torch.Tensor
                         ) -> None:
        """Winner change events from the merge's win mask — one
        readback of the winners, only when someone listens."""
        if not self._hub.active:
            return
        idx = torch.nonzero(win).reshape(-1)
        tomb = store.tomb[idx].tolist()
        val = store.val[idx].tolist()
        self._emit_slots(idx.tolist(), [None if t else v
                                        for v, t in zip(val, tomb)])

    # --- deltas out (crdt.dart:124-169, map_crdt.dart:44-45) ---

    def _delta_mask(self, modified_since: Optional[Hlc]) -> torch.Tensor:
        if modified_since is None:
            return self._store.occupied
        return dense_delta_mask(self._store, modified_since.logical_time)

    def _delta_rows(self, modified_since: Optional[Hlc], *names: str
                    ) -> Tuple[np.ndarray, ...]:
        """Slots of the delta and lanes ``names`` at those slots,
        selected on the device: only the ``k`` rows cross to the host."""
        idx = torch.nonzero(self._delta_mask(modified_since)).reshape(-1)
        return (idx.cpu().numpy(),
                *(getattr(self._store, f)[idx].cpu().numpy()
                  for f in names))

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
        keys, the reference's int-key golden format."""
        return crdt_json.encode(self.record_map(modified_since),
                                key_encoder=key_encoder,
                                value_encoder=value_encoder)

    def pack_since(self, since: Optional[Hlc] = None
                   ) -> Tuple[PackedDelta, List[Any]]:
        """Outbound O(k) columnar delta: the rows with ``modified >=
        since`` (inclusive, the `export_delta` bound) in the packed wire
        form, plus the node-id list its ordinals index into."""
        self.drain_ingest()
        rows = self._delta_rows(since, "lt", "node", "val", "tomb")
        return pack_into_arena(*rows), self._table.ids()

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

    # --- checkpoint/resume ---

    def save(self, path: str) -> None:
        """Columnar npz snapshot including the node-id table (the format
        of ``crdt_tpu.checkpoint.save_dense``; either package loads it)."""
        self.drain_ingest()
        from ..checkpoint import save_dense
        save_dense(self._store, path, node_ids=self._table.ids())

    @classmethod
    def load(cls, node_id: Any, path: str, **kwargs) -> "DenseCrdt":
        """Resume from a snapshot; the canonical clock rebuilds from the
        lanes (refreshCanonicalTime, crdt.dart:31-33) and writer
        attribution survives via the persisted node table."""
        from ..checkpoint import load_dense_with_node_ids
        store, ids = load_dense_with_node_ids(path)
        if ids is None:
            raise ValueError(
                f"{path} has no node-id table (store-level snapshot); "
                "pass store=load_dense(path) with the original node_ids")
        return cls(node_id, store.n_slots, store=store, node_ids=ids,
                   **kwargs)

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
                f"holds {self.n_slots}")
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
            rd = torch.from_numpy(remap).to(self._device)
            self._store = self._store._replace(
                node=rd[self._store.node.long()],
                mod_node=rd[self._store.mod_node.long()])

    def _encode_peer(self, cs: DenseChangeset, node_ids: Sequence[Any]
                     ) -> DenseChangeset:
        """Rewrite a changeset's ordinals into this replica's table
        (every id already interned)."""
        remap = [self._table.ordinal(n) for n in node_ids]
        if remap == list(range(len(self._table))):
            return cs   # peer table == local table: nothing to rewrite
        peer_to_local = torch.tensor(remap, dtype=torch.int32,
                                     device=self._device)
        # Clamped: an invalid entry's ordinal is never read, but must
        # not index out of range.
        idx = cs.node.long().clamp_(0, len(remap) - 1)
        return cs._replace(node=peer_to_local[idx])

    def merge(self, cs: DenseChangeset, node_ids: Sequence[Any]) -> None:
        """Fan-in a peer changeset whose ``node`` ordinals index
        ``node_ids``; they are remapped into this replica's table."""
        self.merge_many([(cs, node_ids)])

    def merge_many(self, changesets: Sequence[
            Tuple[DenseChangeset, Sequence[Any]]]) -> None:
        """N-replica fan-in: concatenate peer changesets along the
        replica axis (earlier entries win identical-HLC ties, the
        sequential-merge order) and run ONE fused lattice join."""
        self.drain_ingest()
        self.stats.merges += 1
        if not changesets:
            # Merging nothing still spends the absorption-phase wall
            # read AND the final send bump (crdt.dart:77-94).
            self._wall_clock()
            if self._pipe is not None:
                self._pipe.merges += 1
                self._pipe_send_bump(self._wall_clock())
                return
            self._canonical_time = Hlc.send(self._canonical_time,
                                            millis=self._wall_clock())
            return
        # Intern the UNION of every peer's ids first (one table
        # mutation), then encode each changeset against the final table.
        union: set = set()
        for _, ids in changesets:
            union.update(ids)
        self._intern_ids(union)
        parts = [self._encode_peer(self._fit_slots(cs), ids)
                 for cs, ids in changesets]
        cs = parts[0] if len(parts) == 1 else DenseChangeset(
            *(torch.cat([getattr(p, f) for p in parts])
              for f in DenseChangeset._fields))
        local = self._local_ordinal()
        pipe = self._pipe
        if pipe is not None:
            # Both wall reads up front (absorption + send bump): the
            # count and order of the unpipelined path.
            wall_merge = self._wall_clock()
            wall_send = self._wall_clock()
            with merge_annotation("crdt_tpu_torch.dense_merge"):
                (new_store, pipe.canonical, pipe.any_bad, pipe.overflow,
                 pipe.drift, pipe.val_overflow, pipe.first_flag_idx,
                 win_count, win, seen) = pipelined_model_step(
                    self._store, cs, pipe.canonical, pipe.any_bad,
                    pipe.overflow, pipe.drift, pipe.val_overflow,
                    pipe.first_flag_idx, local, wall_merge, wall_send,
                    pipe.merges, value_width=self._value_width)
            pipe.merges += 1
            self._store = new_store
            self._store_escaped = False
            self.stats.add_seen_lazy(seen)
            self.stats.add_adopted_lazy(win_count)
            self._emit_merge_wins(new_store, win)
            return

        wall = self._wall_clock()
        with merge_annotation("crdt_tpu_torch.dense_merge"):
            new_store, res, seen, voverflow = model_fanin_batch(
                self._store, cs, self._canonical_lt(), local, wall,
                value_width=self._value_width)
        self.stats.add_seen_lazy(seen)
        # The result scalars come back in ONE copy; the [N] win mask
        # stays on device unless a watch subscriber needs it.
        any_bad, win_count, new_canonical, val_ovf = torch.stack(
            [(res.any_dup | res.any_drift).long(), res.win.sum(),
             res.new_canonical, voverflow.long()]).tolist()
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
            bad, first_bad, first_is_dup, caf = recv_guards(
                cs.lt, cs.node, cs.valid, self._canonical_time.logical_time,
                local, wall)
            if bool(bad):
                # Store untouched; canonical rolled to the pre-failure
                # value (crdt.dart:77-94 throw path).
                self._canonical_time = Hlc.from_logical_time(
                    int(caf), self._node_id)
                if bool(first_is_dup):
                    raise DuplicateNodeException(str(self._node_id))
                bad_lt = int(cs.lt.reshape(-1)[first_bad])
                raise ClockDriftException(bad_lt >> SHIFT, wall)
        self._store = new_store
        self._store_escaped = False
        self.stats.records_adopted += win_count
        self._emit_merge_wins(new_store, res.win)
        self._canonical_time = Hlc.send(
            Hlc.from_logical_time(new_canonical, self._node_id),
            millis=self._wall_clock())

    def _pipe_send_bump(self, wall: int) -> None:
        """The final crdt.dart:93 send bump, on device, flags
        accumulated (the flush checks them)."""
        pipe = self._pipe
        pipe.canonical, overflow, drift = send_step(pipe.canonical, wall)
        # merges already counts this merge: attribute to merges - 1.
        pipe.note(overflow | drift, pipe.merges - 1)
        pipe.overflow = pipe.overflow | overflow
        pipe.drift = pipe.drift | drift
