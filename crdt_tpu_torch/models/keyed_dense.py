"""Keys-over-slots adapter: the full `Crdt` surface on a dense model.

Port of ``crdt_tpu/models/keyed_dense.py``. `DenseCrdt` and
`ShardedDenseCrdt` expose an array surface (slots, int64 lanes) rather
than subclass `Crdt`, but they are the same LWW lattice, so they must
pass the same backend-agnostic conformance suite as every other backend
(test/crdt_test.dart:7-11). This adapter is a thin `Crdt` subclass that
interns arbitrary keys onto dense slots and delegates every operation
(the merge, the typed ops and the watch stream included) to the wrapped
dense model; the canonical clock lives in the dense model alone.

Values must be ints (or None tombstones): the dense payload lane is
int64.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, TypeVar

from ..crdt import Crdt
from ..hlc import Hlc
from ..record import Record
from ..semantics import LWW, SemanticsSpec
from ..watch import ChangeHub, ChangeStream
from .dense_crdt import DenseCrdt

K = TypeVar("K")


class KeyedDenseCrdt(Crdt[K, int]):
    """`Crdt` facade over a dense model (slots-as-keys adapter).

    Key -> slot interning is first-come sequential; interning past the
    wrapped model's ``n_slots`` grows it by doubling (the reference
    map's unbounded growth, map_crdt.dart:10). The adapter re-keys the
    wrapped model's change events, so `watch` filters by KEY, not slot.

    Mixing surfaces: slots written through the raw ``.dense`` surface
    that this adapter never interned appear in `record_map` / `map` /
    watch events keyed by their int slot index, so int user keys can
    collide with them. Use int user keys or raw ``.dense`` writes, not
    both on one adapter.
    """

    def __init__(self, dense: DenseCrdt):
        self._dense = dense
        self._key_to_slot: Dict[K, int] = {}
        self._slot_keys: List[K] = []
        self._hub = ChangeHub()
        self._forwarding = None
        # Deliberately NOT calling Crdt.__init__: the canonical clock is
        # the dense model's (refreshed in its constructor); a second
        # clock here could only drift from it.
        self._wall_clock = dense._wall_clock

    # --- clock: the dense model's, never a copy ---

    @property
    def node_id(self) -> Any:
        return self._dense.node_id

    @property
    def dense(self) -> DenseCrdt:
        """The wrapped dense model (for array-surface access)."""
        return self._dense

    @property
    def _canonical_time(self) -> Hlc:
        # Crdt.merge_json reads this attribute for the decode stamp.
        return self._dense.canonical_time

    @property
    def canonical_time(self) -> Hlc:
        return self._dense.canonical_time

    def refresh_canonical_time(self) -> None:
        self._dense.refresh_canonical_time()

    # --- ingest fast lane: keyed surface over the dense combiner ---

    def ingest(self, auto_flush_rows: int = 1 << 16):
        """The wrapped model's write-combining window
        (`DenseCrdt.ingest`): ``put`` / ``put_all`` / ``delete`` and the
        typed ops issued inside it stage on the host and commit as one
        ingest-kernel launch. Keyed reads stay read-your-writes through
        the dense overlay."""
        return self._dense.ingest(auto_flush_rows=auto_flush_rows)

    def drain_ingest(self) -> bool:
        """Barrier passthrough (`DenseCrdt.drain_ingest`)."""
        return self._dense.drain_ingest()

    def digest_tree(self):
        """Merkle digest passthrough (`DenseCrdt.digest_tree`): keyed
        replicas walk and range-pack over the slot space, so two keyed
        peers must share one key -> slot interning order (the contract
        every packed sync already relies on)."""
        return self._dense.digest_tree()

    # --- key interning ---

    def _intern(self, key: K) -> int:
        slot = self._key_to_slot.get(key)
        if slot is None:
            slot = len(self._slot_keys)
            if slot >= self._dense.n_slots:
                # The reference map grows without bound
                # (map_crdt.dart:10): double the dense capacity.
                self._dense.grow(max(self._dense.n_slots * 2, 1))
            self._key_to_slot[key] = slot
            self._slot_keys.append(key)
        return slot

    # --- local ops: single-stamp batches via the dense scatters ---

    def put(self, key: K, value: Optional[int]) -> None:
        slot = self._intern(key)
        if value is None:
            self._dense.delete_batch([slot])
        else:
            self._dense.put_batch([slot], [value])

    def put_all(self, values: Dict[K, Optional[int]]) -> None:
        if not values:
            return  # no clock touch on an empty batch (crdt.dart:47-48)
        slots = [self._intern(k) for k in values]
        tombs = [v is None for v in values.values()]
        self._dense.put_batch(
            slots, [0 if v is None else v for v in values.values()],
            tombs=tombs if any(tombs) else None)

    def delete(self, key: K) -> None:
        self.put(key, None)

    # --- merge: the dense columnar join, not the generic host loop ---

    def merge(self, remote_records: Dict[K, Record]) -> None:
        self._dense.merge_records(
            {self._intern(k): r for k, r in remote_records.items()})

    # --- typed lanes: keyed surface over crdt_tpu_torch.semantics ---

    def set_semantics(self, keys, semantics) -> None:
        """Assign a registered semantics to the slots behind ``keys``,
        interning unseen keys; the rules of `DenseCrdt.set_semantics`."""
        self._dense.set_semantics(
            [self._intern(k) for k in keys], semantics)

    def semantics_of(self, key: K) -> SemanticsSpec:
        slot = self._key_to_slot.get(key)
        return LWW if slot is None else self._dense.semantics_of(slot)

    def counter_add(self, key: K, delta: int = 1) -> int:
        return self._dense.counter_add(self._intern(key), delta)

    def counter_value(self, key: K) -> int:
        return self._dense.counter_value(self._intern(key))

    def orset_add(self, key: K, element: int) -> frozenset:
        return self._dense.orset_add(self._intern(key), element)

    def orset_remove(self, key: K, element: int) -> frozenset:
        return self._dense.orset_remove(self._intern(key), element)

    def orset_members(self, key: K) -> frozenset:
        return self._dense.orset_members(self._intern(key))

    def mvreg_put(self, key: K, value: int) -> None:
        self._dense.mvreg_put(self._intern(key), value)

    def mvreg_get(self, key: K):
        return self._dense.mvreg_get(self._intern(key))

    # --- storage primitives (crdt.dart:140-169) ---

    def contains_key(self, key: K) -> bool:
        slot = self._key_to_slot.get(key)
        return slot is not None and self._dense.contains_slot(slot)

    def get(self, key: K) -> Optional[int]:
        # The dense POINT read, not Crdt.get's get_record: one small
        # fetch, and inside an ingest() window the staging overlay
        # answers without a flush.
        slot = self._key_to_slot.get(key)
        return None if slot is None else self._dense.get(slot)

    def is_deleted(self, key: K) -> Optional[bool]:
        slot = self._key_to_slot.get(key)
        return None if slot is None else self._dense.is_deleted(slot)

    def get_record(self, key: K) -> Optional[Record]:
        slot = self._key_to_slot.get(key)
        return None if slot is None else self._dense.get_slot_record(slot)

    def put_record(self, key: K, record: Record) -> None:
        self.put_records({key: record})

    def put_records(self, record_map: Dict[K, Record]) -> None:
        self._dense.put_slot_records(
            {self._intern(k): r for k, r in record_map.items()})

    def record_map(self, modified_since: Optional[Hlc] = None
                   ) -> Dict[K, Record]:
        # Raw-slot rows this adapter never interned are keyed by slot
        # index, as the watch forwarder keys them.
        keys = self._slot_keys
        n = len(keys)
        return {(keys[slot] if slot < n else slot): rec
                for slot, rec in self._dense.record_map(
                    modified_since).items()}

    def watch(self, key: Optional[K] = None) -> ChangeStream:
        if self._forwarding is None:
            # One persistent subscription re-keys the dense model's
            # (slot, value) events, and keeps the dense hub active so the
            # bulk paths emit. Raw-slot events pass through keyed by
            # their slot index.
            def forward(event):
                keys = self._slot_keys
                k = (keys[event.key] if 0 <= event.key < len(keys)
                     else event.key)
                self._hub.add(k, event.value)
            self._forwarding = self._dense.watch().listen(forward)
        return self._hub.stream(key)

    def purge(self) -> None:
        self._dense.purge()

    # --- tombstone GC and compaction ---

    def gc_purge(self, stability: Hlc, *,
                 drift_slack_ms: Optional[int] = None) -> int:
        """Epoch tombstone GC passthrough (`DenseCrdt.gc_purge`):
        ``stability`` must be a fleet stability watermark. Purged keys
        keep their interned slots until the next `compact`."""
        return self._dense.gc_purge(stability,
                                    drift_slack_ms=drift_slack_ms)

    def compact(self, ranges=None) -> int:
        """Compact the wrapped store (`DenseCrdt.compact`) and rewrite
        the key -> slot maps from its translation. Keys whose slots were
        reclaimed (purged or never committed) drop from the maps and
        re-intern on next use, so churned capacity is reused. A
        semantics tag given to a key never written leaves with its empty
        slot: assert `set_semantics` again after compacting such keys.
        Returns the number of live keys kept."""
        translation = self._dense.compact(ranges)
        pairs = sorted(
            (int(translation[slot]), key)
            for slot, key in enumerate(self._slot_keys)
            if translation[slot] >= 0)
        slot_keys: List[Any] = []
        key_to_slot: Dict[K, int] = {}
        for new_slot, key in pairs:
            while len(slot_keys) < new_slot:
                # A surviving raw-slot row (never interned) landed
                # between interned keys: hold its place with the slot
                # index, so the intern cursor never hands out an
                # occupied slot.
                slot_keys.append(len(slot_keys))
            slot_keys.append(key)
            key_to_slot[key] = new_slot
        self._slot_keys = slot_keys
        self._key_to_slot = key_to_slot
        return len(pairs)
