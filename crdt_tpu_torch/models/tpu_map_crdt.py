"""Hybrid host-shadow / device-columnar CRDT backend: the drop-in
general-key path.

Port of ``crdt_tpu/models/tpu_map_crdt.py``. A drop-in `Crdt` subclass
(the reference's plugin pattern, README.md:39) holding the record store
as structure-of-arrays lanes twice over:

- **Host shadow** (numpy): the authoritative copy. Every per-record
  decision on the Python-object boundary (the recv guard masks, a
  vectorized running max, hlc.dart:80-97; the LWW win compare,
  crdt.dart:83-84; record and JSON export) runs as batched numpy ops
  here. A backend that asked the card for win masks or guard flags
  would pay a device-to-host copy per record-dict batch, which no batch
  size amortizes, so reads and merges never fetch anything.
- **Device mirror** (`crdt_tpu_torch.ops.merge.Store` on the model's
  device): pushed lazily, as one copy of every lane, when a device
  consumer reads `store`; every write drops it. It is the bridge into
  bulk tensor work (`ops.merge.merge_step`, `max_logical_time`,
  `delta_mask`). The record-dict paths (`merge`, `merge_json`,
  `put_all`, `record_map`, `to_json`) never touch it. The mirror is a
  copy even on the CPU: the shadow is written in place.

Wire ingest (`merge_json`) decodes straight to columns
(`crdt_json.decode_columns`: the C batch HLC parse into the packed
int64 lane) and merges without building a `Record` or `Hlc` per
record.

Division of labor with the reference semantics (crdt.dart:77-94):
clock absorption collapses to a running max; the duplicate-node and
drift guards evaluate against the exclusive cumulative max in payload
visit order (recv's fast path shields records the canonical clock
already dominates, hlc.dart:85); winners re-stamp ``modified`` with the
post-absorption canonical (crdt.dart:86-87); the final ``send`` bump
runs on the host (crdt.dart:93).

Device rule: ``device=None`` is the card, and the constructor raises
without one unless the caller passes ``device="cpu"``, as every entry
point of this package does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, TypeVar

import numpy as np
import torch

from ..crdt import Crdt
from .. import crdt_json
from ..hlc import (MAX_COUNTER, SHIFT, ClockDriftException,
                   DuplicateNodeException, Hlc)
from ..record import KeyDecoder, Record, ValueDecoder
from ..watch import ChangeHub, ChangeStream
from ..ops.merge import Store
from ..ops.packing import NodeTable
from ..utils.devices import resolve_device
from ..utils.stats import MergeStats, merge_annotation

K = TypeVar("K")
V = TypeVar("V")

_MIN_CAPACITY = 8


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 2 else max(n, _MIN_CAPACITY)


class _HostLanes:
    """The shadow store: six numpy lanes, grown geometrically."""

    __slots__ = ("lt", "node", "mod_lt", "mod_node", "occupied", "tomb")

    def __init__(self, capacity: int):
        self.lt = np.zeros(capacity, np.int64)
        self.node = np.zeros(capacity, np.int32)
        self.mod_lt = np.zeros(capacity, np.int64)
        self.mod_node = np.zeros(capacity, np.int32)
        self.occupied = np.zeros(capacity, bool)
        self.tomb = np.zeros(capacity, bool)

    @property
    def capacity(self) -> int:
        return self.lt.shape[0]

    def grow(self, capacity: int) -> None:
        pad = capacity - self.capacity
        if pad <= 0:
            return
        for name in self.__slots__:
            lane = getattr(self, name)
            setattr(self, name, np.concatenate(
                [lane, np.zeros(pad, lane.dtype)]))

    def remap_nodes(self, remap: np.ndarray) -> None:
        self.node = remap[self.node]
        self.mod_node = remap[self.mod_node]


class TpuMapCrdt(Crdt[K, V]):
    """LWW-map CRDT with host-shadow lanes + a lazy device mirror."""

    def __init__(self, node_id: Any,
                 seed: Optional[Dict[K, Record[V]]] = None,
                 wall_clock: Optional[Callable[[], int]] = None,
                 capacity: int = _MIN_CAPACITY, *, device=None):
        self._node_id = node_id
        self._home = resolve_device(device)
        self._table = NodeTable([node_id])
        self._lanes = _HostLanes(max(capacity, _MIN_CAPACITY))
        self._device: Optional[Store] = None   # None = stale mirror
        self._key_to_slot: Dict[K, int] = {}
        self._slot_keys: List[K] = []       # slot -> key, insertion order
        self._payload: List[Any] = []       # slot -> value (None = tombstone)
        self._hub = ChangeHub()
        self.stats = MergeStats().register(backend="TpuMapCrdt",
                                           node=str(node_id))
        if seed:
            # Seed lands before the canonical clock is derived, so
            # refresh_canonical_time absorbs it (map_crdt.dart:16-18 +
            # crdt.dart:31-33).
            self.put_records(dict(seed))
        super().__init__(wall_clock=wall_clock)

    # --- host bookkeeping ---

    @property
    def node_id(self) -> Any:
        return self._node_id

    @property
    def device(self) -> torch.device:
        """Where the mirror lives."""
        return self._home

    @property
    def store(self) -> Store:
        """The device mirror of the shadow lanes (`ops.merge.Store`),
        pushed on demand: one copy of each lane, never a view of the
        shadow, which later writes change in place."""
        if self._device is None:
            l = self._lanes
            self._device = Store(*(
                torch.tensor(getattr(l, f), device=self._home)
                for f in Store._fields))
        return self._device

    def _my_ordinal(self) -> int:
        return self._table.ordinal(self._node_id)

    def _intern_nodes(self, node_ids) -> None:
        remap = self._table.intern(node_ids)
        if remap is not None:
            self._lanes.remap_nodes(remap)
            self._device = None

    def _ensure_slots(self, keys: Sequence[K]) -> np.ndarray:
        from .. import native
        codec = native.load()
        if codec is not None and isinstance(keys, list):
            # C batch get-or-insert: the same dict and slot order,
            # without a Python dispatch per key.
            buf, new_keys = codec.ensure_slots(
                self._key_to_slot, keys, len(self._slot_keys))
            slots = np.frombuffer(buf, np.int64)
            if new_keys:
                self._slot_keys.extend(new_keys)
                self._payload.extend([None] * len(new_keys))
        else:
            slots = np.empty(len(keys), dtype=np.int64)
            get = self._key_to_slot.get
            start = len(self._slot_keys)   # dict/lists in lockstep here
            pending = None   # key dict-inserted but not yet in the lists
            try:
                for i, key in enumerate(keys):
                    slot = get(key)
                    if slot is None:
                        slot = len(self._slot_keys)
                        pending = key
                        self._key_to_slot[key] = slot
                        self._slot_keys.append(key)
                        self._payload.append(None)
                        pending = None
                    slots[i] = slot
            except BaseException:
                # mid-batch failure (e.g. unhashable key): roll back
                # to the pre-batch state so dict and slot tables stay
                # consistent — the C path's contract. `pending` covers
                # the window where the dict holds a key the list tail
                # doesn't (yet).
                if pending is not None:
                    try:
                        del self._key_to_slot[pending]
                    except Exception:
                        pass  # the insert itself failed (unhashable)
                for key in self._slot_keys[start:]:
                    # pop (not del): the pending key may sit in both
                    # the list tail and the pending-cleanup above
                    self._key_to_slot.pop(key, None)
                del self._slot_keys[start:]
                del self._payload[start:]
                raise
        if len(self._slot_keys) > self._lanes.capacity:
            self._lanes.grow(_next_pow2(len(self._slot_keys)))
            self._device = None
        return slots

    def _ordinals(self, node_ids: Sequence[Any]) -> np.ndarray:
        """Vectorized id->ordinal encode (ids already interned)."""
        return self._table.encode(node_ids)

    # --- storage primitives (crdt.dart:140-169) ---

    def contains_key(self, key: K) -> bool:
        return key in self._key_to_slot

    def get_record(self, key: K) -> Optional[Record[V]]:
        slot = self._key_to_slot.get(key)
        if slot is None:
            return None
        l = self._lanes
        if not l.occupied[slot]:
            return None
        lt, mlt = int(l.lt[slot]), int(l.mod_lt[slot])
        return Record(
            Hlc._raw(lt >> SHIFT, lt & MAX_COUNTER,
                     self._table.id_of(int(l.node[slot]))),
            self._payload[slot],
            Hlc._raw(mlt >> SHIFT, mlt & MAX_COUNTER,
                     self._table.id_of(int(l.mod_node[slot]))))

    def put_record(self, key: K, record: Record[V]) -> None:
        self.put_records({key: record})

    def put_records(self, record_map: Dict[K, Record[V]]) -> None:
        if not record_map:
            return
        self.stats.puts += 1
        self.stats.records_put += len(record_map)
        keys = list(record_map.keys())
        records = list(record_map.values())
        m = len(records)
        from .. import native
        codec = native.load()
        if codec is not None:
            lt_buf, hlc_nodes, values, mlt_buf, mod_nodes = \
                codec.records_to_columns(records, True)
            lt = np.frombuffer(lt_buf, np.int64)
            mod_lt = np.frombuffer(mlt_buf, np.int64)
            tomb = np.frombuffer(codec.none_mask(values), bool)
        else:
            lt = np.fromiter((r.hlc.logical_time for r in records),
                             np.int64, count=m)
            mod_lt = np.fromiter(
                (r.modified.logical_time for r in records),
                np.int64, count=m)
            hlc_nodes = [r.hlc.node_id for r in records]
            mod_nodes = [r.modified.node_id for r in records]
            values = [r.value for r in records]
            tomb = np.fromiter((v is None for v in values), bool,
                               count=m)
        self._intern_nodes(hlc_nodes + mod_nodes)
        slots = self._ensure_slots(keys)
        l = self._lanes
        l.lt[slots] = lt
        l.node[slots] = self._ordinals(hlc_nodes)
        l.mod_lt[slots] = mod_lt
        l.mod_node[slots] = self._ordinals(mod_nodes)
        l.occupied[slots] = True
        l.tomb[slots] = tomb
        self._device = None
        self._scatter_all_and_emit(codec, slots, keys, values)

    def _scatter_all_and_emit(self, codec, slots, keys, values) -> None:
        """Whole-batch payload write (every entry lands — the put
        shapes, where there is no LWW filter) + batch event emission.
        The C scatter runs whether or not anyone is watching; events
        come afterwards, so a subscriber never de-vectorizes a bulk
        put (same contract as the merge path)."""
        payload = self._payload
        if codec is not None:
            codec.scatter_payload(payload, slots,
                                  np.arange(len(keys), dtype=np.int64),
                                  values)
        else:
            for i in range(len(keys)):
                payload[slots[i]] = values[i]
        if self._hub.active:
            key_to_slot = self._key_to_slot

            def get(k):
                slot = key_to_slot.get(k)
                # batch slots are exactly this put's keys; a key maps
                # into the batch iff its post-put payload position was
                # just written — putAll batches are dict-keyed, so
                # membership is equality of the stored slot
                if slot is None or not np.any(slots == slot):
                    return False, None
                return True, payload[slot]

            # crdtlint: disable=add-batch-unique-keys -- putAll batches are dict-keyed, so a key cannot repeat within the batch
            self._hub.add_batch(lambda: (list(keys), list(values)), get)

    def _delta_slots(self, modified_since: Optional[Hlc]) -> np.ndarray:
        """Occupied slot indices passing the INCLUSIVE ``modified``
        delta bound (map_crdt.dart:44-45) — the one delta-selection
        shared by ``record_map`` and the lane-direct ``to_json``."""
        n = len(self._slot_keys)
        if n == 0:
            return np.empty(0, np.int64)
        l = self._lanes
        mask = l.occupied[:n]
        if modified_since is not None:
            mask = mask & (l.mod_lt[:n] >= modified_since.logical_time)
        return np.nonzero(mask)[0]

    def put_all(self, values: Dict[K, Optional[V]]) -> None:
        """Batch put, ONE shared send-stamped HLC (crdt.dart:46-54) —
        written straight to the lanes: every record in the batch
        carries the identical (t, t) stamp pair, so there is nothing
        per-record to extract and no Record objects to build."""
        if not values:
            return  # no clock touch on an empty batch (crdt.dart:47-48)
        self._canonical_time = Hlc.send(self._canonical_time,
                                        millis=self._wall_clock())
        t = self._canonical_time.logical_time
        self.stats.puts += 1
        self.stats.records_put += len(values)
        keys = list(values.keys())
        vals = list(values.values())
        self._intern_nodes([self._node_id])
        my_ord = self._my_ordinal()
        slots = self._ensure_slots(keys)
        from .. import native
        codec = native.load()
        l = self._lanes
        l.lt[slots] = t
        l.node[slots] = my_ord
        l.mod_lt[slots] = t
        l.mod_node[slots] = my_ord
        l.occupied[slots] = True
        if codec is not None:
            l.tomb[slots] = np.frombuffer(codec.none_mask(vals), bool)
        else:
            l.tomb[slots] = np.fromiter((v is None for v in vals),
                                        bool, count=len(vals))
        self._device = None
        self._scatter_all_and_emit(codec, slots, keys, vals)

    def record_map(self, modified_since: Optional[Hlc] = None
                   ) -> Dict[K, Record[V]]:
        idx = self._delta_slots(modified_since)
        if idx.size == 0:
            return {}
        l = self._lanes
        ids = np.array(self._table.ids(), object)
        keys = self._slot_keys
        payload = self._payload
        raw = Hlc._raw
        cols = (idx.tolist(),
                (l.lt[idx] >> SHIFT).tolist(),
                (l.lt[idx] & MAX_COUNTER).tolist(),
                ids[l.node[idx]],
                (l.mod_lt[idx] >> SHIFT).tolist(),
                (l.mod_lt[idx] & MAX_COUNTER).tolist(),
                ids[l.mod_node[idx]])
        return {
            keys[slot]: Record(raw(ms, c, nd), payload[slot],
                               raw(mms, mc, mnd))
            for slot, ms, c, nd, mms, mc, mnd in zip(*cols)
        }

    def to_json(self, modified_since: Optional[Hlc] = None,
                key_encoder=None, value_encoder=None) -> str:
        """Wire export (crdt.dart:124-135) straight from the shadow
        lanes: numpy delta mask, C-codec batch HLC formatting, one
        `json.dumps` — no Record/Hlc materialization. Byte-identical
        to the generic `record_map()` + `crdt_json.encode` path
        (same key stringification, same separators, same insertion
        order), which remains the fallback when the native codec is
        unavailable or a year falls outside the 1-9999 wire window."""
        from .. import native
        codec = native.load()
        if codec is None:
            return super().to_json(modified_since,
                                   key_encoder=key_encoder,
                                   value_encoder=value_encoder)
        l = self._lanes
        idx = self._delta_slots(modified_since)
        if idx.size == 0:
            return "{}"
        id_strs = np.array([str(i) for i in self._table.ids()], object)
        hlcs = codec.format_hlc_batch(
            (l.lt[idx] >> SHIFT).tolist(),
            (l.lt[idx] & MAX_COUNTER).tolist(),
            id_strs[l.node[idx]].tolist())
        if None in hlcs:
            # deferred item: an out-of-window year (the generic encoder
            # raises the reference's fail-fast message) or a non-UTF-8
            # node id (the generic encoder serializes it)
            return super().to_json(modified_since,
                                   key_encoder=key_encoder,
                                   value_encoder=value_encoder)
        keys = self._slot_keys
        payload = self._payload
        kenc = crdt_json.dart_str if key_encoder is None else key_encoder
        slot_list = idx.tolist()
        key_strs = [kenc(keys[s]) for s in slot_list]
        if value_encoder is None:
            values = [payload[s] for s in slot_list]
        else:
            values = [value_encoder(keys[s], payload[s])
                      for s in slot_list]
        dumps = crdt_json.compact_dumps
        if len(set(key_strs)) == len(key_strs):
            out = codec.format_wire(key_strs, hlcs, values, dumps)
            if out is not None:
                return out
        # colliding stringified keys collapse dict-style (last value,
        # first position) — same as the generic path
        obj = {k: {"hlc": h, "value": v}
               for k, h, v in zip(key_strs, hlcs, values)}
        return dumps(obj)

    def watch(self, key: Optional[K] = None) -> ChangeStream:
        return self._hub.stream(key)

    def purge(self) -> None:
        self._lanes = _HostLanes(self._lanes.capacity)
        self._device = None
        self._key_to_slot.clear()
        self._slot_keys.clear()
        self._payload.clear()

    # --- overridden hot paths ---

    def refresh_canonical_time(self) -> None:
        """Vectorized canonical-clock rebuild: one max over the
        occupied lt lane (crdt.dart:114-121 'should be overridden')."""
        if not self._slot_keys:
            self._canonical_time = Hlc.from_logical_time(0, self._node_id)
            return
        l = self._lanes
        max_lt = int(np.max(np.where(l.occupied, l.lt, 0)))
        self._canonical_time = Hlc.from_logical_time(max_lt, self._node_id)

    def merge(self, remote_records: Dict[K, Record[V]]) -> None:
        """Batched lattice join (crdt.dart:77-94 semantics), fully
        vectorized on the shadow lanes."""
        wall = self._wall_clock()
        if not remote_records:
            # Dart still bumps the canonical clock on an empty merge
            # (crdt.dart:93 runs unconditionally). Second wall read keeps
            # clock-tick parity with the scalar oracle's merge.
            self._canonical_time = Hlc.send(self._canonical_time,
                                            millis=self._wall_clock())
            return
        records = list(remote_records.values())
        m = len(records)
        from .. import native
        codec = native.load()
        if codec is not None:
            lt_buf, nodes, values = codec.records_to_columns(
                records, False)
            lt = np.frombuffer(lt_buf, np.int64)
        else:
            lt = np.fromiter((r.hlc.logical_time for r in records),
                             np.int64, count=m)
            nodes = [r.hlc.node_id for r in records]
            values = [r.value for r in records]
        self._merge_columns(list(remote_records.keys()), lt, nodes,
                            values, wall)

    def merge_json(self, json_str: str,
                   key_decoder: Optional[KeyDecoder] = None,
                   value_decoder: Optional[ValueDecoder] = None) -> None:
        """Columnar wire ingest: C batch HLC parse -> packed lanes ->
        vectorized join, no per-record Record/Hlc objects
        (crdt.dart:100-109 surface at numpy speed)."""
        # Tick parity by construction: the decode-time `modified` stamp
        # read (which a merge immediately overwrites for winners) comes
        # from the SAME accounting helper the generic path uses, and
        # the empty payload routes through the real merge({}) — so this
        # override cannot drift from Crdt.merge_json's read count.
        self._decode_wall_millis()
        keys, lt, nodes, values = crdt_json.decode_columns(
            json_str, key_decoder=key_decoder, value_decoder=value_decoder)
        if not keys:
            self.merge({})
            return
        self._merge_columns(keys, lt, nodes, values, self._wall_clock())

    def _merge_columns(self, keys: List[K], lt: np.ndarray,
                       node_ids: List[Any], values: List[Any],
                       wall: int) -> None:
        """The shared merge core on columns. ``lt`` is int64[m] packed
        logical times aligned with ``keys``/``node_ids``/``values``."""
        m = len(keys)
        self.stats.merges += 1
        self.stats.records_seen += m
        self._intern_nodes(set(node_ids))
        node = self._ordinals(node_ids)
        my_ord = self._my_ordinal()
        canonical_lt = self._canonical_time.logical_time

        with merge_annotation("crdt_tpu_torch.host_merge",
                              hlc=lambda: self._canonical_time):
            # --- stage 1: recv guards against the RUNNING canonical
            # (exclusive cummax — the fast path shields records the
            # clock already dominates, hlc.dart:85), in payload visit
            # order like the reference's sequential loop. One shared
            # fold with the other host backends (utils/host_guards.py).
            from ..utils.host_guards import recv_fold_columns
            fold = recv_fold_columns(lt, node == my_ord, canonical_lt,
                                     wall)
            if fold.bad_index is not None:
                # Canonical partially advanced to just before the
                # offender; store and host dicts untouched (guards
                # run before slot allocation — no rollback needed).
                self._canonical_time = Hlc.from_logical_time(
                    fold.canonical_at_fail, self._node_id)
                if fold.bad_is_dup:
                    raise DuplicateNodeException(str(self._node_id))
                raise ClockDriftException(
                    int(lt[fold.bad_index]) >> SHIFT, wall)
            new_canonical = fold.new_canonical

            # --- stage 2: vectorized LWW (strict: local wins ties).
            slots = self._ensure_slots(keys)
            l = self._lanes
            l_lt = l.lt[slots]
            l_node = l.node[slots]
            l_occ = l.occupied[slots]
            win = ~l_occ | (lt > l_lt) | ((lt == l_lt) & (node > l_node))

            # --- stage 3: re-stamp winners, scatter into the shadow.
            from .. import native
            codec = native.load()
            widx = slots[win]
            winners = np.nonzero(win)[0]
            l.lt[widx] = lt[win]
            l.node[widx] = node[win]
            l.mod_lt[widx] = new_canonical
            l.mod_node[widx] = my_ord
            l.occupied[widx] = True
            if codec is not None:
                l.tomb[widx] = np.frombuffer(
                    codec.none_mask(values), bool)[winners]
            else:
                l.tomb[widx] = np.fromiter(
                    (values[i] is None for i in winners),
                    bool, count=winners.size)
            self._device = None

        self.stats.records_adopted += int(winners.size)
        # Payload scatter stays on the C path whether or not anyone is
        # watching (a subscriber must not de-vectorize a 1M merge);
        # events are emitted afterwards from the winner indices.
        payload = self._payload
        if codec is not None:
            codec.scatter_payload(payload, slots, winners, values)
        else:
            for i in winners.tolist():
                payload[slots[i]] = values[i]
        if self._hub.active:
            win_list = winners.tolist()
            key_to_slot = self._key_to_slot

            def get(k):
                slot = key_to_slot.get(k)
                if slot is None:
                    return False, None
                # Exact winner membership: one vectorized scan of the
                # winner slots per keyed stream. (A mod_lt==canonical
                # stamp test is NOT sound here — a merge that doesn't
                # advance the clock leaves pre-merge records carrying
                # the same stamp, yielding spurious events.)
                if not bool(np.any(widx == slot)):
                    return False, None
                return True, payload[slot]

            if len(win_list) == m:   # every record won (fresh sync)
                # crdtlint: disable=add-batch-unique-keys -- merge payloads are dict-keyed record maps: keys cannot repeat
                self._hub.add_batch(lambda: (keys, values), get)
            else:
                # crdtlint: disable=add-batch-unique-keys -- merge payloads are dict-keyed record maps: keys cannot repeat
                self._hub.add_batch(
                    lambda: ([keys[i] for i in win_list],
                             [values[i] for i in win_list]), get)

        self._canonical_time = Hlc.send(
            Hlc.from_logical_time(new_canonical, self._node_id),
            millis=self._wall_clock())
