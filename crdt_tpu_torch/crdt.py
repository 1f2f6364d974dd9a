"""CRDT core / merge engine: the abstract record-map `Crdt`.

Port of ``crdt_tpu/crdt.py``. It holds the canonical clock and builds
the whole CRDT algebra on seven abstract storage primitives, stage for
stage as the reference's ``lib/src/crdt.dart:1-170``:

- ``put`` advances the clock via ``Hlc.send`` and writes
  ``Record(t, v, t)`` (crdt.dart:39-43);
- ``put_all`` stamps a whole batch with ONE timestamp (crdt.dart:46-54);
- ``delete`` = ``put(key, None)`` (crdt.dart:58); ``clear`` tombstones
  all, or purges (crdt.dart:67-73);
- ``merge``, the lattice join (crdt.dart:77-94): per remote record, (1)
  canonical = ``Hlc.recv(canonical, remote.hlc)`` for winners AND
  losers; (2) LWW filter, local wins on ``local.hlc >= remote.hlc``;
  (3) winners keep the remote ``hlc`` but ``modified`` = the final
  canonical time; (4) bulk store; (5) a final ``Hlc.send`` bump;
- ``refresh_canonical_time`` seeds the clock from the max stored
  logical time (crdt.dart:114-121).

Wall-clock reads are injectable (``wall_clock``), so N-replica tests
are deterministic without sleeps. Under ``CRDT_TPU_SANITIZE=1`` every
merge ends with the sanitizer's domination check
(`analysis.sanitizer.check_scalar_join`).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

from . import crdt_json
from .analysis import sanitizer as _sanitizer
from .hlc import Hlc, wall_clock_millis
from .record import (KeyDecoder, KeyEncoder, Record, ValueDecoder,
                     ValueEncoder)
from .utils.stats import merge_annotation
from .watch import ChangeStream

K = TypeVar("K")
V = TypeVar("V")


class Crdt(ABC, Generic[K, V]):
    """Abstract LWW-map CRDT (crdt.dart:7-170)."""

    # Backends that account merges set a MergeStats here; the base merge
    # then counts seen and adopted records.
    stats = None

    def __init__(self, wall_clock: Optional[Callable[[], int]] = None):
        self._wall_clock = wall_clock or wall_clock_millis
        self._canonical_time: Hlc = None  # set by refresh_canonical_time
        self.refresh_canonical_time()

    # --- clock ---

    @property
    def canonical_time(self) -> Hlc:
        return self._canonical_time

    @property
    @abstractmethod
    def node_id(self) -> Any:
        ...

    def refresh_canonical_time(self) -> None:
        """Seed the canonical clock from the max stored logical time
        (crdt.dart:114-121)."""
        records = self.record_map()
        max_lt = max(
            (r.hlc.logical_time for r in records.values()), default=0)
        self._canonical_time = Hlc.from_logical_time(max_lt, self.node_id)

    # --- views (tombstones excluded: crdt.dart:16-29) ---

    @property
    def map(self) -> Dict[K, V]:
        return {k: r.value for k, r in self.record_map().items()
                if not r.is_deleted}

    @property
    def is_empty(self) -> bool:
        return len(self.map) == 0

    def __len__(self) -> int:
        return len(self.map)

    @property
    def length(self) -> int:
        return len(self.map)

    @property
    def keys(self) -> List[K]:
        return list(self.map.keys())

    @property
    def values(self) -> List[V]:
        return list(self.map.values())

    # --- local ops (crdt.dart:36-73) ---

    def get(self, key: K) -> Optional[V]:
        record = self.get_record(key)
        return None if record is None else record.value

    def put(self, key: K, value: Optional[V]) -> None:
        self._canonical_time = Hlc.send(self._canonical_time,
                                        millis=self._wall_clock())
        self.put_record(key, Record(self._canonical_time, value,
                                    self._canonical_time))

    def put_all(self, values: Dict[K, Optional[V]]) -> None:
        # No clock touch when nothing is inserted.
        if not values:
            return
        self._canonical_time = Hlc.send(self._canonical_time,
                                        millis=self._wall_clock())
        t = self._canonical_time
        self.put_records({k: Record(t, v, t) for k, v in values.items()})

    def delete(self, key: K) -> None:
        self.put(key, None)

    def is_deleted(self, key: K) -> Optional[bool]:
        record = self.get_record(key)
        return None if record is None else record.is_deleted

    def clear(self, purge: bool = False) -> None:
        if purge:
            self.purge()
        else:
            self.put_all({k: None for k in self.map})

    # --- merge: the lattice join (crdt.dart:77-94) ---

    def merge(self, remote_records: Dict[K, Record[V]]) -> None:
        with merge_annotation("crdt_tpu_torch.host_merge",
                              hlc=lambda: self._canonical_time):
            self._merge_impl(remote_records)

    def _merge_impl(self, remote_records: Dict[K, Record[V]]) -> None:
        local_records = self._local_records_for(remote_records)

        wall = self._wall_clock()
        winners: List[K] = []
        for key, record in remote_records.items():
            # Clock absorption runs for winners AND losers (crdt.dart:82).
            self._canonical_time = Hlc.recv(self._canonical_time, record.hlc,
                                            millis=wall)
            local = local_records.get(key)
            if local is not None and local.hlc >= record.hlc:
                continue  # LWW: local wins on tie (crdt.dart:84)
            winners.append(key)

        # Winners keep the remote hlc; modified = the FINAL canonical
        # time, once the whole filter pass is done (crdt.dart:86-87).
        self.put_records({key: Record(remote_records[key].hlc,
                                      remote_records[key].value,
                                      self._canonical_time)
                          for key in winners})

        if self.stats is not None:
            self.stats.merges += 1
            self.stats.add_seen_lazy(len(remote_records))
            self.stats.add_adopted_lazy(len(winners))

        self._canonical_time = Hlc.send(self._canonical_time,
                                        millis=self._wall_clock())

        if _sanitizer.enabled():
            _sanitizer.check_scalar_join(self, remote_records)

    def _decode_wall_millis(self) -> int:
        """The ONE wall-clock read ``merge_json`` spends on the
        decode-time ``modified`` stamp (crdt_json.dart:23-24). An
        override of ``merge_json`` that skips the generic decode must
        spend its tick through this method, so both paths draw the same
        number of reads from an injected clock."""
        return self._wall_clock()

    def merge_json(self, json_str: str,
                   key_decoder: Optional[KeyDecoder] = None,
                   value_decoder: Optional[ValueDecoder] = None) -> None:
        records = crdt_json.decode(
            json_str, self._canonical_time, key_decoder=key_decoder,
            value_decoder=value_decoder,
            now_millis=self._decode_wall_millis())
        self.merge(records)

    # --- wire export (crdt.dart:124-135) ---

    def to_json(self, modified_since: Optional[Hlc] = None,
                key_encoder: Optional[KeyEncoder] = None,
                value_encoder: Optional[ValueEncoder] = None) -> str:
        return crdt_json.encode(
            self.record_map(modified_since=modified_since),
            key_encoder=key_encoder, value_encoder=value_encoder)

    def count_modified_since(self, modified_since: Optional[Hlc] = None
                             ) -> int:
        """How many records (tombstones included) have
        ``modified.logical_time >= modified_since``: the backlog a delta
        sync from that watermark would ship. ``None`` counts the whole
        store."""
        return len(self.record_map(modified_since=modified_since))

    def __repr__(self) -> str:
        return repr(self.record_map())

    def _local_records_for(self, keys) -> Dict[K, Record[V]]:
        """Local records ``merge`` consults for the given keys: the full
        snapshot (the reference shape, crdt.dart:79); a backend whose
        store may exceed memory overrides this with a keyed lookup."""
        return self.record_map()

    # --- abstract storage primitives (crdt.dart:140-169) ---

    @abstractmethod
    def contains_key(self, key: K) -> bool:
        ...

    @abstractmethod
    def get_record(self, key: K) -> Optional[Record[V]]:
        ...

    @abstractmethod
    def put_record(self, key: K, record: Record[V]) -> None:
        """Store a record without updating the HLC. Meant for subclassing;
        clients should use put()."""

    @abstractmethod
    def put_records(self, record_map: Dict[K, Record[V]]) -> None:
        ...

    @abstractmethod
    def record_map(self, modified_since: Optional[Hlc] = None
                   ) -> Dict[K, Record[V]]:
        """Full record map including tombstones; ``modified_since`` keeps
        records with ``modified.logical_time >= t`` (inclusive,
        map_crdt.dart:44-45)."""

    @abstractmethod
    def watch(self, key: Optional[K] = None) -> ChangeStream:
        """Change stream; ``key`` filters to a single key
        (crdt.dart:162-164)."""

    @abstractmethod
    def purge(self) -> None:
        ...
