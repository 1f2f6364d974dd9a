"""In-memory dict-backed CRDT: the host oracle backend.

Port of ``crdt_tpu/models/map_crdt.py`` (the reference's
``lib/src/map_crdt.dart:1-53``): a plain map of records plus a broadcast
change stream, host only. It is the semantic oracle the dense models
are held against, and the right choice for small, host-resident stores.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, Optional, TypeVar

from ..crdt import Crdt
from ..hlc import Hlc
from ..record import Record
from ..utils.stats import MergeStats
from ..watch import ChangeHub, ChangeStream

K = TypeVar("K")
V = TypeVar("V")


class MapCrdt(Crdt[K, V], Generic[K, V]):
    """A CRDT backed by an in-memory map (map_crdt.dart:9-53)."""

    def __init__(self, node_id: Any,
                 seed: Optional[Dict[K, Record[V]]] = None,
                 wall_clock: Optional[Callable[[], int]] = None):
        self._node_id = node_id
        self._map: Dict[K, Record[V]] = dict(seed or {})
        self._hub = ChangeHub()
        self.stats = MergeStats().register(backend="MapCrdt",
                                           node=str(node_id))
        super().__init__(wall_clock=wall_clock)

    @property
    def node_id(self) -> Any:
        return self._node_id

    def contains_key(self, key: K) -> bool:
        return key in self._map

    def get_record(self, key: K) -> Optional[Record[V]]:
        return self._map.get(key)

    def put_record(self, key: K, record: Record[V]) -> None:
        self._map[key] = record
        self._hub.add(key, record.value)

    def put_records(self, record_map: Dict[K, Record[V]]) -> None:
        self._map.update(record_map)
        for key, record in record_map.items():
            self._hub.add(key, record.value)

    def record_map(self, modified_since: Optional[Hlc] = None
                   ) -> Dict[K, Record[V]]:
        # Inclusive bound: keep modified.logical_time >= t
        # (map_crdt.dart:44-45).
        since = 0 if modified_since is None else modified_since.logical_time
        return {k: r for k, r in self._map.items()
                if r.modified.logical_time >= since}

    def watch(self, key: Optional[K] = None) -> ChangeStream:
        return self._hub.stream(key)

    def purge(self) -> None:
        self._map.clear()
