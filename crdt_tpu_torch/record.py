"""Record cell and pluggable codec types (L1).

Matches the reference `lib/src/record.dart:1-39`:

- ``Record`` = ``(hlc, value, modified)``; ``value is None`` encodes a
  tombstone (record.dart:17).
- JSON codec serializes only ``hlc`` + ``value``; ``modified`` is
  local-only and re-stamped on decode (record.dart:28-31).
- Equality ignores ``modified`` (record.dart:34-35).
- Codec callables for non-string keys / custom value classes
  (record.dart:3-9): ``key_encoder(key) -> str``,
  ``value_encoder(key, value) -> jsonable``, ``key_decoder(str) -> key``,
  ``value_decoder(key, jsonable) -> value``,
  ``node_id_decoder(str) -> node_id``.

A copy of ``crdt_tpu/record.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, Optional, TypeVar

from .hlc import Hlc

K = TypeVar("K")
V = TypeVar("V")

KeyEncoder = Callable[[Any], str]
ValueEncoder = Callable[[Any, Any], Any]
KeyDecoder = Callable[[str], Any]
ValueDecoder = Callable[[str, Any], Any]
NodeIdDecoder = Callable[[str], Any]


class Record(Generic[V]):
    """Stores a value associated with a given HLC (record.dart:12-39)."""

    __slots__ = ("hlc", "value", "modified")

    def __init__(self, hlc: Hlc, value: Optional[V], modified: Hlc):
        self.hlc = hlc
        self.value = value
        self.modified = modified

    @property
    def is_deleted(self) -> bool:
        return self.value is None

    @classmethod
    def from_json(cls, key: Any, obj: Dict[str, Any], modified: Hlc,
                  value_decoder: Optional[ValueDecoder] = None,
                  node_id_decoder: Optional[NodeIdDecoder] = None
                  ) -> "Record[V]":
        hlc = Hlc.parse(obj["hlc"], node_id_decoder)
        raw = obj.get("value")
        value = (raw if value_decoder is None or raw is None
                 else value_decoder(key, raw))
        return cls(hlc, value, modified)

    def to_json(self, key: Any = "",
                value_encoder: Optional[ValueEncoder] = None
                ) -> Dict[str, Any]:
        return {
            "hlc": self.hlc.to_json(),
            "value": (self.value if value_encoder is None
                      else value_encoder(key, self.value)),
        }

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, Record) and self.hlc == other.hlc
                and self.value == other.value)

    def __hash__(self) -> int:
        # Equal records share an hlc (equality requires hlc ==), so the
        # hlc alone is a consistent hash even for unhashable values.
        return hash(self.hlc)

    def __repr__(self) -> str:
        return str(self.to_json(""))
