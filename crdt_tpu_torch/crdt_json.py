"""JSON wire codec (L3) — the replica-boundary format.

The pure-Python path of ``crdt_tpu/crdt_json.py`` (the C codec there is
an accelerator of the same bytes; the JAX suite runs both modes against
each other). Matches the reference `lib/src/crdt_json.dart:1-38`
byte-for-byte on the golden strings in `test/map_crdt_test.dart:114-150`:

- ``encode``: ``{key: {"hlc": "<iso>-<hex4>-<node>", "value": v}}``,
  compact separators, insertion order preserved.
- ``decode``: stamps every incoming record's ``modified`` with
  ``max(canonical_time, Hlc.now(node_id))`` (crdt_json.dart:23-24).
- Keys stringified by default (crdt_json.dart:13) via :func:`dart_str`,
  which mirrors Dart's ``toString`` for the key types exercised by the
  reference tests (str, int, datetime).
- ``decode_columns``: the columnar decode that ``DenseCrdt.merge_json``
  ingests, with no `Record`/`Hlc` objects per record.
"""

from __future__ import annotations

import functools
import json
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np

from .hlc import SHIFT, Hlc
from .record import (KeyDecoder, KeyEncoder, NodeIdDecoder, Record,
                     ValueDecoder, ValueEncoder)


def dart_str(key: Any) -> str:
    """Default key stringification, matching Dart ``toString()`` for the
    reference's golden key types (map_crdt_test.dart:119-150)."""
    if isinstance(key, datetime):
        # Dart DateTime.toString(): 'YYYY-MM-DD HH:MM:SS.mmm' (+micros if set)
        base = (f"{key.year:04d}-{key.month:02d}-{key.day:02d} "
                f"{key.hour:02d}:{key.minute:02d}:{key.second:02d}")
        micros = key.microsecond
        if micros % 1000 == 0:
            return f"{base}.{micros // 1000:03d}"
        return f"{base}.{micros:06d}"
    if isinstance(key, bool):
        return "true" if key else "false"
    return str(key)


def _default(obj: Any) -> Any:
    to_json = getattr(obj, "to_json", None) or getattr(obj, "toJson", None)
    if callable(to_json):
        return to_json()
    raise TypeError(f"Object of type {type(obj).__name__} "
                    f"is not JSON serializable")


# The wire format's one dumps configuration — compact separators, raw
# UTF-8, to_json-hook default.
compact_dumps = functools.partial(json.dumps, separators=(",", ":"),
                                  ensure_ascii=False, default=_default)


def encode(record_map: Dict[Any, Record],
           key_encoder: Optional[KeyEncoder] = None,
           value_encoder: Optional[ValueEncoder] = None) -> str:
    """Map of records -> wire JSON string (crdt_json.dart:8-17)."""
    return compact_dumps({
        (dart_str(key) if key_encoder is None else key_encoder(key)):
            record.to_json(key, value_encoder=value_encoder)
        for key, record in record_map.items()
    })


def decode(json_str: str, canonical_time: Hlc,
           key_decoder: Optional[KeyDecoder] = None,
           value_decoder: Optional[ValueDecoder] = None,
           node_id_decoder: Optional[NodeIdDecoder] = None,
           now_millis: Optional[int] = None) -> Dict[Any, Record]:
    """Wire JSON -> map of records, re-stamping ``modified`` with
    ``max(canonical, now)`` (crdt_json.dart:19-37).

    ``now_millis`` makes the wall-clock read injectable for tests.
    """
    now = Hlc.now(canonical_time.node_id, millis=now_millis)
    modified = canonical_time if canonical_time >= now else now
    return {
        (key if key_decoder is None else key_decoder(key)):
            Record.from_json(key, value, modified,
                             value_decoder=value_decoder,
                             node_id_decoder=node_id_decoder)
        for key, value in json.loads(json_str).items()
    }


def _check_lane_millis(millis: int) -> None:
    """Refuse millis the int64 lane packing can't hold, with the JAX
    package's message (numpy's generic OverflowError on assignment says
    nothing about the remedy)."""
    if not -0x8000_0000_0000 <= millis <= 0x7FFF_FFFF_FFFF:
        raise OverflowError(
            "HLC millis outside the int64 lane range (|millis| "
            ">= 2^47); use the scalar MapCrdt for such timestamps")


def decode_columns(json_str: str,
                   key_decoder: Optional[KeyDecoder] = None,
                   value_decoder: Optional[ValueDecoder] = None,
                   node_id_decoder: Optional[NodeIdDecoder] = None):
    """Wire JSON -> columnar ``(keys, lt, node_ids, values)``: ``lt`` an
    int64 array of packed logical times, the rest lists aligned with
    it. Semantics match :func:`decode` minus the ``modified`` stamp,
    which is the merging store's concern (winners are re-stamped with
    the post-absorption canonical, crdt.dart:86-87). A repeated wire key
    keeps its first position and its last record, as the JSON object's
    dict does; ``value_decoder`` sees the raw wire key."""
    items = list(json.loads(json_str).items())
    hlc_strs = [v["hlc"] for _, v in items]
    lt = np.empty(len(items), np.int64)
    nodes = [None] * len(items)
    for i, s in enumerate(hlc_strs):
        h = Hlc.parse(s)
        _check_lane_millis(h.millis)
        lt[i] = (h.millis << SHIFT) + h.counter
        nodes[i] = h.node_id
    if node_id_decoder is not None:
        nodes = [node_id_decoder(n) for n in nodes]
    keys = ([k for k, _ in items] if key_decoder is None
            else [key_decoder(k) for k, _ in items])
    if value_decoder is None:
        values = [v.get("value") for _, v in items]
    else:
        values = [None if (raw_v := v.get("value")) is None
                  else value_decoder(k, raw_v) for k, v in items]
    return keys, lt, nodes, values


class CrdtJson:
    """Namespace mirroring the reference's static class (crdt_json.dart:5)."""

    encode = staticmethod(encode)
    decode = staticmethod(decode)
