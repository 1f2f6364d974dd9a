"""JSON wire codec (L3) — the replica-boundary format.

Port of ``crdt_tpu/crdt_json.py``: the pure-Python path, and the C
codec (`crdt_tpu_torch.native`) as an accelerator of the same bytes
where it loaded, as the JAX package wires it. Matches the reference `lib/src/crdt_json.dart:1-38`
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

from . import native
from .hlc import MAX_COUNTER, SHIFT, Hlc
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
    codec = native.load()
    if codec is not None and record_map:
        # Batch-format the HLC strings natively. None entries defer to
        # the Python formatter per record: out-of-window years (which
        # raise there) and non-UTF-8 node ids (which serialize fine).
        recs = list(record_map.values())
        hlcs = codec.format_hlc_batch(
            [r.hlc.millis for r in recs], [r.hlc.counter for r in recs],
            [str(r.hlc.node_id) for r in recs])
        # Keys/values are computed ONCE and shared with the dict
        # fallback below — user encoders must not be double-called
        # when format_wire defers (surrogates, key collisions).
        keys = ([dart_str(k) for k in record_map]
                if key_encoder is None
                else [key_encoder(k) for k in record_map])
        values = ([r.value for r in recs] if value_encoder is None
                  else [value_encoder(k, r.value)
                        for k, r in zip(record_map, recs)])
        if None not in hlcs and len(set(keys)) == len(keys):
            # One-pass C assembly, byte-identical to the json.dumps of
            # the dict below (scalar values serialize in C; containers
            # and custom objects go through `compact_dumps`). Colliding
            # stringified keys must collapse dict-style, so those use
            # the dict build instead.
            out = codec.format_wire(keys, hlcs, values, compact_dumps)
            if out is not None:
                return out
        obj = {}
        for k, record, hlc_str, v in zip(keys, recs, hlcs, values):
            obj[k] = {
                "hlc": record.hlc.to_json() if hlc_str is None else hlc_str,
                "value": v,
            }
    else:
        obj = {
            (dart_str(key) if key_encoder is None else key_encoder(key)):
                record.to_json(key, value_encoder=value_encoder)
            for key, record in record_map.items()
        }
    return compact_dumps(obj)


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
    codec = native.load()
    if codec is not None and node_id_decoder is None:
        scanned = codec.parse_wire(json_str)
        if scanned is not None:
            keys, lt_buf, nodes, values, bad = scanned
            lt = np.frombuffer(lt_buf, np.int64)
            raw_hlc = Hlc._raw
            out = {}
            bad_set = set(bad)
            for i, key in enumerate(keys):
                if i in bad_set:
                    h = Hlc.parse(nodes[i])
                else:
                    ltv = int(lt[i])
                    h = raw_hlc(ltv >> SHIFT, ltv & MAX_COUNTER, nodes[i])
                v = values[i]
                if value_decoder is not None and v is not None:
                    v = value_decoder(key, v)
                out[key if key_decoder is None else key_decoder(key)] = \
                    Record(h, v, modified)
            return out
    raw = json.loads(json_str)
    if codec is not None and node_id_decoder is None and raw:
        # Batch-parse the canonical-shape HLC strings natively; None
        # entries (non-canonical shapes) fall back to the full Python
        # parser per item.
        items = list(raw.items())
        millis_l, counter_l, node_l = codec.parse_hlc_batch(
            [v["hlc"] for _, v in items])
        out = {}
        for (key, value), ms, counter, node in zip(items, millis_l,
                                                   counter_l, node_l):
            if ms is None:
                record = Record.from_json(key, value, modified,
                                          value_decoder=value_decoder)
            else:
                raw_v = value.get("value")
                decoded = (raw_v if value_decoder is None or raw_v is None
                           else value_decoder(key, raw_v))
                record = Record(Hlc(ms, counter, node), decoded, modified)
            out[key if key_decoder is None else key_decoder(key)] = record
        return out
    return {
        (key if key_decoder is None else key_decoder(key)):
            Record.from_json(key, value, modified,
                             value_decoder=value_decoder,
                             node_id_decoder=node_id_decoder)
        for key, value in raw.items()
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
                   node_id_decoder: Optional[NodeIdDecoder] = None,
                   with_hlc_strs: bool = False):
    """Wire JSON -> columnar ``(keys, lt, node_ids, values)``: ``lt`` an
    int64 array of packed logical times, the rest lists aligned with
    it. Semantics match :func:`decode` minus the ``modified`` stamp,
    which is the merging store's concern (winners are re-stamped with
    the post-absorption canonical, crdt.dart:86-87). A repeated wire key
    keeps its first position and its last record, as the JSON object's
    dict does; ``value_decoder`` sees the raw wire key. The C codec's
    one-pass scan serves the canonical wire shape; anything it does
    not model exactly takes ``json.loads``.

    ``with_hlc_strs`` appends a fifth column: each record's canonical
    wire hlc string (byte-equal to what ``str(hlc)`` re-derives), or
    None where only a normalizing parse was possible; a backend that
    stores hlc strings (`SqliteCrdt`) re-formats only the None ones."""
    codec = native.load()
    if codec is not None:
        scanned = codec.parse_wire(json_str, with_hlc_strs)
        if scanned is not None:
            if with_hlc_strs:
                keys, lt_buf, nodes, values, bad, hlc_strs = scanned
            else:
                keys, lt_buf, nodes, values, bad = scanned
            # bytearray buffer -> writable int64 view, zero copies
            lt = np.frombuffer(lt_buf, np.int64)
            for i in bad:
                h = Hlc.parse(nodes[i])
                _check_lane_millis(h.millis)
                lt[i] = (h.millis << SHIFT) + h.counter
                nodes[i] = h.node_id
            if node_id_decoder is not None:
                nodes = [node_id_decoder(n) for n in nodes]
            if value_decoder is not None:
                # the decoder sees the RAW wire key, as below
                values = [None if v is None else value_decoder(k, v)
                          for k, v in zip(keys, values)]
            if key_decoder is not None:
                keys = [key_decoder(k) for k in keys]
            if with_hlc_strs:
                return keys, lt, nodes, values, hlc_strs
            return keys, lt, nodes, values
    items = list(json.loads(json_str).items())
    m = len(items)
    hlc_strs = [v["hlc"] for _, v in items]
    millis_l = counter_l = node_l = None
    if codec is not None and m:
        millis_l, counter_l, node_l = codec.parse_hlc_batch(hlc_strs)
    if millis_l is not None and None not in millis_l:
        ms_arr = np.array(millis_l, np.int64)
        # (millis << 16) would wrap int64 outside the lane range.
        _check_lane_millis(int(ms_arr.max()))
        _check_lane_millis(int(ms_arr.min()))
        lt = (ms_arr << SHIFT) + np.array(counter_l, np.int64)
        nodes = node_l
    else:
        # Item by item for non-canonical shapes (or no C codec).
        lt = np.empty(m, np.int64)
        nodes = [None] * m
        for i, hs in enumerate(hlc_strs):
            if millis_l is not None and millis_l[i] is not None:
                ms, c, n = millis_l[i], counter_l[i], node_l[i]
            else:
                h = Hlc.parse(hs)
                ms, c, n = h.millis, h.counter, h.node_id
            _check_lane_millis(ms)
            lt[i] = (ms << SHIFT) + c
            nodes[i] = n
    if node_id_decoder is not None:
        nodes = [node_id_decoder(n) for n in nodes]
    keys = ([k for k, _ in items] if key_decoder is None
            else [key_decoder(k) for k, _ in items])
    if value_decoder is None:
        values = [v.get("value") for _, v in items]
    else:
        values = [None if (raw_v := v.get("value")) is None
                  else value_decoder(k, raw_v) for k, v in items]
    if with_hlc_strs:
        # Raw strings only where the batch parser certified the
        # canonical shape and the counter hex is uppercase (raw == what
        # str(hlc)'s %04X re-derives); None asks the caller to format.
        out_strs = [s if millis_l is not None and millis_l[i] is not None
                    and s[25:29] == s[25:29].upper() else None
                    for i, s in enumerate(hlc_strs)]
        return keys, lt, nodes, values, out_strs
    return keys, lt, nodes, values


class CrdtJson:
    """Namespace mirroring the reference's static class (crdt_json.dart:5)."""

    encode = staticmethod(encode)
    decode = staticmethod(decode)
