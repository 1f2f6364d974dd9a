"""SQLite-backed persistent CRDT — the out-of-tree plugin pattern,
in-tree.

Port of ``crdt_tpu/models/sqlite_crdt.py``: host code only, the same
schema and the same JSON text in the ``value`` column, so a database
file either package wrote opens in the other.

The reference documents persistent backends as `Crdt` subclasses built
outside the package (README.md:39 points at hive_crdt; the abstract
storage slots at crdt.dart:140-169 are the plugin contract, and the
`modified` field exists precisely so such backends can answer delta
queries, CHANGELOG.md:14-15). This module is that pattern realized on
Python's stdlib `sqlite3`: a durable replica that speaks the same wire
format, runs the same conformance suite, and can sync with any other
backend (`MapCrdt`, `TpuMapCrdt`, `DenseCrdt`) or an external JSON
peer.

Storage model — one table, one row per record:

- ``hlc``/``modified`` persist through the reference string codec
  (hlc.dart:102-104), so a row is meaningful to any replica.
- ``lt``/``modified_lt`` are the packed 64-bit logicalTimes
  (hlc.dart:16) as INTEGER columns: ``refresh_canonical_time`` is
  ``MAX(lt)`` (the efficient override the reference invites,
  crdt.dart:113) and the inclusive delta bound (map_crdt.dart:44-45)
  is an indexed ``modified_lt >= ?`` scan.
- ``value`` is JSON text; SQL ``NULL`` is the tombstone
  (record.dart:17). Custom value types plug in via
  ``value_encoder``/``value_decoder`` (record.dart:3-9 typedefs).

Resume-from-disk is the constructor: opening an existing database file
seeds the canonical clock from the stored max (crdt.dart:31-33).
"""

from __future__ import annotations

import json
import sqlite3
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

from ..crdt import Crdt
from ..hlc import Hlc
from ..record import Record
from ..utils.stats import MergeStats
from ..watch import ChangeHub, ChangeStream

K = TypeVar("K")
V = TypeVar("V")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS records (
    key TEXT PRIMARY KEY,
    hlc TEXT NOT NULL,
    lt INTEGER NOT NULL,
    value TEXT,
    modified TEXT NOT NULL,
    modified_lt INTEGER NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_records_modified_lt
    ON records (modified_lt);
"""


class SqliteCrdt(Crdt[K, V], Generic[K, V]):
    """A durable LWW-map CRDT on a SQLite database.

    ``path=":memory:"`` (the default) is an ephemeral store useful for
    tests; a filesystem path makes the replica survive restarts —
    reconstructing is just ``SqliteCrdt(node_id, path)`` again.

    Like the reference's single-isolate model, a replica instance is
    single-threaded (sqlite3's default ``check_same_thread`` guard is
    left on); cross-thread consumption happens through the watch
    streams (`watch().aiter()` marshals onto the consumer's loop).
    """

    def __init__(self, node_id: Any, path: str = ":memory:", *,
                 wall_clock: Optional[Callable[[], int]] = None,
                 key_encoder: Optional[Callable[[K], str]] = None,
                 key_decoder: Optional[Callable[[str], K]] = None,
                 value_encoder: Optional[Callable[[V], Any]] = None,
                 value_decoder: Optional[Callable[[Any], V]] = None,
                 node_decoder: Optional[Callable[[str], Any]] = None,
                 check_same_thread: bool = True):
        self._node_id = node_id
        # check_same_thread=False is required to serve this replica
        # from another thread (e.g. `net.SyncServer`); the
        # single-threaded-replica contract still applies — ALL access
        # must be externally serialized (the server's lock does this).
        self._conn = sqlite3.connect(
            path, check_same_thread=check_same_thread)
        # WAL + NORMAL: writers don't block readers and a commit costs
        # one WAL append instead of a full journal round trip. Power
        # loss can drop the tail of the WAL but never corrupts — a
        # replica restarting after a crash just re-syncs the lost tail
        # (merge is idempotent; that recovery story is the whole point
        # of the CRDT). No-op on :memory: databases.
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.executescript(_SCHEMA)
        self._key_enc = key_encoder or str
        self._key_dec = key_decoder or (lambda s: s)
        self._val_enc = value_encoder or (lambda v: v)
        self._val_dec = value_decoder or (lambda v: v)
        # HLC node ids persist as text; without a decoder a non-str
        # node_id would parse back as str and break tie-break compares
        # and duplicate-node detection against the typed canonical
        # clock. Default to the node_id's own type (int("7") etc.);
        # exotic types must pass node_decoder explicitly.
        if node_decoder is None and not isinstance(node_id, str):
            node_decoder = type(node_id)
        self._node_dec = node_decoder
        self._hub = ChangeHub()
        self.stats = MergeStats().register(backend="SqliteCrdt",
                                           node=str(node_id))
        super().__init__(wall_clock=wall_clock)

    @property
    def node_id(self) -> Any:
        return self._node_id

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "SqliteCrdt[K, V]":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- codecs ---

    def _encode_row(self, key: K, record: Record[V]):
        value = (None if record.value is None
                 else json.dumps(self._val_enc(record.value)))
        return (self._key_enc(key), str(record.hlc),
                record.hlc.logical_time, value, str(record.modified),
                record.modified.logical_time)

    def _decode_row(self, row) -> Record[V]:
        _, hlc, _, value, modified, _ = row
        return Record(
            Hlc.parse(hlc, id_decoder=self._node_dec),
            None if value is None else self._val_dec(json.loads(value)),
            Hlc.parse(modified, id_decoder=self._node_dec))

    # --- efficient clock rebuild (crdt.dart:113: "should be overridden
    # if the implementation can do it more efficiently") ---

    def refresh_canonical_time(self) -> None:
        (max_lt,) = self._conn.execute(
            "SELECT COALESCE(MAX(lt), 0) FROM records").fetchone()
        self._canonical_time = Hlc.from_logical_time(max_lt, self._node_id)

    # --- storage primitives (crdt.dart:140-169) ---

    def contains_key(self, key: K) -> bool:
        return self._conn.execute(
            "SELECT 1 FROM records WHERE key = ?",
            (self._key_enc(key),)).fetchone() is not None

    def get_record(self, key: K) -> Optional[Record[V]]:
        row = self._conn.execute(
            "SELECT * FROM records WHERE key = ?",
            (self._key_enc(key),)).fetchone()
        return None if row is None else self._decode_row(row)

    # Upsert (NOT "INSERT OR REPLACE", which deletes + reinserts and so
    # reassigns the rowid): existing keys keep their rowid, making
    # `ORDER BY rowid` the dict-like first-insertion iteration order —
    # wire bytes match the in-memory backends op-for-op.
    _UPSERT = (
        "INSERT INTO records VALUES (?, ?, ?, ?, ?, ?) "
        "ON CONFLICT(key) DO UPDATE SET hlc=excluded.hlc, "
        "lt=excluded.lt, value=excluded.value, "
        "modified=excluded.modified, modified_lt=excluded.modified_lt")

    def put_record(self, key: K, record: Record[V]) -> None:
        with self._conn:
            self._conn.execute(self._UPSERT, self._encode_row(key, record))
        self._hub.add(key, record.value)

    def put_records(self, record_map: Dict[K, Record[V]]) -> None:
        with self._conn:
            self._conn.executemany(
                self._UPSERT,
                [self._encode_row(k, r) for k, r in record_map.items()])
        for key, record in record_map.items():
            self._hub.add(key, record.value)

    def merge_json(self, json_str: str,
                   key_decoder=None, value_decoder=None) -> None:
        """Columnar wire ingest: C batch HLC parse → vectorized recv
        guards + LWW against a keyed O(delta) lookup → ONE
        executemany upsert in ONE transaction. No `Record`/`Hlc`
        objects on the hot path (crdt.dart:100-109 surface at
        numpy+SQL speed). Rows are record-equivalent to the generic
        path: identical canonical hlc/modified strings and lt columns;
        the value column's JSON text is compact/raw-UTF-8 here vs
        json.dumps defaults there — both parse to the same value
        (pinned by the path differential test).

        Falls back to the generic object path when the native codec is
        unavailable — semantics are identical either way, and the
        wall-clock tick count matches the generic path in both
        branches (the `_decode_wall_millis` accounting contract)."""
        from .. import crdt_json, native
        codec = native.load()
        if codec is None:
            return super().merge_json(json_str,
                                      key_decoder=key_decoder,
                                      value_decoder=value_decoder)
        self._decode_wall_millis()
        keys, lt, nodes, values, hlc_strs = crdt_json.decode_columns(
            json_str, key_decoder=key_decoder,
            value_decoder=value_decoder,
            node_id_decoder=self._node_dec,
            with_hlc_strs=True)
        if not keys:
            self.merge({})
            return
        self._merge_columns(keys, lt, nodes, values, hlc_strs,
                            self._wall_clock())

    def _merge_columns(self, keys, lt, nodes, values, hlc_strs,
                       wall: int) -> None:
        from ..utils.stats import merge_annotation
        with merge_annotation("crdt_tpu_torch.sqlite_merge",
                              hlc=lambda: self._canonical_time):
            self._merge_columns_impl(keys, lt, nodes, values,
                                     hlc_strs, wall)

    def _merge_columns_impl(self, keys, lt, nodes, values, hlc_strs,
                            wall: int) -> None:
        import numpy as np

        from ..hlc import (MAX_COUNTER, SHIFT, ClockDriftException,
                           DuplicateNodeException)
        from ..utils.host_guards import recv_fold_columns

        # --- stage 1: recv fold + guards in payload visit order
        # (the shared host fold, utils/host_guards.py).
        local_mask = np.fromiter((n == self._node_id for n in nodes),
                                 bool, count=len(nodes))
        fold = recv_fold_columns(lt, local_mask,
                                 self._canonical_time.logical_time, wall)
        if fold.bad_index is not None:
            self._canonical_time = Hlc.from_logical_time(
                fold.canonical_at_fail, self._node_id)
            if fold.bad_is_dup:
                raise DuplicateNodeException(str(self._node_id))
            raise ClockDriftException(
                int(lt[fold.bad_index]) >> SHIFT, wall)
        new_canonical = fold.new_canonical

        # --- stage 2: LWW vs the local rows, O(delta) keyed lookup.
        kenc = self._key_enc
        # Wire keys are already str; the default encoder (str) is then
        # an identity pass worth skipping at 1M-key scale.
        enc_keys = (keys if kenc is str
                    and all(type(k) is str for k in keys)
                    else [kenc(k) for k in keys])
        local: Dict[str, tuple] = {}
        # Cold sync into an empty replica (first contact) skips the
        # keyed probes entirely — one EXISTS beats N/500 IN-queries.
        if self._conn.execute(
                "SELECT EXISTS(SELECT 1 FROM records)").fetchone()[0]:
            for row in self._rows_for_keys(enc_keys, "key, lt, hlc"):
                local[row[0]] = (row[1], row[2])
        win = np.ones(len(keys), bool)
        if local:   # all-new-key merges skip the compare entirely
            get = local.get
            for i, ek in enumerate(enc_keys):
                loc = get(ek)
                if loc is None:
                    continue
                l_lt = loc[0]
                r_lt = int(lt[i])
                if r_lt < l_lt:
                    win[i] = False
                elif r_lt == l_lt:
                    # logicalTime tie: node id breaks it, typed compare
                    # (hlc.dart:158-161); local wins the exact tie.
                    l_node = self._parse_node(loc[1])
                    if self._node_dec is not None:
                        l_node = self._node_dec(l_node)
                    win[i] = nodes[i] > l_node

        # --- stage 3: one-transaction columnar upsert of the winners.
        widx = np.nonzero(win)[0]
        self.stats.merges += 1
        self.stats.add_seen_lazy(len(keys))
        self.stats.add_adopted_lazy(int(widx.size))
        if widx.size:
            import itertools

            from .. import native
            codec = native.load()
            all_win = widx.size == len(keys)
            win_list = widx.tolist()
            w_lt = lt if all_win else lt[widx]
            w_keys = enc_keys if all_win else [enc_keys[i]
                                              for i in win_list]
            w_nodes = (nodes if all_win
                       else [nodes[i] for i in win_list])
            w_vals = (values if all_win
                      else [values[i] for i in win_list])
            w_hlcs = (hlc_strs if all_win
                      else [hlc_strs[i] for i in win_list])
            if None in w_hlcs:
                # Items without a certified raw wire string (escaped /
                # non-canonical / out-of-window shapes): re-derive via
                # the batch formatter, then the slow formatter for
                # whatever IT defers.
                w_ms = (w_lt >> SHIFT).tolist()
                w_ctr = (w_lt & MAX_COUNTER).tolist()
                fmt = codec.format_hlc_batch(
                    w_ms, w_ctr,
                    [n if type(n) is str else str(n) for n in w_nodes])
                w_hlcs = [h if h is not None
                          else (f if f is not None
                                else str(Hlc._raw(m, c, n)))
                          for h, f, m, c, n in zip(w_hlcs, fmt, w_ms,
                                                   w_ctr, w_nodes)]
            mod = Hlc.from_logical_time(new_canonical, self._node_id)
            mod_str, mod_lt = str(mod), mod.logical_time
            # C batch value JSON (compact text; the generic path's
            # default-separator dumps parses identically) — per-value
            # json.dumps was the single largest ingest cost.
            enc = self._val_enc
            texts = codec.dump_values(
                [None if v is None else enc(v) for v in w_vals],
                json.dumps)
            rows = zip(w_keys, w_hlcs, w_lt.tolist(),
                       (None if v is None else t
                        for v, t in zip(w_vals, texts)),
                       itertools.repeat(mod_str),
                       itertools.repeat(mod_lt))
            with self._conn:
                self._conn.executemany(self._UPSERT, rows)
            if self._hub.active:
                # Batch emission (hub.add_batch contract): keyed
                # streams answered from a lazily-built winner dict,
                # never a per-record hub.add loop.
                win_map = None

                def get(k):
                    nonlocal win_map
                    if win_map is None:
                        win_map = {keys[i]: values[i] for i in win_list}
                    if k in win_map:
                        return True, win_map[k]
                    return False, None

                if all_win:
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

    @staticmethod
    def _parse_node(hlc_str: str):
        """Node id from a stored hlc string — the reference scan
        (first dash after the last colon ends the ISO time, the next
        ends the counter, hlc.dart:40-44); typed via Hlc.parse's
        decoder contract is not needed here because tie-breaks compare
        against the already-typed wire node."""
        counter_dash = hlc_str.index("-", hlc_str.rfind(":"))
        return hlc_str[hlc_str.index("-", counter_dash + 1) + 1:]

    def _rows_for_keys(self, encoded_keys, columns: str = "*"):
        """Yield the stored rows for the given ENCODED keys, batched
        under SQLite's host-parameter cap — the one keyed O(delta)
        lookup shared by the merge paths."""
        for i in range(0, len(encoded_keys), 500):
            batch = encoded_keys[i:i + 500]
            yield from self._conn.execute(
                f"SELECT {columns} FROM records WHERE key IN "
                f"({','.join('?' * len(batch))})", batch)

    def _local_records_for(self, keys) -> Dict[K, Record[V]]:
        # Keyed lookup so delta merges are O(delta) rows, not a full
        # table scan+parse (the whole point of a beyond-memory store).
        return {self._key_dec(row[0]): self._decode_row(row)
                for row in self._rows_for_keys(
                    [self._key_enc(k) for k in keys])}

    def record_map(self, modified_since: Optional[Hlc] = None
                   ) -> Dict[K, Record[V]]:
        if modified_since is None:
            # No WHERE clause: a `>= 0` default would silently drop rows
            # whose modified HLC has pre-epoch (negative) millis —
            # reachable via the public put_record primitive, where the
            # reference recordMap() returns all records.
            rows = self._conn.execute(
                "SELECT * FROM records ORDER BY rowid")
        else:
            rows = self._conn.execute(
                "SELECT * FROM records WHERE modified_lt >= ? "
                "ORDER BY rowid", (modified_since.logical_time,))
        return {self._key_dec(row[0]): self._decode_row(row)
                for row in rows}

    def count_modified_since(self, modified_since: Optional[Hlc] = None
                             ) -> int:
        """Delta-backlog size straight off the ``modified_lt`` index —
        lag monitoring never parses a row."""
        if modified_since is None:
            # Same no-WHERE rationale as record_map: pre-epoch rows
            # must count.
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM records").fetchone()
        else:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM records WHERE modified_lt >= ?",
                (modified_since.logical_time,)).fetchone()
        return n

    def watch(self, key: Optional[K] = None) -> ChangeStream:
        return self._hub.stream(key)

    def purge(self) -> None:
        with self._conn:
            self._conn.execute("DELETE FROM records")
