"""The port's `SqliteCrdt` against the JAX package's, on the CPU:

- one op script (puts, batches, deletes, clears, record and JSON
  merges) on each package's replica, with the C codec and without it:
  the table's rows byte for byte, the clock, record maps, `to_json`
  bytes, the watch events and the delta counts;
- a database file that each package writes and the other opens: the
  same rows, the clock restored from ``MAX(lt)``, the same wire bytes;
- the guard refusals (type, message, clock at the failure), typed node
  ids, custom key and value codecs, canonical hlc strings from a
  lowercase wire counter;
- a `sync_json` round between a `SqliteCrdt` and a `TpuMapCrdt` in
  each package;
- the port's conformance kit (`crdt_tpu_torch.testing`) on
  `SqliteCrdt`.

Tolerance 0 throughout.
"""

import importlib
import json

import pytest

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu.testing import FakeClock as JaxClock
from crdt_tpu_torch.testing import CrdtConformance, FakeClock

from test_torch_tpu_map import (BASE, PKGS, native_off, op_script, rec,
                                replay, wire_json)
from torch_threads import cap_torch_threads

cap_torch_threads()

jax_sync = importlib.import_module("crdt_tpu.sync")
port_sync = importlib.import_module("crdt_tpu_torch.sync")


def lite(pkg, path=":memory:", node_id="abc", start=BASE, **kw):
    clock = (JaxClock if pkg == "jax" else FakeClock)(start)
    return PKGS[pkg].SqliteCrdt(node_id, path, wall_clock=clock, **kw)


def rows(c):
    return c._conn.execute("SELECT * FROM records ORDER BY rowid").fetchall()


def state(c):
    return (rows(c), str(c.canonical_time),
            [(k, str(r.hlc), r.value, str(r.modified))
             for k, r in c.record_map().items()], c.to_json())


@pytest.mark.parametrize("codec", ["c", "python"])
@pytest.mark.parametrize("seed", [0, 1])
def test_op_script_matches_jax(seed, codec, monkeypatch):
    if codec == "python":
        native_off(monkeypatch)
    ops = op_script(seed + 20, n_ops=60)
    out = []
    for pkg in ("jax", "port"):
        c = lite(pkg)
        seen = []
        c.watch().listen(lambda e: seen.append((e.key, e.value)))
        replay(pkg, c, ops)
        out.append((state(c), seen,
                    c.count_modified_since(c.canonical_time),
                    c.to_json(modified_since=c.canonical_time)))
    assert out[0] == out[1]


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_database_file_crosses_packages(writer, reader, tmp_path):
    ops = op_script(5, n_ops=50)
    db = str(tmp_path / "replica.db")
    with lite(writer, db) as w:
        replay(writer, w, ops)
        written = state(w)
    with lite(reader, db) as r:
        opened = state(r)
        # The clock is restored from MAX(lt) on open.
        (max_lt,) = r._conn.execute(
            "SELECT COALESCE(MAX(lt), 0) FROM records").fetchone()
        assert r.canonical_time.logical_time == max_lt
        r.put("after", 1)
        r.merge_json(wire_json(reader, {"z": (BASE + 50, 1, "peer", 2)}))
        again = state(r)
    with lite(writer, db) as w2:
        back = state(w2)
        assert (back[0], back[2], back[3]) == (again[0], again[2], again[3])
    assert opened[0] == written[0] and opened[2:] == written[2:]


@pytest.mark.parametrize("codec", ["c", "python"])
@pytest.mark.parametrize("case", ["dup", "drift", "json_drift"])
def test_guard_refusals_match_jax(case, codec, monkeypatch):
    if codec == "python":
        native_off(monkeypatch)
    out = []
    for pkg in ("jax", "port"):
        c = lite(pkg)
        c.put_all({"a": 1, "b": 2})
        ahead = BASE + 1000
        with pytest.raises(Exception) as info:
            if case == "dup":
                c.merge({"x": rec(pkg, ahead, 0, "n1", 1),
                         "y": rec(pkg, ahead + 5, 0, "abc", 2)})
            elif case == "drift":
                c.merge({"x": rec(pkg, ahead, 1, "n1", 1),
                         "y": rec(pkg, BASE + 120_000, 0, "n2", 2)})
            else:
                c.merge_json(wire_json(pkg, {
                    "x": (ahead, 0, "n1", 1),
                    "y": (BASE + 200_000, 0, "n2", 2)}))
        out.append((type(info.value).__name__, str(info.value), state(c)))
    assert out[0] == out[1]


def test_typed_node_ids_and_codecs_match_jax(tmp_path):
    out = []
    for pkg in ("jax", "port"):
        db = str(tmp_path / f"{pkg}.db")
        m = PKGS[pkg]
        with lite(pkg, db, node_id=7) as a:
            a.put("x", 1)
        with lite(pkg, db, node_id=7) as b:
            h = b.get_record("x").hlc
            assert h.node_id == 7
            b.merge({"x": m.Record(m.Hlc(h.millis, h.counter, 9), 99,
                                   m.Hlc(h.millis, h.counter, 9))})
            typed = state(b)
        c = lite(pkg, key_encoder=lambda k: f"{k[0]}:{k[1]}",
                 key_decoder=lambda s: tuple(int(v) for v in s.split(":")),
                 value_encoder=lambda v: {"p": list(v)},
                 value_decoder=lambda d: tuple(d["p"]))
        c.put_all({(1, 2): (3, 4), (5, 6): (7, 8)})
        c.delete((1, 2))
        out.append((typed, rows(c),
                    sorted((k, r.value) for k, r in c.record_map().items())))
    assert out[0] == out[1]


def test_lowercase_wire_counter_is_stored_canonical_like_jax():
    wire = ('{"a":{"hlc":"2023-05-06T07:08:09.123Z-00ab-peer",'
            '"value":1},"b":{"hlc":"2023-05-06T07:08:09.124Z-0001-peer",'
            '"value":[1,"é"]}}')
    out = []
    for pkg in ("jax", "port"):
        c = lite(pkg, start=1_683_356_889_000)
        c.merge_json(wire)
        out.append(state(c))
    assert out[0] == out[1]
    assert out[1][0][0][1] == "2023-05-06T07:08:09.123Z-00AB-peer"


def test_sync_json_with_tpu_map_matches_jax():
    ops = op_script(9, n_ops=40)
    out = []
    for pkg, sync_mod in (("jax", jax_sync), ("port", port_sync)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        clock = (JaxClock if pkg == "jax" else FakeClock)(BASE + 3)
        tpu = PKGS[pkg].TpuMapCrdt("tpu", wall_clock=clock, **kw)
        db = lite(pkg, node_id="lite")
        replay(pkg, tpu, ops[:20])
        replay(pkg, db, ops[20:])
        mark = sync_mod.sync_json(db, tpu, since=None)
        out.append((str(mark), state(db)[1:], tpu.to_json(),
                    str(tpu.canonical_time)))
        assert json.loads(db.to_json()) == json.loads(tpu.to_json())
    assert out[0] == out[1]


class TestPortSqliteConformance(CrdtConformance):
    def make_crdt(self):
        return port.SqliteCrdt("abc", wall_clock=FakeClock())


def test_kit_clocks_match_jax():
    """The kit's clocks count and tick alike in both packages."""
    from crdt_tpu import testing as jt
    from crdt_tpu_torch import testing as pt
    a, b = jt.CountingClock(5, 3), pt.CountingClock(5, 3)
    assert [a() for _ in range(4)] == [b() for _ in range(4)]
    a.advance(10)
    b.advance(10)
    assert (a(), a.reads, a.millis) == (b(), b.reads, b.millis)
    assert crdt_tpu.SqliteCrdt._UPSERT == port.SqliteCrdt._UPSERT
