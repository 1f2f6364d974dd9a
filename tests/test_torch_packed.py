"""The port's packed and JSON merge paths against the JAX package's,
bit for bit (integer lanes and wire bytes: tolerance 0).

The same writes go to a source replica in each package and the same
deltas to a receiver in each (``crdt_tpu.DenseCrdt`` with
``executor="pallas-interpret"``, ``crdt_tpu_torch.DenseCrdt`` on the
CPU), each with its own `FakeClock`. Deltas cross packages as wire
bytes: one package's `pack_rows` frame is what the other package's
`unpack_rows` reads. After every merge the receivers agree on lanes,
canonical clock, node table, watch events and stats; refusals raise the
same exception with the same message and leave both replicas as they
were. Routes: a delta of fewer than n_slots / 4 rows takes the sparse
k-row join, a larger one the wide N-slot join.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crdt_tpu_torch as port
from crdt_tpu import DenseCrdt as JaxDenseCrdt
from crdt_tpu import crdt_json as jax_json
from crdt_tpu import native as jax_native
from crdt_tpu.hlc import Hlc as JaxHlc
from crdt_tpu.ops import dense as jd
from crdt_tpu.ops import packing as jp
from crdt_tpu.record import Record as JaxRecord
from crdt_tpu.testing import FakeClock, assert_dense_stores_equal
from crdt_tpu_torch import crdt_json as port_json
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import packing as tp
from torch_threads import cap_torch_threads

cap_torch_threads()

N = 4096
START = 1_700_000_000_000
ROUTES = {"sparse": 300, "wide": 1500}     # delta rows; wide: k * 4 >= N


class Pair:
    """One replica in each package, driven in lockstep."""

    def __init__(self, node_id, start=START, step=1, n=N, **kw):
        self.jax = JaxDenseCrdt(node_id, n, executor="pallas-interpret",
                                wall_clock=FakeClock(start, step), **kw)
        self.port = port.DenseCrdt(node_id, n, device="cpu",
                                   wall_clock=FakeClock(start, step), **kw)
        self.events = [c.watch().record() for c in (self.jax, self.port)]

    def each(self, fn):
        return fn(self.jax), fn(self.port)

    def check(self, where):
        assert_dense_stores_equal(self.jax.store, self.port.store, where)
        assert str(self.jax.canonical_time) == str(self.port.canonical_time)
        assert self.jax._table.ids() == self.port._table.ids()
        assert self.jax._wall_clock.millis == self.port._wall_clock.millis
        assert self.events[0].events == self.events[1].events, where
        for f in ("merges", "records_seen", "records_adopted"):
            assert getattr(self.jax.stats, f) == getattr(self.port.stats, f)

    def snapshot(self):
        return [np.asarray(x).copy() for x in self.port.store], \
            str(self.port.canonical_time), str(self.jax.canonical_time)


def source_and_receiver(rows):
    """A source that wrote ``rows`` rows and a receiver that wrote
    overlapping slots: its first batch is older than the source's
    writes, its last newer, so some delta rows win and some lose. The
    source's id sorts before the receiver's, so interning it shifts the
    receiver's stored ordinals."""
    rng = np.random.default_rng(rows)
    src = Pair("a0", step=7)
    rcv = Pair("r1", start=START + 10)
    slots = rng.choice(N, rows, replace=False)
    with src.jax.ingest(), src.port.ingest():
        for part in np.array_split(slots, 3):
            vals = rng.integers(-2 ** 40, 2 ** 40, len(part))
            src.each(lambda c: c.put_batch(part, vals))
        src.each(lambda c: c.delete_batch(slots[::9]))
    for part in np.array_split(rng.choice(N, 900, replace=False), 3):
        rcv.each(lambda c: c.put_batch(part, np.full(len(part), 5)))
    src.check("source")
    rcv.check("receiver")
    return src, rcv


def wire(pack_rows, delta):
    meta, bufs = pack_rows(delta)
    return meta, b"".join(bytes(b) for b in bufs)


def crossed_packs(src, since=None):
    """Each package's `pack_since` as wire bytes, asserted equal."""
    (jpk, jids), (ppk, pids) = (src.jax.pack_since(since),
                                src.port.pack_since(since and port_hlc(since)))
    assert jids == pids
    jmeta, jblob = wire(jp.pack_rows, jpk)
    pmeta, pblob = wire(tp.pack_rows, ppk)
    assert jmeta == pmeta and jblob == pblob
    return (jmeta, jblob), pids


def port_hlc(h):
    return port.Hlc(h.millis, h.counter, h.node_id)


@pytest.mark.parametrize("route", ROUTES)
def test_packed_delta_crosses_packages_both_ways(route):
    """A JAX `pack_since` framed by JAX's `pack_rows` merges into the
    port, and the port's frame into JAX; then the reverse round."""
    src, rcv = source_and_receiver(ROUTES[route])
    (meta, blob), ids = crossed_packs(src)
    # JAX's bytes into the port, the port's (equal) bytes into JAX.
    rcv.port.merge_packed(tp.unpack_rows(meta, blob), ids)
    rcv.jax.merge_packed(jp.unpack_rows(meta, blob), ids)
    rcv.check(f"{route}: after merge_packed")
    assert rcv.port.stats.records_adopted > 0
    assert rcv.port.stats.records_adopted < ROUTES[route]
    # And back: the receiver's delta since the source's clock.
    since = src.jax.canonical_time
    (meta, blob), ids = crossed_packs(rcv, since)
    src.port.merge_packed(tp.unpack_rows(meta, blob), ids)
    src.jax.merge_packed(jp.unpack_rows(meta, blob), ids)
    src.check(f"{route}: source after the reply")


@pytest.mark.parametrize("route", ROUTES)
def test_merge_json_of_the_other_package(route):
    src, rcv = source_and_receiver(ROUTES[route])
    jwire, pwire = src.jax.to_json(), src.port.to_json()
    assert jwire == pwire
    rcv.port.merge_json(jwire)
    rcv.jax.merge_json(pwire)
    rcv.check(f"{route}: after merge_json")


@pytest.mark.parametrize("route", ROUTES)
def test_merge_records(route):
    src, rcv = source_and_receiver(ROUTES[route])
    jrm, prm = src.jax.record_map(), src.port.record_map()
    assert list(jrm) == list(prm)
    rcv.jax.merge_records(jrm)
    rcv.port.merge_records(prm)
    rcv.check(f"{route}: after merge_records")


@pytest.mark.parametrize("route", ROUTES)
def test_merge_and_repack_equals_merge_then_pack(route):
    """The relay's pack equals `merge_packed` and then `pack_since` on a
    twin, in both packages, and seeds the cache: the next
    `pack_since(since)` returns the very pack the relay returned."""
    src, rcv = source_and_receiver(ROUTES[route])
    _, twin = source_and_receiver(ROUTES[route])
    since = rcv.jax.canonical_time
    (meta, blob), ids = crossed_packs(src)
    relayed = [rcv.jax.merge_and_repack(jp.unpack_rows(meta, blob), ids,
                                        since),
               rcv.port.merge_and_repack(tp.unpack_rows(meta, blob), ids,
                                         port_hlc(since))]
    twin.jax.merge_packed(jp.unpack_rows(meta, blob), ids)
    twin.port.merge_packed(tp.unpack_rows(meta, blob), ids)
    rcv.check(f"{route}: relay")
    twin.check(f"{route}: twin")
    assert_dense_stores_equal(rcv.port.store, twin.port.store, "relay/twin")
    (tmeta, tblob), tids = crossed_packs(twin, since)
    for pack_rows, (pk, pids) in zip((jp.pack_rows, tp.pack_rows),
                                     relayed):
        assert pids == tids
        assert wire(pack_rows, pk) == (tmeta, tblob)
    assert rcv.jax.pack_since(since) is relayed[0]
    assert rcv.port.pack_since(port_hlc(since)) is relayed[1]
    rcv.check(f"{route}: after the cache hit")


def packed_lanes(rng, k, n_ids):
    return dict(
        slots=rng.choice(N, k, replace=False).astype(np.int32),
        lt=((START + 50 + rng.integers(0, 40, k)) << 16)
        + rng.integers(0, 3, k),
        node=rng.integers(0, n_ids, k).astype(np.int32),
        val=rng.integers(-2 ** 40, 2 ** 40, k),
        tomb=(rng.random(k) < 0.3).astype(np.uint8))


def jax_records(rng, k, slots=None):
    slots = rng.choice(N, k, replace=False) if slots is None else slots
    return {int(s): JaxRecord(
        JaxHlc(START + 60 + i, i % 3, f"w{i % 4}"),
        None if i % 5 == 0 else int(v), JaxHlc(START, 0, "x"))
        for i, (s, v) in enumerate(zip(slots, rng.integers(0, 99, k)))}


def port_records(records):
    return {k: port.Record(port.Hlc(r.hlc.millis, r.hlc.counter,
                                    r.hlc.node_id), r.value,
                           port.Hlc(r.modified.millis, r.modified.counter,
                                    r.modified.node_id))
            for k, r in records.items()}


def json_of(records):
    return json.dumps({str(k): {"hlc": str(r.hlc), "value": r.value}
                       for k, r in records.items()})


def refusal_cases():
    """(name, replica kwargs, op) where op(crdt, package) refuses."""
    rng = np.random.default_rng(40)
    ok = packed_lanes(rng, 40, 2)
    ids = ["w1", "w2", "w0"]        # ordinal 2: the receiver's own id

    def packed(**over):
        lanes = {**ok, **over}

        def op(crdt, pkg):
            cls = jp.PackedDelta if pkg == "jax" else tp.PackedDelta
            crdt.merge_packed(cls(**lanes), ids)
        return op

    def as_json(doc):
        return lambda crdt, pkg: crdt.merge_json(json.dumps(doc))

    recs = jax_records(rng, 6)
    hlc = str(next(iter(recs.values())).hlc)
    canonical_ms = START + 5   # the receivers wrote at START+1..+4
    return [
        ("ragged lanes", {}, packed(val=ok["val"][:-1])),
        ("ordinal out of range", {}, packed(
            node=np.r_[ok["node"][:-1], 3].astype(np.int32))),
        ("negative ordinal", {}, packed(
            node=np.r_[-1, ok["node"][1:]].astype(np.int32))),
        ("slot out of range", {}, packed(
            slots=np.r_[ok["slots"][:-1], N].astype(np.int32))),
        ("value width", {"value_width": 32}, packed()),
        ("duplicate node", {}, packed(
            node=np.full(40, 2, np.int32),
            lt=np.full(40, (canonical_ms + 500) << 16, np.int64))),
        ("drift", {}, packed(
            lt=np.r_[ok["lt"][:5], (START + 200_000) << 16,
                     ok["lt"][6:]].astype(np.int64))),
        ("json slot out of range", {}, as_json({"-3": {"hlc": hlc,
                                                       "value": 1}})),
        ("json non-int value", {}, as_json({"7": {"hlc": hlc, "value": 1},
                                            "8": {"hlc": hlc,
                                                  "value": "x"}})),
        ("json bool value", {}, as_json({"9": {"hlc": hlc,
                                               "value": True}})),
        ("json float value", {}, as_json({"9": {"hlc": hlc,
                                                "value": 1.5}})),
        ("json value width", {"value_width": 32},
         as_json({"9": {"hlc": hlc, "value": 2 ** 40}})),
        ("records non-int value", {},
         lambda crdt, pkg: crdt.merge_records(
             {**(recs if pkg == "jax" else port_records(recs)),
              11: (JaxRecord if pkg == "jax" else port.Record)(
                  (JaxHlc if pkg == "jax" else port.Hlc)(START + 70, 0,
                                                          "w1"),
                  2.5, (JaxHlc if pkg == "jax" else port.Hlc)(START, 0,
                                                              "x"))})),
    ]


REFUSALS = refusal_cases()


@pytest.mark.parametrize("name,kw,op", REFUSALS,
                         ids=[c[0] for c in REFUSALS])
def test_refusals_match_and_leave_the_replica_untouched(name, kw, op):
    p = Pair("w0", **kw)
    p.each(lambda c: c.put_batch([1, 2, 3], [10, 20, 30]))
    p.each(lambda c: c.delete_batch([2]))
    before = p.snapshot()
    errs = []
    for crdt, pkg in ((p.jax, "jax"), (p.port, "port")):
        with pytest.raises(Exception) as info:
            op(crdt, pkg)
        errs.append(info.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__, name
    assert str(errs[0]) == str(errs[1]), name
    p.check(f"after {name}")
    after = p.snapshot()
    for a, b in zip(before[0], after[0]):
        np.testing.assert_array_equal(a, b)
    if name not in ("duplicate node", "drift"):
        # The guards roll the clock to just before the offender, as the
        # sequential merge does; every other refusal leaves it.
        assert before[1:] == after[1:], name


def dup_json(recs, slot_keys):
    """Wire JSON whose keys repeat a slot: the literal key twice, or
    another spelling of the same int."""
    items = [f'"{key}":{json.dumps({"hlc": str(r.hlc), "value": r.value})}'
             for key, r in zip(slot_keys, recs.values())]
    return "{" + ",".join(items) + "}"


DUPLICATES = {
    "json literal key": lambda recs: ("json", dup_json(
        recs, ["5", "6", "5", "7", "6"])),
    "json spellings": lambda recs: ("json", dup_json(
        recs, ["5", "05", "6", "+6", "5"])),
    "records": lambda recs: ("records", dict(zip(
        [5, 5.5, 6, 6.25, 7], recs.values()))),
    "packed": lambda recs: ("packed", None),
}


@pytest.mark.parametrize("case", DUPLICATES)
def test_duplicate_slots_collapse_last_wins(case):
    rng = np.random.default_rng(41)
    recs = jax_records(rng, 5, slots=np.arange(100, 105))
    kind, payload = DUPLICATES[case](recs)
    p = Pair("w9")
    if kind == "json":
        p.each(lambda c: c.merge_json(payload))
    elif kind == "records":
        p.jax.merge_records(payload)
        p.port.merge_records(port_records(payload))
    else:
        lanes = packed_lanes(rng, 6, 2)
        lanes["slots"] = np.array([9, 4, 9, 8, 4, 9], np.int32)
        p.jax.merge_packed(jp.PackedDelta(**lanes), ["w0", "w1"])
        p.port.merge_packed(tp.PackedDelta(**lanes), ["w0", "w1"])
        last = {int(s): i for i, s in enumerate(lanes["slots"])}
        for s, i in last.items():
            assert p.port.get(s) == (None if lanes["tomb"][i]
                                     else int(lanes["val"][i]))
    p.check(f"{case}: duplicates collapsed")
    assert p.port.stats.records_seen == len(set(p.port.record_map()))


EMPTY = {
    "packed": lambda c, pkg: c.merge_packed(
        (jp if pkg == "jax" else tp).PackedDelta(
            *(np.zeros(0, d) for d in jp.PACKED_LANE_DTYPES)), []),
    "json": lambda c, pkg: c.merge_json("{}"),
    "records": lambda c, pkg: c.merge_records({}),
    "relay": lambda c, pkg: c.merge_and_repack(
        (jp if pkg == "jax" else tp).PackedDelta(
            *(np.zeros(0, d) for d in jp.PACKED_LANE_DTYPES)), []),
}


@pytest.mark.parametrize("case", EMPTY)
def test_empty_delta_ticks_the_clock_like_jax(case):
    """An empty delta still spends the absorption wall read and the
    final send bump (merge_json one more: the decode's read)."""
    p = Pair("w3")
    p.each(lambda c: c.put_batch([1], [1]))
    before = p.jax._wall_clock.millis
    EMPTY[case](p.jax, "jax")
    EMPTY[case](p.port, "port")
    p.check(f"empty {case}")
    assert p.port._wall_clock.millis - before == (3 if case == "json" else 2)


def _one_row(node=0):
    return tp.PackedDelta(slots=np.array([7], np.int32),
                          lt=np.array([(START + 9) << 16], np.int64),
                          node=np.array([node], np.int32),
                          val=np.array([5], np.int64),
                          tomb=np.array([0], np.uint8))


SHARDED_REFUSALS = {
    "merge_packed": lambda c: c.merge_packed(_one_row(node=3), ["w1"]),
    "merge_json": lambda c: c.merge_json(json.dumps({"7": {
        "hlc": str(port.Hlc(START + 9, 0, "w1")), "value": "x"}})),
    "merge_records": lambda c: c.merge_records({7: port.Record(
        port.Hlc(START + 9, 0, "w1"), 2.5, port.Hlc(START, 0, "w1"))}),
    "merge_and_repack": lambda c: c.merge_and_repack(
        _one_row(), ["w1"], None, sem_mode="typed"),
}


@pytest.mark.parametrize("op", ["merge_packed", "merge_json",
                                "merge_records", "merge_and_repack"])
def test_sharded_model_refuses_until_ported(op):
    """Ported now (ROADMAP A3b): the sharded model refuses what the
    unsharded one refuses, with the same exception and message, and is
    left as it was."""
    mesh = port.parallel.make_fanin_mesh(1, 2, ["cpu"] * 2)
    crdts = (port.DenseCrdt("n0", 1024, device="cpu",
                            wall_clock=FakeClock()),
             port.ShardedDenseCrdt("n0", 1024, mesh, wall_clock=FakeClock()))
    errs = []
    for crdt in crdts:
        crdt.put_batch([1, 7], [10, 70])
        with pytest.raises(Exception) as info:
            SHARDED_REFUSALS[op](crdt)
        errs.append((type(info.value).__name__, str(info.value)))
    assert errs[0] == errs[1]
    assert_dense_stores_equal(crdts[0].store, crdts[1].store, op)
    assert crdts[0].canonical_time == crdts[1].canonical_time
    assert crdts[1].get(7) == 70


# --- the wire functions and the ops, against the JAX package's -------


def test_pack_rows_frames_equal_bytes_and_views():
    rng = np.random.default_rng(42)
    lanes = packed_lanes(rng, 33, 4)
    base = tp.PackedDelta._fields[:5]       # without the optional sem lane
    arena = tp.pack_into_arena(*(lanes[f] for f in base))
    meta, bufs = tp.pack_rows(arena)
    jmeta, jbufs = jp.pack_rows(jp.PackedDelta(**lanes))
    assert meta == jmeta
    assert [bytes(b) for b in bufs] == [bytes(b) for b in jbufs]
    # An arena lane is framed as a view of its own storage.
    assert all(np.shares_memory(np.frombuffer(b, np.uint8), lane)
               for b, lane in zip(bufs, arena))
    # A foreign lane (wrong dtype) is copied into its wire dtype.
    loose = tp.PackedDelta(lanes["slots"].astype(np.int64), lanes["lt"],
                           lanes["node"], lanes["val"],
                           lanes["tomb"].astype(bool))
    assert wire(tp.pack_rows, loose) == wire(jp.pack_rows,
                                             jp.PackedDelta(**lanes))
    back = tp.unpack_rows(meta, b"".join(bytes(b) for b in bufs))
    for f in base:
        assert getattr(back, f).dtype == getattr(arena, f).dtype
        np.testing.assert_array_equal(getattr(back, f), getattr(arena, f))
    assert back.sem is None
    # The sem lane, an int8 tag column cast into the arena: JAX's bytes.
    sem = rng.integers(0, 5, 33).astype(np.int8)
    typed = tp.pack_into_arena(*(lanes[f] for f in base), sem=sem)
    assert wire(tp.pack_rows, typed) == wire(
        jp.pack_rows, jp.PackedDelta(**lanes, sem=sem.astype(np.uint8)))
    assert all(np.shares_memory(np.frombuffer(b, np.uint8), lane)
               for b, lane in zip(tp.pack_rows(typed)[1], typed))


def bad_frames():
    rng = np.random.default_rng(43)
    meta, blob = wire(jp.pack_rows, jp.PackedDelta(**packed_lanes(rng, 5, 2)))

    def lanes_with(i, entry):
        m = json.loads(json.dumps(meta))
        m["lanes"][i] = entry
        return m, blob

    return {
        "not packed": ({"form": "dense"}, blob),
        "fields": lanes_with(1, ["when", "int64", [5]]),
        "dtype": lanes_with(2, ["node", "int64", [5]]),
        "shape": lanes_with(3, ["val", "int64", [5, 1]]),
        "ragged": lanes_with(4, ["tomb", "uint8", [4]]),
        "size": (meta, blob + b"\0"),
        "empty ok": ({"form": "packed", "lanes": [
            [f, d, [0]] for f, d in zip(tp.PackedDelta._fields,
                                        jp.PACKED_LANE_DTYPES)]}, b""),
    }


BAD_FRAMES = bad_frames()


@pytest.mark.parametrize("case", BAD_FRAMES)
def test_unpack_rows_refuses_like_jax(case):
    meta, blob = BAD_FRAMES[case]
    outcomes = []
    for unpack in (jp.unpack_rows, tp.unpack_rows):
        try:
            outcomes.append(("ok", [a.tobytes()
                                    for a in unpack(meta, blob)[:5]]))
        except ValueError as e:
            outcomes.append(("ValueError", str(e)))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1][0] == "ok") == (case == "empty ok")


def test_sem_lane_waits_for_typed_slots():
    """The sem lane (typed slots, since the semantics port): a frame with
    it unpacks to the same lanes in both packages and packs to the same
    bytes; an all-LWW store takes a delta whose tags are all LWW as
    JAX's does, refuses a typed tag before it touches the clock, and
    attaches no sem lane under any valid mode."""
    rng = np.random.default_rng(44)
    lanes = packed_lanes(rng, 4, 1)
    typed = jp.PackedDelta(**lanes, sem=np.zeros(4, np.uint8))
    meta, blob = wire(jp.pack_rows, typed)
    got = tp.unpack_rows(meta, blob)
    assert [a.tobytes() for a in got] == \
        [a.tobytes() for a in jp.unpack_rows(meta, blob)]
    assert wire(tp.pack_rows, got) == (meta, blob)
    p = Pair("n0")
    p.each(lambda c: c.merge_packed(typed, ["w0"]))
    p.check("all-LWW tags merged")
    bad = typed._replace(sem=np.array([0, 0, 3, 0], np.uint8))
    before = p.snapshot()
    errs = []
    for c in (p.jax, p.port):
        with pytest.raises(ValueError, match="semantics tag mismatch") as e:
            c.merge_packed(bad, ["w0"])
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    after = p.snapshot()
    assert all(np.array_equal(x, y) for x, y in zip(before[0], after[0]))
    assert before[1:] == after[1:]
    # An all-LWW store attaches no sem lane under any valid mode.
    crdt = p.port
    assert crdt.pack_since(sem_mode="include", ranges=((0, N),))[0].sem \
        is None
    assert len(tp.pack_rows(crdt.pack_since(sem_mode="include")[0])[1]) \
        == 5


def test_pack_hlcs_and_unpack_hlc_match_jax():
    ids = ["b", "a-1", "c"]
    jt, pt = jp.NodeTable(ids), tp.NodeTable(ids)
    hlcs = [JaxHlc(START + i, i, ids[i % 3]) for i in range(7)]
    jl, jn = jp.pack_hlcs(hlcs, jt)
    pl, pn = tp.pack_hlcs([port.Hlc(h.millis, h.counter, h.node_id)
                           for h in hlcs], pt)
    np.testing.assert_array_equal(jl, pl)
    np.testing.assert_array_equal(jn, pn)
    assert jl.dtype == pl.dtype and jn.dtype == pn.dtype
    for lt, n in zip(pl, pn):
        assert str(tp.unpack_hlc(lt, n, pt)) == str(jp.unpack_hlc(lt, n, jt))


def json_cases():
    rng = np.random.default_rng(45)
    recs = jax_records(rng, 12)
    base = json_of(recs)
    return {
        "plain": (base, {}),
        "literal duplicate keys": (dup_json(recs, ["1", "2", "1", "3", "2",
                                                   "4", "1"]), {}),
        "dashed node ids": (json.dumps({"3": {
            "hlc": "2023-11-14T22:13:20.005Z-00A1-node-with-dashes",
            "value": 4}}), {}),
        "lowercase counter": (json.dumps({"3": {
            "hlc": "2023-11-14T22:13:20.005Z-00a1-n", "value": None}}), {}),
        "value and key decoders": (base, dict(
            key_decoder=lambda k: int(k) * 2,
            value_decoder=lambda k, v: f"{k}:{v}")),
        "node id decoder": (base, dict(node_id_decoder=str.upper)),
        "empty": ("{}", {}),
    }


JSON_CASES = json_cases()


@pytest.mark.parametrize("c_codec", [True, False])
@pytest.mark.parametrize("case", JSON_CASES)
def test_decode_columns_matches_jax_either_branch(case, c_codec,
                                                  monkeypatch):
    """The port's pure-Python decode against JAX's, with JAX's C codec
    (where this host builds it) and without it."""
    s, kw = JSON_CASES[case]
    if not c_codec:
        monkeypatch.setattr(jax_native, "load", lambda: None)
    jk, jl, jn, jv = jax_json.decode_columns(s, **kw)
    pk, pl, pn, pv = port_json.decode_columns(s, **kw)
    assert jk == pk and jn == pn and jv == pv
    assert jl.dtype == pl.dtype and jl.tobytes() == pl.tobytes()


def test_decode_columns_refuses_millis_outside_the_lane():
    s = json.dumps({"1": {"hlc": "9000-01-01T00:00:00.000Z-0000-n",
                          "value": 1}})
    for decode in (jax_json.decode_columns, port_json.decode_columns):
        with pytest.raises(OverflowError, match="int64 lane range"):
            decode(s)


def ops_inputs(rng, k):
    occ = rng.random(N) < 0.5
    store = dict(
        lt=np.where(occ, (START << 16) + rng.integers(0, 64, N), 0),
        node=np.where(occ, rng.integers(0, 4, N), 0).astype(np.int32),
        val=rng.integers(-2 ** 40, 2 ** 40, N),
        mod_lt=np.where(occ, (START << 16) + 99, 0),
        mod_node=np.where(occ, 1, 0).astype(np.int32), occupied=occ,
        tomb=occ & (rng.random(N) < 0.3))
    padded = 1 << max(k - 1, 1).bit_length()
    slot = np.full(padded, N, np.int64)
    slot[:k] = rng.choice(N, k, replace=False)
    rows = dict(slot=slot, lt=(START << 16) + rng.integers(0, 64, padded),
                node=rng.integers(0, 4, padded).astype(np.int32),
                val=rng.integers(-2 ** 40, 2 ** 40, padded),
                tomb=rng.random(padded) < 0.3,
                valid=np.arange(padded) < k)
    return store, rows


@pytest.mark.parametrize("k", [1, 37, 1000])
def test_sparse_and_repack_steps_match_jax(k):
    store, rows = ops_inputs(np.random.default_rng(k), k)
    jstore = jd.DenseStore(**{f: jnp.asarray(v) for f, v in store.items()})
    jrows = [jnp.asarray(rows[f]) for f in ("slot", "lt", "node", "val",
                                            "tomb", "valid")]
    jrows[0] = jrows[0].astype(jnp.int32)
    stamp = (START << 16) + 500
    jnew, jwin, jmask = jd.merge_repack_step(
        jstore, *jrows, jnp.int64(stamp), jnp.int32(2), jnp.int64(stamp))
    pstore = td.store_from_numpy(store)
    prows = [torch.tensor(rows[f]) for f in ("slot", "lt", "node", "val",
                                             "tomb", "valid")]
    out, pwin, pmask = td.merge_repack_step(pstore, *prows, stamp, 2, stamp)
    assert out is pstore                              # in place
    for f in td.DenseStore._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jnew, f)),
                                      getattr(out, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jwin), pwin.numpy())
    np.testing.assert_array_equal(np.asarray(jmask), pmask.numpy())
    # The plain sparse step: the same lanes and win mask.
    sstore = td.store_from_numpy(store)
    _, swin = td.sparse_fanin_step(sstore, *prows, stamp, 2)
    np.testing.assert_array_equal(swin.numpy(), pwin.numpy())
    for a, b in zip(sstore, out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_wire_join_step_matches_jax(seed):
    rng = np.random.default_rng(50 + seed)
    store, _ = ops_inputs(rng, 1)
    lanes = dict(lt=(START << 16) + rng.integers(0, 64, N),
                 node=rng.integers(0, 4, N).astype(np.int16),
                 val=rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32),
                 tomb=rng.random(N) < 0.3, valid=rng.random(N) < 0.6)
    stamp = (START << 16) + 700
    jnew, jwin = jd.wire_join_step(
        jd.DenseStore(**{f: jnp.asarray(v) for f, v in store.items()}),
        *(jnp.asarray(lanes[f]) for f in ("lt", "node", "val", "tomb",
                                          "valid")),
        jnp.int64(stamp), jnp.int32(1))
    pstore = td.store_from_numpy(store)
    out, pwin = td.wire_join_step(
        pstore, *(torch.tensor(lanes[f]) for f in ("lt", "node", "val",
                                                   "tomb", "valid")),
        stamp, 1)
    assert out is pstore
    for f in td.DenseStore._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jnew, f)),
                                      getattr(out, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jwin), pwin.numpy())
