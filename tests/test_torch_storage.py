"""The rest of the model surface (ROADMAP A3b) and the storage plane (A4:
tombstone GC, the resurrection fence, compaction) against the JAX
package's, bit for bit (integer lanes, slot translations and digest
trees: tolerance 0), on both models.

Every scenario runs the same operations on a JAX replica and on the
port's (`DenseCrdt` on the CPU; `ShardedDenseCrdt` on a mesh of ``"cpu"``
devices against JAX's on virtual CPU devices, ``executor="xla"``), each
with its own `FakeClock`, and holds lanes, clock, node table, counts,
translations and trees equal, with every replica copy of a sharded
store equal. The GC scenarios follow ``tests/test_storage_gc.py``
(:71-108, :169-218, :244-320, :347-380; none of its socket tests).
Overlapping compaction spans, which the JAX package sums into one
target (losing records), raise ``ValueError`` in the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crdt_tpu_torch as port
from crdt_tpu import DenseCrdt as JaxDense
from crdt_tpu.hlc import Hlc as JaxHlc
from crdt_tpu.models.dense_crdt import ShardedDenseCrdt as JaxSharded
from crdt_tpu.record import Record as JaxRecord
from crdt_tpu.testing import FakeClock, assert_dense_stores_equal
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td

from test_torch_sharded import assert_copies_equal, changeset_of, meshes
from torch_threads import cap_torch_threads

cap_torch_threads()

BASE = 1_700_000_000_000
N = 64
MODELS = ["dense", "sharded"]


class Pair:
    """A JAX replica and the port's, unsharded or on a mesh, driven in
    lockstep."""

    def __init__(self, model, node="n", n=N, start=BASE, shape=(2, 2)):
        self.model = model
        clocks = (FakeClock(start=start), FakeClock(start=start))
        if model == "dense":
            self.jax = JaxDense(node, n, wall_clock=clocks[0])
            self.port = port.DenseCrdt(node, n, device="cpu",
                                       wall_clock=clocks[1])
        else:
            jmesh, tmesh = meshes(shape)
            self.jax = JaxSharded(node, n, jmesh, wall_clock=clocks[0],
                                  executor="xla")
            self.port = port.ShardedDenseCrdt(node, n, tmesh,
                                              wall_clock=clocks[1])
        self.events = [c.watch().record() for c in (self.jax, self.port)]

    def each(self, fn):
        return fn(self.jax), fn(self.port)

    def same(self, fn):
        a, b = self.each(fn)
        assert a == b, (a, b)
        return b

    def check(self, where, full=True):
        """Lanes (every slot with ``full``, else the occupied ones), clock,
        table, watch events, stats; every replica copy equal."""
        js, ps = self.jax.store, self.port.store
        if full:
            for lane in td.DenseStore._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(js, lane)),
                    getattr(ps, lane).numpy(), err_msg=f"{where}: {lane}")
        else:
            assert_dense_stores_equal(js, ps, where)
        assert str(self.jax.canonical_time) == str(self.port.canonical_time)
        assert self.jax._table.ids() == self.port._table.ids()
        assert self.events[0].events == self.events[1].events, where
        for f in ("merges", "puts", "records_put", "records_seen",
                  "records_adopted"):
            assert getattr(self.jax.stats, f) == \
                getattr(self.port.stats, f), f
        assert self.jax.gc_floor == self.port.gc_floor
        if self.model == "sharded":
            assert_copies_equal(self.port._store, where)


def port_hlc(h):
    return port.Hlc(h.millis, h.counter, h.node_id)


def hlc_of(crdt, h):
    return port_hlc(h) if isinstance(crdt, port.DenseCrdt) else h


def records(pkg_is_port, rows):
    rec, hlc = (port.Record, port.Hlc) if pkg_is_port else (JaxRecord,
                                                           JaxHlc)
    return {slot: rec(hlc(*h), v, hlc(*m)) for slot, h, v, m in rows}


# --- A3b: the model surface ----------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_a3b_surface_matches_jax(model):
    p = Pair(model)
    p.each(lambda c: c.put_batch([1, 2, 3, 40], [10, -20, 30, 2 ** 62]))
    p.each(lambda c: c.delete_batch([2]))
    since = p.jax.canonical_time
    p.same(lambda c: (len(c), np.asarray(c.live_mask).tolist()))
    p.same(lambda c: (c.count_modified_since(None),
                      c.count_modified_since(hlc_of(c, since))))
    # Staged ingest rows count without a flush (slot 2's delete is AT
    # the watermark: the bound is inclusive).
    counts = []
    for c in (p.jax, p.port):
        with c.ingest() as wc:
            c.put_batch([50, 1], [5, 6])
            c.delete_batch([51])
            counts.append((c.count_modified_since(hlc_of(c, since)),
                           c.count_modified_since(None), wc.pending_rows))
    assert counts[0] == counts[1] == (4, 6, 3)
    p.check("after the counts")
    # Raw records: foreign writers, verbatim stamps, a tombstone.
    rows = [(7, (BASE - 5, 3, "w9"), 70, (BASE - 4, 0, "a0")),
            (41, (BASE + 900, 0, "b1"), None, (BASE + 901, 2, "b1")),
            (1, (BASE - 9, 0, "n"), -1, (BASE - 9, 0, "n"))]
    p.jax.put_slot_records(records(False, rows))
    p.port.put_slot_records(records(True, rows))
    p.port.put_slot_records({})
    p.check("after put_slot_records")
    p.same(lambda c: [str(x) for x in (lambda r: (r.hlc, r.value,
                                                  r.modified))(
        c.get_slot_record(41))])
    p.same(lambda c: (c.get(7), c.get(1), c.is_deleted(41)))
    p.each(lambda c: c.clear())
    p.check("after clear")
    p.same(len)
    p.each(lambda c: c.put_batch([9], [99]))
    p.each(lambda c: c.clear(purge=True))
    p.check("after clear(purge=True)")
    p.same(lambda c: (len(c), c.count_modified_since(None)))
    p.each(lambda c: c.put_batch([9, 10], [1, 2]))
    p.each(lambda c: c.purge())
    p.each(lambda c: c.put_batch([11], [3]))
    p.check("after purge")


@pytest.mark.parametrize("model", MODELS)
def test_put_slot_records_refusals_match_jax(model):
    p = Pair(model)
    cases = [{70: ((BASE, 0, "x"), 1, (BASE, 0, "x"))},
             {3: ((BASE, 0, "x"), 1.5, (BASE, 0, "x"))},
             {3: ((BASE, 0, "x"), True, (BASE, 0, "x"))}]
    for case in cases:
        rows = [(s, *r) for s, r in case.items()]
        errs = []
        for c, is_port in ((p.jax, False), (p.port, True)):
            with pytest.raises(Exception) as info:
                c.put_slot_records(records(is_port, rows))
            errs.append((type(info.value).__name__, str(info.value)))
        assert errs[0] == errs[1]
    p.check("untouched")


def delta_source(rows, n=N, seed=0):
    """A JAX source replica whose pack holds ``rows`` rows over ``n``
    slots: old and new stamps against the receivers, tombstones."""
    rng = np.random.default_rng(seed)
    src = JaxDense("a0", n, wall_clock=FakeClock(start=BASE + 3, step=2))
    slots = rng.choice(n, rows, replace=False)
    src.put_batch(slots, rng.integers(-2 ** 40, 2 ** 40, rows))
    src.delete_batch(slots[::5])
    return src


@pytest.mark.parametrize("rows", [6, 40])        # sparse; wide: 40 * 4 >= 64
def test_sharded_columnar_merges_match_jax_and_unsharded(rows):
    """The sharded model's merge_packed, merge_json, merge_records and
    merge_and_repack against JAX's sharded model and the port's
    unsharded one: each route (sparse, wide) joins shard by shard."""
    p = Pair("sharded", node="r1")
    flat = port.DenseCrdt("r1", N, device="cpu",
                          wall_clock=FakeClock(start=BASE))
    rng = np.random.default_rng(rows)
    mine = rng.choice(N, 20, replace=False)
    for c in (p.jax, p.port, flat):
        c.put_batch(mine, np.arange(20))
    src = delta_source(rows)
    packed, ids = src.pack_since(None)
    since = p.jax.canonical_time
    for c in (p.jax, p.port, flat):
        c.merge_packed(packed, ids)
    p.check("merge_packed", full=False)
    assert_dense_stores_equal(p.jax.store, flat.store, "unsharded")
    src.put_batch([0, 63], [1, 2])
    wire = src.to_json()
    for c in (p.jax, p.port, flat):
        c.merge_json(wire)
    recs = {5: JaxRecord(JaxHlc(BASE + 500, 0, "z"), 55,
                         JaxHlc(BASE + 500, 0, "z"))}
    p.jax.merge_records(recs)
    for c in (p.port, flat):
        c.merge_records({5: port.Record(port.Hlc(BASE + 500, 0, "z"), 55,
                                        port.Hlc(BASE + 500, 0, "z"))})
    p.check("merge_json, merge_records", full=False)
    src.put_batch(rng.choice(N, rows, replace=False), np.arange(rows))
    packed, ids = src.pack_since(None)
    outs = [c.merge_and_repack(packed, ids, hlc_of(c, since))
            for c in (p.jax, p.port, flat)]
    for out in outs[1:]:
        assert out[1] == outs[0][1]
        for f in ("slots", "lt", "node", "val", "tomb"):
            assert np.asarray(getattr(out[0], f)).tobytes() == \
                np.asarray(getattr(outs[0][0], f)).tobytes(), f
    assert p.port.pack_since(port_hlc(since))[0] is outs[1][0]
    p.check("merge_and_repack", full=False)
    assert_dense_stores_equal(p.jax.store, flat.store, "unsharded")
    assert p.port.to_json() == flat.to_json() == p.jax.to_json()


# --- GC: the purge and the fence -------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_gc_purge_drops_only_stable_tombstones(model):
    p = Pair(model)
    p.each(lambda c: c.put_batch([1, 2, 3, 33], [10, 20, 30, 330]))
    p.each(lambda c: c.delete_batch([1, 2, 33]))
    obs_device.reset()
    p.same(lambda c: c.gc_purge(c.canonical_time, drift_slack_ms=0))
    assert obs_device.op_launches()["gc_purge"] == (
        1 if model == "dense" else 4)        # one a block on (2, 2)
    p.check("after gc_purge")
    assert p.port.get(3) == 30 and p.port.gc_floor > 0
    assert not p.port.store.occupied[[1, 2, 33]].any()
    # An unadvanced watermark: 0 purged and no op at all.
    obs_device.reset()
    p.same(lambda c: c.gc_purge(c.canonical_time, drift_slack_ms=0))
    assert obs_device.op_launches()["gc_purge"] == 0
    p.check("after the idle pass")


def test_gc_purge_floor_is_inclusive_and_slack_holds():
    p = Pair("dense")
    p.each(lambda c: c.put_batch([7, 4], [70, 40]))
    p.each(lambda c: c.delete_batch([7]))
    head = p.port.canonical_time
    assert int(p.port.store.lt[7]) == head.logical_time
    # A generous slack puts the floor below the stamp: nothing purged.
    p.same(lambda c: c.gc_purge(c.canonical_time, drift_slack_ms=1 << 20))
    p.same(lambda c: c.gc_purge(c.canonical_time))   # hlc.MAX_DRIFT
    assert bool(p.port.store.tomb[7])
    p.same(lambda c: c.gc_purge(c.canonical_time, drift_slack_ms=0))
    p.check("floor == stamp purges")
    errs = []
    for c in (p.jax, p.port):
        with pytest.raises(ValueError) as info:
            c.gc_purge(c.canonical_time, drift_slack_ms=-1)
        errs.append(str(info.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("route", ["packed", "changeset"])
@pytest.mark.parametrize("model", MODELS)
def test_stale_replay_is_fenced_first_deliveries_land(model, route):
    """A pre-delete delta held back and replayed after the purge is
    dropped on the purged slot (through the columnar path, and folded
    into ``valid`` before the kernel on ``merge``); a sub-floor row for
    a slot never purged is a first-time delivery and lands."""
    w = JaxDense("w", N, wall_clock=FakeClock(start=BASE))
    w.put_batch([5, 40], [55, 77])
    stale = w.pack_since(None)
    cs = w.export_delta()
    p = Pair(model, node="r", start=BASE + 1_000_000)
    if route == "packed":
        p.each(lambda c: c.merge_packed(*stale))
    else:
        p.each(lambda c: c.merge(changeset_of(c, cs[0]), cs[1]))
    p.each(lambda c: c.delete_batch([5, 40]))
    p.same(lambda c: c.gc_purge(c.canonical_time, drift_slack_ms=0))
    # Slot 9 was never purged; its row is older than the floor.
    w.put_batch([9], [99])
    stale = w.pack_since(None)
    cs = w.export_delta()
    if route == "packed":
        p.each(lambda c: c.merge_packed(*stale))
    else:
        p.each(lambda c: c.merge(changeset_of(c, cs[0]), cs[1]))
    p.check(f"after the replay ({route})")
    assert not p.port.store.occupied[[5, 40]].any()
    assert p.port.get(9) == 99


@pytest.mark.parametrize("model", MODELS)
def test_fence_emptying_a_delta_ticks_like_an_empty_merge(model):
    p = Pair(model, node="r", start=BASE + 1_000_000)
    w = JaxDense("w", N, wall_clock=FakeClock(start=BASE))
    w.put_batch([5], [55])
    stale = w.pack_since(None)
    p.each(lambda c: c.merge_packed(*stale))
    p.each(lambda c: c.delete_batch([5]))
    p.same(lambda c: c.gc_purge(c.canonical_time, drift_slack_ms=0))
    outs = p.each(lambda c: c.merge_and_repack(*stale))
    assert outs[0][0].k == outs[1][0].k
    p.check("after the fenced relay")
    assert p.jax._wall_clock.millis == p.port._wall_clock.millis


@pytest.mark.parametrize("model", MODELS)
def test_grow_pads_the_fence(model):
    """New slots were never purged: old rows land there after grow,
    while the purged slots stay fenced."""
    p = Pair(model, node="r", start=BASE + 1_000_000)
    w = JaxDense("w", 2 * N, wall_clock=FakeClock(start=BASE))
    w.put_batch([3, 70], [33, 77])
    p.each(lambda c: c.put_batch([3], [1]))
    p.each(lambda c: c.delete_batch([3]))
    p.same(lambda c: c.gc_purge(c.canonical_time, drift_slack_ms=0))
    p.each(lambda c: c.grow(2 * N))
    p.each(lambda c: c.merge_packed(*w.pack_since(None)))
    p.check("after grow and the replay")
    assert p.port.get(70) == 77 and p.port.get(3) is None
    if model == "sharded":
        errs = []
        for c in (p.jax, p.port):
            with pytest.raises(ValueError) as info:
                c.grow(2 * N + 1)
            errs.append(str(info.value))
        assert errs[0] == errs[1]


# --- compaction ------------------------------------------------------------


def churned(model, **kw):
    p = Pair(model, **kw)
    slots = list(range(0, 48))
    p.each(lambda c: c.put_batch(slots, [1000 + s for s in slots]))
    p.each(lambda c: c.delete_batch([s for s in slots if s % 4 == 0]))
    p.each(lambda c: c.put_batch([60, 62], [6, -6]))
    p.each(lambda c: c.delete_batch([62]))
    p.same(lambda c: c.gc_purge(c.canonical_time, drift_slack_ms=0))
    return p


def assert_tree_equal(a, b):
    assert a.depth == b.depth and a.root == b.root
    for la, lb in zip(a.levels, b.levels):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


@pytest.mark.parametrize("ranges", [None, ((0, 64),), ((0, 32),),
                                    ((8, 24), (40, 64)), ((1, 1), (50, 61)),
                                    ((3, 13), (13, 20)), ()])
@pytest.mark.parametrize("model", MODELS)
def test_compact_matches_jax(model, ranges):
    """Translation, lanes and the seeded tree equal JAX's; the seeded
    tree also equals a fresh `digest_tree` of the compacted store, and
    the fence retires."""
    p = churned(model)
    obs_device.reset()
    tr_j, tr_p = p.each(lambda c: c.compact(ranges))
    assert tr_p.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(tr_j), tr_p)
    assert obs_device.op_launches() == dict(
        dict.fromkeys(obs_device.OPS, 0), compact_remap=1)
    p.check("after compact")
    seeded = p.port.digest_tree()
    assert obs_device.op_launches()["digest_tree"] == 0
    assert_tree_equal(seeded, p.jax.digest_tree())
    p.port._digest_cache = None
    assert_tree_equal(seeded, p.port.digest_tree())
    assert p.port._gc_fence is None
    # Every live row kept its lanes at its new slot.
    for s in range(48):
        if tr_p[s] >= 0:
            assert p.port.get(int(tr_p[s])) == (None if s % 4 == 0
                                                else 1000 + s)


def test_overlapping_compact_spans_raise_where_jax_loses_records():
    """The JAX package sums a slot's targets over every span it lies in:
    with (0, 8) and (4, 12) slots 5 and 9 both go to 6, and a value is
    lost. The port refuses, and the replica is untouched."""
    p = Pair("dense")
    p.each(lambda c: c.put_batch([1, 3, 5, 7, 9], [10, 30, 50, 70, 90]))
    before = p.port.store
    with pytest.raises(ValueError, match="overlap"):
        p.port.compact(ranges=((0, 8), (4, 12)))
    with pytest.raises(ValueError, match="overlap"):
        p.port.compact(ranges=((4, 12), (0, 8), (20, 30)))
    for lane, was in zip(p.port.store, before):
        assert torch.equal(lane, was)
    tr = np.asarray(p.jax.compact(ranges=((0, 8), (4, 12))))
    assert int(tr[5]) == int(tr[9]) == 6
    values = {p.jax.get(s) for s in range(N)} - {None}
    assert len(values) == 4             # one of the five values is gone


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 1, 2)])
def test_sharded_digest_levels_equal_unsharded(shape):
    p = churned("sharded", shape=shape)
    flat = port.DenseCrdt("n", N, device="cpu", store=p.port.store,
                          node_ids=p.port._table.ids())
    obs_device.reset()
    tree = p.port.digest_tree()
    assert obs_device.op_launches()["digest_tree"] == 1
    assert_tree_equal(tree, flat.digest_tree())
    assert_tree_equal(tree, p.jax.digest_tree())


def test_sharded_digest_and_compact_fall_back_when_leaves_straddle():
    """A shard width that is no multiple of the leaf width (40 slots
    over 2 key shards: 20): the digest of the gathered store, and the
    gathered compaction, as the JAX sharded model falls back."""
    p = Pair("sharded", n=40, shape=(2, 2))
    p.each(lambda c: c.put_batch([1, 19, 20, 39], [1, 2, 3, 4]))
    p.each(lambda c: c.delete_batch([19]))
    p.same(lambda c: c.gc_purge(c.canonical_time, drift_slack_ms=0))
    assert_tree_equal(p.port.digest_tree(), p.jax.digest_tree())
    tr_j, tr_p = p.each(lambda c: c.compact())
    np.testing.assert_array_equal(np.asarray(tr_j), tr_p)
    p.check("after the gathered compaction")


@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2)])
def test_sharded_gc_and_compact_match_unsharded(shape):
    """test_storage_gc.py:347-380: sharded compaction packs each key
    shard to its own prefix, so its translation differs from the
    unsharded model's, but every live row survives with its lanes
    inside its own shard's span; and it equals JAX's sharded model."""
    p = Pair("sharded", node="ns", shape=shape)
    flat = port.DenseCrdt("ns", N, device="cpu",
                          wall_clock=FakeClock(start=BASE))
    for c in (p.jax, p.port, flat):
        c.put_batch([1, 9, 17, 33, 40], [10, 90, 170, 330, 400])
        c.delete_batch([9, 33])
        assert c.gc_purge(c.canonical_time, drift_slack_ms=0) == 2
    np.testing.assert_array_equal(p.port.store.occupied.numpy(),
                                  flat.store.occupied.numpy())
    tr_j, tr_p = p.each(lambda c: c.compact())
    tr_f = flat.compact()
    np.testing.assert_array_equal(np.asarray(tr_j), tr_p)
    p.check("after the sharded compaction")
    span = N // 2
    for old, val in ((1, 10), (17, 170), (40, 400)):
        new_sh, new_fl = int(tr_p[old]), int(tr_f[old])
        assert new_sh >= 0 and new_sh // span == old // span
        assert p.port.get(new_sh) == flat.get(new_fl) == val
    assert len(p.port) == len(flat) == 3
    assert_tree_equal(p.port.digest_tree(), p.jax.digest_tree())
