"""The port's sharded fan-in (K1p) and `ShardedDenseCrdt` against the
JAX package's, bit for bit (integer lanes: no tolerance).

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the
port on meshes of ``"cpu"`` devices, where each block takes the plain
version of the K1 kernel. The same inputs, made with numpy from a seed,
go to both.

- The step: the port's `make_sharded_fanin` against JAX's
  `make_sharded_pallas_fanin(interpret=True)` (store lanes, ``win``,
  ``win_count``, ``new_canonical`` and the three flags) and against the
  XLA block `make_sharded_fanin` (store lanes), on every mesh shape,
  with identical-HLC ties planted across the replica-shard boundary.
- The cross-group route: the step and the model on (2, 2) and (4, 1)
  meshes whose positions are declared in groups on one CPU device
  (``groups=``: one position a group as on four cards, blocked and
  interleaved pairs, one group), so each key column's combine and the
  mesh-wide scalars reduce within each group and then across the groups
  through the funnel, the plain twin of the cards' NCCL step.
- The model: one op script on a JAX ``ShardedDenseCrdt(executor="xla")``
  and on the port's (lanes, clock, ``to_json`` bytes, exception types
  and payloads, the replica copies equal after every op), merges against
  ``executor="pallas-interpret"``, value-width masking, and checkpoints
  and anti-entropy rounds across the two packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import parallel as jp
from crdt_tpu.models.dense_crdt import DenseCrdt as JaxDense
from crdt_tpu.models.dense_crdt import ShardedDenseCrdt as JaxSharded
from crdt_tpu.models.dense_crdt import sync_dense as jax_sync_dense
from crdt_tpu.ops.dense import DenseChangeset as JaxChangeset
from crdt_tpu.ops.dense import DenseStore as JaxStore
from crdt_tpu.testing import FakeClock, assert_dense_stores_equal
from crdt_tpu_torch import parallel as tp
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import fanin_kernel
from torch_threads import cap_torch_threads

cap_torch_threads()

START = 1_700_000_000_000
TILE = 4096                      # the JAX kernel's per-shard alignment


def meshes(shape, groups=None):
    """The JAX mesh (virtual CPU devices) and the port's (``"cpu"``,
    its positions in ``groups``, row-major labels, where given)."""
    n_dev = int(np.prod(shape))
    if len(shape) == 3:
        return (jp.make_multislice_fanin_mesh(
                    *shape, devices=jax.devices()[:n_dev]),
                tp.make_multislice_fanin_mesh(*shape,
                                              devices=["cpu"] * n_dev,
                                              groups=groups))
    return (jp.make_fanin_mesh(*shape, devices=jax.devices()[:n_dev]),
            tp.make_fanin_mesh(*shape, devices=["cpu"] * n_dev,
                               groups=groups))


def assert_copies_equal(store: tp.ShardedStore, where: str) -> None:
    """Every replica copy of every key shard equals the rank-0 copy, and
    no two copies share memory."""
    ptrs = set()
    for k, first in enumerate(store.blocks[0]):
        for blk in store.column(k):
            for f in td.DenseStore._fields:
                assert torch.equal(getattr(blk, f), getattr(first, f)), \
                    f"{where}: copy of shard {k} differs in {f}"
                ptrs.add(getattr(blk, f).data_ptr())
    n_lanes = sum(len(row) for row in store.blocks) * 7
    assert len(ptrs) == n_lanes or store.width == 0, f"{where}: aliased"


# --- the step -------------------------------------------------------


def step_inputs(n, rows, seed, flagged):
    """Store and changeset lanes (numpy) with dense (lt, node) ties: row
    ``rows // 2 + 2`` repeats row 0's key every 3rd slot with its own
    payload (the replica-shard boundary lies between them on every mesh
    here), row ``rows - 1`` repeats the store's record. ``flagged``
    plants a local-node record above the canonical and a drift record;
    else the canonical sits above every record."""
    rng = np.random.default_rng(seed)
    base = START << 16
    occ = rng.random(n) < 0.5
    s_lt = np.where(occ, base + (rng.integers(0, 6, n) << 16), 0)
    store = dict(lt=s_lt, node=np.where(occ, rng.integers(0, 4, n), 0),
                 val=rng.integers(-2 ** 40, 2 ** 40, n),
                 mod_lt=np.where(occ, base + (99 << 16), 0),
                 mod_node=np.where(occ, 1, 0), occupied=occ,
                 tomb=occ & (rng.random(n) < 0.3))
    cs = dict(lt=base + (rng.integers(0, 6, (rows, n)) << 16),
              node=rng.integers(0, 4, (rows, n)),
              val=rng.integers(-2 ** 40, 2 ** 40, (rows, n)),
              tomb=rng.random((rows, n)) < 0.3,
              valid=rng.random((rows, n)) < 0.6)
    twin = rows // 2 + 2
    cs["lt"][twin, ::3] = cs["lt"][0, ::3]
    cs["node"][twin, ::3] = cs["node"][0, ::3]
    cs["valid"][[0, twin], ::3] = True
    cs["lt"][-1, occ] = s_lt[occ]
    cs["node"][-1, occ] = store["node"][occ]
    local, wall = 2, START + 100
    canonical = base + (3 << 16) if flagged else base + (50 << 16)
    if flagged:
        cs["node"][1, 5], cs["lt"][1, 5] = local, base + (7 << 16)
        cs["valid"][1, 5] = True
        cs["lt"][rows - 2, n - 1] = (wall + 60_001) << 16
        cs["valid"][rows - 2, n - 1] = True
    else:
        cs["node"][cs["node"] == local] = 3
    store["node"] = store["node"].astype(np.int32)
    store["mod_node"] = store["mod_node"].astype(np.int32)
    cs["node"] = cs["node"].astype(np.int32)
    return store, cs, canonical, local, wall


def jax_step_args(store, cs, jmesh, rows_to):
    """JAX's inputs: the changeset padded with invalid rows to
    ``rows_to`` (its kernel walks whole row chunks), both sharded."""
    pad = rows_to - cs["lt"].shape[0]
    cs = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
          for k, v in cs.items()}
    return (jp.shard_store(JaxStore(**{k: jnp.asarray(v)
                                       for k, v in store.items()}), jmesh),
            jp.shard_changeset(JaxChangeset(**{k: jnp.asarray(v)
                                               for k, v in cs.items()}),
                               jmesh))


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2), (2, 4),
                                   (2, 1, 2)], ids=str)
def test_sharded_step_matches_jax(shape):
    jmesh, tmesh = meshes(shape)
    k = shape[-1]
    n, rows = TILE * k, 13        # 13 rows: uneven over every extent here
    extent = tp.replica_extent(tmesh)
    assert extent == jp.replica_extent(jmesh)
    j_pallas = jp.make_sharded_pallas_fanin(jmesh, interpret=True)
    j_xla = jp.make_sharded_fanin(jmesh)
    t_step = tp.make_sharded_fanin(tmesh)
    for seed, flagged in ((1, True), (2, False)):
        store, cs, canonical, local, wall = step_inputs(n, rows, seed,
                                                        flagged)
        j_args = jax_step_args(store, cs, jmesh, -(-rows // (8 * extent))
                               * 8 * extent)
        scalars = (jnp.int64(canonical), jnp.int32(local), jnp.int64(wall))
        j_store, j_res = j_pallas(*j_args, *scalars)
        x_store, _ = j_xla(*j_args, *scalars)
        t_in = tp.shard_store(td.store_from_numpy(store, "cpu"), tmesh)
        t_cs = td.DenseChangeset(**{f: torch.tensor(v) for f, v in cs.items()})
        t_store, t_res = t_step(t_in, tp.shard_changeset(t_cs, tmesh),
                                canonical, local, wall)
        where = f"{shape} seed {seed}"
        assert_copies_equal(t_store, where)
        got = tp.gather_store(t_store)
        for f in td.DenseStore._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(j_store, f)),
                                          err_msg=f"{where}: {f}")
        assert_dense_stores_equal(x_store, got, f"{where} vs XLA block")
        np.testing.assert_array_equal(t_res.win.numpy(),
                                      np.asarray(j_res.win))
        assert int(t_res.win_count) == int(j_res.win_count) > 0
        assert int(t_res.new_canonical) == int(j_res.new_canonical)
        for flag in ("any_bad", "any_dup", "any_drift"):
            assert bool(getattr(t_res, flag)) == \
                bool(getattr(j_res, flag)) == flagged, (where, flag)
        # The unsharded merge of the same inputs lands the same lanes.
        u_store, u_res = fanin_kernel.fanin_batch(
            td.store_from_numpy(store, "cpu"), t_cs, canonical, local, wall)
        for f in td.DenseStore._fields:
            assert torch.equal(getattr(got, f), getattr(u_store, f)), f
        assert torch.equal(t_res.win, u_res.win)
        # The input store was not written.
        assert torch.equal(tp.gather_store(t_in).lt,
                           torch.tensor(store["lt"]))


#: Row-major group labels of four mesh positions: one a group (four
#: cards), blocked and interleaved pairs, one group.
GROUPINGS = {"4x1": [0, 1, 2, 3], "2x2": [0, 0, 1, 1],
             "2x2_interleaved": [0, 1, 0, 1], "1x4": [0, 0, 0, 0]}
GROUPED = [(shape, g) for shape in ((2, 2), (4, 1)) for g in sorted(GROUPINGS)]


@pytest.mark.parametrize("shape,grouping", GROUPED, ids=str)
def test_grouped_sharded_step_matches_jax(shape, grouping):
    jmesh, tmesh = meshes(shape, GROUPINGS[grouping])
    routes = {c.route for c in tmesh.columns}
    if grouping == "1x4":
        assert routes == {"local"} and tmesh.layout.route == "local"
    else:
        assert tmesh.layout.route == "funnel"
    n, rows = TILE * shape[1], 13
    extent = shape[0]
    j_pallas = jp.make_sharded_pallas_fanin(jmesh, interpret=True)
    t_step = tp.make_sharded_fanin(tmesh)
    for seed, flagged in ((11, True), (12, False)):
        store, cs, canonical, local, wall = step_inputs(n, rows, seed,
                                                        flagged)
        j_args = jax_step_args(store, cs, jmesh, -(-rows // (8 * extent))
                               * 8 * extent)
        j_store, j_res = j_pallas(*j_args, jnp.int64(canonical),
                                  jnp.int32(local), jnp.int64(wall))
        t_cs = td.DenseChangeset(**{f: torch.tensor(v) for f, v in cs.items()})
        t_store, t_res = t_step(
            tp.shard_store(td.store_from_numpy(store, "cpu"), tmesh),
            tp.shard_changeset(t_cs, tmesh), canonical, local, wall)
        where = f"{shape} {grouping} seed {seed}"
        assert_copies_equal(t_store, where)
        got = tp.gather_store(t_store)
        for f in td.DenseStore._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(j_store, f)),
                                          err_msg=f"{where}: {f}")
        np.testing.assert_array_equal(t_res.win.numpy(),
                                      np.asarray(j_res.win))
        assert int(t_res.win_count) == int(j_res.win_count) > 0
        assert int(t_res.new_canonical) == int(j_res.new_canonical)
        for flag in ("any_bad", "any_dup", "any_drift"):
            assert bool(getattr(t_res, flag)) == \
                bool(getattr(j_res, flag)) == flagged, (where, flag)
        assert int(tp.sharded_max_logical_time(tmesh)(t_store)) == \
            int(td.dense_max_logical_time(got))


@pytest.mark.parametrize("shape,grouping", GROUPED, ids=str)
def test_grouped_sharded_model_matches_jax(shape, grouping):
    """Flushes, a merge_many, a coarse window, an exact window that
    raises DuplicateNodeException and a delta out, on a grouped mesh
    against JAX's sharded model."""
    n = 64
    p = Pair(shape, n, groups=GROUPINGS[grouping])
    rng = np.random.default_rng(3)
    with p.jax.ingest(auto_flush_rows=16), p.port.ingest(auto_flush_rows=16):
        for _ in range(2):
            slots = rng.choice(n, 12, replace=False)
            vals = rng.integers(-2 ** 40, 2 ** 40, 12)
            p.each(lambda c: c.put_batch(slots, vals))
    p.check(f"{grouping}: after ingest")
    ids1, ids2 = ["n0", "n2", "zz"], ["a0", "n2", "n3"]
    p.merge([(peer_lanes(21, 3, n, 3, 0, 40), ids1),
             (peer_lanes(22, 5, n, 3, 0, 40), ids2)])
    p.check(f"{grouping}: after merge_many")
    since = p.jax.canonical_time
    with p.jax.pipelined(), p.port.pipelined():
        p.merge([(peer_lanes(23, 6, n, 3, 20, 60), ids1)])
        p.merge([(peer_lanes(24, 7, n, 3, 30, 80), ids2)])
    p.check(f"{grouping}: after coarse window")
    ms = p.jax.canonical_time.millis - START
    dup = peer_lanes(25, 2, n, 2, 0, 10, fill=0.0)
    dup["valid"][1, 9], dup["node"][1, 9] = True, 0
    dup["lt"][1, 9] = (START + ms + 500) << 16

    def exact(c):
        with c.pipelined(exact_guards=True):
            c.merge(changeset_of(c, peer_lanes(26, 2, n, 3, 0, 90)), ids1)
            c.merge(changeset_of(c, dup), ["hub", "n7"])
    assert isinstance(p.raises(exact), port.DuplicateNodeException)
    p.check(f"{grouping}: after exact window")
    tsince = port.Hlc(since.millis, since.counter, since.node_id)
    (jcs, jids), (tcs, tids) = (p.jax.export_delta(since),
                                p.port.export_delta(tsince))
    assert jids == tids
    for f in td.DenseChangeset._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jcs, f)),
                                      getattr(tcs, f).numpy(), err_msg=f)


def test_shard_layout_and_ingest():
    """Blocks are views of the home lanes in rank order; a sharded
    flush writes exactly what the unsharded commit writes, on every
    copy; the delta mask and max logical time equal the unsharded
    ones."""
    _, mesh = meshes((3, 2))
    store, cs, *_ = step_inputs(64, 7, 3, False)
    t_cs = td.DenseChangeset(**{f: torch.tensor(v) for f, v in cs.items()})
    blocks = tp.shard_changeset(t_cs, mesh).blocks
    assert [b[0].lt.shape[0] for b in blocks] == [3, 3, 1]
    assert blocks[1][1].lt.data_ptr() == t_cs.lt[3:, 32:].data_ptr()
    assert blocks[1][1].lt.stride() == (64, 1)
    sharded = tp.shard_store(td.store_from_numpy(store, "cpu"), mesh)
    plain = td.store_from_numpy(store, "cpu")
    slots = torch.tensor([0, 31, 32, 63, 7, 64, 64, 64])   # 64: sentinel
    rows = (slots, torch.arange(8) + (START << 16), torch.arange(8) * 11,
            torch.arange(8) % 2 == 0)
    tp.make_sharded_ingest(mesh)(sharded, *rows, 3)
    td.ingest_scatter(plain, *rows, 3)
    assert_copies_equal(sharded, "ingest")
    got = tp.gather_store(sharded)
    for f in td.DenseStore._fields:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
    since = (START << 16) + 4
    assert torch.equal(tp.sharded_delta_mask(mesh)(sharded, since),
                       td.dense_delta_mask(plain, since))
    assert int(tp.sharded_max_logical_time(mesh)(sharded)) == \
        int(td.dense_max_logical_time(plain))
    with pytest.raises(ValueError, match="key shards"):
        tp.shard_store(td.empty_dense_store(63, "cpu"), mesh)


# --- the model ------------------------------------------------------


def peer_lanes(seed, rows, n, n_ids, lo_ms, hi_ms, fill=0.3):
    rng = np.random.default_rng(seed)
    return dict(
        lt=((START + rng.integers(lo_ms, hi_ms, (rows, n))) << 16)
        + rng.integers(0, 3, (rows, n)),
        node=rng.integers(0, n_ids, (rows, n)).astype(np.int32),
        val=rng.integers(-2 ** 40, 2 ** 40, (rows, n)),
        tomb=rng.random((rows, n)) < 0.3,
        valid=rng.random((rows, n)) < fill)


class Pair:
    """A JAX `ShardedDenseCrdt` and the port's, driven in lockstep."""

    def __init__(self, shape, n, node_id="hub", executor="xla",
                 groups=None, **kw):
        self.jmesh, self.tmesh = meshes(shape, groups)
        self.jax = JaxSharded(node_id, n, self.jmesh, wall_clock=FakeClock(),
                              executor=executor, **kw)
        self.port = port.ShardedDenseCrdt(node_id, n, self.tmesh,
                                          wall_clock=FakeClock(), **kw)

    def each(self, fn):
        return fn(self.jax), fn(self.port)

    def merge(self, parts):
        for crdt in (self.jax, self.port):
            crdt.merge_many([(changeset_of(crdt, lanes), ids)
                             for lanes, ids in parts])

    def raises(self, run):
        """Both replicas raise the same exception type and payload."""
        errs = []
        for crdt in (self.jax, self.port):
            with pytest.raises(Exception) as info:
                run(crdt)
            errs.append(info.value)
        assert type(errs[0]).__name__ == type(errs[1]).__name__
        assert str(errs[0]) == str(errs[1]) and \
            errs[0].args == errs[1].args
        return errs[1]

    def check(self, where):
        assert_dense_stores_equal(self.jax.store, self.port.store, where)
        assert str(self.jax.canonical_time) == str(self.port.canonical_time)
        assert self.jax._table.ids() == self.port._table.ids()
        assert self.jax.to_json() == self.port.to_json()
        assert self.jax.stats.records_adopted == \
            self.port.stats.records_adopted
        assert_copies_equal(self.port._store, where)


def package_of(crdt):
    return port if isinstance(crdt, port.DenseCrdt) else crdt_tpu


def as_changeset(mod, lanes):
    """Changeset lanes (a dict of arrays, or either package's changeset)
    as package ``mod``'s changeset."""
    if not isinstance(lanes, dict):
        lanes = dict(zip(td.DenseChangeset._fields, lanes))
    if mod is port:
        return td.DenseChangeset(**{k: torch.tensor(np.asarray(v))
                                    for k, v in lanes.items()})
    return JaxChangeset(**{k: jnp.asarray(np.asarray(v))
                           for k, v in lanes.items()})


def changeset_of(crdt, lanes):
    return as_changeset(package_of(crdt), lanes)


class Across:
    """A replica of one package seen through the other's changeset and
    clock types: the surface `sync_dense` reads and writes."""

    def __init__(self, crdt):
        self.crdt = crdt
        self.own = package_of(crdt)
        self.other = crdt_tpu if self.own is port else port

    @staticmethod
    def hlc(h, mod):
        return mod.Hlc(h.millis, h.counter, h.node_id)

    @property
    def canonical_time(self):
        return self.hlc(self.crdt.canonical_time, self.other)

    def export_delta(self, since=None):
        cs, ids = self.crdt.export_delta(
            None if since is None else self.hlc(since, self.own))
        return as_changeset(self.other, cs), ids

    def merge(self, cs, ids):
        self.crdt.merge(as_changeset(self.own, cs), ids)


def test_sharded_model_op_script_matches_jax(tmp_path):
    n = 64
    p = Pair((2, 2), n)
    rng = np.random.default_rng(0)
    streams = p.each(lambda c: c.watch().record())

    # Local writes: plain batches, then an ingest window with flushes
    # and reads through the overlay.
    p.each(lambda c: c.put_batch([1, 5, 40, 63], [10, 50, 400, 630]))
    p.each(lambda c: c.delete_batch([5, 33]))
    p.check("after put/delete")
    with p.jax.ingest(auto_flush_rows=16), p.port.ingest(auto_flush_rows=16):
        for _ in range(3):
            slots = rng.choice(n, 10, replace=False)
            vals = rng.integers(-2 ** 40, 2 ** 40, 10)
            p.each(lambda c: c.put_batch(slots, vals))
            p.each(lambda c: c.delete_batch(slots[:2]))
            for s in (int(slots[0]), int(slots[-1])):
                assert len(set(p.each(lambda c: c.get(s)))) == 1
                assert len(set(p.each(lambda c: c.is_deleted(s)))) == 1
                assert len(set(p.each(lambda c: c.contains_slot(s)))) == 1
    p.check("after ingest")

    # Two peers, one interning "a0" ahead of "hub" (every stored ordinal
    # shifts, on every copy).
    ids1, ids2 = ["n0", "n2", "zz"], ["a0", "n2", "n3"]
    p.merge([(peer_lanes(1, 2, n, 3, 0, 40), ids1),
             (peer_lanes(2, 2, n, 3, 0, 40), ids2)])
    p.check("after merge_many")
    since = p.jax.canonical_time

    # Guards: a duplicate node, a drift record (both refused with the
    # single-device payload), and a local-node record shielded by an
    # earlier row on the other replica shard (the merge lands).
    ms = p.jax.canonical_time.millis - START
    dup = peer_lanes(3, 2, n, 2, 0, 10, fill=0.0)
    dup["valid"][1, 9], dup["node"][1, 9] = True, 0
    dup["lt"][1, 9] = (START + ms + 500) << 16
    p.raises(lambda c: c.merge(changeset_of(c, dup), ["hub", "n7"]))
    drift = peer_lanes(4, 2, n, 2, 0, 10, fill=0.1)
    drift["valid"][0, 3] = True
    drift["lt"][0, 3] = (START + ms + 200_000) << 16
    p.raises(lambda c: c.merge(changeset_of(c, drift), ["n7", "n8"]))
    p.check("after refusals")
    shield = peer_lanes(5, 2, n, 2, 0, 10, fill=0.0)
    shield["valid"][:, 0] = True
    shield["tomb"][:, 0] = False
    shield["node"][:, 0] = [0, 1]
    shield["lt"][:, 0] = [(START + ms + 900) << 16, (START + ms + 400) << 16]
    p.merge([(shield, ["zz", "hub"])])
    p.check("after shielded merge")
    assert p.port.get(0) == p.jax.get(0) is not None

    # A coarse window (two merges and an empty one), then an exact window
    # whose duplicate raises at the flush with the unpipelined payload.
    with p.jax.pipelined(), p.port.pipelined():
        p.merge([(peer_lanes(6, 2, n, 3, 20, 60), ids1)])
        p.merge([])
        p.merge([(peer_lanes(7, 2, n, 3, 30, 80), ids2)])
    p.check("after coarse window")
    ms = p.jax.canonical_time.millis - START
    dup["lt"][1, 9] = (START + ms + 500) << 16

    def exact(c):
        with c.pipelined(exact_guards=True):
            c.merge(changeset_of(c, peer_lanes(8, 2, n, 3, 0, 90)), ids1)
            c.merge(changeset_of(c, dup), ["hub", "n7"])
    err = p.raises(exact)
    assert isinstance(err, port.DuplicateNodeException)
    p.check("after exact window")

    # The split wire form, from an unsharded peer of each package.
    for src in (JaxDense("w1", n, wall_clock=FakeClock(START + 70)),
                port.DenseCrdt("w2", n, device="cpu",
                               wall_clock=FakeClock(START + 75))):
        src.put_batch(rng.choice(n, 12, replace=False),
                      rng.integers(0, 99, 12))
        scs, ids = src.export_split_delta()
        scs = type(scs)(*(np.asarray(x) for x in scs))
        p.each(lambda c: c.merge_split(scs, ids))
        p.check(f"after merge_split from {type(src).__module__}")

    # Deltas out.
    tsince = port.Hlc(since.millis, since.counter, since.node_id)
    (jcs, jids), (tcs, tids) = (p.jax.export_delta(since),
                                p.port.export_delta(tsince))
    assert jids == tids
    valid = np.asarray(jcs.valid)
    np.testing.assert_array_equal(valid, tcs.valid.numpy())
    for f in ("lt", "node", "val", "tomb"):
        np.testing.assert_array_equal(np.asarray(getattr(jcs, f))[valid],
                                      getattr(tcs, f).numpy()[valid])
    (jpk, _), (tpk, _) = p.jax.pack_since(since), p.port.pack_since(tsince)
    for f in ("slots", "lt", "node", "val", "tomb"):
        assert getattr(jpk, f).tobytes() == getattr(tpk, f).tobytes(), f
    assert p.jax.to_json(since) == p.port.to_json(tsince)
    rec = p.each(lambda c: c.get_slot_record(int(np.nonzero(valid[0])[0][0])))
    assert (str(rec[0].hlc), rec[0].value, str(rec[0].modified)) == \
        (str(rec[1].hlc), rec[1].value, str(rec[1].modified))
    assert streams[0].events == streams[1].events
    assert len(streams[1].events) > 20
    occ = np.asarray(p.jax.store.occupied)
    np.testing.assert_array_equal(np.asarray(p.jax.values)[occ],
                                  p.port.values.numpy()[occ])

    # Each model's split export, merged by a fresh unsharded replica of
    # the other package.
    fresh = (JaxDense("f", n, wall_clock=FakeClock()),
             port.DenseCrdt("f", n, device="cpu", wall_clock=FakeClock()))
    for src, dst in zip((p.port, p.jax), fresh):
        scs, ids = src.export_split_delta()
        dst.merge_split(type(scs)(*(np.asarray(x) for x in scs)), ids)
    assert fresh[0].to_json() == fresh[1].to_json() == p.port.to_json()

    # Anti-entropy with an unsharded replica of the other package, both
    # ways round.
    jplain = JaxDense("pl", n, wall_clock=FakeClock(START + 5))
    tplain = port.DenseCrdt("pl", n, device="cpu",
                            wall_clock=FakeClock(START + 5))
    for c in (jplain, tplain):
        c.put_batch([2, 3, 60], [22, 33, 66])
    port.sync_dense(p.port, Across(jplain))
    jax_sync_dense(p.jax, Across(tplain))
    p.check("after sync_dense")
    assert jplain.to_json() == tplain.to_json() == p.port.to_json()

    # Snapshots across the packages: each model loads the other's.
    p.jax.save(str(tmp_path / "jax.npz"))
    p.port.save(str(tmp_path / "port.npz"))
    from_jax = port.ShardedDenseCrdt.load("hub", str(tmp_path / "jax.npz"),
                                          mesh=p.tmesh,
                                          wall_clock=FakeClock())
    from_port = JaxSharded.load("hub", str(tmp_path / "port.npz"),
                                mesh=p.jmesh, wall_clock=FakeClock(),
                                executor="xla")
    # A resumed clock rebuilds from the lanes (refreshCanonicalTime).
    p.each(lambda c: c.refresh_canonical_time())
    for a, b in ((p.port, from_port), (p.jax, from_jax)):
        assert_dense_stores_equal(a.store, b.store, "npz")
        assert a._table.ids() == b._table.ids()
        assert str(a.canonical_time) == str(b.canonical_time)
    from_jax.put_batch([4], [44])
    from_port.put_batch([4], [44])
    assert from_jax.to_json() == from_port.to_json()
    assert_copies_equal(from_jax._store, "loaded")


def test_sharded_merges_match_jax_pallas_interpret():
    """The JAX model with its Mosaic kernel per shard (interpret mode)
    against the port: unpipelined and coarse-window merges, the shield
    that lands on the other replica shard."""
    n = TILE * 2
    p = Pair((2, 2), n, executor="pallas-interpret")
    p.each(lambda c: c.put_batch(np.arange(0, n, 97), np.arange(0, n, 97)))
    ids = ["n0", "a1", "zz"]
    p.merge([(peer_lanes(11, 3, n, 3, 0, 40), ids),
             (peer_lanes(12, 2, n, 3, 0, 40), ["b2", "n0", "zz"])])
    p.check("after merge_many")
    with p.jax.pipelined(), p.port.pipelined():
        p.merge([(peer_lanes(13, 5, n, 3, 20, 60), ids)])
        p.merge([(peer_lanes(14, 5, n, 3, 30, 80), ids)])
    p.check("after coarse window")
    ms = p.jax.canonical_time.millis - START
    shield = peer_lanes(15, 5, n, 2, 0, 10, fill=0.0)
    shield["valid"][[0, 4], 7] = True
    shield["node"][[0, 4], 7] = [0, 1]
    shield["lt"][[0, 4], 7] = [(START + ms + 900) << 16,
                               (START + ms + 400) << 16]
    p.merge([(shield, ["zz", "hub"])])
    p.check("after shielded merge")


def test_sharded_value_width_32_matches_jax():
    n = 64
    p = Pair((2, 2), n, value_width=32)
    cs = peer_lanes(20, 2, n, 2, 0, 10)
    cs["val"] %= 1000
    cs["val"][1, :3] = 2 ** 40
    cs["valid"][1, :3] = True
    err = p.raises(lambda c: c.merge(changeset_of(c, cs), ["n0", "n2"]))
    assert isinstance(err, ValueError)
    p.check("after value-width refusal")

    def window(c):
        with c.pipelined():
            c.merge(changeset_of(c, cs), ["n0", "n2"])
    err = p.raises(window)
    assert "value-ref overflow" in str(err)
    p.check("after value-width window")
    with pytest.raises(ValueError):
        p.port.put_batch([1], [2 ** 40])


def test_sharded_model_refuses_what_waits_for_its_base():
    """``clear``, ``purge``, ``grow`` and ``compact`` are ported (ROADMAP
    A3b, A4); what the sharded model still refuses: a width that does
    not divide over the key shards, a shrink, overlapping compaction
    spans."""
    _, mesh = meshes((2, 2))
    c = port.ShardedDenseCrdt("n0", 8, mesh)
    c.put_batch([1, 6], [10, 60])
    with pytest.raises(ValueError, match="key shards"):
        c.grow(9)
    with pytest.raises(ValueError, match="cannot shrink"):
        c.grow(4)
    with pytest.raises(ValueError, match="overlap"):
        c.compact(ranges=((0, 4), (2, 6)))
    assert (c.get(1), c.get(6), c.n_slots) == (10, 60, 8)
    with pytest.raises(ValueError, match="key shards"):
        port.ShardedDenseCrdt("n0", 9, mesh)
