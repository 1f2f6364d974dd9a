"""Parity tests of typed slots (`crdt_tpu_torch.semantics` and the typed
surface of the port's models) against ``crdt_tpu`` on the CPU.

Every input is made with numpy from a seed and fed to both packages;
every comparison is exact (integer lanes: tolerance 0):

- the registry: five specs with the same names, tags, codecs, law values
  and refusals;
- the typed joins (`typed_join_lanes`, the wire, sparse and fan-in
  steps, `combine_wire_deltas`) against JAX's on random int64 lanes
  over every tag, bit 63 and the top nibble included;
- the lattice laws of each tag's join (idempotence, commutativity, and
  associativity with `combine_wire_deltas` as the combine) on seeded
  type-canonical lanes;
- `SemanticsConformance` on the port's `DenseCrdt` and
  `ShardedDenseCrdt`;
- the models: the same typed op script on both packages (lanes, clock,
  watch events, exceptions), `PackedDelta` bytes with the sem lane both
  ways, digest roots, the withheld rows of LWW-framed payloads, the tag
  mismatch refusal, `merge_many` / `merge_split` / pipelined windows,
  typed `gc_purge`, `compact` and `grow`, and `sync_packed` /
  `sync_merkle` between a JAX typed replica and a port typed replica in
  both orders.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crdt_tpu_torch as port
from crdt_tpu import DenseCrdt as JaxDense
from crdt_tpu import semantics as jsem
from crdt_tpu.models.dense_crdt import ShardedDenseCrdt as JaxSharded
from crdt_tpu.ops import packing as jp
from crdt_tpu.semantics import kernels as jk
from crdt_tpu.testing import (FakeClock, SemanticsConformance,
                              assert_dense_stores_equal)
from crdt_tpu_torch import semantics as tsem
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import packing as tp
from crdt_tpu_torch.semantics import kernels as tk

from test_torch_sharded import meshes
from torch_threads import cap_torch_threads

cap_torch_threads()

# The modules, not the package-level functions of the same name.
jax_sync = importlib.import_module("crdt_tpu.sync")
port_sync = importlib.import_module("crdt_tpu_torch.sync")

N = 64
BASE = 1_700_000_000_000
TAGS = ("gcounter", "pncounter", "orset", "mvreg")
LAYOUT = {"gcounter": (0, 8), "pncounter": (8, 16), "orset": (16, 24),
          "mvreg": (24, 32)}          # slots 32.. stay LWW


# --- the registry -----------------------------------------------------------


def test_registry_matches_jax():
    assert tsem.names() == jsem.names() == ["lww", "gcounter",
                                            "pncounter", "orset", "mvreg"]
    for t, j in zip(tsem.all_semantics(), jsem.all_semantics()):
        assert (t.name, t.tag, t.doc) == (j.name, j.tag, j.doc)
        assert tsem.get_semantics(t.name) is t and tsem.by_tag(t.tag) is t
        # law_target / audit_target build the analysis gate's targets,
        # under the JAX package's names.
        assert t.law_target(device="cpu").name == j.law_target().name
        assert t.audit_target(device="cpu").name == j.audit_target().name
    for const in ("SEM_LWW", "SEM_GCOUNTER", "SEM_PNCOUNTER", "SEM_ORSET",
                  "SEM_MVREG", "ORSET_UNIVERSE", "ORSET_MAX_LEN", "MVREG_K",
                  "MVREG_MAX"):
        assert getattr(tsem, const) == getattr(jsem, const), const


def _refusal(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["dup_name", "dup_tag", "big_tag",
                                  "unknown_name", "unknown_tag"])
def test_registry_refusals_match_jax(case):
    def run(mod):
        spec = dict(dup_name=("lww", 99), dup_tag=("fresh", 0),
                    big_tag=("fresh", 128)).get(case)
        if spec is not None:
            return _refusal(lambda: mod.register(mod.SemanticsSpec(
                name=spec[0], tag=spec[1], doc="", encode=int, decode=int,
                law_val=lambda lt, node: lt)))
        if case == "unknown_name":
            return _refusal(lambda: mod.get_semantics("nope"))
        return _refusal(lambda: mod.by_tag(77))

    got = run(tsem)
    assert got is not None and got == run(jsem)
    assert tsem.names() == jsem.names()         # nothing registered


CODEC_CASES = {
    "lww": [0, -5, 2 ** 62],
    "gcounter": [0, 3, 2 ** 40, -1],
    "pncounter": [0, 9, -5, 2 ** 31 - 1, -(2 ** 31 - 1), 2 ** 31],
    "orset": [[], [1, 5], list(range(16)), [16], [-1]],
    "mvreg": [1, 7, 0xFFFF, 0, 0x10000],
}


@pytest.mark.parametrize("name", sorted(CODEC_CASES))
def test_codecs_match_jax(name):
    t, j = tsem.get_semantics(name), jsem.get_semantics(name)
    for v in CODEC_CASES[name]:
        out = []
        for spec in (t, j):
            try:
                lane = spec.encode(v)
                out.append(("ok", lane, spec.decode(lane)))
            except ValueError as e:
                out.append(("ValueError", str(e)))
        assert out[0] == out[1], (name, v)
    rng = np.random.default_rng(3)
    lanes = rng.integers(-2 ** 63, 2 ** 63 - 1, 200, dtype=np.int64)
    assert [t.decode(x) for x in lanes] == [j.decode(x) for x in lanes]
    lt = rng.integers(1, 1 << 40, 300).astype(np.int64)
    node = rng.integers(1, 9, 300).astype(np.int32)
    np.testing.assert_array_equal(t.law_val(lt, node), j.law_val(lt, node))


# --- the typed joins --------------------------------------------------------


def _field_lanes(rng, n, width, count, spread):
    """Lanes packing ``count`` fields of ``width`` bits, each drawn from
    ``[0, spread)``, bit 63 included."""
    shifts = np.arange(count, dtype=np.int64) * width
    fields = rng.integers(0, spread, (n, count)).astype(np.int64)
    return (fields << shifts[::-1]).sum(1)


def join_inputs(seed, tag, n=4099):
    """Both sides of a join at ``tag`` (None: every tag mixed, plus an
    unknown one), with top-bit lanes, equal-lt mvreg pairs and exact
    (lt, node) ties."""
    rng = np.random.default_rng(seed)
    if tag is None:
        sem = rng.integers(0, 6, n).astype(np.int8)
    else:
        sem = np.full(n, tsem.get_semantics(tag).tag, np.int8)

    def vals():
        v = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64,
                         endpoint=True)
        v[:6] = [-2 ** 63, 2 ** 63 - 1, 0, -1, -(1 << 60), 1 << 62]  # 0xF<<60
        if tag in ("mvreg", None):
            mv = _field_lanes(rng, n, 16, 4, 6)   # repeats and zeros
            v = np.where(sem == 4, mv, v)
        if tag in ("orset", None):
            v = np.where(sem == 3, _field_lanes(rng, n, 4, 16, 16), v)
        return v

    lt_l = (rng.integers(0, 3, n) << 16).astype(np.int64)
    lt_r = (rng.integers(0, 3, n) << 16).astype(np.int64)
    return dict(sem=sem,
                l_lt=lt_l, l_node=rng.integers(0, 3, n).astype(np.int32),
                l_val=vals(), l_occ=rng.random(n) < 0.7,
                l_tomb=rng.random(n) < 0.3,
                r_lt=lt_r, r_node=rng.integers(0, 3, n).astype(np.int32),
                r_val=vals(), r_tomb=rng.random(n) < 0.3,
                r_valid=rng.random(n) < 0.7)


ORDER = ("sem", "l_lt", "l_node", "l_val", "l_occ", "l_tomb", "r_lt",
         "r_node", "r_val", "r_tomb", "r_valid")


@pytest.mark.parametrize("tag", ["lww", *TAGS, None])
@pytest.mark.parametrize("seed", [0, 1])
def test_typed_join_lanes_matches_jax(tag, seed):
    x = join_inputs(seed, tag)
    want = jk.typed_join_lanes(*(jnp.asarray(x[k]) for k in ORDER))
    got = tk.typed_join_lanes(*(torch.from_numpy(x[k]) for k in ORDER))
    for name, a, b in zip(("lt", "node", "val", "tomb", "occ", "win"),
                          want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{tag}: {name}")
    if tag == "mvreg":     # the equal-lt union ran on both-present lanes
        both = x["l_occ"] & x["r_valid"] & (x["l_lt"] == x["r_lt"])
        assert both.sum() > 500


def _stores(seed, n):
    """The same random store in both packages."""
    rng = np.random.default_rng(seed)
    occ = rng.random(n) < 0.6
    lanes = dict(
        lt=np.where(occ, (rng.integers(0, 3, n) << 16), 0).astype(np.int64),
        node=np.where(occ, rng.integers(0, 3, n), 0).astype(np.int32),
        val=np.where(occ, _field_lanes(rng, n, 16, 4, 6), 0),
        mod_lt=np.where(occ, rng.integers(1, 9, n) << 16, 0),
        mod_node=rng.integers(0, 3, n).astype(np.int32),
        occupied=occ, tomb=occ & (rng.random(n) < 0.3))
    from crdt_tpu.ops.dense import DenseStore as JaxStore
    return (JaxStore(**{k: jnp.asarray(v) for k, v in lanes.items()}),
            td.store_from_numpy(lanes, "cpu"))


def test_wire_and_sparse_steps_match_jax():
    n = 1031
    x = join_inputs(5, None, n)
    jstore, tstore = _stores(6, n)
    args = [x[k] for k in ("r_lt", "r_node", "r_val", "r_tomb", "r_valid")]
    want, wwin = jk.typed_wire_join_step(
        jstore, jnp.asarray(x["sem"]), *(jnp.asarray(a) for a in args),
        jnp.int64(9 << 16), jnp.int32(2))
    got, gwin = tk.typed_wire_join_step(
        tstore, torch.from_numpy(x["sem"]),
        *(torch.from_numpy(a) for a in args), 9 << 16, 2)
    assert_dense_stores_equal(want, got, "wire")
    np.testing.assert_array_equal(np.asarray(wwin), gwin.numpy())

    # Sparse: 300 unique slots, padded to 512 with n_slots sentinels that
    # must never be written (rows past k are invalid).
    rng = np.random.default_rng(7)
    k, padded = 300, 512
    slot = np.full(padded, n, np.int64)
    slot[:k] = rng.choice(n, k, replace=False)
    rows = join_inputs(8, None, padded)
    valid = np.zeros(padded, bool)
    valid[:k] = rows["r_valid"][:k]
    sem_rows = np.zeros(padded, np.int8)
    sem_rows[:k] = x["sem"][slot[:k]]
    jstore, tstore = _stores(9, n)
    r = [rows[k_] for k_ in ("r_lt", "r_node", "r_val", "r_tomb")]
    want, wwin = jk.typed_sparse_join_step(
        jstore, jnp.asarray(sem_rows), jnp.asarray(slot.astype(np.int32)),
        *(jnp.asarray(a) for a in r), jnp.asarray(valid),
        jnp.int64(9 << 16), jnp.int32(2))
    got, gwin = tk.typed_sparse_join_step(
        tstore, torch.from_numpy(sem_rows), torch.from_numpy(slot),
        *(torch.from_numpy(a) for a in r), torch.from_numpy(valid),
        9 << 16, 2)
    assert_dense_stores_equal(want, got, "sparse")
    np.testing.assert_array_equal(np.asarray(wwin), gwin.numpy())
    assert not gwin[k:].any()


@pytest.mark.parametrize("rows", [1, 5])
def test_fanin_step_matches_jax(rows):
    from crdt_tpu.ops.dense import DenseChangeset as JaxCs
    n = 517
    rng = np.random.default_rng(rows)
    sem = rng.integers(0, 5, n).astype(np.int8)
    cs = dict(lt=((BASE + rng.integers(0, 3, (rows, n))) << 16)
              + rng.integers(0, 2, (rows, n)),
              node=rng.integers(0, 4, (rows, n)).astype(np.int32),
              val=_field_lanes(rng, rows * n, 16, 4, 6).reshape(rows, n),
              tomb=rng.random((rows, n)) < 0.3,
              valid=rng.random((rows, n)) < 0.7)
    jstore, tstore = _stores(rows + 10, n)
    canonical = (BASE + 1) << 16
    want, wres = jk.typed_fanin_step(
        jstore, jnp.asarray(sem), JaxCs(**{k: jnp.asarray(v)
                                          for k, v in cs.items()}),
        jnp.int64(canonical), jnp.int32(1), jnp.int64(BASE + 5))
    got, gres = tk.typed_fanin_step(
        tstore, torch.from_numpy(sem),
        td.DenseChangeset(**{k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in cs.items()}),
        canonical, 1, BASE + 5)
    assert_dense_stores_equal(want, got, "fanin")
    np.testing.assert_array_equal(np.asarray(wres.win), gres.win.numpy())
    assert int(wres.new_canonical) == int(gres.new_canonical)
    assert bool(wres.any_bad) == bool(gres.any_dup)


# --- the lattice laws, seeded ------------------------------------------------


def _law_batch(rng, spec, n=64):
    """A wire delta whose values are type-canonical functions of (lt,
    node): the generator of the JAX law targets."""
    millis = rng.integers(1, 1 << 20, size=n)
    lt = ((millis << 16) | rng.integers(0, 4, size=n)).astype(np.int64)
    node = rng.integers(1, 5, size=n).astype(np.int32)
    val = np.asarray(spec.law_val(lt, node), np.int64)
    tomb = ((lt ^ node) & 1).astype(bool)
    valid = rng.integers(0, 2, size=n).astype(bool)
    return {"lt": np.where(valid, lt, 0),
            "node": np.where(valid, node, 0).astype(np.int32),
            "val": np.where(valid, val, 0), "tomb": valid & tomb,
            "valid": valid}


def _apply(store, sem, batch):
    lanes = [torch.from_numpy(np.ascontiguousarray(batch[k]))
             for k in ("lt", "node", "val", "tomb", "valid")]
    out = td.DenseStore(*(x.clone() for x in store))
    tk.typed_wire_join_step(out, sem, *lanes, 1 << 40, 0)
    return {k: getattr(out, k).numpy()
            for k in ("lt", "node", "val", "occupied", "tomb")}, out


@pytest.mark.parametrize("name", ["lww", *TAGS])
def test_typed_join_laws(name):
    spec = tsem.get_semantics(name)
    sem = torch.full((64,), spec.tag, dtype=torch.int8)
    fresh = td.empty_dense_store(64, "cpu")
    rng = np.random.default_rng(spec.tag + 100)

    def same(x, y):
        return all(np.array_equal(x[k], y[k]) for k in x)

    for _ in range(40):
        a, b, c = (_law_batch(rng, spec) for _ in range(3))
        sa, sa_store = _apply(fresh, sem, a)
        assert same(_apply(sa_store, sem, a)[0], sa), "idempotence"
        ab = _apply(_apply(fresh, sem, a)[1], sem, b)
        ba = _apply(_apply(fresh, sem, b)[1], sem, a)
        assert same(ab[0], ba[0]), "commutativity"
        ab_c = _apply(ab[1], sem, c)[0]
        a_bc = _apply(fresh, sem,
                      tk.combine_wire_deltas(sem.numpy(), a,
                                             tk.combine_wire_deltas(
                                                 sem.numpy(), b, c)))[0]
        assert same(ab_c, a_bc), "associativity"
        want = jk.combine_wire_deltas(sem.numpy(), a, b)
        got = tk.combine_wire_deltas(sem.numpy(), a, b)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]), got[k])


# --- the conformance kit on the port's models -------------------------------


class TestPortDenseSemanticsConformance(SemanticsConformance):
    def make_dense(self, node_id):
        return port.DenseCrdt(node_id, self.n_slots, device="cpu",
                              wall_clock=FakeClock(start=BASE))


class TestPortShardedSemanticsConformance(SemanticsConformance):
    def make_dense(self, node_id):
        mesh = port.parallel.make_fanin_mesh(2, 2, devices=["cpu"] * 4)
        return port.ShardedDenseCrdt(node_id, self.n_slots, mesh,
                                     wall_clock=FakeClock(start=BASE))


# --- the models, against the JAX package's ----------------------------------


class Pair:
    """A typed replica in each package, driven in lockstep: unsharded, or
    on a (2, 2) mesh."""

    def __init__(self, node_id, model="dense", n=N, start=BASE, typed=True):
        if model == "dense":
            self.jax = JaxDense(node_id, n, wall_clock=FakeClock(start),
                                executor="xla")
            self.port = port.DenseCrdt(node_id, n, device="cpu",
                                       wall_clock=FakeClock(start))
        else:
            jmesh, tmesh = meshes((2, 2))
            self.jax = JaxSharded(node_id, n, jmesh,
                                  wall_clock=FakeClock(start),
                                  executor="xla")
            self.port = port.ShardedDenseCrdt(node_id, n, tmesh,
                                              wall_clock=FakeClock(start))
        if typed:
            for name, (lo, hi) in LAYOUT.items():
                self.each(lambda c: c.set_semantics(range(lo, hi), name))
        self.events = self.each(lambda c: c.watch().record())

    def each(self, fn):
        return fn(self.jax), fn(self.port)

    def same(self, fn):
        """``fn`` on both replicas: the same result or the same
        exception (type and message)."""
        out = []
        for c in (self.jax, self.port):
            try:
                out.append(("ok", fn(c)))
            except Exception as e:      # compared, then re-raised below
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], out
        return out[1][1]

    def check(self, where):
        assert_dense_stores_equal(self.jax.store, self.port.store, where)
        assert str(self.jax.canonical_time) == str(self.port.canonical_time)
        assert self.jax._table.ids() == self.port._table.ids()
        np.testing.assert_array_equal(self.jax._sem_host(),
                                      self.port._sem_host())
        assert self.jax._sem_version == self.port._sem_version
        assert self.events[0].events == self.events[1].events, where
        assert self.jax.digest_tree().levels[0] == \
            self.port.digest_tree().levels[0]


def typed_script(p, seed, writer):
    """Typed ops through every path of both replicas: direct writes,
    ops inside an ingest window (staged adds accumulate), refusals."""
    rng = np.random.default_rng(seed)
    for _ in range(3):
        g, dg = int(rng.integers(0, 8)), int(rng.integers(0, 9))
        p.same(lambda c: c.counter_add(g, dg))
        s = int(rng.integers(8, 16))
        d = int(rng.integers(-9, 9))
        p.same(lambda c: c.counter_add(s, d))
        o, e = int(rng.integers(16, 24)), int(rng.integers(0, 16))
        p.same(lambda c: c.orset_add(o, e))
        if rng.random() < 0.5:
            p.same(lambda c: c.orset_remove(o, e))
        m, v = int(rng.integers(24, 32)), int(rng.integers(1, 0x8000))
        p.same(lambda c: c.mvreg_put(m, v))
        slots = rng.choice(np.arange(32, N), 4, replace=False)
        vals = rng.integers(-2 ** 40, 2 ** 40, 4)
        p.same(lambda c: c.put_batch(slots, vals))
    with p.jax.ingest(), p.port.ingest():
        for _ in range(4):
            p.same(lambda c: c.counter_add(writer, 3))
            p.same(lambda c: c.orset_add(16 + writer, writer))
            p.same(lambda c: (c.counter_value(writer),
                              c.orset_members(16 + writer)))
        p.same(lambda c: c.delete_batch([33 + writer, 9]))
    p.same(lambda c: [c.counter_value(s) for s in range(16)])
    p.same(lambda c: [c.orset_members(s) for s in range(16, 24)])
    p.same(lambda c: [c.mvreg_get(s) for s in range(24, 32)])
    p.same(lambda c: [c.semantics_of(s).name for s in range(0, N, 7)])
    p.check(f"script {seed}")


REFUSALS = {
    "wrong op": lambda c: c.orset_add(0, 1),
    "lww slot": lambda c: c.counter_add(40, 1),
    "gcounter negative": lambda c: c.counter_add(0, -1),
    "orset universe": lambda c: c.orset_add(16, 16),
    "mvreg zero": lambda c: c.mvreg_put(24, 0),
    "mvreg past int64": lambda c: c.mvreg_put(24, 0x8000),
    "pncounter half": lambda c: c.counter_add(8, 2 ** 31),
    "slot range": lambda c: c.counter_value(N),
    "unknown name": lambda c: c.set_semantics([0], "nope"),
    "unknown tag": lambda c: c.set_semantics([0], 9),
    "set_semantics range": lambda c: c.set_semantics([N], "orset"),
}


@pytest.mark.parametrize("model", ["dense", "sharded"])
def test_typed_ops_match_jax(model):
    p = Pair("a0", model)
    typed_script(p, 1, 0)
    for name, op in REFUSALS.items():
        p.same(op)
    # orset saturation: 7 add/remove cycles, then the length is 14 and
    # one more add reaches 15; the next remove refuses.
    for _ in range(7):
        p.same(lambda c: c.orset_add(17, 2))
        p.same(lambda c: c.orset_remove(17, 2))
    p.same(lambda c: c.orset_add(17, 2))
    p.same(lambda c: c.orset_remove(17, 2))
    p.check("refusals")
    # A value_width=32 replica refuses typed slots, in both packages.
    refused = [_refusal(lambda: c.set_semantics([0], "gcounter"))
               for c in (JaxDense("w", 8, value_width=32, executor="xla"),
                         port.DenseCrdt("w", 8, device="cpu",
                                        value_width=32))]
    assert refused[0] == refused[1] and refused[0][0] == "ValueError"


def _cross(delta, dst):
    """A packed delta rebuilt in ``dst``'s package from its wire bytes."""
    src = tp if dst is jp else jp
    meta, bufs = src.pack_rows(delta)
    return dst.unpack_rows(meta, b"".join(bytes(b) for b in bufs))


@pytest.mark.parametrize("model", ["dense", "sharded"])
@pytest.mark.parametrize("mode", ["include", "withhold", "auto"])
def test_packed_sem_lane_bytes_and_merges_match_jax(model, mode):
    src = Pair("a0", model)
    typed_script(src, 2, 0)
    (jd, jids), (td_, tids) = src.each(lambda c: c.pack_since(None, mode))
    frames = [jp.pack_rows(jd), tp.pack_rows(td_)]
    assert frames[0][0] == frames[1][0]
    assert [bytes(b) for b in frames[0][1]] == \
        [bytes(b) for b in frames[1][1]]
    assert (jd.sem is not None) == (mode == "include") == (td_.sem
                                                           is not None)
    assert jids == tids
    # Each package merges the other's frame; both receivers end equal.
    rcv = Pair("r0", model)
    typed_script(rcv, 3, 1)
    rcv.jax.merge_packed(_cross(td_, jp), tids)
    rcv.port.merge_packed(_cross(jd, tp), jids)
    rcv.check(f"merged {mode}")
    # merge_and_repack on a typed store packs afresh; same bytes.
    out = rcv.each(lambda c: c.merge_and_repack(
        c.pack_since(None, "include")[0], c._table.ids(),
        since=None, sem_mode=mode))
    assert [bytes(b) for b in jp.pack_rows(out[0][0])[1]] == \
        [bytes(b) for b in tp.pack_rows(out[1][0])[1]]
    rcv.check("relay")


@pytest.mark.parametrize("model", ["dense", "sharded"])
def test_withheld_rows_and_tag_mismatch_match_jax(model):
    """LWW-framed payloads (a 5-lane pack, JSON, record dicts) never join
    a typed slot: its rows are withheld, an all-typed payload costs the
    empty merge's two clock ticks; a tag that differs from the local
    column is refused before the clock moves."""
    src = Pair("a0", model, typed=False)
    src.each(lambda c: c.put_batch(np.arange(0, N, 3),
                                   np.arange(0, N, 3) * 7))
    rcv = Pair("r0", model)
    typed_script(rcv, 4, 1)
    plain = src.each(lambda c: c.pack_since(None))
    rcv.jax.merge_packed(*plain[0])
    rcv.port.merge_packed(*plain[1])
    rcv.check("5-lane pack withheld")
    rcv.same(lambda c: c.merge_json(src.jax.to_json(
        modified_since=None)))
    rcv.check("json withheld")
    # Only typed slots: nothing merges, the clock ticks twice.
    only_typed = [jp.PackedDelta(
        slots=np.array([1, 9], np.int32),
        lt=np.array([(BASE + 50) << 16] * 2, np.int64),
        node=np.zeros(2, np.int32), val=np.array([4, 5], np.int64),
        tomb=np.zeros(2, np.uint8))]
    rcv.same(lambda c: c.merge_packed(
        only_typed[0] if c is rcv.jax else _cross(only_typed[0], tp),
        ["zz"]))
    rcv.check("all withheld")
    bad = only_typed[0]._replace(sem=np.array([1, 1], np.uint8))
    before = str(rcv.port.canonical_time)
    rcv.same(lambda c: c.merge_packed(
        bad if c is rcv.jax else _cross(bad, tp), ["zz"]))
    assert str(rcv.port.canonical_time) == before
    rcv.check("mismatch refused")


@pytest.mark.parametrize("model", ["dense", "sharded"])
def test_typed_merges_and_windows_match_jax(model):
    """merge_many of several peers, merge_split, coarse and exact
    pipelined windows, all on typed stores, in both packages."""
    peers = []
    for i, nid in enumerate(("p1", "p2", "p3")):
        p = Pair(nid, model, start=BASE + 3 * i)
        typed_script(p, 10 + i, i)
        peers.append(p)
    rcv = Pair("r0", model)
    typed_script(rcv, 20, 3)
    deltas = [p.each(lambda c: c.export_delta()) for p in peers]
    rcv.jax.merge_many([d[0] for d in deltas])
    rcv.port.merge_many([d[1] for d in deltas])
    rcv.check("merge_many")
    obs_device.reset()
    with rcv.jax.pipelined(), rcv.port.pipelined():
        for d in deltas[::-1]:
            rcv.jax.merge(*d[0])
            rcv.port.merge(*d[1])
    rcv.check("coarse window")
    with rcv.jax.pipelined(exact_guards=True), \
            rcv.port.pipelined(exact_guards=True):
        rcv.jax.merge(*deltas[1][0])
        rcv.port.merge(*deltas[1][1])
    rcv.check("exact window")
    # The split wire form: widened and merged as merge.
    for p in peers[:2]:
        p.same(lambda c: c.put_batch([40, 41], [1, 2]))
        scs = p.each(lambda c: c.export_split_delta(tiled=False))
        rcv.jax.merge_split(*scs[0])
        rcv.port.merge_split(*scs[1])
    rcv.check("merge_split")
    ops = obs_device.op_launches()
    assert ops["typed_fanin_step"] == 6 and sum(
        obs_device.launches().values()) == 0


@pytest.mark.parametrize("model", ["dense", "sharded"])
def test_typed_storage_matches_jax(model):
    p = Pair("a0", model)
    typed_script(p, 30, 0)
    p.same(lambda c: c.delete_batch([0, 9, 17, 25, 40]))
    p.same(lambda c: c.counter_add(1, 4))
    head = p.jax.canonical_time
    p.same(lambda c: c.gc_purge(type(c.canonical_time)(
        head.millis, head.counter, head.node_id), drift_slack_ms=0))
    p.check("gc_purge")
    assert p.port._sem_host()[[0, 9, 17, 25]].tolist() == [0, 0, 0, 0]
    tr = p.each(lambda c: c.compact())
    np.testing.assert_array_equal(np.asarray(tr[0]), tr[1])
    p.check("compact")
    p.same(lambda c: c.counter_add(2, 5))
    n = 2 * N
    p.each(lambda c: c.grow(n))
    p.check("grow")
    p.same(lambda c: c.set_semantics([n - 1], "orset"))
    p.same(lambda c: c.orset_add(n - 1, 3))
    tr = p.each(lambda c: c.compact(ranges=((0, n // 2), (n // 2, n))))
    np.testing.assert_array_equal(np.asarray(tr[0]), tr[1])
    p.check("ranged compact")


def test_snapshot_drops_the_tag_column(tmp_path):
    p = Pair("a0")
    typed_script(p, 40, 0)
    p.port.save(str(tmp_path / "port.npz"))
    p.jax.save(str(tmp_path / "jax.npz"))
    from_port = JaxDense.load("a0", str(tmp_path / "port.npz"),
                              wall_clock=FakeClock(), executor="xla")
    from_jax = port.DenseCrdt.load("a0", str(tmp_path / "jax.npz"),
                                   device="cpu", wall_clock=FakeClock())
    for c in (from_port, from_jax):
        assert c._sem is None and c._sem_version == 0
    assert_dense_stores_equal(from_port.store, from_jax.store, "loaded")
    # The persisted tree (typed) was built under sem_version 4: it does
    # not seed the untyped replica, so both build the same fresh tree.
    assert from_port.digest_tree().levels[0] == \
        from_jax.digest_tree().levels[0]


@pytest.mark.parametrize("order", ["port_local", "jax_local"])
@pytest.mark.parametrize("kind", ["packed", "merkle"])
def test_sync_across_packages_with_the_sem_lane(order, kind):
    """`crdt_tpu.sync` and this package's sync between a JAX typed
    replica and a port typed replica, in both orders, each equal to a
    JAX-JAX run of the same operations (the sem lane on the wire both
    ways, `sem_mode="include"`)."""
    def replica(pkg, nid, seed, writer):
        # The remote's writes are newer than the local's watermark, so
        # one round converges the pair.
        start = BASE + 1000 * writer
        if pkg == "jax":
            c = JaxDense(nid, N, wall_clock=FakeClock(start),
                         executor="xla")
        else:
            c = port.DenseCrdt(nid, N, device="cpu",
                               wall_clock=FakeClock(start))
        for name, (lo, hi) in LAYOUT.items():
            c.set_semantics(range(lo, hi), name)
        rng = np.random.default_rng(seed)
        for _ in range(4):
            c.counter_add(writer, int(rng.integers(1, 5)))
            c.orset_add(16 + writer, int(rng.integers(0, 16)))
            c.mvreg_put(24, int(rng.integers(1, 100)))
            c.put_batch([40 + writer], [int(rng.integers(0, 99))])
        return c

    mixed = (("port", "jax") if order == "port_local" else ("jax", "port"))
    runs = {}
    for label, pkgs, mods in (("mixed", mixed, (port_sync, jax_sync)),
                              ("ref", ("jax", "jax"), (jax_sync, jax_sync))):
        a, b = replica(pkgs[0], "a", 1, 0), replica(pkgs[1], "b", 2, 1)
        getattr(mods[0], f"sync_{kind}")(a, b)
        a.mvreg_put(25, 8)
        b.counter_add(1, 2)
        getattr(mods[1], f"sync_{kind}")(a, b)
        runs[label] = (a, b)
    (a, b), (ra, rb) = runs["mixed"], runs["ref"]
    assert_dense_stores_equal(a.store, ra.store, "local")
    assert_dense_stores_equal(b.store, rb.store, "remote")
    assert str(a.canonical_time) == str(ra.canonical_time)
    assert str(b.canonical_time) == str(rb.canonical_time)
    # Converged, typed lanes included (``modified`` stamps are local).
    sa, sb = a.store, b.store
    occ = np.asarray(sa.occupied)
    np.testing.assert_array_equal(occ, np.asarray(sb.occupied))
    for lane in ("lt", "val", "tomb"):
        np.testing.assert_array_equal(np.asarray(getattr(sa, lane))[occ],
                                      np.asarray(getattr(sb, lane))[occ])
    assert a.mvreg_get(25) == b.mvreg_get(25) == (8,)
    assert a.counter_value(1) == b.counter_value(1)
