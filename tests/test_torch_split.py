"""The split-lane interchange of the port (`crdt_tpu_torch.ops.split`,
the pre-split merge K1s in `ops.fanin_kernel`, and `DenseCrdt`'s
`export_split_delta` / `merge_split` / `pipelined(exact_guards=True)`)
held against the JAX package bit for bit (integer lanes: tolerance 0)
on the same numpy inputs:

- the wire-lane functions against `crdt_tpu.ops.pallas_merge`'s, lane
  values and dtypes;
- `model_fanin_split` against the JAX function with the Pallas kernel
  in interpret mode, wide and narrow, with a remapping ``node_map``,
  value-width masking and a malformed sentinel entry, on every lane and
  every returned field;
- the model: the scripts of ``tests/test_dense_crdt.py``'s
  ``TestSplitInterchange`` and ``TestPipelinedExactGuards`` on a JAX
  ``DenseCrdt(executor="pallas-interpret")`` and a port
  ``DenseCrdt(device="cpu")``, then each package merging the other's
  ``export_split_delta``.

On the CPU the port's wrappers run the kernel's plain version; the CUDA
kernel is held against that plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crdt_tpu_torch as port
from crdt_tpu import DenseCrdt as JaxDenseCrdt
from crdt_tpu.ops import dense as jd
from crdt_tpu.ops import pallas_merge as jp
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import fanin_kernel as tk
from crdt_tpu_torch.ops import split as ts

from test_torch_fanin import (LOCAL, N, R, WALL, assert_lanes_equal,
                              jax_lanes, make_inputs, torch_cs)
from torch_threads import cap_torch_threads

cap_torch_threads()

START = 1_700_000_000_000
# Peer ordinals 0..5 -> local ordinals; peer ordinal 1 is the local node.
NODE_MAP = np.array([2, LOCAL, 5, 1, 4, 3], np.int16)


def np_lanes(lanes):
    return {f: np.asarray(getattr(lanes, f)) for f in lanes._fields}


def assert_same_lanes(jlanes, tlanes, where):
    assert jlanes._fields == tlanes._fields, where
    for f, a in np_lanes(jlanes).items():
        b = getattr(tlanes, f).numpy()
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {f}")


def to_jax_split(lanes):
    cls = jp.NarrowSplitChangeset if "val" in lanes._fields \
        else jp.SplitChangeset
    return cls(**{f: jnp.asarray(v) for f, v in np_lanes(lanes).items()})


def to_port_split(lanes):
    cls = ts.NarrowSplitChangeset if "val" in lanes._fields \
        else ts.SplitChangeset
    return cls(**{f: torch.tensor(v) for f, v in np_lanes(lanes).items()})


def split_inputs(seed, case="plain", narrow=False, r=R, edge=True):
    """make_inputs' store and changeset, the changeset split on the JAX
    side, with a malformed sentinel entry (hi == NEG_HI, lo != 0) alone
    in an empty slot's column, and a few payloads past int32.
    ``edge=False`` drops make_inputs' record at the drift threshold."""
    store, cs, canonical = make_inputs(seed, case, r)
    cs["valid"][r - 1, 7] &= edge
    cs["val"][3, :40] = 2 ** 33 + np.arange(40)
    cs["val"][4, 40:80] = -(2 ** 31) - 1
    jcs = jax_lanes(cs, jd.DenseChangeset)
    if narrow:
        jscs, _ = jp.split_changeset_narrow(jcs)
    else:
        jscs = jp.split_changeset(jcs)
    lanes = {f: np.array(v) for f, v in np_lanes(jscs).items()}
    empty = int(np.nonzero(~store["occupied"])[0][5])
    lanes["hi"][:, empty] = jp.NEG_HI
    lanes["lo"][:, empty] = 0
    lanes["node"][:, empty] = jp.I16_NEG
    lanes["lo"][2, empty] = 7
    lanes["node"][2, empty] = 4
    jscs = type(jscs)(**{f: jnp.asarray(v) for f, v in lanes.items()})
    return store, jscs, canonical, empty


# --- the wire lanes ----------------------------------------------------


@pytest.mark.parametrize("seed,case", [(0, "plain"), (1, "dup")])
def test_split_lanes_match_jax(seed, case):
    _, cs, _ = make_inputs(seed, case)
    cs["val"][2, :30] = 2 ** 35            # past int32: narrow masks them
    cs["valid"][2, :30] = True
    jcs, tcs = jax_lanes(cs, jd.DenseChangeset), torch_cs(cs)
    jscs, tscs = jp.split_changeset(jcs), ts.split_changeset(tcs)
    assert_same_lanes(jscs, tscs, "split_changeset")
    (jn, jovf), (tn, tovf) = (jp.split_changeset_narrow(jcs),
                              ts.split_changeset_narrow(tcs))
    assert_same_lanes(jn, tn, "split_changeset_narrow")
    assert bool(jovf) and bool(tovf)
    for lanes, tlanes in ((jscs, tscs), (jn, tn)):
        jt, tt = jp.tile_changeset(lanes), ts.tile_changeset(tlanes)
        assert_same_lanes(jt, tt, "tile_changeset")
        assert jp._cs_shape(jt) == ts._cs_shape(tt) == (R, N)
        for a, b in ((lanes, tlanes), (jt, tt)):
            assert_same_lanes(jp.split_to_wide(a), ts.split_to_wide(b),
                              "split_to_wide")
        jg = jp.split_guard_lanes(jt.hi, jt.lo, jt.node,
                                  jnp.asarray(NODE_MAP))
        tg = ts.split_guard_lanes(tt.hi, tt.lo, tt.node,
                                  torch.as_tensor(NODE_MAP))
        for a, b in zip(jg, tg):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError, match="tileable"):
        ts.tile_changeset(ts.split_changeset(torch_cs(
            {k: v[:, :100] for k, v in cs.items()})))
    assert (ts.NEG_HI, ts.NEG_LO, ts.I16_NEG, ts.MAX_NODE_ORDINAL,
            ts.TILE, ts._LANE) == (jp.NEG_HI, jp.NEG_LO, jp.I16_NEG,
                                   jp.MAX_NODE_ORDINAL, jp.TILE, jp._LANE)


# --- K1s at the kernel level --------------------------------------------


KERNEL_CASES = [(0, "plain", False, 64, False), (1, "dup", False, 32, True),
                (2, "drift", True, 32, False), (3, "dup", True, 64, True),
                (4, "plain", False, 32, False)]


@pytest.mark.parametrize("seed,case,narrow,value_width,tiled", KERNEL_CASES)
def test_model_fanin_split_matches_pallas(seed, case, narrow, value_width,
                                          tiled):
    store, jscs, canonical, empty = split_inputs(seed, case, narrow)
    if tiled:
        jscs = jp.tile_changeset(jscs)
    jstore, jres, jseen, jovf = jp.model_fanin_split(
        jax_lanes(store, jd.DenseStore), jscs, jnp.asarray(NODE_MAP),
        jnp.int64(canonical), jnp.int32(LOCAL), jnp.int64(WALL),
        chunk_rows=8, interpret=True, value_width=value_width)
    for fn in (tk.model_fanin_split, tk.fanin_split_reference):
        tstore, tres, tseen, tovf = fn(
            td.store_from_numpy(store, "cpu"), to_port_split(jscs),
            torch.as_tensor(NODE_MAP.astype(np.int32)), canonical, LOCAL,
            WALL, value_width=value_width)
        # Every lane of every slot, the malformed sentinel's included.
        assert_lanes_equal(jstore, tstore, fn.__name__)
        np.testing.assert_array_equal(np.asarray(jres.win),
                                      tres.win.numpy())
        assert int(jres.new_canonical) == int(tres.new_canonical)
        assert bool(jres.any_dup) == bool(tres.any_dup)
        assert bool(jres.any_drift) == bool(tres.any_drift)
        assert int(jseen) == int(tseen)
        assert bool(jovf) == bool(tovf)
    # The malformed sentinel won its empty slot and landed unoccupied.
    assert bool(tres.win[empty]) and not bool(tstore.occupied[empty])
    assert bool(tovf) == (value_width == 32 and not narrow)
    assert bool(tres.any_dup) == (case == "dup")
    assert bool(tres.any_drift) == (case == "drift")


# --- the model: split interchange ---------------------------------------


class Pair:
    """One replica in each package, driven in lockstep."""

    def __init__(self, node_id, n=N, start=START, **kw):
        self.jax = JaxDenseCrdt(node_id, n, executor="pallas-interpret",
                                wall_clock=FakeClock(start=start), **kw)
        self.port = port.DenseCrdt(node_id, n, device="cpu",
                                   wall_clock=FakeClock(start=start), **kw)

    def each(self, fn):
        return fn(self.jax), fn(self.port)

    def exports(self, **kw):
        """Both replicas' ``export_split_delta``, checked equal."""
        (js, jids), (ps, pids) = self.each(
            lambda c: c.export_split_delta(**kw))
        assert jids == pids
        assert_same_lanes(js, ps, "export_split_delta")
        return (js, jids), (ps, pids)

    def check(self, where):
        for f in td.DenseStore._fields:
            a = np.asarray(getattr(self.jax.store, f))
            b = getattr(self.port.store, f).numpy()
            occ = np.asarray(self.jax.store.occupied)
            np.testing.assert_array_equal(a[occ], b[occ],
                                          err_msg=f"{where}: {f}")
        np.testing.assert_array_equal(
            np.asarray(self.jax.store.occupied),
            self.port.store.occupied.numpy(), err_msg=where)
        assert str(self.jax.canonical_time) == str(self.port.canonical_time)
        assert self.jax._table.ids() == self.port._table.ids()
        for k in ("merges", "records_seen", "records_adopted"):
            assert getattr(self.jax.stats, k) == \
                getattr(self.port.stats, k), (where, k)


def writer(node_id, start, slots, vals, deletes=(), **kw):
    w = Pair(node_id, start=start, **kw)
    w.each(lambda c: c.put_batch(slots, vals))
    if len(deletes):
        w.each(lambda c: c.delete_batch(deletes))
    return w


def both_raise(fns):
    errs = []
    for fn in fns:
        with pytest.raises(Exception) as info:
            fn()
        errs.append(info.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__
    assert str(errs[0]) == str(errs[1]) and errs[0].args == errs[1].args
    return errs[1]


@pytest.mark.parametrize("value_width", [64, 32])
@pytest.mark.parametrize("tiled", [True, False])
def test_split_interchange_matches_jax(value_width, tiled):
    w = writer("w", START + 5, [0, 7, N - 1], [10, -70, 99], [7],
               value_width=value_width)
    (js, ids), (ps, _) = w.exports(tiled=tiled)
    assert ps.hi.dim() == (3 if tiled else 2)
    rcv = Pair("na", value_width=value_width)
    rcv.jax.merge_split(js, ids)
    rcv.port.merge_split(ps, ids)
    rcv.check("after merge_split")
    assert rcv.port.stats.records_adopted == 3
    assert rcv.port.get(7) is None and rcv.port.get(0) == 10
    # The wide path lands the same lanes and clock.
    wide = port.DenseCrdt("na", N, device="cpu", value_width=value_width,
                          wall_clock=FakeClock(start=START))
    wide.merge(*w.port.export_delta())
    for f in td.DenseStore._fields:
        assert torch.equal(getattr(wide.store, f),
                           getattr(rcv.port.store, f)), f
    assert wide.canonical_time == rcv.port.canonical_time


def test_cross_package_split_deltas():
    """A JAX replica's export merged by a port replica and a port
    replica's export merged by a JAX replica give the same lanes and
    clock on both sides — with a remapping table on the receivers."""
    w = writer("aa", START + 5, np.arange(0, N, 97), np.arange(85) * 3,
               np.arange(0, N, 388))
    w.each(lambda c: c.merge_many([]))
    (js, ids), (ps, _) = w.exports()
    rcv = Pair("zz", node_ids=["m1", "m2", "zz"])
    rcv.port.merge_split(js, ids)                 # JAX's lanes, as jax
    rcv.jax.merge_split(to_jax_split(ps), ids)    # the port's lanes
    rcv.check("cross-package merge_split")
    assert rcv.port._table.ids()[int(rcv.port.store.node[0])] == "aa"
    # A second replica in each package takes the other's delta again.
    again = Pair("m1")
    again.port.merge_split(to_port_split(js), ids)
    again.jax.merge_split(js, ids)
    again.check("second cross merge")


def test_split_guard_parity_and_refusals():
    w = writer("na", START + 50, [1], [1])
    (js, ids), (ps, _) = w.exports()
    rcv = Pair("na")
    err = both_raise([lambda: rcv.jax.merge_split(js, ids),
                      lambda: rcv.port.merge_split(ps, ids)])
    assert isinstance(err, port.DuplicateNodeException)
    rcv.check("after duplicate refusal")
    assert int(rcv.port.store.occupied.sum()) == 0

    big = writer("w", START + 5, [0, 1], [5, 2 ** 40])
    (jcs, bids), (pcs, _) = big.each(lambda c: c.export_delta())
    rcv32 = Pair("na", value_width=32)
    err = both_raise([
        lambda: rcv32.jax.merge_split(jp.split_changeset(jcs), bids),
        lambda: rcv32.port.merge_split(ts.split_changeset(pcs), bids)])
    assert isinstance(err, ValueError) and "int32" in str(err)
    assert int(rcv32.port.store.occupied.sum()) == 0

    wide2 = writer("w", START + 5, [1], [1], n=2 * N)
    (_, _), (ps2, ids2) = wide2.exports(tiled=False)
    with pytest.raises(ValueError, match="merge"):
        rcv.port.merge_split(ps2, ids2)


def test_split_pipelined_window_matches_jax():
    rcv = Pair("na")
    exports = []
    for i, nid in enumerate(("w1", "w2", "w3")):
        w = writer(nid, START + 3 + i, [i, 10 + i], [i * 10, i * 100])
        exports.append(w.exports())
    with rcv.jax.pipelined(), rcv.port.pipelined():
        for (js, ids), (ps, _) in exports:
            rcv.jax.merge_split(js, ids)
            rcv.port.merge_split(ps, ids)
        rcv.each(lambda c: c.merge_many([]))
    rcv.check("after coarse split window")


@pytest.mark.parametrize("rows", [10, 17])
def test_multirow_split_matches_jax(rows):
    rng = np.random.default_rng(rows)
    cs = dict(lt=((START + rng.integers(0, 50, (rows, N))) << 16)
              + rng.integers(0, 4, (rows, N)),
              node=rng.integers(0, 3, (rows, N)).astype(np.int32),
              val=rng.integers(0, 1000, (rows, N)),
              tomb=rng.random((rows, N)) < 0.3,
              valid=rng.random((rows, N)) < 0.7)
    jscs = jp.split_changeset(jax_lanes(cs, jd.DenseChangeset))
    if rows % 2:
        jscs = jp.tile_changeset(jscs)
    ids = ["pa", "pb", "pc"]
    rcv = Pair("na")
    rcv.jax.merge_split(jscs, ids)
    rcv.port.merge_split(to_port_split(jscs), ids)
    rcv.check(f"{rows} rows")


# --- the model: exact-guard windows -------------------------------------


def test_exact_window_real_dup_and_drift_payloads():
    other = writer("na", START + 50, [3], [1])
    (jd_, ids), (pd_, _) = other.each(lambda c: c.export_delta())
    plain, piped = Pair("na"), Pair("na")
    e_plain = both_raise([lambda: plain.jax.merge(jd_, ids),
                          lambda: plain.port.merge(pd_, ids)])

    def window(c, delta):
        with c.pipelined(exact_guards=True):
            c.merge(*delta)

    e_piped = both_raise([lambda: window(piped.jax, (jd_, ids)),
                          lambda: window(piped.port, (pd_, ids))])
    assert isinstance(e_piped, port.DuplicateNodeException)
    assert e_piped.args == e_plain.args
    assert piped.port.get(3) == 1               # the merge has landed
    piped.check("after exact dup window")

    far = writer("far", START + 200_000, [2], [9])
    (jf, fids), (pf, _) = far.each(lambda c: c.export_delta())
    plain, piped = Pair("hub", start=START + 99), Pair("hub",
                                                       start=START + 99)
    e_plain = both_raise([lambda: plain.jax.merge(jf, fids),
                          lambda: plain.port.merge(pf, fids)])
    e_piped = both_raise([lambda: window(piped.jax, (jf, fids)),
                          lambda: window(piped.port, (pf, fids))])
    assert isinstance(e_piped, port.ClockDriftException)
    assert e_piped.args == e_plain.args
    piped.check("after exact drift window")


def test_exact_window_shielded_record_not_spurious():
    lanes = {f: np.zeros((2, N), d) for f, d in (
        ("lt", np.int64), ("node", np.int32), ("val", np.int64),
        ("tomb", bool), ("valid", bool))}
    lanes["lt"][0, 0], lanes["node"][0, 0] = (START + 50) << 16, 0
    lanes["lt"][1, 0], lanes["node"][1, 0] = (START + 10) << 16, 1
    lanes["val"][:, 0] = 1, 2
    lanes["valid"][:, 0] = True
    ids = ["zz", "m"]

    def merge(c):
        cs_cls = td.DenseChangeset if isinstance(c, port.DenseCrdt) \
            else jd.DenseChangeset
        lane = torch.tensor if cs_cls is td.DenseChangeset else jnp.asarray
        c.merge(cs_cls(**{f: lane(v) for f, v in lanes.items()}), ids)

    def coarse(c):
        with c.pipelined():
            merge(c)

    p = Pair("m", start=START + 99)
    err = both_raise([lambda: coarse(p.jax), lambda: coarse(p.port)])
    assert type(err).__name__ == "PipelinedGuardError"
    exact = Pair("m", start=START + 99)
    for c in (exact.jax, exact.port):
        with c.pipelined(exact_guards=True):
            merge(c)                             # no raise
    exact.check("after shielded exact window")
    assert exact.port.get(0) == 1


def test_exact_window_matches_coarse_and_split():
    exports = []
    for i, nid in enumerate(("w1", "w2")):
        w = writer(nid, START + 3 + i, [i, 20 + i], [i * 7, i * 11])
        exports.append((w.each(lambda c: c.export_delta()), w.exports()))
    coarse, exact = Pair("hub"), Pair("hub")
    for p, kw in ((coarse, {}), (exact, {"exact_guards": True})):
        with p.jax.pipelined(**kw), p.port.pipelined(**kw):
            for ((jcs, ids), (pcs, _)), ((js, _), (ps, _)) in exports:
                p.jax.merge(jcs, ids)
                p.port.merge(pcs, ids)
                p.jax.merge_split(js, ids)
                p.port.merge_split(ps, ids)
        p.check(f"window {kw}")
    for f in td.DenseStore._fields:
        assert torch.equal(getattr(coarse.port.store, f),
                           getattr(exact.port.store, f)), f
    assert coarse.port.canonical_time == exact.port.canonical_time

    # merge_split with a real duplicate in an exact window: typed raise.
    dup = writer("na", START + 50, [5], [55])
    (js, ids), (ps, _) = dup.exports()
    piped = Pair("na")

    def window(c, lanes):
        with c.pipelined(exact_guards=True):
            c.merge_split(lanes, ids)

    err = both_raise([lambda: window(piped.jax, js),
                      lambda: window(piped.port, ps)])
    assert isinstance(err, port.DuplicateNodeException)
    piped.check("after exact split dup window")
    clean = Pair("rcv")
    window(clean.jax, js)
    window(clean.port, ps)
    clean.check("clean exact split window")
    assert clean.port.get(5) == 55


def test_exact_window_value_overflow_reported_first():
    big = writer("big", START + 5, [0], [2 ** 40])
    far = writer("far", START + 200_000, [2], [9])
    hub = Pair("hub", start=START + 99, value_width=32)
    deltas = [w.each(lambda c: c.export_delta()) for w in (big, far)]

    def window(i):
        c = (hub.jax, hub.port)[i]
        with c.pipelined(exact_guards=True):
            for d in deltas:
                c.merge(*d[i])

    err = both_raise([lambda: window(0), lambda: window(1)])
    assert type(err).__name__ == "PipelinedGuardError"
    assert "SKIPPED" in str(err) and "exact: drift" in str(err)
    hub.check("after overflow report")


def test_export_split_delta_refuses_wide_tables():
    c = port.DenseCrdt("n0", 64, device="cpu",
                       node_ids=[f"n{i:05d}" for i in range(1 << 15)])
    with pytest.raises(ValueError, match="ordinals"):
        c.export_split_delta()
    ok = port.DenseCrdt("n0", 64, device="cpu",
                        node_ids=[f"n{i:05d}" for i in range(100)])
    scs, _ = ok.export_split_delta()
    assert scs.hi.shape == (1, 64) and scs.node.dtype == torch.int16
