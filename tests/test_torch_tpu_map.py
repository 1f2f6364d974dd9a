"""The port's general-key backend against the JAX package's, on the CPU:

- the sparse `Store` ops (`ops.merge`: `merge_step`, `scatter_put`,
  `max_logical_time`, `delta_mask`, `empty_store`, `grow_store`) on
  numpy-seeded lanes at an odd capacity, with padding entries whose
  slot is at the capacity, past it and negative, every lane and flag
  equal to ``crdt_tpu.ops.merge``'s;
- `TpuMapCrdt` driven by one op script in each package, with the C
  codec and without it: the shadow lanes, the clock, the record maps,
  the `to_json` bytes, the watch events, and the guard exceptions with
  the canonical at the failure;
- the device mirror: a copy of the shadow (never a view), dropped by
  every write, with JAX's lane dtypes; `merge_step` on the mirror
  equals the shadow after the same record merge; the mirror's
  reductions equal the shadow's;
- the state converter (`put_records` of the other package's
  `record_map()`) both ways;
- the port's conformance kit (`crdt_tpu_torch.testing`) on
  `TpuMapCrdt` (`test_torch_keyed.py` runs it on `MapCrdt` and
  `KeyedDenseCrdt`).

Tolerance 0 throughout.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import native as jax_native
from crdt_tpu.ops import merge as jm
from crdt_tpu.testing import FakeClock as JaxClock
from crdt_tpu_torch import native as port_native
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import merge as tm
from crdt_tpu_torch.testing import CrdtConformance, FakeClock

from torch_threads import cap_torch_threads

cap_torch_threads()

BASE = 1_700_000_000_000
PKGS = {"jax": crdt_tpu, "port": port}
LANES = ("lt", "node", "mod_lt", "mod_node", "occupied", "tomb")


# --- the sparse Store ops -----------------------------------------------------


def seeded_store(rng, cap):
    """Store lanes with about half the slots occupied."""
    occ = rng.random(cap) < 0.5
    return {
        "lt": np.where(occ, (BASE + rng.integers(0, 50, cap)) << 16, 0)
        .astype(np.int64),
        "node": np.where(occ, rng.integers(0, 4, cap), 0).astype(np.int32),
        "mod_lt": np.where(occ, BASE << 16, 0).astype(np.int64),
        "mod_node": np.zeros(cap, np.int32),
        "occupied": occ,
        "tomb": occ & (rng.random(cap) < 0.2)}


def seeded_changeset(rng, cap, m):
    """``m`` unique in-range slots (half of them the negative spelling
    of the same slot), then padding entries at ``cap``, past it, below
    ``-cap`` and at a negative in-range index, valid and not."""
    slots = rng.choice(cap, m, replace=False).astype(np.int64)
    neg = rng.random(m) < 0.5
    slots = np.where(neg, slots - cap, slots)
    n = m + 6
    lt = ((BASE + rng.integers(0, 50, n)) << 16).astype(np.int64)
    node = rng.integers(1, 4, n).astype(np.int32)
    tomb = rng.random(n) < 0.3
    valid = np.ones(n, bool)
    used = set(int(s) % cap for s in slots)
    free = next(s for s in range(cap) if s not in used)
    pad = np.array([cap, cap + 7, -cap - 1, -2 * cap, free - cap,
                    cap + 1], np.int64)
    valid[m + 5] = False
    return {"slot": np.concatenate([slots, pad]).astype(np.int32), "lt": lt,
            "node": node, "tomb": tomb, "valid": valid}


def both_stores(lanes):
    return (jm.Store(**{f: jnp.asarray(v) for f, v in lanes.items()}),
            tm.Store(**{f: torch.tensor(v) for f, v in lanes.items()}))


def both_changesets(cs):
    return (jm.Changeset(**{f: jnp.asarray(v) for f, v in cs.items()}),
            tm.Changeset(**{f: torch.tensor(v) for f, v in cs.items()}))


def assert_same_store(j, p, where):
    for f in LANES:
        a, b = np.asarray(getattr(j, f)), getattr(p, f).numpy()
        assert a.dtype == b.dtype, (where, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {f}")


@pytest.mark.parametrize("seed,cap,m", [(0, 1000, 300), (1, 37, 20),
                                        (2, 4097, 64)])
def test_merge_step_matches_jax(seed, cap, m):
    rng = np.random.default_rng(seed)
    js, ps = both_stores(seeded_store(rng, cap))
    jc, pc = both_changesets(seeded_changeset(rng, cap, m))
    canonical, wall = (BASE + 20) << 16, BASE + 30
    obs_device.reset()
    jout, jres = jm.merge_step(js, jc, jnp.int64(canonical), jnp.int32(0),
                               jnp.int64(wall))
    pout, pres = tm.merge_step(ps, pc, canonical, 0, wall)
    assert obs_device.op_launches()["merge_step"] == 1
    assert_same_store(jout, pout, "merge_step")
    assert_same_store(js, ps, "input untouched")
    for f in jm.MergeResult._fields:
        a, b = np.asarray(getattr(jres, f)), getattr(pres, f).numpy()
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert a.dtype == b.dtype, f
    # Padding outside [-cap, cap) reads as absent (so a valid one wins)
    # and writes nothing; an invalid entry never wins.
    assert pres.win[m:m + 4].all() and not pres.win[m + 5]


@pytest.mark.parametrize("seed,cap", [(3, 1000), (4, 37)])
def test_scatter_put_and_reductions_match_jax(seed, cap):
    rng = np.random.default_rng(seed)
    js, ps = both_stores(seeded_store(rng, cap))
    cs = seeded_changeset(rng, cap, cap // 3)
    jc, pc = both_changesets(cs)
    mod = ((BASE + 60) << 16) + np.arange(len(cs["slot"]), dtype=np.int64)
    mod_node = np.full(len(cs["slot"]), 2, np.int32)
    jout = jm.scatter_put(js, jc, jnp.asarray(mod), jnp.asarray(mod_node))
    pout = tm.scatter_put(ps, pc, torch.tensor(mod), torch.tensor(mod_node))
    assert_same_store(jout, pout, "scatter_put")
    # One scalar stamp for every entry, as JAX broadcasts it.
    jout = jm.scatter_put(js, jc, jnp.int64(mod[0]), jnp.int32(1))
    pout = tm.scatter_put(ps, pc, int(mod[0]), 1)
    assert_same_store(jout, pout, "scatter_put scalar stamps")
    assert int(jm.max_logical_time(jout)) == int(tm.max_logical_time(pout))
    for since in (0, (BASE + 60) << 16, int(mod[3]), int(mod.max()) + 1):
        np.testing.assert_array_equal(
            np.asarray(jm.delta_mask(jout, jnp.int64(since))),
            tm.delta_mask(pout, since).numpy())


def test_empty_and_grow_store_match_jax(monkeypatch):
    assert_same_store(jm.empty_store(13), tm.empty_store(13, "cpu"), "empty")
    assert int(tm.max_logical_time(tm.empty_store(5, "cpu"))) == 0
    rng = np.random.default_rng(5)
    js, ps = both_stores(seeded_store(rng, 20))
    assert_same_store(jm.grow_store(js, 33), tm.grow_store(ps, 33), "grow")
    assert tm.grow_store(ps, 20) is ps
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.empty_store(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TpuMapCrdt("n")


# --- TpuMapCrdt against JAX's -------------------------------------------------------


def make(pkg, node_id="abc", start=BASE, step=1):
    kw = {} if pkg == "jax" else {"device": "cpu"}
    clock = (JaxClock if pkg == "jax" else FakeClock)(start, step)
    return PKGS[pkg].TpuMapCrdt(node_id, wall_clock=clock, **kw)


def rec(pkg, ms, counter, node, value):
    """A `Record` of ``pkg`` whose hlc and modified stamps agree."""
    m = PKGS[pkg]
    return m.Record(m.Hlc(ms, counter, node), value, m.Hlc(ms, counter, node))


def op_script(seed, n_ops=80):
    """Puts, batches, deletes, clears, record merges (tie-heavy stamps,
    tombstones, a node id that sorts first) and JSON merges, as plain
    data both packages replay."""
    rng = random.Random(seed)
    keys = [f"k{i}" for i in range(14)] + [3, 7]
    ops = []
    for _ in range(n_ops):
        kind = rng.randrange(7)
        if kind == 0:
            ops.append(("put", rng.choice(keys), rng.randrange(100)))
        elif kind == 1:
            ops.append(("put_all", {k: (None if rng.random() < 0.2
                                        else rng.randrange(100))
                                    for k in rng.sample(keys, 4)}))
        elif kind == 2:
            ops.append(("delete", rng.choice(keys)))
        elif kind in (3, 4):
            recs = {}
            for k in rng.sample(keys, rng.randrange(1, 5)):
                ms = BASE + rng.randrange(0, 200)
                recs[k] = (ms, rng.randrange(3),
                           rng.choice(["n1", "n2", "zz", "a0"]),
                           None if rng.random() < 0.25 else rng.randrange(999))
            ops.append(("merge", recs))
        elif kind == 5:
            ops.append(("json", {f"j{rng.randrange(6)}":
                                 (BASE + rng.randrange(0, 200),
                                  rng.randrange(3), rng.choice(["n1", "zz"]),
                                  rng.randrange(50))
                                 for _ in range(3)}))
        else:
            ops.append(("clear", rng.random() < 0.3))
    return ops


def wire_json(pkg, recs):
    """A wire payload built by ``pkg``'s own encoder."""
    mod = PKGS[pkg]
    src = mod.MapCrdt("src", wall_clock=FakeClock())
    src.put_records({k: rec(pkg, *v) for k, v in recs.items()})
    return src.to_json()


def replay(pkg, crdt, ops):
    for op in ops:
        kind = op[0]
        if kind == "put":
            crdt.put(op[1], op[2])
        elif kind == "put_all":
            crdt.put_all(dict(op[1]))
        elif kind == "delete":
            crdt.delete(op[1])
        elif kind == "merge":
            crdt.merge({k: rec(pkg, *v) for k, v in op[1].items()})
        elif kind == "json":
            crdt.merge_json(wire_json(pkg, op[1]))
        else:
            crdt.clear(purge=op[1])


def rmap(crdt, since=None):
    return [(k, str(r.hlc), r.value, str(r.modified))
            for k, r in crdt.record_map(since).items()]


def shadow(crdt):
    n = crdt._lanes.capacity
    return {f: getattr(crdt._lanes, f)[:n].copy() for f in LANES}


def state(crdt, pkg):
    return (shadow(crdt), str(crdt.canonical_time), rmap(crdt),
            crdt.to_json(), crdt._slot_keys, crdt._payload,
            crdt._table.ids())


def assert_same_state(a, b, where):
    for f in LANES:
        np.testing.assert_array_equal(a[0][f], b[0][f],
                                      err_msg=f"{where}: {f}")
    assert a[1:] == b[1:], where


def native_off(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)
    monkeypatch.setattr(port_native, "load", lambda: None)


@pytest.mark.parametrize("codec", ["c", "python"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_script_matches_jax(seed, codec, monkeypatch):
    if codec == "python":
        native_off(monkeypatch)
    ops = op_script(seed)
    out = {}
    for pkg in ("jax", "port"):
        c = make(pkg)
        seen = []
        c.watch().listen(lambda e: seen.append((e.key, e.value)))
        keyed = c.watch(key="k3").record()
        replay(pkg, c, ops)
        st = state(c, pkg)
        out[pkg] = (st, seen, [(e.key, e.value) for e in keyed.events],
                    rmap(c, c.canonical_time),
                    c.to_json(modified_since=c.canonical_time),
                    c.count_modified_since(c.canonical_time))
    assert_same_state(out["jax"][0], out["port"][0], f"seed {seed}")
    assert out["jax"][1:] == out["port"][1:]


def test_both_codec_branches_give_the_same_bytes(monkeypatch):
    ops = op_script(7)
    fast = make("port")
    replay("port", fast, ops)
    native_off(monkeypatch)
    slow = make("port")
    replay("port", slow, ops)
    assert_same_state(state(fast, "port"), state(slow, "port"), "codecs")


@pytest.mark.parametrize("codec", ["c", "python"])
@pytest.mark.parametrize("case", ["dup", "drift", "dup_after_fast",
                                  "json_drift"])
def test_guard_refusals_match_jax(case, codec, monkeypatch):
    if codec == "python":
        native_off(monkeypatch)
    out = []
    for pkg in ("jax", "port"):
        c = make(pkg)
        c.put_all({"a": 1, "b": 2})
        before = state(c, pkg)
        ahead = BASE + 1000
        if case == "dup":
            payload = {"x": rec(pkg, ahead, 0, "n1", 1),
                       "y": rec(pkg, ahead + 5, 0, "abc", 2)}
        elif case == "drift":
            payload = {"x": rec(pkg, ahead, 1, "n1", 1),
                       "y": rec(pkg, BASE + 120_000, 0, "n2", 2)}
        elif case == "dup_after_fast":
            # the old record of our own id rides recv's fast path
            payload = {"x": rec(pkg, BASE - 10, 0, "abc", 1),
                       "y": rec(pkg, ahead, 0, "abc", 2)}
        with pytest.raises(Exception) as info:
            if case == "json_drift":
                c.merge_json(wire_json(pkg, {
                    "x": (ahead, 0, "n1", 1),
                    "y": (BASE + 200_000, 0, "n2", 2)}))
            else:
                c.merge(payload)
        after = state(c, pkg)
        assert after[0]["lt"].tolist() == before[0]["lt"].tolist()
        out.append((type(info.value).__name__, str(info.value), after[1],
                    after[2], after[3]))
    assert out[0] == out[1]


def test_empty_merges_tick_the_clock_like_jax():
    out = []
    for pkg in ("jax", "port"):
        c = make(pkg, step=3)
        c.put("a", 1)
        c.merge({})
        c.merge_json("{}")
        c.put_all({})
        out.append((str(c.canonical_time), c.to_json()))
    assert out[0] == out[1]


def test_seed_and_growth_match_jax():
    out = []
    for pkg in ("jax", "port"):
        seed = {f"s{i}": rec(pkg, BASE + i, i, f"n{i % 3}", i)
                for i in range(20)}
        kw = {} if pkg == "jax" else {"device": "cpu"}
        c = PKGS[pkg].TpuMapCrdt("abc", seed=seed, wall_clock=FakeClock(),
                                 capacity=3, **kw)
        for i in range(300):
            c.put(f"k{i}", i)
        out.append(state(c, pkg))
        assert c._lanes.capacity == 512
    assert_same_state(out[0], out[1], "seed and growth")


# --- the device mirror --------------------------------------------------------------


def test_mirror_is_a_copy_dropped_by_every_write():
    c = make("port")
    c.put_all({f"k{i}": i for i in range(10)})
    s = c.store
    assert c.store is s and c.device == torch.device("cpu")
    assert {f: getattr(s, f).dtype for f in LANES} == tm.STORE_DTYPES
    for f in LANES:
        np.testing.assert_array_equal(getattr(s, f).numpy(),
                                      getattr(c._lanes, f))
    s.lt[0] = -1                              # never writes through
    assert c._lanes.lt[0] != -1
    lt0 = int(c._lanes.lt[1])
    for write in (lambda: c.put("k1", 99), lambda: c.delete("k2"),
                  lambda: c.merge({"z": rec("port", BASE + 500, 0, "n", 1)}),
                  lambda: c.merge_json(wire_json("port", {
                      "w": (BASE + 600, 0, "n", 2)})),
                  lambda: c.put_records({"v": rec("port", BASE, 0, "m", 3)}),
                  lambda: c.clear(purge=True)):
        before = c.store
        write()
        assert c._device is None
        assert c.store is not before
    assert int(s.lt[1]) == lt0                 # the old mirror stands


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_step_on_the_mirror_equals_the_record_merge(seed):
    """What path I checks on the card: the shadow after a record merge
    equals `merge_step` of the same changeset against the mirror taken
    before it, every lane (``mod_lt`` is the pre-send canonical in
    both)."""
    rng = random.Random(seed)
    c = make("port", node_id="local")
    c.put_all({i: i for i in range(500)})
    c.merge({i: rec("port", BASE + 300 + i, 0, "peer", i)
             for i in range(0, 500, 7)})
    mirror = c.store
    remote = {}
    for k in rng.sample(range(700), 200):
        remote[k] = rec("port", BASE + rng.randrange(0, 900),
                        rng.randrange(3), rng.choice(["peer", "zed"]),
                        None if rng.random() < 0.2 else k)
    c._intern_nodes([r.hlc.node_id for r in remote.values()])
    mirror = c.store                      # ordinals as the merge sees them
    canonical = c.canonical_time.logical_time
    wall = c._wall_clock.millis + 1       # the merge's own wall read
    slots = np.array([c._key_to_slot.get(k, -1) for k in remote])
    new = slots < 0
    slots[new] = len(c._slot_keys) + np.arange(int(new.sum()))
    cs = tm.Changeset(
        slot=torch.tensor(slots, dtype=torch.int32),
        lt=torch.tensor([r.hlc.logical_time for r in remote.values()]),
        node=torch.tensor(c._table.encode([r.hlc.node_id
                                           for r in remote.values()])),
        tomb=torch.tensor([r.value is None for r in remote.values()]),
        valid=torch.ones(len(remote), dtype=torch.bool))
    cap_before = c._lanes.capacity
    c.merge(remote)
    grown = tm.grow_store(mirror, c._lanes.capacity)
    out, res = tm.merge_step(grown, cs, canonical,
                             c._table.ordinal("local"), wall)
    assert not bool(res.any_bad) and c._lanes.capacity >= cap_before
    for f in LANES:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      getattr(c._lanes, f), err_msg=f)
    assert int(tm.max_logical_time(c.store)) == int(
        np.max(np.where(c._lanes.occupied, c._lanes.lt, 0)))
    since = c.canonical_time.logical_time - (5 << 16)
    np.testing.assert_array_equal(
        tm.delta_mask(c.store, since).numpy(),
        c._lanes.occupied & (c._lanes.mod_lt >= since))


def test_record_paths_never_touch_the_mirror():
    c = make("port")
    c.put_all({"a": 1})
    c.merge({"b": rec("port", BASE + 9, 0, "n", 2)})
    c.merge_json(c.to_json())
    c.record_map()
    assert c._device is None


# --- the state converter ------------------------------------------------------------


def test_put_records_of_the_other_packages_record_map():
    ops = op_script(11)
    src = {pkg: make(pkg) for pkg in PKGS}
    for pkg, c in src.items():
        replay(pkg, c, ops)
    into = {pkg: make(pkg, node_id="dst") for pkg in PKGS}
    # jax -> port and port -> jax, each beside its same-package twin
    for dst_pkg, src_pkg in (("port", "jax"), ("jax", "port")):
        mod = PKGS[dst_pkg]
        into[dst_pkg].put_records({
            k: mod.Record(mod.Hlc.parse(str(r.hlc)), r.value,
                          mod.Hlc.parse(str(r.modified)))
            for k, r in src[src_pkg].record_map().items()})
    assert_same_state(state(into["jax"], "jax"), state(into["port"], "port"),
                      "converted")
    assert into["port"].to_json() == src["jax"].to_json()


# --- the port's conformance kit -----------------------------------------------------


class TestPortTpuMapConformance(CrdtConformance):
    def make_crdt(self):
        return port.TpuMapCrdt("abc", wall_clock=FakeClock(), device="cpu")

