"""The port's collective group join against the JAX package's, on the
CPU (JAX's group runs on the virtual CPU devices `tests/conftest.py`
forces; the port's on a member mesh of ``cpu`` devices):

- `CollectiveGroup.join` over the same members in each package, typed
  and LWW-only, with a mid-window joiner: every lane (the local ``mod``
  lanes included), the clocks, the report, the digest root, the seeded
  pack caches byte for byte, the digest caches; a second join is a
  no-op in both;
- the port's join equals pairwise `sync_packed` convergence of the
  same writes, in one ``parallel.collective_join`` call with no pack
  copy; members never alias each other's lanes after it;
- the state converter (`ops.dense.store_from_numpy` per member);
- the validations (type and message) and the raw step's;
- the gossip lane: a co-located peer goes through one join, a failed
  join falls back to the socket and is counted, `attach_group`
  re-scans, a group without the node's replica is refused;
- the port's `SemanticsConformance` on typed `DenseCrdt` s;
- the cross-group route: members declared in groups of 1, 2 (blocked
  and interleaved) or 4 on one CPU device (``groups=`` of the mesh), so
  every collective reduces within each group and then across the
  groups through the funnel, the plain twin of the cards' NCCL step.
  The raw step on random lanes (every tag, (lt, node) ties across the
  groups with payloads of their own, mvreg packs at one lt) against
  JAX's `make_collective_join` on 4 virtual XLA CPU devices, and
  `CollectiveGroup.join` against JAX's group;
- each `parallel.comm` collective against a plain numpy fold, and the
  route each layout takes.

Tolerance 0 throughout (integer lanes).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu.collective import CollectiveGroup as JaxGroup
from crdt_tpu.ops.dense import DenseStore as JaxStore
from crdt_tpu.parallel import collective as jcoll
from crdt_tpu.testing import FakeClock as JaxClock
from crdt_tpu_torch import gossip as pgossip
from crdt_tpu_torch.collective import CollectiveGroup
from crdt_tpu_torch.obs import default_registry
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.parallel import collective as pcoll
from crdt_tpu_torch.parallel import comm
from crdt_tpu_torch.sync import sync_collective, sync_packed
from crdt_tpu_torch.testing import FakeClock, SemanticsConformance

from torch_threads import cap_torch_threads

cap_torch_threads()

N = 64
BASE = 1_700_000_000_000
OP = "parallel.collective_join"
FIELDS = td.DenseStore._fields
GROUPS = {"jax": JaxGroup, "port": CollectiveGroup}


def dense(pkg, node_id, n=N, start=BASE, **kw):
    if pkg == "jax":
        return crdt_tpu.DenseCrdt(node_id, n, wall_clock=JaxClock(start),
                                  **kw)
    return port.DenseCrdt(node_id, n, wall_clock=FakeClock(start),
                          device="cpu", **kw)


def typed(c):
    c.set_semantics([0], "gcounter")
    c.set_semantics([1], "pncounter")
    c.set_semantics([2], "orset")
    c.set_semantics([3], "mvreg")


def build(pkg, n_members=3, seed=0, mixed=True):
    """One deterministic universe of writes: the same FakeClock bases and
    op sequences give the same stamps in either package."""
    rng = random.Random(seed)
    reps = [dense(pkg, chr(ord("a") + i)) for i in range(n_members)]
    for c in reps:
        if mixed:
            typed(c)
    for c in reps:
        slots = rng.sample(range(8, N), 6)
        c.put_batch(slots, [rng.randrange(1, 10_000) for _ in slots])
        c.delete_batch(slots[:1])
        if mixed:
            c.counter_add(0, rng.randrange(1, 50))
            c.counter_add(1, rng.randrange(-20, 20))
            c.orset_add(2, rng.randrange(16))
            c.mvreg_put(3, rng.randrange(1, 100))
    return reps


def lanes(c):
    s = c._store
    if isinstance(s.lt, torch.Tensor):
        return {f: getattr(s, f).numpy() for f in FIELDS}
    return {f: np.asarray(getattr(s, f)) for f in FIELDS}


def packs(c):
    return {k: ([None if a is None else a.tobytes() for a in v[0]], v[1])
            for k, v in c._pack_cache.items()}


def member_state(c):
    return (lanes(c), str(c.canonical_time), c._table.ids(),
            c._sem_host().tobytes(), packs(c), c.stats.merges,
            c._digest_cache[1].root if c._digest_cache else None,
            c._digest_cache[0] if c._digest_cache else None)


def assert_same_members(js, ps, where):
    for j, p in zip(js, ps):
        a, b = member_state(j), member_state(p)
        for f in FIELDS:
            np.testing.assert_array_equal(a[0][f], b[0][f],
                                          err_msg=f"{where}: {f}")
        assert a[1:] == b[1:], where


def report(r):
    return (r.new_canonical, r.win_counts, r.digest_root, r.members,
            r.bytes_to_wire, r.adopted)


@pytest.mark.parametrize("seed,mixed", [(1, True), (2, False), (3, False),
                                        (4, True)])
def test_group_join_matches_jax(seed, mixed):
    j, p = build("jax", seed=seed, mixed=mixed), build("port", seed=seed,
                                                        mixed=mixed)
    jg, pg = JaxGroup(j), CollectiveGroup(p)
    assert report(jg.join()) == report(pg.join())
    assert_same_members(j, p, "first join")
    again = (report(jg.join()), report(pg.join()))
    assert again[0] == again[1] and again[1][5] == 0
    assert_same_members(j, p, "second join")
    for c in j + p:
        c.put_batch([5], [seed])
    assert report(jg.join()) == report(pg.join())
    assert_same_members(j, p, "after a write")


def test_mid_window_joiner_matches_jax():
    out = {}
    for pkg in GROUPS:
        reps = build(pkg, seed=7)
        w = dense(pkg, "w", start=BASE + 9)
        typed(w)
        group = GROUPS[pkg](reps + [w])
        with w.ingest():
            w.put_batch([4, 5], [777, 888])
            r = group.join()
        out[pkg] = (reps + [w], report(r))
    assert out["jax"][1] == out["port"][1]
    assert_same_members(out["jax"][0], out["port"][0], "mid-window")


def wire_converge(reps):
    """The socket-path oracle: full pairwise exchanges until every pair
    has seen every write."""
    for _ in range(2):
        for i in range(len(reps)):
            for k in range(i + 1, len(reps)):
                sync_packed(reps[i], reps[k], since=None)
    return reps


@pytest.mark.parametrize("mixed", [True, False])
def test_join_equals_pairwise_sync_packed_in_one_call(mixed):
    wire = wire_converge(build("port", seed=11, mixed=mixed))
    coll = build("port", seed=11, mixed=mixed)
    copy_bytes = default_registry().counter("crdt_tpu_pack_copy_bytes_total")
    before = sum(s["value"] for s in copy_bytes.samples())
    obs_device.reset()
    rep = sync_collective(CollectiveGroup(coll))
    assert obs_device.op_launches()[OP] == 1 and rep.bytes_to_wire == 0
    assert sum(s["value"] for s in copy_bytes.samples()) == before
    for w, c in zip(wire, coll):
        a, b = lanes(w), lanes(c)
        for f in ("lt", "node", "val", "tomb", "occupied"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        assert np.array_equal(w._sem_host(), c._sem_host())
    obs_device.reset()
    roots = {c.digest_tree().root for c in coll}     # seeded: no build
    assert obs_device.op_launches()["digest_tree"] == 0
    assert roots == {wire[0].digest_tree().root} == {rep.digest_root}
    for c in coll:
        (key,) = c._pack_cache
        mark = port.Hlc.from_logical_time(key[0], "x")
        assert c.pack_since(mark, sem_mode="include" if mixed else "auto") \
            is c._pack_cache[key]
    # Members do not alias: a write into one touches no other.
    coll[0].put_batch([9], [123456])
    assert all(c.get(9) != 123456 for c in coll[1:])
    assert coll[0]._store.lt.data_ptr() != coll[1]._store.lt.data_ptr()


def test_members_seeded_through_store_from_numpy_match_jax():
    """The state converter: each JAX member's lanes and node table land
    in a port member (`store_from_numpy`), and the two groups join to
    the same state."""
    j = build("jax", seed=13)
    p = []
    for c in j:
        store = td.store_from_numpy(
            {f: np.asarray(getattr(c._store, f)) for f in FIELDS}, "cpu")
        m = port.DenseCrdt(c.node_id, N, device="cpu", store=store,
                           node_ids=c._table.ids(),
                           wall_clock=FakeClock(BASE + 500))
        m._set_sem(c._sem_host().copy())
        m._sem_version = c._sem_version     # the cache keys carry it
        m._canonical_time = port.Hlc.parse(str(c.canonical_time))
        p.append(m)
    for c in j:
        c._wall_clock = JaxClock(BASE + 500)
    assert report(JaxGroup(j).join()) == report(CollectiveGroup(p).join())
    for a, b in zip(j, p):
        for f in FIELDS:
            np.testing.assert_array_equal(lanes(a)[f], lanes(b)[f])
        # The keys carry each model's own store generation.
        assert list(packs(a).values()) == list(packs(b).values())


# --- the validations --------------------------------------------------------------


def group_cases():
    def fewer(pkg):
        return GROUPS[pkg]([dense(pkg, "a")])

    def dup(pkg):
        return GROUPS[pkg]([dense(pkg, "dup"), dense(pkg, "dup")])

    def geometry(pkg):
        return GROUPS[pkg]([dense(pkg, "a"), dense(pkg, "b", n=2 * N)])

    def width(pkg):
        return GROUPS[pkg]([dense(pkg, "a"),
                            dense(pkg, "b", value_width=32)])

    def addresses(pkg):
        return GROUPS[pkg]([dense(pkg, "a"), dense(pkg, "b")],
                           addresses={"ghost": "h:1", "a": "h:2"})

    def extent(pkg):
        mesh = (jcoll.make_collective_mesh(3) if pkg == "jax"
                else pcoll.make_collective_mesh(3, ["cpu"] * 3))
        return GROUPS[pkg]([dense(pkg, "a"), dense(pkg, "b")], mesh=mesh)

    def semantics(pkg):
        a, b = dense(pkg, "a"), dense(pkg, "b")
        a.set_semantics([5], "orset")
        b.set_semantics([5], "gcounter")
        return GROUPS[pkg]([a, b]).join()

    def step_arity(pkg):
        if pkg == "jax":
            step = jcoll.make_collective_join(
                jcoll.make_collective_mesh(2), False, 8)
        else:
            step = pcoll.make_collective_join(
                pcoll.make_collective_mesh(2, ["cpu"] * 2), False, 8)
        c = dense(pkg, "a")
        return step((c._store,) * 3, np.zeros(2, np.int64),
                    np.zeros(2, np.int32), 0)

    return [fewer, dup, geometry, width, addresses, extent, semantics,
            step_arity]


@pytest.mark.parametrize("case", group_cases(), ids=lambda f: f.__name__)
def test_validations_match_jax(case):
    errs = []
    for pkg in GROUPS:
        with pytest.raises(ValueError) as info:
            case(pkg)
        errs.append(str(info.value))
    assert errs[0] == errs[1]


def test_default_mesh_takes_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* 2"):
        pcoll.make_collective_mesh(2)
    g = CollectiveGroup([dense("port", "a"), dense("port", "b")])
    assert list(g.mesh.devices) == [torch.device("cpu")] * 2
    assert g.mesh.shape == {pcoll.MEMBER_AXIS: 2}
    assert port.parallel.MEMBER_AXIS == jcoll.MEMBER_AXIS
    assert len(jax.devices()) >= 2


# --- the gossip lane --------------------------------------------------------------


def gossip_pair(pkg):
    a, b = dense(pkg, "ga"), dense(pkg, "gb")
    mod = pgossip if pkg == "port" else crdt_tpu.gossip
    return a, b, mod.GossipNode(a, rng=random.Random(7)), \
        mod.GossipNode(b, rng=random.Random(7))


def test_gossip_routes_co_located_peer_through_one_join():
    out = {}
    for pkg in GROUPS:
        a, b, na, nb = gossip_pair(pkg)
        with na, nb:
            group = GROUPS[pkg]([a, b], addresses={
                "ga": f"{na.host}:{na.port}", "gb": f"{nb.host}:{nb.port}"})
            na.attach_group(group)
            peer = na.add_peer("gb", nb.host, nb.port)
            assert peer.collective
            a.put_batch([1], [11])
            b.put_batch([2], [22])
            obs_device.reset()
            res = na.run_round()
            if pkg == "port":
                assert obs_device.op_launches()[OP] == 1
            out[pkg] = (res, peer.last_attempt, peer.stats.rounds_ok,
                        peer.stats.bytes_sent, peer.stats.bytes_received,
                        a.get(1), b.get(1), a.get(2), b.get(2),
                        str(peer.watermark), na.run_round(),
                        peer.stats.delta_pulls)
    assert out["jax"] == out["port"]
    assert out["port"][:2] == ({"gb": "ok"}, "collective")


def test_gossip_group_given_at_construction():
    a, b = dense("port", "ga"), dense("port", "gb")
    group = CollectiveGroup([a, b])
    with pgossip.GossipNode(a, group=group) as na:
        assert na._group is group
    stranger = dense("port", "ga")
    for pkg in GROUPS:
        with pytest.raises(ValueError, match="does not contain"):
            (pgossip if pkg == "port" else crdt_tpu.gossip).GossipNode(
                stranger if pkg == "port" else dense("jax", "ga"),
                group=group if pkg == "port" else JaxGroup(
                    [dense("jax", "x"), dense("jax", "y")]))


def test_gossip_attach_group_rescans_and_refuses_strangers():
    a, b, na, nb = gossip_pair("port")
    with na, nb:
        peer = na.add_peer("gb", nb.host, nb.port)
        assert not peer.collective
        group = CollectiveGroup([a, b],
                                addresses={"gb": f"{nb.host}:{nb.port}"})
        na.attach_group(group)
        assert peer.collective
        na.attach_group(None)
        assert not peer.collective
        other = CollectiveGroup([dense("port", "ga"), b])
        with pytest.raises(ValueError, match="does not contain"):
            na.attach_group(other)


def test_failed_join_falls_back_to_the_socket_counted():
    out = {}
    for pkg in GROUPS:
        a, b, na, nb = gossip_pair(pkg)
        reg = (default_registry() if pkg == "port"
               else crdt_tpu.default_registry())
        with na, nb:
            group = GROUPS[pkg]([a, b],
                                addresses={"gb": f"{nb.host}:{nb.port}"})
            na.attach_group(group)
            peer = na.add_peer("gb", nb.host, nb.port)

            def boom(*args, **kwargs):
                raise RuntimeError("mesh went away")

            group.join = boom
            a.put_batch([1], [11])
            fb = reg.counter("crdt_tpu_collective_fallback_total")
            before = fb.value(reason="RuntimeError", node="ga", peer="gb")
            res = na.run_round()
            out[pkg] = (res, fb.value(reason="RuntimeError", node="ga",
                                      peer="gb") - before,
                        peer.stats.fallbacks, peer.last_attempt, b.get(1))
    assert out["jax"] == out["port"]
    # The sweep's join fails, then the peer's own round tries the lane
    # again before the ladder: JAX counts both.
    assert out["port"][1] >= 1 and out["port"][3] != "collective"


# --- the cross-group route on one CPU device --------------------------------------

#: Group labels of four members: four groups of one (four cards), two
#: of two (blocked, and interleaved so the gathers reorder), one of four.
GROUPINGS = {"4x1": [0, 1, 2, 3], "2x2": [0, 0, 1, 1],
             "2x2_interleaved": [0, 1, 0, 1], "1x4": [0, 0, 0, 0]}


def grouped_mesh(grouping):
    mesh = pcoll.make_collective_mesh(4, ["cpu"] * 4,
                                      groups=GROUPINGS[grouping])
    want = "local" if grouping == "1x4" else "funnel"
    assert mesh.layout.route == want
    return mesh


def random_members(seed, n, sem):
    """Four members' lanes (numpy): lts on few values so (lt, node) ties
    recur across members, some with payloads of their own (the lowest
    rank's must land), and the mvreg slots' packs at one lt."""
    rng = np.random.default_rng(seed)
    base = BASE << 16
    out = []
    for i in range(4):
        occ = rng.random(n) < 0.7
        lt = base + (rng.integers(0, 3, n) << 16)
        mv = sem == 4
        lt[mv] = base + (5 << 16)
        node = rng.integers(0, 2, n).astype(np.int32)
        val = rng.integers(-2 ** 62, 2 ** 62, n)
        out.append(dict(lt=np.where(occ, lt, 0),
                        node=np.where(occ, node, 0).astype(np.int32),
                        val=np.where(occ, val, 0),
                        mod_lt=np.where(occ, base + (9 << 16), 0),
                        mod_node=np.where(occ, i, 0).astype(np.int32),
                        occupied=occ, tomb=occ & (rng.random(n) < 0.3)))
    return out


@pytest.mark.parametrize("has_sem", [False, True], ids=["lww", "typed"])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_grouped_step_matches_jax(grouping, has_sem):
    n = 4097                                 # odd, past one leaf row
    rng = np.random.default_rng(5)
    sem = (rng.integers(0, 5, n).astype(np.int8) if has_sem
           else np.zeros(n, np.int8))
    members = random_members(6, n, sem)
    since = np.asarray([BASE << 16, (BASE + 1) << 16, 0, BASE << 16],
                       np.int64)
    me = np.asarray([3, 1, 0, 2], np.int32)
    canonical = (BASE + 2) << 16
    jstep = jcoll.make_collective_join(
        jcoll.make_collective_mesh(4, jax.devices()[:4]), has_sem, 8)
    pstep = pcoll.make_collective_join(grouped_mesh(grouping), has_sem, 8)
    sem_args = lambda mod: (() if not has_sem else (
        (jnp.asarray(sem),) if mod == "jax" else (torch.from_numpy(sem),)))
    jstore, jres = jstep(
        tuple(JaxStore(**{k: jnp.asarray(v) for k, v in m.items()})
              for m in members), *sem_args("jax"), since, me,
        jnp.int64(canonical))
    pstores, pres = pstep(
        tuple(td.store_from_numpy(m, "cpu") for m in members),
        *sem_args("port"), torch.from_numpy(since), torch.from_numpy(me),
        canonical)
    for i, st in enumerate(pstores):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(getattr(jstore, f))[i],
                err_msg=f"member {i}: {f}")
        np.testing.assert_array_equal(pres.win[i].numpy(),
                                      np.asarray(jres.win)[i])
        np.testing.assert_array_equal(pres.repack[i].numpy(),
                                      np.asarray(jres.repack)[i])
    assert int(pres.new_canonical) == int(jres.new_canonical)
    assert len(pres.levels) == len(jres.levels)
    for a, b in zip(pres.levels, jres.levels):      # int64 and uint64 bits
        np.testing.assert_array_equal(a.numpy().view(np.uint64),
                                      np.asarray(b).view(np.uint64))
    # The planted ties and the typed lanes did their work.
    assert np.asarray(jres.win).any() and not np.asarray(jres.win).all()


@pytest.mark.parametrize("mixed", [True, False], ids=["typed", "lww"])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_grouped_group_join_matches_jax(grouping, mixed):
    j = build("jax", n_members=4, seed=21, mixed=mixed)
    p = build("port", n_members=4, seed=21, mixed=mixed)
    jg, pg = JaxGroup(j), CollectiveGroup(p, mesh=grouped_mesh(grouping))
    comm.reset_tally()
    assert report(jg.join()) == report(pg.join())
    assert_same_members(j, p, f"{grouping}: first join")
    # Groups on one device: the funnel ran and moved nothing between
    # devices; one group needs no cross-group step.
    assert comm.TALLY["funnel_bytes"] == comm.TALLY["nccl_calls"] == 0
    assert (comm.TALLY["funnel_calls"] > 0) == (grouping != "1x4")
    for c in j + p:
        c.put_batch([5, 9], [len(grouping), 7])
    assert report(jg.join()) == report(pg.join())
    assert_same_members(j, p, f"{grouping}: after a write")
    if mixed:
        assert {c.mvreg_get(3) for c in p} == {j[0].mvreg_get(3)}


LAYOUT_DEVICES = ["cpu"] * 5


@pytest.mark.parametrize("labels", [[0, 0, 0, 0, 0], [0, 1, 2, 3, 4],
                                    [0, 0, 1, 1, 1], [1, 0, 1, 2, 0]],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.uint8,
                                   torch.bool], ids=str)
def test_comm_ops_match_a_plain_fold(labels, dtype):
    layout = comm.Layout(LAYOUT_DEVICES, labels)
    rng = np.random.default_rng(len(set(labels)))
    hi = {torch.int64: 2 ** 62, torch.int32: 2 ** 27, torch.uint8: 40,
          torch.bool: 2}[dtype]
    lo = -hi if dtype in (torch.int64, torch.int32) else 0
    xs = [torch.from_numpy(rng.integers(lo, hi, (3, 7))).to(dtype)
          for _ in LAYOUT_DEVICES]
    blocks = layout.stack(xs)
    ref = np.stack([x.numpy() for x in xs]).astype(np.int64)
    want = {"pmax": ref.max(0), "pmin": ref.min(0), "psum": ref.sum(0)}
    for name, fold in (("pmax", comm.pmax), ("pmin", comm.pmin),
                       ("psum", comm.psum)):
        if name == "pmin" and dtype == torch.bool:
            continue
        outs = fold(layout, blocks)
        assert len(outs) == len(layout.groups)
        for out in outs:
            np.testing.assert_array_equal(out.long().numpy(), want[name],
                                          err_msg=name)
    for out in comm.all_gather(layout, blocks):
        np.testing.assert_array_equal(out.long().numpy(), ref)
    assert [int(r) for g in layout.ranks for r in g.flatten()] == \
        [p for g in layout.groups for p in g]


@pytest.mark.parametrize("labels", [[0, 0, 0, 0, 0], [0, 1, 2, 3, 4],
                                    [1, 0, 1, 2, 0]], ids=str)
def test_comm_lex_winner_matches_a_plain_fold(labels):
    """The lex (lt, node) max and the lowest rank holding it, against a
    per-slot scan in rank order; lts and nodes drawn from a few values so
    ties (on lt, and on both) are common."""
    layout = comm.Layout(LAYOUT_DEVICES, labels)
    rng = np.random.default_rng(7)
    lts = [torch.from_numpy(rng.integers(0, 3, 64)) for _ in LAYOUT_DEVICES]
    nodes = [torch.from_numpy(rng.integers(0, 2, 64)).to(torch.int32)
             for _ in LAYOUT_DEVICES]
    m1, m2, mine = comm.lex_winner(layout, layout.stack(lts),
                                   layout.stack(nodes))
    lt, node = np.stack(lts), np.stack(nodes)
    want = np.zeros(lt.shape, bool)
    for s in range(lt.shape[1]):
        keys = list(zip(lt[:, s], node[:, s]))
        want[keys.index(max(keys)), s] = True
    got = np.zeros(lt.shape, bool)
    for ps, block in zip(layout.groups, mine):
        got[ps] = block.numpy()
    np.testing.assert_array_equal(got, want)
    for a, b in zip(m1, m2):       # the winner's entry, slot by slot
        np.testing.assert_array_equal(a.numpy(), lt.T[want.T])
        np.testing.assert_array_equal(b.numpy(), node.T[want.T])


def test_comm_route_follows_the_layout(monkeypatch):
    monkeypatch.setattr(comm, "nccl_built", lambda: True)
    cards = [f"cuda:{i}" for i in range(4)]
    assert comm.Layout(cards).route == "nccl"
    assert comm.Layout(cards, funnel=True).route == "funnel"
    assert comm.Layout(["cuda:0", "cuda:1"] * 2).route == "nccl"
    assert comm.Layout(["cuda:0", "cuda:1"] * 2).groups == [[0, 2], [1, 3]]
    assert comm.Layout(["cuda:0"] * 4).route == "local"
    # Two groups declared on one card, or a card and the host: funnel.
    assert comm.Layout(["cuda:0"] * 2, labels=["a", "b"]).route == "funnel"
    assert comm.Layout(["cuda:0", "cpu"]).route == "funnel"
    monkeypatch.setattr(comm, "nccl_built", lambda: False)
    assert comm.Layout(cards).route == "funnel"
    with pytest.raises(ValueError, match="share one device"):
        comm.Layout(["cuda:0", "cuda:1"], labels=["a", "a"])
    with pytest.raises(ValueError, match="2 group labels != 4"):
        pcoll.make_collective_mesh(4, ["cpu"] * 4, groups=[0, 1])


# --- the port's conformance kit on typed dense models -----------------------------


class TestPortTypedDenseSemanticsConformance(SemanticsConformance):
    def make_dense(self, node_id):
        return port.DenseCrdt(node_id, self.n_slots, device="cpu",
                              wall_clock=FakeClock(start=BASE))
