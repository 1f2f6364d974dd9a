"""The port's Merkle anti-entropy against the JAX package's, bit for bit
(64-bit digests, wire bytes and counts: tolerance 0).

- The digest math: `_mix64` in int64 lanes against a numpy-uint64
  splitmix64 written here; `slot_digests` (with ``idx_offset`` near
  2^32) and every tree level against ``crdt_tpu.ops.digest`` at ragged
  sizes, on lanes whose ``lt`` and ``val`` have the top bit set or are
  negative, with tombstones and empty slots.
- The model's ``digest_tree``: levels equal to a JAX replica given the
  same operations, the cache (no ``digest_tree`` op on a hit), either
  package's walk over the other's tree, and the persisted tree: a
  snapshot saved by either package loads in the other with its tree
  seeded, and the first ``digest_tree()`` builds nothing.
- Ranged packs: byte for byte against JAX, the whole-store span equal
  to the unranged pack, the out-of-bounds refusal, overlapping spans.
- ``sync_merkle`` and ``sync_packed``, this package's and the JAX
  package's, on port-port, port-JAX and JAX-port pairs: the same
  `MerkleSyncReport` fields as a JAX-JAX run given the same operations,
  equal lanes everywhere, the geometry refusal.

The scenarios follow ``tests/test_merkle.py`` (its in-process part).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crdt_tpu_torch as port
from crdt_tpu import DenseCrdt as JaxDense
from crdt_tpu import checkpoint as jax_ckpt
from crdt_tpu.ops import digest as jd
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch import checkpoint as port_ckpt
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import digest as tdg
from torch_threads import cap_torch_threads

cap_torch_threads()

# The modules, not the package-level functions of the same name.
jax_sync = importlib.import_module("crdt_tpu.sync")
port_sync = importlib.import_module("crdt_tpu_torch.sync")
BASE = 1_700_000_000_000
SYNCS = {"port": port_sync, "jax": jax_sync}


def make(pkg, node, n_slots=64, start=BASE):
    if pkg == "jax":
        return JaxDense(node, n_slots, wall_clock=FakeClock(start=start))
    return port.DenseCrdt(node, n_slots, device="cpu",
                          wall_clock=FakeClock(start=start))


def np_lanes(crdt, lane):
    x = getattr(crdt.store, lane)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_replicated_equal(a, b):
    """Replicated lanes (node and mod_* are replica-local)."""
    for lane in ("lt", "val", "tomb", "occupied"):
        np.testing.assert_array_equal(np_lanes(a, lane), np_lanes(b, lane),
                                      err_msg=lane)


def assert_stores_equal(a, b):
    for lane in ("lt", "node", "val", "mod_lt", "mod_node", "occupied",
                 "tomb"):
        np.testing.assert_array_equal(np_lanes(a, lane), np_lanes(b, lane),
                                      err_msg=lane)
    assert str(a.canonical_time) == str(b.canonical_time)


def assert_trees_equal(a, b):
    assert (a.n_slots, a.leaf_width, a.depth) == (b.n_slots, b.leaf_width,
                                                  b.depth)
    for la, lb in zip(a.levels, b.levels):
        assert np.asarray(la).dtype == np.asarray(lb).dtype == np.uint64
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    assert a.root == b.root


def packed_bytes(packed):
    return [np.asarray(getattr(packed, f)).tobytes()
            for f in ("slots", "lt", "node", "val", "tomb")]


# --- the digest math ---------------------------------------------------


def mix64_u64(x):
    """splitmix64's finalizer in numpy uint64, independent of the port's
    int64 emulation."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def top_bit_lanes(n, seed):
    """Lanes over the whole int64 range: top bit set, negatives, the
    extremes, tombstones and empty slots."""
    rng = np.random.default_rng(seed)
    lt = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64,
                      endpoint=True)
    val = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64,
                       endpoint=True)
    lt[:4] = [-1, -2 ** 63, 2 ** 63 - 1, 0][:min(4, n)]
    val[-3:] = [-2 ** 63, -1, 2 ** 63 - 1][-min(3, n):]
    return dict(lt=lt, val=val, tomb=rng.random(n) < 0.3,
                occupied=rng.random(n) < 0.7)


def test_mix64_int64_wrap_matches_numpy_uint64():
    x = top_bit_lanes(4097, 1)["lt"]
    got = tdg._mix64(torch.tensor(x)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, mix64_u64(x.view(np.uint64)))
    # The logical shift alone, on values with the top bit set.
    for k in (1, 27, 30, 31, 63):
        np.testing.assert_array_equal(
            tdg._shr(torch.tensor(x), k).numpy().view(np.uint64),
            x.view(np.uint64) >> np.uint64(k))


@pytest.mark.parametrize("offset", [0, 2 ** 32 - 3, 2 ** 32 + 7])
@pytest.mark.parametrize("n", [1, 7, 8, 1000, 4097])
def test_slot_digests_match_jax(n, offset):
    lanes = top_bit_lanes(n, n)
    want = jd.slot_digests(*(jnp.asarray(a) for a in lanes.values()),
                           idx_offset=jnp.uint64(offset) if offset
                           else None)
    got = tdg.slot_digests(*(torch.tensor(a) for a in lanes.values()),
                           idx_offset=offset)
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want))
    assert not got[~torch.tensor(lanes["occupied"])].any()


def test_slot_digests_with_a_tag_lane_match_jax():
    lanes = top_bit_lanes(100, 3)
    sem = np.random.default_rng(4).integers(0, 5, 100).astype(np.int8)
    want = jd.slot_digests(*(jnp.asarray(a) for a in lanes.values()),
                           sem=jnp.asarray(sem))
    got = tdg.slot_digests(*(torch.tensor(a) for a in lanes.values()),
                           sem=torch.tensor(sem))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want))


@pytest.mark.parametrize("leaf_width", [8, 5])
@pytest.mark.parametrize("n", [1, 8, 9, 63, 1000, 4097])
def test_digest_levels_match_jax(n, leaf_width):
    """Ragged sizes: n not a multiple of the leaf width, leaf counts not
    a power of two."""
    lanes = top_bit_lanes(n, 10 + n)
    want = jd.digest_levels_from_lanes(
        *(jnp.asarray(a) for a in lanes.values()), leaf_width=leaf_width)
    got = tdg.digest_levels_from_lanes(
        *(torch.tensor(a) for a in lanes.values()), leaf_width=leaf_width)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint64),
                                      np.asarray(w))
    tree = tdg.build_digest_tree(n, leaf_width, got)
    jtree = jd.build_digest_tree(n, leaf_width, want)
    assert_trees_equal(tree, jtree)
    assert tree.values(tree.depth - 1, [0]) == jtree.values(
        jtree.depth - 1, [0])


def test_root_equals_a_numpy_uint64_fold():
    """The root from a fold written here in numpy uint64."""
    n, width = 1000, 8
    lanes = top_bit_lanes(n, 5)
    u = {k: v.view(np.uint64) for k, v in lanes.items()
         if k in ("lt", "val")}
    with np.errstate(over="ignore"):
        idx = np.arange(n, dtype=np.uint64)
        h = mix64_u64(u["lt"] + np.uint64(0x9E3779B97F4A7C15)
                      * (idx + np.uint64(1)))
        h ^= mix64_u64(u["val"] ^ np.uint64(0x94D049BB133111EB))
        h ^= np.where(lanes["tomb"], np.uint64(0xD6E8FEB86659FD93),
                      np.uint64(0))
        h = np.where(lanes["occupied"], mix64_u64(h), np.uint64(0))
        leaves = np.zeros(128, np.uint64)
        leaves[:125] = np.add.reduceat(h, np.arange(0, n, width))
        while len(leaves) > 1:
            leaves = mix64_u64(leaves[0::2] + np.uint64(0x9E3779B97F4A7C15)
                               * leaves[1::2]
                               + np.uint64(0xBF58476D1CE4E5B9))
    got = tdg.digest_levels_from_lanes(
        *(torch.tensor(a) for a in lanes.values()), leaf_width=width)
    assert tdg.build_digest_tree(n, width, got).root == int(leaves[0])


def test_walk_and_coalesce_match_jax():
    rng = np.random.default_rng(6)
    a, b = top_bit_lanes(777, 7), top_bit_lanes(777, 7)
    hit = rng.choice(777, 9, replace=False)
    b["val"][hit] ^= 1
    b["occupied"][hit] = True
    trees = {}
    for name, lanes in (("a", a), ("b", b)):
        trees[name] = (
            tdg.build_digest_tree(777, 8, tdg.digest_levels_from_lanes(
                *(torch.tensor(x) for x in lanes.values()))),
            jd.build_digest_tree(777, 8, jd.digest_levels_from_lanes(
                *(jnp.asarray(x) for x in lanes.values()))))
    (ta, ja), (tb, jb) = trees["a"], trees["b"]
    for kw in ({}, {"fetch_levels": True}):
        runs = []
        for walk, local, remote in (
                (tdg.walk_divergent_leaves, ta, jb),
                (jd.walk_divergent_leaves, ja, tb),
                (jd.walk_divergent_leaves, ja, jb)):
            if kw:
                runs.append(walk(local, None,
                                 fetch_levels=remote.values_levels))
            else:
                runs.append(walk(local, remote.values))
        assert runs[0] == runs[1] == runs[2]
        leaves = runs[0][0]
        assert sorted(set(int(s) // 8 for s in hit)) == sorted(leaves)
        assert tdg.coalesce_leaf_ranges(leaves, 8, 777) == \
            jd.coalesce_leaf_ranges(leaves, 8, 777)
    assert tdg.coalesce_leaf_ranges([97, 96, 5, 4], 8, 777) == \
        ((32, 48), (768, 777))


# --- the model's tree --------------------------------------------------


def both(n_slots=64, node="n", start=BASE):
    return make("jax", node, n_slots, start), make("port", node, n_slots,
                                                    start)


def test_model_digest_tree_matches_jax_and_caches():
    j, p = both(200, "cache")
    for c in (j, p):
        c.put_batch([1, 2, 199], [11, -22, 2 ** 62])
        c.delete_batch([2])
    obs_device.reset()
    t1 = p.digest_tree()
    assert obs_device.op_launches()["digest_tree"] == 1
    assert_trees_equal(t1, j.digest_tree())
    assert p.digest_tree() is t1                      # a hit: no op
    assert obs_device.op_launches()["digest_tree"] == 1
    for c in (j, p):
        c.put_batch([3], [33])                        # the store moved
    t3 = p.digest_tree()
    assert t3 is not t1 and obs_device.op_launches()["digest_tree"] == 2
    assert_trees_equal(t3, j.digest_tree())
    # An in-place write (the ingest commit) drops the tree too.
    with p.ingest():
        p.put_batch([4], [44])
    with j.ingest():
        j.put_batch([4], [44])
    assert_trees_equal(p.digest_tree(), j.digest_tree())
    assert p.store_generation > 0


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_snapshot_tree_loads_seeded_across_packages(saver, tmp_path):
    """A snapshot saved by either package loads in the other (and in its
    own) with its digest tree seeded: the first ``digest_tree()`` builds
    nothing, and equals the saved tree; the cache then drops on a write
    as usual."""
    src = make(saver, "boot")
    src.put_batch(list(range(0, 64, 4)), list(range(16)))
    src.delete_batch([8])
    saved = src.digest_tree()
    path = str(tmp_path / "snap.npz")
    src.save(path)
    assert port_ckpt.load_dense_digest(path)[1:] == \
        jax_ckpt.load_dense_digest(path)[1:]
    obs_device.reset()
    r = port.DenseCrdt.load("boot", path, device="cpu",
                            wall_clock=FakeClock(start=BASE))
    t = r.digest_tree()
    assert obs_device.op_launches()["digest_tree"] == 0
    assert_trees_equal(t, saved)
    j = JaxDense.load("boot", path, wall_clock=FakeClock(start=BASE))
    assert_trees_equal(j._digest_cache[1], saved)     # seeded there too
    r.put_batch([1], [999])
    assert r.digest_tree() is not t
    assert obs_device.op_launches()["digest_tree"] == 1


def test_pre_digest_snapshot_loads_and_rebuilds(tmp_path):
    c = make("port", "old", 32)
    c.put_batch([1, 2], [10, 20])
    path = str(tmp_path / "old.npz")
    port_ckpt.save_dense(c.store, path, node_ids=["old"])
    assert port_ckpt.load_dense_digest(path) is None
    assert jax_ckpt.load_dense_digest(path) is None
    r = port.DenseCrdt.load("old", path, device="cpu",
                            wall_clock=FakeClock(start=BASE))
    obs_device.reset()
    assert_trees_equal(r.digest_tree(), c.digest_tree())
    assert obs_device.op_launches()["digest_tree"] == 2


def test_stale_persisted_tree_is_not_seeded(tmp_path):
    """A tree whose key no longer matches the lanes (a snapshot edited
    after its tree was taken) is ignored and rebuilt."""
    c = make("port", "s", 32)
    c.put_batch([1], [10])
    path = str(tmp_path / "s.npz")
    tree = c.digest_tree()
    port_ckpt.save_dense(c.store, path, node_ids=["s"],
                         digest=(tree, c.canonical_time.logical_time - 1, 0))
    r = port.DenseCrdt.load("s", path, device="cpu")
    assert r._digest_cache is None


# --- ranged packs --------------------------------------------------------


def loaded(n_slots=96):
    j, p = both(n_slots, "c")
    for c in (j, p):
        c.put_batch(list(range(0, n_slots - 6, 3)),
                    list(range(100, 100 + n_slots - 6, 3)))
        c.delete_batch([6, 12])
    return j, p


@pytest.mark.parametrize("ranges", [
    ((0, 96),), ((0, 40),), ((40, 96),), ((5, 13), (50, 51)),
    ((50, 51), (5, 13)), ((0, 20), (10, 30)), ((3, 3), (90, 96)),
    ((7, 7),), ()])
@pytest.mark.parametrize("since", [None, 3])
def test_ranged_pack_matches_jax(ranges, since):
    """Spans that cut leaves, unsorted, overlapping (the union), empty;
    with and without a watermark."""
    j, p = loaded()
    bound = None
    if since is not None:
        bound = [j.canonical_time, p.canonical_time]
        for c in (j, p):
            c.put_batch([since, since + 40], [1, 2])
    jp_, jids = j.pack_since(bound and bound[0], ranges=ranges)
    obs_device.reset()
    pp, pids = p.pack_since(bound and bound[1], ranges=ranges)
    assert obs_device.op_launches()["range_delta_mask"] == 1
    assert jids == pids
    assert packed_bytes(jp_) == packed_bytes(pp)
    # The cache hands the same pack back; another span set is another key.
    assert p.pack_since(bound and bound[1], ranges=ranges)[0] is pp


def test_whole_store_span_equals_the_unranged_pack():
    _, p = loaded()
    full, fids = p.pack_since(None)
    ranged, rids = p.pack_since(None, ranges=((0, 96),))
    assert fids == rids and packed_bytes(full) == packed_bytes(ranged)
    assert ranged is not full          # a separate cache entry


@pytest.mark.parametrize("receiver", ["port", "jax"])
def test_subrange_packs_union_to_full_convergence(receiver):
    src = make("port", "src", 128)
    src.put_batch(list(range(128)), list(range(1000, 1128)))
    src.delete_batch([3, 77])
    via_full = make(receiver, "rf", 128)
    via_ranges = make(receiver, "rr", 128)
    via_full.merge_packed(*src.pack_since(None))
    for span in ((0, 40), (40, 128)):
        via_ranges.merge_packed(*src.pack_since(None, ranges=(span,)))
    assert_replicated_equal(via_full, via_ranges)
    assert via_ranges.digest_tree().root == src.digest_tree().root


@pytest.mark.parametrize("ranges", [((0, 97),), ((-1, 4),), ((5, 4),)])
def test_range_out_of_bounds_raises_like_jax(ranges):
    errs = []
    for c in loaded():
        with pytest.raises(ValueError) as info:
            c.pack_since(None, ranges=ranges)
        errs.append(str(info.value))
    assert errs[0] == errs[1]


def test_span_mask_matches_the_membership_matrix():
    rng = np.random.default_rng(8)
    n = 1000
    los = rng.integers(0, n, 50)
    his = np.minimum(los + rng.integers(0, 40, 50), n)
    los[:3], his[:3] = 0, [0, n, 5]
    idx = np.arange(n)
    want = ((idx[None] >= los[:, None]) & (idx[None] < his[:, None])).any(0)
    got = td.span_mask(n, torch.tensor(los), torch.tensor(his))
    np.testing.assert_array_equal(got.numpy(), want)


# --- the anti-entropy rounds -------------------------------------------


PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def report_fields(r):
    return (r.rounds, r.digests, r.ranges, r.pushed_rows, r.pulled_rows,
            r.payload_bytes, r.digest_bytes, r.total_bytes)


def run_pair(kinds, script, sync_mod):
    a = make(kinds[0], "a", 256)
    b = make(kinds[1], "b", 256)
    return a, b, script(a, b, sync_mod)


def walk_script(a, b, sync):
    """test_merkle.py's report and walk scenarios: converge by a full
    packed round, a clean walk, one diverged slot, a delete on each
    side, a whole-leaf write."""
    ids = list(range(0, 256, 2))
    a.put_batch(ids, [i * 10 for i in ids])
    p, i = a.pack_since(None)
    b.merge_packed(p, i)
    out = [report_fields(sync.sync_merkle(a, b))]
    b.put_batch([37], [999])
    out.append(report_fields(sync.sync_merkle(a, b)))
    a.delete_batch([2, 200])
    b.delete_batch([100])
    b.put_batch(list(range(64, 72)), [7] * 8)
    out.append(report_fields(sync.sync_merkle(a, b)))
    out.append(report_fields(sync.sync_merkle(b, a)))
    return out


@pytest.mark.parametrize("sync_pkg", ["port", "jax"])
@pytest.mark.parametrize("kinds", PAIRS)
def test_sync_merkle_matches_a_jax_pair(kinds, sync_pkg):
    sync = SYNCS[sync_pkg]
    ja, jb, want = run_pair(("jax", "jax"), walk_script, jax_sync)
    a, b, got = run_pair(kinds, walk_script, sync)
    assert got == want
    assert got[0][:3] == (1, 1, ())                  # clean: one probe
    assert got[1][2] == ((32, 40),) and got[1][4] >= 1
    for x, y in ((a, ja), (b, jb)):
        assert_stores_equal(x, y)
    assert a.digest_tree().root == b.digest_tree().root
    assert_replicated_equal(a, b)


@pytest.mark.parametrize("kinds", PAIRS)
def test_sync_merkle_traffic_follows_divergence(kinds):
    a = make(kinds[0], "a", 256)
    b = make(kinds[1], "b", 256)
    a.put_batch(list(range(256)), list(range(256)))
    p, i = a.pack_since(None)
    b.merge_packed(p, i)
    clean = port_sync.sync_merkle(a, b)
    assert clean.ranges == () and clean.payload_bytes == 0
    assert clean.rounds == 1 and clean.total_bytes == 16
    b.put_batch([100], [-1])
    diverged = port_sync.sync_merkle(a, b)
    assert len(diverged.ranges) == 1 and diverged.pulled_rows >= 1
    full = port_sync._packed_nbytes(b.pack_since(None)[0])
    assert diverged.total_bytes < 0.10 * full
    assert_replicated_equal(a, b)


@pytest.mark.parametrize("sync_pkg", ["port", "jax"])
def test_geometry_mismatch_raises_like_jax(sync_pkg):
    errs = []
    for kinds in (("jax", "jax"), ("port", "jax"), ("jax", "port"),
                  ("port", "port")):
        a = make(kinds[0], "a", 64)
        b = make(kinds[1], "b", 128)
        with pytest.raises(ValueError, match="geometry") as info:
            SYNCS[sync_pkg].sync_merkle(a, b)
        errs.append(str(info.value))
    assert len(set(errs)) == 1


def packed_script(a, b, sync):
    a.put_batch([1, 2, 3], [10, 20, 30])
    b.put_batch([3, 4], [40, 50])
    w1 = sync.sync_packed(a, b)
    a.put_batch([5], [-5])
    b.delete_batch([1])
    w2 = sync.sync_packed(a, b, since=w1)
    sync.sync_packed(b, a, since=None)
    return [w1.logical_time, w2.logical_time]


@pytest.mark.parametrize("sync_pkg", ["port", "jax"])
@pytest.mark.parametrize("kinds", PAIRS)
def test_sync_packed_matches_a_jax_pair(kinds, sync_pkg):
    ja, jb, want = run_pair(("jax", "jax"), packed_script, jax_sync)
    a, b, got = run_pair(kinds, packed_script, SYNCS[sync_pkg])
    assert got == want
    for x, y in ((a, ja), (b, jb)):
        assert_stores_equal(x, y)
    assert_replicated_equal(a, b)
