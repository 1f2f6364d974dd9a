"""The port's CUDA kernels on the card, against their plain versions
and against the same op script on the host, bit for bit (integer
lanes: tolerance 0), at small odd shapes the main path never gives
them (n_slots not a multiple of the block, one row, no rows).

These tests need a CUDA device and skip without one. This file
imports neither jax nor the JAX package, so on a machine without jax
run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import crdt_tpu_torch as port
from crdt_tpu_torch import parallel
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import (fanin_kernel, ingest_kernel, probe,
                                stream_kernel)
from crdt_tpu_torch.ops import split as ts

from torch_probe_cases import CHUNKS, SCALARS as CASE_SCALARS, \
    expected, probe_case_lanes
from torch_stream_cases import CLOSED_CASES, LOCAL, WALL, closed_inputs, \
    exact_flags
from torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda

BASE = 1_700_000_000_000 << 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


def lanes(rng, n, rows):
    occ = rng.random(n) < 0.5
    store = dict(
        lt=np.where(occ, BASE + rng.integers(0, 8, n), 0),
        node=np.where(occ, rng.integers(0, 4, n), 0),
        val=rng.integers(-2 ** 62, 2 ** 62, n),
        mod_lt=np.where(occ, BASE + 99, 0),
        mod_node=np.where(occ, 1, 0), occupied=occ,
        tomb=occ & (rng.random(n) < 0.3))
    cs = dict(lt=BASE + rng.integers(0, 8, (rows, n)),
              node=rng.integers(0, 4, (rows, n)).astype(np.int32),
              val=rng.integers(-2 ** 62, 2 ** 62, (rows, n)),
              tomb=rng.random((rows, n)) < 0.3,
              valid=rng.random((rows, n)) < 0.7)
    return store, cs


def lane_bytes(packed):
    """A packed delta's lanes as bytes; the optional ``sem`` lane stays
    None where absent."""
    return [None if lane is None else lane.tobytes() for lane in packed]


def on(device, store, cs):
    return (td.store_from_numpy(store, device),
            td.DenseChangeset(**{k: torch.tensor(v, device=device)
                                 for k, v in cs.items()}))


def plant_row_ties(cs, rows):
    """Rows 1 and ``rows - 1`` repeat row 0's (lt, node) on every 3rd
    slot with payloads of their own: the lowest row's must land."""
    for row in (1, rows - 1):
        cs["lt"][row, ::3] = cs["lt"][0, ::3]
        cs["node"][row, ::3] = cs["node"][0, ::3]
        cs["val"][row, ::3] = cs["val"][0, ::3] + 1 + row
        cs["tomb"][row, ::3] = ~cs["tomb"][0, ::3]
    cs["valid"][[0, 1, rows - 1], ::3] = True


@pytest.mark.parametrize("n,rows,ties", [(5000, 3, False), (257, 1, False),
                                         (1000, 0, False),
                                         (40_000, 64, False),
                                         (4097, 9, True), (40_000, 64, True)])
def test_fanin_kernel_matches_plain(cuda, n, rows, ties):
    store, cs = lanes(np.random.default_rng(n + rows), n, rows)
    if ties:
        plant_row_ties(cs, rows)
    obs_device.reset()
    k = fanin_kernel.fanin_batch(*on(cuda, store, cs), BASE + 3, 2,
                                 1_700_000_010_000)
    assert obs_device.launches()["fanin_batch"] == 1
    p = fanin_kernel.fanin_batch(*on("cpu", store, cs), BASE + 3, 2,
                                 1_700_000_010_000)
    for a, b in zip(list(k[0]) + list(k[1]), list(p[0]) + list(p[1])):
        assert torch.equal(a.cpu(), b)


def test_fanin_kernel_block_table_matches_plain(cuda):
    """One launch of ``csrc/fanin_batch.cu`` over a table of two merges,
    each a column block read in place at the full row stride, computes
    each block's join."""
    n, rows = 6000, 11
    store, cs = lanes(np.random.default_rng(7), 2 * n, rows)
    plant_row_ties(cs, rows)
    s, c = on(cuda, store, cs)
    stores = [td.DenseStore(*(x[k * n:(k + 1) * n] for x in s))
              for k in range(2)]
    css = [td.DenseChangeset(*(x[:, k * n:(k + 1) * n] for x in c))
           for k in range(2)]
    canonical = torch.tensor(BASE + 3, device=cuda)
    obs_device.reset()
    got = fanin_kernel.fanin_cuda_many(stores, css, canonical, 2)
    assert obs_device.launches()["fanin_batch"] == 1
    for st, cb, g in zip(stores, css, got):
        want = fanin_kernel.fanin_join_reference(st, cb, canonical, 2)
        for a, b in zip(g, want):
            assert torch.equal(a, b)


# (n, rows, valid): row counts that are not a multiple of the kernel's
# batch of 4 rows, slot counts either side of its 256-slot block, every
# entry invalid or valid; "blocks" a two-entry table of column blocks
# read in place at the full row stride; "no-slots" a 0-slot store.
SEEN_CASES = [*((n, rows, "some") for rows in (1, 3, 5, 11)
                for n in (1, 255, 257, 6000)),
              (4097, 9, "none"), (4097, 9, "all"), (6000, 11, "blocks"),
              (0, 5, "no-slots")]


@pytest.mark.parametrize("n,rows,valid", SEEN_CASES)
def test_fanin_kernel_counts_seen(cuda, n, rows, valid):
    """K1's ninth output is each merge's count of valid entries,
    ``cs.valid.sum()``; the other eight stay the plain join's."""
    blocks = valid == "blocks"
    store, cs = lanes(np.random.default_rng(16 * n + rows),
                      2 * n if blocks else n, rows)
    if valid in ("none", "all"):
        cs["valid"][:] = valid == "all"
    s, c = on(cuda, store, cs)
    if blocks:
        stores = [td.DenseStore(*(x[k * n:(k + 1) * n] for x in s))
                  for k in range(2)]
        css = [td.DenseChangeset(*(x[:, k * n:(k + 1) * n] for x in c))
               for k in range(2)]
    else:
        stores, css = [s], [c]
    canonical = torch.tensor(BASE + 3, device=cuda)
    obs_device.reset()
    got = fanin_kernel.fanin_cuda_many(stores, css, canonical, 2)
    assert obs_device.launches()["fanin_batch"] == (1 if n else 0)
    for st, cb, g in zip(stores, css, got):
        want = fanin_kernel.fanin_join_reference(st, cb, canonical, 2)
        assert len(g) == len(want) == 9
        assert g[8].dtype == torch.int64
        assert int(g[8]) == int(cb.valid.sum()) == int(want[8])
        for a, b in zip(g[:8], want[:8]):
            assert torch.equal(a, b)


def test_ingest_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    store, _ = lanes(rng, 3000, 0)
    slots = np.full(1024, 3000, np.int64)
    slots[:700] = rng.choice(3000, 700, replace=False)
    rows = [slots, BASE + rng.integers(0, 99, 1024),
            rng.integers(0, 99, 1024), rng.random(1024) < 0.5]
    obs_device.reset()
    k = ingest_kernel.ingest_scatter(
        td.store_from_numpy(store, cuda),
        *(torch.tensor(a, device=cuda) for a in rows), 3)
    assert obs_device.launches()["ingest_scatter"] == 1
    p = ingest_kernel.ingest_scatter(td.store_from_numpy(store, "cpu"),
                                     *(torch.tensor(a) for a in rows), 3)
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)


def ingest_case_slots(rng, layout, n):
    """Unique slots of one K2 flush, sentinels (``n``) included:
    scattered as the main path's; contiguous runs of 1-13 slots that
    start and end inside a 4-slot word, so the 1-B lanes' words hold
    slots outside the flush; and sentinels spread through the rows, as
    the sharded commit gives them."""
    if layout == "scattered":
        return rng.choice(n, 1500, replace=False)
    if layout == "runs mid-word":
        starts = np.sort(rng.choice(n // 16, 120, replace=False)) * 16
        runs = [s + 1 + np.arange(rng.integers(1, 14)) for s in starts]
        return np.concatenate(runs)
    slots = rng.choice(n, 1500, replace=False)
    slots[rng.random(1500) < 0.4] = n
    return slots


@pytest.mark.parametrize("order", ["sorted", "shuffled", "reversed"])
@pytest.mark.parametrize("layout", ["scattered", "runs mid-word",
                                    "sentinels spread"])
def test_ingest_kernel_any_row_order_matches_plain(cuda, layout, order):
    """K2 is bit-exact for unique slots in any row order: its speed, not
    its result, depends on slot order."""
    n = 20_003
    rng = np.random.default_rng(sum(map(ord, layout + order)))
    store, _ = lanes(rng, n, 0)
    slots = ingest_case_slots(rng, layout, n)
    rows = len(slots)
    at = {"sorted": np.argsort(slots, kind="stable"),
          "shuffled": rng.permutation(rows),
          "reversed": np.argsort(slots, kind="stable")[::-1]}[order]
    padded = 1 << (rows - 1).bit_length()
    lanes_np = [np.full(padded, n, np.int64), np.zeros(padded, np.int64),
                np.zeros(padded, np.int64), np.zeros(padded, bool)]
    lanes_np[0][:rows] = slots[at]
    lanes_np[1][:rows] = BASE + rng.integers(0, 1 << 30, rows)
    lanes_np[2][:rows] = rng.integers(-2 ** 62, 2 ** 62, rows)
    lanes_np[3][:rows] = rng.random(rows) < 0.5
    obs_device.reset()
    k = ingest_kernel.ingest_scatter(
        td.store_from_numpy(store, cuda),
        *(torch.tensor(a, device=cuda) for a in lanes_np), 3)
    torch.cuda.synchronize()
    assert obs_device.launches()["ingest_scatter"] == 1
    p = ingest_kernel.ingest_scatter(td.store_from_numpy(store, "cpu"),
                                     *(torch.tensor(a) for a in lanes_np), 3)
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k", [5, 300, 2000])
def test_columnar_merges_on_card_match_host(cuda, k):
    """`merge_packed` (the sparse join below n_slots / 4 rows, the wide
    join from there), `merge_and_repack` and `merge_json` on a card
    replica against a host replica: the sparse join's padding rows sit
    at the ``n_slots`` sentinel and must never be indexed (on the card
    an out-of-range index is a device-side assert, not a dropped
    write)."""
    n = 4099
    out = []
    for device in (cuda, "cpu"):
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        src = port.DenseCrdt("a0", n, device="cpu", wall_clock=tick.__next__)
        rcv = port.DenseCrdt("r1", n, device=device,
                             wall_clock=tick.__next__)
        rng = np.random.default_rng(k)
        src.put_batch(rng.choice(n, k, replace=False),
                      rng.integers(0, 1 << 40, k))
        rcv.put_batch(rng.choice(n, 900, replace=False),
                      rng.integers(0, 9, 900))
        src.put_batch(rng.choice(n, k // 2 + 1, replace=False), 7)
        since = rcv.canonical_time
        packed, ids = src.pack_since()
        assert packed.k == k or packed.k > k // 2
        rcv.merge_packed(packed, ids)
        relay, _ = rcv.merge_and_repack(*src.pack_since(), since)
        rcv.merge_json(src.to_json())
        torch.cuda.synchronize()
        out.append((rcv, relay))
    (a, ra), (b, rb) = out
    for x, y in zip(a.store, b.store):
        assert torch.equal(x.cpu(), y)
    assert str(a.canonical_time) == str(b.canonical_time)
    assert lane_bytes(ra) == lane_bytes(rb)


def test_kernel_wrapper_refuses_bad_lanes(cuda):
    store, cs = lanes(np.random.default_rng(2), 64, 2)
    s, c = on(cuda, store, cs)
    with pytest.raises(ValueError, match="valid"):
        fanin_kernel.fanin_batch(s, c._replace(valid=c.valid.int()), 0, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fanin_kernel.fanin_batch(
            s, c._replace(lt=c.lt.t().contiguous().t()), 0, 0, 0)


def test_dense_crdt_on_card_matches_host(cuda):
    """The same op script on a card replica (kernels) and a host
    replica (plain versions) leaves identical lanes and clocks."""
    replicas = []
    for device in (cuda, "cpu"):
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        c = port.DenseCrdt("n1", 3001, device=device,
                           wall_clock=tick.__next__)
        rng = np.random.default_rng(3)
        with c.ingest(auto_flush_rows=100):
            for _ in range(5):
                c.put_batch(rng.choice(3001, 60, replace=False),
                            rng.integers(0, 1 << 40, 60))
                c.delete_batch(rng.choice(3001, 7, replace=False))
        _, cs = lanes(rng, 3001, 5)
        cs["lt"] += 50 << 16
        with c.pipelined():
            c.merge(td.DenseChangeset(**{k: torch.tensor(v)
                                         for k, v in cs.items()}),
                    ["n0", "n2", "n3", "n4"])
        replicas.append(c)
    a, b = replicas
    for x, y in zip(a.store, b.store):
        assert torch.equal(x.cpu(), y)
    assert str(a.canonical_time) == str(b.canonical_time)
    assert a.to_json() == b.to_json()


def split_lanes(rng, cs, narrow, map_len):
    """Split wire lanes of ``cs`` (host tensors) with payloads past int32
    and malformed sentinels (hi == NEG_HI, lo != 0) sprinkled in, and a
    random node map."""
    wide = td.DenseChangeset(**{k: torch.tensor(v) for k, v in cs.items()})
    wide = wide._replace(val=torch.where(
        torch.tensor(rng.random(wide.val.shape) < 0.1),
        wide.val, wide.val % 1000))
    scs = ts.split_changeset_narrow(wide)[0] if narrow \
        else ts.split_changeset(wide)
    bad = torch.tensor(rng.random(scs.hi.shape) < 0.02)
    scs = scs._replace(hi=torch.where(bad, ts.NEG_HI, scs.hi),
                       lo=torch.where(bad, 9, scs.lo.long()).to(torch.uint32))
    node_map = torch.tensor(rng.integers(0, 6, map_len), dtype=torch.int32)
    return scs, node_map


@pytest.mark.parametrize("n,rows,narrow,value_width,map_len", [
    (5000, 3, False, 64, 4), (257, 1, True, 32, 4), (1000, 0, False, 32, 1),
    (40_000, 64, False, 32, 7), (3001, 9, True, 64, 1 << 15)])
def test_fanin_split_kernel_matches_plain(cuda, n, rows, narrow, value_width,
                                          map_len):
    rng = np.random.default_rng(n + rows)
    store, cs = lanes(rng, n, rows)
    scs, node_map = split_lanes(rng, cs, narrow, map_len)
    args = (BASE + 3, 2, 1_700_000_010_000)
    obs_device.reset()
    k = fanin_kernel.fanin_split(
        td.store_from_numpy(store, cuda), type(scs)(*(x.to(cuda)
                                                      for x in scs)),
        node_map.to(cuda), *args, value_width=value_width)
    assert obs_device.launches()["fanin_split"] == (1 if n else 0)
    p = fanin_kernel.fanin_split(td.store_from_numpy(store, "cpu"), scs, node_map,
                                 *args, value_width=value_width)
    for a, b in zip(list(k[0]) + list(k[1]) + list(k[2:]),
                    list(p[0]) + list(p[1]) + list(p[2:])):
        assert torch.equal(a.cpu(), b)


STREAM_SHAPES = [("random", 5000, 3, 4), ("random", 257, 1, 1),
                 ("random", 1000, 0, 2), ("random", 4099, 8, 5),
                 ("random", 3001, 13, 3), ("random", 4097, 13, 128)] + [
    (case, 4097, rows, n_chunks) for case in CLOSED_CASES
    for rows in (1, 13) for n_chunks in (1, 5, 128)]


@pytest.mark.parametrize("case,n,rows,n_chunks", STREAM_SHAPES)
@pytest.mark.parametrize("guards", ["exact", "fast"])
def test_fanin_stream_kernel_matches_plain(cuda, case, n, rows, n_chunks,
                                           guards):
    """The closed-form kernel against the chunk walk: random lanes with
    local-node records past a drifting wall, and the planted cases of
    `torch_stream_cases` at an odd slot count."""
    if case == "random":
        rng = np.random.default_rng(n + rows + n_chunks)
        store, cs = lanes(rng, n, rows)
        cs["node"][:, ::5] = 2               # local-node records: dup
        canonical, local = BASE + 2, 2
        wall = (BASE >> 16) - port.MAX_DRIFT + 1   # chunk 2 on drifts
    else:
        store, cs, canonical = closed_inputs(case, rows, n_chunks, n=n)
        local, wall = LOCAL, WALL
    obs_device.reset()
    led = obs_device.default_ledger()
    before = led.as_dict()
    k = stream_kernel.fanin_stream(*on(cuda, store, cs), canonical, local,
                                   wall, n_chunks=n_chunks, guards=guards)
    assert obs_device.launches()["fanin_stream"] == 1
    # The ledger names the route: the Pallas entry for a kernel launch.
    route = "pallas.pallas_fanin_stream" if torch.device(cuda).type == \
        "cuda" else "dense.fanin_stream"
    assert {n: v - before.get(n, 0) for n, v in led.as_dict().items()
            if v != before.get(n, 0)} == {route: 1}
    p = stream_kernel.fanin_stream(*on("cpu", store, cs), canonical, local,
                                   wall, n_chunks=n_chunks, guards=guards)
    for a, b in zip(list(k[0]) + list(k[1]), list(p[0]) + list(p[1])):
        assert torch.equal(a.cpu(), b)
    if case != "random" and guards == "exact":
        assert (bool(k[1].any_dup), bool(k[1].any_drift)) == \
            exact_flags(case, n_chunks)


def test_split_interchange_on_card_matches_host(cuda):
    """export_split_delta -> merge_split (unpipelined, coarse and exact
    windows) on a card replica and a host replica: identical lanes,
    clocks, and the same duplicate-node raise."""
    results = []
    for device in (cuda, "cpu"):
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        peer = port.DenseCrdt("p0", 3001, device=device,
                              node_ids=["a", "p0"], wall_clock=tick.__next__)
        rng = np.random.default_rng(4)
        with peer.ingest(auto_flush_rows=100):
            peer.put_batch(rng.choice(3001, 300, replace=False),
                           rng.integers(0, 1 << 40, 300))
        scs, ids = peer.export_split_delta()
        c = port.DenseCrdt("r0", 3001, device=device,
                           node_ids=["b", "r0"], wall_clock=tick.__next__)
        c.merge_split(scs, ids)
        with c.pipelined():
            c.merge_split(scs, ids)
        # A record carrying this replica's own id, 1 s past its clock.
        own_ids = c.export_delta()[1]
        dup = td.DenseChangeset(*(torch.zeros((1, 3001), dtype=dt)
                                  for dt in td.CHANGESET_DTYPES.values()))
        dup.valid[0, 9] = True
        dup.node[0, 9] = own_ids.index("r0")
        dup.lt[0, 9] = c.canonical_time.logical_time + (1000 << 16)
        with pytest.raises(port.DuplicateNodeException):
            with c.pipelined(exact_guards=True):
                peer.put_batch([7], [70])
                c.merge_split(*peer.export_split_delta())
                c.merge_split(ts.split_changeset(dup), own_ids)
        results.append(c)
    a, b = results
    for x, y in zip(a.store, b.store):
        assert torch.equal(x.cpu(), y)
    assert str(a.canonical_time) == str(b.canonical_time)


@pytest.mark.parametrize("shape", [(2, 2), (3, 1), (5, 4)])
def test_sharded_step_matches_plain(cuda, shape):
    """K1p on a mesh that repeats the card, more blocks than devices:
    the blocks' K1 joins in one launch per device (two for the 20 blocks
    of (5, 4), past the kernel's 16-entry table) and the combine against
    the plain per-block join, bit for bit, at odd shard widths, with
    ties across the replica-shard boundary."""
    n, rows = shape[1] * 12_289, 7
    store, cs = lanes(np.random.default_rng(sum(shape)), n, rows)
    cs["lt"][4, ::3] = cs["lt"][0, ::3]
    cs["node"][4, ::3] = cs["node"][0, ::3]
    cs["valid"][[0, 4], ::3] = True
    args = (BASE + 3, 2, 1_700_000_010_000)
    mesh = parallel.make_fanin_mesh(*shape, [cuda] * int(np.prod(shape)))
    outs = []
    for reference in (False, True):
        s, c = on(cuda, store, cs)
        obs_device.reset()
        outs.append(parallel.make_sharded_fanin(mesh, reference=reference)(
            parallel.shard_store(s, mesh), parallel.shard_changeset(c, mesh),
            *args))
        per_device = -(-shape[0] * shape[1] // fanin_kernel.MAX_ENTRIES)
        assert obs_device.launches()["fanin_batch_sharded"] == \
            (0 if reference else per_device)
    (k_store, k_res), (p_store, p_res) = outs
    for k_row, p_row in zip(k_store.blocks, p_store.blocks):
        for a, b in zip(k_row, p_row):
            assert a.lt.is_cuda
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    for x, y in zip(k_res, p_res):
        assert torch.equal(x, y)
    u_store, u_res = fanin_kernel.fanin_batch(*on(cuda, store, cs), *args)
    for x, y in zip(parallel.gather_store(k_store), u_store):
        assert torch.equal(x, y)
    assert torch.equal(k_res.win, u_res.win)


def test_sharded_dense_crdt_on_card_matches_host(cuda):
    """The same op script on a sharded card replica (K1p, K2 per shard
    and copy) and on a host one: identical lanes, clocks, JSON and the
    same duplicate-node raise."""
    results = []
    for devices in ([cuda] * 4, ["cpu"] * 4):
        mesh = parallel.make_fanin_mesh(2, 2, devices)
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        c = port.ShardedDenseCrdt("n1", 6002, mesh,
                                  wall_clock=tick.__next__)
        assert c.device.type == torch.device(devices[0]).type
        rng = np.random.default_rng(5)
        obs_device.reset()
        with c.ingest(auto_flush_rows=100):
            for _ in range(3):
                c.put_batch(rng.choice(6002, 60, replace=False),
                            rng.integers(0, 1 << 40, 60))
        _, cs = lanes(rng, 6002, 5)
        cs["lt"] += 50 << 16
        ids = ["n0", "n2", "n3", "n4"]
        with c.pipelined():
            c.merge(td.DenseChangeset(**{k: torch.tensor(v)
                                         for k, v in cs.items()}), ids)
        c.merge(*c.export_delta())
        dup = td.DenseChangeset(*(torch.zeros((1, 6002), dtype=dt)
                                  for dt in td.CHANGESET_DTYPES.values()))
        dup.valid[0, 9] = True
        dup.lt[0, 9] = c.canonical_time.logical_time + (1000 << 16)
        with pytest.raises(port.DuplicateNodeException):
            with c.pipelined(exact_guards=True):
                c.merge(dup, ["n1"])
        if devices[0] is cuda:
            # One K1p launch per merge on the one card; K2 per copy.
            assert obs_device.launches()["fanin_batch_sharded"] == 3
            assert obs_device.launches()["ingest_scatter"] == 2 * 4
        results.append(c)
    a, b = results
    for x, y in zip(a.store, b.store):
        assert torch.equal(x.cpu(), y)
    assert str(a.canonical_time) == str(b.canonical_time)
    assert a.to_json() == b.to_json()


def probe_lanes(rng, n, rows, narrow=False):
    """Split lanes and a split store for the probes: close keys (ties),
    planted row ties, invalid and malformed sentinels, carrying ``lo``
    words, whole-range ``hi`` words and node words near int16's top (so
    the sums wrap), int8 tombs of both signs."""
    hi = ((BASE >> 32) + rng.integers(0, 3, (rows, n))).astype(np.int32)
    hi[:, ::3] = rng.integers(-2 ** 31, 2 ** 31, (rows, len(hi[0, ::3])))
    lo = rng.choice(np.array([0, 1 << 16, 0xFFFF0000, 0xFFFFFFFF],
                             np.uint32), (rows, n))
    node = rng.integers(1, 9, (rows, n)).astype(np.int16)
    node[:, ::4] = rng.integers(30_000, 2 ** 15, (rows, len(node[0, ::4])))
    if rows > 1:
        for a in (hi, lo, node):
            a[1, ::7] = a[0, ::7]
    invalid = rng.random((rows, n)) < 0.2
    hi[invalid], lo[invalid], node[invalid] = ts.NEG_HI, 0, ts.I16_NEG
    hi[-1, 11::41], lo[-1, 11::41] = ts.NEG_HI, 9
    vhi = rng.integers(-2 ** 31, 2 ** 31, (rows, n)).astype(np.int32)
    tomb = rng.integers(-128, 128, (rows, n)).astype(np.int8)
    if narrow:
        cs = ts.NarrowSplitChangeset(hi, lo, node, vhi, tomb)
    else:
        cs = ts.SplitChangeset(hi, lo, node, vhi, rng.integers(
            0, 2 ** 32, (rows, n)).astype(np.uint32), tomb)
    st = {f: rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
          for f in ts.SplitStore._fields}
    for f in ("lo", "val_lo", "mod_lo"):
        st[f] = st[f].view(np.uint32)
    empty = rng.random(n) < 0.3
    st["hi"][empty], st["lo"][empty] = ts.NEG_HI, 0
    st["hi"][::10], st["lo"][::10] = hi[0, ::10], lo[0, ::10]
    st["node"][::10] = node[0, ::10]
    return ts.SplitStore(**st), cs


def probe_on(device, st, cs):
    return (type(st)(*(torch.tensor(x, device=device) for x in st)),
            type(cs)(*(torch.tensor(x, device=device) for x in cs)))


SCALARS = probe.probe_scalars(BASE + (5 << 16), 3, BASE + (9 << 16) + 0xFFFF)


@pytest.mark.parametrize("name,n,rows,n_chunks", [
    ("probe_join", 5000, 3, None), ("probe_join", 257, 1, None),
    ("probe_join", 40_001, 9, None), ("probe_copy", 5000, 3, None),
    ("probe_copy", 257, 1, None), ("probe_copy", 40_001, 9, None),
    ("probe_stream_noguard", 5000, 3, 5),
    ("probe_stream_noguard", 257, 1, 1),
    ("probe_stream_noguard", 40_001, 9, 3)])
def test_probe_kernels_match_plain(cuda, name, n, rows, n_chunks):
    """P1a, P1b and P1c at odd n (not a multiple of the block or of the
    TPU tile) and odd row counts; 9 rows end P1c's pass on a batch of
    loads that is not full."""
    st, cs = probe_lanes(np.random.default_rng(n + rows), n, rows)
    fn = getattr(probe, name)
    args = (SCALARS,) if n_chunks is None else (SCALARS, n_chunks)
    obs_device.reset()
    k = fn(*probe_on(cuda, st, cs), *args)
    assert obs_device.launches()[name] == 1
    p = fn(*probe_on("cpu", st, cs), *args)
    for a, b in zip(list(k[0]) + [k[1]], list(p[0]) + [p[1]]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n_chunks", CHUNKS)
@pytest.mark.parametrize("rows", [3, 8, 13])
def test_probe_stream_noguard_closed_form_kernel_matches_chunk_walk(
        cuda, rows, n_chunks):
    """P1c's closed form on the card against the chunk walk at the
    planted inputs of ``torch_probe_cases`` (an odd slot count): all ten
    outputs, and each planted column's outcome."""
    st, cs = probe_case_lanes(rows, n_chunks, n=4097)
    obs_device.reset()
    k = probe.probe_stream_noguard(*probe_on(cuda, st, cs), CASE_SCALARS,
                                   n_chunks)
    assert obs_device.launches()["probe_stream_noguard"] == 1
    p = probe.probe_stream_noguard_reference(*probe_on("cpu", st, cs),
                                             CASE_SCALARS, n_chunks)
    for a, b in zip(list(k[0]) + [k[1]], list(p[0]) + [p[1]]):
        assert torch.equal(a.cpu(), b)
    for col, (won_any, won_last, row) in expected(n_chunks).items():
        assert bool(k[1][col]) == won_any, col
        assert (int(k[0].mod_hi[col]) == CASE_SCALARS[5]) == won_last, col
        want = cs.val_hi[row, col] if row >= 0 else st.val_hi[col]
        assert int(k[0].val_hi[col]) == int(want), col


@pytest.mark.parametrize("model", ["dense", "sharded"])
def test_put_batch_repeated_slots_on_card_keep_the_last_entry(cuda, model):
    """One ``put_batch`` outside ``ingest()`` with 20,000 entries on 300
    slots and mixed tombs: on the card every lane of a slot comes from
    its last entry, as on the host. Without the host-side last-wins
    dedup each lane's indexed write could keep another entry."""
    n = 5000
    rng = np.random.default_rng(9)
    slots = rng.integers(0, 300, 20_000)
    vals = rng.integers(-2 ** 40, 2 ** 40, len(slots))
    tombs = rng.random(len(slots)) < 0.5
    replicas = []
    for device in (cuda, "cpu"):
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        if model == "dense":
            c = port.DenseCrdt("n1", n, device=device,
                               wall_clock=tick.__next__)
        else:
            mesh = parallel.make_fanin_mesh(2, 2, [device] * 4)
            c = port.ShardedDenseCrdt("n1", n, mesh,
                                      wall_clock=tick.__next__)
        c.put_batch(slots, vals, tombs=tombs)
        replicas.append(c)
    a, b = replicas
    for x, y in zip(a.store, b.store):
        assert torch.equal(x.cpu(), y)
    last = {s: i for i, s in enumerate(slots.tolist())}
    at, idx = np.array(list(last.values())), np.array(list(last))
    assert np.array_equal(a.store.val.cpu().numpy()[idx], vals[at])
    assert np.array_equal(a.store.tomb.cpu().numpy()[idx], tombs[at])


@pytest.mark.parametrize("n,rows,narrow", [(5000, 16, False),
                                           (40_001, 48, False),
                                           (257, 48, True),
                                           (5000, 32, True)])
def test_probe_copy_batch_kernel_matches_plain(cuda, n, rows, narrow):
    """P2 in groups of 16 rows, wide and narrow, at odd n; the wrapper
    refuses rows that are not whole groups."""
    st, cs = probe_lanes(np.random.default_rng(n + rows), n, rows, narrow)
    obs_device.reset()
    k = probe.probe_copy_batch(*probe_on(cuda, st, cs))
    assert obs_device.launches()["probe_copy_batch"] == 1
    p = probe.probe_copy_batch(*probe_on("cpu", st, cs))
    for a, b in zip(list(k[0]) + [k[1]], list(p[0]) + [p[1]]):
        assert torch.equal(a.cpu(), b)
    with pytest.raises(ValueError, match="whole groups"):
        probe.probe_copy_batch(*probe_on(cuda, st, cs), chunk_rows=rows + 1)


# --- the anti-entropy and storage plane: plain torch on the card -------


def test_digest_on_card_matches_host(cuda):
    """The int64 emulation of the uint64 digest on the card: lanes with
    the top bit set and negative values, tombstones, empty slots, an
    offset near 2^32, 4,097 slots (a ragged leaf, 513 leaves)."""
    from crdt_tpu_torch.ops import digest
    rng = np.random.default_rng(11)
    n = 4097
    host = [torch.tensor(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                      dtype=np.int64, endpoint=True)),
            torch.tensor(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                      dtype=np.int64, endpoint=True)),
            torch.tensor(rng.random(n) < 0.3),
            torch.tensor(rng.random(n) < 0.7)]
    card = [x.to(cuda) for x in host]
    for off in (0, 2 ** 32 - 3):
        assert torch.equal(digest.slot_digests(*card, idx_offset=off).cpu(),
                           digest.slot_digests(*host, idx_offset=off))
    got = digest.digest_levels_from_lanes(*card)
    want = digest.digest_levels_from_lanes(*host)
    assert len(got) == len(want) == 11
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def storage_run(c, n, spans):
    """Writes, a whole leaf tombstoned, ranged packs whose spans cut
    leaves, GC, a fenced replay through ``merge`` (K1 on the card), a
    compaction: what a card replica and a host replica must agree on."""
    rng = np.random.default_rng(12)
    slots = np.union1d(rng.choice(n, 1500, replace=False), np.arange(8, 16))
    c.put_batch(slots, rng.integers(-2 ** 62, 2 ** 62, len(slots)))
    stale, ids = c.export_delta()
    stale = td.DenseChangeset(*(x.clone() for x in stale))
    c.delete_batch(np.union1d(np.arange(8, 16),
                              rng.choice(slots, 300, replace=False)))
    tree = c.digest_tree()
    packs = [c.pack_since(None, ranges=r)[0] for r in (
        ((3, 13), (100, 101), (n - 7, n)), ((0, 20), (10, 30)))]
    purged = c.gc_purge(c.canonical_time, drift_slack_ms=0)
    c.merge(stale, ids)
    translation = c.compact(spans)
    seeded = c.digest_tree()
    c._digest_cache = None
    fresh = c.digest_tree()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return dict(store=[x.cpu() for x in c.store], clock=str(c.canonical_time),
                purged=purged, translation=translation,
                trees=[tree.levels, seeded.levels, fresh.levels],
                packs=[lane_bytes(p) for p in packs])


def assert_runs_equal(a, b):
    for x, y in zip(a.pop("store"), b.pop("store")):
        assert torch.equal(x, y)
    for ta, tb in zip(a.pop("trees"), b.pop("trees")):
        for la, lb in zip(ta, tb):
            np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(a.pop("translation"), b.pop("translation"))
    assert a == b


def test_storage_plane_on_card_matches_host(cuda):
    runs = []
    for device in (cuda, "cpu"):
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        c = port.DenseCrdt("n1", 4097, device=device,
                           wall_clock=tick.__next__)
        obs_device.reset()
        runs.append(storage_run(c, 4097, ((5, 1000), (1000, 4097))))
        if device is cuda:
            assert obs_device.launches()["fanin_batch"] == 1
        assert obs_device.op_launches() == dict(
            dict.fromkeys(obs_device.OPS, 0), digest_tree=2,
            range_delta_mask=2, gc_purge=1, compact_remap=1)
    a, b = runs
    assert a["purged"] >= 8 and (a["translation"][8:16] == -1).all()
    # The seeded tree equals the fresh one.
    for la, lb in zip(a["trees"][1], a["trees"][2]):
        np.testing.assert_array_equal(la, lb)
    assert_runs_equal(a, b)


def test_sharded_storage_plane_on_card_matches_host(cuda):
    """The same on a (2, 2) mesh on the one card against a host mesh:
    the sharded digest and compaction (a shard width of 4,104, a
    multiple of the leaf width), the purge on every copy, the fence
    folded before K1p, and the columnar join routed by key shard."""
    n = 8208
    runs = []
    for devices in ([cuda] * 4, ["cpu"] * 4):
        mesh = parallel.make_fanin_mesh(2, 2, devices)
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        c = port.ShardedDenseCrdt("n1", n, mesh, wall_clock=tick.__next__)
        src = port.DenseCrdt("a0", n, device="cpu", wall_clock=tick.__next__)
        rng = np.random.default_rng(13)
        src.put_batch(rng.choice(n, 3000, replace=False),
                      rng.integers(0, 1 << 40, 3000))
        c.merge_packed(*src.pack_since())             # the wide join
        src.put_batch(rng.choice(n, 40, replace=False), 7)
        c.merge_packed(*src.pack_since(c.canonical_time))  # sparse
        run = storage_run(c, n, None)
        for k in range(2):
            for x, y in zip(c._store.blocks[0][k], c._store.blocks[1][k]):
                assert torch.equal(x, y)
        runs.append(run)
    assert_runs_equal(*runs)


# --- typed slots: plain torch on the card, never the LWW kernels ------------


def typed_join_inputs(rng, n):
    """Both sides of a typed join over every tag (and an unknown one),
    with top-bit lanes, top-4 packs with repeats and exact (lt, node)
    ties; numpy, so card and host get the same bits."""
    shifts = np.array([48, 32, 16, 0], np.int64)
    mv = (rng.integers(0, 6, (n, 4)).astype(np.int64) << shifts).sum(1)
    wild = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64,
                        endpoint=True)
    sem = rng.integers(0, 6, n).astype(np.int8)

    def vals():
        return np.where(sem == 4, mv[rng.permutation(n)], wild[
            rng.permutation(n)])

    return dict(sem=sem,
                l_lt=(rng.integers(0, 3, n) << 16).astype(np.int64),
                l_node=rng.integers(0, 3, n).astype(np.int32),
                l_val=vals(), l_occ=rng.random(n) < 0.7,
                l_tomb=rng.random(n) < 0.3,
                r_lt=(rng.integers(0, 3, n) << 16).astype(np.int64),
                r_node=rng.integers(0, 3, n).astype(np.int32),
                r_val=vals(), r_tomb=rng.random(n) < 0.3,
                r_valid=rng.random(n) < 0.7)


def test_typed_joins_on_card_match_host(cuda):
    """Each typed join (`typed_join_lanes`, the wire, sparse and fan-in
    steps) on the card against the same call on the host, at an odd
    width; the sparse join gets losing and padding rows (slot ==
    n_slots) whose indexed writes must never happen."""
    from crdt_tpu_torch.semantics import kernels as tk
    n = 4097
    rng = np.random.default_rng(21)
    x = typed_join_inputs(rng, n)
    order = ("sem", "l_lt", "l_node", "l_val", "l_occ", "l_tomb", "r_lt",
             "r_node", "r_val", "r_tomb", "r_valid")
    host = tk.typed_join_lanes(*(torch.from_numpy(x[k]) for k in order))
    card = tk.typed_join_lanes(*(torch.from_numpy(x[k]).to(cuda)
                                 for k in order))
    for a, b in zip(host, card):
        assert torch.equal(a, b.cpu())

    store, cs = lanes(rng, n, 5)
    sem = x["sem"]
    outs = []
    for dev in ("cpu", cuda):
        s, c = on(dev, store, cs)
        sem_d = torch.from_numpy(sem).to(dev)
        wide, wwin = tk.typed_wire_join_step(
            td.DenseStore(*(lane.clone() for lane in s)), sem_d,
            c.lt[0], c.node[0], c.val[0], c.tomb[0], c.valid[0],
            BASE + 50, 2)
        fan, res = tk.typed_fanin_step(s, sem_d, c, BASE + 1, 2,
                                       (BASE >> 16) + 5)
        # Sparse: 1,000 unique slots padded to 1,024 with n_slots
        # sentinels; about half the valid rows lose to the store.
        k = 1000
        slot = np.full(1024, n, np.int64)
        slot[:k] = np.random.default_rng(22).choice(n, k, replace=False)
        valid = np.zeros(1024, bool)
        valid[:k] = True
        rows = [torch.from_numpy(np.resize(cs[f][1], 1024)).to(dev)
                for f in ("lt", "node", "val", "tomb")]
        sparse, swin = tk.typed_sparse_join_step(
            td.DenseStore(*(lane.clone() for lane in s)),
            torch.from_numpy(np.where(valid, sem[np.minimum(slot, n - 1)],
                                      0).astype(np.int8)).to(dev),
            torch.from_numpy(slot).to(dev), *rows,
            torch.from_numpy(valid).to(dev), BASE + 60, 3)
        if dev is cuda:
            torch.cuda.synchronize()    # a bad index would assert here
        outs.append([t.cpu() for t in (*wide, wwin, *fan, res.win,
                                       res.new_canonical, *sparse, swin)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    swin = outs[1][-1]
    assert 0 < int(swin[:1000].sum()) < 1000 and not swin[1000:].any()


@pytest.mark.parametrize("model", ["dense", "sharded"])
def test_typed_merge_many_launches_no_lww_kernel(cuda, model):
    """A typed store's merge_many, coarse window and merge_split take the
    typed fold on the card (one typed_fanin_step op each), launch none
    of K1, K1p, K1s or K3, and equal the same ops on the host."""
    n = 4097 if model == "dense" else 4100
    runs = []
    for dev in (cuda, "cpu"):
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        if model == "dense":
            c = port.DenseCrdt("r0", n, device=dev, wall_clock=tick.__next__)
        else:
            mesh = parallel.make_fanin_mesh(2, 2, [dev] * 4)
            c = port.ShardedDenseCrdt("r0", n, mesh,
                                      wall_clock=tick.__next__)
        for name, lo in (("gcounter", 0), ("pncounter", 1000),
                         ("orset", 2000), ("mvreg", 3000)):
            c.set_semantics(range(lo, lo + 1000), name)
        c.counter_add(5, 3)
        c.orset_add(2001, 4)
        rng = np.random.default_rng(31)
        _, cs = lanes(rng, n, 6)
        cs["val"][:, 3000:4000] = (rng.integers(1, 9, (6, 1000)) << 48)
        peer = td.DenseChangeset(**{k: torch.tensor(v, device=c.device)
                                    for k, v in cs.items()})
        ids = ["a0", "b1", "c2", "d3"]
        obs_device.reset()
        c.merge_many([(peer, ids)])
        with c.pipelined():
            c.merge(peer, ids)
        scs = ts.split_changeset(td.DenseChangeset(*(
            lane[:2].contiguous() for lane in peer)))
        c.merge_split(scs, ids)
        launches = obs_device.launches()
        assert obs_device.op_launches()["typed_fanin_step"] == 3
        for k1 in ("fanin_batch", "fanin_batch_sharded", "fanin_split",
                   "fanin_stream"):
            assert launches[k1] == 0, k1
        runs.append((c.store, str(c.canonical_time), c.to_json()))
    (a, ta, ja), (b, tb, jb) = runs
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y)
    assert (ta, ja) == (tb, jb)


# --- C6: the store helpers default to the card --------------------------------


def test_store_helpers_default_to_the_card(cuda):
    store = td.empty_dense_store(17)
    assert all(lane.device.type == "cuda" for lane in store)
    back = td.store_from_numpy(td.store_to_numpy(store))
    assert all(lane.device.type == "cuda" for lane in back)
    assert all(torch.equal(a, b) for a, b in zip(store, back))


# --- the wire: a card replica behind a SyncServer ------------------------------


def wire_run(server_device, mode, n):
    """Two rounds of ``mode`` from a host client to a server over a
    replica on ``server_device``; returns both replicas."""
    import itertools

    from crdt_tpu_torch import net

    ticks = [itertools.count(1_700_000_000_000) for _ in range(2)]
    a = port.DenseCrdt("a", n, device=server_device,
                       wall_clock=ticks[0].__next__)
    b = port.DenseCrdt("b", n, device="cpu", wall_clock=ticks[1].__next__)
    rng = np.random.default_rng(n)
    for c in (a, b):
        slots = rng.choice(n, n // 3, replace=False)
        c.put_batch(slots, rng.integers(-2 ** 62, 2 ** 62, len(slots)))
        c.delete_batch(slots[:9])
    fn = {"dense": net.sync_dense_over_conn,
          "packed": net.sync_packed_over_conn}[mode]
    with net.SyncServer(a) as server:
        with net.PeerConnection(server.host, server.port,
                                timeout=60.0) as conn:
            mark = fn(b, conn, lock=None)
            with server.lock:
                a.put_batch([1, n - 1], [7, 8])
            b.put_batch([2], [9])
            fn(b, conn, since=mark)
    return a, b


@pytest.mark.parametrize("mode", ["dense", "packed"])
@pytest.mark.parametrize("n", [1000, 4097, 8192])
def test_sync_server_on_card_matches_a_host_pair(cuda, mode, n):
    ca, cb = wire_run(cuda, mode, n)
    ha, hb = wire_run("cpu", mode, n)
    assert all(lane.device.type == cuda.type for lane in ca.store)
    for got, want in ((ca, ha), (cb, hb)):
        for x, y in zip(got.store, want.store):
            assert torch.equal(x.cpu(), y)
        assert str(got.canonical_time) == str(want.canonical_time)


# --- the general-key store and the group join on the card ----------------------


@pytest.mark.parametrize("cap,m", [(1000, 300), (37, 20), (4097, 64)])
def test_merge_step_on_card_matches_host(cuda, cap, m):
    from crdt_tpu_torch.ops import merge as tm
    rng = np.random.default_rng(cap)
    occ = rng.random(cap) < 0.5
    lanes = {"lt": np.where(occ, BASE + rng.integers(0, 50, cap), 0),
             "node": np.where(occ, rng.integers(0, 4, cap), 0)
             .astype(np.int32),
             "mod_lt": np.where(occ, BASE, 0),
             "mod_node": np.zeros(cap, np.int32), "occupied": occ,
             "tomb": occ & (rng.random(cap) < 0.2)}
    slots = rng.choice(cap, m, replace=False) - cap * (rng.random(m) < 0.5)
    slots = np.concatenate([slots, [cap, cap + 7, -cap - 1]]).astype(np.int32)
    n = len(slots)
    cs = {"slot": slots, "lt": BASE + rng.integers(0, 50, n),
          "node": rng.integers(1, 4, n).astype(np.int32),
          "tomb": rng.random(n) < 0.3, "valid": rng.random(n) < 0.9}
    outs = []
    for dev in ("cpu", cuda):
        st = tm.Store(**{f: torch.tensor(v, device=dev)
                         for f, v in lanes.items()})
        c = tm.Changeset(**{f: torch.tensor(v, device=dev)
                            for f, v in cs.items()})
        new, res = tm.merge_step(st, c, BASE + 20, 0, (BASE >> 16) + 30)
        put = tm.scatter_put(st, c, BASE + 99, 2)
        outs.append([x.cpu() for x in (*new, *res, *put,
                                      tm.max_logical_time(new),
                                      tm.delta_mask(new, BASE + 20))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_tpu_map_crdt_mirror_lands_on_the_card(cuda):
    from crdt_tpu_torch.ops import merge as tm
    c = port.TpuMapCrdt("n")
    assert c.device.type == "cuda"
    c.put_all({f"k{i}": i for i in range(100)})
    s = c.store
    assert all(lane.device.type == "cuda" for lane in s)
    assert int(tm.max_logical_time(s)) == int(c._lanes.lt.max())
    s.lt.zero_()                              # a copy, not the shadow
    assert c._lanes.lt.max() > 0


def test_two_member_group_on_a_repeated_card_matches_host(cuda):
    from crdt_tpu_torch.collective import CollectiveGroup
    from crdt_tpu_torch.parallel import make_collective_mesh
    out = []
    for dev, mesh in (("cpu", None),
                      (cuda, make_collective_mesh(2, [cuda] * 2))):
        ticks = [iter(range(1_700_000_000_000, 1_700_000_001_000))
                 for _ in range(2)]
        reps = [port.DenseCrdt(name, 4097, device=dev,
                               wall_clock=t.__next__)
                for name, t in zip("ab", ticks)]
        rng = np.random.default_rng(3)
        for c in reps:
            c.set_semantics([0, 1], "gcounter")
            c.set_semantics([2], "mvreg")
            slots = rng.choice(np.arange(3, 4097), 500, replace=False)
            c.put_batch(slots, rng.integers(0, 2 ** 40, 500))
            c.delete_batch(slots[:20])
            c.counter_add(0, 5)
            c.mvreg_put(2, int(rng.integers(1, 99)))
        group = CollectiveGroup(reps, mesh=mesh)
        obs_device.reset()
        rep = group.join()
        assert obs_device.op_launches()["parallel.collective_join"] == 1
        out.append((rep, reps))
    (hr, hreps), (cr, creps) = out
    assert (hr.new_canonical, hr.win_counts, hr.digest_root) == \
        (cr.new_canonical, cr.win_counts, cr.digest_root)
    for h, c in zip(hreps, creps):
        assert all(lane.device.type == "cuda" for lane in c.store)
        for x, y in zip(h.store, c.store):
            assert torch.equal(x, y.cpu())
        (hk, hv), = h._pack_cache.items()
        (ck, cv), = c._pack_cache.items()
        assert [a.tobytes() for a in hv[0] if a is not None] == \
            [a.tobytes() for a in cv[0] if a is not None]


def _serve_flushes(node):
    snap = port.default_registry().snapshot()
    return sum(s["value"] for s in snap["counters"].get(
        "crdt_tpu_ingest_flush_total", [])
        if s["labels"].get("node") == node)


@pytest.mark.parametrize("n", [1000, 4097])
def test_serve_tier_on_card_one_scatter_a_flush_and_reads_back(cuda, n):
    """A `ServeTier` over a card replica: one K2 launch (and one
    ``pallas.ingest_scatter_tiles`` ledger record) per flush with rows,
    and every acknowledged write reads back, on the JSON and the binary
    lane, equal to a host twin given the same writes."""
    import socket
    import time

    from crdt_tpu_torch import net
    from crdt_tpu_torch.obs.device import default_ledger
    node = f"cuda-serve-{n}"
    crdt = port.DenseCrdt(node, n, device="cuda")
    twin = port.DenseCrdt("twin", n, device="cpu")
    rng = np.random.default_rng(n)
    slots = rng.choice(n, 40, replace=False).tolist()
    vals = rng.integers(-2 ** 40, 2 ** 40, 40).tolist()
    led, f0 = default_ledger().as_dict(), _serve_flushes(node)
    before = obs_device.launches()
    with port.ServeTier(crdt, flush_interval=0.002) as tier:
        with socket.create_connection((tier.host, tier.port),
                                      timeout=30.0) as sock:
            for s, v in zip(slots[:20], vals[:20]):
                net.send_frame(sock, {"op": "put", "slot": s, "value": v})
                assert net.recv_frame(sock, deadline=time.monotonic()
                                      + 30.0) == {"ok": True}
            net.send_frame(sock, {"op": "hello", "proto": 1,
                                  "caps": ["binop"]})
            net.recv_frame(sock, deadline=time.monotonic() + 30.0)
            codec = net.FrameCodec(compress=False)
            st, _, _ = net.binop_round(sock, [net.BINOP_PUT] * 20,
                                       slots[20:], vals[20:], codec=codec)
            assert st.tolist() == [net.BINOP_ST_OK] * 20
            st, got, _ = net.binop_round(sock, [net.BINOP_GET] * 40, slots,
                                         [0] * 40, codec=codec)
            assert got.tolist() == vals
    torch.cuda.synchronize()
    flushes = _serve_flushes(node) - f0
    launched = obs_device.launches()["ingest_scatter"] - \
        before["ingest_scatter"]
    recorded = default_ledger().as_dict().get(
        "pallas.ingest_scatter_tiles", 0) - led.get(
        "pallas.ingest_scatter_tiles", 0)
    assert launched == recorded == flushes >= 2
    for s, v in zip(slots, vals):
        twin.put_batch([s], [v])
    for f in ("val", "occupied", "tomb"):
        assert torch.equal(getattr(crdt.store, f).cpu(),
                           getattr(twin.store, f))


def test_push_dense_to_a_card_tier_launches_k1s_once(cuda):
    """A ``push_dense`` frame into a card tier merges through one K1s
    launch, to the lanes of the same push into a host tier."""
    from crdt_tpu_torch import net
    from crdt_tpu_torch.testing import FakeClock
    n = 4097
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(9)
        tier_crdt = port.DenseCrdt("pd-t", n, device=dev,
                                   wall_clock=FakeClock())
        tier_crdt.put_batch(rng.choice(n, 50, replace=False),
                            np.arange(50))
        client = port.DenseCrdt("pd-c", n, device="cpu",
                                wall_clock=FakeClock())
        client.put_batch(np.arange(0, n, 7), np.arange(0, n, 7) * 3)
        before = obs_device.launches()["fanin_split"]
        with port.ServeTier(tier_crdt) as tier:
            with net.PeerConnection(tier.host, tier.port,
                                    timeout=30.0) as conn:
                net.sync_dense_over_conn(client, conn)
        out[dev] = (tier_crdt, obs_device.launches()["fanin_split"]
                    - before)
    assert out["cuda"][1] == 1 and out["cpu"][1] == 0
    for f in out["cpu"][0].store._fields:
        assert torch.equal(getattr(out["cuda"][0].store, f).cpu(),
                           getattr(out["cpu"][0].store, f)), f


def test_replica_group_on_card_rejoins_and_converges(cuda):
    """A three-member group on the card: a killed primary's rejoin
    counts its catch-up bytes from the card store, and the members end
    on one digest root with every acked write."""
    from crdt_tpu_torch.replication import ReplicaGroup
    with ReplicaGroup(1000, replicas=3, ack_replicas=1,
                      heartbeat_interval=0.05, heartbeat_timeout=1.0,
                      lease_misses=3) as group:
        assert group.device.type == "cuda"
        cli = port.FederatedClient(group.member_addrs(), timeout=30.0)
        try:
            for s in range(0, 64, 4):
                cli.put(s, s + 1)
            dead = group.kill_primary()
            cli.put(500, 5)
            group.rejoin(dead.index)
            import time
            deadline = time.monotonic() + 60.0
            bump = 0
            while True:
                bump += 1
                cli.put(999, bump)
                roots = []
                for m in group.members:
                    with m.tier.lock:
                        roots.append(int(m.tier.crdt.digest_tree().root))
                if len(set(roots)) == 1:
                    break
                assert time.monotonic() < deadline
                time.sleep(0.05)
            for m in group.members:
                with m.tier.lock:
                    assert [m.tier.crdt.get(s) for s in range(0, 64, 4)] \
                        == [s + 1 for s in range(0, 64, 4)]
                    assert m.tier.crdt.store.lt.is_cuda
        finally:
            cli.close()


# --- the analysis gate's kernel law targets and the sanitizer ---------


KERNEL_LAW_KERNELS = {
    "pallas.model_fanin_batch": "fanin_batch",
    "pallas.model_fanin_split[wide]": "fanin_split",
    "pallas.model_fanin_split[narrow]": "fanin_split",
    "pallas.pallas_fanin_step[exact]": "fanin_stream",
    "pallas.pallas_fanin_step[fast]": "fanin_stream",
    "pallas.ingest_scatter_tiles": "ingest_scatter",
    "parallel.pallas_fanin_block": "fanin_batch_sharded",
}


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("name", sorted(KERNEL_LAW_KERNELS))
def test_kernel_law_target_holds_on_the_card(cuda, name, dense):
    """Each hand kernel under the three laws (K2: two) at a small odd
    shape, launched, and equal to the same target's plain run."""
    from crdt_tpu_torch.analysis import lattice_laws as laws
    kw = dict(n=258, rows=5, chunks=3, flush_rows=33, dense=dense)
    card, = [t for t in laws.kernel_targets(cuda, **kw) if t.name == name]
    host, = [t for t in laws.kernel_targets("cpu", **kw) if t.name == name]
    obs_device.reset()
    assert laws.run_laws([card], seeds=(0, 1)) == []
    assert obs_device.launches()[KERNEL_LAW_KERNELS[name]] > 0
    for seed in (0, 1):
        rng_c, rng_h = np.random.default_rng(seed), np.random.default_rng(seed)
        a_c = card.gen(rng_c)
        a_h = host.gen(rng_h) if not dense else _to_cpu(a_c)
        got = card.extract(card.apply(card.fresh(), a_c))
        want = host.extract(host.apply(host.fresh(), a_h))
        for f in want:
            assert torch.equal(got[f].cpu(), want[f]), (name, f)


def _to_cpu(batch):
    if isinstance(batch, dict):
        return {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in batch.items()}
    return type(batch)(*(x.cpu() for x in batch))


def test_sanitized_k1_merge_on_the_card(cuda, monkeypatch):
    """A K1 merge, a packed merge, GC and the fenced replay under the
    sanitizer on the card: no violation, one K1 launch a wide merge,
    the host twin's lanes; a planted lost update raises."""
    from crdt_tpu_torch.analysis.sanitizer import LatticeViolation
    from crdt_tpu_torch.testing import FakeClock
    monkeypatch.setenv("CRDT_TPU_SANITIZE", "1")
    lanes_out = {}
    for dev in (cuda, "cpu"):
        a = port.DenseCrdt("a", 1001, device=dev, wall_clock=FakeClock())
        b = port.DenseCrdt("b", 1001, device=dev, wall_clock=FakeClock())
        a.put_batch(list(range(0, 1001, 7)), list(range(143)))
        a.delete_batch(list(range(0, 1001, 21)))
        b.put_batch([3, 500], [1, 2])
        obs_device.reset()
        b.merge(*a.export_delta())
        assert obs_device.launches()["fanin_batch"] == (dev == cuda)
        packed = a.pack_since()
        b.merge_packed(*packed)
        b.gc_purge(b.canonical_time, drift_slack_ms=0)
        b.merge(*a.export_delta())
        lanes_out[str(dev)] = {f: getattr(b.store, f).cpu()
                               for f in ("lt", "node", "val", "occupied",
                                         "tomb")}
    for f, lane in lanes_out["cpu"].items():
        assert torch.equal(lanes_out[str(cuda)][f], lane), f
    c = port.DenseCrdt("c", 1001, device=cuda, wall_clock=FakeClock())
    real = c._dispatch_fanin

    def keep_old(cs, wall):
        join, g = real(cs, wall)
        old = c._store
        return join._replace(outs=(old.lt, old.node, old.val, old.tomb,
                                   old.occupied, *join.outs[5:])), g

    monkeypatch.setattr(c, "_dispatch_fanin", keep_old)
    with pytest.raises(LatticeViolation, match="merged changeset"):
        c.merge(*a.export_delta())


# --- across cards: `parallel.comm`, the group join and the sharded model ------
#
# These need two or four cards and skip below that, naming the count.
# Each holds the route across the cards (NCCL where torch has it, the
# route the layout picks) against its funnel twin, the one-card stacked
# route and the host, bit for bit.


def cards_or_skip(n):
    """The first ``n`` cards, or a skip naming how many are visible."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        pytest.skip(f"needs {n} CUDA cards, {count} visible")
    return [f"cuda:{i}" for i in range(n)]


#: Each position's card: one a card, and four positions over two cards
#: (interleaved and blocked).
CARD_LAYOUTS = {"4_cards": [0, 1, 2, 3], "2_cards": [0, 1],
                "mixed_4_on_2": [0, 1, 0, 1], "blocked_4_on_2": [0, 0, 1, 1]}


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.uint8,
                                   torch.bool], ids=str)
@pytest.mark.parametrize("layout", sorted(CARD_LAYOUTS))
def test_comm_across_cards_matches_the_funnel_and_a_fold(layout, dtype):
    from crdt_tpu_torch.parallel import comm
    at = CARD_LAYOUTS[layout]
    cards = cards_or_skip(max(at) + 1)
    devices = [cards[i] for i in at]
    rng = np.random.default_rng(len(at))
    hi = {torch.int64: 2 ** 60, torch.int32: 2 ** 27, torch.uint8: 50,
          torch.bool: 2}[dtype]
    lo = -hi if dtype in (torch.int64, torch.int32) else 0
    xs = [rng.integers(lo, hi, 4097) for _ in at]
    ref = np.stack(xs)
    want = {"pmax": ref.max(0), "pmin": ref.min(0), "psum": ref.sum(0)}
    for funnel in (False, True):
        lay = comm.Layout(devices, funnel=funnel)
        assert lay.route == ("funnel" if funnel or not comm.nccl_built()
                             else "nccl")
        blocks = lay.stack([torch.from_numpy(x).to(dtype).to(d)
                            for x, d in zip(xs, devices)])
        for name, fold in (("pmax", comm.pmax), ("pmin", comm.pmin),
                           ("psum", comm.psum)):
            if name == "pmin" and dtype == torch.bool:
                continue
            outs = fold(lay, blocks)
            for out, dev in zip(outs, lay.devices):
                assert out.device == torch.device(dev)
                np.testing.assert_array_equal(out.long().cpu().numpy(),
                                              want[name], err_msg=name)
        for out in comm.all_gather(lay, blocks):
            np.testing.assert_array_equal(out.long().cpu().numpy(), ref)


def _group_members(devices, typed, n=4097):
    """Four replicas, one a device of ``devices``, on the same clock
    sequence: the shared slots land at one lt on every member (ties on
    lt across the cards, broken by node), the mvreg slot too (an
    equal-lt union), plus slots of each member's own."""
    reps = []
    for i, dev in enumerate(devices):
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        c = port.DenseCrdt(f"m{i}", n, device=dev, wall_clock=tick.__next__)
        rng = np.random.default_rng(40 + i)
        if typed:
            c.set_semantics([0, 1], "gcounter")
            c.set_semantics([2], "mvreg")
            c.set_semantics([3], "orset")
            c.set_semantics([4], "pncounter")
        c.put_batch(np.arange(100, 400), rng.integers(0, 2 ** 40, 300))
        own = rng.choice(np.arange(400, n), 300, replace=False)
        c.put_batch(own, rng.integers(0, 2 ** 40, 300))
        c.delete_batch(own[:30])
        if typed:
            c.counter_add(i % 2, 5 + i)
            c.mvreg_put(2, 10 + i)
            c.orset_add(3, i)
            c.counter_add(4, 3 - 2 * i)
        reps.append(c)
    return reps


@pytest.mark.parametrize("typed", [False, True], ids=["lww", "typed"])
@pytest.mark.parametrize("layout", ["4_cards", "mixed_4_on_2"])
def test_group_join_across_cards_matches_one_card_and_host(layout, typed):
    from crdt_tpu_torch.collective import CollectiveGroup
    from crdt_tpu_torch.parallel import comm, make_collective_mesh
    at = CARD_LAYOUTS[layout]
    cards = cards_or_skip(max(at) + 1)
    devices = [cards[i] for i in at]
    groups = {
        "cards": CollectiveGroup(_group_members(devices, typed)),
        "funnel": CollectiveGroup(
            _group_members(devices, typed),
            mesh=make_collective_mesh(4, devices, funnel=True)),
        "one_card": CollectiveGroup(
            _group_members([cards[0]] * 4, typed),
            mesh=make_collective_mesh(4, [cards[0]] * 4)),
        "host": CollectiveGroup(_group_members(["cpu"] * 4, typed))}
    for round_ in range(2):
        comm.reset_tally()
        reports = {"cards": groups["cards"].join()}
        assert comm.TALLY["funnel_bytes"] == 0
        assert (comm.TALLY["nccl_calls"] > 0) == comm.nccl_built()
        for i, m in enumerate(groups["cards"].members):
            assert all(lane.device == torch.device(devices[i])
                       for lane in m._store), m.node_id
        for k in ("funnel", "one_card", "host"):
            reports[k] = groups[k].join()
        want = reports["host"]
        for k, rep in reports.items():
            assert (rep.new_canonical, rep.win_counts, rep.digest_root) == \
                (want.new_canonical, want.win_counts, want.digest_root), k
            for m, h in zip(groups[k].members, groups["host"].members):
                for x, y in zip(m.store, h.store):
                    assert torch.equal(x.cpu(), y), (k, m.node_id)
                (_, mv), = m._pack_cache.items()
                (_, hv), = h._pack_cache.items()
                assert [a.tobytes() for a in mv[0] if a is not None] == \
                    [a.tobytes() for a in hv[0] if a is not None]
        assert want.adopted > 0 or round_ == 1
        for g in groups.values():
            for c in g.members:
                c.put_batch([7, 100], [round_, 99])
    if typed:
        assert {c.mvreg_get(2) for g in groups.values()
                for c in g.members} == {(13, 12, 11, 10)}


@pytest.mark.parametrize("layout", ["4_cards", "mixed_4_on_2"])
def test_collective_step_ties_across_cards_go_to_the_lowest_rank(layout):
    """Equal (lt, node) on every member with payloads of their own (a
    state no valid group holds, which makes the rank tie visible): the
    cards' route lands rank 0's payload, as the one-card route and the
    host do."""
    from crdt_tpu_torch.parallel import collective as pc
    at = CARD_LAYOUTS[layout]
    cards = cards_or_skip(max(at) + 1)
    n = 4097
    rng = np.random.default_rng(8)
    stores = []
    for i in range(4):
        occ = np.ones(n, bool)
        stores.append(dict(
            lt=np.full(n, BASE + 7), node=np.full(n, 2, np.int32),
            val=rng.integers(-2 ** 62, 2 ** 62, n),
            mod_lt=np.zeros(n, np.int64),
            mod_node=np.zeros(n, np.int32), occupied=occ,
            tomb=rng.random(n) < 0.5))
    outs = {}
    for name, devices in (("cards", [cards[i] for i in at]),
                          ("one_card", [cards[0]] * 4),
                          ("host", ["cpu"] * 4)):
        step = pc.make_collective_join(
            pc.make_collective_mesh(4, devices), False, 8)
        members, res = step(
            tuple(td.store_from_numpy(s, d)
                  for s, d in zip(stores, devices)),
            torch.zeros(4, dtype=torch.int64),
            torch.arange(4, dtype=torch.int32), 0)
        outs[name] = [[x.cpu() for x in m] for m in members]
    replicated = (0, 1, 2, 5, 6)        # the mod lanes are per member
    for name, members in outs.items():
        for m, h in zip(members, outs["host"]):
            assert np.array_equal(m[2].numpy(), stores[0]["val"]), name
            for x, y in zip(m, h):
                assert torch.equal(x, y), name
            assert all(torch.equal(m[i], outs["host"][0][i])
                       for i in replicated), name


SHARDED_CARD_MESHES = [((2, 2), "4_cards"), ((4, 1), "4_cards"),
                       ((1, 4), "4_cards"), ((4, 1), "mixed_4_on_2"),
                       ((2, 2), "blocked_4_on_2")]


@pytest.mark.parametrize("shape,layout", SHARDED_CARD_MESHES, ids=str)
def test_sharded_step_across_cards_matches_plain(shape, layout):
    """K1p with every mesh position on its layout's card: one launch a
    card, the combine through the cards' collectives, against the plain
    per-block join on one card and the unsharded merge, bit for bit, at
    an odd shard width, with ties across the replica-shard boundary."""
    at = CARD_LAYOUTS[layout]
    cards = cards_or_skip(max(at) + 1)
    n, rows = shape[1] * 4097, 9
    store, cs = lanes(np.random.default_rng(sum(shape)), n, rows)
    cs["lt"][5, ::3] = cs["lt"][0, ::3]
    cs["node"][5, ::3] = cs["node"][0, ::3]
    cs["valid"][[0, 5], ::3] = True
    args = (BASE + 3, 2, 1_700_000_010_000)
    mesh = parallel.make_fanin_mesh(*shape, [cards[i] for i in at])
    obs_device.reset()
    s, c = on_card = on(torch.device(cards[0]), store, cs)
    k_store, k_res = parallel.make_sharded_fanin(mesh)(
        parallel.shard_store(s, mesh), parallel.shard_changeset(c, mesh),
        *args)
    assert obs_device.launches()["fanin_batch_sharded"] == len(set(at))
    flat = list(mesh.devices.flat)
    for row in k_store.blocks:
        for blk in row:
            assert blk.lt.device in flat
    one = parallel.make_fanin_mesh(*shape, [cards[0]] * len(at))
    p_store, p_res = parallel.make_sharded_fanin(one, reference=True)(
        parallel.shard_store(s, one), parallel.shard_changeset(c, one),
        *args)
    for k_row, p_row in zip(k_store.blocks, p_store.blocks):
        for a, b in zip(k_row, p_row):
            for x, y in zip(a, b):
                assert torch.equal(x.cpu(), y.cpu())
    for x, y in zip(k_res, p_res):
        assert torch.equal(x.cpu(), y.cpu())
    u_store, u_res = fanin_kernel.fanin_batch(*on_card, *args)
    for x, y in zip(parallel.gather_store(k_store), u_store):
        assert torch.equal(x.cpu(), y.cpu())
    assert torch.equal(k_res.win.cpu(), u_res.win.cpu())
    assert int(parallel.sharded_max_logical_time(mesh)(k_store)) == \
        int(td.dense_max_logical_time(u_store))


@pytest.mark.parametrize("shape,layout", SHARDED_CARD_MESHES, ids=str)
def test_sharded_dense_crdt_across_cards_matches_host(shape, layout):
    """Flushes, a coarse window, a merge of an exported delta, a
    refused duplicate, the digest root and a delta out on a sharded
    replica over the cards against a host one."""
    at = CARD_LAYOUTS[layout]
    cards = cards_or_skip(max(at) + 1)
    n = shape[1] * 4097
    results = []
    for devices in ([cards[i] for i in at], ["cpu"] * len(at)):
        mesh = parallel.make_fanin_mesh(*shape, devices)
        tick = iter(range(1_700_000_000_000, 1_700_000_100_000))
        c = port.ShardedDenseCrdt("n1", n, mesh, wall_clock=tick.__next__)
        rng = np.random.default_rng(5)
        obs_device.reset()
        with c.ingest(auto_flush_rows=100):
            for _ in range(3):
                c.put_batch(rng.choice(n, 60, replace=False),
                            rng.integers(0, 1 << 40, 60))
        _, cs = lanes(rng, n, 5)
        cs["lt"] += 50 << 16
        ids = ["n0", "n2", "n3", "n4"]
        with c.pipelined():
            c.merge(td.DenseChangeset(**{k: torch.tensor(v)
                                         for k, v in cs.items()}), ids)
        since = c.canonical_time
        c.merge(*c.export_delta())
        dup = td.DenseChangeset(*(torch.zeros((1, n), dtype=dt)
                                  for dt in td.CHANGESET_DTYPES.values()))
        dup.valid[0, 9] = True
        dup.lt[0, 9] = c.canonical_time.logical_time + (1000 << 16)
        with pytest.raises(port.DuplicateNodeException):
            with c.pipelined(exact_guards=True):
                c.merge(dup, ["n1"])
        if devices[0] != "cpu":
            assert obs_device.launches()["fanin_batch_sharded"] == \
                3 * len(set(at))
            for k, first in enumerate(c._store.blocks[0]):
                for blk in c._store.column(k):
                    for x, y in zip(blk, first):
                        assert torch.equal(x.cpu(), y.cpu())
        results.append((c, c.digest_tree().root, c.export_delta(since)))
    (a, ra, (da, ia)), (b, rb, (db, ib)) = results
    for x, y in zip(a.store, b.store):
        assert torch.equal(x.cpu(), y)
    assert str(a.canonical_time) == str(b.canonical_time) and ra == rb
    assert ia == ib and all(torch.equal(x.cpu(), y) for x, y in zip(da, db))
