"""The port's ingest commit (`crdt_tpu_torch.ops.ingest_kernel`) held
against the JAX package bit for bit (integer lanes: tolerance 0):
`ingest_scatter_tiles` in interpret mode — the Pallas kernel K2 that
the port's CUDA kernel replaces — and the XLA scatter
`ops.dense.ingest_scatter`, on the same numpy inputs, with the rows
padded to a power of two by ``slot == n_slots`` sentinels as the write
combiner sends them. Then the combiner's dedup, which also puts the
kept rows in slot order for the kernel (`DenseCrdt._last_wins_order`),
against the JAX package's `_last_wins_keep`, and whole ingest windows
committed in slot order against the JAX package's `ingest()`: lanes,
clock and watch events.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crdt_tpu_torch as port
from crdt_tpu import DenseCrdt as JaxDenseCrdt
from crdt_tpu.ops import dense as jd
from crdt_tpu.ops.pallas_scatter import ingest_scatter_tiles
from crdt_tpu.testing import FakeClock, assert_dense_stores_equal
from crdt_tpu_torch.models import dense_crdt as port_model
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import ingest_kernel as tk
from torch_threads import cap_torch_threads

cap_torch_threads()

N = 2 * 4096
BASE = 1_700_000_000_000 << 16
ME = 2


def make_store(rng):
    occ = rng.random(N) < 0.4
    return dict(
        lt=np.where(occ, BASE + rng.integers(0, 1 << 20, N), 0),
        node=np.where(occ, rng.integers(0, 4, N), 0).astype(np.int32),
        val=np.where(occ, rng.integers(-2 ** 40, 2 ** 40, N), 0),
        mod_lt=np.where(occ, BASE + rng.integers(0, 1 << 20, N), 0),
        mod_node=np.where(occ, rng.integers(0, 4, N), 0).astype(np.int32),
        occupied=occ, tomb=occ & (rng.random(N) < 0.3))


def make_rows(rng, k, slots=None):
    """``k`` deduped rows (unique slots), then the sentinel-padded
    lanes the combiner's commit hands the kernel."""
    if slots is None:
        slots = rng.choice(N, k, replace=False)
    lt = BASE + (1 << 21) + rng.integers(0, 1 << 10, k)
    val = rng.integers(-2 ** 40, 2 ** 40, k)
    tomb = rng.random(k) < 0.3
    padded = 1 << max(k - 1, 1).bit_length()
    pad = lambda a, fill: np.concatenate(
        [a, np.full(padded - k, fill, a.dtype)])
    return (slots, lt, val, tomb), (pad(slots.astype(np.int64), N),
                                    pad(lt, 0), pad(val, 0), pad(tomb, False))


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 300), (2, 4097), (3, N)])
def test_ingest_scatter_matches_pallas_and_xla(seed, k):
    rng = np.random.default_rng(seed)
    store = make_store(rng)
    (slots, lt, val, tomb), padded = make_rows(rng, k)
    jstore = jd.DenseStore(**{f: jnp.asarray(v) for f, v in store.items()})

    pallas = ingest_scatter_tiles(jstore, slots, lt, val, tomb, ME,
                                  interpret=True)
    xla = jd.ingest_scatter(jstore, jnp.asarray(padded[0], jnp.int32),
                            *(jnp.asarray(a) for a in padded[1:]),
                            jnp.int32(ME))
    port = tk.ingest_scatter(td.store_from_numpy(store),
                             *(torch.tensor(a) for a in padded), ME)

    assert_dense_stores_equal(pallas, port, where="vs ingest_scatter_tiles")
    for f in td.DenseStore._fields:
        np.testing.assert_array_equal(np.asarray(getattr(xla, f)),
                                      getattr(port, f).numpy(), err_msg=f)
    assert port.occupied[torch.tensor(slots)].all()


def test_ingest_scatter_one_tile_and_every_tile():
    """Rows packed into one 4096-slot tile, then one row per tile: the
    two extremes of the TPU kernel's tile regrouping, which the direct
    scatter must match."""
    rng = np.random.default_rng(4)
    store = make_store(rng)
    for slots in (rng.choice(4096, 700, replace=False) + 4096,
                  np.array([5, 4096 + 17])):
        (s, lt, val, tomb), padded = make_rows(rng, len(slots), slots)
        jstore = jd.DenseStore(**{f: jnp.asarray(v)
                                  for f, v in store.items()})
        pallas = ingest_scatter_tiles(jstore, s, lt, val, tomb, ME,
                                      interpret=True)
        port = tk.ingest_scatter(td.store_from_numpy(store),
                                 *(torch.tensor(a) for a in padded), ME)
        assert_dense_stores_equal(pallas, port, where=f"{len(s)} rows")


def test_ingest_scatter_updates_in_place_without_launch_on_cpu():
    rng = np.random.default_rng(5)
    store = td.store_from_numpy(make_store(rng))
    _, padded = make_rows(rng, 10)
    obs_device.reset()
    out = tk.ingest_scatter(store, *(torch.tensor(a) for a in padded), ME)
    assert out.lt is store.lt
    assert obs_device.launches()["ingest_scatter"] == 0
    assert tk.ingest_scatter_reference is td.ingest_scatter


def test_sentinel_rows_write_nothing():
    rng = np.random.default_rng(6)
    store = make_store(rng)
    sentinel = [torch.full((4,), N, dtype=torch.int64),
                torch.ones(4, dtype=torch.int64),
                torch.ones(4, dtype=torch.int64),
                torch.ones(4, dtype=torch.bool)]
    out = tk.ingest_scatter(td.store_from_numpy(store), *sentinel, ME)
    for f in td.DenseStore._fields:
        np.testing.assert_array_equal(store[f], getattr(out, f).numpy())


SLOT_SETS = {
    "unique": np.array([9, 3, 700, 41, 0, 8191]),
    "repeated": np.array([9, 3, 9, 41, 3, 3, 8191, 9]),
    "all one slot": np.array([5, 5, 5]),
    "empty": np.zeros(0, np.int64),
    "large unique": np.random.default_rng(7).choice(N, 5000, replace=False),
    "large repeated": np.random.default_rng(8).integers(0, 300, 5000),
    "int32 lane": np.array([7, -3, 7, 2 ** 31 - 1], np.int32),
    "far outside any store": np.array([2 ** 62, -5, 2 ** 62, 7, -2 ** 63]),
    "far outside, repeated": np.random.default_rng(9).choice(
        np.array([2 ** 62, -2 ** 62, 5, 9]), 3000),
}


@pytest.mark.parametrize("case", SLOT_SETS)
def test_last_wins_order_gives_the_keep_and_the_slot_order(case):
    """One sort gives both: the staging-order keep, equal to the JAX
    package's `_last_wins_keep` (None when unique), and the kept rows'
    indices in slot order. Payloads refused later (slots past any
    store, an int32 wire lane) collapse the same way."""
    slots = SLOT_SETS[case]
    keep, order = port.DenseCrdt._last_wins_order(slots)
    want = JaxDenseCrdt._last_wins_keep(slots)
    assert (keep is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(keep, want)
    same = port.DenseCrdt._last_wins_keep(slots)
    assert (same is None) == (keep is None)
    assert same is None or np.array_equal(same, keep)
    kept = np.arange(len(slots)) if keep is None else keep
    np.testing.assert_array_equal(np.sort(order), kept)
    np.testing.assert_array_equal(slots[order], np.unique(slots))


def ingest_script(crdt, rng):
    """Ingest windows with auto flushes: puts with repeated slots within
    and across calls, deletes, mixed tombstones."""
    with crdt.ingest(auto_flush_rows=500):
        for _ in range(6):
            crdt.put_batch(rng.choice(N, 200, replace=True),
                           rng.integers(-2 ** 40, 2 ** 40, 200),
                           tombs=rng.random(200) < 0.1)
            crdt.delete_batch(rng.choice(N, 30, replace=False))
            crdt.put_batch(rng.integers(0, 64, 40), rng.integers(0, 9, 40))


def test_flush_commits_in_slot_order_and_matches_jax_ingest(monkeypatch):
    """The combiner hands the kernel its rows in slot order (sentinels
    after them), and the window leaves the lanes, the clock and the
    watch events (staging order) of the JAX package's `ingest()`."""
    committed = []
    real = port_model.ingest_scatter

    def spy(store, slots, *rest):
        committed.append(slots.clone())
        return real(store, slots, *rest)

    monkeypatch.setattr(port_model, "ingest_scatter", spy)
    replicas = (JaxDenseCrdt("n1", N, executor="pallas-interpret",
                             wall_clock=FakeClock()),
                port.DenseCrdt("n1", N, device="cpu",
                               wall_clock=FakeClock()))
    streams = [c.watch().record() for c in replicas]
    keyed = [c.watch(slot=3).record() for c in replicas]
    for c in replicas:
        ingest_script(c, np.random.default_rng(11))
    assert len(committed) >= 3
    for slots in committed:
        live = slots[slots < N]
        assert torch.all(live[1:] > live[:-1])
        assert torch.all(slots[len(live):] == N)
    jax_crdt, port_crdt = replicas
    assert_dense_stores_equal(jax_crdt.store, port_crdt.store, "ingest")
    assert str(jax_crdt.canonical_time) == str(port_crdt.canonical_time)
    assert streams[0].events == streams[1].events
    assert keyed[0].events == keyed[1].events
    assert len(streams[1].events) > 1000
