"""The port's ingest commit (`crdt_tpu_torch.ops.ingest_kernel`) held
against the JAX package bit for bit (integer lanes: tolerance 0):
`ingest_scatter_tiles` in interpret mode — the Pallas kernel K2 that
the port's CUDA kernel replaces — and the XLA scatter
`ops.dense.ingest_scatter`, on the same numpy inputs, with the rows
padded to a power of two by ``slot == n_slots`` sentinels as the write
combiner sends them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.ops import dense as jd
from crdt_tpu.ops.pallas_scatter import ingest_scatter_tiles
from crdt_tpu.testing import assert_dense_stores_equal
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import ingest_kernel as tk

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
