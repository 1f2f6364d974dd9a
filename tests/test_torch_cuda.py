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
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import fanin_kernel, ingest_kernel

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


def on(device, store, cs):
    return (td.store_from_numpy(store, device),
            td.DenseChangeset(**{k: torch.tensor(v, device=device)
                                 for k, v in cs.items()}))


@pytest.mark.parametrize("n,rows", [(5000, 3), (257, 1), (1000, 0),
                                    (40_000, 64)])
def test_fanin_kernel_matches_plain(cuda, n, rows):
    store, cs = lanes(np.random.default_rng(n + rows), n, rows)
    obs_device.reset()
    k = fanin_kernel.fanin_batch(*on(cuda, store, cs), BASE + 3, 2,
                                 1_700_000_010_000)
    assert obs_device.launches()["fanin_batch"] == 1
    p = fanin_kernel.fanin_batch(*on("cpu", store, cs), BASE + 3, 2,
                                 1_700_000_010_000)
    for a, b in zip(list(k[0]) + list(k[1]), list(p[0]) + list(p[1])):
        assert torch.equal(a.cpu(), b)


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
    p = ingest_kernel.ingest_scatter(td.store_from_numpy(store),
                                     *(torch.tensor(a) for a in rows), 3)
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)


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
