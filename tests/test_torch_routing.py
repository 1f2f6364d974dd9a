"""The port's keyspace routing (`crdt_tpu_torch.routing`) against the
JAX package's (`crdt_tpu.routing`), exactly: tables built from the same
seeded owner sets give the same owner for every slot, the same JSON
bytes and the same ranges; a seeded run of splits, reassigns and merges
gives the same table at every epoch; and `PartitionRouter.check` /
`check_batch` give the same verdict for every slot, client epoch and
session kind, across epochs. Pure host code: no sockets, no device."""

import json

import numpy as np
import pytest

from crdt_tpu import routing as jr
from crdt_tpu_torch import routing as pr

from torch_threads import cap_torch_threads

cap_torch_threads()


def owners(rng, k):
    return [f"10.{rng.integers(0, 256)}.{rng.integers(0, 256)}.{i}:"
            f"{7000 + int(rng.integers(0, 999))}" for i in range(k)]


def table_bytes(t):
    return json.dumps(t.to_json(), sort_keys=True).encode()


def same(a, b):
    assert table_bytes(a) == table_bytes(b)
    assert a.ranges == b.ranges and a.epoch == b.epoch
    assert a.owners() == b.owners()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["build", "even"])
def test_tables_from_same_seed_match_jax(seed, kind):
    rng = np.random.default_rng(seed)
    n = int(rng.choice([1 << 10, 1 << 12, 3000]))
    own = owners(rng, int(rng.integers(1, 7)))
    if kind == "build":
        vnodes = int(rng.choice([1, 8, 64]))
        j = jr.RoutingTable.build(n, own, vnodes=vnodes)
        p = pr.RoutingTable.build(n, own, vnodes=vnodes)
    else:
        j = jr.RoutingTable.even(n, own)
        p = pr.RoutingTable.even(n, own)
    same(p, j)
    slots = np.arange(n)
    assert [p.owner_of(s) for s in range(n)] == \
        [j.owner_of(s) for s in range(n)]
    for o in own:
        np.testing.assert_array_equal(p.owned_mask(slots, o),
                                      j.owned_mask(slots, o))
        assert p.ranges_of(o) == j.ranges_of(o)
        assert p.slots_of(o) == j.slots_of(o)
    # Each package reads the other's bytes back to an equal table.
    same(pr.RoutingTable.from_json(json.loads(table_bytes(j))), j)
    same(jr.RoutingTable.from_json(json.loads(table_bytes(p))), p)


def evolve(mod, seed):
    """A seeded run of topology changes; the table at every epoch, or
    the refusal's type and message where a step is refused."""
    rng = np.random.default_rng(seed)
    own = owners(rng, 3)
    t = mod.RoutingTable.build(1 << 12, own)
    out = [t]
    for step in range(12):
        kind = rng.integers(0, 4)
        try:
            if kind == 0:
                lo, hi, _ = t.ranges[int(rng.integers(0, len(t.ranges)))]
                at = int(rng.integers(lo, hi + 1))
                t = t.split(lo, at, f"new-{step}:1")
            elif kind == 1:
                o = t.owners()
                t = t.reassign(o[int(rng.integers(0, len(o)))],
                               f"promoted-{step}:2")
            elif kind == 2:
                o = t.owners()
                t = t.merge(o[int(rng.integers(0, len(o)))],
                            o[int(rng.integers(0, len(o)))])
            else:
                t = t.reassign(f"ghost-{step}", "x:1")
            out.append(t)
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_split_reassign_merge_match_jax_at_every_epoch(seed):
    got, want = evolve(pr, seed), evolve(jr, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g == w
        else:
            same(g, w)


def verdicts(mod, seed):
    rng = np.random.default_rng(seed)
    own = owners(rng, 3)
    n = 1 << 10
    tables = [mod.RoutingTable.build(n, own)]
    lo, hi, _ = tables[0].ranges[0]
    tables.append(tables[0].split(lo, (lo + hi) // 2 or 1, own[1])
                  if hi - lo > 1 else tables[0].reassign(own[0], own[1]))
    tables.append(tables[1].reassign(own[2], own[0]))
    out = []
    router = mod.PartitionRouter()
    out.append(router.check(5, None, True))        # unbound
    router.bind(own[0])
    for t in tables:
        out.append(router.install(t))
        out.append(router.install(tables[0]))     # never rolls back
        out.append(router.epoch)
        slots = rng.integers(0, n, 64)
        for s in slots.tolist():
            for epoch in (None, router.epoch, router.epoch - 1):
                for fed in (True, False):
                    v = router.check(s, epoch, fed)
                    out.append("PROXY" if v is mod.PROXY else v)
        for epoch in (None, router.epoch, router.epoch + 1):
            m = router.check_batch(slots, epoch, True)
            out.append(None if m is None else m.tolist())
        out.append(router.check_batch(
            np.array([s for s in range(n) if router.owns(s)][:8]),
            router.epoch, True))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_check_verdicts_match_jax_across_epochs(seed):
    assert verdicts(pr, seed) == verdicts(jr, seed)
