"""The port's federated tier (`crdt_tpu_torch.federation`) against the
JAX package's (`crdt_tpu.federation`), on the CPU:

- one scripted elastic cycle on both packages — routed writes into two
  partitions, a live `split_hot`, writes from a client still holding
  the old table (each refused with ``moved`` and retried), then
  `merge_cold` of the recipient back into its donor — gives equal
  routing tables at every epoch (addresses named by their partition's
  node id, since the ports are ephemeral), equal lanes and clocks on
  every partition, and equal ``last_split`` / ``last_merge`` records
  less their timings and the process-wide ledger counts;
- a watch session on a partition that `merge_cold` retires gets the
  typed ``moved`` push, re-homes at the absorbing owner and keeps
  delivering, as the JAX package's test of it asserts (the JAX tier's
  own teardown stalls on the open session; see `test_torch_serve`);
- the device rule: with no card a `FederatedTier` with neither
  ``device`` nor ``make_crdt`` raises at construction.

Every partition replica has an injected wall clock, every write is
acknowledged before the next, and every client closes before the
tier that serves it is retired; deadlines are hang guards only.
"""

import functools
import time

import numpy as np
import pytest
import torch

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu.testing import FakeClock

from torch_threads import cap_torch_threads

cap_torch_threads()

PKGS = {"jax": crdt_tpu, "port": port}
N = 1024
TIMINGS = ("seconds", "flip_to_drain_seconds")


def replica(pkg, node, n=N):
    if pkg == "jax":
        return crdt_tpu.DenseCrdt(node, n, wall_clock=FakeClock())
    return port.DenseCrdt(node, n, device="cpu", wall_clock=FakeClock())


def lanes(c):
    return {f: np.asarray(getattr(c.store, f)) for f in c.store._fields}


def named_table(fed):
    """The table with each address replaced by its tier's node id."""
    name = {t.router.addr: str(t.crdt.node_id) for t in fed.tiers}
    return (fed.table.epoch,
            [(lo, hi, name.get(o, "retired")) for lo, hi, o
             in fed.table.ranges])


def named_record(fed, rec, names):
    out = {k: v for k, v in rec.items() if k not in TIMINGS}
    for k in ("src_addr", "dst_addr"):
        out[k] = names[out[k]]
    ev = dict(out["evidence"])
    ev.pop("ledger_ingest_dispatches", None)   # process-wide counts
    out["evidence"] = ev
    return out


def partition_state(fed):
    out = {}
    for t in fed.tiers:
        with t.lock:
            out[str(t.crdt.node_id)] = (lanes(t.crdt),
                                        str(t.crdt.canonical_time))
    return out


@functools.lru_cache(maxsize=None)
def elastic_cycle(pkg):
    mod = PKGS[pkg]
    rng = np.random.default_rng(21)
    slots = rng.choice(N, 120, replace=False).tolist()
    names = {}
    with mod.FederatedTier(N, partitions=2, flush_interval=0.002,
                           make_crdt=lambda i: replica(pkg, f"fed-p{i}")
                           ) as fed:
        for t in fed.tiers:
            names[t.router.addr] = str(t.crdt.node_id)
        t0 = named_table(fed)
        stale = mod.FederatedClient(fed.addrs(), timeout=30.0)
        try:
            cli = mod.FederatedClient(fed.addrs(), timeout=30.0)
            try:
                for s in slots[:80]:
                    cli.put(s, 3 * s + 1)
            finally:
                cli.close()
            # The same client keeps its epoch-0 table across the split.
            stale.put(slots[0], 7)
            split = fed.split_hot(src=0)
            for t in fed.tiers:
                names[t.router.addr] = str(t.crdt.node_id)
            t1 = named_table(fed)
            for s in slots[80:]:
                stale.put(s, 5 * s + 2)
            redirects = stale.moved_redirects
            reads = [stale.get(s) for s in slots]
            stale_epoch = stale.table.epoch
        finally:
            stale.close()
        state1 = partition_state(fed)
        recipient = [i for i, t in enumerate(fed.tiers)
                     if t.router.addr == split["dst_addr"]][0]
        merge = fed.merge_cold(src=recipient)
        t2 = named_table(fed)
        state2 = partition_state(fed)
        cli = mod.FederatedClient(fed.addrs(), timeout=30.0)
        try:
            after = [cli.get(s) for s in slots]
        finally:
            cli.close()
    return dict(tables=(t0, t1, t2), split=named_record(fed, split, names),
                merge=named_record(fed, merge, names),
                redirects=redirects, stale_epoch=stale_epoch,
                reads=reads, after=after, state1=state1, state2=state2)


def test_elastic_cycle_matches_jax():
    got, want = elastic_cycle("port"), elastic_cycle("jax")
    assert got["tables"] == want["tables"]
    assert got["tables"][1][0] == 1 and got["tables"][2][0] == 2
    assert got["split"] == want["split"]
    assert got["merge"] == want["merge"]
    assert got["split"]["migrated_rows"] > 0
    assert got["merge"]["migrated_rows"] > 0
    # The stale client was refused with `moved` and its retries landed.
    assert got["redirects"] == want["redirects"] > 0
    assert got["stale_epoch"] == want["stale_epoch"] == 1
    assert got["reads"] == want["reads"] == got["after"]
    assert None not in got["after"]
    for key in ("state1", "state2"):
        assert got[key].keys() == want[key].keys()
        for node, (lane, clock) in want[key].items():
            for f in lane:
                np.testing.assert_array_equal(got[key][node][0][f],
                                              lane[f], err_msg=(node, f))
            assert got[key][node][1] == clock, node


def test_split_migrates_exactly_the_donor_rows_of_the_range():
    got = elastic_cycle("port")
    split = got["split"]
    lo, hi = split["range"]
    mid = split["split_at"]
    donor, recipient = split["src_addr"], split["dst_addr"]
    d_lanes = got["state1"][donor][0]
    r_lanes = got["state1"][recipient][0]
    # Every occupied row of [mid, hi) on the donor is on the recipient
    # with the same record; the recipient holds nothing outside it.
    span = np.zeros(N, bool)
    span[mid:hi] = True
    np.testing.assert_array_equal(r_lanes["occupied"] & ~span,
                                  np.zeros(N, bool))
    moved = d_lanes["occupied"] & span
    assert moved.any()
    for f in ("lt", "node", "val", "tomb"):
        np.testing.assert_array_equal(r_lanes[f][moved], d_lanes[f][moved])


def test_watch_rehomes_across_merge_and_keeps_delivering():
    with port.FederatedTier(N, partitions=2, flush_interval=0.002,
                            device="cpu") as fed:
        donor = fed.tiers[0]
        slot = next(s for s in range(N)
                    if fed.table.owner_of(s) == donor.router.addr)
        cli = port.FederatedClient(fed.addrs(), timeout=30.0)
        watch = cli.watch(donor.router.addr, slots=[slot])
        try:
            cli.put(slot, 1)
            deadline = time.monotonic() + 60.0
            events = []
            while not events:
                assert time.monotonic() < deadline
                events = watch.next_event(timeout=30.0)
            assert events == [(slot, 1)]
            cli.close()
            stats = fed.merge_cold(src=0)
            assert stats["rehomed_watchers"] == 1
            cli = port.FederatedClient(fed.addrs(), timeout=30.0)
            cli.put(slot, 2)
            got = None
            while got != 2:
                assert time.monotonic() < deadline
                for s, v in watch.next_event(timeout=30.0):
                    if s == slot:
                        got = v
            assert watch.moved_rehomes == 1
            assert watch.addr == stats["dst_addr"]
        finally:
            watch.close()
            cli.close()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default places partitions on the card")
def test_federation_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        port.FederatedTier(64, partitions=2)
    assert port.FederatedTier(64, device="cpu").device.type == "cpu"
    made = port.FederatedTier(
        64, make_crdt=lambda i: port.DenseCrdt(f"p{i}", 64, device="cpu"))
    assert made.device is None


def test_federation_aware_fleet_rides_a_live_split_and_merge():
    """`torch_serve_fleet`'s federation-aware sessions against a port
    federation, a live `split_hot` and then a `merge_cold` inside their
    windows: every attempt is acknowledged, every ``moved`` is followed
    by an acknowledged retry, the epoch advances at each flip, and every
    acknowledged write reads back."""
    import os

    import torch_serve_fleet as fleet
    routing_py = os.path.join(os.path.dirname(port.__file__), "routing.py")
    with port.FederatedTier(N, partitions=4, flush_interval=0.002,
                            device="cpu") as fed:
        outs, flips = [], []
        for flip in ("split", "merge"):
            def act(start, flip=flip):
                time.sleep(max(0.0, start + 0.2 + 0.4 * 0.8
                               - time.monotonic()))
                if flip == "split":
                    flips.append(fed.split_hot())
                else:
                    dst = flips[0]["dst_addr"]
                    src = [t.router.addr for t in fed.tiers].index(dst)
                    flips.append(fed.merge_cold(src=src))
            seed = fed.tiers[0]
            outs.append(fleet.run(dict(
                mode="fed", sessions=24, rate=10.0, warmup=0.2,
                duration=0.8, host=seed.host, port=seed.port, n_slots=N,
                routing_py=routing_py), on_start=act))
        assert [f["epoch"] for f in flips] == [1, 2]
        assert fed.table.epoch == 2 and len(fed.tiers) == 4
        cli = port.FederatedClient(fed.addrs(), timeout=30.0)
        try:
            for out in outs:
                c = out["counters"]
                assert c["attempts"] == c["acked"] > 0
                assert c["errors"] == c["connect_failures"] == 0
                assert c["moved_then_acked"] <= c["moved"]
                for slot, value in out["last"]:
                    if out is outs[-1] or slot not in dict(outs[-1]["last"]):
                        assert cli.get(slot) == value, slot
        finally:
            cli.close()
        assert outs[0]["counters"]["moved"] > 0
