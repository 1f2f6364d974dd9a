"""The port's replica groups (`crdt_tpu_torch.replication`) against the
JAX package's (`crdt_tpu.replication`), on the CPU:

- the write-concern barrier: a primary tier with a `Replicator` ships
  each flush tick to a follower tier through a `RecordingProxy`; for a
  scripted run of writes (each acknowledged before the next, so each is
  one tick) the ``replicate`` frames, both replicas' lanes and clocks
  equal the JAX-JAX run's, with the port on either end or both;
- a `ReplicaGroup` of three ``device="cpu"`` members: two kills of the
  primary, each ridden out by the routed client and followed by a
  rejoin, lose no acknowledged write (read back from the new primary
  and, once converged, from every member), advance the routing epoch
  on every failover, and end with one digest root on every member;
- the device rule: with no card a group with neither ``device`` nor
  ``make_crdt`` raises at construction.

Every socket binds port 0; groups, tiers and clients close in context
managers or ``finally``; deadlines are generous hang guards, and no
elapsed time is asserted.
"""

import functools
import socket
import time

import numpy as np
import pytest
import torch

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import net as jnet
from crdt_tpu import replication as jrep
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch import net as pnet
from crdt_tpu_torch import replication as prep

from torch_threads import cap_torch_threads
from torch_wire import RecordingProxy, frames

cap_torch_threads()

PKGS = {"jax": crdt_tpu, "port": port}
NETS = {"jax": jnet, "port": pnet}
REPS = {"jax": jrep, "port": prep}
N = 512


def replica(pkg, node, n=N):
    if pkg == "jax":
        return crdt_tpu.DenseCrdt(node, n, wall_clock=FakeClock())
    return port.DenseCrdt(node, n, device="cpu", wall_clock=FakeClock())


def lanes(c):
    return {f: np.asarray(getattr(c.store, f)) for f in c.store._fields}


def _req(net, sock, obj, codec=None):
    net.send_frame(sock, obj, None, codec)
    return net.recv_frame(sock, deadline=time.monotonic() + 30.0,
                          codec=codec)


@functools.lru_cache(maxsize=None)
def ship_run(primary_pkg, follower_pkg):
    """Scripted ticks on a ``primary_pkg`` primary replicating to a
    ``follower_pkg`` follower: (acks, frames of the replicator's
    connection, primary and follower lanes and clocks, the follower's
    durable head as the primary saw it)."""
    rng = np.random.default_rng(11)
    slots = rng.choice(N, 20, replace=False).tolist()
    vals = rng.integers(-2 ** 40, 2 ** 40, 20).tolist()
    p, f = replica(primary_pkg, "rp"), replica(follower_pkg, "rf")
    net = NETS[primary_pkg]
    acks = []
    with PKGS[follower_pkg].ServeTier(f) as ft, \
            RecordingProxy(ft.host, ft.port) as proxy:
        with PKGS[primary_pkg].ServeTier(p, flush_interval=0.002) as pt:
            rep = REPS[primary_pkg].Replicator(
                pt, {"f1": f"{proxy.host}:{proxy.port}"},
                ack_replicas=1, timeout=30.0, group="gt")
            pt.replicator = rep
            try:
                with socket.create_connection((pt.host, pt.port),
                                              timeout=30.0) as sock:
                    for s, v in zip(slots[:12], vals[:12]):
                        acks.append(_req(net, sock, {"op": "put",
                                                     "slot": s,
                                                     "value": v}))
                    for s in slots[:3]:
                        acks.append(_req(net, sock, {"op": "delete",
                                                     "slot": s}))
                    _req(net, sock, {"op": "hello", "proto": 1,
                                     "caps": ["binop"]})
                    st, _, _ = net.binop_round(
                        sock, [net.BINOP_PUT] * 8, slots[12:], vals[12:],
                        codec=net.FrameCodec(compress=False))
                    acks.append(st.tolist())
                durable = rep.status()["f1"]["durable"]
            finally:
                pt.replicator = None
                rep.close()
        streams = proxy.streams()
    return (acks, [(frames(a), frames(b)) for a, b in streams], lanes(p),
            str(p.canonical_time), lanes(f), str(f.canonical_time),
            durable)


@pytest.mark.parametrize("primary_pkg,follower_pkg",
                         [("port", "port"), ("port", "jax"),
                          ("jax", "port")])
def test_barrier_ship_frames_match_jax(primary_pkg, follower_pkg):
    got, want = ship_run(primary_pkg, follower_pkg), ship_run("jax", "jax")
    assert got[0] == want[0]
    assert all(a == {"ok": True} for a in want[0][:-1])
    assert want[0][-1] == [jnet.BINOP_ST_OK] * 8
    # One replicator connection: hello, then one replicate per tick.
    assert len(got[1]) == len(want[1]) == 1
    assert got[1] == want[1]
    ops = [f for f in want[1][0][0] if f.startswith(b'{"op": "replicate"')]
    assert len(ops) == 16
    for i in (2, 4):
        for name in want[i]:
            np.testing.assert_array_equal(got[i][name], want[i][name],
                                          err_msg=name)
    assert got[3] == want[3] and got[5] == want[5]
    assert got[6] == want[6] == want[5]


# --- a group of three card-less members: failover without acked loss ---

TIMINGS = dict(flush_interval=0.002, heartbeat_interval=0.05,
               heartbeat_timeout=1.0, lease_misses=3)


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.01)


def _roots(group):
    roots = []
    for m in group.members:
        tier = m.tier
        if m.role == "down" or tier is None or tier.killed:
            continue
        with tier.lock:
            roots.append(int(tier.crdt.digest_tree().root))
    return roots


def test_group_failover_and_rejoin_lose_no_acked_write():
    with prep.ReplicaGroup(256, replicas=3, ack_replicas=1,
                           device="cpu", **TIMINGS) as group:
        seeds = group.member_addrs()
        cli = port.FederatedClient(seeds, timeout=10.0)
        acked = {}
        try:
            for s in range(0, 64, 4):
                cli.put(s, 1000 + s)
                acked[s] = 1000 + s
            for cycle in range(2):
                epoch = group.table.epoch
                dead = group.kill_primary()
                # The routed client rides out detection and promotion.
                cli.put(200 + cycle, 9000 + cycle)
                acked[200 + cycle] = 9000 + cycle
                cli.refresh()
                assert cli.table.epoch > epoch
                assert group.failovers == cycle + 1
                primary = group.primary
                assert primary is not None and primary is not dead
                with primary.tier.lock:
                    got = {s: primary.tier.crdt.get(s) for s in acked}
                assert got == acked
                member = group.rejoin(dead.index)
                assert member.role == "follower"
                _wait(lambda: all(m.role != "down"
                                  for m in group.members), "rejoin")
            # Converged: nudge writes re-arm the tick so the replicator
            # ships every follower to head; then every member holds
            # every acked write and all roots agree.
            bump = 0
            deadline = time.monotonic() + 60.0
            while True:
                bump += 1
                cli.put(255, bump)
                roots = _roots(group)
                if len(roots) == 3 and len(set(roots)) == 1:
                    break
                assert time.monotonic() < deadline, "no convergence"
                time.sleep(0.05)
            acked[255] = bump
            for m in group.members:
                with m.tier.lock:
                    got = {s: m.tier.crdt.get(s) for s in acked}
                assert got == acked, m.name
        finally:
            cli.close()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default places members on the card")
def test_group_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        prep.ReplicaGroup(64, replicas=2)
    assert prep.ReplicaGroup(64, replicas=2,
                             device="cpu").device.type == "cpu"
    made = prep.ReplicaGroup(
        64, replicas=2, make_crdt=lambda i, g: port.DenseCrdt(
            f"m{i}.{g}", 64, device="cpu"))
    assert made.device is None
