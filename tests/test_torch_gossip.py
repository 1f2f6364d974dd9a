"""The port's gossip runtime (`crdt_tpu_torch.gossip`) against the JAX
package's (`crdt_tpu.gossip`), on the CPU over loopback sockets:

- the retry policy's jittered delays and the circuit breaker's
  transitions on the same injected rng and clock;
- the wire ladder (merkle -> packed -> dense -> JSON) against JAX
  peers: a dense peer of the same width (a merkle walk, then packed
  rounds), a JSON-only `MapCrdt` (capability selection to dense, then
  the sticky fallback to JSON), a pre-hello legacy server, and a
  narrower dense peer that refuses every form in turn; a port node and
  a JAX node run the same script and end with the same per-peer
  counters (bytes included) and the same replicas;
- retry, backoff and breaker transitions against a dead peer with
  injected ``clock``/``sleep``/``rng`` (no real sleeps), equal to
  JAX's;
- a restart that resumes from the persisted watermark (a delta pull),
  and the watermark file read by either package;
- convergence with a JAX peer through the port's seeded `FaultProxy`,
  whose fault draws equal the JAX proxy's;
- the pipelined sweep, the lag / health / stability snapshots, GC and
  the canary, and the collective lane's refusal (ROADMAP A9).

Every socket binds port 0; nothing asserts an upper bound on elapsed
time; every node is closed by a context manager.
"""

import random
import socket

import numpy as np
import pytest

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import gossip as jgossip
from crdt_tpu import testing_faults as jfaults
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch import gossip as pgossip
from crdt_tpu_torch import testing_faults as pfaults

from test_net_fastpath import _LegacyServer
from torch_threads import cap_torch_threads

cap_torch_threads()

PKGS = {"jax": (crdt_tpu, jgossip), "port": (port, pgossip)}
N = 1000


class MonotonicStub:
    """Injectable seconds clock for the breaker's cool-downs."""

    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def dead_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dense(pkg, node, n=N):
    if pkg == "jax":
        return crdt_tpu.DenseCrdt(node, n, wall_clock=FakeClock())
    return port.DenseCrdt(node, n, device="cpu", wall_clock=FakeClock())


def node(pkg, crdt, **kw):
    kw.setdefault("rng", random.Random(7))
    kw.setdefault("sleep", lambda _s: None)
    return PKGS[pkg][1].GossipNode(crdt, **kw)


def lanes(c):
    return {f: np.asarray(getattr(c.store, f)) for f in c.store._fields}


def assert_same_lanes(x, y, skip_vals=()):
    for f, lane in lanes(x).items():
        other = lanes(y)[f]
        if f == "val" and skip_vals:
            # canary beats carry the host's wall clock
            lane, other = np.delete(lane, skip_vals), np.delete(
                other, skip_vals)
        np.testing.assert_array_equal(lane, other, f)
    assert str(x.canonical_time) == str(y.canonical_time)


def writes(c, seed, hi=N, rows=60):
    rng = np.random.default_rng(seed)
    slots = rng.choice(hi, rows, replace=False)
    c.put_batch(slots, rng.integers(-2 ** 31, 2 ** 31, rows))


# --- policies -----------------------------------------------------------------


@pytest.mark.parametrize("attempts", [1, 3, 6, 9])
def test_retry_delays_match_jax(attempts):
    draws = []
    for g in (jgossip, pgossip):
        policy = g.RetryPolicy(max_attempts=6, base_delay=0.1,
                               max_delay=1.0)
        rng = random.Random(42)
        draws.append([policy.delay(attempts, rng) for _ in range(50)])
    assert draws[0] == draws[1]


def breaker_trace(g):
    clk = MonotonicStub()
    stats = (crdt_tpu if g is jgossip else port).gossip.PeerSyncStats()
    br = g.CircuitBreaker(g.BreakerPolicy(failure_threshold=2,
                                          reset_timeout=10.0),
                          clock=clk, stats=stats)
    out = []
    for step in ("f", "f", "a", "t11", "a", "f", "a", "t11", "a", "s",
                 "f", "s", "f", "f", "a"):
        if step == "f":
            br.record_failure()
        elif step == "s":
            br.record_success()
        elif step == "a":
            out.append(br.allow())
        else:
            clk.advance(float(step[1:]))
        out.append((br.state, br.failures))
    return out, stats.as_dict()


def test_breaker_transitions_match_jax():
    assert breaker_trace(pgossip) == breaker_trace(jgossip)


def test_collective_group_is_refused():
    c = dense("port", "a", 64)
    with pytest.raises(NotImplementedError, match="A9"):
        pgossip.GossipNode(c, group=object())
    with node("port", c) as n:
        with pytest.raises(NotImplementedError, match="A9"):
            n.attach_group(object())
        n.attach_group(None)


# --- the wire ladder against JAX peers ------------------------------------------


def ladder_run(pkg):
    """Four JAX peers, one local node of ``pkg``; returns the node's
    counters and every replica."""
    a = dense(pkg, "a")
    writes(a, 1)
    peers = {
        "same": jgossip.GossipNode(crdt_tpu.DenseCrdt(
            "same", N, wall_clock=FakeClock())),
        "map": jgossip.GossipNode(crdt_tpu.MapCrdt(
            "map", wall_clock=FakeClock()), key_decoder=int),
        # A narrower peer: it refuses the local rows at slots >= 600
        # in merkle (geometry), packed, dense (capacity) and JSON in
        # turn.
        "narrow": jgossip.GossipNode(crdt_tpu.DenseCrdt(
            "narrow", 600, wall_clock=FakeClock())),
    }
    writes(peers["same"].crdt, 2)
    peers["map"].crdt.put(7, 70)
    legacy_crdt = crdt_tpu.DenseCrdt("old", N, wall_clock=FakeClock())
    writes(legacy_crdt, 3)
    outcomes = []
    with node(pkg, a) as n, _LegacyServer(legacy_crdt) as legacy:
        for p in peers.values():
            p.start()
        try:
            for name, p in peers.items():
                n.add_peer(name, p.host, p.port)
            n.add_peer("legacy", legacy.host, legacy.port)
            for _ in range(2):
                for name in ("same", "map", "legacy", "narrow"):
                    outcomes.append((name, n.sync_peer(name),
                                     n.peers[name].last_attempt,
                                     n.peers[name].mode))
                    n.peers["legacy"].conn.reset()
                with n.lock:
                    writes(a, 4)
            snap = n.stats_snapshot()
            err = type(n.peers["narrow"].last_error).__name__
        finally:
            for p in peers.values():
                p.stop()
    return outcomes, snap, err, a, peers, legacy_crdt


def test_ladder_against_jax_peers_matches_a_jax_node():
    ref = ladder_run("jax")
    got = ladder_run("port")
    assert got[0] == ref[0]           # outcomes, forms tried, modes
    assert got[2] == ref[2] == "SyncProtocolError"
    for name, row in ref[1].items():
        assert got[1][name] == row, name
    snap = got[1]
    assert snap["same"]["mode"] == "merkle" and snap["same"]["fallbacks"] == 0
    assert snap["map"]["mode"] == "json" and snap["map"]["fallbacks"] == 1
    assert snap["legacy"]["mode"] == "json"
    assert snap["narrow"]["mode"] == "json"
    assert snap["narrow"]["fallbacks"] == 3
    assert snap["narrow"]["rounds_failed"] == 2
    assert_same_lanes(ref[3], got[3])
    for name in ("same", "narrow"):
        assert_same_lanes(ref[4][name].crdt, got[4][name].crdt)
    assert ref[4]["map"].crdt.to_json() == got[4]["map"].crdt.to_json()
    assert_same_lanes(ref[5], got[5])


# --- retry, backoff and the breaker against a dead peer ---------------------------


def dead_peer_run(pkg):
    clk, sleeps = MonotonicStub(), []
    n = node(pkg, dense(pkg, "a", 64), clock=clk, sleep=sleeps.append,
             retry=PKGS[pkg][1].RetryPolicy(max_attempts=3,
                                            base_delay=0.05),
             breaker=PKGS[pkg][1].BreakerPolicy(failure_threshold=2,
                                                reset_timeout=30.0))
    with n:
        peer = n.add_peer("ghost", "127.0.0.1", dead_port())
        trail = [n.sync_peer("ghost") for _ in range(3)]
        trail.append(peer.breaker.state)
        clk.advance(31.0)
        live = jgossip.GossipNode(crdt_tpu.DenseCrdt(
            "b", 64, wall_clock=FakeClock()))
        with live:
            live.crdt.put_batch([5], [50])
            peer.host, peer.port = live.host, live.port
            trail.append(n.sync_peer("ghost"))
        trail.append(peer.breaker.state)
        trail.append(n.crdt.get(5))
        stats = n.stats_snapshot()["ghost"]
    return trail, sleeps, stats


def test_retry_backoff_and_breaker_match_jax():
    ref = dead_peer_run("jax")
    got = dead_peer_run("port")
    assert got[0] == ref[0] == ["failed", "failed", "skipped", "open",
                                "ok", "closed", 50]
    assert got[1] == ref[1] and len(got[1]) == 4
    assert got[2] == ref[2]
    assert got[2]["breaker_opened"] == got[2]["breaker_half_open"] == 1


# --- restart from the persisted watermark ----------------------------------------


def test_restart_resumes_delta_from_persisted_watermark(tmp_path):
    state = str(tmp_path / "a.gossip.json")
    snap = str(tmp_path / "a.npz")
    b = jgossip.GossipNode(crdt_tpu.DenseCrdt("b", N,
                                              wall_clock=FakeClock()))
    writes(b.crdt, 5)
    with b:
        a = node("port", dense("port", "a"), state_path=state)
        with a:
            a.add_peer("b", b.host, b.port)
            assert a.sync_peer("b") == "ok"
            assert a.peers["b"].stats.full_pulls == 1
            mark = a.stats_snapshot()["b"]["watermark"]
            a.crdt.save(snap)
        assert str(port.load_gossip_state(state, "a")["b"]) == mark
        assert str(crdt_tpu.load_gossip_state(state, "a")["b"]) == mark
        with b.lock:
            writes(b.crdt, 6)
        restored = port.DenseCrdt.load("a", snap, device="cpu",
                                       wall_clock=FakeClock(
                                           start=1_700_000_100_000))
        a2 = node("port", restored, state_path=state)
        with a2:
            a2.add_peer("b", b.host, b.port)
            assert str(a2.peers["b"].watermark) == mark
            assert a2.sync_peer("b") == "ok"
            stats = a2.peers["b"].stats
            assert stats.full_pulls == 0 and stats.delta_pulls == 1
        with b.lock:
            for slot in range(N):
                assert restored.get(slot) == b.crdt.get(slot)
    with pytest.raises(ValueError, match="a"):
        pgossip.GossipNode(dense("port", "zz", 8), state_path=state)


# --- the seeded fault proxy ----------------------------------------------------


def test_fault_schedules_match_jax():
    for seed in (3, 11):
        j = jfaults.FaultSchedule(seed=seed, rate=0.7, max_delay=0.01)
        p = pfaults.FaultSchedule(seed=seed, rate=0.7, max_delay=0.01)
        assert [p.next_fault() for _ in range(40)] == \
            [j.next_fault() for _ in range(40)]


def test_convergence_through_seeded_fault_proxy():
    a = node("port", dense("port", "a"),
             retry=pgossip.RetryPolicy(max_attempts=6, base_delay=0.001,
                                       max_delay=0.01),
             breaker=pgossip.BreakerPolicy(failure_threshold=50))
    b = jgossip.GossipNode(crdt_tpu.DenseCrdt("b", N,
                                              wall_clock=FakeClock()),
                           rng=random.Random(7), sleep=lambda _s: None)
    with a, b:
        sched = pfaults.FaultSchedule(seed=11, rate=0.7, max_delay=0.01)
        with pfaults.FaultProxy(b.host, b.port, sched) as proxy:
            a.add_peer("b", proxy.host, proxy.port)
            for i in range(6):
                with a.lock:
                    writes(a.crdt, 10 + i, rows=20)
                with b.lock:
                    writes(b.crdt, 20 + i, rows=20)
                a.sync_peer("b")
            proxy.passthrough = True         # settle: faults off
            assert a.sync_peer("b") == "ok"
            assert a.sync_peer("b") == "ok"
            fired = {k: v for k, v in proxy.counters.items()
                     if k != "connections"}
            assert sum(fired.values()) > 0, proxy.counters
        with a.lock, b.lock:
            for slot in range(N):
                assert a.crdt.get(slot) == b.crdt.get(slot), slot
    assert a.peers["b"].stats.retries > 0


# --- the pipelined sweep, snapshots, GC and the canary -------------------------------


def sweep_run(pkg):
    from crdt_tpu_torch.obs import default_registry as preg
    from crdt_tpu.obs import default_registry as jreg
    reg = (jreg if pkg == "jax" else preg)()
    a = dense(pkg, "hub")
    writes(a, 30)
    peers = [jgossip.GossipNode(crdt_tpu.DenseCrdt(
        f"p{i}", N, wall_clock=FakeClock())) for i in range(3)]
    pipelined = reg.counter("crdt_tpu_gossip_pipelined_rounds_total")
    out = {}
    with node(pkg, a) as n:
        for p in peers:
            p.start()
        try:
            for i, p in enumerate(peers):
                writes(p.crdt, 40 + i)
                n.add_peer(p.crdt.node_id, p.host, p.port)
            before = pipelined.value(node="hub")
            out["first"] = n.run_round()          # walks, then packed
            with n.lock:
                writes(a, 31)
            out["second"] = n.run_round()         # pipelined
            out["pipelined"] = pipelined.value(node="hub") - before
            lag = n.lag_snapshot()
            out["lag"] = {k: (v["synced"], v["pending_records"],
                              v["breaker"]) for k, v in lag.items()}
            health = n.health()
            out["health"] = (health["status"], sorted(health))
            out["stability"] = str(n.stability_hlc())
            with n.lock:
                a.delete_batch([1, 2, 3])
            out["gc"] = n.gc_pass(drift_slack_ms=0)
            probe = n.enable_canary(0, 2)
            out["canary_slot"] = probe.slot
            n.run_round()
            out["canary"] = sorted(probe.snapshot())
            m = PKGS[pkg][0].fetch_metrics(n.host, n.port)
            out["metrics"] = sorted(m)
            out["stats"] = {k: {f: v[f] for f in ("rounds_ok", "mode",
                                                  "fallbacks",
                                                  "full_pulls",
                                                  "delta_pulls")}
                            for k, v in n.stats_snapshot().items()}
        finally:
            for p in peers:
                p.stop()
    return out, a, peers


def test_pipelined_sweep_and_snapshots_match_jax():
    ref, ra, rpeers = sweep_run("jax")
    got, ga, gpeers = sweep_run("port")
    assert got["pipelined"] == ref["pipelined"] == 1
    assert got == ref
    assert "lag" in got["metrics"] and "canary" in got["metrics"]
    canary = [N - 2, N - 1]
    assert_same_lanes(ra, ga, canary)
    for r, g in zip(rpeers, gpeers):
        assert_same_lanes(r.crdt, g.crdt, canary)
