"""The port's fleet evaluation (`crdt_tpu_torch.obs.fleet`) and
dispatch ledger (`crdt_tpu_torch.obs.device`) against the JAX
package's, on the CPU, every comparison exact:

- seeded fleets of metrics snapshots (ack histograms and sketches, shed
  counters, topology-change gauges, canary and replication sections,
  scrape errors) recorded into each package's own registry: `lag_matrix`,
  `histogram_quantile`, `instance_sketch`, `fleet_sketch`,
  `replica_health`, `topology_stall_s` and `evaluate_slo` give equal
  dicts and quantiles, each package's functions on either package's
  snapshots;
- `parse_peers` and `poll_fleet` against live tiers of both packages;
- the ledger: `pow2_bucket`, `register` / `record` / `census` /
  `enabled` on a private ledger of each, and the default ledger's
  ``as_dict()`` deltas after the same model op script on a JAX replica
  (its XLA route) and a ``device="cpu"`` port replica (its plain route);
- one dispatch a call: each port entry point whose body runs another
  recorded op's work (a mask, a plain route, a sharded per-block loop)
  records its own name once and nothing else.
"""

import numpy as np
import pytest

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu.obs import device as jdev
from crdt_tpu.obs import fleet as jfleet
from crdt_tpu.obs import registry as jreg
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch.obs import device as pdev
from crdt_tpu_torch.obs import fleet as pfleet
from crdt_tpu_torch.obs import registry as preg

from torch_threads import cap_torch_threads

cap_torch_threads()

FLEETS = {"jax": jfleet, "port": pfleet}
REGS = {"jax": jreg, "port": preg}
NOW = 1_700_000_100_000.0


def instance(pkg, rng, name, with_sketch):
    reg = REGS[pkg].MetricsRegistry()
    ack = reg.histogram("crdt_tpu_serve_ack_seconds", "ack")
    sk = reg.sketch("crdt_tpu_serve_ack_seconds_sketch", "ack sketch")
    for v in rng.lognormal(-6.0, 1.0, 200):
        ack.observe(float(v), node=name)
        if with_sketch:
            sk.observe(float(v), node=name)
    shed = int(rng.integers(0, 3))
    if shed:
        reg.counter("crdt_tpu_serve_shed_total").inc(
            shed, lane="admission", node=name)
    if rng.integers(0, 2):
        g = reg.gauge("crdt_tpu_topology_change_inflight_since_ms")
        g.set(float(NOW - rng.integers(0, 60_000)) * int(
            rng.integers(0, 2)))
        reg.gauge("crdt_tpu_topology_change_progress_ms").set(
            float(NOW - rng.integers(0, 40_000)))
    return reg.snapshot()


def fleet(pkg, seed):
    """Four instances from one seed: the same draws on either package."""
    rng = np.random.default_rng(seed)
    snaps = {}
    for i, name in enumerate(["a", "b", "c", "d"]):
        snap = instance(pkg, rng, name, with_sketch=bool(seed % 2 or i))
        observed = {str(o): int(NOW - rng.integers(0, 9000))
                    for o in range(4) if rng.integers(0, 5)}
        snap["canary"] = {"origin": i, "observed": observed}
        role = ["primary", "follower", "follower", "primary"][i]
        if seed % 3 == 2 and i == 0:
            role = "follower"             # group g0 loses its primary
        snap["replication"] = {"group": f"g{i // 2}", "role": role,
                               "hlc_head": f"h{i}", "lease_ms": 10.0 * i}
        snaps[name] = snap
    if seed % 4 == 3:
        snaps["e"] = {"_scrape_error": "ConnectionRefusedError: x"}
    return snaps


def evaluate(mod, snaps):
    matrix = mod.lag_matrix(snaps)
    hq = [mod.histogram_quantile(s, q)
          for snap in snaps.values()
          for s in snap.get("histograms", {}).get(
              "crdt_tpu_serve_ack_seconds", [])
          for q in (0.5, 0.99, 1.0)]
    inst = [None if (sk := mod.instance_sketch(snap)) is None
            else (sk.count, sk.quantile(0.99)) for snap in snaps.values()]
    fs = mod.fleet_sketch(snaps)
    return dict(
        matrix=matrix, hq=hq, inst=inst,
        fleet=None if fs is None else (fs.count, fs.quantile(0.5),
                                       fs.quantile(0.99)),
        health=mod.replica_health(snaps),
        stall=mod.topology_stall_s(snaps, now_ms=NOW),
        slo=mod.evaluate_slo(snaps, now_ms=NOW),
        slo_tight=mod.evaluate_slo(snaps, ack_p99_budget_s=0.0146,
                                   convergence_budget_s=2.0,
                                   topology_stall_budget_s=5.0,
                                   now_ms=NOW))


@pytest.mark.parametrize("seed", range(8))
def test_fleet_evaluation_matches_jax(seed):
    snaps = {p: fleet(p, seed) for p in ("jax", "port")}
    want = evaluate(jfleet, snaps["jax"])
    assert evaluate(pfleet, snaps["jax"]) == want
    assert evaluate(pfleet, snaps["port"]) == want
    assert evaluate(jfleet, snaps["port"]) == want
    assert want["slo"]["ok"] in (True, False)


def test_parse_peers_matches_jax():
    for spec in ("a=h:1,b=h2:2", "h:5, ,x=[::1]:7", "solo:9"):
        assert pfleet.parse_peers(spec) == jfleet.parse_peers(spec)
    for bad in ("nohost", "a=h:"):
        with pytest.raises(ValueError) as je:
            jfleet.parse_peers(bad)
        with pytest.raises(ValueError) as pe:
            pfleet.parse_peers(bad)
        assert str(pe.value) == str(je.value)


def test_poll_fleet_reads_both_packages_tiers():
    a = port.DenseCrdt("pf-port", 64, device="cpu")
    b = crdt_tpu.DenseCrdt("pf-jax", 64)
    with port.ServeTier(a) as pt, crdt_tpu.ServeTier(b) as jt:
        peers = [("p", pt.host, pt.port), ("j", jt.host, jt.port),
                 ("dead", "127.0.0.1", 1)]
        got = {p: mod.poll_fleet(peers, timeout=10.0)
               for p, mod in FLEETS.items()}
    for polled in got.values():
        assert set(polled) == {"p", "j", "dead"}
        assert "_scrape_error" in polled["dead"]
        assert polled["p"]["node"]["node_id"] == "pf-port"
        assert polled["j"]["node"]["node_id"] == "pf-jax"
        assert "crdt_tpu_serve_sessions" in polled["p"]["gauges"]
    assert got["port"]["dead"] == got["jax"]["dead"]
    assert set(got["port"]["p"]) == set(got["jax"]["p"])


# --- the dispatch ledger ---

def test_pow2_bucket_matches_jax():
    for dim in (None, 0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 1 << 20):
        assert pdev.pow2_bucket(dim) == jdev.pow2_bucket(dim)


def ledger_script(pkg):
    reg = REGS[pkg].MetricsRegistry()
    mod = jdev if pkg == "jax" else pdev
    led = mod.DispatchLedger(reg)
    led.register("k.a", "k.b")
    for dim in (1, 3, 4, 5, 9, None, 3):
        with led.record("k.a", dim=dim):
            pass
    try:
        with led.record("k.b", dim=2):
            raise KeyError("not counted")
    except KeyError:
        pass
    led.enabled = False
    with led.record("k.a", dim=1):
        pass
    led.enabled = True
    snap = reg.snapshot()
    return (sorted(led.registered_kernels()), led.as_dict(),
            led.dispatches("k.a"), led.dispatches(),
            snap["counters"].get("crdt_tpu_device_dispatches_total"),
            snap["counters"].get("crdt_tpu_device_compiles_total"),
            [s["count"] for s in snap["histograms"].get(
                "crdt_tpu_device_dispatch_seconds", [])])


def test_ledger_records_like_jax():
    assert ledger_script("port") == ledger_script("jax")


def test_census_reports_lane_bytes_like_jax():
    reg_j, reg_p = jreg.MetricsRegistry(), preg.MetricsRegistry()
    j = crdt_tpu.DenseCrdt("cj", 1000)
    p = port.DenseCrdt("cp", 1000, device="cpu")
    nj = jdev.DispatchLedger(reg_j).census(j.store)
    np_ = pdev.DispatchLedger(reg_p).census(p.store)
    assert np_ == nj > 0
    assert reg_p.snapshot()["gauges"]["crdt_tpu_store_bytes"] == \
        reg_j.snapshot()["gauges"]["crdt_tpu_store_bytes"]


def replica(pkg, node, n):
    if pkg == "jax":
        return crdt_tpu.DenseCrdt(node, n, wall_clock=FakeClock())
    return port.DenseCrdt(node, n, device="cpu", wall_clock=FakeClock())


def model_script(pkg):
    """One op script on a model: writes outside and inside an ingest
    window, a fan-in merge, packed merges (sparse and wide), a split
    merge, packs (a cache hit included), the digest tree (a cache hit
    included), GC and compaction. Returns the default ledger's deltas."""
    led = (jdev if pkg == "jax" else pdev).default_ledger()
    rng = np.random.default_rng(4)
    n = 1024
    a, b = replica(pkg, "la", n), replica(pkg, "lb", n)
    b.put_batch(rng.choice(n, 40, replace=False), rng.integers(0, 99, 40))
    before = led.as_dict()
    a.put_batch([1, 2, 3], [10, 20, 30])
    a.delete_batch([2])
    with a.ingest():
        a.put_batch(rng.choice(n, 30, replace=False),
                    rng.integers(0, 99, 30))
        a.delete_batch([3])
    a.merge(*b.export_delta())
    b.put_batch(rng.choice(n, 8, replace=False), rng.integers(0, 99, 8))
    a.merge_packed(*b.pack_since(None))
    packed, ids = b.pack_since(a.canonical_time)
    a.merge_packed(packed, ids)
    a.merge_split(*b.export_split_delta())
    a.pack_since(None)
    a.pack_since(None)
    a.digest_tree()
    a.digest_tree()
    a.gc_purge(a.canonical_time, drift_slack_ms=0)
    a.compact()
    a.digest_tree()
    after = led.as_dict()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_default_ledger_counts_match_jax_on_a_model_script():
    got, want = model_script("port"), model_script("jax")
    assert got == want
    assert want.get("dense.ingest_scatter") == 1
    assert not any(k.startswith("pallas.") for k in got)


def _one_dispatch_calls():
    """Entry points whose bodies reach another recorded op's work (a
    plain route, a mask, a per-block loop), each with the one ledger
    name a call of it records on the CPU route."""
    import torch

    from crdt_tpu_torch import parallel as tp
    from crdt_tpu_torch.ops import dense as td
    from crdt_tpu_torch.ops import fanin_kernel as tk
    from crdt_tpu_torch.ops import ingest_kernel as ti
    from crdt_tpu_torch.ops import split as ts

    n, base = 64, 1_700_000_000_000 << 16
    rng = np.random.default_rng(12)

    def store():
        st = td.empty_dense_store(n, "cpu")
        td._ingest_scatter(st, torch.arange(0, n, 3),
                           torch.arange(0, n, 3) + base,
                           torch.arange(0, n, 3) * 7,
                           torch.zeros(len(range(0, n, 3)), dtype=torch.bool),
                           1)
        return st

    def changeset():
        valid = torch.tensor(rng.random((3, n)) < 0.5)
        return td.DenseChangeset(
            lt=torch.tensor(base + rng.integers(0, 1 << 20, (3, n))),
            node=torch.tensor(rng.integers(2, 5, (3, n)), dtype=torch.int32),
            val=torch.tensor(rng.integers(0, 99, (3, n))),
            tomb=torch.zeros((3, n), dtype=torch.bool), valid=valid)

    def state():
        return (torch.tensor(base), torch.tensor(False), torch.tensor(False),
                torch.tensor(False), torch.tensor(False),
                torch.tensor(-1, dtype=torch.int32))

    wall = (base >> 16) + 10
    rows = (torch.tensor([0, 5, 9, n]), torch.arange(4) + base + 99,
            torch.arange(4), torch.zeros(4, dtype=torch.bool))
    mesh = tp.make_fanin_mesh(1, 2, devices=["cpu"] * 2)
    k = torch.tensor([4, 7, 11])
    return {
        "range_delta_mask": (lambda: td.dense_range_delta_mask(
            store(), 0, torch.tensor([0]), torch.tensor([32])),
            "dense.range_delta_mask"),
        "merge_repack_step": (lambda: td.merge_repack_step(
            store(), k, k + base + 50, torch.full((3,), 2, dtype=torch.int32),
            k, torch.zeros(3, dtype=torch.bool),
            torch.ones(3, dtype=torch.bool), base + 60, 1, base),
            "dense.merge_repack_step"),
        "ingest_scatter": (lambda: ti.ingest_scatter(store(), *rows, 1),
                           "dense.ingest_scatter"),
        "model_fanin_batch": (lambda: tk.model_fanin_batch(
            store(), changeset(), base, 1, wall), "dense.fanin_step"),
        "pipelined_model_step": (lambda: tk.pipelined_model_step(
            store(), changeset(), *state(), 1, wall, wall + 1, 0),
            "dense.fanin_step"),
        "pipelined_model_step_split": (
            lambda: tk.pipelined_model_step_split(
                store(), ts.split_changeset(changeset()),
                np.arange(8, dtype=np.int32), *state(), 1, wall, wall + 1,
                0), "dense.fanin_step"),
        "sharded_ingest": (lambda: tp.make_sharded_ingest(mesh)(
            tp.shard_store(store(), mesh), *rows, 1),
            "parallel.sharded_ingest"),
        "sharded_delta_mask": (lambda: tp.sharded_delta_mask(mesh)(
            tp.shard_store(store(), mesh), base),
            "parallel.sharded_delta_mask"),
        "sharded_max_logical_time": (
            lambda: tp.sharded_max_logical_time(mesh)(
                tp.shard_store(store(), mesh)),
            "parallel.sharded_max_logical_time"),
    }


@pytest.mark.parametrize("entry", sorted(_one_dispatch_calls()))
def test_entry_point_records_one_dispatch(entry):
    """One call of an entry point is one dispatch in the ledger, under
    its own name, and nothing under the ops its body runs."""
    call, name = _one_dispatch_calls()[entry]
    led = pdev.default_ledger()
    before = led.as_dict()
    call()
    after = led.as_dict()
    assert {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)} == {name: 1}
    assert name in led.registered_kernels()
