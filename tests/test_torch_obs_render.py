"""The port's observability rendering (`crdt_tpu_torch.obs.render`,
`.trajectory`, the rendering half of `.fleet`, and the ``python -m
crdt_tpu_torch.obs`` command line) against the JAX package's, on the
CPU: the same text, byte for byte, from snapshots of both packages'
registries driven by the same seeded ops, one trace JSONL, the
trajectory fixtures, and live servers of either package.
"""

import io
import json
import os
import random

import numpy as np
import pytest

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu.obs import cli as jcli
from crdt_tpu.obs import fleet as jfleet
from crdt_tpu.obs import registry as jreg
from crdt_tpu.obs import render as jrender
from crdt_tpu.obs import trajectory as jtraj
from crdt_tpu.testing import FakeClock
from crdt_tpu.utils.stats import MergeStats as JaxMergeStats
from crdt_tpu_torch.obs import cli as pcli
from crdt_tpu_torch.obs import fleet as pfleet
from crdt_tpu_torch.obs import registry as preg
from crdt_tpu_torch.obs import render as prender
from crdt_tpu_torch.obs import trajectory as ptraj
from crdt_tpu_torch.obs.trace import TraceRing
from crdt_tpu_torch.utils.stats import MergeStats as PortMergeStats

import test_torch_fleet as tf
from torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
BASELINE = os.path.join(FIX, "trajectory_baseline.jsonl")
CLEAN = os.path.join(FIX, "trajectory_clean.jsonl")
REGRESSED = os.path.join(FIX, "trajectory_regressed.jsonl")
PKGS = {"jax": (jreg, JaxMergeStats), "port": (preg, PortMergeStats)}


def registry_snapshot(pkg, seed):
    """One registry of either package driven by the same seeded ops:
    labelled counters and gauges, log2 histograms, quantile sketches
    and an attached stats collector; plus the node and lag sections
    the ``metrics`` wire op adds."""
    reg_mod, stats_cls = PKGS[pkg]
    rng = np.random.default_rng(seed)
    reg = reg_mod.MetricsRegistry()
    for i in range(int(rng.integers(1, 4))):
        reg.counter(f"crdt_tpu_test_{i}_total", "c").inc(
            int(rng.integers(1, 9)), node=f"n{i}", lane="wire")
    g = reg.gauge("crdt_tpu_test_queue_depth", "g")
    for node in ("a", "b"):
        g.set(float(rng.integers(0, 100)), node=node)
    h = reg.histogram("crdt_tpu_test_seconds", "h")
    sk = reg.sketch("crdt_tpu_test_seconds_sketch", "s")
    for v in rng.lognormal(-5.0, 1.5, 64):
        h.observe(float(v), op="merge")
        sk.observe(float(v), op="merge")
    stats = stats_cls()
    stats.merges = int(rng.integers(0, 50))
    stats.records_seen = int(rng.integers(0, 500))
    reg.attach("merge", stats, backend="dense", node="n0")
    snap = reg.snapshot()
    snap["node"] = {"node_id": "n0", "hlc_head": "2024-01-01T00:00:00.000Z-0000-n0"}
    snap["lag"] = {"b": {"synced": True, "lag_ms": int(rng.integers(0, 9000)),
                         "seconds_behind": 1.5, "pending_records": 3}}
    # the stats object must outlive the snapshot's weak reference
    return snap, stats


@pytest.mark.parametrize("seed", range(4))
def test_renderers_match_jax_on_both_registries(seed):
    j_snap, _j = registry_snapshot("jax", seed)
    p_snap, _p = registry_snapshot("port", seed)
    assert json.dumps(p_snap, sort_keys=True) == json.dumps(j_snap,
                                                            sort_keys=True)
    for fn in ("render_prometheus", "render_summary"):
        want = getattr(jrender, fn)(j_snap)
        assert getattr(prender, fn)(p_snap) == want
        assert getattr(prender, fn)(j_snap) == want


def write_trace(path, seed):
    """A trace JSONL from the port's tracer: spans of a few kinds with
    seeded durations, one event without ``dur_s`` and a torn tail."""
    rng = np.random.default_rng(seed)
    ring = TraceRing(capacity=256)
    ring.enable(jsonl_path=path)
    for _ in range(40):
        kind = ["merge", "gossip_round", "flush"][int(rng.integers(0, 3))]
        ring.emit(kind, span=f"{kind}.body", dur_s=float(rng.exponential(0.01)))
    ring.emit("breaker", peer="b")
    ring.disable()
    with open(path, "a") as fh:
        fh.write("{torn json\n")


def test_trace_summary_matches_jax(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    write_trace(path, 3)
    events = []
    with open(path) as fh:
        for line in fh:
            try:
                events.append(json.loads(line))
            except ValueError:
                pass
    assert len(events) == 41
    summary = psum = prender.summarize_trace(events)
    assert psum == jrender.summarize_trace(events)
    assert prender.format_phase_table(summary) == \
        jrender.format_phase_table(summary)
    assert prender.format_phase_table({}) == jrender.format_phase_table({})
    out_p, out_j = io.StringIO(), io.StringIO()
    assert pcli.main(["--trace", path, "--device", "cpu"], out=out_p) == \
        jcli.main(["--trace", path], out=out_j) == 0
    assert out_p.getvalue() == out_j.getvalue()


# ------------------------------------------------------------ trajectory

BENCH_ARGS = [
    ["--compare", BASELINE, "--candidate", REGRESSED],
    ["--compare", BASELINE, "--candidate", CLEAN],
    ["--compare", BASELINE, "--candidate", REGRESSED, "--json"],
    ["--compare", BASELINE, "--candidate", CLEAN, "--json"],
    ["--compare", BASELINE, "--candidate", REGRESSED, "--budget", "2.0"],
    ["--compare", BASELINE],
]


@pytest.mark.parametrize("argv", BENCH_ARGS,
                         ids=lambda a: "-".join(os.path.basename(x)
                                                for x in a))
def test_bench_gate_matches_jax(argv):
    out_p, out_j = io.StringIO(), io.StringIO()
    rc_p = pcli.main(["bench", *argv, "--device", "cpu"], out=out_p)
    rc_j = jcli.main(["bench", *argv], out=out_j)
    assert rc_p == rc_j
    assert out_p.getvalue() == out_j.getvalue()


def test_trajectory_functions_match_jax(tmp_path):
    records = {}
    for path in (BASELINE, CLEAN, REGRESSED):
        recs = ptraj.load_trajectory(path)
        assert recs == jtraj.load_trajectory(path)
        records[path] = recs
        for rec in recs:
            flat = ptraj.flatten_metrics(rec)
            assert flat == jtraj.flatten_metrics(rec)
            assert [ptraj.metric_direction(k) for k in flat] == \
                [jtraj.metric_direction(k) for k in flat]
    pool = records[BASELINE]
    for cand in records[CLEAN] + records[REGRESSED]:
        assert ptraj.compare(pool, cand) == jtraj.compare(pool, cand)
        assert ptraj.compare(pool, cand, budget_frac=2.0, pool=2) == \
            jtraj.compare(pool, cand, budget_frac=2.0, pool=2)
    assert ptraj.host_class() == jtraj.host_class()
    result = {"merge_ms": 1.5, "rows": 7, "ok": True,
              "cold_peer": {"bytes_per_s": 2e6}, "slo": {"ok": True}}
    kw = dict(run_id="r1", sha="abc", host="cpu-x86_64-cpu8", smoke=True)
    rec = ptraj.normalize_record("ingest", result, **kw)
    assert rec == jtraj.normalize_record("ingest", result, **kw)
    for mod, name in ((ptraj, "p.jsonl"), (jtraj, "j.jsonl")):
        for r in pool + [rec]:
            mod.append_record(r, str(tmp_path / name))
    assert (tmp_path / "p.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()


# ----------------------------------------------------------------- fleet


def fleet_snapshots(pkg, seed):
    """`test_torch_fleet.fleet`'s seeded fleet, with partition and
    storage-plane sections and shipped-byte counters."""
    snaps = tf.fleet(pkg, seed)
    rng = np.random.default_rng(100 + seed)
    for i, (name, snap) in enumerate(sorted(snaps.items())):
        if "_scrape_error" in snap:
            continue
        snap["partition"] = {
            "addr": f"127.0.0.1:{7000 + i}", "epoch": int(rng.integers(1, 9)),
            "slots": int(rng.integers(1, 1 << 20)),
            "rows_committed": int(rng.integers(0, 10_000)),
            "queue_depth": int(rng.integers(0, 64)),
            "shed": int(rng.integers(0, 3)),
            "last_scale": ({"action": "split", "epoch": 3} if i % 2
                           else None)}
        if i % 3 != 2:
            snap["stability"] = {"pinned": bool(i % 2),
                                 "stability_hlc": f"hlc{i}",
                                 "gc_floor": f"floor{i}" if i else None}
        snap.setdefault("counters", {})[
            "crdt_tpu_shipped_live_bytes_total"] = [
            {"labels": {"surface": "migrate"},
             "value": float(rng.integers(0, 1 << 20))}]
    return snaps


@pytest.mark.parametrize("seed", range(6))
def test_fleet_renderers_match_jax(seed):
    j_snaps = fleet_snapshots("jax", seed)
    p_snaps = fleet_snapshots("port", seed)
    for snaps in (j_snaps, p_snaps):
        matrix = jfleet.lag_matrix(snaps)
        assert pfleet.render_federation(snaps) == \
            jfleet.render_federation(snaps)
        assert pfleet.render_federation(snaps, matrix) == \
            jfleet.render_federation(snaps, matrix)
        assert pfleet.format_matrix(matrix) == jfleet.format_matrix(matrix)
        health = jfleet.replica_health(snaps)
        assert pfleet.format_replicas(health) == \
            jfleet.format_replicas(health)
        for fn in ("format_partitions", "format_storage"):
            assert getattr(pfleet, fn)(snaps) == getattr(jfleet, fn)(snaps)
    assert pfleet.render_federation(p_snaps) == \
        jfleet.render_federation(j_snaps)
    assert pfleet.format_matrix({"origins": []}) == \
        jfleet.format_matrix({"origins": []})


def _node(mod, name, n=32):
    clk = FakeClock()
    return mod.GossipNode(mod.DenseCrdt(name, n, wall_clock=clk,
                                        **({"device": "cpu"}
                                           if mod is port else {})),
                          rng=random.Random(7), sleep=lambda s: None)


def test_fleet_command_exit_codes_match_jax():
    results = {}
    for mod, main in ((crdt_tpu, jcli.main), (port, pcli.main)):
        a, b = _node(mod, "fleet-a"), _node(mod, "fleet-b")
        with a, b:
            a.enable_canary(0, 2)
            b.enable_canary(1, 2)
            a.add_peer("b", b.host, b.port)
            b.add_peer("a", a.host, a.port)
            for _ in range(2):
                assert a.run_round() == {"b": "ok"}
                assert b.run_round() == {"a": "ok"}
            spec = f"a={a.host}:{a.port},b={b.host}:{b.port}"
            extra = ["--device", "cpu"] if mod is port else []
            runs = []
            for args in (["--lag-budget", "1e9"], ["--lag-budget", "-1"]):
                out = io.StringIO()
                rc = main(["fleet", "--peers", spec, "--once", "--json",
                           *args, *extra], out=out)
                doc = json.loads(out.getvalue())
                runs.append((rc, doc["matrix"]["complete"],
                             doc["matrix"]["origins"],
                             doc["slo"]["checks"]["convergence_lag_s"]["ok"]))
            results[mod] = runs
    assert results[port] == results[crdt_tpu] == [
        (0, True, ["0", "1"], True), (1, True, ["0", "1"], False)]


# ------------------------------------------------------- the poll command


def _fixed_snapshot(monkeypatch, mod, reg_mod, stats_cls, seed):
    """Make ``mod``'s ``metrics`` op serve a fresh registry driven by
    the seeded ops of `registry_snapshot`."""
    keep = []

    def snapshot():
        snap, stats = registry_snapshot(
            "jax" if reg_mod is jreg else "port", seed)
        keep.append(stats)
        del snap["node"], snap["lag"]
        return snap

    monkeypatch.setattr(mod.obs, "metrics_snapshot", snapshot)


@pytest.mark.parametrize("mode", [[], ["--json"], ["--prom"]])
def test_poll_once_output_matches_jax(mode, monkeypatch):
    """``--once`` against a port `SyncServer` (the port's command) and
    a JAX one (the JAX command): the same replica script and registry
    ops behind each, the same text out."""
    outs = {}
    for mod, reg_mod, stats_cls, main, extra in (
            (crdt_tpu, jreg, JaxMergeStats, jcli.main, []),
            (port, preg, PortMergeStats, pcli.main, ["--device", "cpu"])):
        _fixed_snapshot(monkeypatch, mod, reg_mod, stats_cls, 5)
        kw = {"device": "cpu"} if mod is port else {}
        crdt = mod.DenseCrdt("obs-cli", 16, wall_clock=FakeClock(), **kw)
        crdt.put_batch([1, 2], [3, 4])
        with mod.SyncServer(crdt) as srv:
            out = io.StringIO()
            rc = main([f"{srv.host}:{srv.port}", "--once", *mode, *extra],
                      out=out)
        outs[mod] = (rc, out.getvalue())
    assert outs[port] == outs[crdt_tpu]
    assert outs[port][0] == 0
    assert ("obs-cli" in outs[port][1]) == (mode != ["--prom"])


def test_poll_failure_exit_code_matches_jax():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        target = f"127.0.0.1:{s.getsockname()[1]}"
    assert pcli.main([target, "--once", "--device", "cpu"],
                     out=io.StringIO()) == \
        jcli.main([target, "--once"], out=io.StringIO()) == 1
