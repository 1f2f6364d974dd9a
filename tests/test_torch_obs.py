"""The port's host observability (`crdt_tpu_torch.obs`,
`utils.stats`) against the JAX package's, on the CPU:

- the quantile sketch: the same buckets, quantiles, merges and wire
  bytes on seeded samples, and the same refusals;
- the metrics registry: counters, gauges, log2 histograms, sketches and
  the weakly held stats collectors give the same snapshot after the
  same calls; the same refusals;
- the trace ring (bounded, JSONL sink, rotation), spans with their
  histogram, round ids, the lag and health helpers and the flight
  recorder, event for event (times aside);
- the counters both packages' models bump: the same op script on a
  port `DenseCrdt` and a JAX one (ingest flushes, pack cache hits,
  misses and evictions, the fused repack, digest cache, GC, the fence,
  compaction, typed rows withheld both ways, watch events, checkpoints,
  pack-copy bytes, the merkle walk over TCP) grows every one of the
  port's counters by what it grows the JAX package's;
- `MergeStats` / `PeerSyncStats` as `tests/test_stats.py` holds them.
"""

import json
import random

import numpy as np
import pytest

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import obs as jobs
from crdt_tpu.obs import lag as jlag
from crdt_tpu.obs import recorder as jrecorder
from crdt_tpu.obs import registry as jregistry
from crdt_tpu.obs import sketch as jsketch
from crdt_tpu.obs import trace as jtrace
from crdt_tpu.testing import FakeClock
from crdt_tpu.utils import stats as jstats
from crdt_tpu_torch import obs as pobs
from crdt_tpu_torch.obs import lag as plag
from crdt_tpu_torch.obs import recorder as precorder
from crdt_tpu_torch.obs import registry as pregistry
from crdt_tpu_torch.obs import sketch as psketch
from crdt_tpu_torch.obs import trace as ptrace
from crdt_tpu_torch.utils import stats as pstats

from torch_threads import cap_torch_threads
from torch_wire import counter_deltas

cap_torch_threads()

SKETCH = (jsketch, psketch)


def lognormal(seed, n=2000):
    rng = random.Random(seed)
    return [rng.lognormvariate(-5, 1.2) for _ in range(n)]


# --- sketch -------------------------------------------------------------------


@pytest.mark.parametrize("seed,accuracy,max_bins", [
    (1, 0.01, 2048), (2, 0.02, 64), (3, 0.005, 16)])
def test_sketch_matches_jax(seed, accuracy, max_bins):
    out = []
    for mod in SKETCH:
        a = mod.QuantileSketch(accuracy, max_bins=max_bins)
        b = mod.QuantileSketch(accuracy, max_bins=max_bins)
        for v in lognormal(seed):
            a.record(v)
        for v in lognormal(seed + 10, 500):
            b.record(v, count=2)
        a.record(0.0)
        m = a.copy().merge(b)
        out.append((a.to_dict(), a.to_bytes(), m.to_dict(),
                    [m.quantile(q) for q in (0, 0.5, 0.9, 0.99, 1)],
                    mod.merge_sketches([a, b]).to_dict(),
                    mod.QuantileSketch.from_bytes(m.to_bytes()).to_dict(),
                    mod.sketch_quantile([{"labels": {}, "count": m.count,
                                          "sum": m.sum,
                                          "sketch": m.to_dict()}], 0.99)))
    assert out[0] == out[1]


@pytest.mark.parametrize("blob", [b"", b"NOPE" + bytes(40), b"\x00" * 9])
def test_sketch_refusals_match_jax(blob):
    errs = []
    for mod in SKETCH:
        with pytest.raises(ValueError) as e:
            mod.QuantileSketch.from_bytes(blob)
        errs.append(str(e.value))
    with pytest.raises(ValueError) as jx:
        jsketch.QuantileSketch(0.01).merge(jsketch.QuantileSketch(0.02))
    with pytest.raises(ValueError) as px:
        psketch.QuantileSketch(0.01).merge(psketch.QuantileSketch(0.02))
    assert errs[0] == errs[1] and str(jx.value) == str(px.value)


# --- registry -----------------------------------------------------------------


def registry_script(reg_mod, stats_mod):
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("c_total", "a counter")
    c.inc(node="a")
    c.inc(2.5, node="b", peer="x")
    g = reg.gauge("g", "a gauge")
    g.set(4, node="a")
    g.add(-1.5, node="a")
    h = reg.histogram("h_seconds", "a histogram", low_exp=-4, high_exp=3)
    for v in (0.01, 0.5, 3.0, 100.0, 0.0625):
        h.observe(v, span="s")
    sk = reg.sketch("sk_seconds", "a sketch")
    for v in lognormal(5, 300):
        sk.observe(v, node="a")
    ms = stats_mod.MergeStats(merges=3, puts=1).register(backend="B",
                                                         node="a")
    ps = stats_mod.PeerSyncStats(rounds_ok=2, bytes_sent=99)
    ps.register(node="a", peer="b")
    reg_default = reg_mod.default_registry()
    snap = reg.snapshot()
    own = {k: v for k, v in reg_default.snapshot()["stats"].items()}
    errors = []
    for bad in (lambda: c.inc(-1), lambda: reg.gauge("c_total"),
                lambda: reg_default.attach("merge", ms, backend="B",
                                           node="a")):
        try:
            bad()
        except Exception as e:  # noqa: BLE001 - compared below
            errors.append((type(e).__name__, str(e)))
    rows = [r for r in own.get("merge", []) if r["labels"]["node"] == "a"
            and r["labels"]["backend"] == "B"]
    peer = [r for r in own.get("peer_sync", [])
            if r["labels"] == {"node": "a", "peer": "b"}]
    return snap, rows, peer, errors, sk.quantile(0.99, node="a"), ms, ps


def test_registry_matches_jax():
    j = registry_script(jregistry, jstats)
    p = registry_script(pregistry, pstats)
    assert json.dumps(p[0]) == json.dumps(j[0])
    assert p[1:5] == j[1:5]
    assert len(p[3]) == 3


def test_metrics_snapshot_and_default_registry_exported():
    assert port.default_registry is pobs.default_registry
    assert set(port.metrics_snapshot()) == set(jobs.metrics_snapshot())
    assert pobs.default_registry() is pregistry.default_registry()


# --- trace ring, spans, round ids ---------------------------------------------------


def strip_times(events):
    return [{k: v for k, v in e.items() if k not in ("mono_s", "dur_s")}
            for e in events]


def trace_script(mod, tmp_path, tag):
    ring = mod.TraceRing(capacity=4)
    ring.emit("x", hlc=lambda: 1 / 0)            # disabled: not evaluated
    sink = str(tmp_path / f"{tag}.jsonl")
    ring.enable(jsonl_path=sink, max_sink_bytes=400)
    hlc = (crdt_tpu if mod is jtrace else port).Hlc(1_700_000_000_000,
                                                    3, "n")
    for i in range(7):
        ring.emit("merge", hlc=hlc if i % 2 else str(hlc), i=i,
                  peer="p")
    events = strip_times(ring.events())
    kinds = strip_times(ring.events("merge"))
    ring.disable()
    lines = []
    for path in (sink + ".1", sink):
        with open(path) as f:
            lines.append([{k: v for k, v in json.loads(line).items()
                           if k != "mono_s"} for line in f])
    return events, kinds, lines


def test_trace_ring_matches_jax(tmp_path):
    assert trace_script(ptrace, tmp_path, "p") == \
        trace_script(jtrace, tmp_path, "j")


def span_count(reg):
    hist = reg.default_registry().histogram("crdt_tpu_span_seconds")
    return sum(s["count"] for s in hist.samples()
               if s["labels"] == {"span": "torch_obs_test_span"})


def test_span_and_round_id_match_jax():
    """Each ring's ``seq`` and the span histogram's count are process
    counters that other test files in the same worker may have moved
    (`TraceRing.clear` keeps ``seq`` in both packages), so each is read
    relative to its own value just before the span: ``seq`` against a
    marker event emitted first, the count as a delta."""
    out = []
    for mod, reg in ((jtrace, jregistry), (ptrace, pregistry)):
        ring = mod.tracer()
        ring.clear()
        ring.enable()
        count0 = span_count(reg)
        try:
            ring.emit("torch_obs_test_marker")
            (marker,) = ring.events("torch_obs_test_marker")
            with mod.span("torch_obs_test_span", kind="merge", hlc="h",
                          node="n"):
                pass
            rid = mod.round_id("node")
        finally:
            ring.disable()
        events = [dict(e, seq=e["seq"] - marker["seq"])
                  for e in strip_times(ring.events("merge"))]
        out.append((events, rid.split(".")[0], rid.split(".")[1][0],
                    mod.round_id(None)[0], span_count(reg) - count0))
    assert out[0] == out[1]
    assert out[1][0][0]["span"] == "torch_obs_test_span"
    assert out[1][0][0]["seq"] == 1 and out[1][4] == 1


# --- lag, health, recorder -----------------------------------------------------


def test_lag_and_health_helpers_match_jax():
    out = []
    for pkg, mod in ((crdt_tpu, jlag), (port, plag)):
        head = pkg.Hlc(1_700_000_005_000, 2, "a")
        mark = pkg.Hlc(1_700_000_000_000, 0, "a")
        peers = {
            "b": mod.lag_entry(head, mark, pending=3, breaker="closed",
                               dense=True, last_error=None),
            "c": mod.lag_entry(head, None, pending=None, breaker="open",
                               dense=False,
                               last_error=ConnectionError("x")),
        }
        out.append((mod.lag_millis(head, mark), mod.lag_millis(head, None),
                    peers, mod.health_status(peers, stale_after_ms=1000),
                    mod.health_status({"b": peers["b"]},
                                      stale_after_ms=10_000)))
    assert out[0] == out[1]


def test_flight_recorder_matches_jax():
    out = []
    for mod in (jrecorder, precorder):
        rec = mod.FlightRecorder(capacity=2, throttle_s=60.0)
        source = lambda: {"lag": {"a": 0.1}}   # strong ref: weakly held
        rec.attach_source(source)
        b1 = rec.trigger("slo_failing", {"why": "test"})
        kinds = [rec.trigger("slo_failing"), rec.trigger("lease_fence"),
                 rec.trigger("lock_order_violation")]
        out.append((sorted(b1), b1["context"], b1["sources"],
                    [None if k is None else k["kind"] for k in kinds],
                    [b["kind"] for b in rec.bundles()],
                    [b["seq"] for b in rec.bundles()]))
    assert out[0] == out[1]


# --- the models' counters ----------------------------------------------------------


def op_script(pkg, tmp_path, tag):
    """One op script on a dense replica pair of ``pkg``; returns the
    growth of that package's counters."""
    reg = (jobs if pkg is crdt_tpu else pobs).default_registry()
    kw = {} if pkg is crdt_tpu else {"device": "cpu"}
    before = reg.snapshot()
    a = pkg.DenseCrdt(f"obs-{tag}-a", 512, wall_clock=FakeClock(), **kw)
    b = pkg.DenseCrdt(f"obs-{tag}-b", 512, wall_clock=FakeClock(), **kw)
    seen = []
    stream = a.watch()
    stream.listen(seen.append)
    with a.ingest(auto_flush_rows=100) as wc:
        for i in range(5):
            a.put_batch(np.arange(8 + 40 * i, 48 + 40 * i),
                        np.arange(40) * (i + 1))
        wc.flush()
        a.put_batch([300], [3])
        a.drain_ingest()
        a.put_batch([301], [4])
    a.delete_batch(np.arange(100, 140))
    b.put_batch(np.arange(200, 260), np.arange(60))
    for since in (None, None, a.canonical_time):
        a.pack_since(since)                   # miss, hit, miss
    for k in range(5):                        # past PACK_CACHE_SLOTS
        a.pack_since(pkg.Hlc(1_700_000_000_000 + k, 0, "x"))
    packed, ids = b.pack_since(None)
    a.merge_and_repack(packed, ids, since=a.canonical_time)
    a.digest_tree()
    a.digest_tree()
    with pkg.net.SyncServer(b) as server:
        with pkg.net.PeerConnection(server.host, server.port,
                                    timeout=30.0) as conn:
            pkg.net.sync_merkle_over_conn(a, conn, lock=server.lock)
            pkg.net.sync_merkle_over_conn(a, conn, lock=server.lock)
    a.set_semantics(range(4), "gcounter")
    a.counter_add(1, 5)
    purged = a.gc_purge(a.canonical_time, drift_slack_ms=0)
    # A replay below the GC floor onto purged slots: fenced.
    old = pkg.DenseCrdt(f"obs-{tag}-old", 512, wall_clock=FakeClock(), **kw)
    old.put_batch(np.arange(100, 110), np.arange(10))
    a.merge_packed(*old.pack_since(None))
    # Typed rows withheld: outbound to an LWW pack, inbound from one.
    a.pack_since(None, sem_mode="withhold")
    t = pkg.DenseCrdt(f"obs-{tag}-t", 512, wall_clock=FakeClock(), **kw)
    t.put_batch([1, 2, 400], [9, 9, 9])
    a.merge_packed(*t.pack_since(None))
    a.compact(ranges=((256, 512),))
    path = str(tmp_path / f"{tag}.npz")
    a.save(path)
    pkg.load_dense(path, **kw)
    pkg.checkpoint.save_json(b, str(tmp_path / f"{tag}.json"))
    pkg.checkpoint.save_gossip_state(str(tmp_path / f"{tag}.g"), "a",
                                     {"b": a.canonical_time})
    # A lane in a foreign dtype costs a pack-path copy.
    delta = b.pack_since(None)[0]
    pkg.ops.packing.pack_rows(delta._replace(
        slots=np.asarray(delta.slots, np.int64)))
    stream.cancel()
    return (counter_deltas(before, reg.snapshot()), purged, len(seen),
            str(a.canonical_time).replace(f"obs-{tag}-", "obs-"))


# The counters the port's models and wire bump (the JAX package's
# device-dispatch ledger counts XLA dispatches and is not ported).
def port_counters(deltas):
    return {k: v for k, v in deltas.items()
            if not k[0].startswith("crdt_tpu_device_")}


def relabel(deltas, tag):
    return {(name, tuple((k, v.replace(f"obs-{tag}-", "obs-"))
                         for k, v in labels)): n
            for (name, labels), n in deltas.items()}


def test_model_counters_match_jax(tmp_path):
    j = op_script(crdt_tpu, tmp_path, "j")
    p = op_script(port, tmp_path, "p")
    assert p[1:] == j[1:]
    want = relabel(port_counters(j[0]), "j")
    got = relabel(p[0], "p")
    assert got == want
    names = {k[0] for k in got}
    for name in ("crdt_tpu_ingest_flush_total", "crdt_tpu_pack_cache_total",
                 "crdt_tpu_pack_cache_evictions_total",
                 "crdt_tpu_fused_repack_total", "crdt_tpu_digest_cache_total",
                 "crdt_tpu_gc_purged_slots_total", "crdt_tpu_gc_passes_total",
                 "crdt_tpu_gc_fenced_rows_total",
                 "crdt_tpu_compact_passes_total",
                 "crdt_tpu_sync_semantics_downgrade_total",
                 "crdt_tpu_watch_events_total", "crdt_tpu_checkpoints_total",
                 "crdt_tpu_pack_copy_bytes_total",
                 "crdt_tpu_merkle_digest_rounds_total",
                 "crdt_tpu_merkle_sync_total",
                 "crdt_tpu_merkle_ranges_shipped_total"):
        assert name in names, name


# --- MergeStats / PeerSyncStats ---------------------------------------------------


@pytest.mark.parametrize("mod", [jstats, pstats])
def test_merge_stats_track_merge_flow(mod):
    s = mod.MergeStats()
    s.merges += 1
    s.add_seen_lazy(3)
    s.add_seen_lazy(np.int64(2))
    s.add_adopted_lazy(1)
    assert (s.records_seen, s.records_adopted) == (5, 1)
    s.reset()
    assert s.as_dict() == {"merges": 0, "records_seen": 0,
                           "records_adopted": 0, "puts": 0,
                           "records_put": 0}
    p = mod.PeerSyncStats(rounds_ok=1, breaker_closed=2)
    assert list(p.as_dict()) == list(jstats.PeerSyncStats().as_dict())
    p.reset()
    assert set(p.as_dict().values()) == {0}


def test_dense_model_registers_its_merge_stats():
    c = port.DenseCrdt("obs-registered", 16, device="cpu",
                       wall_clock=FakeClock())
    c.put_batch([1], [2])
    rows = [r for r in pobs.metrics_snapshot()["stats"]["merge"]
            if r["labels"] == {"backend": "DenseCrdt",
                               "node": "obs-registered"}]
    assert rows == [{"labels": {"backend": "DenseCrdt",
                                "node": "obs-registered"},
                     "values": c.stats.as_dict()}]
