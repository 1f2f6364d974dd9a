"""The port's serving tier (`crdt_tpu_torch.serve`) against the JAX
package's (`crdt_tpu.serve`), on the CPU, every comparison exact:

- the scripted conversation of `torch_serve_script.converse` (JSON and
  binop point ops, a rejected write, packed, dense and merkle rounds,
  ``gc_pass``, a legacy session's reads and the metrics op) through a
  `RecordingProxy`, with a port tier and a JAX tier, each spoken to by
  a port client and by a JAX client: every recorded frame equals the
  JAX-JAX run's (the metrics reply, a snapshot with timings, by its
  section names), and so do both replicas' lanes and clocks and the
  dispatch ledger's counts; on the plain route one ``dense.ingest_scatter``
  per flush that had rows;
- the refusals and lanes, on both packages alike: the admission
  watermark's ``busy``, the cold lane's shed, the unknown op's hang-up,
  binop error isolation and malformed frames, the multi-loop lane and
  the counted fallback where the platform has no SO_REUSEPORT.

Every socket binds port 0; every tier, proxy and connection closes in a
context manager; nothing asserts an elapsed time or a tick count that
depends on scheduling (every write is acknowledged before the next, so
each is its own tick).
"""

import functools
import socket
import time

import numpy as np
import pytest

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import net as jnet
from crdt_tpu.obs import default_registry as jax_registry
from crdt_tpu.obs.device import default_ledger as jax_ledger
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch import net as pnet
from crdt_tpu_torch.obs import default_registry as port_registry
from crdt_tpu_torch.obs.device import default_ledger as port_ledger

from torch_serve_script import METRICS_FRAMES, converse, seed_client
from torch_threads import cap_torch_threads
from torch_wire import RecordingProxy, counter_deltas, frames

cap_torch_threads()

PKGS = {"jax": crdt_tpu, "port": port}
NETS = {"jax": jnet, "port": pnet}
LEDGERS = {"jax": jax_ledger, "port": port_ledger}
REGISTRIES = {"jax": jax_registry, "port": port_registry}
N = 1024


def replica(pkg, node, n=N):
    if pkg == "jax":
        return crdt_tpu.DenseCrdt(node, n, wall_clock=FakeClock())
    return port.DenseCrdt(node, n, device="cpu", wall_clock=FakeClock())


def lanes(c):
    return {f: np.asarray(getattr(c.store, f)) for f in c.store._fields}


def ledger_delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@functools.lru_cache(maxsize=None)
def run_script(tier_pkg, client_pkg):
    """The conversation from a ``client_pkg`` client to a ``tier_pkg``
    tier. Returns (client-side results, per-connection frames, tier
    lanes and clock, client lanes and clock, ledger deltas, flushes
    with rows)."""
    a = replica(tier_pkg, "srv")
    b = replica(client_pkg, "cli")
    seed_client(b, N)
    led = {p: LEDGERS[p]().as_dict() for p in PKGS}
    reg0 = REGISTRIES[tier_pkg]().snapshot()
    with PKGS[tier_pkg].ServeTier(a, flush_interval=0.002) as tier, \
            RecordingProxy(tier.host, tier.port) as proxy:
        out = converse(NETS[client_pkg], proxy.host, proxy.port, b, tier,
                       N)
        streams = proxy.streams()
    reg1 = REGISTRIES[tier_pkg]().snapshot()
    flushes = sum(v for (name, labels), v in
                  counter_deltas(reg0, reg1).items()
                  if name == "crdt_tpu_ingest_flush_total"
                  and dict(labels).get("node") == "srv")
    deltas = {p: ledger_delta(led[p], LEDGERS[p]().as_dict())
              for p in PKGS}
    recorded = [(frames(c2s), frames(s2c)) for c2s, s2c in streams]
    return (out, recorded, lanes(a), str(a.canonical_time), lanes(b),
            str(b.canonical_time), deltas, flushes)


def _assert_same(got, want):
    out, rec, a_lanes, a_clock, b_lanes, b_clock, _, _ = got
    w_out, w_rec, wa_lanes, wa_clock, wb_lanes, wb_clock, _, _ = want
    assert out == w_out
    assert len(rec) == len(w_rec) == 3
    for i, ((c2s, s2c), (wc2s, ws2c)) in enumerate(zip(rec, w_rec)):
        assert c2s == wc2s, f"connection {i}: client frames differ"
        if i == 2:    # the legacy session ends with the metrics reply
            s2c, ws2c = s2c[:-METRICS_FRAMES], ws2c[:-METRICS_FRAMES]
        assert s2c == ws2c, f"connection {i}: tier frames differ"
    for f in wa_lanes:
        np.testing.assert_array_equal(a_lanes[f], wa_lanes[f], err_msg=f)
        np.testing.assert_array_equal(b_lanes[f], wb_lanes[f], err_msg=f)
    assert (a_clock, b_clock) == (wa_clock, wb_clock)


def test_conversation_exercises_every_session_shape():
    out = run_script("jax", "jax")[0]
    assert all(a == {"ok": True} for a in out["json_acks"])
    assert out["rejected"]["code"] == "write_rejected"
    assert out["after_reject"] == {"ok": True}
    assert out["binop_put"][0] == [jnet.BINOP_ST_OK] * 8
    assert out["binop_partial"][0] == [jnet.BINOP_ST_OK,
                                       jnet.BINOP_ST_REJECTED,
                                       jnet.BINOP_ST_OK]
    assert out["gc_purged"] > 0
    assert out["legacy_gets"][0] == {"ok": True, "value": None}
    assert "binop" in out["hello_caps"]
    assert out["metrics_sections"] == ["metrics"]


@pytest.mark.parametrize("tier_pkg,client_pkg",
                         [("port", "port"), ("port", "jax"),
                          ("jax", "port")])
def test_conversation_frames_lanes_and_clock_match_jax(tier_pkg,
                                                       client_pkg):
    _assert_same(run_script(tier_pkg, client_pkg),
                 run_script("jax", "jax"))


def test_ledger_counts_match_jax_and_one_scatter_per_flush():
    """Same script, same dispatches: the port's ledger on its plain
    route counts what the JAX package's counts on its XLA route, and a
    flush that had rows is exactly one ``dense.ingest_scatter``."""
    port_run = run_script("port", "port")
    jax_run = run_script("jax", "jax")
    assert port_run[6]["port"] == jax_run[6]["jax"]
    flushes = port_run[7]
    assert flushes == jax_run[7] > 0
    assert port_run[6]["port"]["dense.ingest_scatter"] == flushes
    assert "pallas.ingest_scatter_tiles" not in port_run[6]["port"]


# --- refusals and lanes, both packages alike ---

def _connect(tier):
    sock = socket.create_connection((tier.host, tier.port), timeout=10.0)
    sock.settimeout(10.0)
    return sock


def _req(net, sock, obj, codec=None):
    net.send_frame(sock, obj, None, codec)
    return net.recv_frame(sock, deadline=time.monotonic() + 10.0,
                          codec=codec)


def _shed(pkg, lane, node):
    return REGISTRIES[pkg]().counter(
        "crdt_tpu_serve_shed_total").value(lane=lane, node=node)


def admission(pkg):
    net = NETS[pkg]
    node = f"adm-{pkg}"
    before = _shed(pkg, "admission", node)
    with PKGS[pkg].ServeTier(replica(pkg, node, 64),
                             max_sessions=2) as tier:
        conns = [net.PeerConnection(tier.host, tier.port, timeout=5.0)
                 for _ in range(3)]
        try:
            conns[0].ensure()
            conns[1].ensure()
            with pytest.raises(net.SyncTransportError) as err:
                conns[2].ensure()
            out = (str(err.value).replace(str(tier.port), "PORT"),
                   conns[2].legacy,
                   tier.shed_count >= 1,
                   _shed(pkg, "admission", node) - before >= 1)
            # Freeing a slot readmits the shed client (its bye is
            # processed asynchronously; the deadline is a hang guard).
            conns[0].close()
            deadline = time.monotonic() + 30.0
            while True:
                try:
                    conns[2].ensure()
                    break
                except net.SyncTransportError:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
            return out + ("packed" in conns[2].caps,)
        finally:
            for c in conns:
                c.close()


def test_admission_watermark_sheds_with_busy_as_jax():
    got = admission("port")
    assert got == admission("jax")
    assert "busy" in got[0] and got[1:] == (False, True, True, True)


def cold_lane(pkg):
    net = NETS[pkg]
    node = f"cold-{pkg}"
    crdt = replica(pkg, node, 64)
    crdt.put_batch([1], [1])
    before = _shed(pkg, "cold", node)
    with PKGS[pkg].ServeTier(crdt, cold_lane_depth=0) as tier:
        with net.PeerConnection(tier.host, tier.port, timeout=5.0) as conn:
            with pytest.raises(net.SyncTransportError) as err:
                net.sync_merkle_over_conn(replica(pkg, "j", 64), conn)
        return (str(err.value).replace(str(tier.port), "PORT"),
                tier.shed_count >= 1,
                _shed(pkg, "cold", node) - before)


def test_cold_lane_bound_sheds_digest_as_jax():
    got = cold_lane("port")
    assert got == cold_lane("jax")
    assert "busy" in got[0] and got[1] and got[2] >= 1


def unknown_and_malformed(pkg):
    """The unknown op's reply then hang-up; a binop frame on a session
    that never agreed the lane, and a truncated one on a session that
    did, both hang up; per-op isolation inside a well-formed frame;
    the tier keeps serving after each."""
    net = NETS[pkg]
    crdt = replica(pkg, "mal", 64)
    out = []
    with PKGS[pkg].ServeTier(crdt, flush_interval=0.002) as tier:
        with _connect(tier) as sock:
            out.append(_req(net, sock, {"op": "frobnicate"}))
            out.append(net.recv_frame(sock, deadline=time.monotonic()
                                      + 10.0))
        with _connect(tier) as sock:
            net.send_bytes_frame(sock, net.encode_binop_request(
                [net.BINOP_PUT], [1], [10]))
            out.append(net.recv_frame(sock, deadline=time.monotonic()
                                      + 10.0))
        with _connect(tier) as sock:
            hello = _req(net, sock, {"op": "hello", "proto": 1,
                                     "caps": ["binop"]})
            codec = net.FrameCodec(compress=False)
            st, _, det = net.binop_round(
                sock, [net.BINOP_PUT] * 3, [1, 9999, 2], [10, 1, 20],
                codec=codec)
            out.append((sorted(hello["caps"]), st.tolist(), det))
            body = b"".join(bytes(p) for p in net.encode_binop_request(
                [net.BINOP_PUT, net.BINOP_PUT], [3, 4], [30, 40]))[:-5]
            net.send_bytes_frame(sock, [body], None, codec)
            out.append(net.recv_frame(sock, deadline=time.monotonic()
                                      + 10.0, codec=codec))
        with _connect(tier) as sock:
            out.append(_req(net, sock, {"op": "put", "slot": 7,
                                        "value": 70}))
            net.send_frame(sock, {"op": "bye"})
    out.append([crdt.get(s) for s in (1, 2, 3, 7)])
    return out


def test_unknown_op_and_malformed_binop_as_jax():
    got = unknown_and_malformed("port")
    assert got == unknown_and_malformed("jax")
    assert got[0]["code"] == "unknown_op" and got[1] is None
    assert got[2] is None and got[4] is None
    assert got[3][1] == [pnet.BINOP_ST_OK, pnet.BINOP_ST_REJECTED,
                         pnet.BINOP_ST_OK]
    assert got[3][2] == [{"i": 1, "code": "write_rejected",
                          "error": "bad slot"}]
    assert got[-1] == [10, 20, None, 70]


def multi_loop(pkg):
    """12 JSON writers and 6 binop sessions over two accept loops on
    one port; every write lands, nothing is dropped, and the tier's
    ticks are counted on the ledger one scatter each."""
    net = NETS[pkg]
    crdt = replica(pkg, f"ml-{pkg}", 256)
    led0 = LEDGERS[pkg]().as_dict()
    with PKGS[pkg].ServeTier(crdt, flush_interval=0.01, loops=2) as tier:
        loops = tier.loops_effective
        socks = [_connect(tier) for _ in range(12)]
        try:
            for i, s in enumerate(socks):
                net.send_frame(s, {"op": "put", "slot": i, "value": i * 10})
            acks = [net.recv_frame(s, deadline=time.monotonic() + 10.0)
                    for s in socks]
        finally:
            for s in socks:
                s.close()
        statuses = []
        for k in range(6):
            with _connect(tier) as sock:
                _req(net, sock, {"op": "hello", "proto": 1,
                                 "caps": ["binop"]})
                st, _, _ = net.binop_round(
                    sock, [net.BINOP_PUT] * 4,
                    [100 + 4 * k + j for j in range(4)], [k] * 4,
                    codec=net.FrameCodec(compress=False))
                statuses.append(st.tolist())
        dropped = tier.dropped_sessions
    scatters = ledger_delta(led0, LEDGERS[pkg]().as_dict()).get(
        "dense.ingest_scatter", 0)
    return (loops, acks, statuses, dropped,
            [crdt.get(i) for i in range(12)],
            [crdt.get(100 + i) for i in range(24)], scatters >= 1)


@pytest.mark.skipif(not hasattr(socket, "SO_REUSEPORT"),
                    reason="platform has no SO_REUSEPORT")
def test_multi_loop_lane_as_jax():
    got = multi_loop("port")
    assert got == multi_loop("jax")
    assert got[0] == 2 and got[1] == [{"ok": True}] * 12
    assert got[2] == [[pnet.BINOP_ST_OK] * 4] * 6 and got[3] == 0
    assert got[4] == [i * 10 for i in range(12)]
    assert got[5] == [i // 4 for i in range(24)]


def reuseport_fallback(pkg, monkeypatch):
    monkeypatch.delattr(socket, "SO_REUSEPORT", raising=False)
    net = NETS[pkg]
    crdt = replica(pkg, f"fb-{pkg}", 64)
    gauge = REGISTRIES[pkg]().gauge("crdt_tpu_serve_loops")
    with PKGS[pkg].ServeTier(crdt, loops=4) as tier:
        out = (tier.loops_effective,
               gauge.value(node=str(crdt.node_id)))
        with _connect(tier) as sock:
            out += (_req(net, sock, {"op": "put", "slot": 1, "value": 5}),)
            net.send_frame(sock, {"op": "bye"})
    return out + (crdt.get(1),)


def test_reuseport_less_platform_falls_back_counted_as_jax(monkeypatch):
    got = reuseport_fallback("port", monkeypatch)
    assert got == reuseport_fallback("jax", monkeypatch)
    assert got == (1, 1, {"ok": True}, 5)


def test_watch_index_matches_jax():
    """`WatchIndex` bookkeeping on the same seeded subscriptions."""
    from crdt_tpu.watch import WatchIndex as JaxIndex
    from crdt_tpu_torch.watch import WatchIndex as PortIndex
    rng = np.random.default_rng(3)
    idx = {"jax": JaxIndex(), "port": PortIndex()}
    for step in range(200):
        w = int(rng.integers(0, 12))
        action = rng.integers(0, 4)
        slots = rng.integers(0, 64, 3).tolist()
        for ix in idx.values():
            if action == 0:
                ix.remove(w)
            elif action == 1:
                ix.add(w)
            else:
                ix.add(w, slots)
        touched = rng.integers(0, 64, 5).tolist()
        got = {p: (len(ix), ix.empty, sorted(ix.watchers()),
                   sorted(ix.touched(touched))) for p, ix in idx.items()}
        assert got["port"] == got["jax"], step


@pytest.mark.parametrize("how", ["stop", "kill"])
def test_stop_and_kill_return_with_an_idle_session_open(how):
    """A client session left open and idle does not park the tier's
    teardown: since Python 3.12.1 `Server.wait_closed` waits for open
    connections, and the JAX package's tier awaits it before cutting
    its sessions, so there `stop()` raises "failed to stop" after its
    60 s join (and `kill()` returns only then). The port cuts every
    session first. Nothing here reads a clock: a regression shows as
    the RuntimeError or as a join that outlives the test's timeout."""
    crdt = replica("port", f"idle-{how}", 64)
    tier = port.ServeTier(crdt).start()
    try:
        with pnet.PeerConnection(tier.host, tier.port,
                                 timeout=10.0) as conn:
            conn.ensure()
            with _connect(tier) as sock:
                assert _req(pnet, sock, {"op": "put", "slot": 3,
                                         "value": 30}) == {"ok": True}
                getattr(tier, how)()
                assert all(ctx.thread is None for ctx in tier._ctxs)
                # The cut session reads end-of-stream, not a reply.
                assert pnet.recv_frame(
                    sock, deadline=time.monotonic() + 10.0) is None
    finally:
        tier.stop()
    assert tier.killed == (how == "kill")


def test_frame_pieces_bytes_match_jax_and_carry_no_empty_piece():
    """`frame_pieces` gives the JAX package's bytes, less its empty
    pieces: CPython 3.12's selector transport, handed an empty piece by
    ``writelines``, keeps write polling with nothing buffered, so the
    session's close never completes (the JAX tier's stop then fails
    after its 60 s join; see the next test)."""
    from crdt_tpu import serve as jserve
    from crdt_tpu_torch import serve as pserve
    bufs = [b'{"op": "x"}', np.zeros(0, np.int64), np.arange(3), b""]
    for codec in (None, (jnet.FrameCodec(compress=False),
                         pnet.FrameCodec(compress=False))):
        jc, pc = (None, None) if codec is None else codec
        want = jserve.frame_pieces(bufs, jc)
        got = pserve.frame_pieces(bufs, pc)
        assert b"".join(bytes(p) for p in got) == \
            b"".join(bytes(p) for p in want)
        assert all(memoryview(p).nbytes for p in got)


def test_empty_pack_replies_leave_stop_prompt():
    """Packed rounds whose later replies are empty packs, then a stop:
    the tier's loop ends (the JAX package's raises "failed to stop")."""
    served = replica("port", "ep-a", 64)
    client = replica("port", "ep-b", 64)
    served.put_batch([1, 2], [10, 20])
    client.put_batch([5], [50])
    tier = port.ServeTier(served).start()
    try:
        with pnet.PeerConnection(tier.host, tier.port,
                                 timeout=10.0) as conn:
            mark = pnet.sync_packed_over_conn(client, conn, since=None)
            for _ in range(3):
                mark = pnet.sync_packed_over_conn(client, conn,
                                                  since=mark)
    finally:
        tier.stop()
    assert all(ctx.thread is None for ctx in tier._ctxs)
    assert served.get(5) == 50 and client.get(1) == 10


def test_open_loop_fleet_acks_read_back_on_the_tier():
    """`torch_serve_fleet` (the process the card run drives its load
    from) against a port tier at a small size: every put the fleet saw
    acknowledged reads back, on the JSON and the binary lane, and the
    ledger counted one commit scatter per flush that had rows."""
    import torch_serve_fleet as fleet
    crdt = replica("port", "fleet-srv", 4096)
    reg0 = port_registry().snapshot()
    led0 = port_ledger().as_dict()
    with port.ServeTier(crdt, flush_interval=0.002) as tier:
        serve = fleet.run(dict(mode="serve", sessions=16, rate=20.0,
                               warmup=0.2, duration=0.5, host=tier.host,
                               port=tier.port, base=0))
        lane = fleet.run(dict(mode="lane", sessions=8, rate=10.0,
                              batch=16, warmup=0.2, duration=0.5,
                              host=tier.host, port=tier.port, base=2048))
    for out in (serve, lane):
        c = out["counters"]
        assert c["errors"] == c["connect_failures"] == 0
        assert out["connected"] > 0 and out["last"]
    assert serve["counters"]["acked"] == serve["counters"]["attempts"]
    assert lane["counters"]["acked"] == 16 * lane["counters"]["attempts"]
    # The throughput evidence: window puts in ops (16 a binop frame),
    # acks inside the window counted apart from the scheduled ones.
    for out, per in ((serve, 1), (lane, 16)):
        assert out["window_ops"] == per * out["measured"] > 0
        assert 0 <= out["acked_in_window"] <= out["counters"]["acked"]
        assert out["last_window_ack_s"] >= 0.0
    for slot, value in serve["last"] + lane["last"]:
        assert crdt.get(slot) == value, slot
    flushes = sum(v for (name, labels), v in counter_deltas(
        reg0, port_registry().snapshot()).items()
        if name == "crdt_tpu_ingest_flush_total"
        and dict(labels).get("node") == "fleet-srv")
    assert ledger_delta(led0, port_ledger().as_dict())[
        "dense.ingest_scatter"] == flushes > 0
