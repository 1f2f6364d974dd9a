"""The port's TCP wire (`crdt_tpu_torch.net`) against the JAX package's
(`crdt_tpu.net`), on the CPU, every comparison exact:

- the frame codecs: `FrameCodec` bodies, the split meta and blob of
  `_pack_split` (split and narrow, 2-D and pre-tiled), `_unpack_split`
  (the lanes back, and every refusal with the same `ValueError`
  message), and the binop codec (bytes both ways, refusals);
- a port client against a JAX `SyncServer` and a JAX client against a
  port `SyncServer`, in every negotiated mode (JSON; dense in the split
  and narrow forms; packed with and without ``semantics``; merkle with
  the digest prefetch) with zlib agreed, with it refused, and with the
  tracer on: both replicas end with the lanes and clock of a JAX-JAX
  run of the same script, and the byte streams a recording proxy
  captures are the JAX-JAX run's (with the tracer on, after each
  frame's trace context is dropped: it carries a per-process round
  id);
- pre-hello legacy peers on either side, and the rejections (the same
  error class, ``code`` and exception name).

Every socket binds port 0; nothing asserts an upper bound on elapsed
time; every server is closed by a context manager.
"""

import functools
import json
import socket

import numpy as np
import pytest

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import net as jnet
from crdt_tpu.obs import tracer as jax_tracer
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch import net as pnet
from crdt_tpu_torch.obs import tracer as port_tracer

from test_net_fastpath import _LegacyServer
from torch_threads import cap_torch_threads
from torch_wire import RecordingProxy, frames, untraced

cap_torch_threads()

PKGS = {"jax": (crdt_tpu, jnet), "port": (port, pnet)}
WANT = ("zlib", "packed", "semantics", "merkle", "trace", "sketch")

# mode -> (client round, n_slots, value_width, typed slots)
MODES = {
    "json": ("sync_over_conn", 1000, 64, False),
    "dense_split": ("sync_dense_over_conn", 4096, 64, False),
    "dense_narrow": ("sync_dense_over_conn", 1000, 32, False),
    "packed": ("sync_packed_over_conn", 1000, 64, False),
    "packed_semantics": ("sync_packed_over_conn", 1000, 64, True),
    "merkle": ("sync_merkle_over_conn", 1000, 64, False),
}


def replica(pkg, node, n, value_width=64):
    if pkg == "jax":
        return crdt_tpu.DenseCrdt(node, n, wall_clock=FakeClock(),
                                  value_width=value_width)
    return port.DenseCrdt(node, n, device="cpu", wall_clock=FakeClock(),
                          value_width=value_width)


def writes(c, seed, n, rows=120):
    rng = np.random.default_rng(seed)
    slots = rng.choice(n - 8, rows, replace=False) + 8
    c.put_batch(slots, rng.integers(-2 ** 31, 2 ** 31, rows))
    c.delete_batch(slots[:7])


def seed_pair(a, b, typed):
    if typed:
        for c in (a, b):
            c.set_semantics(range(8), "gcounter")
        a.counter_add(1, 5)
        b.counter_add(1, 7)
        b.counter_add(3, 2)
    writes(a, 1, a.n_slots)
    writes(b, 2, b.n_slots)


def lanes(c):
    return {f: np.asarray(getattr(c.store, f)) for f in c.store._fields}


@pytest.fixture
def tracers():
    yield
    jax_tracer().disable()
    port_tracer().disable()


def run_script(server_pkg, client_pkg, mode, variant):
    """Two rounds of ``mode`` from a ``client_pkg`` replica to a
    ``server_pkg`` server through a recording proxy, with writes on
    both sides between them. Returns (server replica, client replica,
    recorded streams)."""
    fn, n, vw, typed = MODES[mode]
    a = replica(server_pkg, "a", n, vw)
    b = replica(client_pkg, "b", n, vw)
    seed_pair(a, b, typed)
    if variant == "trace":
        jax_tracer().enable()
        port_tracer().enable()
    caps = WANT if variant != "raw" else tuple(
        c for c in WANT if c != "zlib")
    cli = PKGS[client_pkg][1]
    sync = getattr(cli, fn)
    with PKGS[server_pkg][1].SyncServer(a) as server, \
            RecordingProxy(server.host, server.port) as proxy:
        with cli.PeerConnection(proxy.host, proxy.port, timeout=30.0,
                                want_caps=caps) as conn:
            args = {} if mode == "merkle" else {"since": None}
            mark = sync(b, conn, **args)
            with server.lock:
                writes(a, 3, n, 40)
            writes(b, 4, n, 40)
            if mode != "merkle":
                args = {"since": mark}
            sync(b, conn, **args)
        streams = proxy.streams()
    return a, b, streams


@functools.lru_cache(maxsize=None)
def reference(mode, variant):
    """The JAX-JAX run. Tracing reads the clocks and adds a trace
    context to the frames, nothing else: the traced run is held against
    the untraced one's lanes, clocks and frames."""
    a, b, streams = run_script("jax", "jax", mode,
                               "zlib" if variant == "trace" else variant)
    return (lanes(a), str(a.canonical_time), lanes(b),
            str(b.canonical_time), streams)


def assert_matches(ref, a, b, streams, variant):
    ra, ca, rb, cb, rstreams = ref
    for want, got, clock, what in ((ra, a, ca, "server"),
                                   (rb, b, cb, "client")):
        for f, lane in want.items():
            np.testing.assert_array_equal(lane, lanes(got)[f],
                                          f"{what} {f}")
        assert str(got.canonical_time) == clock, what
    assert len(streams) == len(rstreams)
    for (c2s, s2c), (rc2s, rs2c) in zip(streams, rstreams):
        if variant == "trace":
            assert untraced(c2s) == untraced(rc2s)
            assert untraced(s2c) == untraced(rs2c)
        else:
            assert c2s == rc2s
            assert s2c == rs2c


@pytest.mark.parametrize("variant", ["zlib", "raw", "trace"])
@pytest.mark.parametrize("direction", ["port_client", "port_server"])
@pytest.mark.parametrize("mode", list(MODES))
def test_tcp_rounds_match_a_jax_pair(mode, direction, variant, tracers):
    ref = reference(mode, variant)
    server, client = (("jax", "port") if direction == "port_client"
                      else ("port", "jax"))
    a, b, streams = run_script(server, client, mode, variant)
    assert_matches(ref, a, b, streams, variant)
    c2s = [json.loads(f) for f in frames(streams[0][0]) if f[:1] == b"{"]
    assert c2s[0]["op"] == "hello"
    traced = [m for m in c2s if "trace" in m]
    # With the tracer on, the trace context rode every sync frame after
    # the hello (not the closing bye).
    assert len(traced) == (len(c2s) - 2 if variant == "trace" else 0)


# --- pre-hello legacy peers ---------------------------------------------------


def legacy_client_run(server_pkg, client_pkg):
    a = replica(server_pkg, "a", 1000)
    b = replica(client_pkg, "b", 1000)
    seed_pair(a, b, False)
    with PKGS[server_pkg][1].SyncServer(a) as server, \
            RecordingProxy(server.host, server.port) as proxy:
        mark = PKGS[client_pkg][1].sync_over_tcp(b, proxy.host,
                                                 proxy.port)
        writes(b, 4, 1000, 40)
        PKGS[client_pkg][1].sync_dense_over_tcp(b, proxy.host,
                                                proxy.port, since=mark)
        streams = proxy.streams()
    return a, b, streams


def legacy_server_run(client_pkg):
    a = replica("jax", "a", 1000)
    b = replica(client_pkg, "b", 1000)
    seed_pair(a, b, False)
    with _LegacyServer(a) as server, \
            RecordingProxy(server.host, server.port) as proxy:
        conn = PKGS[client_pkg][1].PeerConnection(proxy.host, proxy.port,
                                                  timeout=30.0)
        mark = PKGS[client_pkg][1].sync_over_conn(b, conn, since=None)
        assert conn.legacy and conn.caps == frozenset()
        writes(b, 4, 1000, 40)
        PKGS[client_pkg][1].sync_over_conn(b, conn, since=mark)
        conn.close()
        streams = proxy.streams()
    return a, b, streams


@pytest.mark.parametrize("direction", ["port_client", "port_server"])
def test_legacy_client_matches_a_jax_pair(direction):
    ref_a, ref_b, ref_streams = legacy_client_run("jax", "jax")
    ref = (lanes(ref_a), str(ref_a.canonical_time), lanes(ref_b),
           str(ref_b.canonical_time), ref_streams)
    server, client = (("jax", "port") if direction == "port_client"
                      else ("port", "jax"))
    a, b, streams = legacy_client_run(server, client)
    assert_matches(ref, a, b, streams, "raw")
    # No hello: the exact pre-hello bytes, untagged.
    assert all(b'"hello"' not in c2s for c2s, _ in streams)


def test_legacy_server_port_client_matches_jax_client():
    ref_a, ref_b, ref_streams = legacy_server_run("jax")
    ref = (lanes(ref_a), str(ref_a.canonical_time), lanes(ref_b),
           str(ref_b.canonical_time), ref_streams)
    a, b, streams = legacy_server_run("port")
    assert_matches(ref, a, b, streams, "raw")
    assert len(streams) == 2     # the refused hello, then the legacy one


# --- rejections ---------------------------------------------------------------


def rejection(server_pkg, client_pkg, case):
    """``(class name, code, error)`` a client round raises."""
    cli = PKGS[client_pkg][1]
    if case == "dense_capacity":
        a = replica(server_pkg, "a", 1000)
        b = replica(client_pkg, "b", 4096)
    elif case == "merkle_geometry":
        a = replica(server_pkg, "a", 4096)
        b = replica(client_pkg, "b", 1000)
    elif case == "packed_on_map":
        pkg = PKGS[server_pkg][0]
        a = pkg.MapCrdt("a", wall_clock=FakeClock())
        b = replica(client_pkg, "b", 1000)
    else:   # a push whose clock is past the drift bound
        a = replica(server_pkg, "a", 1000)
        b = replica(client_pkg, "b", 1000)
        b._wall_clock = FakeClock(start=1_700_000_000_000 + 3_600_000)
    b.put_batch([3, 4], [30, 40])
    fn = {"dense_capacity": cli.sync_dense_over_conn,
          "merkle_geometry": cli.sync_merkle_over_conn,
          "packed_on_map": cli.sync_packed_over_conn,
          "drift": cli.sync_over_conn}[case]
    with PKGS[server_pkg][1].SyncServer(a) as server:
        with cli.PeerConnection(server.host, server.port,
                                timeout=30.0) as conn:
            with pytest.raises(cli.SyncError) as e:
                fn(b, conn)
    err = e.value
    return (type(err).__name__, getattr(err, "code", None),
            getattr(err, "error", None), str(err))


@pytest.mark.parametrize("case", ["dense_capacity", "merkle_geometry",
                                  "packed_on_map", "drift"])
def test_rejections_match_jax(case):
    ref = rejection("jax", "jax", case)
    assert ref[0] == "SyncProtocolError"
    assert rejection("jax", "port", case) == ref
    assert rejection("port", "jax", case) == ref


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_unknown_op_and_refused_connect(pkg):
    net = PKGS[pkg][1]
    with net.SyncServer(replica(pkg, "a", 64)) as server:
        with socket.create_connection((server.host, server.port)) as s:
            net.send_frame(s, {"op": "nope"})
            reply = net.recv_frame(s)
    assert reply == {"code": "unknown_op", "error": "unknown op 'nope'"}
    with pytest.raises(net.SyncProtocolError) as e:
        net._check_reply("x", reply, "ok")
    assert e.value.code == "unknown_op"
    for reply, want in ((None, "ok"), ({"code": "busy"}, "ok"),
                        ({"ok": True}, "meta")):
        with pytest.raises(net.SyncTransportError):
            net._check_reply("x", reply, want)
    free = socket.create_server(("127.0.0.1", 0))
    port_no = free.getsockname()[1]
    free.close()
    with pytest.raises(net.SyncTransportError):
        net.PeerConnection("127.0.0.1", port_no, timeout=5.0).ensure()


# --- frame codecs -------------------------------------------------------------


@pytest.mark.parametrize("compress,size", [(False, 2000), (True, 100),
                                           (True, 4000)])
def test_frame_codec_bytes_match(compress, size):
    rng = np.random.default_rng(size)
    body = bytes(rng.integers(0, 4, size, dtype=np.uint8))
    pieces = [body[:size // 3], memoryview(body[size // 3:])]
    jt, pt = jnet.WireTally(), pnet.WireTally()
    jout = jnet.FrameCodec(compress=compress).encode(pieces, jt)
    pout = pnet.FrameCodec(compress=compress).encode(pieces, pt)
    assert b"".join(map(bytes, jout)) == b"".join(map(bytes, pout))
    assert jt.as_dict() == pt.as_dict()
    wire = b"".join(map(bytes, pout))
    assert pnet.FrameCodec().decode(wire) == body


@pytest.mark.parametrize("body", [b"", b"\x02abc", b"\x01not zlib",
                                  b"\x01" + __import__("zlib").compress(
                                      b"x" * 64)[:-3]])
def test_frame_codec_refusals_match(body):
    with pytest.raises(ValueError) as want:
        jnet.FrameCodec().decode(body)
    with pytest.raises(ValueError) as got:
        pnet.FrameCodec().decode(body)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,vw", [(4096, 64), (4096, 32), (1000, 64),
                                  (1000, 32)])
def test_pack_split_matches_jax(n, vw):
    j, p = replica("jax", "s", n, vw), replica("port", "s", n, vw)
    for c in (j, p):
        writes(c, 9, n)
    jmeta, jbufs = jnet._pack_split(j.export_split_delta()[0])
    pmeta, pbufs = pnet._pack_split(p.export_split_delta()[0])
    assert pmeta == jmeta
    assert [bytes(b) for b in pbufs] == [bytes(b) for b in jbufs]
    blob = b"".join(bytes(b) for b in pbufs)
    back = pnet._unpack_split(pmeta, blob)
    ref = jnet._unpack_split(jmeta, blob)
    assert back._fields == ref._fields
    for got, want in zip(back, ref):
        assert got.is_contiguous() and got.numpy().flags.writeable
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert str(got.numpy().dtype) == str(np.asarray(want).dtype)


def split_refusals():
    meta, bufs = jnet._pack_split(
        replica("jax", "s", 64).export_split_delta()[0])
    blob = b"".join(bytes(b) for b in bufs)

    def edit(fn):
        m = {"form": meta["form"],
             "lanes": [list(l) for l in meta["lanes"]]}
        fn(m)
        return m
    return {
        "not a dict": ([1], blob),
        "bad form": ({"form": "wide", "lanes": meta["lanes"]}, blob),
        "fields": (edit(lambda m: m["lanes"].reverse()), blob),
        "dtype": (edit(lambda m: m["lanes"][0].__setitem__(1, "int64")),
                  blob),
        "1-D": (edit(lambda m: [l.__setitem__(2, [64])
                                for l in m["lanes"]]), blob),
        "inconsistent": (edit(lambda m: m["lanes"][1].__setitem__(
            2, [2, 32])), blob),
        "short": (meta, blob[:-1]),
        "long": (meta, blob + b"\x00"),
    }


@pytest.mark.parametrize("case", list(split_refusals()))
def test_unpack_split_refusals_match(case):
    meta, blob = split_refusals()[case]
    with pytest.raises(ValueError) as want:
        jnet._unpack_split(meta, blob)
    with pytest.raises(ValueError) as got:
        pnet._unpack_split(meta, blob)
    assert str(got.value) == str(want.value)


def test_binop_codec_matches():
    rng = np.random.default_rng(3)
    ops = rng.integers(0, 3, 37).astype(np.uint8)
    slots = rng.integers(0, 2 ** 31, 37)
    vals = rng.integers(-2 ** 62, 2 ** 62, 37)
    for epoch in (None, 5):
        jreq = b"".join(bytes(b) for b in jnet.encode_binop_request(
            ops, slots, vals, epoch))
        preq = b"".join(bytes(b) for b in pnet.encode_binop_request(
            ops, slots, vals, epoch))
        assert preq == jreq
        for got, want in zip(pnet.decode_binop_request(preq),
                             jnet.decode_binop_request(jreq)):
            np.testing.assert_array_equal(got, want)
    details = [{"i": 2, "code": "moved"}]
    for values in (None, vals):
        jrep = b"".join(bytes(b) for b in jnet.encode_binop_reply(
            ops, values, details))
        prep = b"".join(bytes(b) for b in pnet.encode_binop_reply(
            ops, values, details))
        assert prep == jrep
        st, va, det = pnet.decode_binop_reply(prep)
        np.testing.assert_array_equal(st, ops)
        assert det == details
        assert (va is None) == (values is None)


@pytest.mark.parametrize("body", [
    b"", b"\xb1\x01", b"\xb0\x01\x01\x00\x00\x00\x00\x00",
    b"\xb1\x02\x01\x00\x00\x00\x00\x00",
    b"\xb1\x01\x00\x00\x00\x00\x00\x00",
    b"\xb1\x01\x01\x00\x00\x00\x00\x00" + b"\x00" * 12,
    b"\xb1\x01\x01\x00\x00\x00\x00\x00" + b"\x07" + b"\x00" * 12])
def test_binop_refusals_match(body):
    for dec in ("decode_binop_request", "decode_binop_reply"):
        with pytest.raises(ValueError) as want:
            getattr(jnet, dec)(body)
        with pytest.raises(ValueError) as got:
            getattr(pnet, dec)(body)
        assert str(got.value) == str(want.value)
    for args in (([], [], []), ([3], [1], [1]), ([0, 1], [1], [1, 2])):
        with pytest.raises(ValueError) as want:
            jnet.encode_binop_request(*args)
        with pytest.raises(ValueError) as got:
            pnet.encode_binop_request(*args)
        assert str(got.value) == str(want.value)
