"""A scripted serving-tier conversation, shared by the port's serve
tests and ``chip_smoke.py`` (no jax here, so the card run imports it
too).

`converse` drives one `ServeTier` through every session shape a client
has, one write acknowledged before the next, so a tier with an injected
wall clock stamps every tick the same way on every run:

1. a negotiated session (``hello`` offering the binary lane, no zlib):
   JSON ``put`` / ``get`` / ``delete``, a rejected write that leaves
   the session open, then binop puts, gets and deletes;
2. a replication session (`PeerConnection`): a ``delta_packed`` pull
   and ``push_packed`` (`sync_packed_over_conn`), a ``push_dense`` and
   ``delta_dense`` round (`sync_dense_over_conn`), a ``digest`` walk
   (`sync_merkle_over_conn`), and a last ``delta_packed`` pull;
3. the tier's ``gc_pass`` on the host side, then a legacy session
   (no hello): ``get`` of the deleted slots and the ``metrics`` op.

``net`` is the CLIENT package's `net` module and ``client`` a replica
of that package with the tier's ``n_slots``; the tier may be either
package's. Run it through `torch_wire.RecordingProxy` to compare the
frames of two runs. The ``metrics`` reply is a registry snapshot with
timings in it, so `converse` returns its section names, not its bytes,
and callers leave the last frame of that session out of a byte
comparison (`METRICS_FRAMES`).
"""

from __future__ import annotations

import socket
import time

import numpy as np

# The frames at the end of the legacy session that carry the metrics
# op's reply (one reply frame), left out of byte comparisons.
METRICS_FRAMES = 1


def _req(net, sock, obj, codec=None):
    net.send_frame(sock, obj, None, codec)
    return net.recv_frame(sock, deadline=time.monotonic() + 30.0,
                          codec=codec)


def script_slots(n_slots: int, seed: int = 5):
    """The slots and values the conversation writes (seeded)."""
    rng = np.random.default_rng(seed)
    slots = rng.choice(n_slots, 24, replace=False)
    vals = rng.integers(-2 ** 40, 2 ** 40, 24)
    return [int(s) for s in slots], [int(v) for v in vals]


def seed_client(client, n_slots: int, seed: int = 7) -> None:
    """Rows the client replica brings to the replication session."""
    rng = np.random.default_rng(seed)
    slots = rng.choice(n_slots, 40, replace=False)
    client.put_batch(slots, rng.integers(-2 ** 31, 2 ** 31, 40))
    client.delete_batch(slots[:5])


def converse(net, host: str, port: int, client, tier,
             n_slots: int) -> dict:
    """Run the conversation against ``host:port`` (the tier, or a
    recording proxy in front of it). ``tier`` is the `ServeTier` itself,
    for ``gc_pass`` and its lock. Returns what the client saw."""
    slots, vals = script_slots(n_slots)
    out: dict = {}
    # 1. negotiated session: JSON and binop point ops.
    with socket.create_connection((host, port), timeout=30.0) as sock:
        sock.settimeout(30.0)
        hello = _req(net, sock, {"op": "hello", "proto": 1,
                                 "caps": ["binop"]})
        out["hello_caps"] = sorted(hello.get("caps", []))
        codec = net.FrameCodec(compress=False)
        acks = []
        for s, v in zip(slots[:6], vals[:6]):
            acks.append(_req(net, sock, {"op": "put", "slot": s,
                                         "value": v}, codec))
        acks.append(_req(net, sock, {"op": "delete", "slot": slots[0]},
                         codec))
        out["json_acks"] = acks
        out["json_gets"] = [_req(net, sock, {"op": "get", "slot": s},
                                 codec) for s in slots[:3]]
        out["rejected"] = _req(net, sock, {"op": "put",
                                           "slot": n_slots + 5,
                                           "value": 1}, codec)
        out["after_reject"] = _req(net, sock, {"op": "put",
                                               "slot": slots[6],
                                               "value": vals[6]}, codec)
        st, _, det = net.binop_round(
            sock, [net.BINOP_PUT] * 8, slots[8:16], vals[8:16],
            codec=codec)
        out["binop_put"] = (st.tolist(), det)
        st, values, det = net.binop_round(
            sock, [net.BINOP_GET] * 4 + [net.BINOP_DELETE] * 2,
            slots[8:12] + slots[12:14], [0] * 6, codec=codec)
        out["binop_get_delete"] = (
            st.tolist(), None if values is None else values.tolist(), det)
        # An out-of-range binop slot fails alone; the rest commit.
        st, _, det = net.binop_round(
            sock, [net.BINOP_PUT] * 3, [slots[16], n_slots + 1, slots[17]],
            vals[16:19], codec=codec)
        out["binop_partial"] = (st.tolist(), det)
        net.send_frame(sock, {"op": "bye"}, None, codec)
    # 2. replication session: packed, dense and merkle rounds.
    with net.PeerConnection(host, port, timeout=30.0,
                            want_caps=("packed", "merkle")) as conn:
        mark = net.sync_packed_over_conn(client, conn, since=None)
        out["packed_mark"] = str(mark)
        out["dense_mark"] = str(net.sync_dense_over_conn(client, conn))
        out["merkle"] = str(net.sync_merkle_over_conn(client, conn))
        out["packed_mark2"] = str(net.sync_packed_over_conn(
            client, conn, since=mark))
    # 3. GC on the tier, then a legacy session's reads and metrics.
    out["gc_purged"] = int(tier.gc_pass(drift_slack_ms=0))
    with socket.create_connection((host, port), timeout=30.0) as sock:
        sock.settimeout(30.0)
        out["legacy_gets"] = [_req(net, sock, {"op": "get", "slot": s})
                              for s in (slots[0], slots[12], slots[1])]
        snap = _req(net, sock, {"op": "metrics"})
        out["metrics_sections"] = sorted(snap)
        net.send_frame(sock, {"op": "bye"})
    return out
