"""An open-loop client fleet for a serving tier, run as its own process
(``python tests/torch_serve_fleet.py '<json args>'``) so its client
sockets count against its own descriptor limit, not the tier's. It
imports neither torch nor jax: only the standard library and the JAX-
free `routing.py` of the package named in the arguments, loaded by
file path, so a process holding a CUDA context never forks.

Every session writes on its own slots on an absolute schedule (a slow
ack does not delay the next send; latency is measured from the op's
scheduled time). Modes:

- ``serve``: framed JSON ``put`` ops, one slot a session;
- ``lane``: the negotiated binary lane, ``batch`` puts a frame on the
  session's own ``batch`` slots;
- ``fed``: federation-aware sessions (``hello`` with the federation
  cap) spread over a `FederatedTier`'s keyspace, each put stamped with
  its routing epoch; a ``moved`` reply re-targets the session (the
  owner it names), a dead owner (a partition merged away) sends it to
  the newest routing table a live tier holds, and the put is retried
  until acknowledged.

The fleet prints ``START <monotonic seconds>`` once its schedule is
fixed (so a caller can act at a point of the window), then one JSON
line: counters, the ack latency percentiles of the measured window,
the throughput evidence (``acked_in_window``: puts whose ack landed
inside the window, whenever they were scheduled; ``window_ops``: puts
scheduled inside it and acknowledged; ``last_window_ack_s``: the last
of those acks, in seconds after the window opened), and the last
acknowledged value of every slot. A session that falls behind sends
each overdue put as soon as the previous ack returns, so every
scheduled put is sent and acknowledged in the end: the scheduled count
is the offered load, and only the ack times show what the tier kept up
with.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import os
import resource
import struct
import sys
import zlib

HEAD = struct.Struct(">I")
BINOP_HEAD = struct.Struct("<BBHI")
BINOP_MAGIC, BINOP_VERSION, BINOP_PUT, BINOP_ST_OK = 0xB1, 1, 0, 0


def raise_fd_limit(need: int) -> int:
    """Raise the soft descriptor limit toward ``need``; the new soft."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(need, hard), hard))
        except (ValueError, OSError):
            pass
    return resource.getrlimit(resource.RLIMIT_NOFILE)[0]


def load_routing(path: str):
    spec = importlib.util.spec_from_file_location("_fleet_routing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


async def _send(writer, body: bytes, tagged: bool) -> None:
    if tagged:
        body = b"\x00" + body
    writer.write(HEAD.pack(len(body)) + body)
    await writer.drain()


async def _recv(reader, tagged: bool) -> bytes:
    n = HEAD.unpack(await reader.readexactly(4))[0]
    body = await reader.readexactly(n)
    if tagged:
        tag, body = body[:1], body[1:]
        if tag == b"\x01":
            body = zlib.decompress(body)
    return body


async def _dial(host, port, hello_caps=None):
    reader, writer = await asyncio.open_connection(host, port)
    if hello_caps is not None:
        await _send(writer, json.dumps(
            {"op": "hello", "proto": 1, "caps": hello_caps}).encode(),
            tagged=False)
        reply = json.loads(await _recv(reader, tagged=False))
        if not reply.get("ok"):
            raise ConnectionError(f"hello refused: {reply!r}")
    return reader, writer


def _binop_put(slots, value: int) -> bytes:
    n = len(slots)
    return (BINOP_HEAD.pack(BINOP_MAGIC, BINOP_VERSION, n, 0)
            + bytes([BINOP_PUT]) * n
            + struct.pack(f"<{n}I", *slots)
            + struct.pack(f"<{n}q", *([value] * n)))


def _binop_ok(raw: bytes) -> bool:
    _, _, n, _ = BINOP_HEAD.unpack_from(raw)
    return all(b == BINOP_ST_OK for b in raw[8:8 + n])


async def fleet(a: dict) -> dict:
    loop = asyncio.get_running_loop()
    mode, n_sess = a["mode"], a["sessions"]
    host, port = a["host"], a["port"]
    interval = 1.0 / a["rate"]
    batch = a.get("batch", 1)
    counters = {"attempts": 0, "acked": 0, "moved": 0, "busy": 0,
                "reconnects": 0, "errors": 0, "connect_failures": 0,
                "moved_then_acked": 0}
    lats: list = []
    last: dict = {}
    # Acks that landed inside the window (any schedule); ops scheduled
    # inside it and acked (any time), and when the last of those landed.
    window = {"acked_in": 0, "ops": 0, "last_ack": 0.0}
    table = None
    routing = None
    if mode == "fed":
        routing = load_routing(a["routing_py"])
        r, w = await asyncio.open_connection(host, port)
        await _send(w, b'{"op": "route"}', tagged=False)
        rep = json.loads(await _recv(r, tagged=False))
        w.close()
        table = routing.RoutingTable.from_json(rep["routing"])

    route = {"table": table}

    async def refresh_route():
        """The newest table any reachable tier holds (a retired tier
        refuses the dial and is skipped)."""
        best = route["table"]
        for addr in dict.fromkeys(best.owners()):
            h, _, p = addr.rpartition(":")
            try:
                r, w = await asyncio.open_connection(h, int(p))
                try:
                    await _send(w, b'{"op": "route"}', tagged=False)
                    rep = json.loads(await _recv(r, tagged=False))
                finally:
                    w.close()
            except (OSError, ConnectionError,
                    asyncio.IncompleteReadError):
                continue
            if rep.get("routing"):
                new = routing.RoutingTable.from_json(rep["routing"])
                if new.epoch > best.epoch:
                    best = new
        route["table"] = best
        return best

    def slots_of(k):
        if mode == "fed":
            return [(k * a["n_slots"]) // max(1, n_sess)]
        return [a["base"] + k * batch + j for j in range(batch)]

    def addr_of(slot):
        h, _, p = table.owner_of(slot).rpartition(":")
        return h, int(p)

    caps = {"serve": None, "lane": ["binop"], "fed": ["federation"]}[mode]

    async def dial_k(k):
        h, p = addr_of(slots_of(k)[0]) if mode == "fed" else (host, port)
        try:
            return await _dial(h, p, caps)
        except (OSError, ConnectionError):
            return None

    conns = []
    for base in range(0, n_sess, 500):
        res = await asyncio.gather(*(dial_k(k) for k in range(
            base, min(base + 500, n_sess))))
        for r in res:
            if r is None:
                counters["connect_failures"] += 1
            conns.append(r)
    start = loop.time() + 1.0
    warm_end = start + a["warmup"]
    end = warm_end + a["duration"]
    print(f"START {start!r}", flush=True)
    tagged = caps is not None

    async def session(k, conn):
        reader, writer = conn
        slots = slots_of(k)
        epoch = None if table is None else table.epoch
        owner = None if table is None else table.owner_of(slots[0])
        t0 = start + (k / max(1, n_sess)) * interval
        i = 0
        try:
            while True:
                sched = t0 + i * interval
                if sched >= end:
                    return
                now = loop.time()
                if sched > now:
                    await asyncio.sleep(sched - now)
                i += 1
                counters["attempts"] += 1
                if mode == "lane":
                    await _send(writer, _binop_put(slots, i), tagged)
                    if not _binop_ok(await _recv(reader, tagged)):
                        counters["errors"] += 1
                        return
                else:
                    moved = False
                    for _ in range(64):
                        msg = {"op": "put", "slot": slots[0], "value": i}
                        if epoch is not None:
                            msg["epoch"] = epoch
                        try:
                            if writer is None:
                                h, _, p = owner.rpartition(":")
                                reader, writer = await _dial(h, int(p),
                                                             caps)
                            await _send(writer, json.dumps(msg).encode(),
                                        tagged)
                            reply = json.loads(await _recv(reader,
                                                           tagged))
                        except (ConnectionError, OSError,
                                asyncio.IncompleteReadError):
                            if owner is None:      # no router to retry
                                raise
                            counters["reconnects"] += 1
                            if writer is not None:
                                writer.close()
                            writer = None
                            await asyncio.sleep(0.01)
                            # The owner may have been merged away: ask
                            # a live tier for the newest table.
                            fresh = await refresh_route()
                            if fresh.epoch > epoch:
                                epoch = fresh.epoch
                                owner = fresh.owner_of(slots[0])
                            continue
                        if reply.get("ok"):
                            break
                        code = reply.get("code")
                        if code == "moved":
                            counters["moved"] += 1
                            moved = True
                            epoch = reply.get("epoch", epoch)
                            new = reply.get("owner") or owner
                            if new != owner:
                                owner = new
                                writer.close()
                                writer = None
                        elif code == "busy":
                            counters["busy"] += 1
                            await asyncio.sleep(0.01)
                        else:
                            counters["errors"] += 1
                            return
                    else:
                        counters["errors"] += 1
                        return
                    counters["moved_then_acked"] += moved
                done = loop.time()
                counters["acked"] += len(slots)
                for s in slots:
                    last[s] = i
                if warm_end <= done <= end:
                    window["acked_in"] += len(slots)
                if sched >= warm_end:
                    lats.append(done - sched)
                    window["ops"] += len(slots)
                    window["last_ack"] = max(window["last_ack"], done)
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            counters["errors"] += 1
        finally:
            if writer is not None:
                writer.close()

    await asyncio.gather(*(session(k, c) for k, c in enumerate(conns)
                           if c is not None))
    lats.sort()

    def pct_ms(p):
        if not lats:
            return None
        return lats[min(len(lats) - 1, int(p * (len(lats) - 1)))] * 1e3

    return dict(counters=counters, connected=n_sess
                - counters["connect_failures"], measured=len(lats),
                p50_ms=pct_ms(0.50), p99_ms=pct_ms(0.99),
                window_s=a["duration"], start=start,
                acked_in_window=window["acked_in"], window_ops=window["ops"],
                last_window_ack_s=(window["last_ack"] - warm_end
                                   if window["ops"] else None),
                last=sorted(last.items()))


def run(args: dict, on_start=None, timeout: float = 600.0) -> dict:
    """Run the fleet in a child process (the caller stays the tier's
    process); ``on_start(start)`` is called with the schedule's start
    on the shared monotonic clock while the fleet runs. Returns the
    fleet's result dict; raises if the child fails."""
    import subprocess
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             json.dumps(args)], stdout=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("START "):
            raise RuntimeError(f"fleet failed before its schedule: "
                               f"{line!r}")
        if on_start is not None:
            on_start(float(line.split()[1]))
        rest = proc.stdout.read()
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise RuntimeError(f"fleet exited {rc}")
    return json.loads(rest.strip().splitlines()[-1])


def main() -> int:
    args = json.loads(sys.argv[1])
    raise_fd_limit(args["sessions"] + 512)
    import gc
    gc.disable()      # a cycle pass over every live session lands in p99
    out = asyncio.run(fleet(args))
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
