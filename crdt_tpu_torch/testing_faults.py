"""Fault-injection TCP proxy for replication testing — EXPORTED API.

Sits between a sync client and a :class:`crdt_tpu_torch.net.SyncServer` and
misbehaves on a SEEDED schedule: refuse connections, delay or trickle
bytes, truncate a frame mid-body, corrupt payload bytes, duplicate a
whole frame. The gossip runtime (`crdt_tpu_torch.gossip`) must converge
through all of it — that is the robustness claim the fault-matrix
soak (tests/test_network_soak.py) makes, and this proxy is what makes
the claim falsifiable.

Faults are applied to the client→server byte stream (the direction
that carries pushes and requests); the reply stream is forwarded
verbatim. Every fault surfaces to a well-behaved client as either an
EOF/desync (retryable transport fault) or a server-side rejection —
never as silent corruption: a corrupted byte XORs to an invalid UTF-8
sequence, so a damaged JSON frame fails to decode instead of parsing
to different records.

>>> with SyncServer(crdt) as server:
...     proxy = FaultProxy(server.host, server.port,
...                        FaultSchedule(seed=7)).start()
...     sync_over_tcp(other, proxy.host, proxy.port)   # may fault!
...     proxy.counters                                 # what fired
...     proxy.stop()

`FaultSchedule` draws one fault (or none) per CONNECTION from a
seeded rng; `ScriptedSchedule` replays an explicit list — unit tests
use it to script "refuse once, then behave". Set
:attr:`FaultProxy.passthrough` True to disable faulting (the soak's
settle phase) without tearing down the proxy.

Two crash-shaped primitives ride along for the replication suite
(docs/REPLICATION.md): :func:`abrupt_kill` (die with no farewell —
RST/linger-0, the SIGKILL signature) and
:attr:`FaultProxy.blackhole` (asymmetric partition: swallow ONE
direction's bytes with no FIN and no RST, so the victim looks mute
rather than dead).
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Dict, Iterable, Optional

# Corruption XOR mask: flips the high bit of any ASCII byte, yielding
# an invalid UTF-8 sequence — corrupt JSON always FAILS to decode
# rather than decoding to different data.
_CORRUPT_MASK = 0xA5

# A frame larger than this is passed through un-duplicated rather than
# buffered (the duplicate fault is frame-aware and must not hold a
# 100 MB push in memory).
_DUP_FRAME_CAP = 1 << 20


def _slam(sock: socket.socket) -> None:
    """Close WITHOUT a FIN: SO_LINGER zero makes close() send a bare
    RST (or nothing the peer ever hears, if the segment is lost) — the
    kernel-level signature of a SIGKILLed process, as opposed to
    `_teardown`'s orderly shutdown. Replication tests use this to
    prove failover does not depend on the dying side saying goodbye
    (docs/REPLICATION.md)."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def abrupt_kill(target) -> None:
    """The abrupt-kill primitive: die NOW, with no farewell protocol.

    Dispatch by shape — a `ReplicaGroup` loses its primary
    (``kill_primary``), a `ServeTier` (anything with a no-arg
    ``kill()``) dies via its own SIGKILL-equivalent teardown, a
    `FaultProxy` slams every established relay (RST both ways), and a
    bare socket is linger-0 closed. This is the one primitive chaos
    tests should reach for, so "kill" means the same thing
    everywhere."""
    kill_primary = getattr(target, "kill_primary", None)
    if callable(kill_primary):
        kill_primary()
        return
    kill = getattr(target, "kill", None)
    if callable(kill) and not isinstance(target, socket.socket):
        kill()
        return
    if isinstance(target, FaultProxy):
        target.slam()
        return
    if isinstance(target, socket.socket):
        _slam(target)
        return
    raise TypeError(f"don't know how to abruptly kill {target!r}")


def _teardown(sock: socket.socket) -> None:
    """shutdown + close: the shutdown forces the FIN out (and wakes
    any thread blocked in recv on the socket) even while another
    in-flight syscall keeps the kernel file referenced — a bare
    close() in that state notifies nobody."""
    for call in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
        try:
            call()
        except OSError:
            pass


class FaultSchedule:
    """Seeded per-connection fault plan.

    ``rate`` is the probability a connection faults at all; ``kinds``
    weights the fault drawn when one does. Defaults exercise the whole
    matrix. Deterministic for a fixed seed and connection order."""

    DEFAULT_KINDS = {"drop": 2, "delay": 2, "trickle": 1,
                     "truncate": 2, "corrupt": 2, "duplicate": 1}

    def __init__(self, seed: int = 0, rate: float = 0.5,
                 kinds: Optional[Dict[str, float]] = None,
                 max_delay: float = 0.05):
        self._rng = random.Random(seed)
        self.rate = rate
        self.kinds = dict(kinds if kinds is not None
                          else self.DEFAULT_KINDS)
        self.max_delay = max_delay

    def next_fault(self) -> Optional[dict]:
        rng = self._rng
        if rng.random() >= self.rate:
            return None
        names = sorted(self.kinds)
        kind = rng.choices(names,
                           weights=[self.kinds[n] for n in names])[0]
        if kind == "delay":
            return {"kind": kind,
                    "seconds": rng.uniform(0.0, self.max_delay)}
        if kind == "truncate":
            # Inside the first frame's header-or-body for any real
            # payload, so the cut is mid-frame, not between frames.
            return {"kind": kind, "after": rng.randrange(1, 40)}
        if kind == "corrupt":
            # Past the 4-byte length prefix: framing stays intact and
            # the DAMAGE lands in the body, where it must be caught by
            # decode, not by a misread frame length.
            return {"kind": kind, "offset": rng.randrange(4, 160)}
        return {"kind": kind}


class ScriptedSchedule:
    """Replays an explicit fault sequence, one entry per connection
    (None = behave); after the script runs out, behaves forever."""

    def __init__(self, plan: Iterable[Optional[dict]]):
        self._plan = list(plan)
        self._i = 0

    def next_fault(self) -> Optional[dict]:
        if self._i >= len(self._plan):
            return None
        fault = self._plan[self._i]
        self._i += 1
        return fault


class FaultProxy:
    """TCP proxy with scheduled misbehavior (see module docstring).

    ``counters`` maps fault kind → times it actually FIRED (a
    truncate-at-1000 against a 40-byte stream never fires and is not
    counted), plus ``"connections"``. The soak asserts on these to
    prove its faults happened."""

    _passthrough = False
    _blackhole: Optional[str] = None

    def __init__(self, target_host: str, target_port: int,
                 schedule=None,
                 host: str = "127.0.0.1", port: int = 0):
        self.target_host = target_host
        self.target_port = target_port
        self.schedule = schedule or FaultSchedule()
        self.counters: Dict[str, int] = {}
        self._counter_lock = threading.Lock()
        self._lsock = socket.create_server((host, port))
        self._lsock.settimeout(0.2)   # poll the stop flag
        self.host, self.port = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._open: set = set()       # sockets to tear down on stop

    # --- lifecycle (SyncServer's shape) ---

    def start(self) -> "FaultProxy":
        self._thread = threading.Thread(
            target=self._serve, daemon=True,
            name=f"fault-proxy-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for sock in list(self._open):
            _teardown(sock)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._lsock.close()

    def __enter__(self) -> "FaultProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def passthrough(self) -> bool:
        """Faulting disabled? Flipping True→False (a test starting
        its partition) also tears down ESTABLISHED relays: pooled
        clients hold sessions open across rounds, and a partition
        must cut those flows too — not just refuse new connects."""
        return self._passthrough

    @passthrough.setter
    def passthrough(self, value: bool) -> None:
        was = self._passthrough
        self._passthrough = value
        if was and not value:
            for sock in list(self._open):
                self._open.discard(sock)
                _teardown(sock)

    @property
    def blackhole(self) -> Optional[str]:
        """Asymmetric partition mode: ``"c2s"`` silently swallows the
        client→server byte stream (requests vanish, replies still
        flow), ``"s2c"`` the reverse (requests land, acks never come
        back — the direction that distinguishes "dead" from "mute",
        which is what lease fencing exists for), ``"both"`` swallows
        both, ``None`` restores normal relaying. Unlike a passthrough
        flip nothing is torn down: no FIN, no RST — bytes just stop
        arriving, exactly like a one-way network partition."""
        return self._blackhole

    @blackhole.setter
    def blackhole(self, value: Optional[str]) -> None:
        if value not in (None, "c2s", "s2c", "both"):
            raise ValueError(
                f"blackhole must be None/'c2s'/'s2c'/'both'; "
                f"got {value!r}")
        self._blackhole = value

    def slam(self) -> None:
        """RST every established relay, both directions, and refuse
        nothing afterward: the proxy itself stays up (unlike `stop`),
        but every flow that existed dies the SIGKILL way — no FIN."""
        self._count("slam")
        for sock in list(self._open):
            self._open.discard(sock)
            _slam(sock)

    def _count(self, key: str) -> None:
        with self._counter_lock:
            self.counters[key] = self.counters.get(key, 0) + 1

    # --- relay ---

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._relay, args=(conn,),
                             daemon=True,
                             name=f"fault-relay-{self.port}"
                                  f"-fd{conn.fileno()}").start()

    def _relay(self, conn: socket.socket) -> None:
        self._count("connections")
        fault = (None if self.passthrough
                 else self.schedule.next_fault())
        if fault is not None and fault["kind"] == "drop":
            # Accept-then-slam: the client sees a vanished peer.
            self._count("drop")
            conn.close()
            return
        try:
            up = socket.create_connection(
                (self.target_host, self.target_port), timeout=10)
        except OSError:
            conn.close()
            return
        self._open.update((conn, up))
        conn.settimeout(60)
        up.settimeout(60)
        if fault is not None and fault["kind"] == "delay":
            self._count("delay")
            time.sleep(fault["seconds"])
        reply_pump = threading.Thread(
            target=self._pump_verbatim, args=(up, conn), daemon=True,
            name=f"fault-reply-pump-{self.port}")
        reply_pump.start()
        try:
            self._pump_faulty(conn, up, fault)
        finally:
            # shutdown() BEFORE close(): close alone does not send the
            # FIN while the reply pump still holds a blocked recv on
            # the socket (the in-flight syscall keeps the kernel file
            # alive), and the un-notified server would park its
            # single-connection handler in a 30 s recv — starving the
            # client's own retry connection.
            for sock in (conn, up):
                self._open.discard(sock)
                _teardown(sock)
            reply_pump.join(timeout=10)

    def _pump_verbatim(self, src: socket.socket,
                       dst: socket.socket) -> None:
        """Server→client direction: faithful forwarding. A close from
        the server is PROPAGATED (shutdown of the client's read side):
        a client waiting for a reply the server will never send must
        see EOF now, not its whole round timeout later."""
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    return
                if self._blackhole in ("s2c", "both"):
                    self._count("blackhole_s2c")
                    continue
                dst.sendall(data)
        except OSError:
            return
        finally:
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def _pump_faulty(self, src: socket.socket, dst: socket.socket,
                     fault: Optional[dict]) -> None:
        """Client→server direction with the scheduled fault applied."""
        kind = fault["kind"] if fault is not None else None
        sent = 0
        try:
            if kind == "duplicate":
                sent = self._duplicate_first_frame(src, dst)
            while True:
                data = src.recv(1 << 16)
                if not data:
                    return
                if self._blackhole in ("c2s", "both"):
                    self._count("blackhole_c2s")
                    continue
                if kind == "truncate":
                    cut = fault["after"] - sent
                    if cut < len(data):
                        # Forward a prefix, then kill both ends: the
                        # server holds a partial frame, the client a
                        # dead socket.
                        self._count("truncate")
                        if cut > 0:
                            dst.sendall(data[:cut])
                        return
                elif kind == "corrupt":
                    off = fault["offset"] - sent
                    if 0 <= off < len(data):
                        self._count("corrupt")
                        damaged = bytearray(data)
                        damaged[off] ^= _CORRUPT_MASK
                        data = bytes(damaged)
                elif kind == "trickle" and sent < 64:
                    # Drip the first bytes through one at a time —
                    # exercises every whole-frame deadline bound.
                    if sent == 0:
                        self._count("trickle")
                    for i in range(len(data)):
                        dst.sendall(data[i:i + 1])
                        if sent + i < 64:
                            time.sleep(0.002)
                    sent += len(data)
                    continue
                dst.sendall(data)
                sent += len(data)
        except OSError:
            return

    def _duplicate_first_frame(self, src: socket.socket,
                               dst: socket.socket) -> int:
        """Read the first length-prefixed frame whole and send it
        TWICE — the server processes one request twice and the client's
        reply stream desynchronizes (a retryable fault, since rounds
        are idempotent). Returns bytes forwarded (the original's)."""
        head = self._read_exact(src, 4)
        if head is None:
            return 0
        (n,) = struct.unpack(">I", head)
        if n > _DUP_FRAME_CAP:
            dst.sendall(head)
            return 4
        body = self._read_exact(src, n)
        if body is None:
            dst.sendall(head)
            return 4
        self._count("duplicate")
        dst.sendall(head + body)
        dst.sendall(head + body)
        return 4 + n

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)


class ProxyFarm:
    """One `FaultProxy` per real address, minted on demand — the
    ``addr_via`` seam that puts a misbehaving proxy on EVERY wire a
    replica group (or a whole `FederatedTier`) uses: pass
    ``addr_via=farm.via`` and each member's advertised address becomes
    its proxy's, so replication ships, heartbeats, split/merge streams
    and client traffic all cross scheduled faults. Partitions spawned
    LATER (a live split's recipient) get their own proxies the moment
    their addresses are first advertised. ``make_schedule(i)`` builds
    the i-th proxy's schedule (default: a mild drop/delay/duplicate
    mix seeded by i, so runs are reproducible)."""

    def __init__(self, make_schedule=None):
        self._make = make_schedule if make_schedule is not None else (
            lambda i: FaultSchedule(
                seed=i, rate=0.1,
                kinds={"drop": 1, "delay": 2, "duplicate": 1},
                max_delay=0.02))
        self.proxies: Dict[str, FaultProxy] = {}
        self._lock = threading.Lock()

    def via(self, real_addr: str) -> str:
        """The advertised (proxied) address for ``real_addr``,
        creating and starting the proxy on first sight."""
        with self._lock:
            proxy = self.proxies.get(real_addr)
            if proxy is None:
                host, _, port = str(real_addr).rpartition(":")
                proxy = FaultProxy(host, int(port),
                                   schedule=self._make(
                                       len(self.proxies))).start()
                self.proxies[real_addr] = proxy
            return f"{proxy.host}:{proxy.port}"

    def counters(self) -> Dict[str, int]:
        """Aggregate fault counters across every proxy — the soak's
        proof that chaos actually flowed through the wires."""
        agg: Dict[str, int] = {}
        with self._lock:
            proxies = list(self.proxies.values())
        for proxy in proxies:
            for k, v in proxy.counters.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def stop(self) -> None:
        with self._lock:
            proxies, self.proxies = list(self.proxies.values()), {}
        for proxy in proxies:
            proxy.stop()

    def __enter__(self) -> "ProxyFarm":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
