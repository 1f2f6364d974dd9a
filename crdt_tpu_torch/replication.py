"""Replica groups: health-checked failover, write-concern acks, and
zero-loss crash recovery (docs/REPLICATION.md).

Port of ``crdt_tpu/replication.py``: the same barrier frames, monitor,
election and rejoin. Default members are `DenseCrdt` s on ``device``
(the card unless named; a host with no card raises at construction
unless given ``device="cpu"`` or its own ``make_crdt``).

The federated front door (routing.py / federation.py) scales OUT —
each partition owns an arc of the keyspace — but a partition is one
process, and one crash loses every acked write on its arc. This
module backs a partition with N replicas and makes three promises:

1. **Write concern** — the primary's flush tick resolves client acks
   only after :class:`Replicator` confirms the tick's `PackedDelta`
   on ``ack_replicas`` followers (serve.py's barrier). A primary crash
   then loses zero ACKED writes: everything acked is already a
   durable lattice row somewhere that can win the election.
2. **Failover** — a monitor thread heartbeats every member over the
   wire (the serve ``heartbeat`` op, which deliberately rides the
   replica executor so a wedged replica lane reads as dead). A
   primary that misses ``lease_misses`` consecutive beats is
   declared dead; the most-caught-up live follower (highest durable
   HLC head, digest-root then name as tie-breaks) is promoted; the
   routing table flips via `RoutingTable.reassign` (epoch + 1) and
   clients recover through the existing ``moved`` retry machinery.
3. **Rejoin** — a restarted replica builds a FRESH store (the crash
   image is never reused), catches up with a merkle frontier walk
   against the current primary, and re-enters as a follower.

Why this is NOT consensus: every replicated payload is an idempotent
lattice join, so replay, duplication, and even a brief dual-primary
window (an old primary serving out its lease while the new one is
already elected) cannot diverge the store — both sides' writes merge.
What the machinery guarantees is the ACK contract: an acked write
survives any single crash, and a fenced primary (expired lease, or a
write-concern barrier it cannot clear) answers the retryable ``busy``
code instead of acking writes it cannot back. CRDT convergence turns
the usual consensus problem into a routing/liveness problem — the
survey framing in PAPER.md, taken literally.

Role is ROUTING, not a mode switch: every member runs the same
`ServeTier` with a `PartitionRouter` whose table names the primary as
owner of the whole arc. A client write landing on a follower answers
``moved`` through the normal admission gate; promotion is just a
table flip. Gossip reuse: per-follower `CircuitBreaker` /
`BreakerPolicy` (gossip.py) keep a dead follower from adding its
timeout to every barrier.
"""

from __future__ import annotations

import socket
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Callable, Dict, List, Optional, Tuple

from .utils.concurrency import make_lock
from .gossip import BreakerPolicy, CircuitBreaker
from .hlc import Hlc
from .net import (PeerConnection, SyncError, SyncProtocolError,
                  WireTally, _pack_for_peer, recv_frame,
                  send_bytes_frame, send_frame,
                  sync_merkle_over_conn)
from .routing import PartitionRouter, RoutingTable
from .serve import ServeTier
from .utils.devices import resolve_device

__all__ = ["Replicator", "ReplicaGroup"]


def _split_addr(addr: str) -> Tuple[str, int]:
    host, _, port = str(addr).rpartition(":")
    return host, int(port)


class _Follower:
    """Primary-side view of one follower: pooled session, pack
    watermark, durable head, breaker, and the in-flight ship (a
    follower still chewing a previous barrier's pack is skipped, not
    waited on — one slow follower must not serialize ticks)."""

    __slots__ = ("name", "addr", "conn", "mark", "durable", "breaker",
                 "inflight")

    def __init__(self, name: str, addr: str, timeout: float):
        self.name = name
        self.addr = addr
        host, port = _split_addr(addr)
        self.conn = PeerConnection(
            host, port, timeout=timeout,
            want_caps=("zlib", "packed", "semantics", "replication"))
        self.mark: Optional[Hlc] = None
        self.durable: Optional[str] = None
        self.breaker = CircuitBreaker(
            BreakerPolicy(failure_threshold=3, reset_timeout=1.0),
            name=name)
        self.inflight = None


class Replicator:
    """The write-concern half of a primary: ship each tick's pack to
    every follower, report success once ``ack_replicas`` confirmed.

    ``barrier()`` runs on the tier's replica executor immediately
    after the tick's commit (same thread), so the pack taken under
    the tier lock necessarily contains the tick. Shipping fans out on
    a private pool; per-follower packs are `pack_since(mark)` where
    ``mark`` is that follower's last confirmed head — usually equal
    across followers, so the store's pack cache collapses N packs
    into one device dispatch.
    """

    # Checked by analysis/concurrency.py: membership mutations may
    # hold `_lock` while reading the tier's store lock, never the
    # reverse — barrier() runs lock-free on the tier's executor.
    _CRDTLINT_LOCK_ORDER = ("_lock", ("tier.lock", "ServeTier.lock"))

    def __init__(self, tier: ServeTier, followers: Dict[str, str],
                 ack_replicas: int = 1, timeout: float = 0.25,
                 group: str = "g0"):
        self.tier = tier
        self.ack_replicas = int(ack_replicas)
        self.timeout = float(timeout)
        self.group = str(group)
        self.tally = WireTally()
        self._lock = make_lock("Replicator._lock", 20)  # membership
        self._followers: Dict[str, _Follower] = {
            str(name): _Follower(str(name), str(addr), self.timeout)
            for name, addr in followers.items()}
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, len(self._followers) + 1),
            thread_name_prefix="replicate")
        from .obs.registry import default_registry
        reg = default_registry()
        self._m_acks = reg.counter(
            "crdt_tpu_replication_acks_total",
            "write-concern barrier follower confirmations by outcome")
        self._m_barrier = reg.histogram(
            "crdt_tpu_replication_barrier_seconds",
            "flush-tick write-concern barrier wall time")
        # Sketch twin: relative-error barrier quantiles for the fleet
        # roll-up (obs/sketch.py; docs/OBSERVABILITY.md).
        self._m_barrier_sketch = reg.sketch(
            "crdt_tpu_replication_barrier_seconds_sketch",
            "flush-tick write-concern barrier wall time, "
            "relative-error quantile sketch")

    # --- membership (monitor thread) ---

    def add_follower(self, name: str, addr: str) -> None:
        with self._lock:
            self._followers[str(name)] = _Follower(
                str(name), str(addr), self.timeout)

    def drop_follower(self, name: str) -> None:
        with self._lock:
            f = self._followers.pop(str(name), None)
        if f is not None:
            f.conn.close()

    def status(self) -> dict:
        with self._lock:
            followers = list(self._followers.values())
        return {f.name: {"addr": f.addr, "durable": f.durable,
                         "breaker": f.breaker.state}
                for f in followers}

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        with self._lock:
            followers = list(self._followers.values())
            self._followers.clear()
        for f in followers:
            try:
                f.conn.close()
            except Exception:
                pass

    # --- the barrier (tier replica executor thread) ---

    def barrier(self) -> Tuple[bool, str]:
        """Confirm the just-committed tick on ``ack_replicas``
        followers. Returns ``(ok, detail)``; a miss maps to the
        retryable ``busy`` ack in serve.py — the local commit stands
        (idempotent join, converges later), but the CLIENT retries
        until an ack backed by the group lands."""
        need = self.ack_replicas
        if need <= 0:
            return True, "ack_replicas=0"
        t0 = time.perf_counter()
        with self._lock:
            followers = list(self._followers.values())
        jobs = []
        for f in followers:
            prev = f.inflight
            if prev is not None:
                if not prev.done():
                    continue   # still shipping a previous tick: miss
                f.inflight = None
            if not f.breaker.allow():
                continue       # open breaker: skip, don't pay timeout
            fut = self._pool.submit(self._ship, f)
            f.inflight = fut
            jobs.append(fut)
        acked = 0
        pending = set(jobs)
        deadline = t0 + self.timeout + 0.05
        while pending and acked < need:
            budget = deadline - time.perf_counter()
            if budget <= 0:
                break
            done, pending = futures_wait(
                pending, timeout=budget,
                return_when=FIRST_COMPLETED)
            for fut in done:
                if fut.result():
                    acked += 1
        barrier_s = time.perf_counter() - t0
        self._m_barrier.observe(barrier_s, group=self.group)
        self._m_barrier_sketch.observe(barrier_s, group=self.group)
        if acked >= need:
            return True, f"{acked}/{need} follower acks"
        return False, (f"write concern unmet: {acked}/{need} "
                       f"follower acks ({len(followers)} followers)")

    def _ship(self, f: _Follower) -> bool:
        """Ship `pack_since(f.mark)` to one follower via the
        ``replicate`` op and record its durable head. Runs on the
        replicator pool; the tier lock bounds the pack read only."""
        from .ops.packing import pack_rows
        tier = self.tier
        try:
            sock = f.conn.ensure(self.tally)
            sem_ok = "semantics" in f.conn.caps
            with tier.lock:
                head = tier.crdt.canonical_time
                packed, ids = _pack_for_peer(tier.crdt, f.mark,
                                             sem_ok)
            if packed.k:
                meta, bufs = pack_rows(packed)
                send_frame(sock, {"op": "replicate", "meta": meta,
                                  "node_ids": list(ids)},
                           self.tally, f.conn.codec)
                send_bytes_frame(sock, bufs, self.tally, f.conn.codec)
                reply = recv_frame(
                    sock, deadline=time.monotonic() + self.timeout,
                    tally=self.tally, codec=f.conn.codec)
                if not isinstance(reply, dict) or not reply.get("ok"):
                    raise ConnectionError(
                        f"replicate rejected: {reply!r}")
                f.durable = reply.get("hlc")
            f.mark = head
            f.breaker.record_success()
            self._m_acks.inc(group=self.group, follower=f.name,
                             outcome="ok")
            return True
        except (SyncError, ConnectionError, OSError, ValueError,
                socket.timeout) as e:
            f.conn.reset()
            f.breaker.record_failure()
            self._m_acks.inc(group=self.group, follower=f.name,
                             outcome=type(e).__name__)
            return False


class _HbClient:
    """One persistent blocking heartbeat session to a member — the
    pre-hello untagged framing, since liveness probing must not
    depend on capability negotiation."""

    def __init__(self, addr: str, timeout: float):
        self.addr = addr
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None

    def beat(self, lease: Optional[dict] = None,
             want_root: bool = False) -> dict:
        msg: dict = {"op": "heartbeat"}
        if lease is not None:
            msg["lease"] = lease
        if want_root:
            msg["want_root"] = True
        try:
            if self._sock is None:
                host, port = _split_addr(self.addr)
                self._sock = socket.create_connection(
                    (host, port), timeout=self._timeout)
                self._sock.settimeout(self._timeout)
            send_frame(self._sock, msg)
            reply = recv_frame(
                self._sock,
                deadline=time.monotonic() + self._timeout)
        except (ConnectionError, OSError, ValueError,
                socket.timeout) as e:
            self.close()
            raise ConnectionError(f"heartbeat {self.addr}: {e!r}") \
                from e
        if not isinstance(reply, dict) or not reply.get("ok"):
            self.close()
            raise ConnectionError(
                f"heartbeat {self.addr}: bad reply {reply!r}")
        return reply

    def close(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


class _Member:
    __slots__ = ("index", "name", "tier", "addr", "role", "misses",
                 "last", "generation", "hb")

    def __init__(self, index: int, name: str):
        self.index = index
        self.name = name
        self.tier: Optional[ServeTier] = None
        self.addr: Optional[str] = None
        self.role = "follower"      # follower | primary | down
        self.misses = 0
        self.last: dict = {}        # newest heartbeat reply
        self.generation = 0         # bumps on every rejoin
        self.hb: Optional[_HbClient] = None


class ReplicaGroup:
    """N replicas behind one keyspace arc: spawn, monitor, fail over,
    rejoin. Standalone (its own single-owner routing table) or as one
    partition of a `FederatedTier` (which passes ``table``/
    ``on_promote`` and publishes flips fleet-wide).

    ``make_crdt(replica_index, generation)`` builds each member's
    store; generation bumps on every rejoin so a restarted member
    NEVER reuses its crash image. ``addr_via`` maps a member's real
    listen address to the address the group advertises (routing
    table, replicator targets, heartbeats) — the test seam that puts
    a `FaultProxy` in front of every wire the group uses.
    """

    # Checked by analysis/concurrency.py: the group lock (monitor,
    # promotion, membership) may be held while a member tier's store
    # lock is taken; the reverse never happens — _on_promote re-enters
    # FederatedTier._control only AFTER this lock is released (the
    # lock-order invariant).
    _CRDTLINT_LOCK_ORDER = ("_lock", ("tier.lock", "ServeTier.lock"))

    def __init__(self, n_slots: int, replicas: int = 3,
                 ack_replicas: int = 1, host: str = "127.0.0.1",
                 group: str = "g0",
                 make_crdt: Optional[Callable] = None,
                 flush_interval: float = 0.002,
                 heartbeat_interval: float = 0.05,
                 heartbeat_timeout: float = 0.25,
                 lease_misses: int = 4,
                 lease_ttl: Optional[float] = None,
                 replicate_timeout: float = 0.25,
                 table: Optional[RoutingTable] = None,
                 on_promote: Optional[Callable] = None,
                 addr_via: Optional[Callable[[str], str]] = None,
                 tier_kwargs: Optional[dict] = None, device=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1; got {replicas}")
        if ack_replicas > replicas - 1:
            raise ValueError(
                f"ack_replicas={ack_replicas} needs more followers "
                f"than {replicas} replicas provide")
        self.n_slots = int(n_slots)
        self.replicas = int(replicas)
        self.ack_replicas = int(ack_replicas)
        self.host = host
        self.group = str(group)
        self.flush_interval = flush_interval
        self.heartbeat_interval = float(heartbeat_interval)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.lease_misses = int(lease_misses)
        # The fence window a partitioned ex-primary serves out before
        # it stops acking: generous enough that heartbeat jitter
        # cannot fence a healthy primary, short enough that the
        # dual-primary overlap after a promotion stays bounded (and
        # harmless — both sides' writes are joinable; see module doc).
        self.lease_ttl = (float(lease_ttl) if lease_ttl is not None
                          else heartbeat_interval * lease_misses * 2)
        self.replicate_timeout = float(replicate_timeout)
        self._make_crdt = (make_crdt if make_crdt is not None
                           else self._default_crdt)
        # Where the default members live: the card unless the caller
        # names a device (`utils.devices.resolve_device` raises without
        # one), resolved at construction. A caller's own ``make_crdt``
        # places its replicas itself.
        self.device = (None if make_crdt is not None and device is None
                       else resolve_device(device))
        self.on_promote = on_promote
        self._addr_via = addr_via if addr_via is not None \
            else (lambda a: a)
        self._tier_kwargs = dict(tier_kwargs or {})
        self.table = table
        self.members: List[_Member] = [
            _Member(i, f"{self.group}-r{i}")
            for i in range(self.replicas)]
        self._lock = make_lock("ReplicaGroup._lock", 30, rlock=True)
        self._lease_epoch = 1
        self._primary: Optional[_Member] = None
        # The table owner a pending flip must replace — survives a
        # no-candidate election round so a LATER promotion still
        # reassigns the dead primary's arcs.
        self._flip_addr: Optional[str] = None
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._hb_pool: Optional[ThreadPoolExecutor] = None
        self.failovers = 0
        self.last_failover_s: Optional[float] = None

        from .obs.registry import default_registry
        reg = default_registry()
        self._m_failover = reg.counter(
            "crdt_tpu_failover_total",
            "primary failovers driven by the group monitor")
        self._m_health = reg.gauge(
            "crdt_tpu_replica_health",
            "per-replica liveness as seen by the group monitor "
            "(1 = beating, 0 = declared down)")

    def _default_crdt(self, index: int, generation: int):
        from .models.dense_crdt import DenseCrdt
        return DenseCrdt(f"{self.group}-r{index}.{generation}",
                         self.n_slots, device=self.device)

    # --- lifecycle ---

    def start(self) -> "ReplicaGroup":
        with self._lock:
            for m in self.members:
                self._spawn(m)
            primary = self.members[0]
            primary.role = "primary"
            primary.tier.role = "primary"
            self._primary = primary
            if self.table is None and self.on_promote is None:
                # Standalone groups own their table. Under a
                # federation (`on_promote` set) the FLEET table is the
                # authority — pre-installing a private epoch-0 table
                # here would tie with the fleet's epoch-0 publish and
                # `PartitionRouter.install` keeps the incumbent on
                # ties, wedging every member on the private view.
                self.table = RoutingTable.even(
                    self.n_slots, [primary.addr])
            if self.table is not None:
                self.install_table(self.table)
            self._attach_replicator(primary)
        self._hb_pool = ThreadPoolExecutor(
            max_workers=self.replicas,
            thread_name_prefix=f"{self.group}-hb")
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name=f"{self.group}-monitor")
        self._monitor.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        monitor, self._monitor = self._monitor, None
        if monitor is not None:
            monitor.join(timeout=30)
        if self._hb_pool is not None:
            self._hb_pool.shutdown(wait=False)
            self._hb_pool = None
        with self._lock:
            members = list(self.members)
        for m in members:
            if m.hb is not None:
                m.hb.close()
            tier = m.tier
            if tier is not None:
                rep = tier.replicator
                if rep is not None:
                    rep.close()
                try:
                    tier.stop()
                except RuntimeError:
                    pass

    def __enter__(self) -> "ReplicaGroup":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- spawn / membership ---

    def _spawn(self, m: _Member) -> None:
        crdt = self._make_crdt(m.index, m.generation)
        router = PartitionRouter()
        tier = ServeTier(crdt, host=self.host, port=0,
                         flush_interval=self.flush_interval,
                         router=router, **self._tier_kwargs)
        tier.group_name = self.group
        tier.role = "follower"
        tier.start()
        m.tier = tier
        m.addr = self._addr_via(f"{tier.host}:{tier.port}")
        # The router believes the ADVERTISED address: `owns` must
        # agree with the table the group publishes, proxy or not.
        router.bind(m.addr)
        m.hb = _HbClient(m.addr, self.heartbeat_timeout)
        m.misses = 0
        m.role = "follower"
        self._m_health.set(1, group=self.group, replica=m.name)

    def _attach_replicator(self, primary: _Member) -> None:
        followers = {m.name: m.addr for m in self.members
                     if m is not primary and m.role == "follower"}
        primary.tier.replicator = Replicator(
            primary.tier, followers, ack_replicas=self.ack_replicas,
            timeout=self.replicate_timeout, group=self.group)

    def install_table(self, table: RoutingTable) -> None:
        """Install ``table`` on every live member's router. MUST stay
        lock-free: federation calls this under its control lock while
        the promote path runs group-lock → control-lock — taking the
        group lock here would complete the deadlock cycle. Router
        `install` is itself epoch-guarded and thread-safe."""
        self.table = table
        for m in self.members:
            tier = m.tier
            if tier is not None and tier.router is not None \
                    and not tier.killed:
                tier.router.install(table)

    # --- queries ---

    @property
    def primary(self) -> Optional[_Member]:
        with self._lock:
            return self._primary

    def primary_addr(self) -> Optional[str]:
        m = self.primary
        return None if m is None else m.addr

    def member_addrs(self) -> List[str]:
        with self._lock:
            return [m.addr for m in self.members
                    if m.addr is not None and m.role != "down"]

    # --- fault injection (tests / bench) ---

    def kill(self, index: int) -> _Member:
        """Abruptly kill one member (RST, no drain). Group state is
        NOT updated here — the monitor must discover the death over
        the wire, which is exactly the MTTR the bench measures."""
        m = self.members[index]
        m.tier.kill()
        return m

    def kill_primary(self) -> _Member:
        m = self.primary
        if m is None:
            raise RuntimeError("no live primary to kill")
        return self.kill(m.index)

    # --- monitor / failover ---

    def _monitor_loop(self) -> None:
        interval = self.heartbeat_interval
        while not self._stop.wait(interval):
            with self._lock:
                live = [m for m in self.members if m.role != "down"]
                primary = self._primary
                lease = None
                if primary is not None:
                    lease = {"holder": f"{self.group}-monitor",
                             "ttl_ms": self.lease_ttl * 1000.0,
                             "epoch": self._lease_epoch}
            futs = {m: self._hb_pool.submit(
                        m.hb.beat,
                        lease if m is primary else None)
                    for m in live}
            for m, fut in futs.items():
                try:
                    m.last = fut.result()
                    m.misses = 0
                    self._m_health.set(1, group=self.group,
                                       replica=m.name)
                except Exception:
                    m.misses += 1
            dead_primary = None
            with self._lock:
                for m in live:
                    if m.misses >= self.lease_misses:
                        self._m_health.set(0, group=self.group,
                                           replica=m.name)
                        if m is self._primary:
                            dead_primary = m
                        else:
                            self._drop_follower(m)
            if dead_primary is not None or self.primary is None:
                self._failover(dead_primary)

    def _drop_follower(self, m: _Member) -> None:
        """A follower that stopped beating leaves the write-concern
        set so barriers stop paying its timeout; `rejoin` re-adds
        it. Caller holds the group lock."""
        m.role = "down"
        primary = self._primary
        if primary is not None and primary.tier is not None:
            rep = primary.tier.replicator
            if rep is not None:
                rep.drop_follower(m.name)

    def _failover(self, dead: Optional[_Member]) -> None:
        from .obs.trace import span
        t0 = time.perf_counter()
        with self._lock:
            if dead is not None:
                dead.role = "down"
                if self._primary is dead:
                    self._primary = None
                    self._flip_addr = dead.addr
                self._m_health.set(0, group=self.group,
                                   replica=dead.name)
            if self._primary is not None:
                return
            candidates = [m for m in self.members
                          if m.role == "follower"]
            old_addr = self._flip_addr
        if not candidates:
            return     # nothing electable yet; retried next round
        with span("failover", kind="failover", group=self.group,
                  dead=(dead.name if dead is not None else None)):
            # Election: freshest durable head wins; digest root, then
            # name, break ties deterministically. A candidate that
            # cannot answer the probe is not electable.
            scored = []
            for m in candidates:
                try:
                    reply = m.hb.beat(want_root=True)
                except ConnectionError:
                    continue
                try:
                    head = Hlc.parse(str(reply.get("hlc")))
                except (ValueError, TypeError):
                    continue
                scored.append(
                    (head, int(reply.get("root", 0) or 0), m.name, m))
            if not scored:
                return
            scored.sort(key=lambda s: (s[0], s[1], s[2]))
            winner = scored[-1][3]
            # Close the ack-coverage gap BEFORE the routing flip:
            # with ack_replicas < followers, each tick's write
            # concern is satisfied by whichever follower acked
            # first, so no single follower — the freshest-head
            # winner included — is guaranteed a superset of every
            # acked row. Lattice-join the winner from each
            # reachable survivor so promotion never buries a row
            # some other follower acked. Best-effort per survivor:
            # losing the primary AND the only follower holding a
            # tick exceeds what ack_replicas=1 promises.
            for m in candidates:
                if m is winner or m.addr is None:
                    continue
                host, port = _split_addr(m.addr)
                for attempt in range(2):
                    try:
                        conn = PeerConnection(
                            host, port,
                            timeout=self.heartbeat_timeout * 4)
                    except (ConnectionError, OSError):
                        continue
                    try:
                        sync_merkle_over_conn(
                            winner.tier.crdt, conn,
                            lock=winner.tier.lock)
                        break
                    except SyncProtocolError:
                        break
                    except (ConnectionError, OSError):
                        pass
                    finally:
                        conn.close()
            self._promote(winner, old_addr)
        elapsed = time.perf_counter() - t0
        with self._lock:
            self.failovers += 1
            self.last_failover_s = elapsed
        self._m_failover.inc(group=self.group)

    def _promote(self, winner: _Member, old_addr: Optional[str]
                 ) -> None:
        """Routing flip + role flip. The dead primary is never
        touched (it may genuinely be gone, or partitioned — its lease
        fence handles the latter); the winner gets a fresh
        `Replicator` over the remaining live followers and the table
        epoch bumps so every stale client is refused into a refresh."""
        with self._lock:
            winner.role = "primary"
            self._primary = winner
            self._flip_addr = None
            self._lease_epoch += 1
            self._attach_replicator(winner)
            winner.tier.role = "primary"
            table = self.table
            if table is not None and old_addr is not None \
                    and old_addr in table.owners():
                table = table.reassign(old_addr, winner.addr)
        if self.on_promote is not None:
            # Called with the group lock RELEASED (``_primary`` is
            # already visible): federation takes its control lock in
            # here, and a concurrent split holding that control lock
            # polls `primary` (group lock) — invoking the callback
            # under the group lock would complete a deadlock cycle.
            self.on_promote(self, table)
        elif table is not None:
            self.install_table(table)
        # Seed the new primary's lease immediately — the next monitor
        # round would too, but the write path is fenced-free sooner.
        try:
            winner.hb.beat(lease={
                "holder": f"{self.group}-monitor",
                "ttl_ms": self.lease_ttl * 1000.0,
                "epoch": self._lease_epoch})
        except ConnectionError:
            pass

    # --- rejoin ---

    @staticmethod
    def _count_rejoin_bytes(crdt) -> None:
        """Live/tombstone byte split of what a rejoin walk pulled
        into the fresh store (docs/STORAGE.md): the primary ran GC
        first, so tombstone_bytes ≈ 0 is the measurable payoff —
        every tombstone here is one GC could not yet prove stable.
        Wire row width matches the packed lane layout (slot 4 + lt 8
        + node 4 + val 8 + tomb 1)."""
        store = getattr(crdt, "store", None)
        if store is None or not hasattr(store, "tomb"):
            return
        from .obs.registry import default_registry
        # Two counts on the store's device, then two scalars to the host.
        occ = store.occupied
        tomb_rows = int((occ & store.tomb).sum())
        live_rows = int(occ.sum()) - tomb_rows
        reg = default_registry()
        reg.counter(
            "crdt_tpu_shipped_live_bytes_total",
            "packed bytes of live rows shipped by migration streams "
            "and rejoin walks (surface label: migrate|rejoin)").inc(
                live_rows * 25, surface="rejoin")
        reg.counter(
            "crdt_tpu_shipped_tombstone_bytes_total",
            "packed bytes of tombstone rows shipped by migration "
            "streams and rejoin walks (surface label: "
            "migrate|rejoin)").inc(tomb_rows * 25, surface="rejoin")

    def rejoin(self, index: int) -> _Member:
        """Restart a down member: FRESH store, merkle catch-up from
        the current primary, then re-enter as a follower in the
        write-concern set. The crash image is discarded — recovery is
        resync, not replay."""
        m = self.members[index]
        with self._lock:
            primary = self._primary
            if m.role != "down" and m.tier is not None \
                    and not m.tier.killed:
                raise RuntimeError(f"{m.name} is still live")
            if primary is None:
                raise RuntimeError("no live primary to rejoin from")
            m.generation += 1
            prev_port = 0 if m.tier is None else (m.tier.port or 0)
        crdt = self._make_crdt(m.index, m.generation)
        # Spend the GC bytes (docs/STORAGE.md): one epoch-GC pass on
        # the primary BEFORE the catch-up walk, so the rejoining
        # member pulls live rows only — stable tombstones are purged
        # instead of shipped. With this member down the durable set
        # is usually short a mark, which PINS the watermark and
        # purges nothing: unmeasured is never safe-to-purge, and the
        # walk simply ships the tombstones too.
        if primary.tier is not None \
                and hasattr(primary.tier, "gc_pass"):
            primary.tier.gc_pass()
        # Catch up BEFORE serving: the walk pulls everything the
        # group committed while this member was dead (and pushes
        # nothing — the store is fresh).
        # The walk only PULLS into the fresh store, so re-running it
        # after a transport fault is idempotent — and each pass has
        # less left to fetch. A proxied/chaos wire dropping one
        # connection must not fail the whole rejoin; a protocol
        # rejection (explicit error report) stays fatal.
        host, port = _split_addr(primary.addr)
        last: Optional[Exception] = None
        for attempt in range(6):
            try:
                conn = PeerConnection(
                    host, port, timeout=self.heartbeat_timeout * 4)
            except (ConnectionError, OSError) as e:
                last = e
                time.sleep(0.05 * (attempt + 1))
                continue
            try:
                sync_merkle_over_conn(crdt, conn)
                last = None
                break
            except SyncProtocolError:
                raise
            except (ConnectionError, OSError) as e:
                last = e
                time.sleep(0.05 * (attempt + 1))
            finally:
                conn.close()
        if last is not None:
            raise ConnectionError(
                f"rejoin catch-up from {primary.addr} failed after "
                f"retries: {last!r}")
        self._count_rejoin_bytes(crdt)
        with self._lock:
            router = PartitionRouter()
            # Rebind the member's previous listen address: a crashed
            # process restarts at the same host:port, so clients
            # seeded with the original fleet addresses can always
            # rediscover the group no matter how many failovers have
            # happened. Ephemeral fallback if the bind races.
            try:
                tier = ServeTier(crdt, host=self.host,
                                 port=prev_port,
                                 flush_interval=self.flush_interval,
                                 router=router, **self._tier_kwargs)
                tier.group_name = self.group
                tier.role = "follower"
                tier.start()
            except OSError:
                tier = ServeTier(crdt, host=self.host, port=0,
                                 flush_interval=self.flush_interval,
                                 router=router, **self._tier_kwargs)
                tier.group_name = self.group
                tier.role = "follower"
                tier.start()
            m.tier = tier
            m.addr = self._addr_via(f"{tier.host}:{tier.port}")
            router.bind(m.addr)
            if self.table is not None:
                router.install(self.table)
            if m.hb is not None:
                m.hb.close()
            m.hb = _HbClient(m.addr, self.heartbeat_timeout)
            m.misses = 0
            m.role = "follower"
            primary = self._primary
            if primary is not None and primary.tier is not None:
                rep = primary.tier.replicator
                if rep is not None:
                    # mark=None on the fresh follower: the first
                    # barrier ships one full pack — wasteful after a
                    # merkle walk, but immune to stamps that raced
                    # the walk; the second barrier is incremental.
                    rep.add_follower(m.name, m.addr)
            self._m_health.set(1, group=self.group, replica=m.name)
        return m
