"""Resilient gossip runtime: long-running anti-entropy over flaky links.

Port of ``crdt_tpu/gossip.py``, over this package's `net` (the same
frames as the JAX package's, so a torch node and a JAX node gossip
with each other). Not ported yet: the pod-local collective lane
(``group=``, `GossipNode.attach_group`), which needs the collective
group join (ROADMAP A9); a node given a group raises
``NotImplementedError``.

The reference's replication story assumes a cooperative, always-up
peer — its example mocks the remote with a function returning a JSON
string (example/crdt_example.dart:21-25) — and :func:`sync_over_tcp`
inherits that: one socket error aborts the round and nothing retries.
This module turns the one-shot round into a runtime that keeps
converging through drops, delays, truncations and crashes:

- **Bounded retry** with exponential backoff + FULL jitter on
  transport faults. Rounds are idempotent lattice joins, so replaying
  one is always safe; jitter spreads uncoordinated replicas retrying
  a shared peer instead of synchronizing them into a thundering herd.
- A per-peer **circuit breaker**: open after N consecutive failed
  rounds, half-open probe after a cool-down, close again on success —
  a dead peer costs one probe per reset window, not a retry storm.
- **Pooled sessions**: each peer keeps one `net.PeerConnection` — a
  keep-alive framed session with hello capability negotiation —
  instead of paying a fresh TCP connect (and a fresh zlib
  negotiation) every round. Any round error RESETS the session and
  the normal retry machinery reconnects; `stop()` says ``bye``.
- **Graceful wire-form degradation**: peers aim at the fastest wire
  form the local replica speaks (``packed`` O(k) columnar, then the
  ``dense`` kernel form, then universal JSON) and downgrade (sticky)
  one step the moment the peer rejects an op. Capability selection
  is separate and free: a session whose hello did not advertise
  ``packed`` simply isn't offered it — no rejection round-trip, no
  ``fallbacks`` count, and the peer's aim is retried on reconnect.
- **Pipelined sweeps**: `run_round` overlaps round N+1's device-side
  ``pack_since`` with round N's socket I/O (double-buffered through a
  one-worker executor), so a multi-peer sweep hides pack latency
  behind the wire instead of paying pack→send→recv→merge serially.
- **Durable watermarks** (`checkpoint.save_gossip_state`): the
  per-peer delta watermark survives a crash, so a restarted node
  resumes DELTA sync instead of re-pulling full peer state. (The
  replica contents persist separately — `checkpoint.save_json` /
  `load_json`, or a durable backend like `SqliteCrdt`.)
- **Per-peer counters** (`utils.stats.PeerSyncStats`): rounds,
  retries, fallbacks, pull kinds, bytes, breaker transitions — a
  fault-injection soak can prove its faults actually fired.

Time sources are injectable (``clock``/``sleep``/``rng``) so tests
drive the breaker and backoff deterministically; production uses the
defaults. The fault-injection counterpart lives in
`crdt_tpu_torch.testing_faults` (a TCP proxy that drops, delays, truncates,
corrupts and duplicates on a seeded schedule).
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .checkpoint import load_gossip_state, save_gossip_state
from .crdt import Crdt
from .hlc import Hlc
from .net import (PeerConnection, SyncProtocolError, SyncServer,
                  SyncTransportError, WireTally, _pack_for_peer,
                  sync_dense_over_conn, sync_merkle_over_conn,
                  sync_over_conn, sync_packed_over_conn)
from .obs.lag import health_status, lag_entry
from .obs.registry import default_registry
from .obs.trace import tracer
from .utils.concurrency import make_lock
from .utils.stats import PeerSyncStats

_GROUP_NOT_PORTED = (
    "the collective lane (a pod-local CollectiveGroup) needs the "
    "collective group join, which is not ported yet (ROADMAP A9)")


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and full jitter:
    ``sleep = uniform(0, min(max_delay, base_delay * 2**attempt))``.
    Full jitter (rather than equal or decorrelated) because gossiping
    replicas share peers — a deterministic backoff ladder would march
    every client of a briefly-down peer back in lockstep."""

    max_attempts: int = 4      # total tries per round, first included
    base_delay: float = 0.05   # seconds; the cap grows base * 2^n
    max_delay: float = 2.0

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return rng.uniform(0.0, min(self.max_delay,
                                    self.base_delay * (2 ** attempt)))


@dataclass(frozen=True)
class BreakerPolicy:
    failure_threshold: int = 5   # consecutive failed ROUNDS to open
    reset_timeout: float = 30.0  # seconds open before one probe


class CircuitBreaker:
    """CLOSED → (N consecutive round failures) → OPEN →
    (reset_timeout elapses) → HALF_OPEN → one probe round →
    success: CLOSED / failure: OPEN again.

    Failures are counted per ROUND (after the retry budget is spent),
    not per attempt — a peer that needs one retry per round is slow,
    not down, and must not trip the breaker. Transitions are counted
    into the owning peer's :class:`PeerSyncStats` and, when the
    process tracer is enabled, emitted as ``breaker`` trace events."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, policy: BreakerPolicy,
                 clock: Callable[[], float] = time.monotonic,
                 stats: Optional[PeerSyncStats] = None,
                 name: str = ""):
        self.policy = policy
        self._clock = clock
        self._stats = stats
        self.name = name           # owning peer, for trace events
        self.state = self.CLOSED
        self.failures = 0          # consecutive, resets on success
        self._opened_at = 0.0

    def _transition(self, state: str) -> None:
        self.state = state
        ring = tracer()
        if ring.enabled:
            ring.emit("breaker", peer=self.name, state=state,
                      failures=self.failures)

    def allow(self) -> bool:
        """May a round be attempted now? Flips OPEN → HALF_OPEN when
        the cool-down has elapsed (the probe is the caller's round)."""
        if self.state == self.OPEN:
            if self._clock() - self._opened_at \
                    < self.policy.reset_timeout:
                return False
            self._transition(self.HALF_OPEN)
            if self._stats is not None:
                self._stats.breaker_half_open += 1
        return True

    def record_success(self) -> None:
        self.failures = 0
        if self.state != self.CLOSED:
            self._transition(self.CLOSED)
            if self._stats is not None:
                self._stats.breaker_closed += 1

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == self.HALF_OPEN \
                or (self.state == self.CLOSED
                    and self.failures >= self.policy.failure_threshold):
            self._transition(self.OPEN)
            self._opened_at = self._clock()
            if self._stats is not None:
                self._stats.breaker_opened += 1


# Wire modes a peer can aim at, fastest first. Downgrades are sticky
# and one-way: merkle -> packed -> dense -> json. "merkle" is packed
# sync plus digest-tree anti-entropy for rounds with no usable
# watermark (docs/ANTIENTROPY.md) — a cold or long-partitioned peer
# walks divergence in O(log n) probes instead of full-scanning.
_MODES = ("merkle", "packed", "dense", "json")


class Peer:
    """One gossip neighbour: address, pooled session, current wire
    mode, delta watermark, breaker, counters. ``name`` is the durable
    identity the watermark persists under — keep it stable across
    restarts."""

    def __init__(self, name: str, host: str, port: int, *,
                 mode: str,
                 breaker: CircuitBreaker,
                 stats: PeerSyncStats,
                 watermark: Optional[Hlc] = None,
                 timeout: float = 30.0):
        if mode not in _MODES:
            raise ValueError(f"unknown wire mode {mode!r}")
        self.name = name
        self.host = host
        self.port = port
        self.mode = mode              # sticky: downgraded on rejection
        self.conn = PeerConnection(host, port, timeout=timeout)
        self.breaker = breaker
        self.stats = stats
        self.watermark = watermark
        self.last_error: Optional[Exception] = None
        self.last_attempt = mode      # wire form of the newest round

    @property
    def dense(self) -> bool:
        """Back-compat view of :attr:`mode`: any binary form counts
        as dense (the pre-packed API exposed only that split)."""
        return self.mode != "json"

    @dense.setter
    def dense(self, value: bool) -> None:
        # Mode-preserving: `dense = True` only UPGRADES a json peer to
        # the dense floor of the binary ladder — a peer already at
        # dense/packed/merkle keeps its (faster) mode, where the old
        # `mode = "dense"` collapse would silently downgrade it.
        # `dense = False` still forces json, the legacy escape hatch.
        if value:
            if self.mode == "json":
                self.mode = "dense"
        else:
            self.mode = "json"

    def __repr__(self) -> str:
        return (f"Peer({self.name!r}, {self.host}:{self.port}, "
                f"{self.mode}, "
                f"breaker={self.breaker.state}, "
                f"watermark={self.watermark})")


# Protocol codes that mean "this peer does not speak the dense wire
# form" — downgrade to JSON and retry the round immediately. Any other
# rejection (e.g. a clock guard) would fail identically on JSON, so it
# is terminal for the round. "rejected" is the default code replies
# from pre-taxonomy servers map to.
_DENSE_FALLBACK_CODES = frozenset(
    {"dense_rejected", "unknown_op", "rejected"})

# Codes that mean "this peer will not take the packed columnar form"
# even though its session advertised (or predated) the capability —
# drop one step, to dense, and rerun. A session that never advertised
# "packed" is handled earlier and cheaper: `_one_round` simply never
# offers the form (capability selection, not a rejection — no
# fallback counted, no wasted round-trip).
_PACKED_FALLBACK_CODES = frozenset(
    {"packed_rejected", "unknown_op", "rejected"})

# Codes that mean "this peer will not walk digest trees" — geometry
# mismatch, a digest surface the peer's replica lacks, or a
# pre-merkle server. Drop one step, to packed, and rerun: a full
# packed round is always a correct (just wider) substitute for an
# anti-entropy walk.
_MERKLE_FALLBACK_CODES = frozenset(
    {"merkle_rejected", "unknown_op", "rejected"})


class GossipNode:
    """A replica + its :class:`SyncServer` + a set of :class:`Peer`s,
    run as a resilient long-lived gossip participant.

    >>> node = GossipNode(crdt, state_path="/var/lib/app/gossip.json")
    >>> node.add_peer("b", "10.0.0.2", 7000)
    >>> node.start(gossip_interval=1.0)   # background anti-entropy
    ... # or drive rounds yourself:
    >>> node.sync_peer("b")               # 'ok' | 'skipped' | 'failed'
    >>> node.stop()

    Local writes from other threads must hold :attr:`lock` (the
    server's replica lock) — the same contract as `SyncServer`.
    `sync_peer`/`run_round` themselves are not re-entrant; drive them
    from one thread (the built-in loop, or your own)."""

    # crdtlint lock-discipline contract: the peer registry is touched
    # only under self._peers_lock (enforced statically by
    # crdt_tpu.analysis.host_lint).
    _CRDTLINT_GUARDED = {"_peers_lock": ("peers",)}
    # Checked by analysis/concurrency.py: peers-registry lock before
    # the server's replica lock. In the shipped tree they are only
    # ever taken SEQUENTIALLY (lag_snapshot releases one before the
    # other) — the declaration pins the permitted direction should a
    # future path nest them.
    _CRDTLINT_LOCK_ORDER = ("_peers_lock", ("server.lock",
                                            "SyncServer.lock"))

    def __init__(self, crdt: Crdt, host: str = "127.0.0.1",
                 port: int = 0, *,
                 state_path: Optional[str] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[BreakerPolicy] = None,
                 prefer_dense: Optional[bool] = None,
                 round_timeout: float = 30.0,
                 key_encoder=None, value_encoder=None,
                 key_decoder=None, value_decoder=None,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 group=None,
                 **server_kwargs):
        if group is not None:
            raise NotImplementedError(_GROUP_NOT_PORTED)
        self.crdt = crdt
        self.retry = retry or RetryPolicy()
        self.breaker_policy = breaker or BreakerPolicy()
        # Dense binary wire form only when the local replica speaks it.
        self.prefer_dense = (hasattr(crdt, "export_split_delta")
                             if prefer_dense is None else prefer_dense)
        self.round_timeout = round_timeout
        self._codecs = dict(key_encoder=key_encoder,
                            value_encoder=value_encoder,
                            key_decoder=key_decoder,
                            value_decoder=value_decoder)
        self._rng = rng or random.Random()
        self._clock = clock
        self._sleep = sleep
        self.server = SyncServer(crdt, host, port,
                                 **self._codecs, **server_kwargs)
        # Client-side wire bytes across all peers, node lifetime
        # (per-peer splits live in each PeerSyncStats). The server's
        # metrics op folds our per-peer lag table into its snapshot.
        self.wire = WireTally()
        default_registry().attach("wire", self.wire, replace=True,
                                  role="client", node=str(crdt.node_id))
        self.server.metrics_extra = self._metrics_extra
        # Flight-recorder context (obs/recorder.py): incident bundles
        # dumped by this process carry the same node/lag/routing/
        # partition sections the metrics op shows a live poller.
        # Weakly held — a test's short-lived node never pins itself.
        from .obs.recorder import default_recorder
        default_recorder().attach_source(self._metrics_extra)
        # Guards the peer REGISTRY (the dict itself): add_peer may run
        # from any thread while the gossip loop iterates. Per-peer
        # mutable state stays single-writer (the gossip thread).
        self._peers_lock = make_lock("GossipNode._peers_lock", 38)
        self.peers: Dict[str, Peer] = {}
        self._state_path = state_path
        # Crash resume: watermarks persisted by a previous incarnation
        # seed add_peer — the first round after restart is a DELTA
        # pull, not a full re-pull.
        self._saved_marks = ({} if state_path is None else
                             load_gossip_state(state_path,
                                               crdt.node_id))
        self._gossip_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Fleet canary probe (obs/probe.py): enabled explicitly via
        # enable_canary — user stores must never lose slots silently.
        self._canary = None
        # Federated routing view (routing.PartitionRouter): attached
        # via attach_router so the routing table + epoch gossip on the
        # metrics/health surfaces pre-federation clients already poll.
        self._router = None
        # Replica-group membership view (replication.ReplicaGroup's
        # ServeTier): attached via attach_replication so role/lease
        # ride the same metrics surface (docs/REPLICATION.md).
        self._replica_tier = None

    # --- topology ---

    @property
    def host(self) -> str:
        return self.server.host

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def lock(self) -> threading.Lock:
        """The replica lock (the server's): hold it around any local
        write from outside the gossip thread."""
        return self.server.lock

    def _default_mode(self, binary: bool) -> str:
        """Fastest wire form the LOCAL replica can speak. What the
        peer accepts is discovered per session (hello caps) and per
        round (sticky rejection downgrade)."""
        if not binary:
            return "json"
        if hasattr(self.crdt, "pack_since") \
                and hasattr(self.crdt, "merge_packed"):
            # "merkle" = packed plus digest-tree anti-entropy for
            # watermark-less rounds; steady-state behavior (and the
            # pipelined fast lane) is identical to "packed".
            if callable(getattr(self.crdt, "digest_tree", None)):
                return "merkle"
            return "packed"
        return "dense"

    def add_peer(self, name: str, host: str, port: int,
                 dense: Optional[bool] = None, *,
                 mode: Optional[str] = None) -> Peer:
        """Register (or re-address) a peer. A persisted watermark for
        ``name`` is resumed. ``mode`` pins the starting wire form
        ('merkle' | 'packed' | 'dense' | 'json'); the older ``dense``
        flag keeps
        meaning "binary if True, JSON if False", with binary resolving
        to the fastest form the local replica speaks."""
        if mode is None:
            mode = self._default_mode(
                self.prefer_dense if dense is None else dense)
        stats = PeerSyncStats().register(
            node=str(self.crdt.node_id), peer=name)
        peer = Peer(
            name, host, port,
            mode=mode,
            breaker=CircuitBreaker(self.breaker_policy,
                                   clock=self._clock, stats=stats,
                                   name=name),
            stats=stats,
            watermark=self._saved_marks.get(name),
            timeout=self.round_timeout)
        with self._peers_lock:
            old = self.peers.get(name)
            self.peers[name] = peer
        if old is not None:
            old.conn.reset()     # re-addressed: drop the old session
        return peer

    # --- lifecycle ---

    def start(self, gossip_interval: Optional[float] = None
              ) -> "GossipNode":
        """Serve the replica; with ``gossip_interval`` also run
        `run_round` on a background loop every that many seconds."""
        self.server.start()
        if gossip_interval is not None:
            self._stop.clear()

            def loop() -> None:
                while not self._stop.is_set():
                    self.run_round()
                    self._stop.wait(gossip_interval)

            self._gossip_thread = threading.Thread(
                target=loop, daemon=True,
                name=f"gossip-{self.crdt.node_id}")
            self._gossip_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._gossip_thread is not None:
            self._gossip_thread.join(timeout=60)
            self._gossip_thread = None
        with self._peers_lock:
            conns = [p.conn for p in self.peers.values()]
        for conn in conns:
            conn.close(self.wire)    # polite bye, best-effort
        self.server.stop()

    def __enter__(self) -> "GossipNode":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- rounds ---

    def run_round(self) -> Dict[str, str]:
        """One gossip sweep: sync every peer once, in a shuffled order
        (uncoordinated nodes must not all visit peers in registration
        order). Returns ``{peer name: outcome}``.

        Peers on the packed fast path with an already-negotiated
        healthy session run PIPELINED: peer N+1's ``pack_since``
        (device work, under the replica lock) overlaps peer N's
        socket round on a one-worker executor, so the sweep hides
        pack latency behind the wire. Everything else — first
        contact, legacy/dense/JSON peers, open or probing breakers —
        takes the plain sequential path."""
        if self._canary is not None:
            # One canary beat per sweep, BEFORE the watermark reads:
            # the beat rides this very sweep's deltas, so the fleet
            # matrix measures write->replicate->observe end to end.
            try:
                self._canary.beat()
            except Exception:
                pass   # a failed beat must never stall gossip
        with self._peers_lock:
            names = list(self.peers)
        self._rng.shuffle(names)
        with self._peers_lock:
            peers = {n: self.peers[n] for n in names
                     if n in self.peers}
        fast: List[str] = []
        results: Dict[str, str] = {}
        for name in names:
            p = peers[name]
            # A merkle peer WITH a watermark runs the same packed
            # incremental round (the digest walk is only for
            # watermark-less rounds), so it pipelines identically.
            if ((p.mode == "packed"
                 or (p.mode == "merkle" and p.watermark is not None))
                    and p.conn.connected
                    and "packed" in p.conn.caps
                    and p.breaker.state == CircuitBreaker.CLOSED):
                fast.append(name)
            else:
                results[name] = self.sync_peer(name)
        if len(fast) < 2:
            for name in fast:
                results[name] = self.sync_peer(name)
            return results
        default_registry().counter(
            "crdt_tpu_gossip_pipelined_rounds_total",
            "gossip sweeps that overlapped device pack with "
            "network I/O").inc(node=str(self.crdt.node_id))
        with ThreadPoolExecutor(max_workers=1) as ex:
            prev_name, fut = "", None
            for name in fast:
                p = peers[name]
                with self.server.lock:
                    # Drain any ingest-window backlog BEFORE reading
                    # the watermark: pack_since drains internally, but
                    # that flush advances the canonical AFTER a
                    # watermark read here — the stale watermark would
                    # re-send every flushed row next round.
                    drain = getattr(self.crdt, "drain_ingest", None)
                    if drain is not None:
                        drain()
                    watermark = self.crdt.canonical_time
                    # The fast lane requires a live negotiated session
                    # (checked above), so the caps are authoritative:
                    # the sem tag lane rides iff this peer agreed to
                    # "semantics" in its hello.
                    packed, ids = _pack_for_peer(
                        self.crdt, p.watermark,
                        "semantics" in p.conn.caps)
                # The worker is still (possibly) mid-round on the
                # previous peer — that socket wait is what the pack
                # above just overlapped. Collect it before
                # dispatching this one.
                if fut is not None:
                    results[prev_name] = fut.result()
                prev_name = name
                fut = ex.submit(self.sync_peer, name,
                                (watermark, packed, ids))
            if fut is not None:
                results[prev_name] = fut.result()
        return results

    def sync_peer(self, name: str,
                  _prepacked: Optional[Tuple] = None) -> str:
        """One resilient anti-entropy round against a peer.

        Returns ``'ok'`` (round completed, watermark advanced and
        persisted), ``'skipped'`` (breaker open — no network attempt),
        or ``'failed'`` (retry budget exhausted on transport faults,
        or the peer rejected the round; see ``peer.last_error``).
        Failures never raise — a long-running mesh must keep gossiping
        with its healthy peers."""
        ring = tracer()
        if not ring.enabled:
            return self._sync_peer(name, _prepacked)
        start = time.perf_counter()
        outcome = self._sync_peer(name, _prepacked)
        dur = time.perf_counter() - start
        with self.server.lock:
            stamp = str(self.crdt.canonical_time)
        ring.emit("gossip_round", hlc=stamp, peer=name,
                  outcome=outcome, dur_s=dur)
        default_registry().histogram(
            "crdt_tpu_gossip_round_seconds",
            "anti-entropy round wall time, retries included"
        ).observe(dur, peer=name, outcome=outcome)
        return outcome

    def _sync_peer(self, name: str,
                   _prepacked: Optional[Tuple] = None) -> str:
        with self._peers_lock:
            peer = self.peers[name]
        if not peer.breaker.allow():
            peer.stats.skipped += 1
            return "skipped"
        was_full = peer.watermark is None
        attempt = 0
        while True:
            try:
                mark = self._one_round(peer, _prepacked)
            except SyncProtocolError as e:
                # A rejected round means the pre-pack is for the
                # wrong wire form; a transport fault means the store
                # may have moved during the backoff. Either way the
                # rerun re-packs fresh.
                _prepacked = None
                tried = peer.last_attempt
                if tried == "merkle" \
                        and e.code in _MERKLE_FALLBACK_CODES:
                    # The peer advertised merkle but won't walk
                    # (geometry mismatch, digest surface missing):
                    # downgrade (sticky) one step — a full packed
                    # round is a correct, wider substitute.
                    peer.stats.fallbacks += 1
                    peer.mode = "packed"
                    continue
                if tried == "packed" \
                        and e.code in _PACKED_FALLBACK_CODES:
                    # The peer advertised packed but won't take it:
                    # downgrade (sticky) one step and rerun on the
                    # dense split form. Not a link fault — no
                    # backoff, and the retry budget is untouched.
                    peer.stats.fallbacks += 1
                    peer.mode = "dense"
                    continue
                if tried == "dense" and peer.mode != "json" \
                        and e.code in _DENSE_FALLBACK_CODES:
                    # No binary form at all: downgrade (sticky) to
                    # the universal JSON path and rerun.
                    peer.stats.fallbacks += 1
                    peer.mode = "json"
                    continue
                return self._round_failed(peer, e)
            except SyncTransportError as e:
                _prepacked = None
                attempt += 1
                if attempt >= self.retry.max_attempts:
                    return self._round_failed(peer, e)
                peer.stats.retries += 1
                peer.last_error = e
                self._sleep(self.retry.delay(attempt, self._rng))
                continue
            if was_full:
                peer.stats.full_pulls += 1
            else:
                peer.stats.delta_pulls += 1
            peer.stats.rounds_ok += 1
            peer.last_error = None
            peer.breaker.record_success()
            peer.watermark = mark
            self._persist()
            return "ok"

    def _one_round(self, peer: Peer,
                   prepacked: Optional[Tuple] = None) -> Hlc:
        """One wire round on the peer's pooled session, byte-tallied.

        The form actually attempted may sit BELOW ``peer.mode`` for
        this round: a session whose hello did not advertise the
        ``packed`` capability (including pre-hello legacy peers) is
        never offered it. That is capability selection, not a
        rejection — ``fallbacks`` stays untouched, ``peer.mode``
        keeps aiming high, and a future session that does advertise
        the cap gets the fast path back. Dense stays rejection-based
        on purpose: pre-hello servers may well speak it, and hello
        caps can't prove they don't."""
        tally = WireTally()
        try:
            conn = peer.conn
            if (conn.host, conn.port) != (peer.host, peer.port):
                # The peer was re-pointed in place (failover): drop
                # the old session and follow the address.
                conn.reset()
                conn.host, conn.port = peer.host, peer.port
            conn.ensure(tally)
            mode = peer.mode
            if mode == "merkle":
                if "merkle" not in conn.caps:
                    # Capability selection, like packed below: a
                    # session that never advertised merkle is never
                    # offered the walk — no fallback counted.
                    mode = "packed"
                elif peer.watermark is not None or prepacked is not None:
                    # Warm session: the watermark-bounded incremental
                    # round is strictly cheaper than a digest walk.
                    # Merkle is the cold/partitioned-join half; the
                    # mode keeps aiming at it so a dropped watermark
                    # (restart without state, explicit reset) walks
                    # again.
                    mode = "packed"
            if mode == "packed" and "packed" not in conn.caps:
                mode = ("dense"
                        if hasattr(self.crdt, "export_split_delta")
                        else "json")
            peer.last_attempt = mode
            if mode == "merkle":
                return sync_merkle_over_conn(
                    self.crdt, conn, lock=self.server.lock,
                    tally=tally, fused_repack=True)
            if mode == "packed":
                # Gossip relays take the fused merge+repack dispatch:
                # the pulled delta's join also seeds the next round's
                # pack under this round's watermark.
                return sync_packed_over_conn(
                    self.crdt, conn, since=peer.watermark,
                    lock=self.server.lock, tally=tally,
                    _prepacked=prepacked, fused_repack=True)
            if mode == "dense":
                return sync_dense_over_conn(
                    self.crdt, conn, since=peer.watermark,
                    lock=self.server.lock, tally=tally)
            return sync_over_conn(
                self.crdt, conn, since=peer.watermark,
                lock=self.server.lock, tally=tally, **self._codecs)
        finally:
            peer.stats.bytes_sent += tally.sent
            peer.stats.bytes_received += tally.received
            self.wire.sent += tally.sent
            self.wire.received += tally.received
            self.wire.z_raw += tally.z_raw
            self.wire.z_wire += tally.z_wire

    def _round_failed(self, peer: Peer, exc: Exception) -> str:
        peer.last_error = exc
        peer.stats.rounds_failed += 1
        peer.breaker.record_failure()
        return "failed"

    def _persist(self) -> None:
        if self._state_path is not None:
            with self._peers_lock:
                entries = list(self.peers.items())
            save_gossip_state(
                self._state_path, self.crdt.node_id,
                {name: p.watermark for name, p in entries})

    # --- observability ---

    def stats_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-peer counter snapshot plus breaker state — cheap, no
        replica access, safe to poll from a monitoring thread."""
        with self._peers_lock:
            entries = list(self.peers.items())
        return {name: {**p.stats.as_dict(),
                       "breaker": p.breaker.state,
                       "dense": p.dense,
                       "mode": p.mode,
                       "connects": p.conn.connects,
                       "watermark": None if p.watermark is None
                       else str(p.watermark)}
                for name, p in entries}

    def lag_snapshot(self, include_pending: bool = True
                     ) -> Dict[str, Dict[str, Any]]:
        """Per-peer convergence lag: how far each peer's last
        completed round is behind the local HLC head.

        ``lag_ms`` is ``local_head.millis - watermark.millis`` (the
        watermark is the local canonical time captured at the start of
        the peer's last completed round, so this measures sync
        staleness, not network latency); ``pending_records`` counts
        local records modified since that watermark — the backlog the
        next delta round would push. Never-synced peers report
        ``synced: False`` with null lag. ``include_pending=False``
        skips the replica scan (and its lock) for cheap polling."""
        with self._peers_lock:
            entries = list(self.peers.items())
        with self.server.lock:
            head = self.crdt.canonical_time
            pending = {}
            if include_pending:
                for name, p in entries:
                    pending[name] = self.crdt.count_modified_since(
                        p.watermark)
        return {name: lag_entry(head, p.watermark,
                                pending=pending.get(name),
                                breaker=p.breaker.state,
                                dense=p.dense,
                                last_error=p.last_error)
                for name, p in entries}

    def health(self, include_pending: bool = True,
               stale_after_ms: int = 60_000) -> Dict[str, Any]:
        """One-call node health: identity, HLC head, per-peer lag, and
        an overall ``status`` — ``"degraded"`` when any peer is
        never-synced, breaker-impaired, or staler than
        ``stale_after_ms``; else ``"ok"``."""
        peers = self.lag_snapshot(include_pending=include_pending)
        with self.server.lock:
            head = self.crdt.canonical_time
        out = {"node_id": str(self.crdt.node_id),
               "hlc_head": str(head),
               "head_millis": head.millis,
               "status": health_status(peers,
                                       stale_after_ms=stale_after_ms),
               "peers": peers}
        router = self._router
        if router is not None and router.epoch is not None:
            out["routing_epoch"] = router.epoch
        return out

    # --- tombstone GC (docs/STORAGE.md) ---

    def stability_hlc(self) -> Optional[Hlc]:
        """Fleet stability watermark: the min over every configured
        peer's delivery watermark (the `lag_snapshot` signal —
        the local canonical captured when that peer's last round
        completed, i.e. everything this node holds below it has been
        offered to the peer) and, when a replica-group tier is
        attached, the group's durable floor
        (`ServeTier.stability_hlc`). A tombstone below this mark has
        been delivered everywhere, so purging it can never be
        observed. ANY unmeasured input — a never-synced peer, a
        follower without a durable head — pins the watermark to
        ``None``: unmeasured ≠ safe-to-purge, the same discipline as
        the autoscaler's degraded freeze. With no peers and no tier,
        this node is the fleet, and its own head is the watermark.
        Raw watermark — `DenseCrdt.gc_purge` applies the HLC drift
        slack."""
        with self._peers_lock:
            peers = list(self.peers.values())
        marks = []
        for p in peers:
            if p.watermark is None:
                return None
            marks.append(p.watermark)
        tier = self._replica_tier
        if tier is not None:
            t = tier.stability_hlc()
            if t is None:
                return None
            marks.append(t)
        if not marks:
            with self.server.lock:
                return self.crdt.canonical_time
        return min(marks)

    def gc_pass(self, drift_slack_ms: Optional[int] = None) -> int:
        """One epoch-GC pass: fold the fleet stability watermark and
        purge tombstones it has passed (`DenseCrdt.gc_purge`, one
        dispatch — zero when the watermark hasn't advanced). Returns
        slots purged; 0 when the watermark is pinned or the replica
        has no dense GC surface (record-dict backends purge nothing).
        Call it from the sweep cadence — GC is idempotent and cheap
        when idle, so over-calling is safe."""
        from .obs.registry import default_registry
        stability = self.stability_hlc()
        if stability is None:
            default_registry().counter(
                "crdt_tpu_gc_pinned_total",
                "GC passes skipped on a pinned stability watermark"
            ).inc(surface="gossip")
            return 0
        if not hasattr(self.crdt, "gc_purge"):
            return 0
        with self.server.lock:
            return self.crdt.gc_purge(stability,
                                      drift_slack_ms=drift_slack_ms)

    def attach_group(self, group) -> None:
        """Declare this node's pod-local replica group. Not ported yet:
        the collective lane needs the collective group join (ROADMAP
        A9), so any group raises ``NotImplementedError``; ``None``
        (detach) is accepted and changes nothing."""
        if group is not None:
            raise NotImplementedError(_GROUP_NOT_PORTED)

    def attach_router(self, router) -> None:
        """Bind a `routing.PartitionRouter` so this node's metrics op
        and `health()` carry the federated routing table/epoch — the
        gossip leg of table distribution: any peer or poller that
        already fetches metrics learns the newest table without a
        federation-aware session (docs/FEDERATION.md)."""
        self._router = router

    def attach_replication(self, tier) -> None:
        """Bind a replica-group member `ServeTier` so this node's
        metrics op carries its group/role/lease state — the gossip
        leg of replica-health distribution: the fleet poller learns
        which member is primary without a group-aware session
        (docs/REPLICATION.md)."""
        self._replica_tier = tier

    def _metrics_extra(self) -> Dict[str, Any]:
        """Folded into the server's ``metrics`` op reply (called
        WITHOUT the server lock held — lag_snapshot takes it)."""
        with self.server.lock:
            node = {"node_id": str(self.crdt.node_id),
                    "hlc_head": str(self.crdt.canonical_time)}
        extra = {"node": node, "lag": self.lag_snapshot()}
        if self._canary is not None:
            extra["canary"] = self._canary.snapshot()
        router = self._router
        if router is not None and router.table is not None:
            extra["routing"] = router.table.to_json()
        tier = self._replica_tier
        if tier is not None and tier.role is not None:
            extra["replication"] = {
                "group": tier.group_name, "role": tier.role,
                "lease_ms": tier._lease_ms()}
        if tier is not None:
            # Per-partition load roll-up for the fleet table
            # (obs/fleet.py format_partitions) — present only when
            # the tier is a federated partition.
            part = tier.partition_info()
            if part is not None:
                extra["partition"] = part
        # Stability watermark (docs/STORAGE.md): gossiped so peers and
        # the fleet poller see each node's GC posture — the watermark
        # it would purge at (or the pin), and the armed floor.
        stability = self.stability_hlc()
        gc: Dict[str, Any] = {
            "stability_hlc": (None if stability is None
                              else str(stability)),
            "pinned": stability is None}
        floor = getattr(self.crdt, "gc_floor", None)
        if floor:
            gc["gc_floor"] = int(floor)
        extra["stability"] = gc
        return extra

    # --- fleet canary (obs/probe.py) ---

    def enable_canary(self, origin: int, n_origins: int,
                      base_slot: Optional[int] = None):
        """Join the fleet's canary protocol: reserve ``n_origins``
        slots (the top of the store unless ``base_slot`` is given),
        beat slot ``base_slot + origin`` each gossip sweep, and expose
        last-seen beats per origin in the ``canary`` section of the
        ``metrics`` op — the fleet poller's lag-matrix feed
        (docs/OBSERVABILITY.md). Returns the probe."""
        from .obs.probe import CanaryProbe
        self._canary = CanaryProbe(self.crdt, origin, n_origins,
                                   base_slot=base_slot,
                                   lock=self.server.lock)
        return self._canary
