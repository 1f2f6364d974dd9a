"""Async serving tier: multiplex thousands of client sessions onto
the ingest combiner and the packed read path (docs/SERVING.md).

Port of ``crdt_tpu/serve.py``: the same tier, frames, error codes and
registry series over this package's `DenseCrdt`. The tier takes the
replica it is given and never picks a device: a card replica commits
each flush tick through the K2 ingest-scatter kernel and merges a
``push_dense`` frame through K1s, both under the store lock on the
default stream, so a digest walk on the cold lane sees every tick's
scatter without a synchronize.

`SyncServer` (net.py) is a REPLICATION endpoint: a handful of pooled
gossip peers, one handler thread per connection, every request a full
replica-lock round trip. A serving workload is the opposite shape —
10k mostly-idle client sessions each issuing small point writes and
reads — and a thread per session or a scatter per write would sink
it. :class:`ServeTier` multiplexes every session onto ONE asyncio
event loop and funnels all writes through the replica's shared
`DenseCrdt.ingest()` combiner window:

- **Writes** (the serve-only ``put``/``delete`` ops) never touch the
  replica from the event loop. Each session appends to a loop-local
  queue; a flusher task ticks every ``flush_interval`` seconds and
  commits the whole backlog as ONE ``put_batch`` + combiner flush on
  the replica executor — one batched HLC stamp and one commit
  scatter per tick, however many clients wrote. Acks resolve when
  the tick's commit returns, so p99 write-ack latency is bounded by
  (tick interval + one flush), not by client count.
- **Reads** ride the existing fast paths: ``delta_packed`` answers
  from the replica's clock-keyed pack cache (a quiet store serves
  every session's pull from one pack) and the arena's memoryviews are
  handed to the transport as a vectored ``writelines`` — zero copies
  in this module. Point ``get`` reads answer from the combiner's
  read-your-writes overlay.
- **Cold joins** (the ``digest`` Merkle-walk op) are routed to a
  bounded single-worker "slow lane" executor: a digest-tree build is
  the most expensive lock hold in the tier, so at most
  ``cold_lane_depth`` walks may be queued — the rest are shed with
  the retryable ``busy`` code and counted, and warm sessions never
  wait behind a herd of cold peers.

The tier speaks the exact `SyncServer` frame protocol — hello
negotiation, `FrameCodec` tagged framing, packed/dense/merkle ops,
error codes — so existing `PeerConnection` clients (and pre-hello
legacy peers, who simply never send hello) interoperate unchanged;
the wire-compat tests (tests/test_torch_serve.py, against the JAX
package's tier) prove both directions bit-compatible.

Backpressure is explicit and measured (`MetricsRegistry`):
``crdt_tpu_serve_sessions`` / ``_queue_depth`` gauges,
``_flush_seconds`` / ``_ack_seconds`` histograms,
``_shed_total{lane=admission|cold}``, and an admission watermark —
sessions past ``max_sessions`` are refused at accept with the same
pre-hello ``busy`` frame `SyncServer` uses, so clients back off
instead of downgrading.

Blocking discipline: nothing in a coroutine may block the loop — no
sync frame helpers, no ``time.sleep``, no raw sockets. The JAX package's
``async-blocking-call`` lint rule holds its copy of this module to it.
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np

from .utils.concurrency import make_lock
from .hlc import Hlc
from .net import (BINOP_DELETE, BINOP_GET, BINOP_PUT, BINOP_ST_BUSY,
                  BINOP_ST_MOVED, BINOP_ST_OK, BINOP_ST_OK_NULL,
                  BINOP_ST_REJECTED, MAX_FRAME_BYTES, FrameCodec,
                  WireTally, _flat_views, _pack_for_peer, _pack_split,
                  _recv_span, _unpack_split, decode_binop_request,
                  encode_binop_reply)

# First body byte of a binary op frame (docs/WIRE.md): a negotiated
# session dispatches on it — JSON ops start with '{' (0x7b), so the
# two dialects share one read loop with no ambiguity.
_BINOP_REQ_TAG = b"\xb1"
_BINOP_OP_NAMES = {BINOP_PUT: "put", BINOP_DELETE: "delete",
                   BINOP_GET: "get"}


# --- async framing (the length-prefixed wire of net.py, loop-side) ---

async def read_bytes_frame_async(reader: asyncio.StreamReader,
                                 codec: Optional[FrameCodec] = None,
                                 tally: Optional[WireTally] = None
                                 ) -> Optional[bytes]:
    """One RAW frame from a stream reader; None on EOF/hangup —
    exactly `recv_bytes_frame`'s contract, minus the blocking."""
    try:
        head = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        return None
    (n,) = struct.unpack(">I", head)
    if n > MAX_FRAME_BYTES:
        raise ValueError(f"peer announced a {n}-byte frame (cap "
                         f"{MAX_FRAME_BYTES}); corrupt stream?")
    try:
        body = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        return None
    if tally is not None:
        tally.received += 4 + n
    if codec is not None:
        body = codec.decode(body)
    return body


async def read_frame_async(reader: asyncio.StreamReader,
                           codec: Optional[FrameCodec] = None,
                           tally: Optional[WireTally] = None
                           ) -> Optional[Any]:
    body = await read_bytes_frame_async(reader, codec, tally)
    return None if body is None else json.loads(body)


def frame_pieces(bufs, codec: Optional[FrameCodec] = None,
                 tally: Optional[WireTally] = None) -> list:
    """Header + body pieces for one frame, ready for a vectored
    ``writer.writelines`` — the async twin of `send_bytes_frame`,
    sharing its codec/tally/size-cap semantics. Pieces pass through
    as memoryviews (a packed delta's arena views reach the transport
    with zero copies in our code)."""
    if codec is not None:
        bufs = codec.encode(bufs, tally)
    views = _flat_views(bufs)
    total = sum(v.nbytes for v in views)
    if total > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {total} bytes exceeds "
                         f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})")
    if tally is not None:
        tally.sent += 4 + total
    # Empty pieces (an empty pack's lanes) are left out: the same bytes
    # on the wire, and CPython 3.12's selector transport, given one by
    # ``writelines``, keeps write polling with nothing buffered, so a
    # later ``close()`` never reaches ``connection_lost`` and the
    # session's ``wait_closed`` (and the tier's stop) never returns.
    return [struct.pack(">I", total)] + [v for v in views if v.nbytes]


async def write_frame_async(writer: asyncio.StreamWriter, bufs,
                            codec: Optional[FrameCodec] = None,
                            tally: Optional[WireTally] = None) -> None:
    writer.writelines(frame_pieces(bufs, codec, tally))
    await writer.drain()


async def write_json_async(writer: asyncio.StreamWriter, obj: Any,
                           codec: Optional[FrameCodec] = None,
                           tally: Optional[WireTally] = None) -> None:
    await write_frame_async(writer, [json.dumps(obj).encode()],
                            codec, tally)


# A watcher whose transport buffer exceeds this is shed at fan-out
# time: watch delivery is at-least-once over idempotent lattice rows,
# so a shed subscriber resubscribes and catches up via the watermark —
# unbounded buffering for a stalled reader is the one outcome the tier
# must never choose.
_WATCH_BUFFER_CAP = 1 << 22


class _OwnerProxy:
    """One pooled upstream connection to an owning tier, forwarding
    keyspace ops on behalf of pre-federation sessions (the `moved`
    fallback negotiated away by the missing hello cap). Speaks the
    pre-hello untagged framing — the upstream tier treats it as one
    more legacy session — and serializes in-flight requests under an
    asyncio lock, so one connection serves every proxied op this tier
    sends that owner. Loop-confined, like the sessions it serves."""

    def __init__(self, addr: str, timeout: float):
        host, _, port = addr.rpartition(":")
        self.host, self.port = host, int(port)
        self._timeout = timeout
        self._lock = asyncio.Lock()
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def request(self, msg: dict) -> Any:
        async with self._lock:
            last: Optional[BaseException] = None
            for attempt in range(2):
                try:
                    if self._writer is None:
                        self._reader, self._writer = \
                            await asyncio.wait_for(
                                asyncio.open_connection(
                                    self.host, self.port),
                                timeout=self._timeout)
                    await write_json_async(self._writer, msg)
                    reply = await asyncio.wait_for(
                        read_frame_async(self._reader),
                        timeout=self._timeout)
                    if reply is None:
                        raise ConnectionError(
                            "upstream closed mid-request")
                    return reply
                except (ConnectionError, OSError, ValueError,
                        asyncio.TimeoutError) as e:
                    # A dead pooled connection retries ONCE on a fresh
                    # one; forwarded writes are idempotent lattice
                    # writes, so the replay is safe.
                    last = e
                    await self.close()
            raise last if last is not None else ConnectionError(
                "proxy request failed")

    async def close(self) -> None:
        w, self._writer = self._writer, None
        self._reader = None
        if w is not None:
            try:
                w.close()
                await w.wait_closed()
            except (ConnectionError, OSError):
                pass


def _resolve_ack(fut: "asyncio.Future", outcome: Any) -> None:
    """Resolve one write-ack future ON ITS OWNING LOOP — the callback
    the committer hands to `call_soon_threadsafe` for writes enqueued
    by another accept loop. Resolved via set_result, never
    set_exception, so a session torn down mid-ack leaves no
    unretrieved exception behind."""
    if not fut.done():
        fut.set_result(outcome)


class _MpscStripe:
    """One mutex lane of the MPSC write queue. The stripe lock is a
    LEAF by construction: it wraps exactly a list append or a list
    swap, never a replica touch, a frame write, or another lock — so
    an accept loop's enqueue can never wait behind device work."""

    # Checked by analysis/concurrency.py: rank 46 sits above every
    # control-plane lock and is never held while acquiring anything.
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    __slots__ = ("_lock", "items")

    def __init__(self) -> None:
        self._lock = make_lock("MpscStripe._lock", 46)
        self.items: list = []

    def push(self, entry) -> None:
        with self._lock:
            self.items.append(entry)

    def swap(self) -> list:
        with self._lock:
            out, self.items = self.items, []
        return out


class MpscQueue:
    """Multi-producer single-consumer staging queue for the write
    path: every accept loop enqueues through `push` (the MPSC gate the
    crdtlint ``combiner-enqueue-unsafe`` rule holds combiner-owning
    classes to) and ONLY the committer loop drains. Enqueues stripe by
    producer thread id, so loops contend on disjoint mutexes; `drain`
    swaps each stripe's list under its own lock, one at a time — two
    stripe locks are never held together. Per-producer FIFO order is
    preserved (one thread always lands on one stripe); cross-producer
    order is whatever the tick observes, exactly as with concurrent
    appends to a single list."""

    __slots__ = ("_stripes", "_mask")

    def __init__(self, stripes: int = 8) -> None:
        n = 1
        while n < stripes:
            n *= 2
        self._mask = n - 1
        self._stripes = tuple(_MpscStripe() for _ in range(n))

    def push(self, entry) -> None:
        self._stripes[threading.get_ident() & self._mask].push(entry)

    def drain(self) -> list:
        out: list = []
        for stripe in self._stripes:
            if stripe.items:
                out.extend(stripe.swap())
        return out

    def __len__(self) -> int:
        # Torn-free under the GIL: a load signal (queue-depth gauge,
        # autoscaler pressure), not an invariant.
        return sum(len(s.items) for s in self._stripes)


class _LoopCtx:
    """Per-accept-loop state for one `ServeTier`. Everything here is
    confined to its OWN event loop thread — sessions, writers, watch
    index, proxy pool — so N loops share nothing hot; cross-loop
    traffic is exactly two seams: the MPSC write queue in, and
    `call_soon_threadsafe` ack/fan-out hops out. ``index`` 0 is the
    committer: it owns the ingest window, the flusher task and the
    tier's public port."""

    __slots__ = ("index", "loop", "stop_event", "started", "error",
                 "thread", "sessions", "writers", "watch",
                 "watch_codec", "watch_mark", "proxies", "fanout_busy")

    def __init__(self, index: int) -> None:
        from .watch import WatchIndex
        self.index = index
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.stop_event: Optional[asyncio.Event] = None
        self.started = threading.Event()
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None
        self.sessions = 0
        self.writers: set = set()
        self.watch = WatchIndex()
        self.watch_codec: dict = {}
        self.watch_mark: Optional[Hlc] = None
        self.proxies: dict = {}
        self.fanout_busy = False


class ServeTier:
    """Serve one replica to thousands of concurrent client sessions.

    Runs its own asyncio event loop on a dedicated daemon thread
    (``start``/``stop``, or use as a context manager), so synchronous
    callers — tests, `PeerConnection` clients, the embedding app —
    need no loop of their own. The replica's `ingest()` window is
    held open for the tier's whole lifetime; ALL replica access from
    the tier goes through :attr:`lock` on executor threads, never on
    the event loop. An application that also touches the replica from
    other threads must share this lock (pass its own via ``lock=``).

    Serve-only ops, in the same framed JSON protocol::

        {"op": "put",    "slot": s, "value": v} -> {"ok": true}
        {"op": "delete", "slot": s}             -> {"ok": true}
        {"op": "get",    "slot": s}             -> {"ok": true, "value": v|null}

    Write acks resolve after the batch containing the write has
    committed — read-your-writes for the writer, one flush per tick
    for the tier. A malformed write is answered with code
    ``write_rejected`` and the session STAYS OPEN (long-lived client
    sessions should not die for one bad request; protocol-level
    violations still hang up, like `SyncServer`).
    """

    # crdtlint lock-discipline contract, same as SyncServer: every
    # replica access holds the replica lock.
    _CRDTLINT_GUARDED = {"lock": ("crdt",)}
    # Checked by analysis/concurrency.py: the store lock is a LEAF —
    # it guards device dispatches by design and no other lock is ever
    # taken inside it. Control-plane classes that take it while
    # holding their own lock declare that order on their side
    # (FederatedTier, Replicator, ReplicaGroup, GossipNode).
    _CRDTLINT_LOCK_ORDER = ("lock",)

    def __init__(self, crdt, host: str = "127.0.0.1", port: int = 0,
                 max_sessions: int = 12000,
                 flush_interval: float = 0.002,
                 auto_flush_rows: int = 1 << 15,
                 cold_lane_depth: int = 8,
                 idle_timeout: Optional[float] = 300.0,
                 io_timeout: float = 30.0,
                 key_encoder=None, value_encoder=None,
                 key_decoder=None, value_decoder=None,
                 lock: Optional[threading.RLock] = None,
                 router=None, loops: int = 1):
        self.crdt = crdt
        # Multi-loop serving (docs/SERVING.md): `loops` accept loops
        # share ONE listening port via SO_REUSEPORT, each with its own
        # event loop thread and loop-confined session state; writes
        # from every loop funnel through the MPSC queue into loop 0's
        # flusher, so the one-stamp/one-scatter-per-tick invariant is
        # unchanged however many loops accept. Platforms without
        # SO_REUSEPORT fall back to one loop, COUNTED on the
        # crdt_tpu_serve_loops gauge — never a silent downscale.
        self.loops = max(1, int(loops))
        self.loops_effective: Optional[int] = None
        self.lock = lock if lock is not None \
            else make_lock("ServeTier.lock", 40, rlock=True)
        # Federation: an attached `PartitionRouter` (routing.py) makes
        # this tier one partition of a federated keyspace — keyspace
        # ops are admitted through router.check() before they may
        # enqueue (the crdtlint router-epoch-bypass contract), foreign
        # slots answer `moved` (or proxy for pre-federation sessions),
        # and the `federation` hello cap is advertised.
        self.router = router
        # Elastic repartitioning breadcrumb: the last split/merge this
        # partition took part in, stamped by the federation's scale
        # engine and surfaced on the metrics wire for the fleet table
        # (obs/fleet.py `format_partitions`).
        self.last_scale: Optional[dict] = None
        # Replication (docs/REPLICATION.md): a primary carries a
        # `Replicator` (replication.py) — the flush tick's write-concern
        # barrier — while followers carry None and learn their role
        # from the group monitor. The crdtlint `ack-before-replicate`
        # rule holds the flush tick to "barrier before any ack".
        self.replicator = None
        self.role: Optional[str] = None
        self.group_name: Optional[str] = None
        self._lease: Optional[Tuple[str, float, int]] = None
        self.killed = False
        self.host = host
        self.port: Optional[int] = None
        self._want_port = port
        self.max_sessions = max_sessions
        self.flush_interval = flush_interval
        self._auto_flush_rows = auto_flush_rows
        self.cold_lane_depth = cold_lane_depth
        self.idle_timeout = idle_timeout
        self._io_timeout = io_timeout
        self._kenc, self._venc = key_encoder, value_encoder
        self._kdec, self._vdec = key_decoder, value_decoder
        self._node = str(crdt.node_id)
        self._n_slots = int(getattr(crdt, "n_slots", 0) or 0)

        from .obs.registry import default_registry
        reg = default_registry()
        self.tally = WireTally()
        reg.attach("wire", self.tally, replace=True, role="serve",
                   node=self._node)
        self._m_sessions = reg.gauge(
            "crdt_tpu_serve_sessions",
            "live multiplexed client sessions")
        self._m_depth = reg.gauge(
            "crdt_tpu_serve_queue_depth",
            "writes queued for the next combiner tick")
        self._m_shed = reg.counter(
            "crdt_tpu_serve_shed_total",
            "requests shed for backpressure (admission watermark or "
            "cold-join lane bound)")
        self._m_ops = reg.counter(
            "crdt_tpu_serve_ops_total",
            "serve-tier ops by kind (client ops carry lane=json|bin)")
        self._m_loops = reg.gauge(
            "crdt_tpu_serve_loops",
            "accept loops sharing this tier's port (SO_REUSEPORT "
            "multi-loop serving; 1 = single loop, incl. the "
            "no-SO_REUSEPORT fallback)")
        self._m_flush = reg.histogram(
            "crdt_tpu_serve_flush_seconds",
            "combiner flush wall time under the serving tier, by "
            "trigger")
        self._m_ack = reg.histogram(
            "crdt_tpu_serve_ack_seconds",
            "write enqueue-to-ack latency (queue wait + tick commit)")
        # Sketch twins of the ack/phase histograms: same observations,
        # γ-indexed buckets, ~1% relative-error quantiles instead of
        # bucket ceilings. The fleet poller merges these into the
        # fleet-true p99 evaluate_slo and the autoscaler gate on —
        # the 14.6 ms envelope is not a power of two
        # (docs/OBSERVABILITY.md).
        self._m_ack_sketch = reg.sketch(
            "crdt_tpu_serve_ack_seconds_sketch",
            "write enqueue-to-ack latency, relative-error quantile "
            "sketch")
        # Per-lane twin of the ack sketch: the json|bin split lives on
        # its own instrument so the unlabeled series above keeps its
        # exact label key — evaluate_slo and the bench quantile reads
        # match label sets exactly, and a new label would orphan them.
        self._m_ack_lane_sketch = reg.sketch(
            "crdt_tpu_serve_ack_lane_seconds_sketch",
            "write ack latency by client lane (json per-op vs bin "
            "batched frame), relative-error quantile sketch")
        self._m_ack_phase = reg.histogram(
            "crdt_tpu_serve_ack_phase_seconds",
            "write-ack latency decomposed by phase: queue_wait (enqueue "
            "to tick pickup), stamp (HLC send_batch), scatter (device "
            "commit dispatch), ack_write (residual tick work + ack "
            "fan-out)")
        self._m_ack_phase_sketch = reg.sketch(
            "crdt_tpu_serve_ack_phase_seconds_sketch",
            "write-ack phase latency, relative-error quantile sketch")
        self._m_moved = reg.counter(
            "crdt_tpu_serve_moved_total",
            "keyspace ops redirected with the moved reply (federated "
            "routing)")
        self._m_proxied = reg.counter(
            "crdt_tpu_serve_proxied_total",
            "keyspace ops forwarded to the owning tier for "
            "pre-federation sessions")
        self._m_watchers = reg.gauge(
            "crdt_tpu_serve_watchers",
            "live watch subscriptions on the serve loop")
        self._m_fanout = reg.counter(
            "crdt_tpu_serve_watch_fanout_total",
            "watch event frames fanned out at flush ticks")

        # The pending write queue: multi-producer (every accept loop
        # pushes), single-consumer (loop 0's flusher drains). Session
        # state, watch indexes and proxy pools live per-loop in
        # `_LoopCtx`; the counters below are plain ints bumped from
        # any loop — load signals with GIL-granular (not transactional)
        # accuracy, exact whenever one loop serves (every test).
        self._q = MpscQueue()
        self.shed_count = 0
        self.dropped_sessions = 0
        self.idle_closed_sessions = 0
        self.watch_shed_sessions = 0
        self._cold_inflight = 0

        # One replica executor serializes every warm-path replica
        # touch; the cold lane gets its own single worker so a digest
        # walk never queues AHEAD of the flusher tick.
        self._replica_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-replica")
        self._cold_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-cold")

        self._ctxs: List[_LoopCtx] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._ingest_cm = None
        self._wc = None

    # --- lifecycle ---

    @property
    def _thread(self) -> Optional[threading.Thread]:
        # Liveness probe kept under the pre-multi-loop name (the
        # rehome/stop guards read it): the committer loop's thread.
        return self._ctxs[0].thread if self._ctxs else None

    def _effective_loops(self) -> int:
        """Feature-detect SO_REUSEPORT at bind time: the constant must
        exist AND the kernel must accept it (WSL/macOS quirks), else
        the tier serves on one loop — counted on the loop gauge, never
        a silent downscale."""
        want = self.loops
        if want <= 1:
            return 1
        if not hasattr(socket, "SO_REUSEPORT"):
            return 1
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        probe.settimeout(1.0)   # never does I/O; bound for hygiene
        try:
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        except OSError:
            return 1
        finally:
            probe.close()
        return want

    def start(self) -> "ServeTier":
        eff = self._effective_loops()
        self._ctxs = [_LoopCtx(i) for i in range(eff)]
        self.loops_effective = eff
        self._m_loops.set(eff, node=self._node)
        ctx0 = self._ctxs[0]
        ctx0.thread = threading.Thread(
            target=self._run, args=(ctx0,), daemon=True,
            name="serve-tier-loop")
        ctx0.thread.start()
        ctx0.started.wait(timeout=60)
        if ctx0.error is not None:
            err, ctx0.error = ctx0.error, None
            ctx0.thread.join(timeout=5)
            self._ctxs = []
            raise err
        if self.port is None:
            self._ctxs = []
            raise RuntimeError("serving tier failed to start in time")
        # Secondary accept loops bind the CONCRETE port loop 0 got
        # (which may have been ephemeral), so they start second.
        for ctx in self._ctxs[1:]:
            ctx.thread = threading.Thread(
                target=self._run, args=(ctx,), daemon=True,
                name=f"serve-tier-loop-{ctx.index}")
            ctx.thread.start()
        failed: Optional[BaseException] = None
        for ctx in self._ctxs[1:]:
            ctx.started.wait(timeout=60)
            if ctx.error is not None and failed is None:
                failed = ctx.error
        if failed is not None:
            self.stop()
            raise failed
        return self

    def _signal_stop(self) -> None:
        for ctx in self._ctxs:
            loop, ev = ctx.loop, ctx.stop_event
            if loop is not None and ev is not None:
                try:
                    loop.call_soon_threadsafe(ev.set)
                except RuntimeError:
                    pass

    def stop(self) -> None:
        if not self._ctxs or self._ctxs[0].thread is None:
            return
        # Every loop tears down concurrently: the committer's final
        # flush tick resolves cross-loop acks while the other loops
        # are still draining their sessions, so no ack is stranded.
        self._signal_stop()
        for ctx in reversed(self._ctxs):
            thread, ctx.thread = ctx.thread, None
            if thread is None:
                continue
            thread.join(timeout=60)
            if thread.is_alive():
                raise RuntimeError(
                    "serving tier loop failed to stop; the replica "
                    "may still be accessed — do not reuse it")
        self._replica_pool.shutdown(wait=True)
        self._cold_pool.shutdown(wait=True)

    def kill(self) -> None:
        """SIGKILL-equivalent teardown for fault injection: no final
        flush tick, no ack resolution, transports aborted (RST, close
        without FIN) — clients observe exactly what a crashed process
        shows them. Queued-but-unacked writes die with the tier; acked
        writes survive only to the extent the write-concern barrier
        already replicated them, which is the property the failover
        tests measure. The replica object is left as the crash image —
        a restart must build a FRESH store and catch up via the merkle
        walk, never reuse this one."""
        if not self._ctxs or self._ctxs[0].thread is None:
            return
        self.killed = True
        self._signal_stop()
        for ctx in self._ctxs:
            thread, ctx.thread = ctx.thread, None
            if thread is not None:
                thread.join(timeout=60)
        self._replica_pool.shutdown(wait=True)
        self._cold_pool.shutdown(wait=True)

    def __enter__(self) -> "ServeTier":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self, ctx: _LoopCtx) -> None:
        try:
            asyncio.run(self._main(ctx))
        except BaseException as e:   # pragma: no cover - belt+braces
            if not ctx.started.is_set():
                ctx.error = e
                ctx.started.set()

    def _reuseport_socket(self, port: int) -> socket.socket:
        # Sync helper on purpose: bind/setsockopt never block, and
        # keeping them out of the coroutine keeps the async-blocking
        # lint focused on calls that actually can.
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            # Non-blocking from birth (settimeout(0) IS non-blocking
            # mode): asyncio owns this socket the moment start_server
            # adopts it.
            sock.settimeout(0.0)
            sock.bind((self.host, port))
        except BaseException:
            sock.close()
            raise
        return sock

    async def _listen(self, ctx: _LoopCtx) -> asyncio.AbstractServer:
        def handler(r, w):
            return self._session(ctx, r, w)
        if self.loops_effective == 1:
            return await asyncio.start_server(
                handler, self.host, self._want_port, backlog=2048)
        # Multi-loop: every loop binds its OWN SO_REUSEPORT socket so
        # the kernel load-balances accepts across them. Loop 0 binds
        # the requested port; the others bind whatever concrete port
        # loop 0 was actually given.
        port = self._want_port if ctx.index == 0 else self.port
        sock = self._reuseport_socket(port)
        try:
            return await asyncio.start_server(
                handler, sock=sock, backlog=2048)
        except BaseException:
            sock.close()
            raise

    async def _main(self, ctx: _LoopCtx) -> None:
        ctx.loop = asyncio.get_running_loop()
        ctx.stop_event = asyncio.Event()
        committer = ctx.index == 0
        if committer:
            # Committer aliases: the flusher, rehome_watchers and the
            # stop path address loop 0 through the pre-multi-loop
            # names.
            self._loop = ctx.loop
            self._stop_event = ctx.stop_event
            try:
                self._open_ingest()
            except BaseException as e:
                ctx.error = e
                ctx.started.set()
                return
        try:
            server = await self._listen(ctx)
        except BaseException as e:
            ctx.error = e
            if committer:
                self._close_ingest()
            ctx.started.set()
            return
        flusher = None
        if committer:
            self.port = server.sockets[0].getsockname()[1]
            flusher = asyncio.ensure_future(self._flusher())
        ctx.started.set()
        try:
            await ctx.stop_event.wait()
        finally:
            # Stop accepting now; wait for the listener only once every
            # session transport below is cut. Since Python 3.12.1
            # `Server.wait_closed` also waits for the server's open
            # connections, so awaiting it first would park the loop on
            # any idle client session (up to ``idle_timeout``) and the
            # caller's join would time out.
            server.close()
            if flusher is not None:
                flusher.cancel()
                try:
                    await flusher
                except asyncio.CancelledError:
                    pass
            if self.killed:
                # Crash fidelity (`kill()`): drop the queue unacked,
                # RST every transport, leave the ingest window where
                # the crash left it. Pending sessions are cancelled
                # when asyncio.run tears the loop down.
                for w in list(ctx.writers):
                    transport = w.transport
                    if transport is not None:
                        try:
                            transport.abort()
                        except Exception:
                            pass
            else:
                # Resolve every queued ack (the committer's final tick
                # also resolves writes the OTHER loops enqueued — they
                # are still draining their sessions because stop()
                # joins the committer last), give the sessions one loop
                # breath to write their replies, then cut the
                # transports.
                if committer:
                    await self._flush_tick()
                await asyncio.sleep(0)
                for proxy in ctx.proxies.values():
                    await proxy.close()
                ctx.proxies.clear()
                for w in list(ctx.writers):
                    try:
                        w.close()
                    except Exception:
                        pass
                deadline = ctx.loop.time() + 5.0
                while ctx.sessions and ctx.loop.time() < deadline:
                    await asyncio.sleep(0.01)
                if committer:
                    self._close_ingest()
            await server.wait_closed()

    def _open_ingest(self) -> None:
        with self.lock:
            self._ingest_cm = self.crdt.ingest(
                auto_flush_rows=self._auto_flush_rows)
            self._wc = self._ingest_cm.__enter__()
            self._wc.on_flush = self._note_flush

    def _close_ingest(self) -> None:
        with self.lock:
            wc, self._wc = self._wc, None
            if wc is not None:
                wc.on_flush = None
            cm, self._ingest_cm = self._ingest_cm, None
            if cm is not None:
                cm.__exit__(None, None, None)

    def _note_flush(self, trigger: str, rows: int,
                    seconds: float) -> None:
        # WriteCombiner flush listener — fires on EVERY trigger (tick,
        # auto, any barrier a pack/merge drains through), so the
        # histogram sees the tier's true flush distribution.
        self._m_flush.observe(seconds, node=self._node,
                              trigger=trigger)

    # --- write path: queue -> one combiner tick ---

    async def _flusher(self) -> None:
        while not self._stop_event.is_set():
            await asyncio.sleep(self.flush_interval)
            try:
                await self._flush_tick()
            except Exception:
                # The flusher is the tier's heartbeat: if it ever died,
                # every queued ack would hang forever. _flush_tick
                # already converts batch failures into per-write
                # rejections, so anything reaching here is unexpected —
                # drop the tick and keep ticking.
                continue

    async def _flush_tick(self) -> None:
        entries = self._q.drain()
        self._m_depth.set(0, node=self._node)
        if not entries:
            # Quiet ticks still fan out: merges (push_packed from a
            # migration, gossip) advance the store without touching
            # this tier's write queue, and watchers must see them.
            await self._fanout_all()
            return
        # Two entry shapes share the queue — JSON per-op writes
        # ("j", slot, value, tomb, fut, t0, loop) and binop batch
        # frames ("b", slots, vals, tombs, fut, t0, decode_s, loop).
        # Both carry fut at [4], t0 at [5] and the OWNING loop last.
        jq = [e for e in entries if e[0] == "j"]
        bq = [e for e in entries if e[0] == "b"]
        nj = len(jq)
        writes = nj + sum(len(e[1]) for e in bq)
        tick_t = time.perf_counter()
        phases: dict = {}
        # Write concern (docs/REPLICATION.md): a primary may resolve
        # this tick's acks only after its `Replicator` confirms the
        # delta on `ack_replicas` followers, and only while it still
        # holds a fresh lease — an expired lease means the group
        # monitor may already have promoted someone else, so acking
        # here could lose the write to the client's view. Both
        # failures map to the retryable `busy` code (the local commit
        # stands — it is an idempotent lattice join that will
        # converge via gossip — but the CLIENT is told to retry, so
        # its ack, when it finally lands, is backed by the group).
        rep = self.replicator
        try:
            slots = np.fromiter((e[1] for e in jq), np.int64, count=nj)
            vals = np.fromiter((e[2] for e in jq), np.int64, count=nj)
            tombs = np.fromiter((e[3] for e in jq), bool, count=nj)
            batches = [(e[1], e[2], e[3]) for e in bq]
            phases = await self._loop.run_in_executor(
                self._replica_pool, self._commit, slots, vals, tombs,
                batches)
            if self._lease_expired():
                outcome: Any = ("busy", "primary lease expired "
                                        "(fenced; retry)")
                # Flight recorder (obs/recorder.py): a tripped lease
                # fence is an incident edge — a write arrived after
                # this primary's authority lapsed. Capture while the
                # trace ring still holds the window; the recorder
                # throttles the tight-retry storm itself.
                try:
                    from .obs.recorder import default_recorder
                    default_recorder().trigger(
                        "lease_fence",
                        {"node": self._node, "writes_fenced": writes})
                except Exception:
                    pass
            elif rep is not None:
                replicated, detail = await self._loop.run_in_executor(
                    self._replica_pool, rep.barrier)
                outcome = True if replicated else ("busy", detail)
            else:
                outcome = True
        except Exception as e:
            # The whole tick failed (e.g. a value-width guard): every
            # writer in it gets the rejection. Resolved via
            # set_result, not set_exception, so a session torn down
            # mid-ack never leaves an unretrieved exception behind.
            outcome = f"{type(e).__name__}: {e}"
        now = time.perf_counter()
        # Ack attribution: every write in the
        # tick shares the combiner's stamp/scatter legs; queue_wait is
        # per write; ack_write is the residual tick time the phase
        # timers don't cover (queue drain, executor hop, ack fan-out).
        # Per-write observation keeps sum(phase sums) comparable to
        # the crdt_tpu_serve_ack_seconds sum. Failed ticks committed
        # nothing, so nothing is attributed. A binop batch is ONE
        # client-visible ack (one reply frame), so it is one
        # observation — with its decode+admission cost attributed to
        # the binary-lane-only `decode` phase.
        stamp = float(phases.get("stamp", 0.0)) if phases else 0.0
        scatter = float(phases.get("scatter", 0.0)) if phases else 0.0
        ack_write = max(0.0, (now - tick_t) - stamp - scatter)
        this_loop = self._loop
        for e in entries:
            fut, t0, floop = e[4], e[5], e[-1]
            lane = "json" if e[0] == "j" else "bin"
            dec = e[6] if e[0] == "b" else 0.0
            if floop is this_loop:
                if not fut.done():
                    fut.set_result(outcome)
            else:
                # The write was enqueued by another accept loop: its
                # future must resolve THERE (futures are not
                # thread-safe). A loop mid-teardown just drops the ack
                # — its sessions are gone anyway.
                try:
                    floop.call_soon_threadsafe(_resolve_ack, fut,
                                               outcome)
                except RuntimeError:
                    pass
            self._m_ack.observe(now - t0, node=self._node)
            self._m_ack_sketch.observe(now - t0, node=self._node)
            self._m_ack_lane_sketch.observe(now - t0, lane=lane,
                                            node=self._node)
            if outcome is True:
                if dec > 0.0:
                    self._m_ack_phase.observe(
                        dec, phase="decode", node=self._node)
                    self._m_ack_phase_sketch.observe(
                        dec, phase="decode", node=self._node)
                queue_wait = max(0.0, tick_t - t0 - dec)
                self._m_ack_phase.observe(
                    queue_wait, phase="queue_wait", node=self._node)
                self._m_ack_phase.observe(stamp, phase="stamp",
                                          node=self._node)
                self._m_ack_phase.observe(scatter, phase="scatter",
                                          node=self._node)
                self._m_ack_phase.observe(ack_write, phase="ack_write",
                                          node=self._node)
                self._m_ack_phase_sketch.observe(
                    queue_wait, phase="queue_wait", node=self._node)
                self._m_ack_phase_sketch.observe(
                    stamp, phase="stamp", node=self._node)
                self._m_ack_phase_sketch.observe(
                    scatter, phase="scatter", node=self._node)
                self._m_ack_phase_sketch.observe(
                    ack_write, phase="ack_write", node=self._node)
        await self._fanout_all()

    def _commit(self, slots: np.ndarray, vals: np.ndarray,
                tombs: np.ndarray, batches: list) -> dict:
        with self.lock:
            wc = self._wc
            if len(slots):
                self.crdt.put_batch(slots, vals, tombs)
            # Each binop frame stages as its own stamp group — its
            # wire views land straight in the combiner's columnar
            # staging — but the tick still ends in ONE send_batch and
            # ONE ingest_scatter (the dispatch-ledger invariant).
            for bs, bv, bt in batches:
                self.crdt.put_batch(bs, bv, bt)
            if wc is not None:
                wc.flush("tick")
                return dict(wc.last_phase_seconds)
        return {}

    # --- watch fan-out: one pack per flush tick, pushed to every
    # watcher of a touched slot (docs/FEDERATION.md) ---

    async def _fanout_all(self) -> None:
        """Fan out the tick to every loop's watchers. The committer's
        own watchers are pushed inline (awaited — the single-loop path
        keeps its exact pre-multi-loop ordering); other loops get a
        `call_soon_threadsafe` nudge that packs-and-pushes on THEIR
        thread, because watch writers are loop-confined. A loop whose
        previous fan-out is still in flight is skipped this tick —
        watch delivery is at-least-once off a watermark, so the next
        tick covers the gap."""
        await self._fanout_tick(self._ctxs[0])
        for ctx in self._ctxs[1:]:
            if ctx.watch.empty or ctx.fanout_busy:
                continue
            if ctx.loop is None or ctx.stop_event is None \
                    or ctx.stop_event.is_set():
                continue
            try:
                ctx.loop.call_soon_threadsafe(self._spawn_fanout, ctx)
            except RuntimeError:
                pass

    def _spawn_fanout(self, ctx: _LoopCtx) -> None:
        # Runs ON ctx's loop. The busy flag is flipped here (not at
        # the committer) so it is only ever touched from ctx's thread
        # once set, and from the committer only as a skip hint.
        if ctx.fanout_busy:
            return
        ctx.fanout_busy = True
        task = asyncio.ensure_future(self._fanout_tick(ctx))

        def _done(t: "asyncio.Future") -> None:
            ctx.fanout_busy = False
            t.exception()   # a pack failure must never go unretrieved

        task.add_done_callback(_done)

    async def _fanout_tick(self, ctx: _LoopCtx) -> None:
        if ctx.watch.empty:
            return
        try:
            out = await ctx.loop.run_in_executor(
                self._replica_pool, self._watch_pack, ctx)
        except Exception:
            return   # a pack failure must never kill the flusher
        if out is None:
            return
        meta_msg, bufs, touched = out
        targets = ctx.watch.touched(touched)
        if not targets:
            return
        # Frame pieces are built ONCE per codec flavor (raw vs zlib)
        # and the SAME memoryviews are vectored to every watcher —
        # the zero-copy fan-out: 10k watchers cost 10k writelines,
        # not 10k serializations.
        flavors: dict = {}
        meta_raw = [json.dumps(meta_msg).encode()]
        for w in list(targets):
            codec = ctx.watch_codec.get(w)
            key = codec is not None and codec.compress
            cached = flavors.get(key)
            if cached is None:
                head = frame_pieces(meta_raw, codec)
                body = frame_pieces(bufs, codec)
                nbytes = sum(getattr(p, "nbytes", len(p))
                             for p in head + body)
                cached = flavors[key] = (head, body, nbytes)
            head, body, nbytes = cached
            transport = w.transport
            if (transport is None or transport.is_closing()
                    or transport.get_write_buffer_size()
                    > _WATCH_BUFFER_CAP):
                # Backpressure: a watcher that cannot keep up is shed
                # (its session close deregisters it) rather than
                # letting its transport buffer grow without bound.
                self.watch_shed_sessions += 1
                self._m_shed.inc(lane="watch", node=self._node)
                self._drop_watcher(ctx, w)
                try:
                    w.close()
                except Exception:
                    pass
                continue
            try:
                w.writelines(head)
                w.writelines(body)
            except (ConnectionError, OSError):
                self._drop_watcher(ctx, w)
                continue
            self.tally.sent += nbytes
            self._m_fanout.inc(node=self._node)

    def _drop_watcher(self, ctx: _LoopCtx, writer) -> None:
        ctx.watch.remove(writer)
        ctx.watch_codec.pop(writer, None)
        self._m_watchers.set(sum(len(c.watch) for c in self._ctxs),
                             node=self._node)

    def rearm_watch(self, mark) -> None:
        """Rewind the watch pack watermark to ``mark`` (keeping the
        MORE inclusive of the two — None means "from store birth" and
        is never overwritten). The merge engine calls this on the
        RECIPIENT at the routing flip: rows streamed over from the
        donor keep their ORIGIN HLC stamps, which an already-advanced
        recipient watermark would silently skip, so the first fan-out
        tick after re-homed watchers subscribe must pack from the flip
        watermark. Rewinding re-delivers rows between the two marks to
        existing watchers — watch delivery is at-least-once and the
        rows are idempotent lattice states, so re-applying is safe."""
        with self.lock:
            for ctx in self._ctxs:
                cur = ctx.watch_mark
                if cur is not None and (mark is None or mark < cur):
                    ctx.watch_mark = mark

    def rehome_watchers(self, owner: str, epoch: int,
                        since: Optional[str] = None,
                        timeout: float = 5.0) -> int:
        """Push a typed ``moved`` frame to every live watch session
        and deregister it — the watch half of a partition retire. Runs
        on the serve loop (watch state is loop-confined) and blocks
        the calling control thread until the frames are flushed, so
        the tier stop that follows cannot RST them off the wire.
        Returns the number of sessions re-homed."""
        if self._loop is None or self._thread is None or self.killed:
            return 0
        msg = {"op": "moved", "ok": False, "code": "moved",
               "owner": owner, "epoch": int(epoch),
               "error": (f"partition merged into {owner} at "
                         f"routing epoch {epoch}")}
        if since is not None:
            # Resume mark: the merge's flip watermark. The client
            # resubscribes with it so the recipient re-packs from
            # there regardless of interleaved fan-out ticks.
            msg["since"] = str(since)
        raw = [json.dumps(msg).encode()]

        async def _push(ctx: _LoopCtx) -> int:
            moved = 0
            for w in list(ctx.watch.watchers()):
                codec = ctx.watch_codec.get(w)
                try:
                    w.writelines(frame_pieces(raw, codec))
                    await w.drain()
                except (ConnectionError, OSError):
                    pass
                self._drop_watcher(ctx, w)
                moved += 1
            return moved

        total = 0
        for ctx in self._ctxs:
            if ctx.loop is None or ctx.thread is None:
                continue
            fut = asyncio.run_coroutine_threadsafe(_push(ctx),
                                                   ctx.loop)
            try:
                total += fut.result(timeout)
            except (TimeoutError, RuntimeError, OSError):
                fut.cancel()
        return total

    def partition_info(self) -> Optional[dict]:
        """Per-partition load/ownership roll-up for the fleet poller
        (obs/fleet.py `format_partitions`): address, routing epoch,
        owned-slot count, cumulative committed rows, instantaneous
        queue depth, shed count, and the last scale action this
        partition took part in. None when the tier is not a federated
        partition (no bound router)."""
        router = self.router
        if router is None or router.addr is None:
            return None
        table = router.table
        wc = self._wc
        info = {
            "addr": router.addr,
            "epoch": None if table is None else table.epoch,
            "slots": (None if table is None
                      else table.slots_of(router.addr)),
            "rows_committed": (0 if wc is None
                               else int(wc.rows_committed)),
            # len() on the loop-confined queue is a torn-free read
            # under the GIL — a load signal, not an invariant.
            "queue_depth": len(self._q),
            "shed": int(self.shed_count),
        }
        if self.last_scale is not None:
            info["last_scale"] = dict(self.last_scale)
        return info

    def _watch_arm(self, ctx: _LoopCtx,
                   since: Optional[str] = None) -> str:
        """Register-time replica touch: the head stamp the reply
        reports, also seeding the pack watermark so event streams
        start at subscription time, not store birth. A ``since``
        stamp (the resume mark a merge's ``moved`` frame hands a
        re-homed subscription) rewinds the watermark at REGISTRATION
        time, so rows committed between the routing flip and this
        resubscribe are re-packed at the next tick no matter how many
        fan-out ticks other watchers drove in between."""
        from .hlc import Hlc
        mark = None
        if since is not None:
            try:
                mark = Hlc.parse(str(since))
            except (ValueError, TypeError, IndexError):
                mark = None   # malformed resume mark: plain subscribe
        with self.lock:
            head = self.crdt.canonical_time
            # A None watermark on a store with no watcher ever armed
            # carries no from-birth promise to anyone, so a resume
            # mark may seed it directly — a re-homed subscription
            # must start at the flip watermark, not at head, or the
            # commits it is resuming across are silently skipped.
            if mark is not None and (ctx.watch_mark is None
                                     or mark < ctx.watch_mark):
                ctx.watch_mark = mark
            if ctx.watch_mark is None:
                ctx.watch_mark = head
        return str(head)

    def _watch_pack(self, ctx: _LoopCtx):
        """One tick's event pack (executor thread, lock held): every
        row modified at-or-after the watermark, tags included. The
        inclusive bound means a row exactly AT the watermark can ship
        twice across ticks — watch delivery is at-least-once, and the
        rows are idempotent lattice states, so re-applying is safe."""
        from .ops.packing import pack_rows
        with self.lock:
            head = self.crdt.canonical_time
            if ctx.watch_mark is not None \
                    and head == ctx.watch_mark:
                return None
            packed, ids = _pack_for_peer(self.crdt, ctx.watch_mark,
                                         True)
            ctx.watch_mark = head
        if not packed.k:
            return None
        meta, bufs = pack_rows(packed)
        touched = [int(s) for s in packed.slots]
        return ({"op": "event", "meta": meta,
                 "node_ids": list(ids), "k": packed.k},
                bufs, touched)

    # --- replica helpers (executor threads, lock held) ---

    def _caps(self) -> set:
        caps = {"zlib"}
        with self.lock:
            packed = (hasattr(self.crdt, "pack_since")
                      and hasattr(self.crdt, "merge_packed"))
            semantics = packed and hasattr(self.crdt, "set_semantics")
            merkle = packed and callable(
                getattr(self.crdt, "digest_tree", None))
        if packed:
            caps.add("packed")
        if semantics:
            caps.add("semantics")
        if merkle:
            caps.add("merkle")
        # Trace-context piggybacking is pure frame metadata — no
        # replica surface needed, so it is advertised unconditionally
        # (same as SyncServer).
        caps.add("trace")
        # Quantile-sketch metrics payloads: sessions that agree get a
        # "sketches" section on the metrics op; everyone else gets
        # the pre-sketch reply byte-identically (same as SyncServer).
        caps.add("sketch")
        # Binary client op lane (docs/WIRE.md): serve-tier-only — the
        # peer wire (`SyncServer`) keeps its packed-lane dialect and
        # its hello bytes unchanged. Advertised unconditionally: the
        # lane rides the write combiner the tier always owns. A client
        # that never offers it gets today's JSON dialect byte-for-byte.
        caps.add("binop")
        if self.router is not None:
            # Advertised only by routed tiers: a client that agrees
            # gets `moved` redirects; one that never asks is a
            # pre-federation session and gets the proxy fallback.
            caps.add("federation")
        if packed:
            # heartbeat/lease/replicate — the group-membership wire
            # surface (docs/REPLICATION.md); replicate needs the
            # packed merge path.
            caps.add("replication")
        return caps

    def _read_slot(self, slot: int):
        with self.lock:
            return self.crdt.get(slot)

    def _merge_json(self, payload: str, tctx=None) -> None:
        with _recv_span("push", tctx):
            with self.lock:
                self.crdt.merge_json(payload, key_decoder=self._kdec,
                                     value_decoder=self._vdec)

    def _export_json(self, since: Optional[str]) -> str:
        with self.lock:
            return self.crdt.to_json(
                modified_since=None if since is None
                else Hlc.parse(since),
                key_encoder=self._kenc, value_encoder=self._venc)

    def _merge_dense(self, meta, blob: bytes, ids, tctx=None) -> None:
        scs = _unpack_split(meta, blob)
        if not isinstance(ids, list) or not ids:
            raise ValueError("push_dense without node_ids")
        with _recv_span("push_dense", tctx):
            with self.lock:
                self.crdt.merge_split(scs, ids)

    def _export_dense(self, since: Optional[str]):
        with self.lock:
            scs, ids = self.crdt.export_split_delta(
                None if since is None else Hlc.parse(since))
        meta, bufs = _pack_split(scs)
        return {"meta": meta, "node_ids": list(ids)}, bufs

    def _merge_packed(self, meta, blob: bytes, ids, tctx=None) -> None:
        from .ops.packing import unpack_rows
        packed = unpack_rows(meta, blob)
        if not isinstance(ids, list):
            raise ValueError("push_packed without node_ids")
        if packed.k:
            with _recv_span("push_packed", tctx):
                with self.lock:
                    self.crdt.merge_packed(packed, ids)

    def _export_packed(self, since: Optional[str], ranges,
                       sem_ok: bool):
        from .ops.packing import pack_rows
        if ranges is not None:
            ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
        with self.lock:
            packed, ids = _pack_for_peer(
                self.crdt, None if since is None else Hlc.parse(since),
                sem_ok, ranges=ranges)
        meta, bufs = pack_rows(packed)
        return ({"meta": meta, "node_ids": list(ids),
                 "k": packed.k}, bufs)

    def _digest_values(self, groups):
        with self.lock:
            tree = self.crdt.digest_tree()
            per_group = [tree.values(lvl, ix) for lvl, ix in groups]
        flat = [v for vals in per_group for v in vals]
        buf = np.asarray(flat, np.uint64).astype(">u8").tobytes()
        return ({"op": "digest_resp", "ok": True, "k": len(flat),
                 "ks": [len(v) for v in per_group],
                 "n_slots": tree.n_slots,
                 "leaf_width": tree.leaf_width,
                 "depth": tree.depth}, buf)

    def _metrics_snapshot(self) -> dict:
        from .obs import metrics_snapshot
        snap = metrics_snapshot()
        if "node" not in snap:
            with self.lock:
                snap["node"] = {
                    "node_id": str(self.crdt.node_id),
                    "hlc_head": str(self.crdt.canonical_time)}
        if self.role is not None:
            # Group membership state for the fleet poller: role +
            # lease freshness is what `evaluate_slo`'s primary-
            # liveness check reads (obs/fleet.py).
            with self.lock:
                head = str(self.crdt.canonical_time)
            rep = self.replicator
            info = {"group": self.group_name, "role": self.role,
                    "hlc_head": head, "lease_ms": self._lease_ms()}
            if rep is not None:
                info["followers"] = rep.status()
            snap["replication"] = info
        part = self.partition_info()
        if part is not None:
            snap["partition"] = part
        return snap

    # --- tombstone GC (docs/STORAGE.md) ---

    def stability_hlc(self) -> "Optional[Hlc]":
        """Partition stability watermark: the min over every
        follower's durable HLC (the heartbeat/replicate-ack field) and
        this tier's own head — what this partition has PROVEN
        replicated. An unreplicated tier is its partition's sole
        owner, so its own head is the watermark. Any follower without
        a measured durable head pins the watermark to ``None``
        (unmeasured ≠ safe-to-purge — the autoscaler's degraded-freeze
        discipline), as does follower role: a follower cannot prove
        group-wide delivery, its primary drives GC. Raw watermark —
        `DenseCrdt.gc_purge` applies the drift slack."""
        if self.role == "follower":
            return None
        rep = self.replicator
        with self.lock:
            head = self.crdt.canonical_time
        if rep is None:
            return head
        marks = [head]
        for st in rep.status().values():
            d = st.get("durable")
            if d is None:
                return None
            try:
                marks.append(Hlc.parse(str(d)))
            except (ValueError, TypeError):
                return None
        return min(marks)

    def gc_pass(self, drift_slack_ms: Optional[int] = None) -> int:
        """One epoch-GC pass under the tier lock: purge tombstones the
        partition stability watermark has passed. Returns slots purged
        (0 when the watermark is pinned, the replica has no `gc_purge`
        surface, or the watermark hasn't advanced — the latter without
        a dispatch)."""
        from .obs.registry import default_registry
        stability = self.stability_hlc()
        if stability is None:
            default_registry().counter(
                "crdt_tpu_gc_pinned_total",
                "GC passes skipped on a pinned stability watermark"
            ).inc(surface="serve")
            return 0
        with self.lock:
            if not hasattr(self.crdt, "gc_purge"):
                return 0
            return self.crdt.gc_purge(stability,
                                      drift_slack_ms=drift_slack_ms)

    # --- replication surface (docs/REPLICATION.md) ---

    def _lease_ms(self) -> Optional[float]:
        lease = self._lease
        if lease is None:
            return None
        return max(0.0, (lease[1] - time.monotonic()) * 1000.0)

    def _lease_expired(self) -> bool:
        lease = self._lease
        return lease is not None and time.monotonic() > lease[1]

    def _grant_lease(self, lease: dict) -> Optional[str]:
        """Adopt a lease grant iff it is not older than the one held —
        a stale monitor (e.g. orphaned by a group restart) must not
        extend a fence a newer monitor already owns. Returns the
        refusal reason, or None when adopted."""
        try:
            holder = str(lease["holder"])
            ttl_ms = float(lease["ttl_ms"])
            epoch = int(lease.get("epoch", 0))
        except (KeyError, TypeError, ValueError):
            return "malformed lease grant"
        cur = self._lease
        if cur is not None and epoch < cur[2]:
            return f"stale lease epoch {epoch} < {cur[2]}"
        self._lease = (holder, time.monotonic() + ttl_ms / 1000.0,
                       epoch)
        return None

    def _hb_state(self, want_root: bool) -> dict:
        """Heartbeat replica touch (executor thread, lock held): the
        durable HLC head every beat, plus the digest root only when
        asked — elections need the tie-break, per-beat probes must not
        pay a tree build."""
        with self.lock:
            out = {"hlc": str(self.crdt.canonical_time)}
            if want_root and callable(
                    getattr(self.crdt, "digest_tree", None)):
                out["root"] = int(self.crdt.digest_tree().root)
        return out

    def _replicate_in(self, meta, blob: bytes, ids,
                      tctx=None) -> str:
        """Follower half of the write-concern barrier: merge the
        primary's tick pack, then report the durable head from the
        SAME lock hold — the watermark the primary's ack rests on."""
        with self.lock:
            self._merge_packed(meta, blob, ids, tctx)
            return str(self.crdt.canonical_time)

    # --- the session coroutine ---

    async def _session(self, ctx: _LoopCtx,
                       reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        seated = sum(c.sessions for c in self._ctxs)
        if seated >= self.max_sessions or ctx.stop_event.is_set():
            # Admission watermark: refuse with the same pre-hello
            # untagged busy frame SyncServer's accept path uses, so
            # every client generation reads it and backs off
            # (retryable, never the legacy-downgrade signal). The
            # seated count sums per-loop tallies — GIL-granular, so a
            # racing burst across loops can overshoot by at most one
            # accept per loop, which the watermark tolerates.
            self.shed_count += 1
            self._m_shed.inc(lane="admission", node=self._node)
            try:
                await write_json_async(
                    writer,
                    {"ok": False, "code": "busy",
                     "error": "serving tier at capacity "
                              f"(max_sessions={self.max_sessions})"},
                    None, self.tally)
            except (ConnectionError, OSError):
                pass
            await self._hangup(writer)
            return
        ctx.sessions += 1
        self._m_sessions.set(seated + 1, node=self._node)
        ctx.writers.add(writer)
        try:
            await self._session_loop(ctx, reader, writer)
        except (ConnectionError, OSError, ValueError,
                json.JSONDecodeError, asyncio.TimeoutError,
                asyncio.IncompleteReadError):
            # An ADMITTED session torn down by error (vs a clean
            # bye/EOF) counts as dropped — the bench's "zero dropped
            # below the watermark" criterion reads this. Idle expiry
            # is absorbed as a clean close in _read_op_raw, so the
            # only TimeoutError reaching here is a mid-op io_timeout
            # (a genuinely stalled client).
            self.dropped_sessions += 1
        finally:
            self._drop_watcher(ctx, writer)
            ctx.writers.discard(writer)
            ctx.sessions -= 1
            self._m_sessions.set(sum(c.sessions for c in self._ctxs),
                                 node=self._node)
            await self._hangup(writer)

    @staticmethod
    async def _hangup(writer: asyncio.StreamWriter) -> None:
        try:
            writer.close()
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass

    async def _read_op_raw(self, reader: asyncio.StreamReader,
                           codec: Optional[FrameCodec],
                           idle_exempt: bool = False):
        # RAW body bytes, not parsed JSON: the session loop dispatches
        # on the first byte (0xB1 binop vs '{' JSON) before paying for
        # a parse.
        if self.idle_timeout is None or idle_exempt:
            return await read_bytes_frame_async(reader, codec,
                                                self.tally)
        try:
            return await asyncio.wait_for(
                read_bytes_frame_async(reader, codec, self.tally),
                timeout=self.idle_timeout)
        except asyncio.TimeoutError:
            # Idle expiry is ROUTINE housekeeping, not a failure: close
            # like an EOF so the session never lands in
            # dropped_sessions (the bench's zero-dropped criterion).
            self.idle_closed_sessions += 1
            return None

    async def _read_blob(self, reader: asyncio.StreamReader,
                         codec: Optional[FrameCodec]):
        # Binary continuation frames are bounded by io_timeout, like
        # SyncServer: an announced-but-never-sent frame must not hold
        # the session forever.
        return await asyncio.wait_for(
            read_bytes_frame_async(reader, codec, self.tally),
            timeout=self._io_timeout)

    async def _route_verdict(self, ctx: _LoopCtx, msg: dict,
                             slot: int, fed_ok: bool):
        """Admission through the router for one keyspace op: None to
        enqueue locally, else the reply dict to send instead. The
        `moved`/proxy taxonomy lives in routing.PartitionRouter.check;
        this adds the forwarded-op guard (a proxied op landing on a
        non-owner means the table flipped mid-flight — shed retryably
        rather than bounce between tiers) and the proxy hop itself."""
        router = self.router
        if router is None:
            return None
        from .routing import PROXY
        verdict = router.check(slot, msg.get("epoch"), fed_ok)
        if verdict is None:
            return None
        if msg.get("fwd"):
            return {"ok": False, "code": "busy",
                    "error": "routing flux: forwarded op landed on a "
                             "non-owner (retry after table refresh)"}
        if verdict is PROXY:
            owner = router.table.owner_of(slot)
            proxy = ctx.proxies.get(owner)
            if proxy is None:
                proxy = ctx.proxies[owner] = _OwnerProxy(
                    owner, self._io_timeout)
            fwd = dict(msg)
            fwd["fwd"] = int(fwd.get("fwd", 0) or 0) + 1
            fwd.pop("trace", None)
            try:
                reply = await proxy.request(fwd)
            except (ConnectionError, OSError, ValueError,
                    asyncio.TimeoutError):
                return {"ok": False, "code": "busy",
                        "error": f"owner {owner} unreachable (proxy)"}
            self._m_proxied.inc(op=str(msg.get("op")),
                                node=self._node)
            return reply if isinstance(reply, dict) else {
                "ok": False, "code": "busy",
                "error": "owner returned garbage (proxy)"}
        self._m_moved.inc(op=str(msg.get("op")), node=self._node)
        return verdict

    def _read_slots(self, slots: np.ndarray) -> list:
        # Batched point reads for a binop frame: one lock hold, one
        # executor hop for every `get` in the frame.
        with self.lock:
            return [self.crdt.get(int(s)) for s in slots]

    async def _binop_frame(self, ctx: _LoopCtx, body: bytes,
                           writer: asyncio.StreamWriter,
                           codec: Optional[FrameCodec],
                           fed_ok: bool) -> bool:
        """One binary op batch -> one status reply frame. Per-op error
        isolation: a rejected slot, a refused route or a proxied miss
        fails ITS status byte; its batchmates commit normally. Writes
        stage before gets execute, so read-your-writes extends into
        the frame — a get observes every write earlier in (or
        anywhere in) its own batch. Returns False when the reply could
        not be written (transport gone) so the session ends."""
        t0 = time.perf_counter()
        opcodes, slots, values, epoch = decode_binop_request(body)
        n = len(opcodes)
        status = np.zeros(n, np.uint8)
        details: list = []
        values_out: Optional[np.ndarray] = None
        for code, name in _BINOP_OP_NAMES.items():
            count = int((opcodes == code).sum())
            if count:
                self._m_ops.inc(count, op=name, lane="bin",
                                node=self._node)
        ok = slots < self._n_slots
        if not ok.all():
            for i in np.nonzero(~ok)[0]:
                status[i] = BINOP_ST_REJECTED
                details.append({"i": int(i), "code": "write_rejected",
                                "error": "bad slot"})
        router = self.router
        if router is not None:
            admit = router.check_batch(slots, epoch, fed_ok)
            if admit is not None:
                # Refused ops re-enter the JSON verdict path one by
                # one: `moved` redirects, proxy hops and the fwd-flux
                # guard keep ONE taxonomy (and one set of counters)
                # across both dialects. Refusals are the cold path —
                # a current-epoch client on the owner never lands
                # here.
                for i in np.nonzero(~admit & ok)[0]:
                    i = int(i)
                    code = int(opcodes[i])
                    msg = {"op": _BINOP_OP_NAMES[code],
                           "slot": int(slots[i])}
                    if code != BINOP_GET:
                        msg["value"] = int(values[i])
                    if epoch is not None:
                        msg["epoch"] = epoch
                    reply = await self._route_verdict(
                        ctx, msg, int(slots[i]), fed_ok)
                    st, detail = _binop_status_of(reply)
                    status[i] = st
                    if detail is not None:
                        detail["i"] = i
                        details.append(detail)
                    if st == BINOP_ST_OK and code == BINOP_GET:
                        if values_out is None:
                            values_out = np.zeros(n, np.int64)
                        value = reply.get("value")
                        if value is None:
                            status[i] = BINOP_ST_OK_NULL
                        else:
                            values_out[i] = int(value)
                ok &= admit
        wmask = ok & (opcodes != BINOP_GET)
        nw = int(wmask.sum())
        if nw:
            # decode+admission cost rides the entry so the flush tick
            # can attribute it as the binary lane's `decode` phase.
            decode_s = time.perf_counter() - t0
            if nw == n:
                # The hot shape (a pure write batch): the wire views
                # go STRAIGHT into combiner staging — zero copies in
                # this module, proven by the pack-copy counters.
                wslots, wvals = slots, values
                wtombs = opcodes == BINOP_DELETE
            else:
                wslots = slots[wmask]
                wvals = values[wmask]
                wtombs = opcodes[wmask] == BINOP_DELETE
            fut = ctx.loop.create_future()
            self._q.push(("b", wslots, wvals, wtombs, fut, t0,
                          decode_s, ctx.loop))
            self._m_depth.set(len(self._q), node=self._node)
            outcome = await fut
            if outcome is not True:
                widx = np.nonzero(wmask)[0]
                if isinstance(outcome, tuple):
                    status[widx] = BINOP_ST_BUSY
                    details.append({"code": outcome[0],
                                    "error": outcome[1]})
                else:
                    status[widx] = BINOP_ST_REJECTED
                    details.append({"code": "write_rejected",
                                    "error": str(outcome)})
        gmask = ok & (opcodes == BINOP_GET)
        if gmask.any():
            gidx = np.nonzero(gmask)[0]
            read = await ctx.loop.run_in_executor(
                self._replica_pool, self._read_slots, slots[gidx])
            if values_out is None:
                values_out = np.zeros(n, np.int64)
            for i, value in zip(gidx, read):
                if value is None:
                    status[i] = BINOP_ST_OK_NULL
                else:
                    values_out[i] = int(value)
        try:
            writer.writelines(frame_pieces(
                encode_binop_reply(status, values_out, details),
                codec, self.tally))
            await writer.drain()
        except (ConnectionError, OSError):
            return False
        return True

    async def _session_loop(self, ctx: _LoopCtx,
                            reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        loop = ctx.loop
        codec: Optional[FrameCodec] = None
        binop_ok = False
        sem_ok = False
        trace_ok = False
        fed_ok = False
        sketch_ok = False
        watching = False
        while not ctx.stop_event.is_set():
            raw = await self._read_op_raw(reader, codec,
                                          idle_exempt=watching)
            if raw is None:
                return
            if binop_ok and raw[:1] == _BINOP_REQ_TAG:
                # Binary op lane: a whole batch of keyspace ops in one
                # frame, one reply frame back. A malformed binop frame
                # raises ValueError out of this loop — protocol
                # violation, hang up — while a bad op INSIDE a
                # well-formed frame only fails that op's status slot.
                if not await self._binop_frame(ctx, raw, writer,
                                               codec, fed_ok):
                    return
                continue
            msg = json.loads(raw)
            if not isinstance(msg, dict) or msg.get("op") == "bye":
                return
            op = msg.get("op")
            if op in ("put", "delete", "get"):
                # Client keyspace ops carry the lane label (the binop
                # path counts the same ops with lane="bin"); control
                # ops stay label-compatible with every dashboard that
                # predates the lane split.
                self._m_ops.inc(op=str(op), lane="json",
                                node=self._node)
            else:
                self._m_ops.inc(op=str(op), node=self._node)
            tctx = msg.get("trace") if trace_ok else None
            if not isinstance(tctx, dict):
                tctx = None

            if op in ("put", "delete"):
                slot = msg.get("slot")
                value = msg.get("value", 0)
                # bools are JSON true/false, not slot/value ints; the
                # int64 bound keeps an oversized Python int from ever
                # reaching the flush tick's np.int64 conversion (which
                # would reject the WHOLE batch, not just this write).
                if not _slot_ok(slot, self._n_slots) \
                        or not _value_ok(value):
                    await write_json_async(
                        writer, {"ok": False, "code": "write_rejected",
                                 "error": "bad slot/value"},
                        codec, self.tally)
                    continue
                routed = await self._route_verdict(ctx, msg, slot,
                                                   fed_ok)
                if routed is not None:
                    await write_json_async(writer, routed, codec,
                                           self.tally)
                    continue
                fut = loop.create_future()
                self._q.push(("j", slot, value, op == "delete", fut,
                              time.perf_counter(), loop))
                self._m_depth.set(len(self._q), node=self._node)
                outcome = await fut
                if outcome is True:
                    await write_json_async(writer, {"ok": True},
                                           codec, self.tally)
                elif isinstance(outcome, tuple):
                    # Retryable tick outcome (write-concern barrier
                    # miss, lease fence): the client backs off and
                    # retries, same contract as admission `busy`.
                    await write_json_async(
                        writer, {"ok": False, "code": outcome[0],
                                 "error": outcome[1]},
                        codec, self.tally)
                else:
                    await write_json_async(
                        writer, {"ok": False, "code": "write_rejected",
                                 "error": str(outcome)},
                        codec, self.tally)

            elif op == "get":
                slot = msg.get("slot")
                if not _slot_ok(slot, self._n_slots):
                    await write_json_async(
                        writer, {"ok": False, "code": "write_rejected",
                                 "error": "bad slot"},
                        codec, self.tally)
                    continue
                routed = await self._route_verdict(ctx, msg, slot,
                                                   fed_ok)
                if routed is not None:
                    await write_json_async(writer, routed, codec,
                                           self.tally)
                    continue
                value = await loop.run_in_executor(
                    self._replica_pool, self._read_slot, slot)
                await write_json_async(writer,
                                       {"ok": True, "value": value},
                                       codec, self.tally)

            elif op == "hello":
                want = msg.get("caps")
                want = set(want) if isinstance(want, list) else set()
                agreed = sorted(want & self._caps())
                reply = {"ok": True, "proto": 1, "caps": agreed}
                router = self.router
                if router is not None and router.epoch is not None:
                    # The epoch rides hello so long-lived sessions
                    # notice a flip on reconnect without a route op.
                    reply["routing_epoch"] = router.epoch
                await write_json_async(writer, reply, codec,
                                       self.tally)
                codec = FrameCodec(compress="zlib" in agreed)
                binop_ok = "binop" in agreed
                sem_ok = "semantics" in agreed
                trace_ok = "trace" in agreed
                fed_ok = "federation" in agreed
                sketch_ok = "sketch" in agreed

            elif op == "route":
                router = self.router
                if router is None or router.table is None:
                    await write_json_async(
                        writer, {"ok": False, "code": "unrouted",
                                 "error": "no routing table installed"},
                        codec, self.tally)
                else:
                    await write_json_async(
                        writer, {"ok": True,
                                 "routing": router.table.to_json()},
                        codec, self.tally)

            elif op == "watch":
                slots = msg.get("slots")
                if slots is not None and (
                        not isinstance(slots, list) or not slots
                        or not all(_slot_ok(s, self._n_slots)
                                   for s in slots)):
                    await write_json_async(
                        writer, {"ok": False, "code": "write_rejected",
                                 "error": "bad watch slots"},
                        codec, self.tally)
                    continue
                head = await loop.run_in_executor(
                    self._replica_pool, self._watch_arm, ctx,
                    msg.get("since"))
                ctx.watch.add(writer, slots)
                ctx.watch_codec[writer] = codec
                self._m_watchers.set(
                    sum(len(c.watch) for c in self._ctxs),
                    node=self._node)
                # A subscribed session is exempt from idle expiry —
                # a silent watcher is the normal state, and the
                # fan-out path owns its liveness (buffer-cap shed).
                watching = True
                await write_json_async(
                    writer, {"ok": True, "mode": "watch",
                             "since": head},
                    codec, self.tally)

            elif op == "push":
                try:
                    await loop.run_in_executor(
                        self._replica_pool, self._merge_json,
                        msg["payload"], tctx)
                except Exception as e:
                    await write_json_async(
                        writer, {"ok": False, "code": "merge_rejected",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                await write_json_async(writer, {"ok": True}, codec,
                                       self.tally)

            elif op == "delta":
                try:
                    payload = await loop.run_in_executor(
                        self._replica_pool, self._export_json,
                        msg.get("since"))
                except Exception as e:
                    await write_json_async(
                        writer, {"code": "delta_failed",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                await write_json_async(writer, {"payload": payload},
                                       codec, self.tally)

            elif op == "push_dense":
                blob = await self._read_blob(reader, codec)
                if blob is None:
                    return
                try:
                    await loop.run_in_executor(
                        self._replica_pool, self._merge_dense,
                        msg.get("meta"), blob, msg.get("node_ids"),
                        tctx)
                except Exception as e:
                    await write_json_async(
                        writer, {"ok": False, "code": "dense_rejected",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                await write_json_async(writer, {"ok": True}, codec,
                                       self.tally)

            elif op == "delta_dense":
                try:
                    meta_msg, bufs = await loop.run_in_executor(
                        self._replica_pool, self._export_dense,
                        msg.get("since"))
                except Exception as e:
                    await write_json_async(
                        writer, {"code": "dense_rejected",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                await write_json_async(writer, meta_msg, codec,
                                       self.tally)
                await write_frame_async(writer, bufs, codec,
                                        self.tally)

            elif op == "push_packed":
                blob = await self._read_blob(reader, codec)
                if blob is None:
                    return
                try:
                    await loop.run_in_executor(
                        self._replica_pool, self._merge_packed,
                        msg.get("meta"), blob, msg.get("node_ids"),
                        tctx)
                except Exception as e:
                    await write_json_async(
                        writer, {"ok": False,
                                 "code": "packed_rejected",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                await write_json_async(writer, {"ok": True}, codec,
                                       self.tally)

            elif op == "delta_packed":
                try:
                    meta_msg, bufs = await loop.run_in_executor(
                        self._replica_pool, self._export_packed,
                        msg.get("since"), msg.get("ranges"), sem_ok)
                except Exception as e:
                    await write_json_async(
                        writer, {"code": "packed_rejected",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                await write_json_async(writer, meta_msg, codec,
                                       self.tally)
                # The packed read path's last hop: arena memoryviews,
                # vectored out with zero copies in this module.
                await write_frame_async(writer, bufs, codec,
                                        self.tally)

            elif op == "digest":
                # Cold-join slow lane: bounded, sheddable, and on its
                # OWN executor so a tree build never runs ahead of a
                # warm flush tick in the replica queue.
                if self._cold_inflight >= self.cold_lane_depth:
                    self.shed_count += 1
                    self._m_shed.inc(lane="cold", node=self._node)
                    await write_json_async(
                        writer,
                        {"ok": False, "code": "busy",
                         "error": "cold-join lane full "
                                  f"(depth={self.cold_lane_depth})"},
                        codec, self.tally)
                    continue
                try:
                    groups = _parse_digest_groups(msg)
                except (ValueError, TypeError) as e:
                    await write_json_async(
                        writer, {"code": "merkle_rejected",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                self._cold_inflight += 1
                try:
                    reply, buf = await loop.run_in_executor(
                        self._cold_pool, self._digest_values, groups)
                except Exception as e:
                    await write_json_async(
                        writer, {"code": "merkle_rejected",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                finally:
                    self._cold_inflight -= 1
                await write_json_async(writer, reply, codec,
                                       self.tally)
                await write_frame_async(writer, [buf], codec,
                                        self.tally)

            elif op == "heartbeat":
                # Group liveness probe (replication.py monitor). Rides
                # the replica executor ON PURPOSE: a tier whose replica
                # lane is wedged reads as dead — the monitor measures
                # end-to-end serviceability, not TCP accept.
                lease = msg.get("lease")
                lease_err = (self._grant_lease(lease)
                             if isinstance(lease, dict) else None)
                try:
                    state = await loop.run_in_executor(
                        self._replica_pool, self._hb_state,
                        bool(msg.get("want_root")))
                except Exception as e:
                    await write_json_async(
                        writer, {"ok": False, "code": "hb_failed",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                reply = {"ok": True, "op": "heartbeat",
                         "role": self.role, "group": self.group_name,
                         "node": self._node,
                         "lease_ms": self._lease_ms(), **state}
                if lease_err is not None:
                    reply["lease_rejected"] = lease_err
                await write_json_async(writer, reply, codec,
                                       self.tally)

            elif op == "lease":
                # Standalone grant (heartbeat can piggyback one too):
                # the fence a partitioned ex-primary honors by
                # answering `busy` once its TTL runs out.
                lease_err = self._grant_lease(msg)
                if lease_err is not None:
                    await write_json_async(
                        writer, {"ok": False, "code": "lease_stale",
                                 "error": lease_err},
                        codec, self.tally)
                else:
                    await write_json_async(
                        writer, {"ok": True, "role": self.role,
                                 "lease_ms": self._lease_ms()},
                        codec, self.tally)

            elif op == "replicate":
                blob = await self._read_blob(reader, codec)
                if blob is None:
                    return
                try:
                    head = await loop.run_in_executor(
                        self._replica_pool, self._replicate_in,
                        msg.get("meta"), blob, msg.get("node_ids"),
                        tctx)
                except Exception as e:
                    await write_json_async(
                        writer, {"ok": False,
                                 "code": "packed_rejected",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                await write_json_async(
                    writer, {"ok": True, "hlc": head,
                             "role": self.role},
                    codec, self.tally)

            elif op == "metrics":
                try:
                    snap = await loop.run_in_executor(
                        self._replica_pool, self._metrics_snapshot)
                except Exception as e:
                    await write_json_async(
                        writer, {"code": "metrics_failed",
                                 "error": type(e).__name__,
                                 "detail": str(e)},
                        codec, self.tally)
                    return
                if not sketch_ok:
                    # Pre-sketch sessions (no hello, or one that did
                    # not agree "sketch") get the reply a pre-sketch
                    # server produced, byte for byte: stripping the
                    # section restores the old key order exactly.
                    snap.pop("sketches", None)
                await write_json_async(writer, {"metrics": snap},
                                       codec, self.tally)

            elif op == "debug_dump":
                # Flight-recorder bundles (obs/recorder.py): the
                # post-incident forensics surface. New op — legacy
                # pollers never send it, so no cap is needed.
                from .obs.recorder import default_recorder
                bundles = default_recorder().bundles()
                if not sketch_ok:
                    bundles = [
                        {k: v for k, v in b.items()
                         if k != "sketches"} for b in bundles]
                await write_json_async(
                    writer, {"ok": True, "bundles": bundles},
                    codec, self.tally)

            else:
                await write_json_async(
                    writer, {"code": "unknown_op",
                             "error": f"unknown op {op!r}"},
                    codec, self.tally)
                return


def _binop_status_of(reply) -> Tuple[int, Optional[dict]]:
    """Map a JSON routing/proxy verdict onto a binop status byte plus
    an optional detail dict (the human-readable half of the reply:
    owner address, epoch, error text)."""
    if not isinstance(reply, dict):
        return BINOP_ST_BUSY, {"code": "busy",
                               "error": "owner returned garbage "
                                        "(proxy)"}
    if reply.get("ok"):
        return BINOP_ST_OK, None
    code = str(reply.get("code", "write_rejected"))
    status = {"busy": BINOP_ST_BUSY,
              "moved": BINOP_ST_MOVED}.get(code, BINOP_ST_REJECTED)
    detail = {k: v for k, v in reply.items() if k != "ok"}
    return status, detail


def _slot_ok(slot: Any, n_slots: int) -> bool:
    return (isinstance(slot, int) and not isinstance(slot, bool)
            and 0 <= slot < n_slots)


def _value_ok(value: Any) -> bool:
    # The int64 bound matches the store's value lane; anything wider
    # must be rejected per-write, never per-batch.
    return (isinstance(value, int) and not isinstance(value, bool)
            and -(1 << 63) <= value < (1 << 63))


def _parse_digest_groups(msg: dict) -> list:
    """Validate a digest op into [(level, idx-list), ...] — the same
    checks SyncServer applies, shared shape with the prefetch 'more'
    extension."""
    level = msg.get("level")
    idxs = msg.get("idx")
    if not isinstance(level, int) or not isinstance(idxs, list):
        raise ValueError("digest needs int 'level' + list 'idx'")
    groups = [(level, idxs)]
    more = msg.get("more")
    if more is not None:
        if not isinstance(more, list):
            raise ValueError(
                "digest 'more' must be a list of [level, idx] pairs")
        for pair in more:
            if not isinstance(pair, (list, tuple)) or len(pair) != 2:
                raise ValueError(
                    "digest 'more' entries need int level + list idx")
            lvl2, idx2 = pair
            if not isinstance(lvl2, int) or not isinstance(idx2, list):
                raise ValueError(
                    "digest 'more' entries need int level + list idx")
            groups.append((lvl2, idx2))
    return groups
