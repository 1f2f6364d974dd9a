"""Federated serving: N `ServeTier` partitions behind one keyspace.

Port of ``crdt_tpu/federation.py``: the same split, merge, migration
frames and routing tables. Default partitions are `DenseCrdt` s on
``device`` (the card unless named; a host with no card raises at
construction unless given ``device="cpu"`` or its own ``make_crdt``).

`ServeTier` multiplexes thousands of sessions onto ONE replica;
this module composes N of them into a single logical front door. Each tier owns a consistent-hash share of the slot
space (`routing.RoutingTable`); cross-partition ops answer `moved`
(or are proxied for pre-federation sessions), and the table travels
on the hello/route/metrics surfaces so clients and tiers agree on
ownership by epoch.

The load-bearing piece is the **live split** (`split_hot`): when a
partition runs hot — ranked from its serve ack phases and dispatch-
ledger counts (`obs.device`) — half of its widest range is migrated to a new
tier while writes keep flowing:

1. pick the donor range ``[lo, hi)`` and midpoint ``mid``;
2. stream ``[mid, hi)`` to the recipient in watermark rounds:
   each round packs ``pack_since(mark, ranges=((mid, hi),))`` under
   the donor's lock and ships it over the recipient's ordinary
   ``push_packed`` op (the packed wire path, so a `FaultProxy` can sit on
   the wire and the rows are idempotent lattice joins — kill, retry,
   re-ship, nothing double-applies);
3. when a round ships few rows the backlog is small: flip the routing
   epoch (`RoutingTable.split`), publish the new table to every tier;
4. drain: writes accepted by the donor *before* the flip may still be
   sitting in its combiner — wait out the donor's flush tick, then
   ship one final ranged round so the recipient holds everything;
5. clients racing the flip are refused with `moved` (stale epoch),
   refetch the table, and replay at the recipient — the `moved` retry
   loop IS the consistency mechanism; no write is dropped because no
   write is ever acked by a tier that did not commit it.

The inverse, the **live merge** (`merge_cold`), retires a cold
partition the same way: stream every arc it owns to its ring
neighbor in idempotent watermark rounds, flip one epoch
(`RoutingTable.merge` — the recipient must already be an owner),
drain the donor's last flush tick, then retire the donor tier AND
its replica group, re-homing its watch sessions with a typed
``moved`` that carries the flip watermark so re-subscriptions resume
without a gap. Crash-safety is asymmetric around the flip: before
it, the table still names the donor, so any failure (including the
donor primary dying) aborts cleanly and the merge is simply
retryable; after it, the arcs already belong to the recipient, so a
donor crash hands off to the group's failover and the full arc is
re-shipped from the new primary. A recipient crash never flips at
all. `autoscale.Autoscaler` closes the loop: an SLO-driven daemon
that calls `split_hot`/`merge_cold` with hysteresis, cooldown and
epoch fencing, and freezes scaling entirely when its inputs are
unmeasured or a group is primaryless — unmeasured is never treated
as safe to shrink.

Geometry: every partition replica is built with the GLOBAL n_slots.
A partition's store is sparsely occupied outside its ranges, which is
exactly what makes range streaming, Merkle walks and `merge_packed`
work unchanged across partitions — a slot means the same thing
everywhere (docs/FEDERATION.md).

`FederatedClient` is the reference routed client: fetches the table,
sessions per owner, sends the epoch on every op, absorbs `moved` by
refetching and replaying, and can hold watch subscriptions
(`watch`/`next_event`) against any partition.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .utils.concurrency import make_lock
from .net import (BINOP_DELETE, BINOP_GET, BINOP_PUT, BINOP_ST_BUSY,
                  BINOP_ST_MOVED, BINOP_ST_OK, BINOP_ST_OK_NULL,
                  FrameCodec, WireTally, _pack_for_peer, binop_round,
                  recv_frame, recv_bytes_frame, send_bytes_frame,
                  send_frame)
from .routing import PartitionRouter, RoutingTable
from .serve import ServeTier
from .utils.devices import resolve_device

__all__ = ["FederatedTier", "FederatedClient"]

# Streaming rounds stop chasing the write stream once a round ships
# this few rows — the leftover is the final post-flip drain's job.
_SETTLE_ROWS = 64
_MAX_ROUNDS = 64


def _metrics():
    from .obs.registry import default_registry
    reg = default_registry()
    return {
        "epoch": reg.gauge("crdt_tpu_federation_epoch",
                           "current routing-table epoch"),
        "partitions": reg.gauge(
            "crdt_tpu_federation_partitions",
            "live partitions behind the federated front door"),
        # The autoscaler-facing name; kept
        # alongside the historical federation_partitions gauge so
        # existing dashboards and the fleet CLI keep reading.
        "partition_count": reg.gauge(
            "crdt_tpu_partition_count",
            "live partitions behind the federated front door"),
        "splits": reg.counter("crdt_tpu_federation_splits_total",
                              "completed live partition splits"),
        "merges": reg.counter("crdt_tpu_federation_merges_total",
                              "completed live partition merges"),
        "migrated": reg.counter(
            "crdt_tpu_federation_migrated_rows_total",
            "rows streamed to recipients during live splits and "
            "merges"),
        "split_seconds": reg.histogram(
            "crdt_tpu_federation_split_seconds",
            "live split wall time (first stream round to post-flip "
            "drain)"),
        "merge_seconds": reg.histogram(
            "crdt_tpu_federation_merge_seconds",
            "live merge wall time (first stream round to donor "
            "retire)"),
        # Wedge detection (obs/fleet.py `evaluate_slo`): wall-clock
        # millis when the in-flight topology change started / last
        # made progress, 0 when idle. A change whose progress stamp
        # stalls past the SLO budget is a hard failure — a wedged
        # split/merge holds `_control` and freezes the scale loop.
        "inflight_since_ms": reg.gauge(
            "crdt_tpu_topology_change_inflight_since_ms",
            "wall-clock ms when the in-flight topology change "
            "started (0 = idle)"),
        "progress_ms": reg.gauge(
            "crdt_tpu_topology_change_progress_ms",
            "wall-clock ms of the in-flight topology change's last "
            "progress (0 = idle)"),
        # Byte split for the GC payoff story (docs/STORAGE.md): how
        # much of every anti-entropy stream was live state vs
        # tombstones. Post-GC donors should ship tombstone_bytes ≈ 0.
        "live_bytes": reg.counter(
            "crdt_tpu_shipped_live_bytes_total",
            "packed bytes of live rows shipped by migration streams "
            "and rejoin walks (surface label: migrate|rejoin)"),
        "tomb_bytes": reg.counter(
            "crdt_tpu_shipped_tombstone_bytes_total",
            "packed bytes of tombstone rows shipped by migration "
            "streams and rejoin walks (surface label: "
            "migrate|rejoin)"),
    }


class _Upstream:
    """Blocking control-plane connection to one tier (federation
    caps negotiated) used by the split engine and the routed client:
    plain request/reply framing on the caller's thread — control
    traffic, never the serving hot path."""

    def __init__(self, addr: str, timeout: float = 30.0,
                 caps: Tuple[str, ...] = ("zlib", "packed",
                                          "semantics", "federation",
                                          "binop")):
        host, _, port = addr.rpartition(":")
        self.addr = addr
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.tally = WireTally()
        send_frame(self.sock, {"op": "hello", "proto": 1,
                               "caps": list(caps)}, self.tally)
        reply = recv_frame(self.sock, tally=self.tally)
        if not (isinstance(reply, dict) and reply.get("ok")):
            raise ConnectionError(
                f"hello to {addr} failed: {reply!r}")
        agreed = set(reply.get("caps") or ())
        self.caps = frozenset(agreed)
        self.codec = FrameCodec(compress="zlib" in agreed)
        self.routing_epoch = reply.get("routing_epoch")

    def request(self, msg: dict) -> Any:
        send_frame(self.sock, msg, self.tally, self.codec)
        return recv_frame(self.sock, tally=self.tally,
                          codec=self.codec)

    def request_with_blob(self, msg: dict, bufs) -> Any:
        send_frame(self.sock, msg, self.tally, self.codec)
        send_bytes_frame(self.sock, bufs, self.tally, self.codec)
        return recv_frame(self.sock, tally=self.tally,
                          codec=self.codec)

    def recv(self) -> Any:
        return recv_frame(self.sock, tally=self.tally,
                          codec=self.codec)

    def recv_blob(self) -> Optional[bytes]:
        return recv_bytes_frame(self.sock, tally=self.tally,
                                codec=self.codec)

    def close(self) -> None:
        try:
            send_frame(self.sock, {"op": "bye"}, self.tally,
                       self.codec)
        except (OSError, ValueError):
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class FederatedTier:
    """N consistent-hash partitions of one keyspace, each a
    `ServeTier` over its own replica, sharing one epoch-versioned
    `RoutingTable`.

    ``make_crdt(partition_id)`` builds each partition's replica
    (global ``n_slots`` geometry — see the module docstring); the
    default builds a CPU-backed `DenseCrdt`. The id is a monotone
    spawn sequence, NOT the partition's list position: elastic
    split/merge cycles retire and re-create partitions, and a reused
    node name would collide with the retired generation's rows still
    living in the survivors. ``layout="even"`` (the
    bench default) gives equal contiguous shares; ``layout="hash"``
    places consistent-hash tokens (`RoutingTable.build`).

    ``replicas > 1`` backs every partition with a
    `replication.ReplicaGroup` (docs/REPLICATION.md): ``tiers[i]``
    then tracks partition *i*'s current PRIMARY (so every existing
    consumer — splits, hot ranking, `tier_at` — keeps working), and
    a group promotion swaps the entry and republishes the table
    fleet-wide through `_on_promote`. With a custom ``make_crdt`` and
    ``replicas > 1`` the factory is called as
    ``make_crdt(partition, replica, generation)``.
    """

    # Checked by analysis/concurrency.py: `_control` may be held while
    # taking a donor tier's store lock (`_ship_ranges` migrates rows
    # under both), never the reverse — the promote path takes the
    # group lock alone and `publish` touches no tier lock, so the
    # cycle cannot happen.
    _CRDTLINT_LOCK_ORDER = ("_control", ("donor.lock",
                                         "ServeTier.lock"))

    def __init__(self, n_slots: int, partitions: int = 4,
                 host: str = "127.0.0.1",
                 flush_interval: float = 0.002,
                 max_sessions: int = 12000,
                 make_crdt=None, layout: str = "even",
                 vnodes: int = 8, replicas: int = 1,
                 ack_replicas: int = 1,
                 heartbeat_interval: float = 0.05,
                 heartbeat_timeout: float = 0.25,
                 lease_misses: int = 4,
                 replicate_timeout: float = 0.25,
                 addr_via=None, device=None, **tier_kw):
        if partitions < 1:
            raise ValueError(
                f"partitions must be >= 1; got {partitions}")
        self.n_slots = int(n_slots)
        self.host = host
        self.flush_interval = flush_interval
        self.max_sessions = max_sessions
        self._layout = layout
        self._vnodes = vnodes
        self._tier_kw = dict(tier_kw)
        self._user_make_crdt = make_crdt
        self._make_crdt = make_crdt if make_crdt is not None \
            else self._default_crdt
        # Where the default partitions live: the card unless the caller
        # names a device (`utils.devices.resolve_device` raises without
        # one), resolved here so a host with no card fails at
        # construction, not at the first spawn. A caller's own
        # ``make_crdt`` places its replicas itself.
        self.device = (None if make_crdt is not None and device is None
                       else resolve_device(device))
        self._n_initial = partitions
        self.replicas = int(replicas)
        self.ack_replicas = int(ack_replicas)
        self.heartbeat_interval = float(heartbeat_interval)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.lease_misses = int(lease_misses)
        self.replicate_timeout = float(replicate_timeout)
        # Forwarded to every ReplicaGroup: maps a member's real listen
        # address to the address the fleet advertises — the chaos-test
        # seam that puts a FaultProxy on EVERY wire the federation
        # uses (replication, streaming, client traffic). Replicated
        # layouts only; bare tiers (replicas == 1) ignore it.
        self.addr_via = addr_via
        self.tiers: List[ServeTier] = []
        # Parallel to `tiers`: the ReplicaGroup backing partition i,
        # or None when replicas == 1 (the zero-overhead layout).
        self.groups: List[Optional[object]] = []
        self.table: Optional[RoutingTable] = None
        self.last_split: Optional[dict] = None
        self.last_merge: Optional[dict] = None
        # Serializes splits and table publication against each other;
        # the serving hot path never takes it.
        self._control = make_lock("FederatedTier._control", 10)
        # Monotone partition-identity counter. Spawn names must NEVER
        # be reused across elastic cycles: a merged-away partition's
        # rows live on in the survivor stamped with its node id, and
        # a later split recipient reusing that name would reject its
        # own ancestors' rows as a duplicate node mid-migration.
        self._spawn_seq = 0

    def _default_crdt(self, index: int):
        from .models.dense_crdt import DenseCrdt
        return DenseCrdt(f"fed-p{index}", self.n_slots,
                         device=self.device)

    def _replica_crdt(self, pi: int, ri: int, gen: int):
        if self._user_make_crdt is not None:
            return self._user_make_crdt(pi, ri, gen)
        from .models.dense_crdt import DenseCrdt
        return DenseCrdt(f"fed-p{pi}-r{ri}.{gen}", self.n_slots,
                         device=self.device)

    # --- lifecycle ---

    def _spawn_tier(self, index: int) -> ServeTier:
        tier = ServeTier(
            self._make_crdt(index), host=self.host, port=0,
            max_sessions=self.max_sessions,
            flush_interval=self.flush_interval,
            router=PartitionRouter(), **self._tier_kw)
        tier.start()
        tier.router.bind(f"{tier.host}:{tier.port}")
        return tier

    def _spawn_partition(self):
        """Spawn one partition under the next spawn-sequence identity:
        a bare tier when ``replicas == 1`` (the pre-replication
        layout, zero added moving parts), else a started
        `ReplicaGroup` whose primary tier is what the fleet routes
        to. Returns ``(primary_tier, group_or_None)``. The identity
        is the monotone ``_spawn_seq``, not the list position — list
        positions are reused as merges retire partitions, names are
        not (see ``_spawn_seq``)."""
        seq = self._spawn_seq
        self._spawn_seq += 1
        if self.replicas == 1:
            return self._spawn_tier(seq), None
        from .replication import ReplicaGroup
        grp = ReplicaGroup(
            self.n_slots, replicas=self.replicas,
            ack_replicas=self.ack_replicas, host=self.host,
            group=f"p{seq}",
            make_crdt=lambda ri, gen, pi=seq:
                self._replica_crdt(pi, ri, gen),
            flush_interval=self.flush_interval,
            heartbeat_interval=self.heartbeat_interval,
            heartbeat_timeout=self.heartbeat_timeout,
            lease_misses=self.lease_misses,
            replicate_timeout=self.replicate_timeout,
            on_promote=self._on_promote,
            addr_via=self.addr_via,
            tier_kwargs={"max_sessions": self.max_sessions,
                         **self._tier_kw})
        grp.start()
        return grp.primary.tier, grp

    def start(self) -> "FederatedTier":
        try:
            for _ in range(self._n_initial):
                tier, grp = self._spawn_partition()
                self.tiers.append(tier)
                self.groups.append(grp)
            owners = [t.router.addr for t in self.tiers]
            if self._layout == "hash":
                table = RoutingTable.build(self.n_slots, owners,
                                           vnodes=self._vnodes)
            else:
                table = RoutingTable.even(self.n_slots, owners)
            with self._control:
                self.publish(table)
        except BaseException:
            self.stop()
            raise
        return self

    def stop(self) -> None:
        tiers, self.tiers = self.tiers, []
        groups, self.groups = self.groups, []
        for i, tier in enumerate(tiers):
            grp = groups[i] if i < len(groups) else None
            try:
                if grp is not None:
                    grp.stop()
                else:
                    tier.stop()
            except Exception:
                pass

    def __enter__(self) -> "FederatedTier":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def publish(self, table: RoutingTable) -> None:
        """Install ``table`` on every tier — every group MEMBER for
        replicated partitions, so followers answer ``moved`` with the
        same epoch the primary serves — and refresh the fleet gauges
        (epoch-guarded installs, so an older table never rolls a tier
        back). Callers hold ``_control``; `install_table` is lock-free
        on the group side, which is what keeps the promote path
        (group lock → control lock) cycle-free."""
        for i, tier in enumerate(self.tiers):
            grp = self.groups[i] if i < len(self.groups) else None
            if grp is not None:
                grp.install_table(table)
            else:
                tier.router.install(table)
        self.table = table
        m = _metrics()
        m["epoch"].set(float(table.epoch))
        m["partitions"].set(float(len(self.tiers)))
        m["partition_count"].set(float(len(self.tiers)))

    # --- wedge instrumentation (obs/fleet.py `evaluate_slo`) ---

    def _change_started(self) -> None:
        from .hlc import wall_clock_millis
        ms = float(wall_clock_millis())
        m = _metrics()
        m["inflight_since_ms"].set(ms)
        m["progress_ms"].set(ms)

    def _change_progress(self) -> None:
        from .hlc import wall_clock_millis
        _metrics()["progress_ms"].set(float(wall_clock_millis()))

    def _change_done(self) -> None:
        m = _metrics()
        m["inflight_since_ms"].set(0.0)
        m["progress_ms"].set(0.0)

    def _on_promote(self, group, table) -> None:
        """Failover hook: a group monitor elected a new primary and
        hands us its proposed table flip. Swap the partition's `tiers`
        entry to the new primary and publish fleet-wide. Runs on the
        group's monitor thread AFTER it released the group lock (see
        `ReplicaGroup._promote`), so taking ``_control`` here cannot
        deadlock against a split holding ``_control`` while polling
        the group."""
        with self._control:
            idx = next((i for i, g in enumerate(self.groups)
                        if g is group), None)
            if idx is None:
                return        # group already detached (stop/abort)
            old_tier = self.tiers[idx]
            new_tier = group.primary.tier
            self.tiers[idx] = new_tier
            current = self.table
            if table is not None and (
                    current is None or table.epoch > current.epoch):
                fresh = table
            else:
                # The group's flip raced a concurrent epoch bump (a
                # split published while the election ran) and lost
                # the tie — re-derive the ownership move against the
                # CURRENT table so the dead primary's arcs still land
                # on the winner.
                fresh = current
                if current is not None:
                    old_addr = old_tier.router.addr
                    if old_addr in current.owners():
                        fresh = current.reassign(
                            old_addr, new_tier.router.addr)
            if fresh is not None:
                self.publish(fresh)

    def _await_failover(self, group, dead_tier: ServeTier,
                        timeout: float = 5.0) -> ServeTier:
        """Block until ``group`` promotes a replacement for
        ``dead_tier`` and return the new primary's tier. Used by the
        post-flip drain when the donor dies mid-split; safe to call
        while holding ``_control`` because `ReplicaGroup.primary`
        only takes the group lock, which `_promote` releases before
        it calls back into `_on_promote`."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = group.primary
            if m is not None and m.tier is not None \
                    and m.tier is not dead_tier \
                    and not m.tier.killed:
                return m.tier
            # crdtlint: disable=blocking-under-lock -- bounded failover wait; group.primary takes only the group lock, released before _on_promote re-enters _control
            time.sleep(group.heartbeat_interval)
        raise ConnectionError(
            f"group {group.group}: no replacement primary within "
            f"{timeout}s of donor death")

    def addrs(self) -> List[str]:
        return [t.router.addr for t in self.tiers]

    def tier_at(self, addr: str) -> ServeTier:
        for tier in self.tiers:
            if tier.router.addr == addr:
                return tier
        raise KeyError(f"no tier at {addr}")

    # --- hot-partition detection (serve ack phases + dispatch ledger) ---

    def hot_partition(self) -> Tuple[int, dict]:
        """Rank partitions by committed write rows (the serve ack
        pipeline's volume signal) and return (index, evidence). The
        evidence dict records the per-partition rows plus the process
        dispatch-ledger ingest-scatter counts, so a split decision is
        auditable in the trace record."""
        from .obs.device import default_ledger
        rows = []
        for tier in self.tiers:
            wc = tier._wc
            rows.append(0 if wc is None else int(wc.rows_committed))
        hot = max(range(len(rows)), key=lambda i: rows[i])
        led = default_ledger()
        evidence = {
            "rows_committed": rows,
            "hot_index": hot,
            "ledger_ingest_dispatches": {
                k: v for k, v in led.as_dict().items()
                if "ingest" in k or "put_scatter" in k},
        }
        return hot, evidence

    def cold_partition(self) -> Tuple[Optional[int], dict]:
        """Rank partitions by committed write rows and return the
        COLDEST mergeable index plus the evidence dict (mirror of
        `hot_partition`, feeding `merge_cold`). A partition is
        mergeable when some OTHER partition owns a range adjacent to
        one of its arcs — with one partition left there is nothing to
        merge into and the index comes back None."""
        rows = []
        for tier in self.tiers:
            wc = tier._wc
            rows.append(0 if wc is None else int(wc.rows_committed))
        cold = None
        for i in sorted(range(len(rows)), key=lambda i: rows[i]):
            addr = self.tiers[i].router.addr
            if self.table is not None \
                    and self._merge_neighbor(addr) is not None:
                cold = i
                break
        evidence = {"rows_committed": rows, "cold_index": cold}
        return cold, evidence

    def _merge_neighbor(self, donor_addr: str) -> Optional[str]:
        """The ring neighbor that absorbs a retiring donor's arcs:
        the owner of the range following the donor's widest arc
        (wrapping), falling back to the one preceding it. None when
        no other owner borders the donor (single-owner table)."""
        table = self.table
        spans = table.ranges_of(donor_addr)
        if not spans:
            return None
        lo, hi = max(spans, key=lambda r: r[1] - r[0])
        n = table.n_slots
        for probe in (hi % n, (lo - 1) % n):
            owner = table.owner_of(probe)
            if owner != donor_addr:
                return owner
        return None

    # --- the live split state machine ---

    def split_hot(self, src: Optional[int] = None,
                  dst_addr_override: Optional[str] = None,
                  settle_rows: int = _SETTLE_ROWS) -> dict:
        """Split the hot partition live: spawn a recipient tier,
        stream the migrating half-range to it while writes keep
        flowing, flip the routing epoch, drain the donor's last tick.
        Returns the split stats dict (also kept as ``last_split``).

        ``dst_addr_override`` routes the *stream* through a different
        address than the recipient's own (tests interpose a
        `FaultProxy` there to kill mid-handoff); the routing table
        always names the recipient's real address.
        """
        with self._control:
            return self._split_locked(src, dst_addr_override,
                                      settle_rows)

    def _split_locked(self, src, dst_addr_override, settle_rows):
        if self.table is None:
            raise RuntimeError("federation not started")
        t0 = time.perf_counter()
        if src is None:
            src, evidence = self.hot_partition()
        else:
            evidence = {"hot_index": src, "forced": True}
        donor = self.tiers[src]
        donor_group = self.groups[src] if src < len(self.groups) \
            else None
        donor_addr = donor.router.addr
        spans = self.table.ranges_of(donor_addr)
        if not spans:
            raise ValueError(f"partition {src} owns no ranges")
        lo, hi = max(spans, key=lambda r: r[1] - r[0])
        if hi - lo < 2:
            raise ValueError(
                f"range [{lo}, {hi}) too narrow to split")
        mid = (lo + hi) // 2

        recipient, recipient_group = self._spawn_partition()
        self.tiers.append(recipient)
        self.groups.append(recipient_group)
        dst_addr = recipient.router.addr
        stream_addr = dst_addr_override or dst_addr

        # Pre-flip: recipient must already believe the CURRENT table
        # (it is not an owner yet, so forwarded/foreign ops answer
        # moved instead of enqueueing) before any client can find it.
        if recipient_group is not None:
            recipient_group.install_table(self.table)
        else:
            recipient.router.install(self.table)

        rounds = 0
        migrated = 0
        mark = None
        flipped = False
        self._change_started()
        # Dial INSIDE the try: a refused handshake must still run the
        # unwind (drop the just-spawned recipient) and `_change_done`
        # (a wedge gauge left in-flight reads as a stuck topology
        # change forever).
        up = None
        try:
            up = self._dial_upstream(stream_addr)
            while rounds < _MAX_ROUNDS:
                rounds += 1
                shipped, mark = self._ship_ranges(
                    donor, up, mark, ((mid, hi),))
                self._change_progress()
                migrated += shipped
                if shipped <= settle_rows:
                    break
            # Flip: one epoch bump, published everywhere. Writes the
            # donor acked before this instant are covered by the
            # post-flip drain; writes arriving after it answer moved.
            table = self.table.split(lo, mid, dst_addr)
            self.publish(table)
            flipped = True
            self._change_progress()
            flip_at = time.perf_counter()
            # Drain: anything the donor enqueued pre-flip commits
            # within one flush tick; wait it out, then ship the final
            # watermark round so the recipient holds every acked row.
            # crdtlint: disable=blocking-under-lock -- bounded drain (4 flush ticks); _control intentionally serializes the whole split against other topology changes
            time.sleep(max(donor.flush_interval * 4, 0.01))
            try:
                shipped, mark = self._ship_ranges(donor, up, mark,
                                                  ((mid, hi),))
            except ConnectionError:
                if donor_group is None or not donor.killed:
                    raise
                # Donor crashed AFTER the flip: the table already
                # names the recipient, so aborting would strand
                # [mid, hi). Hand off: wait for the donor's group to
                # promote (write concern means every acked row is on
                # the winner) and re-drain the full range from the
                # new primary — mark=None, because the watermark was
                # taken against the dead store's clock.
                donor = self._await_failover(donor_group, donor)
                shipped, mark = self._ship_ranges(donor, up, None,
                                                  ((mid, hi),))
            migrated += shipped
            rounds += 1
        except BaseException:
            if not flipped:
                # Pre-flip abort: no client ever saw the recipient
                # (the table never named it), so unwinding it IS the
                # clean abort — the donor's group fails over on its
                # own and the split can simply be retried.
                self.tiers.pop()
                grp = self.groups.pop()
                try:
                    if grp is not None:
                        grp.stop()
                    else:
                        recipient.stop()
                except Exception:
                    pass
            raise
        finally:
            if up is not None:
                up.close()
            self._change_done()

        m = _metrics()
        m["splits"].inc()
        m["migrated"].inc(migrated)
        dt = time.perf_counter() - t0
        m["split_seconds"].observe(dt)
        donor.last_scale = {"action": "split-donor",
                            "epoch": self.table.epoch,
                            "peer": dst_addr}
        recipient.last_scale = {"action": "split-recipient",
                                "epoch": self.table.epoch,
                                "peer": donor_addr}
        self.last_split = {
            "src": src, "src_addr": donor_addr, "dst_addr": dst_addr,
            "range": [lo, hi], "split_at": mid,
            "rounds": rounds, "migrated_rows": migrated,
            "epoch": self.table.epoch, "seconds": dt,
            "drain_rows": shipped,
            "flip_to_drain_seconds": time.perf_counter() - flip_at,
            "evidence": evidence,
        }
        return self.last_split

    def _ship_ranges(self, donor: ServeTier, up: _Upstream, mark,
                     spans: Tuple[Tuple[int, int], ...]):
        """One streaming round: pack the donor's rows in ``spans``
        modified at-or-after ``mark`` (under the donor's lock, with
        the watermark taken in the SAME hold so no commit can fall
        between pack and mark), ship via push_packed, return
        (rows, new_mark). A split streams one half-range; a merge
        streams every arc the donor owns. Transport faults retry on a
        fresh connection — the rows are idempotent lattice joins. A
        KILLED donor raises instead of packing: its in-process store
        object is still addressable, but a real crash would not be,
        and the abort/handoff paths key off this honesty."""
        from .ops.packing import pack_rows
        if donor.killed:
            raise ConnectionError(
                f"donor {donor.host}:{donor.port} killed mid-stream")
        with donor.lock:
            wm = donor.crdt.canonical_time
            # crdtlint: disable=blocking-under-lock -- migration pack must be atomic with the donor watermark; _control serializes topology changes so no other split waits on this dispatch
            packed, ids = _pack_for_peer(donor.crdt, mark, True,
                                         ranges=tuple(spans))
        if not packed.k:
            return 0, wm
        # Live/tombstone byte split (docs/STORAGE.md): every row costs
        # the same wire bytes, so the split is exact row accounting.
        # Donors that ran an epoch-GC pass first stream tomb_bytes ≈ 0
        # — the measurable payoff of purge-before-retire.
        per_row = packed.nbytes // packed.k
        tomb_rows = int(packed.tomb.sum())
        m = _metrics()
        m["tomb_bytes"].inc(tomb_rows * per_row, surface="migrate")
        m["live_bytes"].inc((packed.k - tomb_rows) * per_row,
                            surface="migrate")
        meta, bufs = pack_rows(packed)
        msg = {"op": "push_packed", "meta": meta,
               "node_ids": list(ids)}
        for attempt in range(8):
            try:
                reply = up.request_with_blob(msg, bufs)
                if isinstance(reply, dict) and reply.get("ok"):
                    return packed.k, wm
                raise ConnectionError(
                    f"push_packed refused: {reply!r}")
            except (ConnectionError, OSError, ValueError) as e:
                # Kill-and-restart mid-handoff (FaultProxy drops the
                # link, the recipient restarts): reconnect and replay
                # the SAME pack — merge_packed is idempotent.
                last = e
                try:
                    up.close()
                except Exception:
                    pass
                # crdtlint: disable=blocking-under-lock -- bounded redial backoff (8 attempts); abandoning mid-migration would strand shipped-but-unacked rows
                time.sleep(0.05 * (attempt + 1))
                try:
                    up.__init__(up.addr)
                except (ConnectionError, OSError) as e2:
                    last = e2
                    continue
        raise ConnectionError(
            f"range stream to {up.addr} failed after retries: {last!r}")

    @staticmethod
    def _dial_upstream(addr: str) -> _Upstream:
        """Handshake the control-plane stream, with retries. The dial
        is the one transport step `_ship_ranges` cannot re-run (its
        reconnects need a session object to exist first), and a single
        flaky accept should not abort a topology change that has not
        moved a row yet."""
        last: Exception = ConnectionError(f"no dial attempted: {addr}")
        for attempt in range(8):
            try:
                return _Upstream(addr)
            except (ConnectionError, OSError) as e:
                last = e
                # crdtlint: disable=blocking-under-lock -- bounded dial backoff (8 attempts, ≤1.8s total); the UNBOUNDED wait lives outside the lock, this residue is capped
                time.sleep(0.05 * (attempt + 1))
        raise ConnectionError(
            f"upstream dial to {addr} failed after retries: {last!r}")

    # --- the live merge state machine (inverse of split_hot) ---

    def merge_cold(self, src: Optional[int] = None,
                   dst_addr_override: Optional[str] = None,
                   settle_rows: int = _SETTLE_ROWS) -> dict:
        """Merge the cold partition away live: stream every arc it
        owns to its ring neighbor in the same idempotent watermark
        rounds the split uses, flip the routing epoch
        (`RoutingTable.merge`), drain the donor's last flush tick
        plus a final catch-up round, re-home its watch sessions, then
        retire the donor tier AND its `ReplicaGroup`. Returns the
        merge stats dict (also kept as ``last_merge``).

        Crash-safety mirrors the split. Donor primary killed PRE-flip:
        the stream raises, the table still names the donor, nothing
        was spawned — the merge is simply retryable once the group
        fails over, and the arc is served throughout. Donor killed
        POST-flip: hand off to `_await_failover` and re-ship the full
        arc from the new primary (write concern means every acked row
        is on the winner). Recipient crash: `push_packed` retries
        exhaust and the merge aborts WITHOUT flipping — the donor
        still owns its arc, and a later retry merges into whichever
        neighbor the recipient's own failover elected.

        ``dst_addr_override`` routes the *stream* through a different
        address than the recipient's own (tests interpose a
        `FaultProxy` there); the routing table always names the
        recipient's real address.
        """
        with self._control:
            stats, grp, donor = self._merge_locked(
                src, dst_addr_override, settle_rows)
        # Stop the retired group OUTSIDE the _control hold: after a
        # donor-kill handoff its monitor thread is parked in
        # `_on_promote` waiting for _control, and `stop()` joins that
        # thread — joining under the lock is a deadlock that only the
        # join timeout would break. Released first, the monitor wakes,
        # finds the group already detached, backs off, and the join
        # completes immediately.
        try:
            if grp is not None:
                grp.stop()
            else:
                donor.stop()
        except Exception:
            pass
        return stats

    def _merge_locked(self, src, dst_addr_override, settle_rows):
        if self.table is None:
            raise RuntimeError("federation not started")
        if len(self.tiers) <= 1:
            raise ValueError("cannot merge the last partition")
        t0 = time.perf_counter()
        if src is None:
            src, evidence = self.cold_partition()
            if src is None:
                raise ValueError("no mergeable partition "
                                 "(single-owner table)")
        else:
            evidence = {"cold_index": src, "forced": True}
        donor = self.tiers[src]
        donor_group = self.groups[src] if src < len(self.groups) \
            else None
        donor_addr = donor.router.addr
        spans = self.table.ranges_of(donor_addr)
        if not spans:
            raise ValueError(f"partition {src} owns no ranges")
        dst_addr = self._merge_neighbor(donor_addr)
        if dst_addr is None:
            raise ValueError(
                f"no ring neighbor to absorb {donor_addr}")
        recipient = self.tier_at(dst_addr)
        stream_addr = dst_addr_override or dst_addr

        # Spend the GC bytes (docs/STORAGE.md): purge the donor's
        # stable tombstones BEFORE streaming, so retiring a churned
        # partition ships live rows only — the recipient never pays
        # pack/merge/digest cost for deletes every replica already
        # observed. Zero-cost when the stability watermark is pinned
        # or has not advanced (gc_pass dispatches nothing).
        gc_purged = donor.gc_pass()

        rounds = 0
        migrated = 0
        mark = None
        flipped = False
        self._change_started()
        # Dial INSIDE the try: a refused handshake must still run
        # `_change_done`, or the wedge gauge reads as a stuck topology
        # change forever.
        up = None
        try:
            up = self._dial_upstream(stream_addr)
            while rounds < _MAX_ROUNDS:
                rounds += 1
                shipped, mark = self._ship_ranges(donor, up, mark,
                                                  spans)
                self._change_progress()
                migrated += shipped
                if shipped <= settle_rows:
                    break
            # Flip: the donor leaves the table in one epoch bump,
            # published everywhere — every write arriving after this
            # instant answers moved at the recipient; writes the
            # donor acked before it are the drain's job. The
            # recipient's watch watermark is rewound to the flip
            # watermark FIRST, so re-homed subscriptions cannot miss
            # rows whose origin stamps predate the recipient's head.
            table = self.table.merge(donor_addr, dst_addr)
            flip_mark = mark
            recipient.rearm_watch(flip_mark)
            self.publish(table)
            flipped = True
            self._change_progress()
            flip_at = time.perf_counter()
            # crdtlint: disable=blocking-under-lock -- bounded drain (4 flush ticks), same serialized-topology reasoning as _split_locked
            time.sleep(max(donor.flush_interval * 4, 0.01))
            try:
                shipped, mark = self._ship_ranges(donor, up, mark,
                                                  spans)
            except ConnectionError:
                if donor_group is None or not donor.killed:
                    raise
                # Donor crashed AFTER the flip: the table already
                # dropped it, so aborting would strand its arcs.
                # Hand off: wait for the group to promote (write
                # concern means every acked row is on the winner) and
                # re-ship the FULL arc from the new primary —
                # mark=None, the watermark was taken against the dead
                # store's clock.
                donor = self._await_failover(donor_group, donor)
                shipped, mark = self._ship_ranges(donor, up, None,
                                                  spans)
            migrated += shipped
            rounds += 1
            self._change_progress()
        except BaseException:
            # Pre-flip abort: the table still names the donor, so the
            # arc is served throughout and there is nothing to unwind
            # — the merge is simply retryable (after a donor-group
            # failover the retry streams from the new primary).
            # Post-flip, reaching here means the handoff above also
            # failed; the arcs belong to the recipient and acked rows
            # are on the donor group's survivors by write concern —
            # surface the error, the retire just did not happen.
            raise
        finally:
            if up is not None:
                up.close()
            self._change_done()

        # Retire the donor: re-home its watch sessions (typed moved +
        # flip-watermark resume at the recipient) and drop it from
        # the partition lists under _control (a late _on_promote for
        # this group then finds nothing and backs off). The caller
        # stops the group after releasing _control — heartbeats,
        # leases and replicator ships cease, the addresses are
        # released, and the fleet poller loses the member on its next
        # scrape.
        rehomed = donor.rehome_watchers(
            dst_addr, table.epoch,
            since=None if flip_mark is None else str(flip_mark))
        del self.tiers[src]
        grp = self.groups.pop(src) if src < len(self.groups) else None

        m = _metrics()
        m["merges"].inc()
        m["migrated"].inc(migrated)
        dt = time.perf_counter() - t0
        m["merge_seconds"].observe(dt)
        # publish() ran before the retire, so refresh the partition
        # gauges now that the donor is gone.
        m["partitions"].set(float(len(self.tiers)))
        m["partition_count"].set(float(len(self.tiers)))
        recipient.last_scale = {"action": "merge-absorb",
                                "epoch": table.epoch,
                                "peer": donor_addr}
        self.last_merge = {
            "src": src, "src_addr": donor_addr, "dst_addr": dst_addr,
            "spans": [list(s) for s in spans],
            "rounds": rounds, "migrated_rows": migrated,
            "gc_purged": gc_purged,
            "epoch": self.table.epoch, "seconds": dt,
            "drain_rows": shipped, "rehomed_watchers": rehomed,
            "flip_to_drain_seconds": time.perf_counter() - flip_at,
            "evidence": evidence,
        }
        return self.last_merge, grp, donor


class FederatedClient:
    """Routed synchronous client: one hello'd session per owner,
    table-aware, epoch-stamped ops, `moved`-driven retry.

    The retry loop is the protocol: on ``moved`` (or a routing-flux
    ``busy``) the client refetches the table from any live tier and
    replays the op at the new owner. An op is reported successful
    ONLY on a positive ack from the tier that committed it — which is
    what makes "zero dropped writes" measurable from the client side.

    Retries back off exponentially (10 ms doubling, capped at
    250 ms), and the default attempt budget is sized so the loop
    rides out a full replica-group failover (~2 s of cumulative
    sleep against a sub-second promote; docs/REPLICATION.md) —
    mid-failover, every path can fail at once: the old owner drops
    connections, a fenced primary answers ``busy``, and ``refresh``
    itself may find no reachable tier for a beat.
    """

    def __init__(self, seeds: List[str], timeout: float = 30.0,
                 max_redirects: int = 12):
        if not seeds:
            raise ValueError("need at least one seed address")
        self._seeds = list(seeds)
        self._timeout = timeout
        self._max_redirects = max_redirects
        self._sessions: Dict[str, _Upstream] = {}
        self.table: Optional[RoutingTable] = None
        self.moved_redirects = 0
        self.busy_retries = 0
        self.redirect_resets = 0
        # Binary op lane adoption accounting (docs/WIRE.md): rounds
        # sent on the negotiated `binop` lane, and sessions demoted to
        # framed JSON after a malformed binary reply (sticky for the
        # session's lifetime — one framing fault means the peer's
        # binary half cannot be trusted, but its JSON half still can).
        self.binop_rounds = 0
        self.binop_fallbacks = 0
        self.refresh()

    # --- plumbing ---

    def _session(self, addr: str) -> _Upstream:
        up = self._sessions.get(addr)
        if up is None:
            up = self._sessions[addr] = _Upstream(
                addr, timeout=self._timeout)
        return up

    def _drop_session(self, addr: str) -> None:
        up = self._sessions.pop(addr, None)
        if up is not None:
            up.close()

    def _backoff(self, attempt: int) -> None:
        time.sleep(min(0.25, 0.01 * (1 << attempt)))

    def _try_refresh(self, hint: Optional[str] = None) -> None:
        """Refresh, absorbing total unreachability: mid-failover the
        fleet can briefly answer nothing at all, and the op retry
        loop — not this probe — owns the failure budget."""
        try:
            self.refresh(hint)
        except ConnectionError:
            pass

    def refresh(self, hint: Optional[str] = None) -> RoutingTable:
        """Fetch the newest routing table from any reachable tier.
        ``hint`` (the owner address a ``moved`` reply named) is tried
        FIRST — it is the freshest routing signal available, and
        mid-topology-change it may be the only address that already
        serves the new epoch; then seeds, then every known owner."""
        candidates = list(dict.fromkeys(
            ([hint] if hint else [])
            + self._seeds + (list(self.table.owners())
                             if self.table is not None else [])))
        last: Optional[BaseException] = None
        for addr in candidates:
            try:
                reply = self._session(addr).request({"op": "route"})
            except (ConnectionError, OSError, ValueError) as e:
                self._drop_session(addr)
                last = e
                continue
            if isinstance(reply, dict) and reply.get("ok") \
                    and isinstance(reply.get("routing"), dict):
                table = RoutingTable.from_json(reply["routing"])
                self.table = RoutingTable.newest(self.table, table)
                return self.table
        raise ConnectionError(
            f"no tier answered a route request: {last!r}")

    # --- keyspace ops ---

    def _next_attempt(self, attempt: int, epoch_seen: int) -> int:
        """Redirect-budget accounting for one retry: a refresh that
        actually ADVANCED the table epoch means the fleet's topology
        moved under this op — the attempt bought progress, not a
        spin, so the budget resets. Back-to-back topology changes (a
        split chased by a merge chased by a failover) therefore can
        never burn the whole budget on one churn burst, while the
        budget still bounds consecutive attempts that learn nothing
        (resetting on ANY refresh would loop forever against a
        permanently stale table)."""
        if self.table is not None and self.table.epoch > epoch_seen:
            self.redirect_resets += 1
            return 0
        return attempt + 1

    def _keyspace(self, msg: dict, slot: int,
                  want_field: str = "ok") -> dict:
        if self.table is None:
            self.refresh()
        attempt = 0
        while attempt < self._max_redirects:
            epoch_seen = -1 if self.table is None \
                else self.table.epoch
            owner = self.table.owner_of(slot)
            msg["epoch"] = self.table.epoch
            try:
                reply = self._session(owner).request(msg)
                if reply is None:
                    # EOF without a reply frame: an abrupt kill (RST
                    # or half-close) reads as None, not an exception.
                    raise ConnectionError(f"{owner} closed mid-op")
            except (ConnectionError, OSError, ValueError):
                self._drop_session(owner)
                self._backoff(attempt)
                self._try_refresh()
                attempt = self._next_attempt(attempt, epoch_seen)
                continue
            if isinstance(reply, dict) and reply.get("ok"):
                return reply
            code = reply.get("code") if isinstance(reply, dict) \
                else None
            if code == "moved":
                # The typed redirect: adopt the owner's epoch view
                # and replay. (PeerConnection maps this same reply to
                # SyncRedirectError; here we stay dict-level.)
                self.moved_redirects += 1
                self._try_refresh()
                attempt = self._next_attempt(attempt, epoch_seen)
                continue
            if code == "busy":
                # Routing flux, a write-concern barrier miss, or a
                # FENCED ex-primary serving out its lease: back off,
                # then refetch the table — a fence usually means the
                # epoch has moved (or is about to) under us.
                self.busy_retries += 1
                self._backoff(attempt)
                self._try_refresh()
                attempt = self._next_attempt(attempt, epoch_seen)
                continue
            raise ValueError(f"op {msg.get('op')!r} rejected: "
                             f"{reply!r}")
        raise ConnectionError(
            f"op {msg.get('op')!r} on slot {slot} still redirecting "
            f"after {self._max_redirects} attempts")

    _JSON_OP = {BINOP_PUT: "put", BINOP_DELETE: "delete",
                BINOP_GET: "get"}

    def _json_msg(self, opcode: int, slot: int, value: int) -> dict:
        msg = {"op": self._JSON_OP[opcode], "slot": int(slot)}
        if opcode == BINOP_PUT:
            msg["value"] = int(value)
        return msg

    def _op(self, opcode: int, slot: int, value: int = 0) -> dict:
        """One keyspace op, preferring the binary op lane
        (docs/WIRE.md) when the owner's session negotiated the
        ``binop`` cap: fixed columnar frames instead of per-op JSON.
        Same retry protocol as `_keyspace` — MOVED replies carry the
        owner address + epoch in the detail tail, which feeds the
        refresh as a routing hint; BUSY backs off and refreshes. A
        malformed binary reply demotes that session to framed JSON
        permanently (sticky fallback) and replays the op there; a
        session that never negotiated the cap routes through
        `_keyspace` untouched."""
        if self.table is None:
            self.refresh()
        attempt = 0
        while attempt < self._max_redirects:
            epoch_seen = -1 if self.table is None \
                else self.table.epoch
            owner = self.table.owner_of(slot)
            try:
                up = self._session(owner)
                if "binop" not in up.caps \
                        or getattr(up, "json_ops", False):
                    return self._keyspace(
                        self._json_msg(opcode, slot, value), slot)
                self.binop_rounds += 1
                try:
                    status, values, details = binop_round(
                        up.sock, [opcode], [int(slot)], [int(value)],
                        epoch=self.table.epoch, tally=up.tally,
                        codec=up.codec)
                except ValueError:
                    # A well-framed but undecodable binary reply: the
                    # peer's binop half is broken, its JSON half is
                    # not — demote the session for good and replay.
                    up.json_ops = True
                    self.binop_fallbacks += 1
                    return self._keyspace(
                        self._json_msg(opcode, slot, value), slot)
            except (ConnectionError, OSError):
                self._drop_session(owner)
                self._backoff(attempt)
                self._try_refresh()
                attempt = self._next_attempt(attempt, epoch_seen)
                continue
            st = int(status[0])
            if st == BINOP_ST_OK:
                return {"ok": True,
                        "value": (int(values[0])
                                  if values is not None else None)}
            if st == BINOP_ST_OK_NULL:
                return {"ok": True, "value": None}
            det = next((d for d in details
                        if isinstance(d, dict) and d.get("i") == 0),
                       None)
            if det is None:
                det = next((d for d in details
                            if isinstance(d, dict) and "i" not in d),
                           {})
            if st == BINOP_ST_MOVED:
                self.moved_redirects += 1
                self._try_refresh(det.get("owner"))
                attempt = self._next_attempt(attempt, epoch_seen)
                continue
            if st == BINOP_ST_BUSY:
                self.busy_retries += 1
                self._backoff(attempt)
                self._try_refresh()
                attempt = self._next_attempt(attempt, epoch_seen)
                continue
            raise ValueError(
                f"op {self._JSON_OP[opcode]!r} rejected: {det!r}")
        raise ConnectionError(
            f"op {self._JSON_OP[opcode]!r} on slot {slot} still "
            f"redirecting after {self._max_redirects} attempts")

    def put(self, slot: int, value: int) -> None:
        self._op(BINOP_PUT, slot, int(value))

    def delete(self, slot: int) -> None:
        self._op(BINOP_DELETE, slot)

    def get(self, slot: int):
        return self._op(BINOP_GET, slot).get("value")

    # --- watch ---

    def watch(self, addr: str, slots=None) -> "_WatchSession":
        """Subscribe on one tier; returns a dedicated event session
        (`next_event` decodes one pushed pack into [(slot, value),
        ...] with typed lanes decoded — docs/FEDERATION.md)."""
        return _WatchSession(addr, slots, timeout=self._timeout)

    def close(self) -> None:
        for addr in list(self._sessions):
            self._drop_session(addr)


class _WatchSession:
    """One watch subscription riding its own connection (events are
    server-pushed; multiplexing them with request/reply frames on one
    socket would interleave streams)."""

    def __init__(self, addr: str, slots, timeout: float = 30.0):
        self._timeout = timeout
        # The server's WatchIndex routes by INTEREST but ships the
        # shared tick pack (zero-copy fan-out: one pack, N writers);
        # slot-scoped subscriptions filter here, client-side.
        self._slots = (None if slots is None
                       else [int(s) for s in slots])
        self._filter = (None if slots is None
                        else frozenset(self._slots))
        self._up: Optional[_Upstream] = None
        self.addr = addr
        self.moved_rehomes = 0
        self._subscribe(addr)

    def _subscribe(self, addr: str,
                   since: Optional[str] = None) -> None:
        """(Re)subscribe at ``addr`` with the original slot filter —
        the initial registration AND the typed-``moved`` re-home a
        partition merge pushes to live sessions. ``since`` is the
        resume mark a moved frame carries: the recipient rewinds its
        fan-out watermark to it at registration, so no commit event
        is dropped across the move."""
        up = _Upstream(addr, timeout=self._timeout)
        msg: dict = {"op": "watch"}
        if self._slots is not None:
            msg["slots"] = self._slots
        if since is not None:
            msg["since"] = str(since)
        reply = up.request(msg)
        if not (isinstance(reply, dict) and reply.get("ok")):
            up.close()
            raise ConnectionError(f"watch refused: {reply!r}")
        if self._up is not None:
            self._up.close()
        self._up = up
        self.addr = addr
        self.since = reply.get("since")

    def next_event(self, timeout: Optional[float] = None
                   ) -> List[Tuple[int, Any]]:
        """Block for one pushed event pack; returns decoded
        (slot, value) pairs (None value = tombstone; typed lanes
        decode through their registered semantics). A typed ``moved``
        frame — the partition this subscription lived on was merged
        away — transparently resubscribes at the named owner: the
        recipient's fan-out watermark was rewound to the flip
        watermark server-side, so no commit event is dropped across
        the move."""
        from .ops.packing import unpack_rows
        from .semantics import by_tag
        for _ in range(4):   # absorb back-to-back re-homes
            if timeout is not None:
                self._up.sock.settimeout(timeout)
            meta_msg = self._up.recv()
            if isinstance(meta_msg, dict) \
                    and meta_msg.get("code") == "moved":
                owner = meta_msg.get("owner")
                if not owner:
                    raise ConnectionError(
                        f"watch moved without owner: {meta_msg!r}")
                self.moved_rehomes += 1
                self._subscribe(str(owner), meta_msg.get("since"))
                continue
            if not (isinstance(meta_msg, dict)
                    and meta_msg.get("op") == "event"):
                raise ConnectionError(
                    f"watch stream broke: {meta_msg!r}")
            blob = self._up.recv_blob()
            if blob is None:
                raise ConnectionError("watch stream EOF mid-event")
            packed = unpack_rows(meta_msg["meta"], blob)
            out: List[Tuple[int, Any]] = []
            sem = packed.sem
            for i in range(packed.k):
                slot = int(packed.slots[i])
                if self._filter is not None \
                        and slot not in self._filter:
                    continue
                if packed.tomb[i]:
                    out.append((slot, None))
                    continue
                lane = int(packed.val[i])
                tag = int(sem[i]) if sem is not None else 0
                out.append((slot, lane if tag == 0
                            else by_tag(tag).decode(lane)))
            return out
        raise ConnectionError(
            "watch re-homed more than 4 times in one poll")

    def close(self) -> None:
        self._up.close()
