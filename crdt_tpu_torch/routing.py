"""Keyspace routing for the federated serving tier.

Port of ``crdt_tpu/routing.py``: the same FNV-1a ring, epochs, table
bytes and `check()` verdicts, so the two packages' tiers share tables.

One `ServeTier` serves thousands of sessions on a single replica;
the federation layer scales *out* by giving each of N tiers ownership
of a contiguous share of the slot space. This module is the pure-host
half of that design — no sockets, no device work, no metrics — so the
router can be unit-tested exhaustively and shared verbatim between
servers, the proxy fallback, clients and the bench harness:

- `RoutingTable`: an epoch-versioned, immutable partition map. The
  keyspace `[0, n_slots)` is covered by disjoint contiguous ranges,
  each owned by one tier address. Ranges are contiguous **by
  construction** so a migrating range is exactly what
  `DenseCrdt.pack_since(ranges=...)` streams (docs/ANTIENTROPY.md) —
  consistent hashing here places *owner tokens* on the slot ring and
  assigns arcs, rather than hashing each key independently, which
  would shred locality and make range migration impossible.
- `PartitionRouter`: the per-tier view — "which table do I believe,
  and is this op mine?". `check()` is the single admission gate the
  serve loop consults before a keyspace op may enqueue.

Epoch discipline: tables are totally ordered by `epoch`; a split
produces `epoch + 1`. Routers adopt a table only if it is newer
(`install`), so gossiped tables may arrive in any order. Clients send
the epoch they routed with on every keyspace op; a stale epoch is
refused with `moved` even when the slot still lands on the same owner
— the refusal is what forces the client to refetch the table *before*
its next write can race a migrating range (docs/FEDERATION.md).
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["RoutingTable", "PartitionRouter", "PROXY"]

# FNV-1a 64-bit, hand-rolled: token placement must be stable across
# processes and Python versions (builtin hash() is salted per process),
# and the router must not grow a hashlib dependency for 8 tokens.
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


# Sentinel returned by `PartitionRouter.check` when the op belongs to
# another tier but the session never negotiated the `federation` cap:
# the server must answer by proxying to the owner, not by sending a
# `moved` reply the client cannot parse.
PROXY = "proxy"


class RoutingTable:
    """Immutable epoch-versioned map from slot ranges to owner
    addresses.

    ``ranges`` is a tuple of ``(lo, hi, owner)`` half-open intervals,
    sorted by ``lo``, disjoint, and covering ``[0, n_slots)`` exactly —
    validated at construction so a malformed gossiped table fails
    loudly at install time rather than misrouting writes later.
    """

    __slots__ = ("n_slots", "epoch", "ranges", "_los")

    def __init__(self, n_slots: int, epoch: int,
                 ranges: Sequence[Tuple[int, int, str]]):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1; got {n_slots}")
        if epoch < 0:
            raise ValueError(f"epoch must be >= 0; got {epoch}")
        rs = tuple((int(lo), int(hi), str(owner))
                   for lo, hi, owner in ranges)
        if not rs:
            raise ValueError("routing table needs at least one range")
        cursor = 0
        for lo, hi, owner in rs:
            if lo != cursor or hi <= lo:
                raise ValueError(
                    f"ranges must be sorted, disjoint and cover "
                    f"[0, {n_slots}); got gap/overlap at [{lo}, {hi})")
            if not owner:
                raise ValueError(f"empty owner for range [{lo}, {hi})")
            cursor = hi
        if cursor != n_slots:
            raise ValueError(
                f"ranges cover [0, {cursor}) but n_slots={n_slots}")
        self.n_slots = int(n_slots)
        self.epoch = int(epoch)
        self.ranges = rs
        self._los = [lo for lo, _, _ in rs]

    # --- construction ---

    @classmethod
    def build(cls, n_slots: int, owners: Sequence[str],
              vnodes: int = 8) -> "RoutingTable":
        """Consistent-hash placement: each owner contributes ``vnodes``
        tokens at FNV-1a positions on the slot ring; each arc between
        consecutive tokens is owned by the arc-opening token's owner.
        Adding an owner moves only the arcs its new tokens bisect —
        the classic consistent-hashing stability property, with arcs
        that stay contiguous so they remain streamable ranges."""
        names = list(dict.fromkeys(str(o) for o in owners))
        if not names:
            raise ValueError("need at least one owner")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1; got {vnodes}")
        tokens: Dict[int, str] = {}
        for name in names:
            for i in range(vnodes):
                pos = _fnv1a64(f"{name}#{i}".encode()) % n_slots
                # Token collisions resolve to the lexicographically
                # smaller owner: deterministic, order-independent.
                prev = tokens.get(pos)
                if prev is None or name < prev:
                    tokens[pos] = name
        pts = sorted(tokens)
        ranges: List[Tuple[int, int, str]] = []
        first_owner = tokens[pts[0]]
        if pts[0] != 0:
            # The wrap arc [last_token, n_slots) + [0, first_token)
            # belongs to the last token's owner; it lands as two
            # contiguous ranges.
            ranges.append((0, pts[0], tokens[pts[-1]]))
        for i, lo in enumerate(pts):
            hi = pts[i + 1] if i + 1 < len(pts) else n_slots
            if hi > lo:
                ranges.append((lo, hi, tokens[lo]))
        merged = cls._merge_adjacent(ranges)
        table = cls(n_slots, 0, merged)
        missing = set(names) - set(table.owners())
        if missing:
            # Tiny rings can starve an owner of arcs; fall back to the
            # even split so every started tier owns something.
            return cls.even(n_slots, names)
        return table

    @classmethod
    def even(cls, n_slots: int, owners: Sequence[str]) -> "RoutingTable":
        """Equal contiguous shares in owner order — the predictable
        layout the bench uses so "partition 0 runs hot" is a statement
        about a known range."""
        names = list(dict.fromkeys(str(o) for o in owners))
        if not names:
            raise ValueError("need at least one owner")
        n = len(names)
        if n > n_slots:
            raise ValueError(
                f"{n} owners cannot split {n_slots} slots")
        ranges = []
        for i, name in enumerate(names):
            lo = n_slots * i // n
            hi = n_slots * (i + 1) // n
            ranges.append((lo, hi, name))
        return cls(n_slots, 0, ranges)

    @staticmethod
    def _merge_adjacent(
            ranges: Iterable[Tuple[int, int, str]]
    ) -> List[Tuple[int, int, str]]:
        out: List[Tuple[int, int, str]] = []
        for lo, hi, owner in ranges:
            if out and out[-1][2] == owner and out[-1][1] == lo:
                out[-1] = (out[-1][0], hi, owner)
            else:
                out.append((lo, hi, owner))
        return out

    # --- queries ---

    def owner_of(self, slot: int) -> str:
        """Owner address for one slot (O(log ranges))."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(
                f"slot {slot} outside keyspace [0, {self.n_slots})")
        return self.ranges[bisect_right(self._los, slot) - 1][2]

    def owned_mask(self, slots, addr: str):
        """Vectorized ownership test for a batch of slots (the binary
        op lane's admission path): one ``searchsorted`` over the range
        starts against a precomputed per-range owner mask, O(k log r)
        for a k-op batch instead of k Python-level ``owner_of`` calls.
        Callers bound the slots to ``[0, n_slots)`` first (the serve
        tier's per-op slot guard runs before routing)."""
        import numpy as np
        slots = np.asarray(slots)
        idx = np.searchsorted(np.asarray(self._los, np.int64),
                              slots.astype(np.int64, copy=False),
                              side="right") - 1
        owned = np.fromiter((o == addr for _, _, o in self.ranges),
                            bool, count=len(self.ranges))
        return owned[idx]

    def owners(self) -> Tuple[str, ...]:
        """Distinct owners in first-range order."""
        return tuple(dict.fromkeys(o for _, _, o in self.ranges))

    def ranges_of(self, owner: str) -> Tuple[Tuple[int, int], ...]:
        """The (lo, hi) ranges one owner holds — the exact argument
        shape `pack_since(ranges=...)` takes when migrating them."""
        return tuple((lo, hi) for lo, hi, o in self.ranges
                     if o == owner)

    def slots_of(self, owner: str) -> int:
        return sum(hi - lo for lo, hi in self.ranges_of(owner))

    # --- evolution ---

    def split(self, lo: int, at: int, new_owner: str) -> "RoutingTable":
        """New table (epoch + 1) with ``[at, hi)`` of the range that
        starts at ``lo`` reassigned to ``new_owner`` — the routing flip
        at the end of a live migration. The old owner keeps
        ``[lo, at)``."""
        for rlo, rhi, owner in self.ranges:
            if rlo == lo:
                if not lo < at < rhi:
                    raise ValueError(
                        f"split point {at} outside ({lo}, {rhi})")
                out = []
                for r in self.ranges:
                    if r[0] == lo:
                        out.append((lo, at, owner))
                        out.append((at, rhi, str(new_owner)))
                    else:
                        out.append(r)
                return RoutingTable(self.n_slots, self.epoch + 1, out)
        raise ValueError(f"no range starts at slot {lo}")

    def reassign(self, old_owner: str,
                 new_owner: str) -> "RoutingTable":
        """New table (epoch + 1) with every range of ``old_owner``
        handed to ``new_owner`` — the routing flip at the end of a
        failover. Unlike `split` the range geometry is unchanged:
        replica promotion moves *ownership of an arc*, never its
        boundaries, so in-flight `pack_since(ranges=...)` bookkeeping
        keyed on (lo, hi) stays valid across the flip."""
        old, new = str(old_owner), str(new_owner)
        if old not in self.owners():
            raise ValueError(f"{old!r} owns no ranges at epoch "
                             f"{self.epoch}")
        out = [(lo, hi, new if o == old else o)
               for lo, hi, o in self.ranges]
        return RoutingTable(self.n_slots, self.epoch + 1,
                            self._merge_adjacent(out))

    def merge(self, retiring: str, into: str) -> "RoutingTable":
        """New table (epoch + 1) with every range of ``retiring``
        handed to ``into`` — the routing flip at the end of a live
        merge (`FederatedTier.merge_cold`). Unlike `reassign`, the
        recipient must ALREADY be an owner: a merge shrinks the fleet
        by one partition, it never introduces an address, so a typo'd
        recipient fails here instead of minting a ghost owner the
        fleet would route writes to. Adjacent ranges coalesce, so a
        donor arc bordered by the recipient's own arc disappears from
        the range list entirely."""
        old, new = str(retiring), str(into)
        if old == new:
            raise ValueError(f"cannot merge {old!r} into itself")
        owners = self.owners()
        if old not in owners:
            raise ValueError(f"{old!r} owns no ranges at epoch "
                             f"{self.epoch}")
        if new not in owners:
            raise ValueError(
                f"merge recipient {new!r} owns no ranges at epoch "
                f"{self.epoch}; a merge hands arcs to an EXISTING "
                f"owner (use reassign for promotion flips)")
        out = [(lo, hi, new if o == old else o)
               for lo, hi, o in self.ranges]
        return RoutingTable(self.n_slots, self.epoch + 1,
                            self._merge_adjacent(out))

    @staticmethod
    def newest(a: Optional["RoutingTable"],
               b: Optional["RoutingTable"]) -> Optional["RoutingTable"]:
        """Join for gossiped tables: the higher epoch wins; ties keep
        ``a`` (epochs only ever move through `split`, so equal epochs
        are equal tables)."""
        if a is None:
            return b
        if b is None or b.epoch <= a.epoch:
            return a
        return b

    # --- wire form (rides hello/metrics JSON surfaces) ---

    def to_json(self) -> dict:
        return {"n_slots": self.n_slots, "epoch": self.epoch,
                "ranges": [[lo, hi, owner]
                           for lo, hi, owner in self.ranges]}

    @classmethod
    def from_json(cls, obj: dict) -> "RoutingTable":
        return cls(int(obj["n_slots"]), int(obj["epoch"]),
                   [(int(lo), int(hi), str(owner))
                    for lo, hi, owner in obj["ranges"]])

    def __eq__(self, other) -> bool:
        return (isinstance(other, RoutingTable)
                and self.n_slots == other.n_slots
                and self.epoch == other.epoch
                and self.ranges == other.ranges)

    def __hash__(self):
        return hash((self.n_slots, self.epoch, self.ranges))

    def __repr__(self) -> str:
        return (f"RoutingTable(n_slots={self.n_slots}, "
                f"epoch={self.epoch}, ranges={len(self.ranges)}, "
                f"owners={len(self.owners())})")


class PartitionRouter:
    """One tier's routing view: the newest table it has adopted plus
    its own address, answering "may this op enqueue here?".

    Single-writer by design: `bind`/`install` run on the tier's serve
    loop (or before it starts), and `check` runs on the same loop —
    no lock needed, matching the serve loop's threading model.
    """

    __slots__ = ("addr", "table")

    def __init__(self, addr: Optional[str] = None,
                 table: Optional[RoutingTable] = None):
        self.addr = addr
        self.table = table

    @property
    def epoch(self) -> Optional[int]:
        return None if self.table is None else self.table.epoch

    def bind(self, addr: str, table: Optional[RoutingTable] = None
             ) -> None:
        """Fix this router's own address (host:port, known only once
        the listening socket reports its port) and optionally seed the
        table in the same step."""
        self.addr = str(addr)
        if table is not None:
            self.install(table)

    def install(self, table: RoutingTable) -> bool:
        """Adopt ``table`` iff it is newer than the current one (so
        out-of-order gossip cannot roll the epoch back). Returns True
        when the table changed."""
        newest = RoutingTable.newest(self.table, table)
        if newest is self.table:
            return False
        self.table = newest
        return True

    def owns(self, slot: int) -> bool:
        return (self.table is not None and self.addr is not None
                and self.table.owner_of(slot) == self.addr)

    def check(self, slot: int, client_epoch: Optional[int],
              fed_ok: bool):
        """The admission gate for one keyspace op.

        Returns ``None`` when the op may enqueue locally, the `PROXY`
        sentinel when the server must forward it for a pre-federation
        session, or a ready-to-send ``moved`` reply dict. A stale
        ``client_epoch`` is refused even for slots this tier owns —
        see the module docstring for why.
        """
        table = self.table
        if table is None or self.addr is None:
            return None          # unbound: single-tier mode, no gate
        owner = table.owner_of(slot)
        stale = (client_epoch is not None
                 and int(client_epoch) != table.epoch)
        if owner == self.addr and not stale:
            return None
        if not fed_ok and owner != self.addr:
            return PROXY
        return {"ok": False, "code": "moved", "owner": owner,
                "epoch": table.epoch,
                "error": (f"slot {slot} owned by {owner} at routing "
                          f"epoch {table.epoch}")}

    def check_batch(self, slots, client_epoch: Optional[int],
                    fed_ok: bool):
        """Vectorized admission for one binary op batch: ``None`` when
        EVERY op may enqueue locally (the hot all-owned path costs one
        searchsorted), else a bool admit-mask — the serve loop settles
        each refused op individually through `check`, so the
        moved/stale-epoch/proxy taxonomy stays in one place. A stale
        ``client_epoch`` refuses the whole batch (one epoch stamps the
        frame), same as the per-op rule."""
        table = self.table
        if table is None or self.addr is None:
            return None          # unbound: single-tier mode, no gate
        if client_epoch is not None \
                and int(client_epoch) != table.epoch:
            import numpy as np
            return np.zeros(len(slots), bool)
        mask = table.owned_mask(slots, self.addr)
        if mask.all():
            return None
        return mask
