"""In-process anti-entropy rounds between two replicas.

Port of ``crdt_tpu/sync.py``. The reference keeps its sync round in its
tests (test/map_crdt_test.dart:273-279): capture the local canonical
time, push everything to the remote, then pull what the remote modified
at or after that time (inclusive, map_crdt.dart:44-45). Either replica
may be this package's or the JAX package's (they join through the same
JSON, `PackedDelta` bytes and digest trees):

- :func:`sync`: in-process record maps (any `Crdt`);
- :func:`sync_json`: the JSON wire format (crdt_json.dart);
- :func:`sync_packed`: one push/pull round on the packed columnar form
  (``pack_since`` / ``merge_packed``), bounded by one watermark, the
  semantics tag lane riding when both replicas have typed slots;
- :func:`sync_merkle`: compare digest trees, walk only the subtrees
  that differ, then exchange just the divergent leaf ranges through
  ``pack_since(ranges=...)`` both ways; traffic follows divergence, not
  store size. It returns a :class:`MerkleSyncReport`.

- :func:`sync_collective`: one round over a whole co-located replica
  group (`collective.CollectiveGroup`) as a single group join.

The socket forms are `crdt_tpu_torch.net`'s ``sync_*_over_conn`` and
``sync_*_over_tcp``.
"""

from __future__ import annotations

from typing import Optional

from .hlc import Hlc
from .net import _pack_for_peer
from .obs.trace import round_id, span, tracer
from .ops.digest import coalesce_leaf_ranges, walk_divergent_leaves
from .record import KeyDecoder, KeyEncoder, ValueDecoder, ValueEncoder

# Default for ``since``: pull from the SAME round's pre-push canonical
# time, the reference's one-shot round. Distinct from None, which asks
# for a cold-start FULL exchange.
_SAME_ROUND = object()


def sync(local, remote, since=_SAME_ROUND) -> Hlc:
    """One push/pull round between two in-process record-map replicas
    (`Crdt`s): a full push of ``local.record_map()``, then a pull of the
    remote's records modified since the watermark. Omit ``since`` for
    the reference's one-shot round (the pull bounded by this round's
    pre-push canonical time), pass None for a cold-start full pull, or
    a previous round's return to resume delta sync. Returns the
    watermark."""
    watermark = local.canonical_time
    remote.merge(local.record_map())
    local.merge(remote.record_map(
        modified_since=watermark if since is _SAME_ROUND else since))
    return watermark


def sync_json(local, remote, key_encoder: Optional[KeyEncoder] = None,
              value_encoder: Optional[ValueEncoder] = None,
              key_decoder: Optional[KeyDecoder] = None,
              value_decoder: Optional[ValueDecoder] = None,
              since=_SAME_ROUND) -> Hlc:
    """The same round over the JSON wire format: a full-state push, then
    a pull keyed on the watermark (crdt.dart:124-135); ``since`` as in
    :func:`sync`."""
    watermark = local.canonical_time
    remote.merge_json(local.to_json(key_encoder=key_encoder,
                                    value_encoder=value_encoder),
                      key_decoder=key_decoder, value_decoder=value_decoder)
    local.merge_json(remote.to_json(
        modified_since=watermark if since is _SAME_ROUND else since,
        key_encoder=key_encoder, value_encoder=value_encoder),
        key_decoder=key_decoder, value_decoder=value_decoder)
    return watermark


def _sem_ok(local, remote) -> bool:
    return hasattr(local, "set_semantics") and hasattr(remote,
                                                       "set_semantics")


def _pull(local, pulled, pulled_ids, watermark, sem_ok: bool) -> None:
    """Merge the pulled half. With ``merge_and_repack`` the join also
    computes (and caches) the next round's push pack under this
    round's watermark."""
    if hasattr(local, "merge_and_repack"):
        local.merge_and_repack(pulled, pulled_ids, since=watermark,
                               sem_mode="include" if sem_ok else "auto")
    else:
        local.merge_packed(pulled, pulled_ids)


def sync_packed(local, remote, since=_SAME_ROUND) -> Hlc:
    """One round on the packed columnar form: push the rows ``local``
    modified since ``since``, pull the rows ``remote`` modified since
    the same watermark. Omit ``since`` for the reference's one-shot
    round (a FULL push, a pull bounded by this round's pre-push
    canonical time), pass None for a cold-start full exchange, or a
    previous round's return to resume delta sync. An empty half skips
    its merge. Returns the watermark."""
    # Commit any ingest backlog before the watermark read: the flush
    # advances the canonical, and a stale bound would re-send its rows.
    drain = getattr(local, "drain_ingest", None)
    if drain is not None:
        drain()
    watermark = local.canonical_time
    push_bound = None if since is _SAME_ROUND else since
    pull_bound = watermark if since is _SAME_ROUND else since
    sem_ok = _sem_ok(local, remote)
    node = str(getattr(local, "node_id", ""))
    # The round id a socket round carries in its trace context, so
    # in-process rounds correlate in the one JSONL sink the same way.
    rid = {"rid": round_id(node)} if tracer().enabled else {}
    with span("sync_packed", kind="sync", node=node,
              hlc=lambda: local.canonical_time,
              peer=str(getattr(remote, "node_id", "")), **rid):
        packed, ids = _pack_for_peer(local, push_bound, sem_ok)
        if packed.k:
            remote.merge_packed(packed, ids)
        pulled, pulled_ids = _pack_for_peer(remote, pull_bound, sem_ok)
        if pulled.k:
            _pull(local, pulled, pulled_ids, watermark, sem_ok)
    return watermark


def sync_collective(group):
    """One anti-entropy round over a whole co-located replica group as a
    SINGLE group join: the in-process twin of the gossip fast lane's
    collective round, for benches and tests that want the group shape
    without a `GossipNode`.

    Where :func:`sync_packed` converges one replica pair per call (N
    replicas need O(N^2) rounds through a connected topology), one
    ``sync_collective(group)`` call lands every member of the
    `crdt_tpu_torch.collective.CollectiveGroup` on the joined state at
    once: zero bytes to any wire, pack and digest caches seeded
    (docs/COLLECTIVE.md). Returns the group's `CollectiveJoinReport`;
    the join carries its own ``collective_join`` span."""
    return group.join()


class MerkleSyncReport:
    """What one :func:`sync_merkle` round cost: walk ``rounds``, digests
    fetched (``digests``; 8 bytes each way on a wire), the divergent
    slot ``ranges`` re-shipped, the rows pushed and pulled, and the
    packed arenas' exact size (``payload_bytes``). Empty ``ranges``
    means the trees matched and no payload moved."""

    __slots__ = ("watermark", "rounds", "digests", "ranges",
                 "pushed_rows", "pulled_rows", "payload_bytes")

    def __init__(self, watermark, rounds, digests, ranges,
                 pushed_rows, pulled_rows, payload_bytes):
        self.watermark = watermark
        self.rounds = rounds
        self.digests = digests
        self.ranges = ranges
        self.pushed_rows = pushed_rows
        self.pulled_rows = pulled_rows
        self.payload_bytes = payload_bytes

    @property
    def digest_bytes(self) -> int:
        return 16 * self.digests   # 8-B value out + 8-B value back

    @property
    def total_bytes(self) -> int:
        return self.digest_bytes + self.payload_bytes


def _packed_nbytes(packed) -> int:
    total = 0
    for lane in packed:
        nbytes = getattr(lane, "nbytes", None)
        if nbytes is not None:
            total += int(nbytes)
    return total


def sync_merkle(local, remote) -> MerkleSyncReport:
    """One Merkle anti-entropy round: compare the two digest trees, walk
    only the subtrees that differ (one `walk_divergent_leaves` level a
    simulated round trip), then exchange JUST the divergent leaf ranges
    through ``pack_since(ranges=...)`` both ways. Matching roots cost
    one probe and no payload. Raises ``ValueError`` when the trees'
    geometry differs (a full packed round is the fallback)."""
    drain = getattr(local, "drain_ingest", None)
    if drain is not None:
        drain()
    watermark = local.canonical_time
    node = str(getattr(local, "node_id", ""))
    rid = {"rid": round_id(node)} if tracer().enabled else {}
    with span("sync_merkle", kind="sync", node=node,
              hlc=lambda: local.canonical_time,
              peer=str(getattr(remote, "node_id", "")), **rid):
        tree = local.digest_tree()
        remote_tree = remote.digest_tree()
        if not tree.same_geometry(remote_tree.n_slots,
                                  remote_tree.leaf_width,
                                  remote_tree.depth):
            raise ValueError(
                f"merkle geometry mismatch: local ({tree.n_slots}, "
                f"{tree.leaf_width}) vs remote ({remote_tree.n_slots}, "
                f"{remote_tree.leaf_width})")
        leaves, rounds, fetched = walk_divergent_leaves(
            tree, remote_tree.values)
        if not leaves:
            return MerkleSyncReport(watermark, rounds, fetched, (),
                                    0, 0, 0)
        ranges = coalesce_leaf_ranges(leaves, tree.leaf_width,
                                      tree.n_slots)
        sem_ok = _sem_ok(local, remote)
        packed, ids = _pack_for_peer(local, None, sem_ok, ranges=ranges)
        payload = _packed_nbytes(packed) if packed.k else 0
        if packed.k:
            remote.merge_packed(packed, ids)
        pulled, pulled_ids = _pack_for_peer(remote, None, sem_ok,
                                            ranges=ranges)
        payload += _packed_nbytes(pulled) if pulled.k else 0
        if pulled.k:
            _pull(local, pulled, pulled_ids, watermark, sem_ok)
    return MerkleSyncReport(watermark, rounds, fetched, ranges,
                            int(packed.k), int(pulled.k), payload)
