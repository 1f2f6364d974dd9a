"""Convergence-lag derivation: "how far behind is replica B?".

Merkle-CRDTs answer divergence questions by comparing DAG roots; the
operational analogue for this LWW/HLC lattice is **HLC-delta lag**
computed from state the gossip runtime already keeps:

- ``peer.watermark`` is the local canonical time captured at the start
  of the last COMPLETED anti-entropy round with that peer (the delta
  ``since`` bound, persisted across restarts).
- Everything this replica wrote after the watermark has therefore not
  been confirmed through a round with that peer.

So per peer:

- ``lag_ms``  = local HLC head millis − watermark millis (clamped at
  0; both are HLC fields, no wall-clock read involved). ``None`` when
  the peer has never completed a round — unbounded, not zero.
- ``pending_records`` = ``crdt.count_modified_since(watermark)`` —
  the records a next delta round would carry (an upper-bound estimate:
  records the peer obtained out-of-band are still counted).

`GossipNode.lag_snapshot()` / `GossipNode.health()` assemble these
under the right locks; the helpers here are pure so they test without
sockets and render identically everywhere (CLI, metrics op, docs).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..hlc import Hlc

# Breaker states that mean the runtime is actively avoiding the peer.
_UNHEALTHY_BREAKER = ("open", "half_open")


def lag_millis(local_head: Hlc, watermark: Optional[Hlc]
               ) -> Optional[int]:
    """HLC-delta staleness in milliseconds, ``None`` when the peer has
    never completed a round (unbounded lag, not zero)."""
    if watermark is None:
        return None
    return max(0, local_head.millis - watermark.millis)


def lag_entry(local_head: Hlc, watermark: Optional[Hlc], *,
              pending: Optional[int] = None,
              breaker: Optional[str] = None,
              dense: Optional[bool] = None,
              last_error: Optional[BaseException] = None
              ) -> Dict[str, Any]:
    """One peer's staleness row — the shape `health()`, the ``metrics``
    wire op, the fleet lag matrix, and the CLI all share.
    ``seconds_behind`` is the same HLC-millis delta in seconds (the
    unit the fleet poller's convergence-SLO budget is expressed in);
    ``None`` when unsynced, like ``lag_ms``."""
    ms = lag_millis(local_head, watermark)
    return {
        "watermark": None if watermark is None else str(watermark),
        "synced": watermark is not None,
        "lag_ms": ms,
        "seconds_behind": None if ms is None else ms / 1000.0,
        "pending_records": pending,
        "breaker": breaker,
        "dense": dense,
        "last_error": (None if last_error is None
                       else f"{type(last_error).__name__}: "
                            f"{last_error}"),
    }


def health_status(peers: Dict[str, Dict[str, Any]],
                  stale_after_ms: int = 60_000) -> str:
    """``"ok"`` unless some peer is unreachable-by-policy (breaker
    open/half-open), never synced, or staler than ``stale_after_ms``."""
    for entry in peers.values():
        if entry.get("breaker") in _UNHEALTHY_BREAKER:
            return "degraded"
        if not entry.get("synced"):
            return "degraded"
        lag = entry.get("lag_ms")
        if lag is not None and lag > stale_after_ms:
            return "degraded"
    return "ok"
