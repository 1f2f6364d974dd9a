"""Canary convergence probes: timestamped beats in a reserved slot range.

Convergence lag is a *fleet* property — no single replica can measure
it from local state (``lag_ms`` is this replica's view of how stale a
peer *might* be, an upper bound from watermarks). The canary protocol
measures it end to end, through the real write path:

- The fleet reserves ``n_origins`` slots at the top of every store
  (``base_slot .. base_slot + n_origins``); slot ``base_slot + i``
  belongs to origin ``i``.
- Each replica's probe periodically :meth:`~CanaryProbe.beat`\\ s its
  own slot with the current ``hlc.wall_clock_millis()`` as the int64
  value. The beat is an ordinary LWW write — it is stamped, flushed,
  packed, shipped, and merged exactly like user traffic.
- Every replica exposes :meth:`~CanaryProbe.observed` — the last-seen
  canary millis per origin — through the ``metrics`` wire op (the
  ``canary`` section `GossipNode` contributes).
- The fleet poller (`obs.fleet`) scrapes those sections into
  a per-(origin, observer) lag matrix:
  ``lag(o, w) = newest_beat(o) − observed(w)[o]``.

Values are wall-clock millis (read through the one sanctioned boundary,
``hlc.wall_clock_millis``), so the matrix is only as honest as fleet
clock sync — same caveat as HLC itself, and fine for the "seconds
behind" granularity an SLO budget cares about.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..hlc import wall_clock_millis


class CanaryProbe:
    """One replica's canary writer/reader over a reserved slot range.

    ``origin`` is this replica's index in the fleet's canary range
    (``0 <= origin < n_origins``); ``base_slot`` defaults to the top
    ``n_origins`` slots of the store. An optional ``lock`` guards the
    underlying replica (pass the owning server's lock when the replica
    is shared).
    """

    def __init__(self, crdt: Any, origin: int, n_origins: int,
                 base_slot: Optional[int] = None, lock: Any = None):
        if not 0 <= origin < n_origins:
            raise ValueError(
                f"origin {origin} out of range [0, {n_origins})")
        if base_slot is None:
            base_slot = int(getattr(crdt, "n_slots")) - n_origins
        if base_slot < 0:
            raise ValueError(
                f"store too small for {n_origins} canary slots")
        self.crdt = crdt
        self.origin = int(origin)
        self.n_origins = int(n_origins)
        self.base_slot = int(base_slot)
        self._lock = lock

    @property
    def slot(self) -> int:
        """This origin's canary slot."""
        return self.base_slot + self.origin

    def beat(self, millis: Optional[int] = None) -> int:
        """Write one canary beat (current wall millis unless given)
        into this origin's slot, through the ordinary write path."""
        if millis is None:
            millis = wall_clock_millis()
        millis = int(millis)
        if self._lock is not None:
            with self._lock:
                self._put(millis)
        else:
            self._put(millis)
        return millis

    def _put(self, millis: int) -> None:
        self.crdt.put_batch(np.asarray([self.slot], dtype=np.int32),
                            np.asarray([millis], dtype=np.int64))

    def observed(self) -> Dict[str, Optional[int]]:
        """Last-seen canary millis per origin index (string keys so
        the dict is JSON-clean on the metrics wire); ``None`` until a
        beat from that origin has replicated here."""
        if self._lock is not None:
            with self._lock:
                return self._observed()
        return self._observed()

    def _observed(self) -> Dict[str, Optional[int]]:
        return canary_observed(self.crdt, self.base_slot,
                               self.n_origins)

    def snapshot(self) -> Dict[str, Any]:
        """The ``canary`` section of the ``metrics`` wire op reply."""
        return {
            "origin": self.origin,
            "n_origins": self.n_origins,
            "base_slot": self.base_slot,
            "observed": self.observed(),
        }


def canary_observed(crdt: Any, base_slot: int, n_origins: int
                    ) -> Dict[str, Optional[int]]:
    """Read the reserved canary range of ``crdt``: origin index (as a
    string) → last-seen beat millis, ``None`` where nothing has
    replicated yet."""
    out: Dict[str, Optional[int]] = {}
    for i in range(n_origins):
        v = crdt.get(base_slot + i)
        out[str(i)] = None if v is None else int(v)
    return out
