"""Merge observability: per-backend counters and a named profiler span.

Port of ``crdt_tpu/utils/stats.py``. `MergeStats` counts merges and
record flow on a backend; `PeerSyncStats` counts a gossip peer's
rounds, retries, fallbacks, bytes and breaker transitions;
`merge_annotation` wraps the device launch in a trace span
(`crdt_tpu_torch.obs.trace.span`: live only while the process tracer
is on or a ``torch.profiler`` records, and then a
``torch.profiler.record_function`` range, a timed histogram entry and,
with the tracer on, an HLC-stamped ``merge`` ring event).

``register(**labels)`` attaches an instance to the process-wide metrics
registry (`crdt_tpu_torch.obs.registry`) as a weakly held collector,
so every live backend and peer appears in one ``metrics`` snapshot.
Registration is read-side only: the hot-path accounting stays plain
host ints and lazy device scalars.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ..obs.trace import span as _span


@dataclass
class MergeStats:
    """Counters for one CRDT backend instance.

    ``records_seen``/``records_adopted`` may be fed unfetched device
    scalars via the ``add_*_lazy`` methods so the merge hot path never
    blocks on a device→host copy; reading the property drains them.
    """
    merges: int = 0            # merge() calls
    puts: int = 0              # local write batches (put/put_all)
    records_put: int = 0       # local records written
    _seen: int = 0
    _seen_pending: Any = None  # lazy running sum (device scalar)
    _adopted: int = 0
    _adopted_pending: Any = None

    @property
    def records_seen(self) -> int:
        """Remote records examined, winners+losers (crdt.dart:80-85)."""
        if self._seen_pending is not None:
            self._seen += int(self._seen_pending)
            self._seen_pending = None
        return self._seen

    @records_seen.setter
    def records_seen(self, value: int) -> None:
        self._seen_pending = None
        self._seen = value

    def add_seen_lazy(self, count: Any) -> None:
        """Accumulate a host int or an unfetched device scalar without
        forcing a sync; kept as one running device sum (O(1) memory)."""
        self._seen_pending = (count if self._seen_pending is None
                              else self._seen_pending + count)

    @property
    def records_adopted(self) -> int:
        """LWW winners written; may drain a lazy device sum."""
        if self._adopted_pending is not None:
            self._adopted += int(self._adopted_pending)
            self._adopted_pending = None
        return self._adopted

    @records_adopted.setter
    def records_adopted(self, value: int) -> None:
        self._adopted_pending = None
        self._adopted = value

    def add_adopted_lazy(self, count: Any) -> None:
        self._adopted_pending = (
            count if self._adopted_pending is None
            else self._adopted_pending + count)

    def device_pending(self, device) -> Tuple[Any, Any]:
        """The lazy ``(seen, adopted)`` sums as int64 scalars on
        ``device`` (None where nothing is pending), for a kernel that
        adds a merge's counts to them and hands the sums to `carry`; a
        pending host count goes into its total first."""
        out = []
        for name in ("_seen", "_adopted"):
            pending = getattr(self, name + "_pending")
            if pending is not None and not isinstance(pending,
                                                      torch.Tensor):
                setattr(self, name, getattr(self, name) + int(pending))
                setattr(self, name + "_pending", None)
                pending = None
            elif pending is not None:
                pending = pending.to(device, torch.int64)
            out.append(pending)
        return out[0], out[1]

    def carry(self, seen: Any, adopted: Any = None) -> None:
        """Take the lazy sums a kernel carried on from `device_pending`:
        ``seen``, and ``adopted`` where given."""
        self._seen_pending = seen
        if adopted is not None:
            self._adopted_pending = adopted

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("merges", "records_seen", "records_adopted", "puts",
                 "records_put")}

    def reset(self) -> None:
        for k in self.as_dict():
            setattr(self, k, 0)

    def register(self, **labels: Any) -> "MergeStats":
        """Attach to the process-wide metrics registry as a ``merge``
        collector (weakly held); returns self for chaining. The scrape
        drains the lazy device sums (`records_seen` / `records_adopted`
        force a device-to-host fetch), so snapshot from a monitoring
        thread, not from inside a pipelined window. Re-registering
        under a live label set supersedes it (the replica-restart
        idiom: same node id, new object)."""
        from ..obs.registry import default_registry
        default_registry().attach("merge", self, replace=True, **labels)
        return self


@dataclass
class PeerSyncStats:
    """Per-peer counters for the gossip runtime (`crdt_tpu_torch.gossip`).

    One instance per `Peer`; every field is a plain host int so a
    monitoring loop can snapshot `as_dict()` without touching the
    replica. ``retries`` counts re-attempts after transport faults
    (first attempts are not retries); ``fallbacks`` counts wire-form
    downgrades; the ``breaker_*`` fields count state TRANSITIONS, so a
    soak can prove the breaker actually cycled."""
    rounds_ok: int = 0         # completed anti-entropy rounds
    rounds_failed: int = 0     # rounds abandoned (retries exhausted
    #                            or fatal protocol rejection)
    skipped: int = 0           # rounds refused locally: breaker open
    retries: int = 0           # transport-fault re-attempts
    fallbacks: int = 0         # wire form downgraded one step
    full_pulls: int = 0        # rounds pulled with since=None
    delta_pulls: int = 0       # rounds pulled from a watermark
    bytes_sent: int = 0        # wire bytes out, frame headers included
    bytes_received: int = 0    # wire bytes in, frame headers included
    breaker_opened: int = 0
    breaker_half_open: int = 0
    breaker_closed: int = 0

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in (
            "rounds_ok", "rounds_failed", "skipped", "retries",
            "fallbacks", "full_pulls", "delta_pulls", "bytes_sent",
            "bytes_received", "breaker_opened", "breaker_half_open",
            "breaker_closed")}

    def reset(self) -> None:
        for f in self.as_dict():
            setattr(self, f, 0)

    def register(self, **labels: Any) -> "PeerSyncStats":
        """Attach to the process-wide metrics registry as a
        ``peer_sync`` collector (weakly held); returns self. A
        re-``add_peer`` under the same (node, peer) labels supersedes
        the prior collector rather than duplicating the series."""
        from ..obs.registry import default_registry
        default_registry().attach("peer_sync", self, replace=True,
                                  **labels)
        return self


def merge_annotation(name: str = "crdt_tpu_torch.merge", hlc: Any = None):
    """Named span around a merge launch (`obs.trace.span`, kind
    ``merge``): nothing unless live, that is while the process tracer
    is enabled or a ``torch.profiler`` records. Live, a
    ``torch.profiler.record_function`` range, timed into
    ``crdt_tpu_span_seconds`` with its syncs counted; with the tracer
    enabled also an HLC-stamped ``merge`` ring event. ``hlc`` may be a
    zero-arg callable, evaluated only when an event is actually
    recorded."""
    return _span(name, kind="merge", hlc=hlc)
