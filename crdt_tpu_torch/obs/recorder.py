"""SLO flight recorder: bounded debug bundles captured at incident
edges, dumped over the wire after the fact.

Post-incident forensics today depend on having had a poller attached
*while* the incident happened — the trace ring rotates, sketches keep
merging new samples over the bad window, and by the time a human asks
"what did p99 look like when the autoscaler split?", the evidence is
gone. The flight recorder inverts that: the *process that noticed*
captures a bundle at the moment of the edge, and keeps the last few
in memory for the ``debug_dump`` wire op (net.py / serve.py) and the
``python -m crdt_tpu.obs dump`` CLI to fetch later.

Trigger sites (all in-tree, all fire-and-forget):

- ``evaluate_slo`` flips to failing — the autoscaler's observe loop
  edge-detects the verdict (autoscale.py);
- the primary lease fence trips — a write arrived after the lease
  expired (serve.py);
- the runtime deadlock sanitizer counts a lock-order violation
  (analysis/concurrency.py ``OrderedLock._report``).

Each bundle carries the recent TraceRing span tail, the registry's
sketch snapshots (quantiles over the bad window, not bucket
ceilings), and whatever context sources are attached — a gossip node
attaches its ``metrics_extra`` provider, so bundles include the lag
matrix, routing-table epoch and per-partition load sections the
``metrics`` op would have shown a poller.

Capture is deliberately defensive: every section is independently
try/except-ed (a recorder must never turn an incident into a crash),
per-kind throttling stops a storming trigger (a fenced lease retried
in a tight loop) from churning the ring, and the recorder's own lock
is a leaf — capture gathers all obs state *before* taking it.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from ..utils.concurrency import make_lock

# Bundles kept (oldest evicted) and trace-ring tail length per bundle.
DEFAULT_CAPACITY = 8
DEFAULT_SPAN_TAIL = 128
# Same-kind triggers inside this window are dropped (storm guard).
DEFAULT_THROTTLE_S = 5.0


class FlightRecorder:
    """Bounded in-memory ring of incident debug bundles."""

    # Leaf lock: capture gathers registry/trace state before taking
    # it, and nothing is acquired while holding it.
    _CRDTLINT_GUARDED = {"_lock": ("_bundles", "_seq", "_last_t",
                                   "_sources")}
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 span_tail: int = DEFAULT_SPAN_TAIL,
                 throttle_s: float = DEFAULT_THROTTLE_S):
        self.capacity = int(capacity)
        self.span_tail = int(span_tail)
        self.throttle_s = float(throttle_s)
        self._lock = make_lock("FlightRecorder._lock", 95)
        self._bundles: List[dict] = []
        self._seq = 0
        self._last_t: Dict[str, float] = {}
        # Weakly-held context providers (gossip nodes come and go in
        # tests; the recorder is process-global and must not pin them).
        self._sources: List[weakref.ref] = []

    # --- context sources ---

    def attach_source(self, fn: Callable[[], dict]) -> None:
        """Register a zero-arg provider whose dict is folded into
        every future bundle's ``sources`` list (weakly held; a bound
        method keeps only its instance alive-or-not)."""
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
        with self._lock:
            self._sources = [r for r in self._sources
                             if r() is not None]
            self._sources.append(ref)

    # --- capture ---

    def trigger(self, kind: str,
                context: Optional[dict] = None) -> Optional[dict]:
        """Capture a bundle for incident ``kind``; returns it, or
        ``None`` when throttled. Never raises."""
        now = time.monotonic()
        with self._lock:
            last = self._last_t.get(kind)
            if last is not None and now - last < self.throttle_s:
                return None
            self._last_t[kind] = now
            sources = [r() for r in self._sources]
        bundle = self._capture(kind, context,
                               [s for s in sources if s is not None])
        with self._lock:
            self._seq += 1
            bundle["seq"] = self._seq
            self._bundles.append(bundle)
            del self._bundles[:-self.capacity]
        return bundle

    def _capture(self, kind: str, context: Optional[dict],
                 sources: List[Callable[[], dict]]) -> dict:
        from ..hlc import wall_clock_millis
        bundle: Dict[str, Any] = {"kind": kind,
                                  "t_wall_ms": float(wall_clock_millis()),
                                  "context": context or {}}
        try:
            from .trace import tracer
            ring = tracer()
            if ring.enabled:
                bundle["trace"] = ring.events()[-self.span_tail:]
        except Exception:
            pass
        try:
            from .registry import default_registry
            snap = default_registry().snapshot()
            bundle["sketches"] = snap.get("sketches", {})
            bundle["counters"] = snap.get("counters", {})
        except Exception:
            pass
        outs = []
        for fn in sources:
            try:
                out = fn()
                if isinstance(out, dict):
                    outs.append(out)
            except Exception:
                continue
        if outs:
            bundle["sources"] = outs
        return bundle

    # --- read side ---

    def bundles(self) -> List[dict]:
        """The retained bundles, oldest first (shallow list copy —
        bundles are write-once after capture)."""
        with self._lock:
            return list(self._bundles)

    def clear(self) -> None:
        with self._lock:
            self._bundles = []
            self._last_t = {}


_DEFAULT = FlightRecorder()


def default_recorder() -> FlightRecorder:
    """The process-wide recorder every in-tree trigger site uses."""
    return _DEFAULT
