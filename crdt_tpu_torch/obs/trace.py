"""HLC-stamped structured trace events + profiler-annotated spans.

Port of ``crdt_tpu/obs/trace.py``: the same ring, sink, event fields
and round ids; the profiler annotation is torch's.

A :class:`TraceRing` is a bounded in-memory event ring (newest N
events) with an optional JSONL sink. Events are plain dicts:

    {"seq": 17, "kind": "gossip_round", "mono_s": 123.456,
     "hlc": "2026-08-05T..+0000-0000-n0", "peer": "b",
     "outcome": "ok", "dur_s": 0.0123}

- ``kind`` names the event class: ``merge`` (a merge dispatch span),
  ``gossip_round``, ``wire_frame``, ``checkpoint``, ``breaker``,
  ``bench_phase``, ``ingest`` (a write-combiner flush span,
  models/ingest.py — carries ``rows`` and ``trigger``).
- ``hlc`` is the emitting replica's canonical HLC at emission — the
  cluster-orderable stamp. ``mono_s`` (``time.monotonic()``) orders
  events within one process; wall-clock reads stay where they belong
  (``hlc.wall_clock_millis`` is the one sanctioned boundary).
- ``dur_s`` is present on span-shaped events.

**Cost model**: tracing is off by default and every emit site checks
``tracer().enabled`` (one attribute read) first. A :func:`span` is
*live* when the ring is enabled or a ``torch.profiler`` is recording
(``torch.autograd.profiler._is_profiler_enabled``, one more attribute
read). A span that is not live runs its body and nothing else: no
profiler range, no clock read, no histogram, no sync watch. A live span
runs its body inside ``torch.profiler.record_function(name)`` (a named
range on the profiler's host timeline, the clock its device events are
stamped on), times it into the ``crdt_tpu_span_seconds`` histogram,
and emits a ring event when the ring is enabled.

**Sync counter**: ``crdt_tpu_span_syncs_total{span}`` counts the
host-device synchronizations made while spans are live, each under the
innermost live span of the thread that made it: ``.item()``,
``.tolist()``, ``int(tensor)``, a blocking copy, an ATen op that reads
a CUDA scalar inside. The outermost live span sets
``torch.cuda.set_sync_debug_mode("warn")`` (where CUDA is initialized
and the mode is the default) and restores it on exit; torch reports
each synchronization as a warning. The first such span also installs,
once, a warning hook and an ``always`` filter for those reports, and
leaves them in place: the hook counts a report and hides it while a
span holds the mode, and hands every other warning, and a report under
a mode the caller set, to the hook it replaced. The debug mode is
process-wide, so the count is exact for spans on one thread: a sync on
a thread with no live span of its own is dropped, and spans opened on
other threads in the meantime share the outermost span's mode.

HLC arguments may be zero-arg callables; they are invoked only when an
event is actually recorded, so disabled tracing never pays for a
``str(Hlc)``.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

import torch.profiler
from torch.autograd import profiler as _autograd_profiler

from ..utils.concurrency import make_lock


@functools.lru_cache(maxsize=512)
def _hlc_str_cached(millis: int, counter: int, node_id: Any) -> str:
    # Format straight from the fields (the Hlc.__str__ layout);
    # constructing a throwaway Hlc just to render it would double the
    # miss cost. millis comes from a live Hlc, already normalized.
    from ..hlc import _iso8601
    return f"{_iso8601(millis)}-{counter:04X}-{node_id}"


def _hlc_str(hlc: Any) -> str:
    """``str(hlc)`` with a small field-keyed cache: emit sites hand
    the SAME canonical stamp to every event between refreshes, so the
    ISO-8601 render (the single biggest per-event cost) is paid once
    per stamp, not once per event — what keeps the soak-measured
    tracing overhead inside the 5% budget (bench.py antientropy
    mode). Keyed on the raw fields, not the object: hashing must not
    re-render the stamp."""
    if isinstance(hlc, str):
        return hlc
    try:
        return _hlc_str_cached(hlc.millis, hlc.counter, hlc.node_id)
    except (AttributeError, TypeError):  # stamp-like — render directly
        return str(hlc)


class TraceRing:
    """Bounded in-memory trace event ring + optional JSONL sink.

    The sink is size-bounded: when ``max_sink_bytes`` is set on
    :meth:`enable`, the file rolls to ``<path>.1`` (one generation,
    overwritten on each roll) once it crosses the budget, so a
    multi-hour soak holds at most ~2x the budget on disk.
    """

    # crdtlint lock-discipline contract: ring storage and sink are
    # touched only under self._lock. ``enabled`` is a bare bool read
    # on hot paths by design (stale reads only delay on/off by one
    # event).
    _CRDTLINT_GUARDED = {"_lock": ("_events", "_sink", "_seq",
                                   "_sink_path", "_sink_bytes",
                                   "_sink_max_bytes")}
    # analysis/concurrency.py: leaf singleton — emit never takes
    # another lock inside the ring critical section.
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    def __init__(self, capacity: int = 4096):
        self.enabled = False
        self._lock = make_lock("TraceRing._lock", 82)
        self._events: deque = deque(maxlen=capacity)
        self._sink = None
        self._sink_path: Optional[str] = None
        self._sink_bytes = 0
        self._sink_max_bytes: Optional[int] = None
        self._seq = 0

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._events.maxlen

    def enable(self, capacity: Optional[int] = None,
               jsonl_path: Optional[str] = None,
               max_sink_bytes: Optional[int] = None) -> "TraceRing":
        """Turn event recording on; optionally resize the ring and/or
        append every event to a JSONL file. ``max_sink_bytes`` bounds
        the sink: once the file crosses it, it is rotated to
        ``<path>.1`` and a fresh file is started."""
        with self._lock:
            if capacity is not None:
                self._events = deque(self._events, maxlen=capacity)
            if jsonl_path is not None:
                if self._sink is not None:
                    self._sink.close()
                self._sink = open(jsonl_path, "a", encoding="utf-8")
                self._sink_path = jsonl_path
                try:
                    self._sink_bytes = os.path.getsize(jsonl_path)
                except OSError:
                    self._sink_bytes = 0
            if max_sink_bytes is not None:
                self._sink_max_bytes = max_sink_bytes
        self.enabled = True
        return self

    def disable(self) -> None:
        """Stop recording and close any JSONL sink."""
        self.enabled = False
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
            self._sink_path = None
            self._sink_bytes = 0
            self._sink_max_bytes = None

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def emit(self, kind: str, hlc: Any = None, **fields: Any) -> None:
        """Record one event (no-op while disabled). ``hlc`` may be an
        `Hlc`, a string, or a zero-arg callable evaluated lazily."""
        if not self.enabled:
            return
        event: Dict[str, Any] = {"kind": kind,
                                 "mono_s": time.monotonic()}
        if hlc is not None:
            if callable(hlc):
                hlc = hlc()
            if hlc is not None:
                event["hlc"] = _hlc_str(hlc)
        event.update(fields)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)
            if self._sink is not None:
                # json.dumps defaults to ASCII output, so len() == bytes.
                line = json.dumps(event, default=str) + "\n"
                self._sink.write(line)
                self._sink.flush()
                self._sink_bytes += len(line)
                if (self._sink_max_bytes is not None
                        and self._sink_path is not None
                        and self._sink_bytes >= self._sink_max_bytes):
                    self._sink.close()
                    os.replace(self._sink_path, self._sink_path + ".1")
                    self._sink = open(self._sink_path, "a",
                                      encoding="utf-8")
                    self._sink_bytes = 0

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Snapshot the ring (oldest first), optionally one kind."""
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        return out


_DEFAULT = TraceRing()

# Cross-replica round ids come from a locked process counter, NOT the
# wall clock (crdtlint wall-clock-read): the node-id prefix makes them
# fleet-unique, the counter makes them process-unique, and no clock
# skew can make two rounds collide or reorder.
_RID_LOCK = make_lock("trace._RID_LOCK", 82)
_RID_N = 0


def round_id(node: Any = None) -> str:
    """Compact fleet-unique sync-round id, e.g. ``"a.r17"``: the
    initiator stamps one per round and piggybacks it on sync frames
    (the ``trace`` hello cap) so its ``sync_*`` span and the
    responder's merge span correlate in the JSONL sink."""
    global _RID_N
    with _RID_LOCK:
        _RID_N += 1
        n = _RID_N
    return f"{node}.r{n}" if node not in (None, "") else f"r{n}"

# Span durations double into a fixed log2 histogram so the metrics op
# exposes per-phase latency distributions, not just the event tail the
# ring happens to hold. Created lazily to keep import order trivial.
_SPAN_HIST = None
_SPAN_HIST_LOCK = make_lock("trace._SPAN_HIST_LOCK", 82)


def tracer() -> TraceRing:
    """The process-wide trace ring every in-tree emit site uses."""
    return _DEFAULT


def _span_histogram():
    global _SPAN_HIST
    with _SPAN_HIST_LOCK:
        if _SPAN_HIST is None:
            from .registry import default_registry
            _SPAN_HIST = default_registry().histogram(
                "crdt_tpu_span_seconds",
                "traced span durations by span name (log2 buckets)",
                low_exp=-20, high_exp=5)
            # Registered beside it, so that a reader finds it whenever
            # a span was live, syncs or none.
            _sync_counter()
        return _SPAN_HIST


def _sync_counter():
    from .registry import default_registry
    return default_registry().counter(
        "crdt_tpu_span_syncs_total",
        "host-device synchronizations under the innermost live span")


# The live spans of each thread, innermost last: a sync is counted
# under the top of its own thread's stack.
_LIVE = threading.local()
# The sync watch: how many spans are live in the process, whether the
# outermost one set the debug mode (and restores it when the last one
# exits), and the warning hook that `_on_warning` replaced.
_SYNC_LOCK = make_lock("trace._SYNC_LOCK", 82)
_SYNC_DEPTH = 0
_SYNC_OURS = False
_SYNC_HOOKED = None
_SYNC_WARNING = "called a synchronizing CUDA operation"


def _live_stack() -> List[str]:
    stack = getattr(_LIVE, "stack", None)
    if stack is None:
        stack = _LIVE.stack = []
    return stack


def _on_warning(message, category, filename, lineno, file=None,
                line=None):
    """The warning hook: counts torch's sync reports under this
    thread's innermost live span, hides them while a span holds the
    debug mode, and hands every other warning to the hook it
    replaced."""
    if str(message).startswith(_SYNC_WARNING):
        stack = getattr(_LIVE, "stack", None)
        if stack:
            _sync_counter().inc(span=stack[-1])
        if _SYNC_OURS:
            return      # the mode is ours: nothing to show
    (_SYNC_HOOKED or warnings._showwarning_orig)(
        message, category, filename, lineno, file, line)


def _install_hook() -> None:
    """The hook and the ``always`` filter for sync reports, each put in
    place where it is missing (the first time, or after a
    ``warnings.catch_warnings`` exit restored what it found)."""
    global _SYNC_HOOKED
    if warnings.showwarning is not _on_warning:
        _SYNC_HOOKED = warnings.showwarning
        warnings.showwarning = _on_warning
    if not any(f[0] == "always" and f[1] is not None
               and f[1].pattern == _SYNC_WARNING for f in warnings.filters):
        warnings.filterwarnings("always", message=_SYNC_WARNING)


def _watch_syncs() -> None:
    """Entered by every live span: the outermost one turns torch's sync
    reports on (where CUDA is up and the mode is the default)."""
    global _SYNC_DEPTH, _SYNC_OURS
    with _SYNC_LOCK:
        _SYNC_DEPTH += 1
        if _SYNC_DEPTH > 1 or not torch.cuda.is_initialized():
            return
        _install_hook()
        if torch.cuda.get_sync_debug_mode() == 0:
            torch.cuda.set_sync_debug_mode("warn")
            _SYNC_OURS = True


def _unwatch_syncs() -> None:
    global _SYNC_DEPTH, _SYNC_OURS
    with _SYNC_LOCK:
        _SYNC_DEPTH -= 1
        if _SYNC_DEPTH or not _SYNC_OURS:
            return
        _SYNC_OURS = False
        torch.cuda.set_sync_debug_mode(0)


class span:
    """A named span (a context manager), live when the process tracer
    is enabled or a ``torch.profiler`` is recording (module docstring).
    Not live, the body runs alone. Live, it runs inside
    ``torch.profiler.record_function(name)``, is timed into the
    ``crdt_tpu_span_seconds`` histogram, counts its syncs into
    ``crdt_tpu_span_syncs_total`` and, with the tracer enabled, is
    emitted as an HLC-stamped ring event.

    A class rather than a generator: a span that is not live costs one
    object and two attribute reads, which the merge step pays once a
    stage."""

    __slots__ = ("name", "kind", "hlc", "fields", "_range", "_start")

    def __init__(self, name: str, kind: str = "span", hlc: Any = None,
                 **fields: Any):
        self.name = name
        self.kind = kind
        self.hlc = hlc
        self.fields = fields
        self._range = None

    def __enter__(self) -> None:
        if not (_DEFAULT.enabled or _autograd_profiler._is_profiler_enabled):
            return
        _live_stack().append(self.name)
        _watch_syncs()
        self._start = time.perf_counter()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()

    def __exit__(self, *exc: Any) -> None:
        rng, self._range = self._range, None
        if rng is None:
            return
        try:
            rng.__exit__(*exc)
        finally:
            dur = time.perf_counter() - self._start
            _unwatch_syncs()
            _live_stack().pop()
            _DEFAULT.emit(self.kind, hlc=self.hlc, span=self.name,
                          dur_s=dur, **self.fields)
            _span_histogram().observe(dur, span=self.name)
