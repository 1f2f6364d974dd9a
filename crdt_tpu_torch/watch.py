"""Change-notification streams (C13 — watch/reactivity).

The reference exposes a Dart broadcast stream of ``MapEntry(key, value)``
change events (map_crdt.dart:11,27-39,48-49; contract crdt.dart:162-164).
This is the Python equivalent: a synchronous broadcast hub with
filterable subscriptions. The device model emits events host-side after
its kernel writes land — reactivity never lives inside a kernel.

Inside a `DenseCrdt.ingest()` window (models/ingest.py), staged writes
do NOT emit as they are staged: change events fire at COMMIT time, one
event per distinct slot carrying the winning post-dedup value. Ordering
across flushes follows commit order, which is also HLC order.

The port of ``crdt_tpu/watch.py``: the same hub, streams, async
bridge and the serving tier's `WatchIndex`, with the bridge's lock made
by `utils.concurrency.make_lock` under the JAX package's contract name
and rank; delivered events count in the registry's
``crdt_tpu_watch_events_total``.
"""

from __future__ import annotations

import asyncio
import weakref
from collections import deque
from typing import Any, Callable, List, NamedTuple, Optional

from .utils.concurrency import make_lock


# Change events delivered to live subscribers, process-wide. Created
# lazily, touched only when some stream is listening, so the
# nobody-watching bulk path stays free.
_WATCH_COUNTER = None


def _watch_counter():
    global _WATCH_COUNTER
    if _WATCH_COUNTER is None:
        from .obs.registry import default_registry
        _WATCH_COUNTER = default_registry().counter(
            "crdt_tpu_watch_events_total",
            "change events fanned out to live watch subscribers")
    return _WATCH_COUNTER


class ChangeEvent(NamedTuple):
    """A (key, value) change notification — value is None for deletes."""
    key: Any
    value: Any


_ANY_KEY = object()   # sentinel: stream not filtered to a single key


class _EventBatch(NamedTuple):
    """A recorded batch held UNMATERIALIZED in a stream buffer: a 1M
    merge with a recording subscriber must not allocate 1M ChangeEvent
    objects on the merge path — `events` expands batches on read."""
    keys: Any
    values: Any


class ChangeStream:
    """A filtered view over a :class:`ChangeHub`.

    Supports callback subscription (``listen``), buffered collection for
    tests (``record`` + ``events``), and further filtering (``where``).
    """

    def __init__(self, hub: "ChangeHub",
                 predicate: Optional[Callable[[ChangeEvent], bool]] = None,
                 key_filter: Any = _ANY_KEY):
        self._hub = hub
        self._predicate = predicate
        # A single-key stream keeps its key structurally so batch
        # emission can answer it in O(1) instead of scanning the batch.
        self._key_filter = key_filter
        self._buffer: List[Any] = []
        self._recording = False
        # Each subscription is a single-element list token so duplicate
        # callbacks unsubscribe independently.
        self._callbacks: List[List[Callable[[ChangeEvent], None]]] = []
        hub._streams.append(self)

    def _emit(self, event: ChangeEvent) -> None:
        if self._predicate is not None and not self._predicate(event):
            return
        if self._recording:
            self._buffer.append(event)
        for token in list(self._callbacks):
            token[0](event)

    def _emit_many(self, keys, values) -> None:
        """Batch emission: an unfiltered recording-only stream appends
        ONE batch marker (expanded by `events`); anything with a
        predicate or callbacks takes the per-event path."""
        if self._predicate is None and not self._callbacks:
            if self._recording:
                self._buffer.append(_EventBatch(keys, values))
            return
        for k, v in zip(keys, values):
            self._emit(ChangeEvent(k, v))

    def listen(self, callback: Callable[[ChangeEvent], None]
               ) -> Callable[[], None]:
        """Subscribe; returns an idempotent unsubscribe function. The
        last unsubscribe detaches the stream from its hub; a later
        listen() re-attaches."""
        if self not in self._hub._streams:
            self._hub._streams.append(self)
        token = [callback]
        self._callbacks.append(token)

        def unsubscribe() -> None:
            if token in self._callbacks:
                self._callbacks.remove(token)
                if not self._callbacks and not self._recording:
                    self.cancel()

        return unsubscribe

    def record(self) -> "ChangeStream":
        """Start buffering events into ``events`` (test helper)."""
        self._recording = True
        return self

    @property
    def events(self) -> List[ChangeEvent]:
        out: List[ChangeEvent] = []
        for item in self._buffer:
            if type(item) is _EventBatch:
                out.extend(map(ChangeEvent, item.keys, item.values))
            else:
                out.append(item)
        return out

    def where(self, predicate: Callable[[ChangeEvent], bool]
              ) -> "ChangeStream":
        prev = self._predicate
        combined = (predicate if prev is None
                    else (lambda e: prev(e) and predicate(e)))
        return ChangeStream(self._hub, combined)

    def cancel(self) -> None:
        if self in self._hub._streams:
            self._hub._streams.remove(self)

    def aiter(self) -> "AsyncChangeIterator":
        """Async iteration over future events (the Dart ``await for``
        shape). Call ``close()`` (or use ``async with``) to end it."""
        return AsyncChangeIterator(self)


class AsyncChangeIterator:
    """Bridges the synchronous ChangeHub to an ``async for`` consumer.

    Emission may happen on any thread; a lock serializes the
    pending-buffer → queue handoff, after which delivery is marshalled
    onto the consuming event loop with ``call_soon_threadsafe``. A
    dropped iterator detaches on garbage collection.
    """

    # crdtlint lock-discipline contract: the pending buffer is touched
    # only under self._lock (enforced by analysis.host_lint).
    _CRDTLINT_GUARDED = {"_lock": ("_pending",)}
    # Checked by analysis/concurrency.py: singleton leaf — no other
    # lock is ever taken inside the handoff critical section.
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    _CLOSE = object()

    def __init__(self, stream: ChangeStream):
        self._pending: deque = deque()
        self._queue: Optional[asyncio.Queue] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._lock = make_lock("AsyncChangeIterator._lock", 60)
        self._closed = False
        # Subscribe through a weak shim so the hub never keeps an
        # abandoned iterator alive.
        ref = weakref.ref(self)

        def shim(event, _ref=ref):
            it = _ref()
            if it is not None:
                it._on_event(event)

        self._unsubscribe = stream.listen(shim)

    def _on_event(self, event) -> None:
        with self._lock:
            if self._queue is None:
                self._pending.append(event)
                return
            loop, queue = self._loop, self._queue
        try:
            loop.call_soon_threadsafe(queue.put_nowait, event)
        except RuntimeError:
            pass  # consuming loop already closed; drop quietly

    def close(self) -> None:
        """Stop receiving; pending events still drain, then iteration
        raises StopAsyncIteration."""
        if self._closed:
            return
        self._closed = True
        self._unsubscribe()
        self._on_event(self._CLOSE)

    async def aclose(self) -> None:
        self.close()

    def __del__(self) -> None:
        if not getattr(self, "_closed", True):
            self._closed = True
            self._unsubscribe()

    def __aiter__(self) -> "AsyncChangeIterator":
        return self

    async def __anext__(self) -> ChangeEvent:
        if self._queue is None:
            # crdtlint: disable=async-blocking-call -- bounded handoff: the critical section is a few deque ops, and emitters never block inside it
            with self._lock:
                self._loop = asyncio.get_running_loop()
                self._queue = asyncio.Queue()
                while self._pending:
                    self._queue.put_nowait(self._pending.popleft())
        event = await self._queue.get()
        if event is self._CLOSE:
            raise StopAsyncIteration
        return event

    async def __aenter__(self) -> "AsyncChangeIterator":
        return self

    async def __aexit__(self, *exc) -> None:
        self.close()


class WatchIndex:
    """Slot-interest bookkeeping for the serving tier's push-on-flush
    fan-out (docs/FEDERATION.md): who subscribed to which slots, and —
    given the slots a flush tick touched — which watchers get the
    pack. Watchers are opaque handles (the serve loop uses session
    writer records); slot sets are held both ways so registration,
    removal and the per-tick interest query all stay proportional to
    the watcher's own subscriptions, never to the watcher count.

    Single-threaded by design: every call site lives on the tier's
    serve loop, matching the loop's no-lock threading model.
    """

    __slots__ = ("_by_slot", "_slots_of", "_all")

    def __init__(self) -> None:
        self._by_slot: dict = {}     # slot -> set of watchers
        self._slots_of: dict = {}    # watcher -> frozenset of slots
        self._all: set = set()       # whole-keyspace watchers

    def __len__(self) -> int:
        return len(self._slots_of) + len(self._all)

    @property
    def empty(self) -> bool:
        return not self._slots_of and not self._all

    def add(self, watcher, slots=None) -> None:
        """Register ``watcher`` for ``slots`` (an iterable of ints) or
        the whole keyspace (None). Re-adding replaces the previous
        subscription."""
        self.remove(watcher)
        if slots is None:
            self._all.add(watcher)
            return
        fs = frozenset(int(s) for s in slots)
        self._slots_of[watcher] = fs
        for s in fs:
            self._by_slot.setdefault(s, set()).add(watcher)

    def remove(self, watcher) -> None:
        """Idempotent deregistration (session close, backpressure
        shed)."""
        self._all.discard(watcher)
        fs = self._slots_of.pop(watcher, None)
        if fs:
            for s in fs:
                group = self._by_slot.get(s)
                if group is not None:
                    group.discard(watcher)
                    if not group:
                        del self._by_slot[s]

    def watchers(self) -> set:
        """Every live watcher regardless of slot interest — the set a
        partition retire must re-home (`ServeTier.rehome_watchers`)."""
        return self._all | set(self._slots_of)

    def touched(self, slots) -> set:
        """Watchers interested in ANY of ``slots`` — the fan-out set
        for one flush tick's pack. Whole-keyspace watchers are always
        included; slot-filtered watchers join via the per-slot index,
        so a tick touching k slots costs O(k + matches)."""
        out = set(self._all)
        by_slot = self._by_slot
        if by_slot:
            for s in slots:
                group = by_slot.get(int(s))
                if group:
                    out.update(group)
        return out


class ChangeHub:
    """Broadcast source owned by a storage backend."""

    def __init__(self) -> None:
        self._streams: List[ChangeStream] = []

    @property
    def active(self) -> bool:
        """True when some stream actually wants events (a live callback
        or an active recording) — lets bulk backends skip host emission
        entirely when nobody is listening."""
        return any(s._recording or s._callbacks for s in self._streams)

    def add(self, key: Any, value: Any) -> None:
        event = ChangeEvent(key, value)
        for stream in list(self._streams):
            stream._emit(event)
        if self.active:
            _watch_counter().inc()

    def add_batch(self, pairs,
                  get: Optional[Callable[[Any], tuple]] = None) -> None:
        """Emit a whole batch of (key, value) changes.

        Equivalent to ``add`` per pair, but ``pairs`` is ``(keys,
        values)`` or a zero-arg callable producing it, materialized at
        most once and ONLY if some stream needs the full batch —
        single-key-filtered streams are answered via ``get(key) ->
        (present, value)`` without touching it. ``get`` answers a key
        AT MOST ONCE per batch; callers whose batch may repeat a key
        must pass ``get=None``. Materialized batches may be RETAINED by
        recording streams, so callers hand over snapshots they will not
        mutate afterwards."""
        mat = None
        keyed_hits = 0
        for stream in list(self._streams):
            if not (stream._recording or stream._callbacks):
                continue   # no sink: never materialize on its behalf
            k = stream._key_filter
            if k is not _ANY_KEY and get is not None:
                present, v = get(k)
                if present:
                    stream._emit(ChangeEvent(k, v))
                    keyed_hits += 1
                continue
            if mat is None:
                mat = pairs() if callable(pairs) else pairs
            stream._emit_many(*mat)
        if mat is not None:
            _watch_counter().inc(len(mat[0]))
        elif keyed_hits:
            _watch_counter().inc(keyed_hits)

    def stream(self, key: Any = None) -> ChangeStream:
        if key is None:
            return ChangeStream(self)
        return ChangeStream(self, lambda e: e.key == key,
                            key_filter=key)
