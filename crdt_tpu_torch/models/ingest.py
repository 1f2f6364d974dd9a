"""Write-path fast lane: the host-side `WriteCombiner`.

Port of ``crdt_tpu/models/ingest.py``. Local writes coalesce the LSM
way and commit as ONE kernel launch:

- ``put_batch``/``delete_batch`` issued inside a ``DenseCrdt.ingest()``
  window append to growable columnar host buffers (slots/values/tombs)
  — no device work per call.
- At flush the whole backlog is stamped by ONE `Hlc.send_batch` (one
  wall read, one counter run; each staged call keeps its own strictly
  later stamp, so per-record order and putAll stamp-sharing survive).
- Duplicate staged slots collapse last-wins on the host (the last
  occurrence also carries the dominating stamp, so this IS the LWW
  outcome) — a CUDA scatter with duplicate indices has no defined
  winner. The same sort puts the kept rows in slot order.
- The commit is one `ops.ingest_kernel.ingest_scatter` launch over the
  rows in slot order, so a warp's stores land in neighbouring lines.

Read-your-writes: ``get``/``contains_slot``/``is_deleted`` consult the
staging overlay before the device store. Every other read, merge,
pack, serialization or snapshot path drains the combiner first
(`DenseCrdt.drain_ingest`), so nothing outside the window observes a
store missing staged writes.
"""

from __future__ import annotations

import time
from typing import Optional, TYPE_CHECKING

import numpy as np

from ..hlc import Hlc
from ..obs import device as _obs_device
from ..obs.trace import span

if TYPE_CHECKING:                       # pragma: no cover
    from .dense_crdt import DenseCrdt

_INITIAL_ROWS = 1024

# Flush-path instruments, resolved once per process (the default
# registry is a fixed singleton), as the JAX package resolves them.
_METRICS = None


def _metrics():
    global _METRICS
    if _METRICS is None:
        from ..obs.registry import default_registry
        reg = default_registry()
        _METRICS = (
            reg.counter("crdt_tpu_ingest_flush_total",
                        "write-combiner flushes by trigger"),
            reg.counter("crdt_tpu_ingest_flush_rows_total",
                        "rows committed by write-combiner flushes "
                        "(post-dedup)"),
            reg.counter("crdt_tpu_ingest_flush_groups_total",
                        "staged put/delete calls committed by flushes"),
            reg.histogram("crdt_tpu_ingest_flush_seconds",
                          "write-combiner flush wall time (stamp + "
                          "launch, no fence)"),
        )
    return _METRICS


class WriteCombiner:
    """Columnar staging buffers for one `DenseCrdt.ingest()` window.
    Not thread-safe: callers serialize like every other local write."""

    __slots__ = ("_owner", "_auto", "_slots", "_vals", "_tombs",
                 "_group", "_k", "_groups", "_pending", "flushes",
                 "rows_committed", "on_flush", "last_phase_seconds")

    def __init__(self, owner: "DenseCrdt", auto_flush_rows: int = 1 << 16):
        if auto_flush_rows < 1:
            raise ValueError(
                f"auto_flush_rows must be >= 1; got {auto_flush_rows}")
        self._owner = owner
        self._auto = auto_flush_rows
        cap = _INITIAL_ROWS
        self._slots = np.empty(cap, np.int64)
        self._vals = np.empty(cap, np.int64)
        self._tombs = np.empty(cap, bool)
        self._group = np.empty(cap, np.int64)
        self._k = 0          # staged rows
        self._groups = 0     # staged API calls (one HLC stamp each)
        # slot -> value-or-None (tombstone), LAST staged occurrence:
        # the read-your-writes overlay answers point reads in O(1).
        self._pending: dict = {}
        self.flushes = 0
        # Flush listener ``cb(trigger, rows, seconds)``, called after
        # every commit (a serving tier counts its ticks here). Listener
        # errors are swallowed: observability must never fail a commit.
        self.on_flush = None
        self.last_phase_seconds: dict = {}
        self.rows_committed = 0

    @property
    def pending_rows(self) -> int:
        """Rows staged and not yet committed."""
        return self._k

    @property
    def pending_groups(self) -> int:
        """Staged API calls awaiting their flush stamp."""
        return self._groups

    def _grow_to(self, need: int) -> None:
        cap = len(self._slots)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("_slots", "_vals", "_tombs", "_group"):
            old = getattr(self, name)
            grown = np.empty(cap, old.dtype)
            grown[:self._k] = old[:self._k]
            setattr(self, name, grown)

    def stage(self, slots: np.ndarray, values: np.ndarray,
              tombs: Optional[np.ndarray]) -> None:
        """Append one put/delete batch as a single stamp group. The
        owner has already validated slots and value width."""
        n = len(slots)
        k = self._k
        if n:
            self._grow_to(k + n)
            self._slots[k:k + n] = slots
            self._vals[k:k + n] = values
            self._tombs[k:k + n] = False if tombs is None else tombs
            self._group[k:k + n] = self._groups
            self._k = k + n
            # zip keeps order, so the LAST staged occurrence wins.
            if tombs is None:
                self._pending.update(zip(slots.tolist(), values.tolist()))
            else:
                vals_obj = values.astype(object)
                vals_obj[np.asarray(tombs, bool)] = None
                self._pending.update(zip(slots.tolist(),
                                         vals_obj.tolist()))
        # An EMPTY batch still counts as a group: the unbatched path
        # spends one send per call regardless.
        self._groups += 1
        if self._k >= self._auto:
            self.flush("auto")

    def pending_slot_array(self) -> np.ndarray:
        """The distinct staged slots (`DenseCrdt.count_modified_since`
        counts them: they commit at or after the canonical head)."""
        return np.fromiter(self._pending.keys(), np.int64,
                           count=len(self._pending))

    def pending_value(self, slot: int):
        """``(staged, value)`` for the overlay; ``value`` is None for a
        staged tombstone."""
        if slot in self._pending:
            return True, self._pending[slot]
        return False, None

    def flush(self, trigger: str = "explicit") -> bool:
        """Stamp and commit every staged row as ONE kernel launch.
        Returns True when a commit ran (False on an empty backlog). On a
        clock exception (drift/overflow from `Hlc.send_batch`) nothing
        is stamped or committed and the backlog stays staged.
        ``trigger`` labels the flush in the registry's counters
        (``"auto"``, ``"exit"``, ``"barrier"`` or ``"explicit"``)."""
        if self._groups == 0:
            return False
        owner = self._owner
        k = self._k
        node = str(owner.node_id)
        t0 = time.perf_counter()
        with span("ingest_flush", kind="ingest",
                  hlc=lambda: owner.canonical_time,
                  node=node, rows=k, trigger=trigger):
            new_canonical, group_lts = Hlc.send_batch(
                owner.canonical_time, self._groups,
                millis=owner._wall_clock())
            t_stamp = time.perf_counter()
            d = 0
            if k:
                slots = self._slots[:k]
                lt = np.asarray(group_lts, np.int64)[self._group[:k]]
                vals = self._vals[:k]
                tombs = self._tombs[:k]
                # The dedup's one sort also gives the slot order the
                # kernel's stores want; watch events keep staging order.
                keep, order = owner._last_wins_order(slots)
                d = len(order)
                owner._commit_scatter(slots, lt, vals, tombs, order)
            t_scatter = time.perf_counter()
            owner._canonical_time = new_canonical
            owner.stats.puts += self._groups
            owner.stats.records_put += k
            groups = self._groups
            self._k = 0
            self._groups = 0
            self._pending = {}
            self.flushes += 1
            self.rows_committed += d
            if d:
                self._emit_commit(slots, vals, tombs, keep)
        dt = time.perf_counter() - t0
        # The stamp and the commit's host time, which a serving tier's
        # ack-phase sketches read: the commit launches and returns, so
        # its time is the launch's, not the device's.
        self.last_phase_seconds = {"stamp": t_stamp - t0,
                                   "scatter": t_scatter - t_stamp}
        # Store-bytes census: lane nbytes is tensor metadata, no device
        # work; the commit is where the store's footprint last moved.
        _obs_device.census(owner._store)
        flushes_c, rows_c, groups_c, seconds_h = _metrics()
        flushes_c.inc(trigger=trigger, node=node)
        rows_c.inc(d, node=node)
        groups_c.inc(groups, node=node)
        seconds_h.observe(dt, node=node)
        cb = self.on_flush
        if cb is not None:
            try:
                cb(trigger, d, dt)
            except Exception:
                pass
        return True

    def _emit_commit(self, slots: np.ndarray, vals: np.ndarray,
                     tombs: np.ndarray, keep: Optional[np.ndarray]
                     ) -> None:
        """Change events fire AT COMMIT, with the winning post-dedup
        value per slot, in staging order (rows ``keep``, or all)."""
        hub = self._owner._hub
        if not hub.active:
            return
        if keep is not None:
            slots, vals, tombs = slots[keep], vals[keep], tombs[keep]
        sl = slots.tolist()
        # A typed slot's event carries what its reads return, decoded.
        decode = self._owner._watch_decode
        svals = [None if t else decode(s, v)
                 for s, v, t in zip(sl, vals.tolist(), tombs.tolist())]
        pos = {s: i for i, s in enumerate(sl)}
        # crdtlint: disable=add-batch-unique-keys -- slots are deduplicated last-wins by flush() before reaching here, so the batch repeats no key
        hub.add_batch(lambda: (sl, svals),
                      lambda q: ((True, svals[pos[q]])
                                 if isinstance(q, (int, np.integer))
                                 and q in pos else (False, None)))
