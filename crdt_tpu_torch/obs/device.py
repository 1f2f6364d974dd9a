"""Kernel launch counters and the dispatch ledger.

Two records of the device work, kept apart on purpose.

The launch counters (`KERNELS`, `note_launch`, `launches`) hold what a
run needs to prove that its main path went through the hand-written
kernels: one plain integer per kernel, bumped by the kernel's wrapper
where it launches (never by the plain torch version the wrapper takes
for CPU tensors). ``chip_smoke.py`` zeroes the counts before it drives
the main path and reads them after. The K1 kernel is counted under two
names: as ``fanin_batch`` on the unsharded merge, and as
``fanin_batch_sharded`` where the sharded step (`parallel.fanin`)
launches it over a device's blocks, once per device per merge. The
fan-in tail (K1t, `ops.fanin_tail`), in K1's source, counts as
``fanin_tail``, once a merge it ends. The four kernel probes
(`ops.probe`) count under their source names.

`OPS` counts, beside them, the plain-torch ops of the anti-entropy and
storage plane, of the typed joins, of the general-key `ops.merge.Store`
and of the collective group join (the JAX package runs them through
XLA, not Pallas, and no hand kernel replaces them): each digest-tree
build, range delta mask, GC purge and compaction remap, each typed
wire, sparse and fan-in join step, each `merge_step`, `scatter_put`,
`max_logical_time` and `delta_mask`, and each group join
(``parallel.collective_join``), on any device. A cached
``digest_tree()`` counts nothing, which is how a run shows that a tree
came from the cache.

The dispatch ledger (`DispatchLedger`, `default_ledger`, `record`) is
the port of ``crdt_tpu/obs/device.py``'s: every device entry point of
the ops, the fan-in wrappers, the digest, the sharded and collective
steps and the typed joins reports each dispatch under the JAX
package's name, into the same registry series
(``crdt_tpu_device_dispatches_total{kernel}``,
``crdt_tpu_device_dispatch_seconds{kernel}``,
``crdt_tpu_device_compiles_total{kernel,bucket}``,
``crdt_tpu_device_donation_violations_total{kernel}`` and the
``crdt_tpu_store_bytes{backend}`` census gauge). A plain torch route
records the name JAX's XLA route records (``dense.ingest_scatter``,
``dense.fanin_step``, ...); a hand-kernel launch records the Pallas
entry it replaces (``pallas.ingest_scatter_tiles``,
``pallas.model_fanin_batch``, ``pallas.model_fanin_split``, ...), so
the ledger's invariants read the same on both packages: a flush tick
with rows is exactly one commit scatter, a pack-cache hit is zero.
One call records one name, never both: each entry point opens one
``with record(...)`` and calls unrecorded bodies inside it (a wrapper
whose plain route is a recorded op leaves the record to that op; the
sharded steps' per-block loops call the bodies), so the outermost
entry point is the one dispatch, as one jitted program is in the JAX
package. Torch has no buffer donation
(a commit writes its lanes in place), so the donation-violation
counter is registered and never rises.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ..utils.concurrency import make_lock
from .registry import MetricsRegistry, default_registry

KERNELS = ("fanin_batch", "ingest_scatter", "fanin_split", "fanin_stream",
           "fanin_batch_sharded", "probe_join", "probe_copy",
           "probe_stream_noguard", "probe_copy_batch", "fanin_tail")

OPS = ("digest_tree", "range_delta_mask", "gc_purge", "compact_remap",
       "typed_wire_join_step", "typed_sparse_join_step",
       "typed_fanin_step", "merge_step", "scatter_put",
       "max_logical_time", "delta_mask", "parallel.collective_join")

_LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_OPS: Dict[str, int] = dict.fromkeys(OPS, 0)


def note_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (a `KERNELS` entry)."""
    _LAUNCHES[name] += 1


def note_op(name: str) -> None:
    """Count one call of plain op ``name`` (an `OPS` entry)."""
    _OPS[name] += 1


def launches() -> Dict[str, int]:
    """Launch count per kernel since the last `reset`."""
    return dict(_LAUNCHES)


def op_launches() -> Dict[str, int]:
    """Call count per plain op since the last `reset`."""
    return dict(_OPS)


def reset() -> None:
    for counts in (_LAUNCHES, _OPS):
        for name in counts:
            counts[name] = 0


def _backend(store) -> str:
    """The census gauge's ``backend`` label for the device a store's
    lanes live on, in the JAX package's words (``"cpu"``, ``"gpu"``)."""
    for lane in store:
        dev = getattr(lane, "device", None)
        if dev is not None:
            return "gpu" if dev.type == "cuda" else dev.type
    return "cpu"


def pow2_bucket(dim: Optional[int]) -> str:
    """The compile-census bucket label for a leading batch dim: the
    pow2 ceiling (the shape ladder callers pad onto), or ``"scalar"``
    for kernels with no size-varying dim."""
    if dim is None:
        return "scalar"
    d = max(int(dim), 1)
    return str(1 << (d - 1).bit_length())


class DispatchLedger:
    """Per-kernel dispatch accounting over one `MetricsRegistry`.

    Thread-safe: merges, gossip rounds and serving-tier flushes
    dispatch from different threads into the same ledger.
    """

    # Lock-discipline contract, read by the crdtlint analyzers.
    _CRDTLINT_GUARDED = {"_lock": ("_counts", "_compiled", "_registered")}
    # The ledger lock releases before the metric incs (`_dispatch`), so
    # nothing ever nests inside it.
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry if registry is not None \
            else default_registry()
        self._lock = make_lock("DispatchLedger._lock", 84)
        self._counts: Dict[str, int] = {}    # kernel -> dispatches
        self._compiled: set = set()          # (kernel, bucket) seen
        self._registered: set = set()        # kernel names declared
        self._metrics = None
        # Plain attribute, read unlocked on the hot path: toggling is a
        # coarse A/B switch (overhead measurement), not a
        # synchronization point.
        self.enabled = True

    def _instruments(self):
        m = self._metrics
        if m is None:
            reg = self._registry
            m = self._metrics = (
                reg.counter("crdt_tpu_device_dispatches_total",
                            "device dispatches by kernel entry point"),
                reg.histogram("crdt_tpu_device_dispatch_seconds",
                              "dispatching host-call wall time by "
                              "kernel (enqueue + host prep; async on "
                              "accelerators)"),
                reg.counter("crdt_tpu_device_compiles_total",
                            "first-call events per (kernel, pow2 size "
                            "bucket) — the compile census"),
                # Registered for the series' sake; never incremented:
                # torch has no buffer donation to violate.
                reg.counter("crdt_tpu_device_donation_violations_total",
                            "donated inputs still live after a "
                            "donating dispatch (TPU/GPU only)"),
                reg.gauge("crdt_tpu_store_bytes",
                          "store-lane bytes at the last reported "
                          "commit/merge, by backend"),
            )
        return m

    # --- registration (the crdtlint completeness surface) ---

    def register(self, *kernels: str) -> None:
        """Declare kernel entry points as ledger-instrumented. Called
        at module import of the instrumented module, so coverage can be
        checked without dispatching anything."""
        with self._lock:
            self._registered.update(kernels)

    def registered_kernels(self) -> frozenset:
        with self._lock:
            return frozenset(self._registered)

    # --- reads (tests and invariant probes) ---

    def dispatches(self, kernel: Optional[str] = None) -> int:
        """Host-side dispatch count for one kernel, or the total over
        every kernel — the number a zero-dispatch invariant probe
        snapshots before and after the operation under test."""
        with self._lock:
            if kernel is not None:
                return self._counts.get(kernel, 0)
            return sum(self._counts.values())

    def as_dict(self) -> dict:
        with self._lock:
            return dict(self._counts)

    # --- recording ---

    def record(self, kernel: str, dim: Optional[int] = None,
               donated=None):
        """Context manager timing ONE dispatch of ``kernel``.

        ``dim`` is the leading batch dim (bucketed to its pow2 ceiling
        for the census: the first call into a bucket is the one that
        builds a kernel or warms an allocator). ``donated`` is accepted
        for the JAX signature and ignored: torch donates no buffer."""
        if not self.enabled:
            return _NULL_RECORD
        return _Record(self, kernel, dim, donated)

    def _dispatch(self, kernel: str, seconds: float,
                  dim: Optional[int], donated) -> None:
        bucket = pow2_bucket(dim)
        disp_c, disp_h, comp_c, _, _ = self._instruments()
        first = False
        with self._lock:
            self._counts[kernel] = self._counts.get(kernel, 0) + 1
            if (kernel, bucket) not in self._compiled:
                self._compiled.add((kernel, bucket))
                first = True
        disp_c.inc(kernel=kernel)
        disp_h.observe(seconds, kernel=kernel)
        if first:
            comp_c.inc(kernel=kernel, bucket=bucket)

    # --- store census ---

    def census(self, store) -> int:
        """Report a store's lane bytes to the per-backend gauge.
        ``store`` is any NamedTuple of tensors (`DenseStore` & friends);
        ``nbytes`` is tensor metadata, so this costs no device work."""
        nbytes = 0
        for lane in store:
            nbytes += int(getattr(lane, "nbytes", 0) or 0)
        if self.enabled:
            self._instruments()[4].set(float(nbytes),
                                       backend=_backend(store))
        return nbytes


class _Record:
    __slots__ = ("_ledger", "_kernel", "_dim", "_donated", "_t0")

    def __init__(self, ledger: DispatchLedger, kernel: str,
                 dim: Optional[int], donated):
        self._ledger = ledger
        self._kernel = kernel
        self._dim = dim
        self._donated = donated

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._ledger._dispatch(self._kernel,
                                   time.perf_counter() - self._t0,
                                   self._dim, self._donated)
        return False


class _NullRecord:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_RECORD = _NullRecord()

_DEFAULT_LEDGER = DispatchLedger()


def default_ledger() -> DispatchLedger:
    """The process-wide ledger every instrumented entry point reports
    to (same singleton discipline as `default_registry`)."""
    return _DEFAULT_LEDGER


def register(*kernels: str) -> None:
    _DEFAULT_LEDGER.register(*kernels)


def record(kernel: str, dim: Optional[int] = None, donated=None):
    """Module-level fast path for instrumented call sites: resolves
    the singleton once and short-circuits to a shared no-op context
    manager when the ledger is disabled."""
    led = _DEFAULT_LEDGER
    if not led.enabled:
        return _NULL_RECORD
    return led.record(kernel, dim, donated)


def census(store) -> int:
    return _DEFAULT_LEDGER.census(store)

