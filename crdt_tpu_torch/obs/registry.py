"""Process-wide metrics registry: counters, gauges, log2 histograms,
and mergeable quantile sketches.

Design constraints, in order:

1. **The merge hot path stays lock-free.** `MergeStats` accumulates
   plain host ints (and lazy device scalars) exactly as before; it
   *attaches* to the registry as a weak-referenced collector and is
   only read at snapshot time. Registry locks are paid on scrape and
   on genuinely cold paths (gossip rounds, checkpoints, watch fanout),
   never per record.
2. **Thread-safe by declaration.** Every instrument and the registry
   itself guard their mutable state behind one lock each, declared via
   ``_CRDTLINT_GUARDED`` so the crdtlint lock-discipline rule enforces
   the contract statically.
3. **No global leak.** Collectors are held by ``weakref`` — a test
   that builds ten thousand replicas does not grow the registry past
   their lifetimes; dead entries are pruned on snapshot.

Histograms use **fixed log2 buckets**: bucket ``e`` counts
observations ``<= 2**e`` for ``e`` in a fixed exponent range, plus an
overflow bucket. Log-spaced bounds cover µs..minutes latencies with
~26 integers and merge trivially across processes (the bounds are the
same everywhere by construction).
"""

from __future__ import annotations

import bisect
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.concurrency import make_lock
from .sketch import (DEFAULT_MAX_BINS, DEFAULT_RELATIVE_ACCURACY,
                     QuantileSketch)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    # Single-label fast path: most hot-path series carry exactly one
    # label (span name, trigger, outcome), and the sorted() generator
    # round trip is pure overhead there — this sits under every
    # counter.inc/histogram.observe in the tree.
    if len(labels) == 1:
        for k, v in labels.items():
            return ((str(k), str(v)),)
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing counter with optional labels."""

    kind = "counter"

    # crdtlint lock-discipline contract (see module docstring).
    _CRDTLINT_GUARDED = {"_lock": ("_values",)}
    # analysis/concurrency.py: leaf singleton, nothing nests inside.
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = make_lock("Counter._lock", 90)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, amount: float = 1, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels: Any) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._values.get(key, 0)

    def samples(self) -> List[dict]:
        with self._lock:
            items = list(self._values.items())
        return [{"labels": dict(k), "value": v} for k, v in items]

    def _state(self) -> Dict[_LabelKey, float]:
        with self._lock:
            return dict(self._values)

    def _restore(self, state: Dict[_LabelKey, float]) -> None:
        with self._lock:
            self._values = dict(state)


class Gauge:
    """Point-in-time value with optional labels (set or add)."""

    kind = "gauge"

    _CRDTLINT_GUARDED = {"_lock": ("_values",)}
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = make_lock("Gauge._lock", 90)
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = value

    def add(self, amount: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels: Any) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._values.get(key, 0)

    def samples(self) -> List[dict]:
        with self._lock:
            items = list(self._values.items())
        return [{"labels": dict(k), "value": v} for k, v in items]

    def _state(self) -> Dict[_LabelKey, float]:
        with self._lock:
            return dict(self._values)

    def _restore(self, state: Dict[_LabelKey, float]) -> None:
        with self._lock:
            self._values = dict(state)


class Histogram:
    """Histogram over fixed log2 buckets.

    Bucket ``i`` counts observations ``<= 2**exponents[i]``; one extra
    overflow bucket catches the rest. The default range (2**-20 ..
    2**5 seconds, ~1 µs .. 32 s) suits the latencies this codebase
    emits; pass ``low_exp``/``high_exp`` for other units.
    """

    kind = "histogram"

    _CRDTLINT_GUARDED = {"_lock": ("_series",)}
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    def __init__(self, name: str, help: str = "",
                 low_exp: int = -20, high_exp: int = 5):
        if high_exp <= low_exp:
            raise ValueError("need high_exp > low_exp")
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(
            2.0 ** e for e in range(low_exp, high_exp + 1))
        self._lock = make_lock("Histogram._lock", 90)
        # label key -> [bucket counts (len(bounds)+1, last=overflow),
        #               total count, running sum]
        self._series: Dict[_LabelKey, list] = {}

    def observe(self, value: float, **labels: Any) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        key = _label_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = [[0] * (len(self.bounds) + 1), 0, 0.0]
                self._series[key] = series
            series[0][idx] += 1
            series[1] += 1
            series[2] += value

    def samples(self) -> List[dict]:
        with self._lock:
            items = [(k, [list(s[0]), s[1], s[2]])
                     for k, s in self._series.items()]
        return [{"labels": dict(k),
                 "buckets": [[b, c] for b, c in zip(self.bounds,
                                                    counts)],
                 "overflow": counts[len(self.bounds)],
                 "count": count, "sum": total}
                for k, (counts, count, total) in items]

    def _state(self) -> Dict[_LabelKey, list]:
        with self._lock:
            return {k: [list(s[0]), s[1], s[2]]
                    for k, s in self._series.items()}

    def _restore(self, state: Dict[_LabelKey, list]) -> None:
        with self._lock:
            self._series = {k: [list(s[0]), s[1], s[2]]
                            for k, s in state.items()}


class Sketch:
    """Labelled relative-error quantile sketch (obs/sketch.py).

    The histogram's complement, not its replacement: log2 buckets
    answer "how many under 2**e" cheaply, but their quantiles are
    bucket *ceilings* — a true p99 of 16 ms reads as 31.25 ms. A
    sketch series records the same observations into γ-indexed log
    buckets whose quantile estimates carry a configurable relative
    error (~1% default), merge commutatively/associatively across
    replicas, and so can gate an SLO envelope that does not sit on a
    power of two (docs/OBSERVABILITY.md).
    """

    kind = "sketch"

    _CRDTLINT_GUARDED = {"_lock": ("_series",)}
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    def __init__(self, name: str, help: str = "",
                 relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
                 max_bins: int = DEFAULT_MAX_BINS):
        self.name = name
        self.help = help
        self.relative_accuracy = float(relative_accuracy)
        self.max_bins = int(max_bins)
        self._lock = make_lock("Sketch._lock", 90)
        self._series: Dict[_LabelKey, QuantileSketch] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            sk = self._series.get(key)
            if sk is None:
                sk = QuantileSketch(self.relative_accuracy,
                                    self.max_bins)
                self._series[key] = sk
            sk.record(value)

    def quantile(self, q: float, **labels: Any) -> Optional[float]:
        """Per-series quantile; ``None`` when that label set has no
        observations (unmeasured ≠ zero)."""
        key = _label_key(labels)
        with self._lock:
            sk = self._series.get(key)
            return None if sk is None else sk.quantile(q)

    def merged(self) -> Optional[QuantileSketch]:
        """All label sets folded into one fresh sketch; ``None`` when
        the instrument has never observed."""
        with self._lock:
            sketches = [sk.copy() for sk in self._series.values()]
        out: Optional[QuantileSketch] = None
        for sk in sketches:
            out = sk if out is None else out.merge(sk)
        return out

    def samples(self) -> List[dict]:
        with self._lock:
            items = [(k, sk.copy()) for k, sk in self._series.items()]
        return [{"labels": dict(k), "count": sk.count, "sum": sk.sum,
                 "sketch": sk.to_dict()} for k, sk in items]

    def _state(self) -> Dict[_LabelKey, QuantileSketch]:
        with self._lock:
            return {k: sk.copy() for k, sk in self._series.items()}

    def _restore(self, state: Dict[_LabelKey, QuantileSketch]) -> None:
        with self._lock:
            self._series = {k: sk.copy() for k, sk in state.items()}


class MetricsRegistry:
    """Named instruments plus weak-referenced stat collectors.

    ``counter``/``gauge``/``histogram`` get-or-create by name (the
    same name always yields the same instrument; a kind clash raises).
    ``attach(kind, obj, **labels)`` registers any object exposing
    ``as_dict()`` as a collector — its live values land under
    ``snapshot()["stats"][kind]`` with the given labels. Collectors
    are weakly referenced and pruned once their owner is collected.
    """

    _CRDTLINT_GUARDED = {"_lock": ("_instruments", "_collectors")}
    # analysis/concurrency.py: scrape takes the registry lock, then
    # each instrument's — never the reverse (registry rank 86 orders
    # before the instruments' 90 under the runtime sanitizer).
    _CRDTLINT_LOCK_ORDER = ("_lock",)

    def __init__(self) -> None:
        self._lock = make_lock("MetricsRegistry._lock", 86)
        self._instruments: Dict[str, Any] = {}
        self._collectors: List[Tuple[str, Dict[str, str],
                                     weakref.ref]] = []

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"instrument {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  low_exp: int = -20, high_exp: int = 5) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   low_exp=low_exp, high_exp=high_exp)

    def sketch(self, name: str, help: str = "",
               relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
               max_bins: int = DEFAULT_MAX_BINS) -> Sketch:
        return self._get_or_create(Sketch, name, help,
                                   relative_accuracy=relative_accuracy,
                                   max_bins=max_bins)

    def attach(self, kind: str, obj: Any, *, replace: bool = False,
               **labels: Any) -> Any:
        """Register ``obj`` (anything with ``as_dict()``) as a live
        stats collector; returns ``obj`` for chaining. Weakly held.

        A ``(kind, label-set)`` pair identifies one exposition series.
        Attaching a second live collector under an already-live pair
        raises ``ValueError`` — duplicate label sets must never reach
        the Prometheus exposition, where they are undefined. Pass
        ``replace=True`` to supersede the prior entry instead: the
        restart idiom (a replica re-created under the same node id
        while the old object is still weakly reachable) keeps exactly
        one series, the newest. Entries whose referent died are always
        fair game for reuse.
        """
        label_map = {str(k): str(v) for k, v in labels.items()}
        key = (kind, _label_key(label_map))
        entry = (kind, label_map, weakref.ref(obj))
        with self._lock:
            kept = []
            for c in self._collectors:
                if c[2]() is None:
                    continue  # dead — prune opportunistically
                if (c[0], _label_key(c[1])) == key:
                    if not replace:
                        raise ValueError(
                            f"duplicate collector label set: "
                            f"kind={kind!r} labels={label_map!r} "
                            f"(pass replace=True to supersede)")
                    continue  # superseded by the new entry
                kept.append(c)
            kept.append(entry)
            self._collectors = kept
        return obj

    def snapshot(self) -> dict:
        """Self-describing JSON-safe snapshot of every instrument and
        every live collector. Dead collector entries are pruned."""
        with self._lock:
            instruments = list(self._instruments.values())
            collectors = list(self._collectors)
            self._collectors = [c for c in collectors
                                if c[2]() is not None]
        # "sketches" sits before "stats" so a wire layer that strips
        # it for a pre-sketch peer (net.py metrics op) leaves a dict
        # whose key order — hence serialized bytes — is identical to
        # what a pre-sketch server produced.
        out = {"counters": {}, "gauges": {}, "histograms": {},
               "sketches": {}, "stats": {}}
        section = {"counter": "counters", "gauge": "gauges",
                   "histogram": "histograms", "sketch": "sketches"}
        for inst in instruments:
            out[section[inst.kind]][inst.name] = inst.samples()
        for kind, labels, ref in collectors:
            obj = ref()
            if obj is None:
                continue
            try:
                values = obj.as_dict()
            except Exception:
                # A collector mid-teardown must not break the scrape.
                continue
            out["stats"].setdefault(kind, []).append(
                {"labels": labels, "values": values})
        return out


    def state_snapshot(self) -> Tuple[Dict[str, Any], List]:
        """Deep copy of every instrument's accumulated samples plus
        the collector list — pair with :meth:`restore_state` to fence
        a window of activity off from the rest of the process.

        The intended consumer is test isolation: the registry is a
        process-global, so (say) serve-tier ack latencies observed by
        one test module would otherwise leak into another module's
        fleet-poller SLO verdict, making outcomes depend on collection
        order. Instruments themselves are never dropped on restore —
        code holds direct references to them — only their sample state
        is rolled back (instruments born inside the window restore to
        empty)."""
        with self._lock:
            instruments = dict(self._instruments)
            collectors = list(self._collectors)
        return ({name: inst._state()
                 for name, inst in instruments.items()}, collectors)

    def restore_state(self, snap: Tuple[Dict[str, Any], List]) -> None:
        """Roll every instrument back to a :meth:`state_snapshot`.
        Instruments registered since the snapshot stay registered
        (cached references elsewhere must keep working) but lose their
        samples; collectors attached since are detached."""
        inst_state, collectors = snap
        with self._lock:
            instruments = dict(self._instruments)
            self._collectors = list(collectors)
        for name, inst in instruments.items():
            inst._restore(inst_state.get(name, {}))


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every in-tree instrument attaches to."""
    return _DEFAULT
