"""Mergeable relative-error quantile sketch (DDSketch-style).

The registry's log2 histograms answer quantile queries with *bucket
ceilings*: ``histogram_quantile`` on a sample whose true p99 is 16 ms
reports 31.25 ms, because 16 ms lands in the (15.625, 31.25] bucket
and the upper bound is all a fixed-bucket histogram can promise. Any
SLO envelope that does not sit exactly on a power of two — the
measured 14.6 ms SERVE_r01 ack envelope, say — is therefore
unexpressible as a histogram gate (docs/OBSERVABILITY.md).

:class:`QuantileSketch` fixes that with γ-indexed logarithmic buckets:
for relative accuracy ``α`` it uses ``γ = (1+α)/(1−α)`` and maps a
positive value ``v`` to bucket ``ceil(log_γ(v))``, so the bucket
midpoint estimate ``2·γ^k/(γ+1)`` is within ``α·v`` of every value in
the bucket. With the default α = 1% that is ~230 buckets per decade —
sparse dict storage keeps only the touched ones, and a collapsing
bound folds the *lowest* buckets together when the sketch grows past
``max_bins``, preserving upper-quantile (p99) accuracy exactly where
SLO gates look.

The sketch is deliberately CRDT-shaped:

- :meth:`merge` adds per-bucket counts — **commutative** and
  **associative** (collapse is canonical: lowest keys fold upward
  deterministically given the final bucket multiset), with the
  relative-error bound **preserved** across any merge order. The
  property obligations are executable: ``tests/test_sketch.py``
  checks the laws under 64-way merge permutations.
- Serialization is self-describing (:meth:`to_dict` for the JSON
  wire, :meth:`to_bytes` for compact binary) so per-replica sketches
  ship on the ``metrics`` op and fold into fleet-true quantiles in
  ``obs/fleet.py`` — the same delta/state composition discipline the
  store CRDTs follow.

Zero dependencies beyond the standard library; nothing here imports
JAX or the registry (the labelled ``Sketch`` instrument lives in
``obs/registry.py`` beside Counter/Gauge/Histogram).
"""

from __future__ import annotations

import math
import struct
from typing import Any, Dict, Iterable, List, Optional

DEFAULT_RELATIVE_ACCURACY = 0.01
DEFAULT_MAX_BINS = 512

# Compact binary frame: magic, relative accuracy, running sum, zero
# count, total count, number of sparse bins; then (key, count) pairs.
_HEADER = struct.Struct("<4sddQQI")
_BIN = struct.Struct("<qQ")
_MAGIC = b"QSK1"


class QuantileSketch:
    """Sparse γ-indexed log-bucket quantile sketch.

    ``relative_accuracy`` is the guaranteed bound: for any quantile
    that falls above the collapse region, the estimate ``m`` satisfies
    ``|m − v| ≤ relative_accuracy · v`` for the true order statistic
    ``v``. Values ``<= 0`` land in a dedicated zero bucket (latencies
    are non-negative; a clock that runs backwards should not crash the
    scrape path).
    """

    def __init__(self, relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
                 max_bins: int = DEFAULT_MAX_BINS):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError("relative_accuracy must be in (0, 1)")
        if max_bins < 2:
            raise ValueError("need max_bins >= 2")
        self.relative_accuracy = float(relative_accuracy)
        self.max_bins = int(max_bins)
        self.gamma = (1.0 + self.relative_accuracy) / \
                     (1.0 - self.relative_accuracy)
        self._log_gamma = math.log(self.gamma)
        self.bins: Dict[int, int] = {}
        self.zeros = 0
        self.count = 0
        self.sum = 0.0

    # --- recording ---

    def key_for(self, value: float) -> int:
        """Bucket key for a positive value: ``ceil(log_γ(v))`` — v in
        ``(γ^(k−1), γ^k]`` maps to k."""
        return int(math.ceil(math.log(value) / self._log_gamma
                             - 1e-12))

    def value_for(self, key: int) -> float:
        """Midpoint estimate for bucket ``key`` — within the relative
        accuracy of every value the bucket covers."""
        return 2.0 * self.gamma ** key / (self.gamma + 1.0)

    def record(self, value: float, count: int = 1) -> None:
        if count <= 0:
            return
        if value <= 0.0:
            self.zeros += count
        else:
            k = self.key_for(value)
            self.bins[k] = self.bins.get(k, 0) + count
        self.count += count
        self.sum += value * count
        if len(self.bins) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        # Fold the lowest buckets upward until the bound holds. The
        # fold direction is the whole trick: p50/p99 gates read the
        # top of the distribution, so accuracy is sacrificed only at
        # the bottom. Deterministic given the final bucket multiset,
        # which is what keeps merge order-independent.
        keys = sorted(self.bins)
        i = 0
        while len(keys) - i > self.max_bins:
            k0, k1 = keys[i], keys[i + 1]
            self.bins[k1] += self.bins.pop(k0)
            i += 1

    # --- queries ---

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (0 ≤ q ≤ 1); ``None`` when the
        sketch is empty (unmeasured ≠ zero)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        if self.count == 0:
            return None
        rank = q * (self.count - 1)
        cum = self.zeros
        if cum > rank:
            return 0.0
        last = 0.0
        for k in sorted(self.bins):
            cum += self.bins[k]
            last = self.value_for(k)
            if cum > rank:
                return last
        return last  # floating-point slack on rank; top bucket

    # --- merge (commutative, associative, error-preserving) ---

    def copy(self) -> "QuantileSketch":
        out = QuantileSketch(self.relative_accuracy, self.max_bins)
        out.bins = dict(self.bins)
        out.zeros = self.zeros
        out.count = self.count
        out.sum = self.sum
        return out

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into this sketch in place; returns ``self``.

        Requires matching γ (same ``relative_accuracy``) — merging
        differently-indexed sketches would silently discard the error
        bound, so it raises instead.
        """
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different relative "
                f"accuracy ({self.relative_accuracy} vs "
                f"{other.relative_accuracy})")
        for k, c in other.bins.items():
            self.bins[k] = self.bins.get(k, 0) + c
        self.zeros += other.zeros
        self.count += other.count
        self.sum += other.sum
        if len(self.bins) > self.max_bins:
            self._collapse()
        return self

    # --- serialization ---

    def to_dict(self) -> dict:
        """JSON-safe snapshot (rides the ``metrics`` wire op behind
        the negotiated ``sketch`` cap)."""
        return {"relative_accuracy": self.relative_accuracy,
                "max_bins": self.max_bins,
                "zeros": self.zeros,
                "count": self.count,
                "sum": self.sum,
                "bins": {str(k): c for k, c in self.bins.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        out = cls(float(d.get("relative_accuracy",
                              DEFAULT_RELATIVE_ACCURACY)),
                  int(d.get("max_bins", DEFAULT_MAX_BINS)))
        out.bins = {int(k): int(c)
                    for k, c in dict(d.get("bins", {})).items()}
        out.zeros = int(d.get("zeros", 0))
        out.count = int(d.get("count", 0))
        out.sum = float(d.get("sum", 0.0))
        return out

    def to_bytes(self) -> bytes:
        """Compact binary form (checkpoint / debug-bundle payloads)."""
        parts = [_HEADER.pack(_MAGIC, self.relative_accuracy,
                              self.sum, self.zeros, self.count,
                              len(self.bins))]
        for k in sorted(self.bins):
            parts.append(_BIN.pack(k, self.bins[k]))
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "QuantileSketch":
        if len(data) < _HEADER.size:
            raise ValueError("truncated sketch frame")
        magic, acc, total, zeros, count, n = _HEADER.unpack_from(data)
        if magic != _MAGIC:
            raise ValueError(f"bad sketch magic {magic!r}")
        need = _HEADER.size + n * _BIN.size
        if len(data) < need:
            raise ValueError("truncated sketch frame")
        out = cls(acc)
        off = _HEADER.size
        for _ in range(n):
            k, c = _BIN.unpack_from(data, off)
            out.bins[k] = out.bins.get(k, 0) + c
            off += _BIN.size
        out.zeros = zeros
        out.count = count
        out.sum = total
        return out

    def __repr__(self) -> str:  # debugging aid only
        return (f"QuantileSketch(acc={self.relative_accuracy}, "
                f"count={self.count}, bins={len(self.bins)})")


def merge_sketches(
        sketches: Iterable[QuantileSketch]) -> Optional[QuantileSketch]:
    """Merge an iterable of sketches into a fresh one (inputs are not
    mutated); ``None`` when the iterable is empty. The fleet-true
    roll-up: per-replica ack sketches fold into one sketch whose
    quantiles hold fleet-wide with the same relative-error bound."""
    out: Optional[QuantileSketch] = None
    for sk in sketches:
        if out is None:
            out = sk.copy()
        else:
            out.merge(sk)
    return out


def sketch_from_sample(sample: Any) -> Optional[QuantileSketch]:
    """Rebuild a sketch from one wire ``samples()`` entry (a dict with
    a ``"sketch"`` payload) or a raw ``to_dict`` payload. Returns
    ``None`` on anything malformed — a half-upgraded peer's snapshot
    must degrade to unmeasured, not break the poller."""
    if not isinstance(sample, dict):
        return None
    payload = sample.get("sketch", sample)
    if not isinstance(payload, dict) or "bins" not in payload:
        return None
    try:
        return QuantileSketch.from_dict(payload)
    except (TypeError, ValueError):
        return None


def sketch_quantile(samples: List[Any], q: float) -> Optional[float]:
    """Merged ``q``-quantile across wire sample entries (all label
    sets of one instrument, or one entry per replica). ``None`` when
    nothing parseable carries data — unmeasured ≠ zero."""
    merged = merge_sketches(
        sk for sk in (sketch_from_sample(s) for s in samples)
        if sk is not None and sk.count > 0)
    if merged is None:
        return None
    return merged.quantile(q)
