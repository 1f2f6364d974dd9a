"""Observability of the port.

- `device`: the hand-written kernels' launch counters and the plain
  ops' call counters, which ``chip_smoke.py`` reads;
- the host observability the wire serves, copied from
  ``crdt_tpu/obs/``: the process-wide metrics `registry` (counters,
  gauges, log2 histograms, quantile sketches) whose snapshot the
  ``metrics`` op returns, the `trace` ring and its spans (a
  ``torch.profiler.record_function`` range each while the ring is on
  or a profiler records, timed, with the syncs inside counted), the flight
  `recorder` behind ``debug_dump``, the gossip `lag` helpers and the
  canary `probe`;
- the rendering of what they hold, copied too: the Prometheus and
  human `render` ers and the trace summary, the `fleet` poller's lag
  matrix, SLO verdict and federation exposition, and the bench
  `trajectory`; ``python -m crdt_tpu_torch.obs`` drives them (`cli`).
"""

from __future__ import annotations

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       Sketch, default_registry)
from .sketch import QuantileSketch, merge_sketches, sketch_quantile
from .recorder import FlightRecorder, default_recorder
from .trace import TraceRing, round_id, span, tracer
from .lag import health_status, lag_entry, lag_millis
from .probe import CanaryProbe, canary_observed
from .fleet import (evaluate_slo, format_matrix, lag_matrix,
                    poll_fleet, render_federation)
from .device import DispatchLedger, default_ledger, pow2_bucket
from .trajectory import (append_record, compare, load_trajectory,
                         normalize_record)
from .render import (format_phase_table, render_prometheus,
                     render_summary, summarize_trace)


def metrics_snapshot() -> dict:
    """One self-describing snapshot of the process-wide registry — the
    payload the `SyncServer` ``metrics`` wire op returns."""
    return default_registry().snapshot()


__all__ = [
    "Counter", "Gauge", "Histogram", "Sketch", "MetricsRegistry",
    "default_registry", "metrics_snapshot",
    "QuantileSketch", "merge_sketches", "sketch_quantile",
    "FlightRecorder", "default_recorder",
    "TraceRing", "tracer", "span", "round_id",
    "lag_millis", "lag_entry", "health_status",
    "CanaryProbe", "canary_observed",
    "poll_fleet", "lag_matrix", "evaluate_slo", "render_federation",
    "format_matrix",
    "DispatchLedger", "default_ledger", "pow2_bucket",
    "normalize_record", "append_record", "load_trajectory", "compare",
    "render_prometheus", "render_summary", "summarize_trace",
    "format_phase_table",
]
