"""Rendering: registry snapshots → Prometheus text / human summary,
trace JSONL → per-phase latency table.

Copied from ``crdt_tpu/obs/render.py``: the same text, byte for byte,
from the same snapshots.

Everything here is pure (dicts in, strings out) so the CLI, tests and
any embedding service render identically. The snapshot shape is the
one :meth:`obs.registry.MetricsRegistry.snapshot` produces,
optionally extended by the `SyncServer` ``metrics`` op with ``node``
(identity) and ``lag`` (per-peer staleness) sections.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List

from .sketch import sketch_from_sample

# Sketch series render as Prometheus summary quantiles at these
# points — the tails SLO gates read, plus the median.
_SKETCH_QUANTILES = (0.5, 0.9, 0.99)

# stats-collector kinds → Prometheus metric family prefixes. The
# legacy dataclasses expose as_dict() fields; each numeric field
# becomes one family: e.g. MergeStats.merges (kind "merge") renders as
# crdt_tpu_merge_merges_total{backend=...,node=...}.
_STATS_PREFIX = {
    "merge": ("crdt_tpu_merge_", "_total"),
    "peer_sync": ("crdt_tpu_peer_", "_total"),
    "wire": ("crdt_tpu_wire_", "_bytes_total"),
}


def _esc(value: Any) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(value: float) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int) or (isinstance(value, float)
                                  and value.is_integer()):
        return str(int(value))
    return repr(float(value))


def render_prometheus(snapshot: Dict[str, Any]) -> str:
    """Prometheus text exposition (v0.0.4) of a metrics snapshot."""
    lines: List[str] = []

    for name, samples in sorted(snapshot.get("counters", {}).items()):
        lines.append(f"# TYPE {name} counter")
        for s in samples:
            lines.append(f"{name}{_labels(s['labels'])} "
                         f"{_fmt(s['value'])}")
    for name, samples in sorted(snapshot.get("gauges", {}).items()):
        lines.append(f"# TYPE {name} gauge")
        for s in samples:
            lines.append(f"{name}{_labels(s['labels'])} "
                         f"{_fmt(s['value'])}")
    for name, samples in sorted(
            snapshot.get("histograms", {}).items()):
        lines.append(f"# TYPE {name} histogram")
        for s in samples:
            cum = 0
            for bound, count in s["buckets"]:
                cum += count
                labels = dict(s["labels"], le=f"{bound:.9g}")
                lines.append(f"{name}_bucket{_labels(labels)} {cum}")
            cum += s.get("overflow", 0)
            labels = dict(s["labels"], le="+Inf")
            lines.append(f"{name}_bucket{_labels(labels)} {cum}")
            lines.append(f"{name}_count{_labels(s['labels'])} "
                         f"{s['count']}")
            lines.append(f"{name}_sum{_labels(s['labels'])} "
                         f"{_fmt(s['sum'])}")
    # Quantile sketches expose as summaries: unlike the log2
    # histogram families above (whose quantiles are bucket ceilings),
    # these carry the sketch's relative-error bound — the series a
    # dashboard should alert on (docs/OBSERVABILITY.md).
    for name, samples in sorted(snapshot.get("sketches", {}).items()):
        lines.append(f"# TYPE {name} summary")
        for s in samples:
            sk = sketch_from_sample(s)
            if sk is not None and sk.count > 0:
                for q in _SKETCH_QUANTILES:
                    labels = dict(s["labels"], quantile=f"{q:g}")
                    lines.append(f"{name}{_labels(labels)} "
                                 f"{_fmt(sk.quantile(q))}")
            lines.append(f"{name}_count{_labels(s['labels'])} "
                         f"{s['count']}")
            lines.append(f"{name}_sum{_labels(s['labels'])} "
                         f"{_fmt(s['sum'])}")

    for kind, entries in sorted(snapshot.get("stats", {}).items()):
        prefix, suffix = _STATS_PREFIX.get(
            kind, (f"crdt_tpu_{kind}_", ""))
        for entry in entries:
            for field, value in entry["values"].items():
                if not isinstance(value, (int, float)) \
                        or isinstance(value, bool):
                    continue
                lines.append(f"{prefix}{field}{suffix}"
                             f"{_labels(entry['labels'])} "
                             f"{_fmt(value)}")

    node = snapshot.get("node")
    lag = snapshot.get("lag")
    node_label = ({} if not isinstance(node, dict)
                  else {"node": node.get("node_id", "")})
    if isinstance(lag, dict):
        for peer, entry in sorted(lag.items()):
            labels = dict(node_label, peer=peer)
            lines.append(f"crdt_tpu_peer_synced{_labels(labels)} "
                         f"{1 if entry.get('synced') else 0}")
            if entry.get("lag_ms") is not None:
                lines.append(
                    f"crdt_tpu_peer_lag_millis{_labels(labels)} "
                    f"{_fmt(entry['lag_ms'])}")
            if entry.get("seconds_behind") is not None:
                lines.append(
                    f"crdt_tpu_peer_seconds_behind"
                    f"{_labels(labels)} "
                    f"{_fmt(entry['seconds_behind'])}")
            if entry.get("pending_records") is not None:
                lines.append(
                    f"crdt_tpu_peer_pending_records"
                    f"{_labels(labels)} "
                    f"{_fmt(entry['pending_records'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def _table(headers: List[str], rows: List[List[str]]) -> List[str]:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows
              else len(h) for i, h in enumerate(headers)]
    out = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for row in rows:
        out.append("  ".join(c.ljust(w)
                             for c, w in zip(row, widths)))
    return out


def render_summary(snapshot: Dict[str, Any]) -> str:
    """Compact human-readable summary of a metrics snapshot — the
    default ``python -m crdt_tpu_torch.obs`` output."""
    lines: List[str] = []
    node = snapshot.get("node")
    if isinstance(node, dict):
        lines.append(f"node {node.get('node_id')}  "
                     f"head={node.get('hlc_head')}")

    lag = snapshot.get("lag")
    if isinstance(lag, dict) and lag:
        rows = []
        for peer, e in sorted(lag.items()):
            rows.append([
                peer,
                "-" if e.get("lag_ms") is None else str(e["lag_ms"]),
                "-" if e.get("pending_records") is None
                else str(e["pending_records"]),
                str(e.get("breaker") or "-"),
                "dense" if e.get("dense") else "json",
                "yes" if e.get("synced") else "NEVER",
            ])
        lines.append("")
        lines.extend(_table(
            ["peer", "lag_ms", "pending", "breaker", "wire",
             "synced"], rows))

    stats = snapshot.get("stats", {})
    merge = stats.get("merge", [])
    if merge:
        rows = []
        for entry in merge:
            lbl = entry["labels"]
            v = entry["values"]
            rows.append([
                str(lbl.get("backend", "?")),
                str(lbl.get("node", "?")),
                str(v.get("merges", 0)),
                str(v.get("records_seen", 0)),
                str(v.get("records_adopted", 0)),
                str(v.get("puts", 0)),
                str(v.get("records_put", 0)),
            ])
        lines.append("")
        lines.extend(_table(
            ["backend", "node", "merges", "seen", "adopted", "puts",
             "recs_put"], rows))

    peers = stats.get("peer_sync", [])
    if peers:
        rows = []
        for entry in peers:
            lbl = entry["labels"]
            v = entry["values"]
            rows.append([
                str(lbl.get("peer", "?")),
                str(v.get("rounds_ok", 0)),
                str(v.get("rounds_failed", 0)),
                str(v.get("retries", 0)),
                str(v.get("bytes_sent", 0)),
                str(v.get("bytes_received", 0)),
            ])
        lines.append("")
        lines.extend(_table(
            ["peer", "ok", "failed", "retries", "tx_bytes",
             "rx_bytes"], rows))

    wire = stats.get("wire", [])
    if wire:
        lines.append("")
        for entry in wire:
            lbl = entry["labels"]
            v = entry["values"]
            lines.append(f"wire[{lbl.get('role', '?')}] "
                         f"sent={v.get('sent', 0)}B "
                         f"received={v.get('received', 0)}B")
    return "\n".join(lines) + ("\n" if lines else "")


def _percentile(sorted_values: List[float], q: float) -> float:
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1,
              max(0, math.ceil(q * len(sorted_values)) - 1))
    return sorted_values[idx]


def summarize_trace(events: Iterable[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, float]]:
    """Aggregate span-shaped trace events (those carrying ``dur_s``)
    into per-phase latency stats. The phase key is the event's
    ``span`` name when present, else its ``kind``."""
    groups: Dict[str, List[float]] = {}
    for event in events:
        dur = event.get("dur_s")
        if dur is None:
            continue
        phase = event.get("span") or event.get("kind", "?")
        groups.setdefault(str(phase), []).append(float(dur))
    out: Dict[str, Dict[str, float]] = {}
    for phase, durs in groups.items():
        durs.sort()
        out[phase] = {
            "count": len(durs),
            "total_s": sum(durs),
            "mean_s": sum(durs) / len(durs),
            "p50_s": _percentile(durs, 0.50),
            "p95_s": _percentile(durs, 0.95),
            "max_s": durs[-1],
        }
    return out


def format_phase_table(summary: Dict[str, Dict[str, float]]) -> str:
    """Fixed-width per-phase latency table from `summarize_trace`."""
    if not summary:
        return "no span events\n"
    rows = []
    for phase in sorted(summary,
                        key=lambda p: -summary[p]["total_s"]):
        s = summary[phase]
        rows.append([phase, str(int(s["count"])),
                     f"{s['total_s']:.6f}", f"{s['mean_s']:.6f}",
                     f"{s['p50_s']:.6f}", f"{s['p95_s']:.6f}",
                     f"{s['max_s']:.6f}"])
    return "\n".join(_table(
        ["phase", "count", "total_s", "mean_s", "p50_s", "p95_s",
         "max_s"], rows)) + "\n"
