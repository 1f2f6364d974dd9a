"""Fleet evaluation: N replicas' ``metrics`` ops → lag matrix + SLO verdict.

Port of ``crdt_tpu/obs/fleet.py``: the same pure functions over the
same snapshot dicts, so a fleet of this package's tiers is judged and
rendered exactly as the JAX package judges and renders its own —
``python -m crdt_tpu_torch.obs fleet --peers a=h:p,b=h:p [--once]``
scrapes the ``metrics`` wire op across the fleet.

- **Lag matrix** — per-(origin, observer) end-to-end replication lag
  from the canary beats (`obs.probe`):
  ``lag_s[origin][observer] = (newest_beat(origin) −
  observed(observer)[origin]) / 1000``. ``None`` marks a pair where
  the observer has never seen that origin's canary; ``complete`` is
  True only when every (origin, observer) pair has a value.
- **SLO verdict** — a machine-readable pass/fail over the budgets:
  serve ack p99 (`crdt_tpu_serve_ack_seconds`, or its sketch twin),
  worst convergence lag (the matrix), shed writes
  (`crdt_tpu_serve_shed_total` == 0), topology-change progress, and
  replica-group primary liveness (every group visible in any
  snapshot's ``replication`` section must have a reachable member
  claiming ``role == "primary"``). Each check is ``{"value",
  "budget", "ok"}`` with ``ok=None`` when the fleet exposes no data
  for it (not measured ≠ passed ≠ failed); the top-level ``ok``
  requires every *measured* check to pass.
- **Replica health** — per-group role/lease/head roll-up from the
  ``replication`` sections (`replica_health`).

Everything below `poll_fleet` is pure (dicts in, dicts out), so
in-process soaks feed `lag_matrix` / `evaluate_slo` directly from
replica snapshots without sockets.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from .render import _fmt, _labels, _table
from .sketch import QuantileSketch, merge_sketches, sketch_from_sample

# Default budgets, the JAX package's own, kept equal so both packages
# return the same verdict on the same snapshots: a serve ack p99
# budget, a convergence budget loose enough for WAN gossip but tight
# enough to catch a wedged peer, and a topology-change progress budget
# (a split/merge whose progress stamp stalls longer than this holds the
# federation's control lock and has frozen the scale loop).
ACK_P99_BUDGET_S = 0.00425
CONVERGENCE_BUDGET_S = 5.0
TOPOLOGY_STALL_BUDGET_S = 30.0

# The ack envelope the sketch-backed autoscaler probe gates on
# (autoscale.py), again the JAX package's default. Unexpressible as a
# log2 histogram gate (the nearest bucket ceilings are 7.8 ms and
# 15.6 ms), hence the sketch.
SERVE_ACK_ENVELOPE_S = 0.0146

# Instrument names the ack SLO check reads: the log2 histogram (bucket
# ceilings; every fleet exposes it) and its sketch twin (relative-
# error quantiles; fleets behind the `sketch` hello cap).
ACK_HIST_NAME = "crdt_tpu_serve_ack_seconds"
ACK_SKETCH_NAME = "crdt_tpu_serve_ack_seconds_sketch"


def parse_peers(spec: str) -> List[Tuple[str, str, int]]:
    """``"a=host:1234,b=host:1235"`` (or bare ``host:port``) →
    ``[(name, host, port), ...]``."""
    peers = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, addr = part.rpartition("=")
        host, _, port = addr.rpartition(":")
        if not host or not port:
            raise ValueError(f"peer {part!r} is not [name=]host:port")
        peers.append((name or addr, host, int(port)))
    return peers


def poll_fleet(peers: List[Tuple[str, str, int]],
               timeout: float = 5.0) -> Dict[str, dict]:
    """Scrape each peer's ``metrics`` op. Unreachable peers map to
    ``{"_scrape_error": "..."}`` — the matrix and verdict treat them
    as observers that saw nothing."""
    # Lazy: obs stays importable below net (cli.py contract).
    from ..net import SyncError, fetch_metrics
    out: Dict[str, dict] = {}
    for name, host, port in peers:
        try:
            out[name] = fetch_metrics(host, port, timeout=timeout)
        except (SyncError, OSError) as exc:
            out[name] = {"_scrape_error":
                         f"{type(exc).__name__}: {exc}"}
    return out


def _okey(origin: str):
    return (0, int(origin)) if origin.isdigit() else (1, origin)


def lag_matrix(snapshots: Dict[str, dict]) -> Dict[str, Any]:
    """Per-(origin, observer) replication lag from the ``canary``
    sections of scraped (or in-process) metrics snapshots. Pure."""
    canaries: Dict[str, dict] = {}
    for name, snap in snapshots.items():
        if not isinstance(snap, dict):
            continue
        can = snap.get("canary")
        if isinstance(can, dict) and isinstance(can.get("observed"),
                                                dict):
            canaries[name] = can
    observers = sorted(canaries)
    origin_peers: Dict[str, str] = {}
    newest: Dict[str, int] = {}
    for name, can in canaries.items():
        if can.get("origin") is not None:
            origin_peers[str(can["origin"])] = name
        for o, v in can["observed"].items():
            o = str(o)
            if v is not None and (o not in newest
                                  or int(v) > newest[o]):
                newest[o] = int(v)
    origins = sorted(newest, key=_okey)
    lag: Dict[str, Dict[str, Optional[float]]] = {}
    complete = bool(origins) and bool(observers)
    worst: Optional[float] = None
    for o in origins:
        row: Dict[str, Optional[float]] = {}
        for w in observers:
            v = canaries[w]["observed"].get(o)
            if v is None:
                row[w] = None
                complete = False
            else:
                row[w] = max(0.0, (newest[o] - int(v)) / 1000.0)
                worst = (row[w] if worst is None
                         else max(worst, row[w]))
        lag[o] = row
    return {"origins": origins, "observers": observers,
            "origin_peers": origin_peers, "lag_s": lag,
            "complete": complete, "max_lag_s": worst}


def histogram_quantile(sample: Dict[str, Any], q: float
                       ) -> Optional[float]:
    """Upper-bound quantile estimate from one log2-bucket histogram
    sample (the `Histogram.samples()` shape): the smallest bucket
    bound whose cumulative count reaches ``q``; ``inf`` when the
    quantile lands in the overflow bucket; ``None`` when empty."""
    count = sample.get("count", 0)
    if not count:
        return None
    target = q * count
    cum = 0
    for bound, n in sample.get("buckets", []):
        cum += n
        if cum >= target:
            return float(bound)
    return math.inf


def instance_sketch(snap: dict, name: str = ACK_SKETCH_NAME
                    ) -> Optional[QuantileSketch]:
    """One instance's sketch series (all label sets merged) from its
    metrics snapshot; ``None`` when the snapshot predates the sketch
    cap or carries no observations. Pure."""
    if not isinstance(snap, dict):
        return None
    samples = snap.get("sketches", {}).get(name, [])
    merged = merge_sketches(
        sk for sk in (sketch_from_sample(s) for s in samples)
        if sk is not None and sk.count > 0)
    return merged


def fleet_sketch(snapshots: Dict[str, dict],
                 name: str = ACK_SKETCH_NAME
                 ) -> Optional[QuantileSketch]:
    """Fleet-true quantile sketch: every replica's series merged into
    one. The merge is the sketch's CRDT join — commutative and
    associative with the relative-error bound preserved — so the
    result's p99 is the p99 of the *union* of all replicas' samples,
    not a max-of-ceilings. ``None`` when no replica ships sketch data
    (pre-sketch fleet). Pure."""
    return merge_sketches(
        sk for sk in (instance_sketch(snap, name)
                      for snap in snapshots.values())
        if sk is not None)


def replica_health(snapshots: Dict[str, dict]) -> Dict[str, Any]:
    """Per-group replica roll-up from the ``replication`` sections of
    scraped (or in-process) metrics snapshots: ``groups`` maps group
    → instance → {role, lease_ms, hlc_head[, followers]}, and
    ``groups_without_primary`` lists every group no reachable member
    claims to lead. A killed primary scrapes as ``_scrape_error`` and
    so cannot claim its group — the group shows up here through its
    followers and counts as primaryless until the monitor promotes
    one. Pure."""
    groups: Dict[str, Dict[str, dict]] = {}
    for name, snap in snapshots.items():
        if not isinstance(snap, dict):
            continue
        rep = snap.get("replication")
        if not isinstance(rep, dict):
            continue
        entry = {"role": rep.get("role"),
                 "lease_ms": rep.get("lease_ms"),
                 "hlc_head": rep.get("hlc_head")}
        if isinstance(rep.get("followers"), dict):
            entry["followers"] = rep["followers"]
        groups.setdefault(str(rep.get("group")), {})[name] = entry
    missing = sorted(g for g, members in groups.items()
                     if not any(m.get("role") == "primary"
                                for m in members.values()))
    return {"groups": groups, "groups_without_primary": missing}


def _check(value: Optional[float], budget: float,
           ok: Optional[bool] = None) -> Dict[str, Any]:
    if ok is None:
        ok = None if value is None else bool(value <= budget)
    return {"value": value, "budget": budget, "ok": ok}


def _gauge_max(snap: dict, name: str) -> Optional[float]:
    vals = [s["value"] for s in snap.get("gauges", {}).get(name, [])
            if s.get("value") is not None]
    return max(vals) if vals else None


def topology_stall_s(snapshots: Dict[str, dict],
                     now_ms: Optional[float] = None
                     ) -> Optional[float]:
    """Seconds since the in-flight topology change last made progress,
    0.0 when no change is in flight, None when no snapshot exposes the
    wedge gauges (pre-elastic fleets). A change is "in flight" when
    any snapshot's ``crdt_tpu_topology_change_inflight_since_ms`` is
    non-zero; staleness is measured against the matching
    ``..._progress_ms`` stamp. Pure given ``now_ms``."""
    if now_ms is None:
        from ..hlc import wall_clock_millis
        now_ms = float(wall_clock_millis())
    seen = False
    worst: Optional[float] = None
    for snap in snapshots.values():
        if not isinstance(snap, dict):
            continue
        inflight = _gauge_max(
            snap, "crdt_tpu_topology_change_inflight_since_ms")
        if inflight is None:
            continue
        seen = True
        if inflight <= 0:
            continue
        progress = _gauge_max(
            snap, "crdt_tpu_topology_change_progress_ms") or inflight
        stall = max(0.0, (now_ms - progress) / 1000.0)
        worst = stall if worst is None else max(worst, stall)
    if not seen:
        return None
    return worst if worst is not None else 0.0


def evaluate_slo(snapshots: Dict[str, dict],
                 matrix: Optional[Dict[str, Any]] = None, *,
                 ack_p99_budget_s: float = ACK_P99_BUDGET_S,
                 convergence_budget_s: float = CONVERGENCE_BUDGET_S,
                 topology_stall_budget_s: float =
                 TOPOLOGY_STALL_BUDGET_S,
                 now_ms: Optional[float] = None
                 ) -> Dict[str, Any]:
    """Machine-readable fleet SLO verdict (see module docstring)."""
    if matrix is None:
        matrix = lag_matrix(snapshots)
    ceiling: Optional[float] = None
    shed: Optional[float] = None
    for snap in snapshots.values():
        if not isinstance(snap, dict):
            continue
        hists = snap.get("histograms", {})
        for s in hists.get(ACK_HIST_NAME, []):
            v = histogram_quantile(s, 0.99)
            if v is not None:
                ceiling = v if ceiling is None else max(ceiling, v)
        ctrs = snap.get("counters", {})
        for s in ctrs.get("crdt_tpu_serve_shed_total", []):
            shed = (shed or 0.0) + s["value"]
    # Ack p99: sketch-true when any replica ships sketch data (the
    # merged fleet sketch's quantile carries a ~1% relative-error
    # bound, so an off-power-of-two budget like the 14.6 ms envelope
    # is a real gate). Pre-sketch fleets fall back to the histogram
    # bucket ceiling, *honestly*: the ceiling only proves a pass when
    # it is itself within budget, only proves a breach when even the
    # bucket's lower edge exceeds budget, and is otherwise unmeasured
    # (ok=None) — unmeasured ≠ passed, and a ceiling 2× the budget is
    # not evidence of a breach.
    fleet_ack = fleet_sketch(snapshots)
    ack_check: Dict[str, Any]
    if fleet_ack is not None:
        ack_check = _check(fleet_ack.quantile(0.99), ack_p99_budget_s)
        ack_check["source"] = "sketch"
    else:
        ack_ok: Optional[bool] = None
        if ceiling is not None:
            # crdtlint: disable=histogram-ceiling-gate -- the one legal ceiling compare: three-valued, pass only when ceiling<=budget, fail only when the bucket FLOOR breaches, else unmeasured
            if ceiling <= ack_p99_budget_s:
                ack_ok = True       # true p99 <= ceiling <= budget
            # crdtlint: disable=histogram-ceiling-gate -- bucket floor (ceiling/2) exceeding budget proves the breach without trusting the quantization
            elif ceiling / 2.0 > ack_p99_budget_s:
                ack_ok = False      # even the bucket floor breaches
        # _check() would re-derive ok from the ceiling; build the
        # dict directly so ok=None survives as "unmeasured".
        ack_check = {"value": ceiling, "budget": ack_p99_budget_s,
                     "ok": ack_ok, "source": "histogram_ceiling"}
    conv = matrix.get("max_lag_s")
    conv_ok: Optional[bool] = None
    if matrix.get("origins"):
        # An incomplete matrix is a failed convergence check even if
        # the seen pairs are fast — an unseen pair IS unbounded lag.
        conv_ok = bool(matrix.get("complete")
                       and conv is not None
                       and conv <= convergence_budget_s)
    health = replica_health(snapshots)
    missing = health["groups_without_primary"]
    # Unmeasured ≠ passed: a fleet with no replication sections gets
    # ok=None here, but a group whose members answer and none of whom
    # is primary is a hard failure — that partition is down for
    # writes regardless of every other number on this page.
    primary_ok: Optional[bool] = (None if not health["groups"]
                                  else not missing)
    checks = {
        "ack_p99_s": ack_check,
        "convergence_lag_s": _check(conv, convergence_budget_s,
                                    ok=conv_ok),
        "shed_writes": _check(shed, 0.0),
        "groups_without_primary": _check(
            float(len(missing)) if health["groups"] else None, 0.0,
            ok=primary_ok),
        # A wedged in-flight topology change is a hard failure: the
        # stalled split/merge holds the federation's control lock, so
        # promotions queue behind it and the autoscaler is frozen —
        # the fleet cannot react to anything until it clears.
        "topology_change_stall_s": _check(
            topology_stall_s(snapshots, now_ms=now_ms),
            topology_stall_budget_s),
    }
    measured = [c["ok"] for c in checks.values()
                if c["ok"] is not None]
    scrape_errors = sorted(
        name for name, snap in snapshots.items()
        if isinstance(snap, dict) and "_scrape_error" in snap)
    ok = bool(measured) and all(measured) and not scrape_errors
    return {"checks": checks, "matrix_complete":
            bool(matrix.get("complete")),
            "scrape_errors": scrape_errors,
            "replication": health, "ok": ok}


def render_federation(snapshots: Dict[str, dict],
                      matrix: Optional[Dict[str, Any]] = None) -> str:
    """Aggregated Prometheus exposition of the fleet-level series;
    every series carries an ``instance`` (or origin/observer) label so
    same-named per-replica series cannot collide."""
    if matrix is None:
        matrix = lag_matrix(snapshots)
    lines: List[str] = []
    lines.append("# TYPE crdt_tpu_fleet_up gauge")
    for name, snap in sorted(snapshots.items()):
        up = int(isinstance(snap, dict)
                 and "_scrape_error" not in snap)
        lines.append(f"crdt_tpu_fleet_up"
                     f"{_labels({'instance': name})} {up}")
    if matrix["origins"]:
        lines.append("# TYPE crdt_tpu_canary_lag_seconds gauge")
        for o in matrix["origins"]:
            for w, v in sorted(matrix["lag_s"][o].items()):
                if v is None:
                    continue
                lines.append(
                    f"crdt_tpu_canary_lag_seconds"
                    f"{_labels({'origin': o, 'observer': w})} "
                    f"{_fmt(v)}")
    emitted_type = False
    for name, snap in sorted(snapshots.items()):
        if not isinstance(snap, dict):
            continue
        for s in snap.get("histograms", {}).get(
                "crdt_tpu_serve_ack_seconds", []):
            v = histogram_quantile(s, 0.99)
            if v is None or math.isinf(v):
                continue
            if not emitted_type:
                lines.append(
                    "# TYPE crdt_tpu_fleet_ack_p99_seconds gauge")
                emitted_type = True
            lines.append(f"crdt_tpu_fleet_ack_p99_seconds"
                         f"{_labels(dict(s['labels'], instance=name))}"
                         f" {_fmt(v)}")
    # Sketch-true ack quantiles: per-instance p99 plus the merged
    # fleet summary. These sit NEXT to the bucket-ceiling gauge above
    # — the two disagreeing (ceiling 31.25 ms, sketch 16 ms) is the
    # signal the log2 family cannot express, made visible.
    emitted_type = False
    for name, snap in sorted(snapshots.items()):
        sk = instance_sketch(snap)
        if sk is None:
            continue
        v = sk.quantile(0.99)
        if v is None:
            continue
        if not emitted_type:
            lines.append(
                "# TYPE crdt_tpu_fleet_ack_p99_sketch_seconds gauge")
            emitted_type = True
        lines.append(f"crdt_tpu_fleet_ack_p99_sketch_seconds"
                     f"{_labels({'instance': name})} {_fmt(v)}")
    fleet_ack = fleet_sketch(snapshots)
    if fleet_ack is not None and fleet_ack.count > 0:
        lines.append("# TYPE crdt_tpu_fleet_ack_seconds summary")
        for q in (0.5, 0.9, 0.99):
            lines.append(
                f"crdt_tpu_fleet_ack_seconds"
                f"{_labels({'quantile': f'{q:g}'})} "
                f"{_fmt(fleet_ack.quantile(q))}")
        lines.append(f"crdt_tpu_fleet_ack_seconds_count "
                     f"{fleet_ack.count}")
        lines.append(f"crdt_tpu_fleet_ack_seconds_sum "
                     f"{_fmt(fleet_ack.sum)}")
    emitted_type = False
    for name, snap in sorted(snapshots.items()):
        if not isinstance(snap, dict):
            continue
        for s in snap.get("counters", {}).get(
                "crdt_tpu_serve_shed_total", []):
            if not emitted_type:
                lines.append(
                    "# TYPE crdt_tpu_fleet_shed_total counter")
                emitted_type = True
            lines.append(f"crdt_tpu_fleet_shed_total"
                         f"{_labels(dict(s['labels'], instance=name))}"
                         f" {_fmt(s['value'])}")
    health = replica_health(snapshots)
    if health["groups"]:
        lines.append("# TYPE crdt_tpu_fleet_replica_primary gauge")
        for g, members in sorted(health["groups"].items()):
            for inst, m in sorted(members.items()):
                lines.append(
                    f"crdt_tpu_fleet_replica_primary"
                    f"{_labels({'group': g, 'instance': inst})} "
                    f"{int(m.get('role') == 'primary')}")
    return "\n".join(lines) + ("\n" if lines else "")


def format_replicas(health: Dict[str, Any]) -> str:
    """Human-readable per-group replica table (role, lease, head);
    empty string when no snapshot carried a ``replication`` section."""
    if not health["groups"]:
        return ""
    headers = ["group", "instance", "role", "lease_ms", "hlc_head"]
    rows = []
    for g, members in sorted(health["groups"].items()):
        for inst, m in sorted(members.items()):
            lease = m.get("lease_ms")
            rows.append([g, inst, str(m.get("role")),
                         "-" if lease is None else f"{lease:.0f}",
                         str(m.get("hlc_head") or "-")])
    text = "\n".join(_table(headers, rows)) + "\n"
    missing = health["groups_without_primary"]
    if missing:
        text += ("NO LIVE PRIMARY: " + ", ".join(missing) + "\n")
    return text


def format_partitions(snapshots: Dict[str, dict]) -> str:
    """Human-readable per-partition table from the ``partition``
    sections of scraped (or in-process) metrics snapshots, ranked by
    committed-row load (rank 1 = hottest) with the last scale action
    each partition took part in — the at-a-glance view of what the
    autoscaler has been doing. Empty string when no snapshot carries
    a partition section. Pure."""
    parts = []
    for name, snap in snapshots.items():
        if isinstance(snap, dict) and isinstance(
                snap.get("partition"), dict):
            parts.append((name, snap["partition"]))
    if not parts:
        return ""
    parts.sort(key=lambda kv: (
        -(kv[1].get("rows_committed") or 0), kv[0]))
    # Both ack p99 estimates side by side: the histogram's bucket
    # ceiling and the sketch's relative-error value. When they
    # disagree (ceiling 31.25 ms vs sketch 16 ms) the gap is the
    # log2 quantization — visible here instead of silent.
    headers = ["rank", "instance", "addr", "epoch", "slots", "rows",
               "queue", "shed", "p99ceil_ms", "p99_ms", "last_scale"]
    rows = []
    for rank, (name, p) in enumerate(parts, 1):
        ls = p.get("last_scale") or {}
        last = str(ls.get("action") or "-")
        if ls.get("epoch") is not None:
            last += f"@e{ls['epoch']}"
        snap = snapshots.get(name)
        ceil = None
        if isinstance(snap, dict):
            for s in snap.get("histograms", {}).get(ACK_HIST_NAME,
                                                    []):
                v = histogram_quantile(s, 0.99)
                if v is not None:
                    ceil = v if ceil is None else max(ceil, v)
        sk = instance_sketch(snap) if isinstance(snap, dict) else None
        true_p99 = sk.quantile(0.99) if sk is not None else None
        rows.append([str(rank), name, str(p.get("addr")),
                     str(p.get("epoch")), str(p.get("slots")),
                     str(p.get("rows_committed")),
                     str(p.get("queue_depth")), str(p.get("shed")),
                     "-" if ceil is None or math.isinf(ceil)
                     else f"{ceil * 1e3:.1f}",
                     "-" if true_p99 is None
                     else f"{true_p99 * 1e3:.1f}",
                     last])
    return "\n".join(_table(headers, rows)) + "\n"


def format_storage(snapshots: Dict[str, dict]) -> str:
    """Human-readable storage-plane table: per-instance stability
    watermark (``PINNED`` when any peer is unmeasured — tombstone GC
    is parked, docs/STORAGE.md), the last purge floor, and the
    live/tombstone split of shipped transfer bytes (migrate + rejoin
    surfaces summed). The split is the payoff metric: post-GC donors
    should ship ~zero tombstone bytes. Empty string when no snapshot
    carries storage-plane data. Pure."""
    rows = []
    for name, snap in sorted(snapshots.items()):
        if not isinstance(snap, dict):
            continue
        st = snap.get("stability")
        ctrs = snap.get("counters", {})
        live = sum(s["value"] for s in ctrs.get(
            "crdt_tpu_shipped_live_bytes_total", []))
        tomb = sum(s["value"] for s in ctrs.get(
            "crdt_tpu_shipped_tombstone_bytes_total", []))
        if not isinstance(st, dict) and not live and not tomb:
            continue
        if isinstance(st, dict):
            mark = ("PINNED" if st.get("pinned")
                    else str(st.get("stability_hlc") or "-"))
            floor = str(st.get("gc_floor") or "-")
        else:
            mark, floor = "-", "-"
        rows.append([name, mark, floor,
                     str(int(live)), str(int(tomb))])
    if not rows:
        return ""
    headers = ["instance", "stability", "gc_floor",
               "shipped_live_B", "shipped_tomb_B"]
    return "\n".join(_table(headers, rows)) + "\n"


def format_matrix(matrix: Dict[str, Any]) -> str:
    """Human-readable (origin × observer) lag table, seconds."""
    if not matrix["origins"]:
        return "no canary data\n"
    headers = ["origin\\observer"] + list(matrix["observers"])
    rows = []
    for o in matrix["origins"]:
        row = [o]
        for w in matrix["observers"]:
            v = matrix["lag_s"][o].get(w)
            row.append("-" if v is None else f"{v:.3f}")
        rows.append(row)
    return "\n".join(_table(headers, rows)) + "\n"


def fleet_main(argv: Optional[List[str]] = None, out=None) -> int:
    """``python -m crdt_tpu_torch.obs fleet`` entry point. Returns the exit
    code CI gates on: 0 iff the SLO verdict is ok (with ``--once``)."""
    import argparse
    import json
    import sys
    import time

    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.obs fleet",
        description="scrape a replica fleet into a canary lag matrix "
                    "and SLO verdict")
    ap.add_argument("--peers", required=True,
                    help="comma list of [name=]host:port")
    ap.add_argument("--once", action="store_true",
                    help="poll once and exit (exit 1 on SLO breach)")
    ap.add_argument("--interval", type=float, default=5.0)
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--json", action="store_true",
                    help="emit {matrix, slo} JSON per poll")
    ap.add_argument("--prom", action="store_true",
                    help="emit Prometheus federation text per poll")
    ap.add_argument("--ack-budget", type=float,
                    default=ACK_P99_BUDGET_S,
                    help="serve ack p99 budget, seconds")
    ap.add_argument("--lag-budget", type=float,
                    default=CONVERGENCE_BUDGET_S,
                    help="convergence lag budget, seconds")
    args = ap.parse_args(argv)
    out = sys.stdout if out is None else out
    peers = parse_peers(args.peers)

    while True:
        snapshots = poll_fleet(peers, timeout=args.timeout)
        matrix = lag_matrix(snapshots)
        verdict = evaluate_slo(
            snapshots, matrix, ack_p99_budget_s=args.ack_budget,
            convergence_budget_s=args.lag_budget)
        if args.json:
            out.write(json.dumps({"matrix": matrix,
                                  "slo": verdict}) + "\n")
        elif args.prom:
            out.write(render_federation(snapshots, matrix))
        else:
            out.write(format_matrix(matrix))
            out.write(format_replicas(verdict["replication"]))
            out.write(format_partitions(snapshots))
            out.write(format_storage(snapshots))
            out.write(f"slo ok={verdict['ok']} "
                      f"{json.dumps(verdict['checks'])}\n")
        out.flush()
        if args.once:
            return 0 if verdict["ok"] else 1
        time.sleep(args.interval)
