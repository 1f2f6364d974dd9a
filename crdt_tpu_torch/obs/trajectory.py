"""Bench trajectory: every benchmark run as one normalized record.

Copied from ``crdt_tpu/obs/trajectory.py``: the same records, verdicts,
output and exit codes; `host_class` reads its backend from torch.

The repo accumulated nine `BENCH_r*.json` files that share no schema —
wrapper dicts with a parsed summary, raw result dicts, multi-line
suites — so "did PR N regress the ingest floor?" had no machine
answer: the bench trajectory was literally unreadable as a series.
This module fixes the substrate:

- **One record per bench run**, schema
  ``{run_id, mode, git_sha, host_class, smoke, metrics{...}, slo}``,
  appended to ``benchmarks/history/trajectory.jsonl``. ``metrics`` is
  the bench result's numeric leaves flattened to dotted keys
  (``cold_peer.bytes_per_s``), so heterogeneous modes coexist in one
  file and any metric is addressable by name. ``host_class``
  (``{backend}-{machine}-cpu{n}``) keeps cross-host floors from being
  compared: a CPU-smoke record never regresses against a TPU soak.

- **A regression verdict** (`compare`) with `evaluate_slo` semantics
  (obs.fleet): per-metric ``{value, baseline, budget, ok}`` where
  ``ok`` is None when unmeasured (metric absent from either side, or
  direction unknown) and the top-level verdict requires every
  *measured* check to pass — unmeasured is never silently "passed",
  the count is surfaced as ``unmeasured``. Baselines are
  **fastest-of-N floors** over the preceding records of the same
  ``(mode, host_class, smoke)`` group: min over the pool for
  lower-is-better metrics, max for higher-is-better — one slow
  baseline run cannot manufacture a pass, one fast one sets the bar.

- **Noise budgets** are per-metric multiplicative headroom
  (default ±25%): a lower-is-better metric fails when
  ``value > floor * (1 + budget)``, higher-is-better when
  ``value < ceiling * (1 - budget)``. Counters/sizes (``bytes``,
  ``rows``, ``n``, ``count``) and booleans are identity-checked
  metrics only when the caller lists them via ``--metric``; by default
  only rate/latency metrics participate (see `metric_direction`).

``python -m crdt_tpu_torch.obs bench --compare <baseline.jsonl>`` is the CI
gate: exit 0 when the verdict is ok, 1 on regression, 2 when nothing
was comparable (unmeasured != passed applies to the whole run too).
Pure stdlib — importable without waking a card, usable from CI
without a device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: Default multiplicative noise headroom per metric. Wide on purpose:
#: the gate exists to catch step regressions (a dropped fast path, an
#: extra dispatch), not 5% jitter on shared CI hosts. Tighten per-run
#: with ``--budget``.
DEFAULT_BUDGET_FRAC = 0.25

#: Baseline pool: fastest-of-N floors over this many preceding runs of
#: the same (mode, host_class, smoke) group.
DEFAULT_BASELINE_POOL = 5

#: Default on-disk series (repo-relative).
TRAJECTORY_PATH = os.path.join("benchmarks", "history",
                               "trajectory.jsonl")

# Metric-name tokens that decide comparison direction. Substring match
# on the LAST dotted component, lower-is-better checked first so
# "merge_ms_per_round" classifies by its unit suffix.
_LOWER_TOKENS = ("_ms", "_s", "_seconds", "_us", "_ns", "latency",
                 "overhead", "floor_ms", "_frac")
_HIGHER_TOKENS = ("per_sec", "per_s", "_ops", "ops_s", "throughput",
                  "speedup", "rate", "per_round_per_sec")
# Never auto-compared: configuration echoes and counts that legitimately
# change run to run (shape knobs, totals, budgets themselves).
# "overhead_frac" is the bench's own self-measurement, gated absolutely
# in-bench against ledger_overhead_budget_frac — its floor bounces 2x
# run to run, so a multiplicative trajectory floor would only flap.
# "ceiling" tags metrics derived from histogram_quantile bucket
# ceilings (obs/fleet.py): those are log2-quantized upper bounds, so
# gating a real sample against a ceiling floor would verdict the
# quantization, not the latency — benches record the sketch-true
# quantile (obs/sketch.py) in a separate, gated key alongside.
_SKIP_TOKENS = ("budget", "_n", "n_", "rounds", "repeats", "bytes",
                "rows", "slots", "count", "size", "width", "port",
                "seed", "chunk", "depth", "within", "ok", "vs_baseline",
                "overhead_frac", "ceiling")
# Checked BEFORE the skip list: byte/size metrics that ARE the thing
# being optimized (churn-soak steady-state footprint, docs/STORAGE.md)
# rather than configuration echoes. "bytes" alone stays skipped — only
# these explicit steady-state shapes gate.
_LOWER_OVERRIDES = ("bytes_hwm", "bytes_per_live_row", "bytes_steady",
                    "tombstone_bytes_shipped")


def metric_direction(name: str) -> Optional[str]:
    """``"lower"`` / ``"higher"`` is better, or None (not compared).
    Heuristic over the last dotted component's unit-ish tokens —
    deliberately conservative: an unclassifiable metric is recorded in
    the trajectory but never gated on."""
    leaf = name.rsplit(".", 1)[-1].lower()
    for tok in _LOWER_OVERRIDES:
        if tok in leaf:
            return "lower"
    for tok in _SKIP_TOKENS:
        if tok in leaf:
            return None
    for tok in _HIGHER_TOKENS:
        if tok in leaf:
            return "higher"
    for tok in _LOWER_TOKENS:
        if leaf.endswith(tok) or tok in leaf:
            return "lower"
    return None


def flatten_metrics(obj: Any, prefix: str = "",
                    out: Optional[Dict[str, float]] = None
                    ) -> Dict[str, float]:
    """Numeric leaves of a nested bench result as dotted keys. Bools,
    strings, lists and None are dropped — the trajectory carries
    scalars a floor can be computed over."""
    if out is None:
        out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            flatten_metrics(v, key, out)
    elif isinstance(obj, bool):
        pass
    elif isinstance(obj, (int, float)):
        out[prefix] = float(obj)
    return out


def host_class() -> str:
    """Coarse hardware identity for grouping comparable runs:
    ``{backend}-{machine}-cpu{n}``. Backend is ``"cuda"`` once this
    process has a live CUDA context and ``"cpu"`` otherwise (the JAX
    package's CPU string) — the class must be computable in CI without
    waking an accelerator."""
    import platform
    import sys
    torch = sys.modules.get("torch")
    backend = ("cuda" if torch is not None and torch.cuda.is_initialized()
               else "cpu")
    return (f"{backend}-{platform.machine() or 'unknown'}"
            f"-cpu{os.cpu_count() or 0}")


def git_sha(repo_dir: Optional[str] = None) -> str:
    """Current commit sha, or "unknown" outside a checkout — records
    must still append from a bare CI artifact dir."""
    import subprocess
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo_dir or os.getcwd(), capture_output=True,
            text=True, timeout=10).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def normalize_record(mode: str, result: dict, *,
                     run_id: Optional[str] = None,
                     sha: Optional[str] = None,
                     host: Optional[str] = None,
                     smoke: bool = False,
                     source: Optional[str] = None) -> dict:
    """One trajectory record from one bench result dict. ``slo`` rides
    along verbatim when the result carries one (bench.py prints it as
    a trailing line; callers pass it merged into ``result``)."""
    if run_id is None:
        import time
        import uuid
        run_id = (time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
                  + "-" + uuid.uuid4().hex[:8])
    rec = {
        "run_id": run_id,
        "mode": mode,
        "git_sha": sha if sha is not None else git_sha(),
        "host_class": host if host is not None else host_class(),
        "smoke": bool(smoke),
        "metrics": flatten_metrics({k: v for k, v in result.items()
                                    if k != "slo"}),
        "slo": result.get("slo") if isinstance(result.get("slo"),
                                               dict) else None,
    }
    if source:
        rec["source"] = source
    return rec


def append_record(record: dict,
                  path: str = TRAJECTORY_PATH) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def load_trajectory(path: str) -> List[dict]:
    """Records in file order; malformed lines are skipped (a torn
    append must not take the whole series down), schema-less lines
    (no ``mode``/``metrics``) too."""
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "mode" in rec \
                    and isinstance(rec.get("metrics"), dict):
                out.append(rec)
    return out


def _group_key(rec: dict) -> Tuple[str, str, bool]:
    return (str(rec.get("mode")), str(rec.get("host_class")),
            bool(rec.get("smoke")))


def compare(baseline: Sequence[dict], candidate: dict, *,
            budget_frac: float = DEFAULT_BUDGET_FRAC,
            pool: int = DEFAULT_BASELINE_POOL,
            metrics: Optional[Sequence[str]] = None) -> dict:
    """Regression verdict for ``candidate`` against the fastest-of-N
    floors of its ``(mode, host_class, smoke)`` group in ``baseline``.

    Returns ``{checks: {metric: {value, baseline, budget, ok,
    direction}}, ok, unmeasured, compared, group, baseline_runs}``
    with `evaluate_slo` semantics: ``ok`` is None for unmeasured
    checks, the verdict requires every measured check to pass, and a
    run with zero measured checks is NOT ok (``ok`` None) — unmeasured
    never reads as passed."""
    key = _group_key(candidate)
    peers = [r for r in baseline if _group_key(r) == key
             and r.get("run_id") != candidate.get("run_id")]
    peers = peers[-pool:]
    cand_metrics = candidate.get("metrics", {})
    names = (list(metrics) if metrics
             else sorted(cand_metrics.keys()))
    checks: Dict[str, dict] = {}
    for name in names:
        direction = metric_direction(name)
        value = cand_metrics.get(name)
        floor: Optional[float] = None
        vals = [r["metrics"][name] for r in peers
                if isinstance(r.get("metrics", {}).get(name),
                              (int, float))]
        ok: Optional[bool] = None
        budget: Optional[float] = None
        if direction is not None and value is not None and vals:
            if direction == "lower":
                floor = min(vals)
                if floor <= 0.0:
                    # A zero floor gives no scale for multiplicative
                    # noise — any nonzero value would "regress".
                    checks[name] = {"value": value, "baseline": floor,
                                    "budget": None, "ok": None,
                                    "direction": direction}
                    continue
                budget = floor * (1.0 + budget_frac)
                ok = bool(value <= budget)
            else:
                floor = max(vals)
                budget = floor * (1.0 - budget_frac)
                ok = bool(value >= budget)
        elif direction is None and metrics:
            # Explicitly requested but unclassifiable: surface it as
            # unmeasured rather than dropping the row.
            ok = None
        elif direction is None:
            continue
        checks[name] = {"value": value, "baseline": floor,
                        "budget": budget, "ok": ok,
                        "direction": direction}
    measured = [c["ok"] for c in checks.values() if c["ok"] is not None]
    unmeasured = sum(1 for c in checks.values() if c["ok"] is None)
    ok = (bool(measured) and all(measured)) if measured else None
    return {"checks": checks, "ok": ok, "compared": len(measured),
            "unmeasured": unmeasured,
            "group": {"mode": key[0], "host_class": key[1],
                      "smoke": key[2]},
            "baseline_runs": [r.get("run_id") for r in peers]}


def bench_main(argv: Optional[List[str]] = None, out=None) -> int:
    """``python -m crdt_tpu_torch.obs bench`` entry point.

    ``--compare BASELINE`` verdicts the newest record of BASELINE's
    last group (self-trajectory: append, then gate) or, with
    ``--candidate FILE``, the newest record of FILE against the whole
    of BASELINE. Exit 0 = every measured metric within budget, 1 =
    regression, 2 = nothing comparable (missing group, empty series —
    unmeasured != passed, for the run as a whole too)."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.obs bench",
        description="bench-trajectory regression verdicts "
                    "(benchmarks/history/trajectory.jsonl)")
    ap.add_argument("--compare", metavar="BASELINE",
                    default=TRAJECTORY_PATH,
                    help="baseline trajectory jsonl "
                         f"(default {TRAJECTORY_PATH})")
    ap.add_argument("--candidate", metavar="FILE", default=None,
                    help="candidate trajectory jsonl; default: the "
                         "baseline's own last record (self-gate)")
    ap.add_argument("--pool", type=int, default=DEFAULT_BASELINE_POOL,
                    help="fastest-of-N baseline pool size")
    ap.add_argument("--budget", type=float,
                    default=DEFAULT_BUDGET_FRAC,
                    help="per-metric noise budget fraction")
    ap.add_argument("--metric", action="append", default=None,
                    help="gate only these metric names (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full verdict JSON")
    args = ap.parse_args(argv)
    out = sys.stdout if out is None else out

    baseline = load_trajectory(args.compare)
    if args.candidate:
        cand_series = load_trajectory(args.candidate)
        if not cand_series:
            out.write(f"no candidate records in {args.candidate}\n")
            return 2
        candidate = cand_series[-1]
    else:
        if not baseline:
            out.write(f"no records in {args.compare}\n")
            return 2
        candidate = baseline[-1]
        baseline = baseline[:-1]

    verdict = compare(baseline, candidate, budget_frac=args.budget,
                      pool=args.pool, metrics=args.metric)
    if args.json:
        out.write(json.dumps({"candidate": candidate.get("run_id"),
                              "verdict": verdict}, sort_keys=True)
                  + "\n")
    else:
        g = verdict["group"]
        out.write(f"candidate {candidate.get('run_id')} "
                  f"mode={g['mode']} host={g['host_class']} "
                  f"smoke={g['smoke']} vs "
                  f"{len(verdict['baseline_runs'])} baseline run(s)\n")
        for name, c in sorted(verdict["checks"].items()):
            if c["ok"] is None:
                state = "unmeasured"
            else:
                state = "ok" if c["ok"] else "REGRESSED"
            base = ("-" if c["baseline"] is None
                    else f"{c['baseline']:.6g}")
            val = "-" if c["value"] is None else f"{c['value']:.6g}"
            out.write(f"  {state:<10} {name} value={val} "
                      f"floor={base} dir={c['direction']}\n")
        out.write(f"verdict ok={verdict['ok']} "
                  f"compared={verdict['compared']} "
                  f"unmeasured={verdict['unmeasured']}\n")
    out.flush()
    if verdict["ok"] is None:
        return 2
    return 0 if verdict["ok"] else 1
