"""``python -m crdt_tpu_torch.obs`` — poll a live node or summarize a trace.

Two modes:

- **Poll** a running `SyncServer` / `GossipNode` via the ``metrics``
  wire op and render the snapshot (human summary by default, raw
  JSON with ``--json``, Prometheus text with ``--prom``)::

      python -m crdt_tpu_torch.obs --once 127.0.0.1:7000
      python -m crdt_tpu_torch.obs 127.0.0.1:7000 --interval 5   # loop

- **Summarize** a trace JSONL (written by
  ``tracer().enable(jsonl_path=...)``) into a per-phase latency
  table::

      python -m crdt_tpu_torch.obs --trace /tmp/crdt-trace.jsonl

The ``fleet`` subcommand scrapes N replicas into a canary lag matrix
and SLO verdict (see :mod:`obs.fleet`)::

    python -m crdt_tpu_torch.obs fleet --peers a=127.0.0.1:7000,b=127.0.0.1:7001 --once

The ``bench`` subcommand verdicts the newest bench-trajectory record
against the fastest-of-N floors of its group — the CI regression gate
(see :mod:`obs.trajectory`)::

    python -m crdt_tpu_torch.obs bench --compare benchmarks/history/trajectory.jsonl

The ``dump`` subcommand fetches a node's SLO flight-recorder bundles
over the ``debug_dump`` wire op — post-incident forensics without a
poller having been attached (see :mod:`obs.recorder`)::

    python -m crdt_tpu_torch.obs dump 127.0.0.1:7000

Port of ``crdt_tpu/obs/cli.py``, with the same output and exit codes.
Like every entry point of the port it runs on the CUDA card unless
asked for the CPU: ``--device cpu`` (any position, any subcommand)
runs it on a host without a card, where it raises otherwise. The
command itself only polls and renders; the device it resolves is the
one its process may use, and `obs.trajectory.host_class` reads.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from .render import (format_phase_table, render_prometheus,
                     render_summary, summarize_trace)


def _parse_target(target: str):
    host, sep, port = target.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"target must be host:port, got {target!r}")
    return host or "127.0.0.1", int(port)


def _render(snapshot: dict, mode: str) -> str:
    if mode == "json":
        return json.dumps(snapshot, indent=2, default=str) + "\n"
    if mode == "prom":
        return render_prometheus(snapshot)
    return render_summary(snapshot)


def _summarize_file(path: str, out) -> int:
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue   # half-written tail line of a live sink
    out.write(format_phase_table(summarize_trace(events)))
    return 0


def _format_bundle(bundle: dict) -> str:
    """One flight-recorder bundle as a compact human block."""
    lines = [f"bundle #{bundle.get('seq', '?')} "
             f"kind={bundle.get('kind')} "
             f"t_wall_ms={bundle.get('t_wall_ms')}"]
    ctx = bundle.get("context")
    if ctx:
        lines.append(f"  context: {json.dumps(ctx, default=str)}")
    trace = bundle.get("trace")
    if isinstance(trace, list):
        lines.append(f"  trace tail: {len(trace)} events")
        lines.append(format_phase_table(summarize_trace(trace))
                     .rstrip().replace("\n", "\n  "))
    sketches = bundle.get("sketches")
    if isinstance(sketches, dict) and sketches:
        from .sketch import sketch_from_sample
        for name, samples in sorted(sketches.items()):
            for s in samples:
                sk = sketch_from_sample(s)
                if sk is None or sk.count == 0:
                    continue
                lines.append(
                    f"  {name}{s.get('labels', {})}: "
                    f"count={sk.count} "
                    f"p50={sk.quantile(0.5):.6f} "
                    f"p99={sk.quantile(0.99):.6f}")
    for src in bundle.get("sources", []):
        if isinstance(src, dict):
            keys = ", ".join(sorted(src))
            lines.append(f"  source sections: {keys}")
    return "\n".join(lines) + "\n"


def _dump_main(argv: List[str], out) -> int:
    """``python -m crdt_tpu_torch.obs dump`` — fetch a node's flight-
    recorder bundles (obs/recorder.py) over the ``debug_dump`` op."""
    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.obs dump",
        description="fetch a node's SLO flight-recorder debug "
                    "bundles (post-incident forensics)")
    ap.add_argument("target",
                    help="host:port of a running SyncServer/ServeTier")
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--json", action="store_true",
                    help="print raw bundle JSON (one per line)")
    args = ap.parse_args(argv)
    host, port = _parse_target(args.target)
    from ..net import SyncError, fetch_debug_dump
    try:
        bundles = fetch_debug_dump(host, port, timeout=args.timeout)
    except SyncError as e:
        print(f"dump failed: {e}", file=sys.stderr)
        return 1
    if args.json:
        for b in bundles:
            out.write(json.dumps(b, default=str) + "\n")
    elif not bundles:
        out.write("no bundles recorded\n")
    else:
        for b in bundles:
            out.write(_format_bundle(b))
    return 0


def _take_device(argv: List[str]):
    """``(device or None, argv less --device)``."""
    rest, device, it = [], None, iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, None)
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return device, rest


def main(argv: Optional[List[str]] = None, out=None) -> int:
    out = out or sys.stdout
    if argv is None:
        argv = sys.argv[1:]
    from ..utils.devices import resolve_device
    device, argv = _take_device(list(argv))
    resolve_device(device)
    if argv and argv[0] == "fleet":
        from .fleet import fleet_main
        return fleet_main(argv[1:], out)
    if argv and argv[0] == "bench":
        from .trajectory import bench_main
        return bench_main(argv[1:], out)
    if argv and argv[0] == "dump":
        return _dump_main(argv[1:], out)
    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.obs",
        description="poll a node's metrics op, or summarize a trace "
                    "JSONL into a per-phase latency table")
    ap.add_argument("target", nargs="?",
                    help="host:port of a running SyncServer/GossipNode")
    ap.add_argument("--once", action="store_true",
                    help="poll once and exit (default: loop)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll period in seconds (loop mode)")
    ap.add_argument("--timeout", type=float, default=10.0,
                    help="per-poll socket timeout")
    ap.add_argument("--json", action="store_true",
                    help="print the raw snapshot JSON")
    ap.add_argument("--prom", action="store_true",
                    help="print Prometheus text exposition")
    ap.add_argument("--trace", metavar="JSONL",
                    help="summarize a trace JSONL instead of polling")
    args = ap.parse_args(argv)

    if args.trace:
        return _summarize_file(args.trace, out)
    if not args.target:
        ap.error("need a host:port target (or --trace JSONL)")
    mode = "json" if args.json else "prom" if args.prom else "summary"
    host, port = _parse_target(args.target)

    # Imported lazily: obs must stay importable below net (net's
    # server attaches its wire tally to this package's registry).
    from ..net import SyncError, fetch_metrics

    while True:
        try:
            snapshot = fetch_metrics(host, port,
                                     timeout=args.timeout)
        except SyncError as e:
            print(f"poll failed: {e}", file=sys.stderr)
            return 1
        out.write(_render(snapshot, mode))
        if args.once:
            return 0
        out.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
