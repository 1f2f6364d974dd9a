"""Run one cell of the port's benchmark once and print its result line.

    python3 crdtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's file, ``crdtbench/workloads/<name>.json``, names its
configuration, its card count and its traffic; the traffic's kind names
the driver, ``crdtbench/traffic/<kind>.py``. The run loads, warms up,
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON object as the last line of
standard output. ``--trace 1`` profiles a slice of the window and
reports the per-layer metrics instead of the end-to-end ones.

It exits non-zero and prints no result when there is no card, fewer
cards than the cell asks for, or when JAX or the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from crdtbench import harness

    cell = harness.workload(args.workload)
    chips = int(cell["chips"])
    import torch
    if not torch.cuda.is_available():
        print("crdtbench: no CUDA device visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"crdtbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(chips)]
    ctx = harness.Ctx(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, devices)
    try:
        line = complete(ctx)
    except Exception:
        traceback.print_exc()
        return 1
    if line is None:
        return 1
    print(line, flush=True)
    return 0


def complete(ctx, **hooks):
    """Everything of a run after the look for cards: the traffic module's set-up,
    window and check, the readers, and the result line (None, with the
    reason on standard error, where there is none to print). ``hooks``
    go to the driver (the tests' planted faults)."""
    from crdtbench import harness
    import torch
    driver = harness.traffic(ctx.params["kind"])
    out = driver.run(ctx, **hooks)
    loaded = harness.forbidden_loaded()
    if loaded:
        print("crdtbench: forbidden modules loaded: " + ", ".join(loaded),
              file=sys.stderr)
        return None
    if ctx.setup_s is None:
        print("crdtbench: the driver never opened its window",
              file=sys.stderr)
        return None
    out.trace = ctx.trace
    metrics = harness.metric_values(harness.benchmark(), ctx.cell,
                                    ctx.traced, out, ctx.setup_s)
    on_card = torch.cuda.is_available()
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": len(ctx.devices),
              "memory_peak_bytes": out.memory_peak_bytes}
    if ctx.traced:
        tr = out.trace
        if tr is None:
            print("crdtbench: the traced run recorded no trace",
                  file=sys.stderr)
            return None
        device["busy_s"] = sum(tr["busy_s"]) / len(tr["busy_s"])
        device["window_s"] = tr["window_s"]
    correct = bool(out.checks) and all(c.ok for c in out.checks)
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else '  FAILED'}", file=sys.stderr)
    return harness.result_line(correct, out, metrics, device)


if __name__ == "__main__":
    sys.exit(main())
