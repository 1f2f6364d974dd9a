"""The control of a cell at the cell's own size: the plain reference in
the program's place with one guarantee of the configuration broken
(each traffic driver's ``control``). Its readings are the upper ends of
the limits that decide ``correct``; every one of them must read above
its limit.

    python3 crdtbench/control.py --workload <name> --seeds 1,2,3

A control follows as many rounds as the cell's window of the benchmark's
``run_seconds`` would hold.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from crdtbench import harness
    seconds = harness.benchmark()["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(args.workload, seed, seconds, False,
                          time.perf_counter(), ["cuda:0"])
        t = time.perf_counter()
        readings = harness.traffic(ctx.params["kind"]).control(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
