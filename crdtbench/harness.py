"""The harness's general part: finding a cell's files by name, the run
context a traffic driver works in, the metric readers and the result
line. Nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: Top-level modules that may not be loaded when the result is printed.
FORBIDDEN = ("jax", "jaxlib", "flax", "crdt_tpu")


def _named(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{_named('workload', name)}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{_named('config', name)}.json")


def load_module(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    """The driver module of a traffic kind: ``traffic/<kind>.py``."""
    return load_module(HERE / "traffic" / f"{_named('traffic', kind)}.py",
                       f"crdtbench_traffic_{kind}")


def reader(metric: str) -> Callable[["Outcome"], Optional[float]]:
    """A metric's reader: ``metrics/<name>.py``'s ``read``."""
    mod = load_module(HERE / "metrics" / f"{_named('metric', metric)}.py",
                      "crdtbench_metric_" + metric.replace(".", "_")
                      .replace("-", "_"))
    return mod.read


def metrics_for(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with tracing its per-layer ones. A metric without ``workloads`` is
    every cell's."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one of `FORBIDDEN`,
    compared whole (``crdt_tpu_torch`` is not ``crdt_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Check:
    """One number compared, beside its limit: it holds when
    ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a traffic driver hands back after its window."""
    window_s: float
    samples: Dict[str, List[float]] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: Optional[dict] = None


class Ctx:
    """The run a traffic driver works in: its cell, configuration, seed,
    window length, cards, and the clock its set-up is read from."""

    def __init__(self, cell: str, seed: int, seconds: float, traced: bool,
                 t_start: float, devices: List[str]):
        self.cell = cell
        self.workload = workload(cell)
        self.config = config(self.workload["config"])
        self.params = self.workload["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = traced
        self.devices = devices
        self.t_start = t_start
        self.setup_s: Optional[float] = None
        self.trace: Optional[dict] = None

    def settle(self) -> None:
        """End set-up in the same state on every run: a full garbage
        collection now, so that none that set-up's objects call for
        lands at a random point of the window."""
        import gc
        gc.collect()

    def window_opens(self, at: Optional[float] = None) -> None:
        """Mark the first timed op (``at``, on `time.perf_counter`)."""
        t = time.perf_counter() if at is None else at
        self.setup_s = t - self.t_start

    def span(self, name: str):
        """The benchmark's own span around a call into the program,
        recorded only in a traced run."""
        if not self.traced:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("crdtbench." + name)

    @contextlib.contextmanager
    def profiling(self):
        """Run the enclosed part of a traced run under `torch.profiler`;
        the trace kept is that of the slice between `slice_begins` and
        `slice_ends` (the profiler takes seconds to start, so it starts
        before the slice)."""
        if not self.traced:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        from . import tracing
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._slice = [None, None]
        with profile(activities=acts) as prof:
            yield
            self.sync()
        w0, w1 = self._slice
        if w0 is not None and w1 is not None:
            self.trace = tracing.from_profiler(prof, len(self.devices),
                                               w0, w1)

    def slice_begins(self) -> None:
        if self.traced:
            self.sync()
            self._slice[0] = time.time_ns() / 1e3

    def slice_ends(self) -> None:
        if self.traced:
            self.sync()
            self._slice[1] = time.time_ns() / 1e3

    def sync(self) -> None:
        import torch
        if torch.cuda.is_available():
            for d in self.devices:
                if d.startswith("cuda"):
                    torch.cuda.synchronize(d)

    def memory_peak(self) -> int:
        import torch
        if not torch.cuda.is_available():
            return 0
        return max(torch.cuda.max_memory_allocated(d) for d in self.devices
                   if d.startswith("cuda"))


def metric_values(bench: dict, cell: str, traced: bool, out: Outcome,
                  setup_s: float) -> Dict[str, dict]:
    """Each metric of the run by its reader; a reader that finds nothing
    to read returns None and the metric is left out."""
    out.counts.setdefault("setup_s", setup_s)
    values = {}
    for m in metrics_for(bench, cell, traced):
        v = reader(m["name"])(out)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return values


def result_line(correct: bool, out: Outcome, metrics: Dict[str, dict],
                device: dict) -> str:
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    tr = out.trace
    if tr is not None:
        line["breakdown"] = {"device_ops": tr["top_device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return json.dumps(line)
