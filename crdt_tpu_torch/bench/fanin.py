"""The fan-in rows of ``bench.py`` on the port: the write-stream replay
(`bench`, ``bench.py:192``) and the HBM-resident distinct batch
(`bench_distinct`, ``bench.py:266``) — the rows the kernel probes
(`bench.probe_kernel`) are read against.

- `bench`: ONE ``[chunk_replicas, n_keys]`` changeset replayed
  ``n_replicas // chunk_replicas`` times per call by the stream replay
  (`ops.stream_kernel.fanin_stream`, fast guards), ``repeats`` calls
  chained with the canonical clock threaded from call to call, one
  readback at the end (``bench.py:239-245``).
- `bench_distinct`: ``[n_rows, n_keys]`` split wire lanes resident on
  the device, one pre-split merge (`ops.fanin_kernel.fanin_split`,
  identity node map over the generated ordinals 0..8) per loop into the
  empty store, the canonical threaded.

Both count only valid records as merges and fence with
``torch.cuda.synchronize()``. ``bench.py``'s ``path=`` knob and its
fallback are left out (the device picks the path: the kernels on the
card, the plain versions on the CPU), and so is ``with_phases``.
"""

from __future__ import annotations

import time

import torch

from ..hlc import SHIFT
from ..models.dense_crdt import resolve_device
from ..ops.dense import empty_dense_store
from ..ops.fanin_kernel import fanin_split
from ..ops.split import split_changeset, split_changeset_narrow
from ..ops.stream_kernel import fanin_stream
from .data import (_MILLIS, CONFIGS, device_name, make_changeset,
                   result_dict)

WALL = _MILLIS + 10_000


def fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _path(device: torch.device, kernel: str) -> str:
    return kernel if device.type == "cuda" else "plain"


def bench(n_keys: int, n_replicas: int, chunk_replicas: int,
          repeats: int = 64, config: str = "fanin", device=None) -> dict:
    """The stream replay row (see the module docstring)."""
    dev = resolve_device(device)
    n_chunks = n_replicas // chunk_replicas
    store = empty_dense_store(n_keys, dev)
    cs = make_changeset(chunk_replicas, n_keys, seed=0, device=dev,
                        **CONFIGS[config])
    # Only valid lanes are record merges (fill < 1 pads the changeset
    # with invalid entries that cost no join work).
    merges = int(cs.valid.sum()) * n_chunks
    canon0 = torch.tensor(_MILLIS << SHIFT, device=dev)

    def run(canon):
        _, res = fanin_stream(store, cs, canon, 0, WALL, n_chunks=n_chunks,
                              guards="fast")
        return res.new_canonical

    int(run(canon0))                      # build, warm, fence
    fence(dev)
    t0 = time.perf_counter()
    canon = canon0
    for _ in range(repeats):
        canon = run(canon)
    int(canon)
    fence(dev)
    elapsed = time.perf_counter() - t0
    suffix = "" if config == "fanin" else f"_{config}"
    out = result_dict(
        f"record_merges_per_sec_{n_keys // 1000}k_keys_"
        f"x{chunk_replicas}_replicas_stream{n_chunks}{suffix}",
        merges * repeats, elapsed, path=_path(dev, "cuda-stream"),
        platform=device_name(dev))
    out["repeats"] = repeats
    out["merges"] = merges * repeats
    return out


def bench_distinct(n_keys: int, n_rows: int, loops: int = 48,
                   value_width: int = 64, device=None) -> dict:
    """The distinct-batch row (see the module docstring);
    ``value_width=32`` takes the narrow value-ref lanes (15 B/entry)."""
    dev = resolve_device(device)
    store = empty_dense_store(n_keys, dev)
    cs = make_changeset(n_rows, n_keys, seed=0, device=dev)
    merges = int(cs.valid.sum())
    if value_width == 32:
        scs, overflow = split_changeset_narrow(
            cs._replace(val=cs.val & 0x7FFFFFFF))
        if bool(overflow):
            raise AssertionError("bench_distinct: masked values overflow "
                                 "int32")
    else:
        scs = split_changeset(cs)
    del cs
    node_map = torch.arange(9, dtype=torch.int32, device=dev)
    canon0 = torch.tensor(_MILLIS << SHIFT, device=dev)

    def run(canon):
        _, res, _, _ = fanin_split(store, scs, node_map, canon, 0, WALL,
                                   value_width=value_width)
        return res.new_canonical

    int(run(canon0))                      # build, warm, fence
    fence(dev)
    t0 = time.perf_counter()
    canon = canon0
    for _ in range(loops):
        canon = run(canon)
    int(canon)
    fence(dev)
    elapsed = time.perf_counter() - t0
    suffix = "" if value_width == 64 else "_valref32"
    out = result_dict(
        f"record_merges_per_sec_{n_keys // 1000}k_keys_"
        f"x{n_rows}_distinct_replicas{suffix}", merges * loops, elapsed,
        path=_path(dev, "cuda-split"), platform=device_name(dev))
    out["loops"] = loops      # every loop re-reads all rows from memory
    out["merges"] = merges * loops
    return out
