"""Kernel-variant probe on the card: where does the fan-in kernels' time
go? The port of ``benchmarks/probe_kernel.py``, with its flags, defaults
and variants.

Runs the stream bench shape (``--keys`` slots, one ``--chunk``-row
changeset replayed ``--replicas // --chunk`` times) through variants
that split compute from memory traffic:

- ``full``: the production merge, one `ops.stream_kernel.fanin_step`
  per chunk with the canonical threaded;
- ``stream``: the stream replay, all chunks in one
  `ops.stream_kernel.fanin_stream` launch (exact guards);
- ``stream-noguard``: the stream replay's loop with every guard
  removed (`ops.probe.probe_stream_noguard`, P1c);
- ``nojoin``: the join with no guards (`ops.probe.probe_join`, P1a),
  once per chunk;
- ``copy``: a pure copy at the same layout (`ops.probe.probe_copy`,
  P1b), once per chunk;

and the distinct-batch geometry (``--rows`` resident rows, ``--loops``
chained passes) through ``copy-batch`` and ``copy-batch-valref``
(`ops.probe.probe_copy_batch`, P2, wide and narrow lanes): the memory
ceiling the distinct row (`bench.fanin.bench_distinct`) is read
against.

Usage (on a machine with a CUDA card; without one it exits non-zero
and computes nothing)::

    python -m crdt_tpu_torch.bench.probe_kernel [--keys N] [--replicas N]
        [--chunk N] [--variants full,nojoin,copy] [--rows N] [--loops N]

Each printed line keeps the JAX probe's fields and adds the card's
name. `run_variant` and `run_batch_copy` also return the line's numbers;
they take ``device="cpu"`` (the plain versions) for tests.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..hlc import SHIFT
from ..utils.devices import resolve_device
from ..ops import probe
from ..ops.dense import empty_dense_store
from ..ops.split import (split_changeset, split_changeset_narrow,
                         split_store)
from ..ops.stream_kernel import fanin_step, fanin_stream
from .data import _MILLIS, device_name, make_changeset
from .fanin import WALL, fence

VARIANTS = ("full", "stream", "stream-noguard", "nojoin", "copy")
BATCH_VARIANTS = ("copy-batch", "copy-batch-valref")


def _best_of(run, repeats: int, dev: torch.device) -> float:
    """Seconds of the fastest of ``repeats`` fenced runs, after one
    fenced warm-up run (which builds the kernels)."""
    run()
    fence(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        fence(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def run_variant(name: str, n_keys: int, n_replicas: int, chunk: int,
                repeats: int = 3, device=None) -> dict:
    """Time variant ``name`` (see the module docstring) at ``n_keys`` x
    ``chunk`` rows x ``n_replicas // chunk`` chunks; print and return
    its line."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}")
    dev = resolve_device(device)
    n_chunks = n_replicas // chunk
    wide_store = empty_dense_store(n_keys, dev)
    wide_cs = make_changeset(chunk, n_keys, seed=0, device=dev)
    store, cs = split_store(wide_store), split_changeset(wide_cs)
    canonical = _MILLIS << SHIFT
    scalars = probe.probe_scalars(canonical)
    canon0 = torch.tensor(canonical, device=dev)

    if name == "full":
        def run():
            st, canon = wide_store, canon0
            for _ in range(n_chunks):
                st, res = fanin_step(st, wide_cs, canon, 0, WALL)
                canon = res.new_canonical
            return canon
    elif name == "stream":
        def run():
            return fanin_stream(wide_store, wide_cs, canon0, 0, WALL,
                                n_chunks=n_chunks)[1].new_canonical
    elif name == "stream-noguard":
        def run():
            return probe.probe_stream_noguard(store, cs, scalars,
                                              n_chunks)[0].hi
    else:
        fn = probe.probe_join if name == "nojoin" else probe.probe_copy

        def run():
            st = store
            for _ in range(n_chunks):
                st = st._replace(hi=fn(st, cs, scalars)[0].hi)
            return st.hi

    best = _best_of(run, repeats, dev)
    merges = int((cs.hi != cs.hi.min()).sum()) * n_chunks
    gbytes = ((6 * chunk + 2 * 9) * n_keys * 4) * n_chunks / 1e9
    card = device_name(dev)
    print(f"{name:8s} {best * 1e3:8.1f} ms   {merges / best / 1e9:6.2f} "
          f"B merges/s   {gbytes / best:6.1f} GB/s effective   [{card}]")
    return dict(variant=name, ms=best * 1e3, merges=merges,
                merges_per_s=merges / best, gbytes=gbytes,
                gb_per_s=gbytes / best, n_keys=n_keys, chunk=chunk,
                n_chunks=n_chunks, repeats=repeats, card=card)


def run_batch_copy(n_keys: int, n_rows: int, chunk_rows: int = 16,
                   loops: int = 48, value_width: int = 64,
                   repeats: int = 3, device=None) -> dict:
    """`bench.fanin.bench_distinct`'s protocol with the merge swapped
    for the same-layout pure copy (P2): the same split lanes resident on
    the device, ``loops`` passes chained through the store, one fence.
    Prints and returns its line; the merges/s it prints is the memory
    ceiling the distinct row is compared against."""
    dev = resolve_device(device)
    store = split_store(empty_dense_store(n_keys, dev))
    cs = make_changeset(n_rows, n_keys, seed=0, device=dev)
    merges = int(cs.valid.sum())
    if value_width == 32:
        scs, _ = split_changeset_narrow(cs._replace(val=cs.val & 0x7FFFFFFF))
    else:
        scs = split_changeset(cs)
    del cs
    state = [store]

    def run():
        for _ in range(loops):
            state[0] = probe.probe_copy_batch(state[0], scs, chunk_rows)[0]

    best = _best_of(run, repeats, dev)
    r, n = scs.hi.shape
    cs_bytes = sum(lane.element_size() for lane in scs) * r * n
    gbytes = cs_bytes * loops / 1e9   # store lanes amortize over chunks
    narrow = value_width == 32
    name = f"copy-batch{'-valref' if narrow else ''}"
    card = device_name(dev)
    print(f"{name:18s} {best * 1e3:8.1f} ms   "
          f"{merges * loops / best / 1e9:6.2f} B merges/s   "
          f"{gbytes / best:6.1f} GB/s cs-lane traffic   [{card}]")
    return dict(variant=name, ms=best * 1e3, merges=merges * loops,
                merges_per_s=merges * loops / best, gbytes=gbytes,
                gb_per_s=gbytes / best, n_keys=n_keys, n_rows=n_rows,
                chunk_rows=chunk_rows, loops=loops, repeats=repeats,
                card=card)


def run_named(name: str, args) -> dict:
    """One ``--variants`` entry with the CLI's arguments."""
    if name in BATCH_VARIANTS:
        return run_batch_copy(args.keys, args.rows, loops=args.loops,
                              value_width=32 if name.endswith("valref")
                              else 64)
    return run_variant(name, args.keys, args.replicas, args.chunk)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.bench.probe_kernel")
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--replicas", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--variants", default="full,nojoin,copy")
    ap.add_argument("--rows", type=int, default=128,
                    help="copy-batch: device-resident distinct rows")
    ap.add_argument("--loops", type=int, default=48)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS) - set(BATCH_VARIANTS)
    if unknown:
        print(f"probe_kernel: unknown variants {sorted(unknown)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_kernel: no CUDA device; the probes time the card's "
              "kernels and nothing was run", file=sys.stderr)
        return 2
    for name in names:
        run_named(name, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
