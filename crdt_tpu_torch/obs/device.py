"""Kernel launch counters — the port's reduced dispatch ledger.

``crdt_tpu/obs/device.py`` records every device dispatch with its
shape and donation; the port keeps only what a run needs to prove that
its main path went through the hand-written kernels: one plain integer
per kernel, bumped by the kernel's wrapper where it launches (never by
the plain torch version the wrapper takes for CPU tensors).
``chip_smoke.py`` zeroes the counts before it drives the main path and
reads them after. The K1 kernel is counted under two names: as
``fanin_batch`` on the unsharded merge, and as ``fanin_batch_sharded``
where the sharded step (`parallel.fanin`) launches it over a device's
blocks, once per device per merge. The four kernel probes (`ops.probe`)
count under their source names.

`OPS` counts, beside them, the plain-torch ops of the anti-entropy and
storage plane, of the typed joins, of the general-key `ops.merge.Store`
and of the collective group join (the JAX package runs them through
XLA, not Pallas, and no hand kernel replaces them): each digest-tree
build, range delta mask, GC purge and compaction remap, each typed
wire, sparse and fan-in join step, each `merge_step`, `scatter_put`,
`max_logical_time` and `delta_mask`, and each group join
(``parallel.collective_join``), on any device. A cached
``digest_tree()`` counts nothing, which is how a run shows that a tree
came from the cache.
"""

from __future__ import annotations

from typing import Dict

KERNELS = ("fanin_batch", "ingest_scatter", "fanin_split", "fanin_stream",
           "fanin_batch_sharded", "probe_join", "probe_copy",
           "probe_stream_noguard", "probe_copy_batch")

OPS = ("digest_tree", "range_delta_mask", "gc_purge", "compact_remap",
       "typed_wire_join_step", "typed_sparse_join_step",
       "typed_fanin_step", "merge_step", "scatter_put",
       "max_logical_time", "delta_mask", "parallel.collective_join")

_LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_OPS: Dict[str, int] = dict.fromkeys(OPS, 0)


def note_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (a `KERNELS` entry)."""
    _LAUNCHES[name] += 1


def note_op(name: str) -> None:
    """Count one call of plain op ``name`` (an `OPS` entry)."""
    _OPS[name] += 1


def launches() -> Dict[str, int]:
    """Launch count per kernel since the last `reset`."""
    return dict(_LAUNCHES)


def op_launches() -> Dict[str, int]:
    """Call count per plain op since the last `reset`."""
    return dict(_OPS)


def reset() -> None:
    for counts in (_LAUNCHES, _OPS):
        for name in counts:
            counts[name] = 0
