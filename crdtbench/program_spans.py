"""The port's own spans, read from its metrics registry once a run is
over: ``crdt_tpu_span_seconds`` (count and seconds by span) and
``crdt_tpu_span_syncs_total`` (host-device syncs by the innermost live
span). The program times its spans only while they are live, that is in
a traced run while the profiler records: the traced slice. A registry
in which no merge span was timed, as with a program that has no such
spans, gives no reading."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

SECONDS = "crdt_tpu_span_seconds"
SYNCS = "crdt_tpu_span_syncs_total"
MERGE = "crdt_tpu_torch.merge"
PREPARE = "crdt_tpu_torch.merge.prepare"
MASK = "crdt_tpu_torch.fanin.mask"
JOIN = "crdt_tpu_torch.fanin.join"
STAMP = "crdt_tpu_torch.fanin.stamp"
FENCE = "crdt_tpu_torch.window.fence"
#: The merge span and every span the merge step opens inside it.
IN_MERGE = (MERGE, PREPARE, "crdt_tpu_torch.dense_merge", MASK, JOIN,
            STAMP)


def spans(registry=None) -> Dict[str, List[float]]:
    """``{span: [count, seconds, syncs]}`` from the registry (the port's
    process-wide one by default), read without creating anything."""
    if registry is None:
        from crdt_tpu_torch.obs.registry import default_registry
        registry = default_registry()
    state, _ = registry.state_snapshot()
    out: Dict[str, List[float]] = {}
    for key, (_, count, total) in state.get(SECONDS, {}).items():
        name = dict(key).get("span")
        if name is not None and count:
            out[name] = [count, total, 0]
    for key, n in state.get(SYNCS, {}).items():
        name = dict(key).get("span")
        if name in out:
            out[name][2] = n
    return out


def per_merge_ms(names: Iterable[str], registry=None) -> Optional[float]:
    """The seconds of the named spans, summed, in ms a merge span; None
    where no merge span or none of the named spans was timed."""
    got = spans(registry)
    merges = got.get(MERGE, [0])[0]
    timed = [got[n] for n in names if n in got]
    if not merges or not timed:
        return None
    return 1e3 * sum(t[1] for t in timed) / merges
