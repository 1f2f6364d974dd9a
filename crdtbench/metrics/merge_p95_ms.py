"""merge_p95_ms: the 95th percentile, in ms, over every merge unit the
window completed (a lap, or a join call), from hand-over to merged and
fenced."""

from crdtbench.stats import percentile


def read(out):
    v = percentile(out.samples.get("unit_s", []), 0.95)
    return None if v is None else v * 1e3
