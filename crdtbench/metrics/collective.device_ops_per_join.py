"""collective.device_ops_per_join: device ops on the first card per
traced round (its member's write and the join), from the profiler."""


def read(out):
    tr, joins = out.trace, out.counts.get("traced_joins", 0)
    if tr is None or not joins or not tr["device_ops"][0]:
        return None
    return tr["device_ops"][0] / joins
