"""device.idle_pct.peers: the idle share, in %, over the traced slice,
the mean over the cell's cards (profiler)."""


def read(out):
    tr = out.trace
    if tr is None or not tr["window_s"] or not any(tr["busy_s"]):
        return None
    busy = sum(tr["busy_s"]) / len(tr["busy_s"])
    return 100.0 * (1.0 - busy / tr["window_s"])
