"""comm.nccl_ms_per_join: NCCL kernels' device time per join, in ms,
the mean over the cell's cards, in the traced rounds (profiler)."""


def read(out):
    tr, joins = out.trace, out.counts.get("traced_joins", 0)
    if tr is None or not joins or not any(tr["nccl_s"]):
        return None
    return sum(tr["nccl_s"]) / len(tr["nccl_s"]) / joins * 1e3
