"""model.host_ms_per_merge: the mean host time, in ms, of one
``DenseCrdt.merge`` call inside a pipelined window (its enqueue: no
sync inside), from the benchmark's own spans around each call."""

from crdtbench.stats import mean


def read(out):
    v = mean(out.samples.get("merge_host_s", []))
    return None if v is None else v * 1e3
