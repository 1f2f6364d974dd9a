"""fanin.merge_roofline: the least bytes the traced laps' merges must move
(``crdtbench/roofline.py``), over the card's peak bandwidth, as a share
of the device time of the ops launched inside the benchmark's spans
around each ``DenseCrdt.merge`` call. A trace in which some op's launch
is not known cannot be attributed, and gives no reading."""

from crdtbench.roofline import PEAK_HBM_BYTES_PER_S


def read(out):
    tr, laps = out.trace, out.counts.get("traced_laps", 0)
    if tr is None or not laps or tr["unlinked"][0]:
        return None
    merge_s = tr["launched_s"].get("crdtbench.merge", [0.0])[0]
    if not merge_s:
        return None
    least_s = out.counts["lap_bytes"] * laps / PEAK_HBM_BYTES_PER_S
    return 100.0 * least_s / merge_s
