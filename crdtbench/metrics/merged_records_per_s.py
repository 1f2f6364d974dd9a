"""merged_records_per_s: valid peer records the replicas had to take
in during the window, counted from the generated inputs, over the whole
window."""


def read(out):
    if "records_in_window" not in out.counts:
        return None
    return out.counts["records_in_window"] / out.window_s
