"""setup_s: seconds from the process's start to the window's first
timed op (imports, kernel build and load, data, connects, warm-up)."""


def read(out):
    return out.counts.get("setup_s")
