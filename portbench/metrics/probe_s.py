"""probe_s: seconds per probe of the 100k binary search, the window's
time over the probes it completed (host clock)."""


def read(rec):
    n = len(rec["answers"])
    return rec["window_s"] / n if n else None
