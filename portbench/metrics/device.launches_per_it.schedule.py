"""device.launches_per_it.schedule: device operations launched inside the
profiled solve span, over its iterations."""

from portbench.readers import host_events, kernels_within


def read(rec):
    solves = host_events(rec, "pb.solve")[:1]
    if not solves:
        return None
    n = kernels_within(rec, solves)
    return n / rec["counters"]["nit"] if n else None
