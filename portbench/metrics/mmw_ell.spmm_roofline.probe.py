"""mmw_ell.spmm_roofline.probe: the least time the profiled probes' SpMM
work needs (real blocks, D and the products the algorithm makes, at the
H100's published peaks; ``portbench.reference.roofline``) over the
device's busy time inside their solve spans, in %."""

from portbench.readers import busy_within, host_events


def read(rec):
    solves = host_events(rec, "pb.solve")
    if not solves:
        return None
    bounds = rec["counters"].get("bound_s", [])[:len(solves)]
    busy = busy_within(rec, solves)
    if busy <= 0 or len(bounds) < len(solves) or None in bounds:
        return None
    return 100.0 * sum(bounds) / busy
