"""mmw_ell.ms_per_it.probe: milliseconds per iteration of the block-sparse
solver, its synchronised solve spans over their iterations."""

from portbench.readers import mean, spans


def read(rec):
    m = mean(spans(rec, "pb.solve"))
    return None if m is None else 1e3 * m / rec["counters"]["nit"]
