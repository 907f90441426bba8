"""mmw_ell.spmm.ms_per_it.probe: device milliseconds of the port's SpMM
kernels in the profiled probe's solve (the kernels that start inside the
program's first ``mmw_ell.solve`` range of the trace), over its
iterations."""

from portbench.program_spans import spmm_kernel_s


def read(rec):
    s = spmm_kernel_s(rec)
    return None if s is None else 1e3 * s / rec["counters"]["nit"]
