"""bcsr.spmm_roofline.probe: the least time the profiled probe's SpMM
work needs (``counters["bound_s"][0]``, the bound the solve-level
roofline reads; ``portbench.reference.roofline``) over the device time of
the port's SpMM kernels in that probe's solve (those that start inside the
program's first ``mmw_ell.solve`` range of the trace), in %."""

from portbench.program_spans import spmm_kernel_s


def read(rec):
    bounds = rec["counters"].get("bound_s", [])[:1]
    s = spmm_kernel_s(rec)
    if s is None or not bounds or bounds[0] is None:
        return None
    return 100.0 * bounds[0] / s
