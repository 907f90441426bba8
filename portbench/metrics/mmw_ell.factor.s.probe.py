"""mmw_ell.factor.s.probe: device seconds of the profiled probe's final
bound and factorisation (the program's ``mmw_ell.factor`` span), per
solve."""

from portbench.program_spans import named, record


def read(rec):
    fs = named(record(), "mmw_ell.factor")
    return sum(s.device_ms for s in fs) * 1e-3 / len(fs) if fs else None
