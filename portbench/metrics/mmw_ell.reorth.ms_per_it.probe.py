"""mmw_ell.reorth.ms_per_it.probe: device milliseconds of the Lanczos
re-orthogonalisation (the program's ``lanczos.reorth`` spans) in the
profiled probe's ``mmw_ell.solve``, over its iterations."""

from portbench.program_spans import per_it, record


def read(rec):
    return per_it(record(), "mmw_ell.solve", "lanczos.reorth")
