"""mmw.expm.host_ms_per_it.schedule: host milliseconds of the dense
solver's sketched exponential (the program's ``mmw.expm`` spans) in the
profiled request's first ``mmw.solve``, over its iterations."""

from portbench.program_spans import named, per_it, record


def read(rec):
    recs = record()
    return per_it(recs, "mmw.solve", "mmw.expm", "host_ms",
                  solves=named(recs, "mmw.solve")[:1])
