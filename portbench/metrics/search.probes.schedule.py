"""search.probes.schedule: probes (solve and rounding) per schedule."""

from portbench.readers import mean


def read(rec):
    return mean(rec["counters"].get("probes", []))
