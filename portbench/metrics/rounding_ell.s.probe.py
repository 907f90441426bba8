"""rounding_ell.s.probe: seconds of the device rounding per probe, its
synchronised spans."""

from portbench.readers import mean, spans


def read(rec):
    return mean(spans(rec, "pb.rounding"))
