"""Idle share of the device (%) over the profiled part of the window: one
minus the union of the device's operations over its length."""

from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
