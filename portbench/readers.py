"""Helpers the metric readers share: spans of the requests the profiler
did not slow, device time inside spans, the profiled window's idle share.

A run's record (``rec``) holds ``answers`` (one per request, with ``t0``,
``t1``), ``window_s``, ``spans`` (name, t0, t1, request index; traced runs
only), ``counters`` (what the protocol counted) and ``trace`` (the
profiled part: ``busy`` intervals, ``kernels``, ``host`` events, on the
profiler's clock).
"""

from __future__ import annotations

import bisect


def spans(rec, name: str) -> list:
    """Durations (s) of the spans called ``name``, leaving out the
    profiled requests when later ones exist."""
    skip = int(rec["cell"]["workload"].get("profile_requests", 1))
    got = [(b - a, r) for n, a, b, r in rec["spans"] if n == name]
    later = [d for d, r in got if r >= skip]
    return later or [d for d, _ in got]


def mean(xs):
    return sum(xs) / len(xs) if xs else None


def host_events(rec, name: str) -> list:
    """(start, end) of the profiled part's host events called ``name``."""
    if not rec["trace"]:
        return []
    return [(a, b) for n, a, b in rec["trace"]["host"] if n == name]


def busy_within(rec, intervals) -> float:
    """Seconds of the device's busy union that fall inside ``intervals``."""
    busy = rec["trace"]["busy"]
    starts = [a for a, _ in busy]
    tot = 0.0
    for lo, hi in intervals:
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(busy) and busy[i][0] < hi:
            a, b = busy[i]
            tot += max(0.0, min(b, hi) - max(a, lo))
            i += 1
    return tot


def kernels_within(rec, intervals) -> int:
    """Device operations that start inside ``intervals``."""
    ks = sorted(a for _, a, _ in rec["trace"]["kernels"])
    return sum(bisect.bisect_left(ks, hi) - bisect.bisect_left(ks, lo)
               for lo, hi in intervals)


def idle_pct(rec):
    """Idle share (%) of the device over the profiled window; None when no
    operation ran on the device."""
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
