"""Profiling hooks: the reference's decorator and device-level tracing
(port of :mod:`sig_sdp_mmw_tpu.utils.profiling`).

* :func:`profile` keeps the reference's decorator surface
  (``sim_src/util.py:91-110``) on cProfile (host-side cost), gated by
  :data:`GLOBAL_PROF_ENABLER`;
* :func:`device_trace` records a ``torch.profiler`` trace, with the card's
  kernels when a card is present, and writes it as a Chrome trace;
* :func:`annotate` names a span of host code in that trace
  (``torch.profiler.record_function``) and, on a card, in an NVTX range.
"""

from __future__ import annotations

import contextlib
import cProfile
import functools
import os
import pstats
import sys


class _ProfEnabler:
    enabled = True

    def DISABLE(self):
        self.enabled = False

    def ENABLE(self):
        self.enabled = True


GLOBAL_PROF_ENABLER = _ProfEnabler()


def profile(func):
    """Reference-compatible host profiler decorator (``util.py:100-110``):
    with the enabler on, each call runs under cProfile and prints its 25
    costliest entries by cumulative time."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if not GLOBAL_PROF_ENABLER.enabled:
            return func(*args, **kwargs)
        prof = cProfile.Profile()
        try:
            return prof.runcall(func, *args, **kwargs)
        finally:
            pstats.Stats(prof, stream=sys.stdout).sort_stats(
                "cumulative").print_stats(25)

    return wrapper


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a trace of the block: ``with device_trace(d) as prof: run()``.

    CPU activity always, CUDA activity when a card is present.  On exit the
    trace is written to ``log_dir/trace.json`` (Chrome trace format); the
    yielded ``torch.profiler.profile`` gives ``key_averages()`` and
    ``events()`` after the block."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Phase annotation visible in :func:`device_trace`'s trace (and as an
    NVTX range on a card)."""
    import torch

    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
