"""Profiling hooks: the reference's decorator, device-level tracing and the
port's span recorder (port of :mod:`sig_sdp_mmw_tpu.utils.profiling`).

* :func:`profile` keeps the reference's decorator surface
  (``sim_src/util.py:91-110``) on cProfile (host-side cost), gated by
  :data:`GLOBAL_PROF_ENABLER`;
* :func:`device_trace` records a ``torch.profiler`` trace, with the card's
  kernels when a card is present, and writes it as a Chrome trace;
* :func:`span` (the reference's name :func:`annotate` is the same
  function) names a phase of the program.  It records only while a
  ``torch.profiler`` session is recording, or inside :func:`tracing`.
  Off, it hands back one shared null context and costs well under a
  microsecond.  On, it opens a ``record_function`` range (and an NVTX
  range on a card), so the phase shows in the profiler's trace on the
  same clock as the kernels, and appends the span to an in-memory record.
  A span opened with ``timed=True`` also records, with CUDA initialised,
  a pair of timing events on the current stream; the others leave their
  device time to the profiler's trace, since the two events cost more to
  record than the rest of a span.  A span never waits for the card:
  :func:`spans` reads the events' device times once the caller has
  synchronised.

The record starts again at the first span recorded after the recorder was
off (a span asked for while off, or the start of :func:`tracing` or
:func:`device_trace`, marks it), so one profiled window holds one record.
It keeps at most :data:`MAX_SPANS` spans and counts the rest
(:func:`dropped`); :func:`clear` empties it.  Spans nest by the order they
are entered in, on one thread.
"""

from __future__ import annotations

import collections
import contextlib
import cProfile
import functools
import os
import pstats
import sys
import time

import torch

# Spans one record keeps; a sig100k probe records about 7,700.
MAX_SPANS = 200_000

SpanRecord = collections.namedtuple(
    "SpanRecord", "id parent root name t0 t1 attrs host_ms device_ms")
SpanRecord.__doc__ = """One finished span: its id, its parent's and its
outermost ancestor's ids (None, its own), its name, host nanoseconds at
entry and exit (``time.perf_counter_ns``), its attributes, and its host and
device milliseconds (device: the timing events' interval on a card, None
there for a span not opened with ``timed=True``; the host's interval
elsewhere)."""


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
    ``events()`` after the block.  The span record starts again with it."""
    from torch.profiler import ProfilerActivity

    global _stale
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _stale = True
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _NullSpan:
    """What :func:`span` hands out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        return None

    def set(self, **attrs):
        pass


_NULL = _NullSpan()
_profiler_enabled = torch.autograd._profiler_enabled

# The recorder's state, on module level so that the off path reads two
# globals and nothing more.
_forced = 0          # depth of open tracing() blocks
_stale = True        # the next recorded span starts a new record
# [id, parent, root, name, t0, t1, attrs, ev0, ev1, device ms]
_entries = []
_stack = []          # entries of the open spans, outermost first
_next_id = 0
_dropped = 0
_events = []         # timing events free for reuse


def _restart():
    global _entries, _stack, _next_id, _dropped, _stale
    for e in _entries:
        if e[8] is not None:          # finished: its events are free
            _events.extend((e[7], e[8]))
    _entries, _stack = [], []
    _next_id = _dropped = 0
    _stale = False


def _event():
    return _events.pop() if _events else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "attrs", "timed", "entry", "rf", "nvtx", "stream")

    def __init__(self, name, timed, attrs):
        self.name, self.timed, self.attrs = name, timed, attrs

    def __enter__(self):
        global _next_id, _dropped
        if _stale:
            _restart()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.nvtx = torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        sid = _next_id
        _next_id += 1
        parent = _stack[-1] if _stack else None
        ev = None
        if self.nvtx and self.timed:  # both events on the entry's stream
            self.stream = torch.cuda.current_stream()
            ev = _event()
            ev.record(self.stream)
        e = [sid, parent[0] if parent else None,
             parent[2] if parent else sid, self.name, time.perf_counter_ns(),
             None, self.attrs, ev, None, None]
        if len(_entries) < MAX_SPANS:
            _entries.append(e)
        else:
            _dropped += 1
        _stack.append(e)
        self.entry = e
        return self

    def __exit__(self, *exc):
        e = self.entry
        if e[7] is not None:
            e[8] = _event()
            e[8].record(self.stream)
        e[5] = time.perf_counter_ns()
        if not self.nvtx:             # no card: device time is host time
            e[9] = (e[5] - e[4]) * 1e-6
        if _stack and _stack[-1] is e:
            _stack.pop()
        elif e in _stack:
            _stack.remove(e)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        self.rf.__exit__(*exc)
        return False

    def set(self, **attrs):
        """Add attributes (host values the program already holds)."""
        self.attrs.update(attrs)


def span(name: str, timed: bool = False, **attrs):
    """``with span("mmw.expm", Z=Z) as s: ...``: a named phase, recorded
    only while a profiler session records or inside :func:`tracing`.
    ``attrs`` (and ``s.set(...)`` later) are host values the program
    already holds; none may read a device tensor.  ``timed``: on a card,
    also bracket the span with timing events (for a span whose device time
    a reader takes from :func:`spans`)."""
    global _stale
    if _forced or _profiler_enabled():
        return _Span(name, timed, attrs)
    _stale = True
    return _NULL


annotate = span


@contextlib.contextmanager
def tracing():
    """Record spans without a profiler session; where this turns the
    recorder on, the record starts again."""
    global _forced, _stale
    if not (_forced or _profiler_enabled()):
        _stale = True
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans() -> list:
    """The finished spans of the current record, in the order they were
    entered, as :class:`SpanRecord` (device times resolved here; on a card
    this waits for the events, so call it after the work)."""
    done = [e for e in _entries if e[5] is not None]
    if any(e[7] is not None and e[9] is None for e in done):
        torch.cuda.synchronize()
    out = []
    for e in done:
        if e[9] is None and e[7] is not None:
            e[9] = e[7].elapsed_time(e[8])
        out.append(SpanRecord(e[0], e[1], e[2], e[3], e[4], e[5], e[6],
                              (e[5] - e[4]) * 1e-6, e[9]))
    return out


def dropped() -> int:
    """Spans the current record left out past :data:`MAX_SPANS`."""
    return _dropped


def clear():
    """Empty the record (its timing events go back to the pool)."""
    _restart()
