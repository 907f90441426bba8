"""Cost of one span of the port's recorder
(:mod:`sig_sdp_mmw_torch.utils.profiling`) on this host, off and on.

    python -m sig_sdp_mmw_torch.experiments.bench_spans [--n N] [--out F]

* off: ``with span("bcsr.spmm", operand="St", D=32)`` with no profiler
  and no ``tracing()``, the path every untraced run takes;
* on: the same inside ``tracing()`` (a ``record_function`` range, and on a
  card an NVTX range) and inside a ``torch.profiler`` session, plain and
  with ``timed=True`` (on a card, two timing events besides);
* on a card, what a span's parts cost under a profiler: a
  ``record_function`` range, an NVTX range, a timing event made and
  recorded, one taken from a pool and recorded.

The on-cost in place is the benchmark's: a ``--trace 1`` run against an
untraced one of the same seed.  Prints one JSON line (also written to
``--out``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from sig_sdp_mmw_torch.utils import profiling


def _per_span_us(n: int, timed: bool = False, D: int = 32) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("bcsr.spmm", timed, operand="St", D=D):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / n / 1e3)
    return best


def span_costs(n: int) -> dict:
    """Least µs per span over five runs of ``n``, each path."""
    from torch.profiler import ProfilerActivity, profile

    out = {"off_us": _per_span_us(n)}
    m = max(n // 20, 100)
    with profiling.tracing():
        out["on_tracing_us"] = _per_span_us(m)
        out["on_tracing_timed_us"] = _per_span_us(m, timed=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        out["on_profiler_us"] = _per_span_us(m)
        out["on_profiler_timed_us"] = _per_span_us(m, timed=True)
    profiling.clear()
    return out


def part_costs(n: int) -> dict:
    """Least µs per call of each part of an on span, under a profiler."""
    from torch.profiler import ProfilerActivity, profile

    pool = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    parts = {
        "record_function": lambda: torch.profiler.record_function(
            "x").__enter__().__exit__(None, None, None),
        "nvtx": lambda: (torch.cuda.nvtx.range_push("x"),
                         torch.cuda.nvtx.range_pop()),
        "event_new_record": lambda: torch.cuda.Event(
            enable_timing=True).record(),
        "event_pool_record": lambda: pool.pop().record(),
    }
    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for name, f in parts.items():
            t0 = time.perf_counter_ns()
            for _ in range(n):
                f()
            out[name + "_us"] = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    rec = {"torch": torch.__version__, "spans": span_costs(a.n)}
    if torch.cuda.is_available():
        rec["device"] = torch.cuda.get_device_name(0)
        torch.ones(1, device="cuda")                  # CUDA initialised
        rec["spans_cuda"] = span_costs(a.n)
        rec["parts_cuda"] = part_costs(max(a.n // 20, 100))
    line = json.dumps(rec)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
