"""mmw.launch_calls_per_it.schedule: the host's calls that put work on
the card (kernel launches, asynchronous copies and sets, graph launches)
inside the program's first ``mmw.solve`` range of the profiled request,
over its iterations.  A CUDA graph replaying many kernels counts once.

The names are those an H100's trace of the dense solve shows (torch
2.11, CUDA 12.8: the first five), and the graph launch."""

from portbench.readers import host_events

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch")


def read(rec):
    solves = sorted(host_events(rec, "mmw.solve"))[:1]
    if not solves:
        return None
    lo, hi = solves[0]
    n = sum(1 for name, a, _ in rec["trace"]["host"]
            if name in LAUNCH_CALLS and lo <= a <= hi)
    return n / rec["counters"]["nit"] if n else None
