"""The benchmark's general machinery: finding a cell's files by name,
the measured window, tracing, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Everything
particular to it is found by name:

* ``portbench/workloads/<cell>.json``: its request protocol, the protocol's
  parameters and the limits of its correctness checks;
* ``portbench/configs/<config>.json``: the deployment it runs;
* ``portbench/traffic/<protocol>.py``: the protocol, which sets the system
  up, drives the window's requests and judges the answers;
* ``portbench/metrics/<metric>.py``: the metric's reader, which takes the
  metric from the run's record and returns None where it finds nothing; a
  metric split by the end-to-end metric it moves (``device.idle.probe``)
  falls back to the reader of its stem (``device.idle``).

A run: the device check, set-up (timed as ``setup_s``), the window of
``--seconds`` (closed loop: a request starts when the last one ends, and
the request in flight when the time is up finishes and counts), the
correctness judgement once the window has closed, and one JSON line.
With ``--trace 1`` the calls into each layer are timed as synchronised
spans and a bounded first part of the window runs under ``torch.profiler``.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time

PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "sig_sdp_mmw_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_spec(name: str, bench=None) -> dict:
    """The ``BENCHMARK.json`` entry of cell ``name``, with its workload
    file under ``"workload"``, its configuration under ``"config_file"``
    and the names of its metrics under ``"end_to_end"`` / ``"per_layer"``."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def applies(m):
        return name in m.get("workloads", [name])

    return dict(entry,
                workload=load_json(os.path.join(PB_DIR, "workloads",
                                                name + ".json")),
                config_file=load_json(os.path.join(ROOT, conf["file"])),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def protocol(name: str):
    return importlib.import_module(f"portbench.traffic.{name}")


def metric_reader(name: str):
    """The module ``portbench/metrics/<name>.py`` (names hold dots), or
    that of the longest stem of ``name`` that has one."""
    stem = name
    while not os.path.exists(os.path.join(PB_DIR, "metrics", stem + ".py")):
        if "." not in stem:
            raise FileNotFoundError(f"no reader for metric {name!r}")
        stem = stem.rsplit(".", 1)[0]
    path = os.path.join(PB_DIR, "metrics", stem + ".py")
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class StopWindow(Exception):
    """Raised by :meth:`Window.answer` once the window's time is up."""


class Tracer:
    """Spans around the calls into the program's layers.  Off: a span
    costs nothing and synchronises nothing.  On: each span is a
    ``record_function`` range in the profiler's trace and a host-clock
    interval that ends after a device synchronise."""

    def __init__(self, on: bool, sync):
        self.on = on
        self.sync = sync
        self.spans = []          # (name, t0, t1, request index)
        self.request = 0

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            self.sync()
        self.spans.append((name, t0, time.perf_counter(), self.request))


class Window:
    """The measured window: each answer the protocol hands in ends one
    request; the request in flight when ``seconds`` have passed is the
    last.  With a profiler, the first ``profile_requests`` requests run
    under it."""

    def __init__(self, seconds: float, tracer: Tracer, prof=None,
                 profile_requests: int = 0):
        self.seconds = seconds
        self.tracer = tracer
        self.prof = prof
        self.profile_requests = profile_requests
        self.answers = []
        self.parts = 0
        self.t0 = self.last = None

    def start(self):
        if self.prof is not None:
            import torch

            self.prof.start()
            with torch.profiler.record_function("pb.mark"):
                pass
        self.t0 = self.last = time.perf_counter()

    def _stop_profiler(self):
        import torch

        with torch.profiler.record_function("pb.mark"):
            pass
        self.prof.stop()
        self.prof = None

    def part(self):
        """One part of the profiled work done (a request, or a smaller
        unit where the protocol says so); the profiler stops after
        ``profile_requests`` of them."""
        self.parts += 1
        if self.prof is not None and self.parts >= self.profile_requests:
            self._stop_profiler()

    def answer(self, ans: dict, part: bool = True):
        """Record one request's answer; raise :class:`StopWindow` when the
        window's time is up.  ``part``: the request counts as a part of the
        profiled work."""
        now = time.perf_counter()
        ans["t0"], ans["t1"] = self.last, now
        ans["index"] = len(self.answers)
        self.answers.append(ans)
        self.last = now
        self.tracer.request = len(self.answers)
        if part:
            self.part()
        if now - self.t0 >= self.seconds:
            raise StopWindow

    @property
    def elapsed(self) -> float:
        return self.last - self.t0


def check_no_jax() -> list:
    """Top-level names of loaded modules that the benchmark forbids."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _device_record(prof):
    """Device intervals, kernel totals and host spans of a profiled part,
    in seconds on the profiler's clock."""
    from torch.autograd import DeviceType

    dev, host, marks = [], [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, a, b))
        elif e.name == "pb.mark":
            marks.append(a)
        else:
            host.append((e.name, a, b))
    # A host range (record_function) is also drawn on the device's
    # timeline under its own name; it is no device operation.
    named = {n for n, _, _ in host} | {"pb.mark"}
    return [d for d in dev if d[0] not in named], host, marks


def merge(intervals):
    """Union of (start, end) intervals as a sorted disjoint list."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_record(prof) -> dict:
    """What the per-layer readers and ``breakdown`` read of a profile:
    the window (the two marks), kernels, their union, host spans, and the
    idle time summed by what the host was doing: the innermost benchmark
    span and host op open in the middle of each gap ("python" where no op
    was)."""
    dev, host, marks = _device_record(prof)
    w0, w1 = (min(marks), max(marks)) if len(marks) >= 2 else (0.0, 0.0)
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in dev
           if b > w0 and a < w1]
    busy = merge([(a, b) for _, a, b in dev])
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    pb = [h for h in host if h[0].startswith("pb.")]
    ops = [h for h in host if not h[0].startswith("pb.")]

    def innermost(spans, starts, t):
        # Nested spans: the innermost open at t is the latest-starting one
        # that has not ended.
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 2000, -1), -1):
            if spans[j][2] >= t:
                return spans[j][0]
        return "python"

    pb.sort(key=lambda h: h[1])
    ops.sort(key=lambda h: h[1])
    pb_s, ops_s = [h[1] for h in pb], [h[1] for h in ops]

    labelled = {}
    for a, b in gaps:
        t = 0.5 * (a + b)
        key = innermost(pb, pb_s, t) + "/" + innermost(ops, ops_s, t)
        labelled[key] = labelled.get(key, 0.0) + (b - a)
    kernels = {}
    for n, a, b in dev:
        kernels[n] = kernels.get(n, 0.0) + (b - a)
    return dict(window=(w0, w1), kernels=dev, busy=busy, host=host,
                busy_s=sum(b - a for a, b in busy), window_s=w1 - w0,
                device_ops=sorted(kernels.items(), key=lambda kv: -kv[1]),
                idle_gaps=sorted(labelled.items(), key=lambda kv: -kv[1]))


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it."""
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec=None, hooks=None,
             t_start=None) -> dict:
    """One run of cell ``name``: set-up, window, judgement; returns the
    result object.  ``t_start``: the host clock when the process started
    (``setup_s`` counts from it; default now).  ``device`` ``"cpu"`` and
    ``spec`` (a :func:`cell_spec` with smaller parameters) serve the CPU
    tests; ``hooks`` lets a test or the control put its own parts in the
    program's place (the protocols read it)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or cell_spec(name)
    wl = spec["workload"]
    proto = protocol(wl["protocol"])
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    tracer = Tracer(trace, sync)
    ctx = proto.setup(spec, seed, dev, tracer, hooks or {})
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    win = Window(seconds, tracer, prof, int(wl.get("profile_requests", 1)))
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] {name} seed={seed} setup {setup_s:.3f}s; window "
        f"{seconds}s, trace={int(trace)}")
    win.start()
    try:
        proto.window(ctx, win)
    except StopWindow:
        pass
    sync()
    window_s = win.elapsed
    if win.prof is not None:          # fewer requests than it waited for
        win._stop_profiler()
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    judged = proto.judge(ctx, win.answers)
    rec = dict(cell=spec, seed=seed, answers=win.answers, window_s=window_s,
               setup_s=setup_s, spans=tracer.spans, counters=ctx.counters,
               trace=trace_record(prof) if trace else None)
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec[group]:
        if m["name"] == "setup_s":
            v = setup_s
        else:
            v = metric_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = judged["checks"]
    errors = sum(1 for a in win.answers if a.get("error"))
    correct = (errors == 0 and judged["failed"] == 0
               and all(v <= lim for v, lim in checks.values()))
    result = {"correct": bool(correct), "attempted": len(win.answers),
              "failed": int(judged["failed"]), "metrics": metrics}
    if dev.type == "cuda":
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(0),
                            "count": 1, "memory_peak_bytes": int(peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace:
        tr = rec["trace"]
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              tr["device_ops"][:10]],
                               "idle_gaps": [list(x) for x in
                                             tr["idle_gaps"][:10]]}
    result["info"] = judged.get("info", {})
    if trace and dev.type == "cuda":
        # Shares of a peak hold at the card's power limit: name it.
        result["info"]["power_limit"] = power_limit()
        log(f"[portbench] {torch.cuda.get_device_name(0)} power limit "
            f"{result['info']['power_limit']}; peaks: 3.35 TB/s, 989 TFLOP/s "
            "bf16 (H100 SXM data sheet, 700 W)")
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for a in win.answers:
        if a.get("error"):
            log(f"[portbench] request {a['index']} raised: {a['error']}")
    return result


def main(argv=None, t_start=None) -> int:
    """The command line; ``t_start``: the host clock at the process's
    start (``setup_s`` counts from it)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    spec = cell_spec(a.workload)
    # Build and kernel caches of the program stay inside the checkout.
    cache = os.path.join(ROOT, "build", "portbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    import torch

    chips = int(spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"[portbench] {a.workload} needs {chips} CUDA device(s); found "
            f"{n}: no result")
        return 2
    log(f"[portbench] device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                      t_start=t_start)
    bad = check_no_jax()
    if bad:
        log(f"[portbench] loaded forbidden modules: {', '.join(bad)}: no "
            "result")
        return 3
    kind = result["device"]["kind"]
    for k, c in result["checks"].items():
        log(f"[portbench] check {k} {c['value']!r} limit {c['limit']!r} "
            f"({kind} x {torch.cuda.device_count()})")
    print(json.dumps(result), flush=True)
    return 0
