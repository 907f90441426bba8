"""The readers of the program's own spans (``sig_sdp_mmw_torch.utils.
profiling``) on synthetic records: what each reads, and nothing where the
spans are missing, as on a program without the recorder."""

from __future__ import annotations

import json
import os

import pytest

from portbench import harness
from sig_sdp_mmw_torch.utils import profiling
from sig_sdp_mmw_torch.utils.profiling import SpanRecord

SPAN_METRICS = ["mmw_ell.spmm.ms_per_it.probe",
                "mmw_ell.reorth.ms_per_it.probe", "mmw_ell.factor.s.probe",
                "bcsr.spmm_roofline.probe",
                "mmw.launch_calls_per_it.schedule",
                "mmw.expm.host_ms_per_it.schedule"]


def _span(i, parent, root, name, device_ms, host_ms=None, **attrs):
    host_ms = device_ms if host_ms is None else host_ms
    return SpanRecord(i, parent, root, name, 0, 1, attrs, host_ms, device_ms)


def _probe_record():
    """One block-sparse solve of 2 iterations: products in a phase and
    below the factor; a re-orthogonalisation; a product outside the
    solve."""
    return [
        _span(0, None, 0, "mmw_ell.solve", 100.0, nit=2, Z=8.0),
        _span(1, 0, 0, "mmw_ell.expm", 40.0),
        _span(2, 1, 0, "bcsr.spmm", 3.0, operand="St", D=16),
        _span(3, 2, 0, "bcsr.spmm", 1.0, operand="St", D=16),
        _span(4, 1, 0, "bcsr.spmm", 5.0, operand="Q", D=16),
        _span(5, 1, 0, "lanczos.reorth", 6.0),
        _span(6, 0, 0, "mmw_ell.factor", 20.0),
        _span(7, 6, 0, "bcsr.spmm", 2.0, operand="StT", D=24),
        _span(8, None, 8, "bcsr.spmm", 50.0, operand="St", D=16),
    ]


def _schedule_record():
    """Two dense solves; the first (profiled) one's expm spans read."""
    return [
        _span(0, None, 0, "mmw.solve", 30.0, nit=2),
        _span(1, 0, 0, "mmw.expm", 9.0, host_ms=4.0),
        _span(2, 0, 0, "mmw.expm", 9.0, host_ms=6.0),
        _span(3, None, 3, "mmw.solve", 30.0, nit=2),
        _span(4, 3, 3, "mmw.expm", 9.0, host_ms=100.0),
    ]


def read(name, rec):
    return harness.metric_reader(name).read(rec)


def test_span_readers_on_a_synthetic_record(monkeypatch):
    monkeypatch.setattr(profiling, "spans", _probe_record)
    rec = {"counters": {"bound_s": [0.005, 1.0]}}
    assert read("mmw_ell.reorth.ms_per_it.probe", rec) == pytest.approx(3.0)
    assert read("mmw_ell.factor.s.probe", rec) == pytest.approx(0.02)
    monkeypatch.setattr(profiling, "spans", _schedule_record)
    assert read("mmw.expm.host_ms_per_it.schedule", {}) == pytest.approx(5.0)


def test_spmm_readers_on_a_synthetic_trace():
    """The SpMM kernels that start inside the first ``mmw_ell.solve``
    range: not the other kernels there, nor SpMM kernels outside it or in
    a later solve."""
    flat = "void (anonymous namespace)::bsr_spmm_flat_ring<__nv_bfloat16, 128>"
    ell = "void (anonymous namespace)::bcsr_spmm_ell_ring<__nv_bfloat16, 128>"
    host = [("mmw_ell.solve", 3.0, 4.0), ("mmw_ell.solve", 1.0, 2.0),
            ("bcsr.spmm", 1.1, 1.2)]
    kernels = [(flat, 1.1, 1.103), (ell, 1.5, 1.502),
               ("void at::native::elementwise_kernel<128, 2>", 1.3, 1.35),
               (flat, 0.5, 0.6), (flat, 2.5, 2.6), (flat, 3.1, 3.2)]
    rec = {"counters": {"bound_s": [0.0025, 1.0], "nit": 2},
           "trace": {"host": host, "kernels": kernels}}
    # 3 + 2 ms of SpMM kernels over 2 iterations; 2.5 ms of bound.
    assert read("mmw_ell.spmm.ms_per_it.probe", rec) == pytest.approx(2.5)
    assert read("bcsr.spmm_roofline.probe", rec) == pytest.approx(50.0)
    rec["counters"]["bound_s"] = [None]
    assert read("bcsr.spmm_roofline.probe", rec) is None
    rec["trace"]["kernels"] = kernels[2:4]
    assert read("mmw_ell.spmm.ms_per_it.probe", rec) is None


def test_launch_calls_on_a_synthetic_trace():
    host = [("mmw.solve", 1.0, 2.0), ("cudaLaunchKernel", 1.1, 1.2),
            ("cudaMemcpyAsync", 1.3, 1.4), ("cudaLaunchKernel", 1.5, 1.6),
            ("aten::mm", 1.5, 1.7), ("cudaLaunchKernel", 2.5, 2.6),
            ("mmw.solve", 3.0, 4.0), ("cudaLaunchKernel", 3.1, 3.2)]
    rec = {"counters": {"nit": 2}, "trace": {"host": host}}
    assert read("mmw.launch_calls_per_it.schedule", rec) == \
        pytest.approx(1.5)
    rec["trace"]["host"] = host[:1]
    assert read("mmw.launch_calls_per_it.schedule", rec) is None
    rec["trace"]["host"] = host[1:2]
    assert read("mmw.launch_calls_per_it.schedule", rec) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_find_nothing_without_spans(name, monkeypatch):
    """An empty record, or a program whose profiling module has no
    recorder (the parent of the recorder's change), reads None."""
    rec = {"counters": {"bound_s": [0.005], "nit": 2},
           "trace": {"host": []}}
    profiling.clear()
    assert read(name, rec) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(name, rec) is None


def test_every_span_metric_has_its_reader():
    """Each new entry names a cell that reports what it moves, and has a
    reader of its own name (not a stem's)."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    moves = {"probe": ("probe_s", "sig100k.search"),
             "schedule": ("schedule_s", "sig300.schedule")}
    for name in SPAN_METRICS:
        m = entries[name]
        assert (m["moves"], *m["workloads"]) == moves[name.rsplit(".")[-1]]
        assert os.path.exists(os.path.join(harness.PB_DIR, "metrics",
                                           name + ".py"))
        assert callable(harness.metric_reader(name).read)
    assert list(entries)[-len(SPAN_METRICS):] == SPAN_METRICS
