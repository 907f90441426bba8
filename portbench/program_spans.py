"""Helpers the readers of the program's own spans share: the record of
``sig_sdp_mmw_torch.utils.profiling`` (the spans of the profiled part of
the window), the spans below a given one, and the device time of the
port's SpMM kernels inside the program's first solve range of the trace.
A program without the recorder gives an empty record, and a trace
without the program's ranges no range, so their readers find nothing."""

from __future__ import annotations

from portbench.readers import host_events

# The port's hand-written SpMM kernels (``ops/kernels/csrc/``), as parts
# of the names the trace gives them.
SPMM_KERNELS = ("bsr_spmm_flat_ring", "bcsr_spmm_ell_ring", "short_tile",
                "bsr_spmm_vres_tma", "bsr_spmm_vres_tf32")


def spmm_kernel_s(rec, solve_name: str = "mmw_ell.solve"):
    """Device seconds of the SpMM kernels that start inside the first
    ``solve_name`` range of the profiled part (the kernels alone: V's cast
    and padding, and the device's waits, left out); None where the trace
    has no such range or no such kernel."""
    solves = sorted(host_events(rec, solve_name))[:1]
    if not solves:
        return None
    lo, hi = solves[0]
    s = sum(b - a for n, a, b in rec["trace"]["kernels"]
            if lo <= a <= hi and any(k in n for k in SPMM_KERNELS))
    return s if s > 0 else None


def record() -> list:
    """The program's finished spans, or [] where it records none."""
    from sig_sdp_mmw_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def named(recs, name: str) -> list:
    return [s for s in recs if s.name == name]


def below(recs, top, name: str) -> list:
    """The outermost spans called ``name`` among the descendants of span
    ``top``."""
    byid = {s.id: s for s in recs if s.root == top.root}
    out = []
    for s in byid.values():
        if s.name != name:
            continue
        p = byid.get(s.parent)
        while p is not None and p.id != top.id and p.name != name:
            p = byid.get(p.parent)
        if p is not None and p.id == top.id:
            out.append(s)
    return out


def per_it(recs, solve_name: str, name: str, clock: str = "device_ms",
           solves=None):
    """Milliseconds of the spans ``name`` below the solves ``solve_name``
    (all in the record, or ``solves``), over their iterations; None where
    there are none."""
    solves = named(recs, solve_name) if solves is None else solves
    ms = sum(getattr(s, clock) for t in solves for s in below(recs, t, name))
    nit = sum(t.attrs["nit"] for t in solves)
    return ms / nit if ms > 0 and nit > 0 else None
