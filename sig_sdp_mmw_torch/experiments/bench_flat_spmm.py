"""SpMM microbenchmark on the card (counterpart of
``tools/bench_flat_spmm.py``): the three block-sparse SpMM contracts on one
operand, S̃ of the K=100,467 instance (cell 183, Hilbert order), D=48.

* ``ell``: the block-ELL kernel (:func:`sig_sdp_mmw_torch.ops.bcsr.
  bcsr_spmm`) on 128x128 bfloat16 blocks, the baseline;
* ``flat_G{G}``: the flat block-CSR kernel (:func:`bsr_spmm_flat`);
* ``vres_G{G}``: the flat block-CSR kernel with V resident in L2
  (:func:`bsr_spmm_vres`), for G in ``groups``.

Every kernel run is checked against its plain PyTorch version on the same
inputs (to ``REL_TOL`` of max|out|; a disagreement raises) and reports the
stored block MB, its time and the plain version's (CUDA events, median of 3
rounds of ``iters`` launches), the effective GB/s over the stored block
bytes, and its relative error against the ELL result.  Needs a CUDA device.
Returns the record; writes it as JSON only to ``out_path``.

    python -m sig_sdp_mmw_torch.experiments.bench_flat_spmm --out bench.json
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics

import numpy as np
import torch

print = functools.partial(print, flush=True)

# Kernel vs plain: the same (block-dtype-rounded) products summed in float32
# in different orders.
REL_TOL = 1e-5


def time_ms(fn, iters: int, rounds: int = 3) -> float:
    """Median over ``rounds`` of the mean time of ``iters`` back-to-back
    launches of ``fn``, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def check(name: str, out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Max |out - ref| against REL_TOL * max|ref|; raises on a miss."""
    err = float((out - ref).abs().max())
    tol = REL_TOL * float(ref.abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max|diff| {err:.3e} > {tol:.3e}")
    return dict(max_abs_err=err, tol=tol)


def main(cell=183, D=48, iters=30, groups=(4, 8, 16, 32), out_path=None,
         device="cuda"):
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr
    from sig_sdp_mmw_torch.ops.bcsr import (bcsr_from_csr, bcsr_spmm,
                                            bcsr_spmm_reference,
                                            bsr_flat_from_csr, bsr_spmm_flat,
                                            bsr_spmm_flat_reference,
                                            bsr_spmm_vres)
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"bench_flat_spmm measures on a CUDA device, "
                           f"not {device}")
    out = {"device": torch.cuda.get_device_name(device), "D": D,
           "cell": cell, "runs": []}
    rng = np.random.default_rng(0)

    S, Q, _ = generate_large_state_csr(cell, 75e-4, seed=0, order="hilbert")
    St = build_st_csr(S, Q)
    K = St.shape[0]
    Kp = ((K + 127) // 128) * 128
    out["K"] = K
    V = torch.from_numpy(rng.standard_normal((Kp, D)).astype(np.float32)
                         ).to(device)

    ell = bcsr_from_csr(St, block=128, pad_rows_to=Kp, dtype=torch.bfloat16,
                        device=device)
    r_ell = bcsr_spmm(ell, V)
    ell_bytes = ell.blocks.numel() * 2
    t = time_ms(lambda: bcsr_spmm(ell, V), iters)
    rec = {"impl": "ell", "maxblk": int(ell.bcols.shape[1]),
           "stored_mb": ell_bytes / 1e6, "ms": t,
           "plain_ms": time_ms(lambda: bcsr_spmm_reference(ell, V), iters),
           "eff_gbps": ell_bytes / t / 1e6,
           **check("ell", r_ell, bcsr_spmm_reference(ell, V))}
    print(rec)
    out["runs"].append(rec)
    del ell
    ref_scale = float(r_ell.abs().max())

    for G in groups:
        flat = bsr_flat_from_csr(St, block=128, group=G, pad_rows_to=Kp,
                                 dtype=torch.bfloat16, device=device)
        want = bsr_spmm_flat_reference(flat, V)
        plain_ms = time_ms(lambda: bsr_spmm_flat_reference(flat, V), iters)
        fbytes = flat.blocks.numel() * 2
        for name, fn in (("flat", bsr_spmm_flat), ("vres", bsr_spmm_vres)):
            r = fn(flat, V)
            t = time_ms(lambda: fn(flat, V), iters)
            rec = {"impl": f"{name}_G{G}", "nsteps": flat.nsteps,
                   "stored_mb": fbytes / 1e6, "ms": t, "plain_ms": plain_ms,
                   "eff_gbps": fbytes / t / 1e6,
                   "rel_err_vs_ell":
                       float((r - r_ell).abs().max()) / max(ref_scale, 1e-9),
                   **check(f"{name}_G{G}", r, want)}
            print(rec)
            out["runs"].append(rec)
        del flat
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--D", type=int, default=48)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--groups", type=int, nargs="+", default=[4, 8, 16, 32])
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.D, a.iters, tuple(a.groups), out_path=a.out)
