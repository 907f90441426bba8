"""Convergence plateau against problem size: for each cell, the least
feasible Z from a short-budget search, then the reference-spec convergence
(eta 0.04, nit 625) at that Z, its upper bound read at every segment.

Port of ``tools/plateau_study.py`` (record ``PLATEAU_VS_K.json``).  MMW's
bound grows with the constraint count C = E + 2K (``models/mmw.py``), so
the same budget lands on a higher plateau at larger K whatever the
solver's quality; the rows carry K, C, ln C, lb, Z_fin and the curve.

Per cell (``LargeEnv(cell, 75e-4, seed=0)``; default cells 10, 24, 60,
110, 183, K = 300 to 100,467):

* search: a bisection over [lb, lb + 8], each probe one block-sparse MMW
  solve (nit 60, eta 0.05, D_pad 48, ``lanczos_m=8``, one rSVD iteration)
  rounded by the native scan (6 attempts); a feasible probe lowers the
  window's top;
* convergence at Z_fin: :func:`conv_probe.probe_curve` (eta 0.04, nit
  625, segments of 125, ``mmw_ell_ub_from_carry`` at each boundary).

Draws: the tool's ``PRNGKey(11)``; the probe at Z solves with
``TorchDraws(11, stream=Z)`` and rounds with ``TorchDraws(11, stream=77 +
Z)`` (``fold_in(key, Z)``, ``fold_in(key, 77 + Z)``), the convergence
solve with ``TorchDraws(11)`` (the key itself); ``run_cell(draws=)`` takes
others.  The block operands hold 128x128 bf16 blocks with the stored
transpose and the flat twins (groups of 8, the port's 100k layout): S̃ and
S̃ᵀ go through kernel #1 and Q through kernel #3 (the tool puts every
product on the block-ELL one).  A cell whose window holds no feasible Z is
recorded with ``Z_fin`` None and no curve (the tool stops there).  Each
row records its kernel launches by route and its seconds, the record the
card.  Writes JSON only to ``--out`` (after every cell).

    python -m sig_sdp_mmw_torch.experiments.plateau_study --out plateau.json
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)

CELLS = (10, 24, 60, 110, 183)
DRAW_SEED = 11


def tool_draws(device):
    """The tool's draws by role: ``draws(role, Z)`` with role "solve",
    "round" (a probe at Z) or "curve" (the convergence solve)."""
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    def draws(role, Z):
        stream = {"solve": Z, "round": 77 + Z, "curve": 0}[role]
        return TorchDraws(DRAW_SEED, device, stream=stream)
    return draws


def run_cell(cell, eta=0.04, nit=625, seg=125, nattempt=6, device="cuda",
             draws=None, segments=None):
    """One row of the tool (``run_cell``).  ``segments``: stop the
    convergence after that many segments (default all ``nit // seg``)."""
    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr
    from sig_sdp_mmw_torch.experiments.common import (launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.experiments.conv_probe import probe_curve
    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.models.rounding_ell import rounding_native_csr
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    draws = draws or tool_draws(device)
    t_cell = time.time()
    S, Q, h = generate_large_state_csr(cell, 75e-4, seed=0)
    K = S.shape[0]
    slim = ell_slim_from_csr(S, Q, h, device=device)
    ops = bcsr_operands_from_state(S, Q, block=128, dtype=torch.bfloat16,
                                   store_transpose=True, flat_group=8,
                                   device=device)
    cuda_sync(ops)
    lb = int(np.diff(Q.indptr).max()) + 1
    D_pad = 48
    E = int((Q != 0).sum()) // 2
    C = E + 2 * K                     # constraint count (mmw.py:59-60)

    snap = launch_snapshot()
    lo, hi = lb, lb + 8
    Z_fin = None
    probes = []
    t0 = time.time()
    while lo <= hi:
        mid = (lo + hi + 1) // 2
        out = mmw_solve_ell(slim, float(mid), nit=60, eta=0.05, D_pad=D_pad,
                            rank_pad=D_pad, draws=draws("solve", mid),
                            lanczos_m=8, bcsr=ops, rsvd_iters=1)
        _, _, rem = rounding_native_csr(mid, out.X_half, S, Q, h,
                                        draws("round", mid),
                                        nattempt=nattempt)
        probes.append(dict(Z=mid, ub=float(out.ub_final), rem=int(rem)))
        print(f"  cell={cell} probe Z={mid} rem={rem}")
        if rem == 0:
            Z_fin = mid
            hi = mid - 1
        else:
            lo = mid + 1
    row = dict(cell=cell, K=K, C=C, lnC=math.log(C), lb=lb, Z_fin=Z_fin,
               eta=eta, nit=nit, probes=probes, search_s=time.time() - t0)
    if Z_fin is None:
        print(f"  cell={cell}: no feasible Z in [{lb}, {lb + 8}]")
    else:
        t0 = time.time()
        curve = probe_curve(slim, ops, float(Z_fin), nit=nit, seg=seg,
                            eta=eta, D_pad=D_pad, lanczos_m=8,
                            draws=draws("curve", Z_fin), segments=segments,
                            tag=f"cell={cell}")
        cuda_sync(slim)
        row.update(curve=curve, ub_final=curve[-1][1],
                   curve_s=time.time() - t0)
        print(f"  cell={cell} K={K} C={C} Z_fin={Z_fin} "
              f"ub({curve[-1][0]})={curve[-1][1]:.4f}")
    row.update(launches=launches_since(snap), cell_s=time.time() - t_cell)
    return row


def main(cells=CELLS, device="cuda", out=None, **kw):
    """Every cell's row (``kw``: :func:`run_cell`'s ``nit``, ``seg``...)."""
    from sig_sdp_mmw_torch.experiments.common import card_info
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    rec = {"device": card_info(device), "rows": []}
    for cell in cells:
        rec["rows"].append(run_cell(cell, device=device, **kw))
        print("[plateau_study] " + json.dumps(rec["rows"][-1]))
        if out:
            with open(out, "w") as f:
                json.dump(rec, f, indent=1)
    if out:
        print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, nargs="*", default=list(CELLS))
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(tuple(a.cells), device=a.device, out=a.out)
