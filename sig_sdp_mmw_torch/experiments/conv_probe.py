"""Convergence probe at K=100k: where the block-sparse solve's upper bound
stands after nit=625 (eta=0.04, the ``sim_convergence_rho.py`` spec), in
bf16 and in float32 blocks.

Port of ``tools/conv_probe.py`` (record ``CONV_PROBE_100K.json``): the state
``LargeEnv(cell, 75e-4, seed=0)`` (cell 183, K=100,467), Z = lb + z_extra,
D_pad = rank_pad = 16·ceil(2Z/16), ``lanczos_m=8``; the solve runs in
segments of ``seg`` iterations through ``mmw_solve_ell(carry_in=,
it_start=, num_steps=, return_carry=True)``, and the bound of the averaged
primal is read from the carry at every segment's end
(``mmw_ell_ub_from_carry``).  The draws are ``TorchDraws(0)`` (the tool's
``PRNGKey(0)``), the same in both dtypes, as the tool's.

The block operands hold 128x128 blocks with the stored transpose and the
flat twins (groups of 8, the port's 100k layout), so S̃ and S̃ᵀ go through
kernel #1, the flat block-CSR kernel, and Q through kernel #3, the
block-ELL one (the tool puts every product on the block-ELL one).  The
record gains the card, each dtype's seconds and its kernel launches by
route.  :func:`main`'s ``dtypes`` and ``segments`` (stop each solve after
that many segments) make the short check of ``chip_smoke.py``.  Writes JSON
only to ``--out``.

    python -m sig_sdp_mmw_torch.experiments.conv_probe --out conv.json
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def probe_curve(slim, ops, Z: float, *, nit: int, seg: int, eta: float,
                D_pad: int, lanczos_m: int = 8, draws=None,
                segments: int = None, tag: str = ""):
    """[[iteration, ub], ...] at each segment's end of one segmented solve
    (``segments`` of them, default all ``nit // seg``)."""
    from sig_sdp_mmw_torch.models.mmw_ell import (mmw_ell_ub_from_carry,
                                                  mmw_solve_ell)
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    draws = draws or TorchDraws(0, slim.mask.device)
    kw = dict(nit=nit, eta=eta, D_pad=D_pad, rank_pad=D_pad,
              lanczos_m=lanczos_m, draws=draws, bcsr=ops)
    t0 = time.time()
    c, curve = None, []
    for i0 in list(range(0, nit, seg))[:segments]:
        c = mmw_solve_ell(slim, Z, carry_in=c, it_start=i0, num_steps=seg,
                          return_carry=True, **kw)
        u = float(mmw_ell_ub_from_carry(slim, Z, c, i0 + seg))
        curve.append([i0 + seg, u])
        print(f"[{tag}] it={i0 + seg} ub={u:.4f} [{time.time() - t0:.0f}s]")
    return curve


def main(cell=183, eta=0.04, nit=625, seg=125, z_extra=4, lanczos_m=8,
         dtypes=("bf16", "f32"), device="cuda", out=None, segments=None):
    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr
    from sig_sdp_mmw_torch.experiments.common import (card_info,
                                                      launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    S, Q, h = generate_large_state_csr(cell, 75e-4, seed=0)
    K = S.shape[0]
    slim = ell_slim_from_csr(S, Q, h, device=device)
    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + z_extra)
    D_pad = ((int(Z) * 2 + 15) // 16) * 16
    print(f"K={K} lb={lb} Z={Z} D_pad={D_pad} eta={eta} nit={nit}")

    rec = {"K": K, "Z": Z, "eta": eta, "nit": nit, "runs": {},
           "device": card_info(device), "seconds": {}, "launches": {}}
    for tag in dtypes:
        ops = bcsr_operands_from_state(S, Q, block=128, dtype=DTYPES[tag],
                                       store_transpose=True, flat_group=8,
                                       device=device)
        cuda_sync(ops)
        snap = launch_snapshot()
        t0 = time.time()
        rec["runs"][tag] = probe_curve(slim, ops, Z, nit=nit, seg=seg,
                                       eta=eta, D_pad=D_pad,
                                       lanczos_m=lanczos_m,
                                       segments=segments, tag=tag)
        cuda_sync(slim)
        rec["seconds"][tag] = time.time() - t0
        rec["launches"][tag] = launches_since(snap)
        del ops
    print("[conv_probe] " + json.dumps(rec))
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--eta", type=float, default=0.04)
    ap.add_argument("--nit", type=int, default=625)
    ap.add_argument("--seg", type=int, default=125)
    ap.add_argument("--z-extra", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.eta, a.nit, a.seg, a.z_extra, device=a.device, out=a.out)
