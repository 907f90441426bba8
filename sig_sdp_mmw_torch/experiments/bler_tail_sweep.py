"""Price the BLER tail against the state threshold ``min_s_n_ratio``.

Port of ``tools/bler_tail_sweep.py`` (record ``BLER_TAIL_SWEEP.json``).
Received powers below ``min_s_n_ratio`` are dropped from the solver's graph
by design (reference ``env.py:151``), so the solver never constrains their
sum; a lower threshold gives a denser graph, fewer unmodelled interferers
and a smaller tail of users above BLER 1e-5, at a price in state size and
solve time.  For each ratio, the whole pipeline on ``LargeEnv(cell, rho,
seed)`` (default cell 100, K=30,000): generate -> ELL state -> block
operands -> binary search of ``MMWEll`` probes (nit 150, eta 0.05, 10
attempts, the device rounding) -> ``verify_assignment_csr`` -> the
full-channel BLER.

Each row holds the tool's keys (nnz, degS, state MB, the build, solve and
BLER-evaluation seconds, Z, rem, the verification, the BLER statistics)
and the kernel launches of its search by route.  The blocks are float32
``block`` x ``block`` as the tool's, with the flat twins (groups of 8): S̃
and S̃ᵀ go through kernel #1 and Q through kernel #3 (the tool puts S̃ on
the block-ELL product and S̃ᵀ on a scatter).  The solver's draws are the
``MMWEll(seed=0)`` defaults, as the tool's.  Writes JSON only to ``--out``.

    python -m sig_sdp_mmw_torch.experiments.bler_tail_sweep --cell 100 \\
        --ratios 0.1 0.03 0.01 --out sweep.json
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)


def _nbytes(obj) -> int:
    """Bytes of every tensor field of a TensorFields container."""
    n = 0
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
        elif dataclasses.is_dataclass(v):
            n += _nbytes(v)
    return n


def run_one(ratio, cell, rho, seed, nit, eta, nattempt, block, device="cuda"):
    """One row of the sweep (the tool's ``run_one``)."""
    from sig_sdp_mmw_torch.core.ell import ell_from_scipy
    from sig_sdp_mmw_torch.env.env import EnvParams
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments.common import (launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.models.mmw_ell import MMWEll
    from sig_sdp_mmw_torch.models.rounding_ell import verify_assignment_csr
    from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    p = EnvParams(cell_size=cell, sta_density_per_1m2=rho,
                  min_s_n_ratio=ratio)
    env = LargeEnv(cell, rho, seed=seed, params=p)
    rec = {"min_s_n_ratio": ratio}

    t0 = time.time()
    S, Q, h = env.generate_state_csr()
    ell = ell_from_scipy(S, Q, h, device=device)
    cuda_sync(ell)
    rec["K"] = S.shape[0]
    rec["nnz_S"] = int(S.nnz)
    rec["degS"] = int(ell.s_cols.shape[1])
    rec["state_mb"] = _nbytes(ell) / 2**20
    rec["build_s"] = time.time() - t0

    alg = MMWEll(nit=nit, eta=eta, use_bcsr=True, nattempt=nattempt)
    t0 = time.time()
    alg.prepare(ell, S, Q, block=block, flat_group=8)
    cuda_sync(alg.bcsr)
    rec["bcsr_build_s"] = time.time() - t0
    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = alg
    snap = launch_snapshot()
    t0 = time.time()
    z_vec, Z, rem = bs.run(ell)
    rec["solve_s"] = time.time() - t0
    rec["launches"] = launches_since(snap)
    rec["probe_Z"] = [int(x) for x in
                      bs.LOGGED_NP_DATA["bs_search_per_it"][:, 5]]
    rec["Z"] = int(Z)
    rec["rem"] = int(rem)
    ok, ni, na = verify_assignment_csr(S, Q, h, np.asarray(z_vec)[:ell.K])
    rec["verified"] = dict(ok=bool(ok), interf=int(ni), asso=int(na))

    t0 = time.time()
    bler = env.evaluate_bler(np.asarray(z_vec)[: ell.K], int(Z))
    rec["bler_eval_s"] = time.time() - t0
    rec["bler_mean"] = float(np.mean(bler))
    rec["bler_max"] = float(np.max(bler))
    rec["frac_above_1e-5"] = float(np.mean(bler > 1e-5))
    print(f"ratio={ratio}: K={rec['K']} nnz={rec['nnz_S']} "
          f"degS={rec['degS']} Z={Z} rem={rem} "
          f"frac>1e-5={rec['frac_above_1e-5']:.4f} "
          f"solve={rec['solve_s']:.1f}s")
    return rec


def main(argv=None):
    from sig_sdp_mmw_torch.experiments.common import card_info
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", type=int, default=100)
    ap.add_argument("--rho", type=float, default=75e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nit", type=int, default=150)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--nattempt", type=int, default=10)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--ratios", type=float, nargs="*",
                    default=[0.1, 0.03, 0.01])
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)

    rows = []
    for r in a.ratios:
        rows.append(run_one(r, a.cell, a.rho, a.seed, a.nit, a.eta,
                            a.nattempt, a.block, device=device))
        print("[bler_tail_sweep] " + json.dumps(rows[-1]))
    out = {"config": vars(a), "device": card_info(device), "rows": rows,
           "conclusion": None}
    if len(rows) >= 2:
        f0, f1 = rows[0]["frac_above_1e-5"], rows[-1]["frac_above_1e-5"]
        out["conclusion"] = (
            f"lowering min_s_n_ratio {rows[0]['min_s_n_ratio']} -> "
            f"{rows[-1]['min_s_n_ratio']} moves the >1e-5 tail "
            f"{f0:.4f} -> {f1:.4f} at a state cost "
            f"{rows[0]['nnz_S']} -> {rows[-1]['nnz_S']} nnz and solve "
            f"{rows[0]['solve_s']:.1f} -> {rows[-1]['solve_s']:.1f} s")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {a.out}")
    return out


if __name__ == "__main__":
    main()
