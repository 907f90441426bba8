"""BLER-tail mitigation at K~100k: the baseline state against states whose
``h_max`` carries the expected sub-threshold interference
(``env/large.py::tail_margin_h``, ``LargeEnv(tail_margin_z=)``).

Port of ``tools/bler_tail_fix.py`` (record ``BLER_TAIL_FIX.json``).  For each
``tail_margin_z`` in ``tail_zs`` (default None, 8, 5; the record holds the
first two): the state ``LargeEnv(cell, 75e-4, seed=0, tail_margin_z=)``, a
bisection for the least Z in [lb, lb + 8], each probe one block-sparse MMW
solve (nit 60, eta 0.05, D_pad 48, ``lanczos_m=8``, 2 rSVD iterations)
rounded by the native scan (6 attempts) and checked by
``verify_assignment_csr``, then ``LargeEnv.evaluate_bler`` at the least
feasible Z.  A case whose window holds no feasible Z is recorded with
``Z_fin`` None (the JAX tool stops there).

Draws: the probe at Z solves with ``TorchDraws(3, stream=Z)`` and rounds
with ``TorchDraws(3, stream=99 + Z)`` (the tool's ``fold_in(PRNGKey(3), Z)``
and ``fold_in(PRNGKey(3), 99 + Z)``); ``run_case(draws=)`` takes others.
The block operands hold 128x128 bf16 blocks with the stored transpose and
the flat twins (groups of 8): S̃ and S̃ᵀ go through kernel #1 and Q through
kernel #3 (the tool puts all on the block-ELL product).  Each case
records its kernel launches by route and its seconds; the record names the
card.  Writes JSON only to ``--out`` (after every case).

    python -m sig_sdp_mmw_torch.experiments.bler_tail_fix --out tail_fix.json
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)


def run_case(cell, tail_z, nit=60, nattempt=6, win=8, block=128,
             device="cuda", draws=None):
    """One case of the tool (``run_case``): the search, the verification
    and the BLER statistics.  ``draws(role, Z)``: the draws object of the
    probe at Z, ``role`` "solve" or "round"."""
    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments.common import (launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.models.rounding_ell import (rounding_native_csr,
                                                       verify_assignment_csr)
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_torch.utils.draws import TorchDraws
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    if draws is None:
        def draws(role, Z):
            return TorchDraws(3, device, stream=Z if role == "solve"
                              else 99 + Z)
    env = LargeEnv(cell, 75e-4, seed=0, tail_margin_z=tail_z)
    S, Q, h = env.generate_state_csr()
    slim = ell_slim_from_csr(S, Q, h, device=device)
    ops = bcsr_operands_from_state(S, Q, block=block, dtype=torch.bfloat16,
                                   store_transpose=True, flat_group=8,
                                   device=device)
    cuda_sync(ops)
    lb = int(np.diff(Q.indptr).max()) + 1
    D_pad = 48

    snap = launch_snapshot()
    lo, hi = lb, lb + win
    best = None
    probes = []
    while lo <= hi:
        mid = (lo + hi + 1) // 2
        t0 = time.time()
        out = mmw_solve_ell(slim, float(mid), nit=nit, eta=0.05, D_pad=D_pad,
                            rank_pad=D_pad, draws=draws("solve", mid),
                            lanczos_m=8, bcsr=ops, rsvd_iters=2)
        u = float(out.ub_final)
        z, _, rem = rounding_native_csr(mid, out.X_half, S, Q, h,
                                        draws("round", mid),
                                        nattempt=nattempt)
        probes.append(dict(Z=mid, ub=u, rem=int(rem), s=time.time() - t0))
        print(f"  tail_z={tail_z} probe Z={mid} ub={u:.3f} rem={rem}")
        if rem == 0:
            ok, ni, na = verify_assignment_csr(S, Q, h, z)
            if not ok:
                raise AssertionError(f"rem 0 at Z={mid} but the checker "
                                     f"finds {ni} interference and {na} "
                                     "association violations")
            best = (mid, z, dict(ok=True, interf=ni, asso=na))
            hi = mid - 1
        else:
            lo = mid + 1
    rec = dict(tail_margin_z=tail_z, K=int(S.shape[0]), lb=lb, Z_fin=None,
               probes=probes, launches=launches_since(snap))
    if best is None:
        print(f"  tail_z={tail_z}: no feasible Z in [{lb}, {lb + win}]")
        return rec
    Z_fin, z_vec, verified = best
    t0 = time.time()
    bler = env.evaluate_bler(z_vec, Z_fin)
    rec.update(Z_fin=int(Z_fin), verified=verified,
               bler_mean=float(np.mean(bler)), bler_max=float(np.max(bler)),
               frac_above_1e5=float(np.mean(bler > 1e-5)),
               p99=float(np.quantile(bler, 0.99)), bler_s=time.time() - t0)
    return rec


def main(cell=183, tail_zs=(None, 8, 5), device="cuda", out=None):
    from sig_sdp_mmw_torch.experiments.common import card_info
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    rec = {"device": card_info(device), "cell": cell, "cases": []}
    for tz in tail_zs:
        t0 = time.time()
        case = run_case(cell, tz, device=device)
        case["case_s"] = time.time() - t0
        print("[bler_tail_fix] " + json.dumps(case))
        rec["cases"].append(case)
        if out:
            with open(out, "w") as f:
                json.dump(rec, f, indent=1)
    if out:
        print(f"wrote {out}")
    return rec


def _tail_z(s: str):
    return None if s.lower() == "none" else int(s)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--tail-zs", type=_tail_z, nargs="*",
                    default=[None, 8, 5], help="None for no margin")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, tuple(a.tail_zs), device=a.device, out=a.out)
