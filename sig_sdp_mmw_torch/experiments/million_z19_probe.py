"""Extended-budget probe of Z=19 at K=1M: is 19 feasible when the solve
and the rounding get more budget than the search's probes?

Port of ``tools/million_z19_probe.py``.  The million-link search
(``MILLION_LINK_E2E.json``: probes at nit 60, 3 rounding attempts) answers
Z_fin 20, its probe at 19 missing by one user; ``MILLION_LINK_FEASIBLE.json``
rounds 19 at nit 90.  This probe solves the same instance
(``LargeEnv(580, 75e-4, seed=0)``, K=1,009,200) at Z=19 with nit 120 in
segments of 3 (eta 0.05, D_pad 48, 2 rSVD iterations, ``gram_mode="edge"``,
``spmm_row_chunk=2048``), on 128x128 bf16 blocks without the stored
transpose and with bf16 weights, rounds with the native scan (10
attempts, the host S̃ᵀ CSR built once) and checks the assignment with
``verify_assignment_csr``.  S̃ and Q go through kernel #3, the block-ELL
one; S̃ᵀ through ``bcsr_spmm_transpose``.

``lanczos_m`` is 8, not the tool's 6: 6 is below the m >= 8 floor of the
solver (``models/mmw.py``'s ``mmw_default_lanczos_m``), and the port's 1M
path runs at 8.

Draws: the tool's ``PRNGKey(5)`` for the solve and ``PRNGKey(77)`` for the
rounding, here ``TorchDraws(5)`` and ``TorchDraws(77)``; ``main(draws=)``
takes others.  The tool appends its result into the repo's
``MILLION_LINK_E2E.json``; this writes its record, with the card and the
kernel launches by route, only to ``--out``.

    python -m sig_sdp_mmw_torch.experiments.million_z19_probe --out z19.json
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)


def tool_draws(device):
    """The tool's draws by role: ``draws(role)``, "solve" or "round"."""
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    def draws(role):
        return TorchDraws({"solve": 5, "round": 77}[role], device)
    return draws


def probe(S, Q, h, Z, nit=120, segment=3, lanczos_m=8, nattempt=10,
          device="cuda", draws=None):
    """The tool's body on a CSR state: the segmented solve at Z, the
    rounding and the verification.  Returns the record."""
    from sig_sdp_mmw_torch.core.ell import build_st_csr, ell_slim_from_csr
    from sig_sdp_mmw_torch.experiments.common import (launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.models.rounding_ell import (rounding_native_csr,
                                                       verify_assignment_csr)
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    draws = draws or tool_draws(device)
    t0 = time.time()
    slim = ell_slim_from_csr(S, Q, h, device=device)
    ops = bcsr_operands_from_state(S, Q, block=128, dtype=torch.bfloat16,
                                   store_transpose=False,
                                   weights_dtype=torch.bfloat16,
                                   device=device)
    cuda_sync(ops)
    StT = build_st_csr(S, Q).transpose().tocsr()
    build_s = time.time() - t0

    kw = dict(nit=nit, eta=0.05, D_pad=48, rank_pad=48, lanczos_m=lanczos_m,
              spmm_row_chunk=2048, gram_mode="edge", rsvd_iters=2, bcsr=ops,
              draws=draws("solve"))
    snap = launch_snapshot()
    t0 = time.time()
    c = None
    for i0 in range(0, nit, segment):
        c = mmw_solve_ell(slim, float(Z), carry_in=c, it_start=i0,
                          num_steps=min(segment, nit - i0), return_carry=True,
                          **kw)
        if (i0 // segment) % 10 == 0:
            cuda_sync(slim)
            print(f"seg..{i0 + segment} [{time.time() - t0:.0f}s]")
    out = mmw_solve_ell(slim, float(Z), carry_in=c, it_start=nit,
                        num_steps=0, **kw)
    ub = float(out.ub_final)
    solve_s = time.time() - t0
    launches = launches_since(snap)
    print(f"solve ub={ub:.4f} [{solve_s:.0f}s]")

    t0 = time.time()
    z, _, rem = rounding_native_csr(Z, out.X_half, S, Q, h, draws("round"),
                                    nattempt=nattempt, StT_csr=StT)
    round_s = time.time() - t0
    ok, ni, na = verify_assignment_csr(S, Q, h, z)
    print(f"rem={rem} verify ok={ok} ({ni},{na}) [{round_s:.0f}s]")
    return dict(Z=int(Z), nit=nit, nattempt=nattempt, lanczos_m=lanczos_m,
                ub=ub, rem=int(rem),
                verified=dict(ok=bool(ok), interf=int(ni), asso=int(na)),
                build_s=build_s, solve_s=solve_s, round_s=round_s,
                launches=launches)


def main(cell=580, Z=19, nit=120, segment=3, lanczos_m=8, nattempt=10,
         device="cuda", out=None, draws=None):
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments.common import card_info
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    t0 = time.time()
    S, Q, h = LargeEnv(cell, 75e-4, seed=0).generate_state_csr()
    lb = int(np.diff(Q.indptr).max()) + 1
    rec = {"device": card_info(device), "cell": cell, "K": int(S.shape[0]),
           "lb": lb, "generate_s": time.time() - t0}
    rec["z19_extended_probe"] = probe(S, Q, h, Z, nit, segment, lanczos_m,
                                      nattempt, device, draws)
    print("[million_z19_probe] " + json.dumps(rec))
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", type=int, default=580)
    ap.add_argument("--Z", type=int, default=19)
    ap.add_argument("--nit", type=int, default=120)
    ap.add_argument("--segment", type=int, default=3)
    ap.add_argument("--lanczos-m", type=int, default=8)
    ap.add_argument("--nattempt", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.Z, a.nit, a.segment, a.lanczos_m, a.nattempt,
         device=a.device, out=a.out)
