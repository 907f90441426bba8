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
``--draw-seeds`` runs each case once per seed s in place of 3
(``TorchDraws(s, stream=Z)``, ``TorchDraws(s, stream=99 + Z)``), each case
record carrying its ``draw_seed``.  ``--reround-attempts N``: where no seed
of a margin finds a feasible Z, each seed's probe at the window's top is
solved again with its own draws (the same factor) and rounded with N
attempts in place of ``nattempt``, as a report (``reround`` in the case);
the search's answer is not changed.
The block operands hold 128x128 bf16 blocks with the stored transpose and
the flat twins (groups of 8): S̃ and S̃ᵀ go through kernel #1 and Q through
kernel #3 (the tool puts all on the block-ELL product).  Each case
records its kernel launches by route and its seconds; the record names the
card.  Writes JSON only to ``--out`` (after every case).

    python -m sig_sdp_mmw_torch.experiments.bler_tail_fix --out tail_fix.json
    python -m sig_sdp_mmw_torch.experiments.bler_tail_fix --tail-zs 8 \
        --draw-seeds 0 1 2 3 4 5 6 7 --reround-attempts 10 --out seeds.json
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)


DRAW_SEED = 3


def seed_draws(seed, device):
    """The tool's draws by role on seed ``seed`` (the tool's is 3)."""
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    def draws(role, Z):
        return TorchDraws(seed, device, stream=Z if role == "solve"
                          else 99 + Z)
    return draws


def _case_state(cell, tail_z, block, device):
    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync

    env = LargeEnv(cell, 75e-4, seed=0, tail_margin_z=tail_z)
    S, Q, h = env.generate_state_csr()
    slim = ell_slim_from_csr(S, Q, h, device=device)
    ops = bcsr_operands_from_state(S, Q, block=block, dtype=torch.bfloat16,
                                   store_transpose=True, flat_group=8,
                                   device=device)
    cuda_sync(ops)
    return env, (S, Q, h), slim, ops


def _probe(state, slim, ops, Z, nit, nattempt, draws):
    """One probe at Z: the solve, then the native rounding.  Returns
    (ub, z_vec, rem)."""
    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.models.rounding_ell import rounding_native_csr

    D_pad = 48
    out = mmw_solve_ell(slim, float(Z), nit=nit, eta=0.05, D_pad=D_pad,
                        rank_pad=D_pad, draws=draws("solve", Z), lanczos_m=8,
                        bcsr=ops, rsvd_iters=2)
    z, _, rem = rounding_native_csr(Z, out.X_half, *state,
                                    draws("round", Z), nattempt=nattempt)
    return float(out.ub_final), z, int(rem)


def run_case(cell, tail_z, nit=60, nattempt=6, win=8, block=128,
             device="cuda", draws=None):
    """One case of the tool (``run_case``): the search, the verification
    and the BLER statistics.  ``draws(role, Z)``: the draws object of the
    probe at Z, ``role`` "solve" or "round" (default :func:`seed_draws` of
    the tool's seed 3)."""
    from sig_sdp_mmw_torch.experiments.common import (launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.models.rounding_ell import verify_assignment_csr
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    draws = draws or seed_draws(DRAW_SEED, device)
    env, state, slim, ops = _case_state(cell, tail_z, block, device)
    S, Q, h = state
    lb = int(np.diff(Q.indptr).max()) + 1

    snap = launch_snapshot()
    lo, hi = lb, lb + win
    best = None
    probes = []
    while lo <= hi:
        mid = (lo + hi + 1) // 2
        t0 = time.time()
        u, z, rem = _probe(state, slim, ops, mid, nit, nattempt, draws)
        probes.append(dict(Z=mid, ub=u, rem=rem, s=time.time() - t0))
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


def reround_top(cell, tail_z, nattempt, nit=60, win=8, block=128,
                device="cuda", draws=None):
    """A report: the probe at the window's top (lb + ``win``) solved with
    ``draws`` (the search's own factor there) and rounded with
    ``nattempt`` attempts; the first attempts draw as the search's did."""
    from sig_sdp_mmw_torch.models.rounding_ell import verify_assignment_csr
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    draws = draws or seed_draws(DRAW_SEED, device)
    _, state, slim, ops = _case_state(cell, tail_z, block, device)
    Z = int(np.diff(state[1].indptr).max()) + 1 + win
    u, z, rem = _probe(state, slim, ops, Z, nit, nattempt, draws)
    ok, ni, na = verify_assignment_csr(*state, z)
    print(f"  tail_z={tail_z} reround Z={Z} attempts={nattempt} ub={u:.3f} "
          f"rem={rem} verified={ok}")
    return dict(Z=Z, nattempt=nattempt, ub=u, rem=rem,
                verified=dict(ok=bool(ok), interf=int(ni), asso=int(na)))


def main(cell=183, tail_zs=(None, 8, 5), device="cuda", out=None,
         draw_seeds=(DRAW_SEED,), reround_attempts=None, nit=60):
    from sig_sdp_mmw_torch.experiments.common import card_info
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    rec = {"device": card_info(device), "cell": cell, "cases": []}

    def save():
        if out:
            with open(out, "w") as f:
                json.dump(rec, f, indent=1)

    for tz in tail_zs:
        cases = []
        for seed in draw_seeds:
            t0 = time.time()
            case = run_case(cell, tz, nit=nit, device=device,
                            draws=seed_draws(seed, device))
            case["draw_seed"] = seed
            case["case_s"] = time.time() - t0
            print("[bler_tail_fix] " + json.dumps(case))
            cases.append(case)
            rec["cases"].append(case)
            save()
        if reround_attempts and all(c["Z_fin"] is None for c in cases):
            for case in cases:
                case["reround"] = reround_top(
                    cell, tz, reround_attempts, nit=nit, device=device,
                    draws=seed_draws(case["draw_seed"], device))
                save()
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
    ap.add_argument("--draw-seeds", type=int, nargs="*", default=[DRAW_SEED])
    ap.add_argument("--reround-attempts", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, tuple(a.tail_zs), device=a.device, out=a.out,
         draw_seeds=tuple(a.draw_seeds),
         reround_attempts=a.reround_attempts)
