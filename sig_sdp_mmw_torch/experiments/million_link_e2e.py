"""Million-link end-to-end pipeline on the port (counterpart of
``tools/million_link_e2e.py``): min-Z bisection, convergence at the found Z,
rounding, independent verification and BLER at K ~ 1M on one card.

* state: ``LargeEnv(cell, rho, seed)`` (cell 580: K = 1,009,200), the slim
  state (``ell_slim_from_csr``, no O(K*deg) arrays on the device) and the
  block operands (128x128 bfloat16 blocks with stored transpose, bfloat16
  symmetrization weights; the native packer builds them), all on
  ``device``, which is checked;
* every MMW solve runs in segments of ``segment`` iterations passing the
  solver carry (:func:`sig_sdp_mmw_torch.models.mmw_ell.mmw_solve_ell`),
  with ``gram_mode="edge"`` and ``spmm_row_chunk``; every S̃, S̃ᵀ and Q
  product goes through :func:`sig_sdp_mmw_torch.ops.bcsr.bcsr_spmm` (the
  block-ELL CUDA kernel on the card);
* search: the tool's own window bisection over [lb, lb + win] with the
  both-infeasible window shift; each probe is a solve at ``nit_probe``,
  ``eta_probe`` with one subspace iteration in the epilogue, then the
  native rounding and the verifier;
* convergence: a solve at the found Z with ``nit_conv``, ``eta_conv``,
  logging the averaged-primal violation (:func:`mmw_ell_ub_from_carry`)
  every ``max(segment, 25)`` iterations; the final rounding falls back to
  the search probe's assignment when it misses;
* BLER on the full channel (sparse evaluator), unless ``skip_bler``.

Draws come from :class:`sig_sdp_mmw_torch.utils.draws.TorchDraws` seeded 17,
one stream per role as the tool folds its key (probe solve: Z, probe
rounding: 1000 + Z, convergence: 777, final rounding: 4242).  Returns the
record; writes it as JSON, and the assignment beside it, only to
``out_path``.

    python -m sig_sdp_mmw_torch.experiments.million_link_e2e --out run.json
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)

DRAW_SEED = 17


def main(cell=580, rho=75e-4, seed=0, block=128, d_pad=48,
         nit_probe=120, eta_probe=0.05, nit_conv=625, eta_conv=0.04,
         segment=5, lanczos_m=8, nattempt=3, store_transpose=True,
         gram_mode="edge", row_chunk=2048, out_path=None, skip_bler=False,
         win=8, device="cuda"):
    from sig_sdp_mmw_torch.core.ell import build_st_csr, ell_slim_from_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.models.mmw_ell import (mmw_ell_ub_from_carry,
                                                  mmw_solve_ell)
    from sig_sdp_mmw_torch.models.rounding_ell import (rounding_native_csr,
                                                       verify_assignment_csr)
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_torch.utils.draws import TorchDraws
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    rec = {"config": dict(cell=cell, rho=rho, seed=seed, block=block,
                          d_pad=d_pad, nit_probe=nit_probe,
                          eta_probe=eta_probe, nit_conv=nit_conv,
                          eta_conv=eta_conv, segment=segment,
                          lanczos_m=lanczos_m, nattempt=nattempt,
                          store_transpose=store_transpose,
                          gram_mode=gram_mode, row_chunk=row_chunk, win=win),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "phases_s": {}, "probes": []}
    ph = rec["phases_s"]

    def save():
        if out_path:
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)

    # ---- state -------------------------------------------------------------
    t0 = time.time()
    env = LargeEnv(cell, rho, seed=seed)
    S, Q, h = env.generate_state_csr()
    K = S.shape[0]
    rec["K"] = K
    rec["nnz_S"] = int(S.nnz)
    ph["generate"] = time.time() - t0
    print(f"generate K={K} nnz={S.nnz} [{ph['generate']:.1f}s]")

    t0 = time.time()
    Br, Bc = (block, block) if isinstance(block, int) else block
    lcm = Br * Bc // math.gcd(Br, Bc)
    Kp_pad = ((K + lcm - 1) // lcm) * lcm
    slim = ell_slim_from_csr(S, Q, h, pad_rows_to=Kp_pad, device=device)
    ops = bcsr_operands_from_state(S, Q, block=block, dtype=torch.bfloat16,
                                   store_transpose=store_transpose,
                                   weights_dtype=torch.bfloat16,
                                   device=device)
    cuda_sync(ops)
    ph["build"] = time.time() - t0
    devices = sorted(slim.tensor_devices() | ops.tensor_devices())
    rec["operand_devices"] = devices
    if devices != [device.type]:
        raise RuntimeError(f"operands on {devices}, asked for {device}")
    rec["bcsr_maxblk"] = int(ops.s_blocks.bcols.shape[1])
    rec["block_fill_pct"] = 100 * S.nnz / ops.s_blocks.blocks.numel()
    print(f"build maxblk={rec['bcsr_maxblk']} "
          f"fill={rec['block_fill_pct']:.3f}% on {devices} "
          f"[{ph['build']:.1f}s]")

    # Host S̃ᵀ CSR for the native greedy rounding, built once.
    t0 = time.time()
    StT_host = build_st_csr(S, Q).transpose().tocsr()
    Q_host = Q.tocsr()
    ph["stt_build"] = time.time() - t0
    save()

    def solve_kw(nit, eta, rsvd_iters):
        return dict(nit=nit, eta=eta, D_pad=d_pad, rank_pad=d_pad,
                    lanczos_m=lanczos_m, spmm_row_chunk=row_chunk,
                    gram_mode=gram_mode, rsvd_iters=rsvd_iters, bcsr=ops)

    def run_solve(Z, nit, eta, stream, rsvd_iters, curve_every=None,
                  tag=""):
        kw = solve_kw(nit, eta, rsvd_iters)
        draws = TorchDraws(DRAW_SEED, device, stream=stream)
        c = None
        curve = []
        t0 = time.time()
        for i0 in range(0, nit, segment):
            n = min(segment, nit - i0)
            c = mmw_solve_ell(slim, float(Z), draws=draws, carry_in=c,
                              it_start=i0, num_steps=n, return_carry=True,
                              **kw)
            i1 = i0 + n
            if curve_every and (i1 % curve_every == 0 or i1 == nit):
                u = float(mmw_ell_ub_from_carry(slim, float(Z), c, i1))
                curve.append([i1, u])
                print(f"  {tag} it={i1} ub={u:.4f} [{time.time()-t0:.0f}s]")
        out = mmw_solve_ell(slim, float(Z), draws=draws, carry_in=c,
                            it_start=nit, num_steps=0, **kw)
        u = float(out.ub_final)
        dt = time.time() - t0
        print(f"  {tag} solve ub={u:.4f} [{dt:.1f}s, {dt/nit:.3f}s/it]")
        return out, u, curve, dt

    def round_and_verify(Z, X_half, stream, tag=""):
        t0 = time.time()
        z_vec, _, rem = rounding_native_csr(
            int(Z), X_half, S, Q_host, h,
            TorchDraws(DRAW_SEED, device, stream=stream), nattempt=nattempt,
            StT_csr=StT_host)
        dt_r = time.time() - t0
        t0 = time.time()
        ok, ni, na = verify_assignment_csr(S, Q, h, z_vec)
        dt_v = time.time() - t0
        print(f"  {tag} rounding rem={rem} verify ok={ok} "
              f"interf={ni} asso={na} [{dt_r:.1f}s + {dt_v:.1f}s]")
        return z_vec, int(rem), bool(ok), dt_r

    # ---- min-Z bisection (the tool's window semantics) ---------------------
    lb = int(np.diff(Q.indptr).max()) + 1
    rec["lb"] = lb
    lo, hi = lb, lb + win
    feasible = {}          # Z -> z_vec
    t_search = time.time()
    nprobe = 0
    while lo <= hi:
        mid = (lo + hi + 1) // 2
        nprobe += 1
        print(f"probe #{nprobe}: Z={mid} window=[{lo},{hi}]")
        out, u, _, dt_s = run_solve(mid, nit_probe, eta_probe, mid,
                                    rsvd_iters=1, tag=f"Z={mid}")
        z_vec, rem, ok, dt_r = round_and_verify(mid, out.X_half, 1000 + mid,
                                                tag=f"Z={mid}")
        rec["probes"].append(dict(Z=mid, ub=u, rem=rem, verified=ok,
                                  solve_s=dt_s, round_s=dt_r))
        save()
        if rem == 0 and ok:
            feasible[mid] = z_vec
            hi = mid - 1
        else:
            lo = mid + 1
        if not feasible and lo > hi:
            # Both-bounds-infeasible window shift.
            if hi >= lb + 64:
                raise RuntimeError(f"no feasible Z up to {hi}")
            lo, hi = hi + 1, hi + max(hi - lo, 2)
            print(f"window shift -> [{lo},{hi}]")
    Z_fin = min(feasible)
    rec["Z_fin"] = int(Z_fin)
    ph["search"] = time.time() - t_search
    rec["n_probes"] = nprobe
    print(f"search: Z_fin={Z_fin} after {nprobe} probes "
          f"[{ph['search']:.1f}s]")
    save()

    # ---- convergence at Z_fin ----------------------------------------------
    t0 = time.time()
    out, u, curve, _ = run_solve(Z_fin, nit_conv, eta_conv, 777,
                                 rsvd_iters=3, curve_every=max(segment, 25),
                                 tag=f"conv Z={Z_fin}")
    rec["conv_curve"] = curve
    rec["ub_final"] = u
    ph["convergence"] = time.time() - t0
    save()

    z_vec, rem, ok, dt_r = round_and_verify(Z_fin, out.X_half, 4242,
                                            tag="final")
    rec["final"] = dict(Z=int(Z_fin), rem=rem, verified=ok, round_s=dt_r)
    if rem != 0:
        print("final rounding missed; using the search probe's assignment")
        z_vec = feasible[Z_fin]
        rec["final"]["used_probe_assignment"] = True
        rec["final"]["rem"] = 0
    # The independent verdict on the assignment this run hands back.
    ok, ni, na = verify_assignment_csr(S, Q, h, z_vec)
    rec["remainder"] = rec["final"]["rem"]
    rec["verified_feasible"] = bool(ok)
    rec["n_interf_vio"], rec["n_asso_vio"] = int(ni), int(na)
    if out_path:
        np.savez_compressed(os.path.splitext(out_path)[0] + "_assignment.npz",
                            z_vec=np.asarray(z_vec), Z=Z_fin, cell=cell,
                            seed=seed)
    save()

    # ---- BLER on the full channel (sparse evaluator) -----------------------
    if not skip_bler:
        t0 = time.time()
        bler = env.evaluate_bler(np.asarray(z_vec)[:K], int(Z_fin))
        ph["bler"] = time.time() - t0
        rec["bler"] = dict(mean=float(np.mean(bler)), max=float(np.max(bler)),
                           frac_above_1e5=float(np.mean(bler > 1e-5)),
                           p99=float(np.quantile(bler, 0.99)))
        print(f"bler mean={rec['bler']['mean']:.3e} "
              f"max={rec['bler']['max']:.3e} "
              f"frac>1e-5={rec['bler']['frac_above_1e5']:.3f} "
              f"[{ph['bler']:.1f}s]")
    rec["total_s"] = sum(ph.values())
    save()
    print(f"DONE total={rec['total_s']:.1f}s"
          + (f" -> {out_path}" if out_path else ""))
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=580)
    ap.add_argument("--rho", type=float, default=75e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nit-probe", type=int, default=120)
    ap.add_argument("--eta-probe", type=float, default=0.05)
    ap.add_argument("--nit-conv", type=int, default=625)
    ap.add_argument("--eta-conv", type=float, default=0.04)
    ap.add_argument("--segment", type=int, default=5)
    ap.add_argument("--lanczos-m", type=int, default=8)
    ap.add_argument("--nattempt", type=int, default=3)
    ap.add_argument("--no-transpose", action="store_true")
    ap.add_argument("--gram", type=str, default="edge")
    ap.add_argument("--row-chunk", type=int, default=2048)
    ap.add_argument("--win", type=int, default=8)
    ap.add_argument("--skip-bler", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.rho, a.seed, nit_probe=a.nit_probe,
         eta_probe=a.eta_probe, nit_conv=a.nit_conv, eta_conv=a.eta_conv,
         segment=a.segment, lanczos_m=a.lanczos_m, nattempt=a.nattempt,
         store_transpose=not a.no_transpose, gram_mode=a.gram,
         row_chunk=a.row_chunk, win=a.win, skip_bler=a.skip_bler,
         out_path=a.out, device=a.device)
