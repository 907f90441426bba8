"""End-to-end large-K pipeline on the port (counterpart of
``tools/e2e_large.py``).

Runs the whole contract on the sparse path, never forming a [K, K] matrix:
state generation -> ELL state -> block operands -> degree bounds -> search
over Z -> independent feasibility verification -> BLER, plus the BLER tail
decomposition and the heuristic rows MAX_GAIN_ELL and MAX_RAND_ELL at the
found Z (rem, verification, BLER and wall time each).

* ``search="binary"``: the reference's bisection, each probe one sparse MMW
  solve followed by ``MMWEll.rounding``; ``search="speculative"``: the
  waves of :class:`sig_sdp_mmw_torch.parallel.ParallelProbeSearchEll`
  (``wave`` candidates each, solves in segments of ``wave_segment``
  iterations when set).
* ``rounding="device"`` (the default, the JAX tool's): the ELL device
  rounding, on the route its Kp picks (the batched attempts up to 16,384
  rows, the wavefront above); ``"native"``: the C++ greedy scan on the host
  CSR state.
* ``flat_group`` set (the default, 8): every S̃ and S̃ᵀ matvec goes through
  the flat block-CSR CUDA kernel on the card; the association operator Q
  and the epilogue's block products through the block-ELL kernel.
  ``block``: 128 (128x128 blocks) or any other size (square blocks through
  the kernels' short-block tile).  ``d_pad`` caps the sketch width;
  ``row_chunk`` bounds the block-ELL plain versions' transients.

``device`` defaults to ``"cuda"`` and raises without a card; pass ``"cpu"``
for the plain versions on the CPU.  Returns the JAX tool's record keys (and
``rounding``, ``rounding_info``, ``wave_rows``);
writes them as JSON (and the assignment beside it) only when given
``out_path``.

    python -m sig_sdp_mmw_torch.experiments.e2e_large --cell 183 --out run.json
    python -m sig_sdp_mmw_torch.experiments.e2e_large --search speculative \
        --block 32 --cell 40
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)


def main(cell=183, rho=75e-4, seed=0, nit=150, eta=0.05, nattempt=10,
         block=128, out_path=None, use_bcsr=True, bf16=True, flat_group=8,
         device="cuda", search="binary", wave=4, row_chunk=None,
         wave_segment=None, d_pad=None, rounding="device"):
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.models.mmw_ell import MMWEll
    from sig_sdp_mmw_torch.models.rounding_ell import verify_assignment_csr
    from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    if search not in ("binary", "speculative"):
        raise ValueError(f"search must be 'binary' or 'speculative', got "
                         f"{search!r}")

    rec = {"config": {"cell": cell, "rho": rho, "seed": seed, "nit": nit,
                      "eta": eta, "nattempt": nattempt, "block": block,
                      "use_bcsr": use_bcsr, "bf16_blocks": bf16,
                      "flat_group": flat_group, "d_pad": d_pad,
                      "row_chunk": row_chunk},
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "rounding": rounding,
           "phases_s": {}}
    ph = rec["phases_s"]

    t0 = time.time()
    env = LargeEnv(cell, rho, seed=seed)
    S, Q, h = env.generate_state_csr()
    K = S.shape[0]
    rec["K"] = K
    rec["nnz_S"] = int(S.nnz)
    rec["nnz_Q"] = int(Q.nnz)
    ph["generate"] = time.time() - t0
    print(f"generate: K={K} nnz(S)={S.nnz} nnz(Q)={Q.nnz} "
          f"[{ph['generate']:.2f}s]")

    t0 = time.time()
    ell = env.generate_ell(device=device)
    cuda_sync(ell)
    ph["ell_build"] = time.time() - t0
    print(f"ell build: degS={ell.s_cols.shape[1]} E_pad={ell.E_pad} "
          f"Kp={ell.Kp} [{ph['ell_build']:.2f}s]")

    alg = MMWEll(nit=nit, eta=eta, use_bcsr=use_bcsr, nattempt=nattempt,
                 seed=seed, rounding=rounding)
    t0 = time.time()
    # bf16 blocks + stored transpose: half the bytes per matvec; products
    # still accumulate in float32.
    bkw = dict(dtype=torch.bfloat16 if bf16 else torch.float32,
               store_transpose=True, flat_group=flat_group)
    alg.prepare(ell, S, Q, h_max=h, block=block, **bkw)
    if use_bcsr:
        cuda_sync(alg.bcsr)
        ph["bcsr_build"] = time.time() - t0
        fl = alg.bcsr.s_flat
        print(f"bcsr build: Kb={alg.bcsr.s_blocks.Kb} "
              f"maxblk={alg.bcsr.s_blocks.bcols.shape[1]}"
              + (f" flat_steps={fl.nsteps}x{fl.G}" if fl is not None else "")
              + f" [{ph['bcsr_build']:.2f}s]")
    rec["operand_devices"] = sorted(
        ell.tensor_devices()
        | (alg.bcsr.tensor_devices() if use_bcsr else set()))

    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = alg

    t0 = time.time()
    lb, ub = bs.set_bounds(ell)
    rec["lb"], rec["ub"] = lb, ub
    ph["bounds"] = time.time() - t0
    print(f"bounds: lb={lb} ub={ub} [{ph['bounds']:.2f}s]")

    if d_pad is not None:
        # Cap the sketch width: D = Z*rank_radio columns are active per
        # probe; the window's upper bound would over-pad.
        alg._d_pad_for = lambda e, Z: (d_pad, min(d_pad, e.Kp - 1))

    t0 = time.time()
    if search == "speculative":
        from sig_sdp_mmw_torch.parallel import ParallelProbeSearchEll

        pp = ParallelProbeSearchEll(nit=nit, eta=eta, nattempt=nattempt,
                                    seed=seed, wave=wave, use_bcsr=use_bcsr,
                                    spmm_row_chunk=row_chunk,
                                    d_pad_cap=d_pad,
                                    wave_segment=wave_segment)
        pp._bcsr = alg.bcsr            # reuse the device operands
        z_vec, Z_fin, rem = pp.run(ell)
        ph["search"] = time.time() - t0
        waves = pp.LOGGED_NP_DATA["pp_wave"]
        rec["n_waves"] = int(waves.shape[0])
        rec["n_probes"] = int(waves[:, -3].sum())
        rec["wave_rows"] = [{"candidates": int(r[-3]), "solve_s": float(r[-2]),
                             "rounding_s": float(r[-1])} for r in waves]
        rec["probe_Z"] = sorted(pp.probed)
        rec["search_mode"] = f"speculative(wave={wave})"
    else:
        z_vec, Z_fin, rem = bs.run(ell)
        ph["search"] = time.time() - t0
        probes = np.asarray(alg.LOGGED_NP_DATA["mmw_all_it"])
        steps = np.asarray(bs.LOGGED_NP_DATA["bs_search_per_it"])
        rec["n_probes"] = int(probes.shape[0])
        rec["solve_us_per_probe"] = [float(x) for x in probes[:, -1]]
        rec["rounding_us_per_probe"] = [float(x) for x in steps[:, -1]]
        rec["probe_Z"] = [int(x) for x in steps[:, 5]]
        rec["rounding_info"] = alg.rounding_info
        rec["search_mode"] = "binary"
    rec["Z_fin"] = int(Z_fin)
    rec["remainder"] = int(rem)
    print(f"search[{rec['search_mode']}]: Z={Z_fin} rem={rem} "
          f"probes={rec['n_probes']} [{ph['search']:.2f}s]")

    t0 = time.time()
    ok, n_interf, n_asso = verify_assignment_csr(S, Q, h, z_vec)
    ph["verify"] = time.time() - t0
    rec["verified_feasible"] = bool(ok)
    rec["n_interf_vio"] = int(n_interf)
    rec["n_asso_vio"] = int(n_asso)
    print(f"verify: ok={ok} interf_vio={n_interf} asso_vio={n_asso} "
          f"[{ph['verify']:.2f}s]")

    t0 = time.time()
    bler = env.evaluate_bler(z_vec, int(Z_fin))
    ph["bler_eval"] = time.time() - t0
    rec["bler_mean"] = float(np.mean(bler))
    rec["bler_max"] = float(np.max(bler))
    rec["bler_frac_above_1e-5"] = float(np.mean(bler > 1e-5))
    print(f"bler: mean={rec['bler_mean']:.3e} max={rec['bler_max']:.3e} "
          f"frac>1e-5={rec['bler_frac_above_1e-5']:.4f} "
          f"[{ph['bler_eval']:.2f}s]")

    # Tail decomposition: the solver enforces the THRESHOLDED graph (rx
    # ratios below min_s_n_ratio are dropped by design) while the evaluation
    # charges the full channel.  Re-evaluating on the in-graph channel (exact
    # terms above min_s_n_ratio, no mean-field tail) separates thresholding
    # physics from solver error.  The in-graph channel keeps every same-slot
    # pair inside the cutoff radius, so it overcounts and the
    # subthreshold-only fraction is a lower bound.
    t0 = time.time()
    bler_g = env.evaluate_bler(z_vec, int(Z_fin),
                               eval_min_ratio=env.params.min_s_n_ratio,
                               tail_correction=False)
    rec["tail_decomposition"] = {
        "in_graph_min_ratio": env.params.min_s_n_ratio,
        "frac_above_1e-5_in_graph_channel": float(np.mean(bler_g > 1e-5)),
        "frac_above_1e-5_full_channel": rec["bler_frac_above_1e-5"],
        "frac_above_1e-5_from_subthreshold_only":
            float(np.mean((bler > 1e-5) & (bler_g <= 1e-5))),
    }
    ph["tail_decomp"] = time.time() - t0
    print(f"tail decomposition: {rec['tail_decomposition']} "
          f"[{ph['tail_decomp']:.2f}s]")

    # Heuristic baselines at the same Z (the sim_all_bler protocol at
    # scale), each with its own verification, BLER and wall time.
    from sig_sdp_mmw_torch.models.heuristics_ell import (MAX_GAIN_ELL,
                                                         MAX_RAND_ELL)

    Z_pad_h = ((int(Z_fin) + 15) // 16) * 16
    for name, cls in (("mgain", MAX_GAIN_ELL), ("mrand", MAX_RAND_ELL)):
        t0 = time.time()
        z_h, _, rem_h = cls.run(int(Z_fin), ell, Z_pad=Z_pad_h)
        wall = time.time() - t0
        ok_h, ni_h, na_h = verify_assignment_csr(S, Q, h, z_h)
        bler_h = env.evaluate_bler(z_h, int(Z_fin))
        rec[name] = {
            "rem": int(rem_h), "verified_feasible": bool(ok_h),
            "n_interf_vio": int(ni_h), "n_asso_vio": int(na_h),
            "bler_mean": float(np.mean(bler_h)),
            "bler_max": float(np.max(bler_h)),
            "bler_frac_above_1e-5": float(np.mean(bler_h > 1e-5)),
            "wall_s": wall,
        }
        print(f"{name}@Z={int(Z_fin)}: rem={rem_h} ok={ok_h} "
              f"bler mean={rec[name]['bler_mean']:.3e} "
              f"max={rec[name]['bler_max']:.3e} "
              f"frac>1e-5={rec[name]['bler_frac_above_1e-5']:.4f} "
              f"[{wall:.2f}s]")
        ph[f"heur_{name}"] = wall

    rec["total_s"] = sum(ph.values())
    if out_path:
        np.savez_compressed(os.path.splitext(out_path)[0] + "_assignment.npz",
                            z_vec=np.asarray(z_vec), Z=int(Z_fin), cell=cell,
                            seed=seed)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {out_path} (total {rec['total_s']:.2f}s)")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--rho", type=float, default=75e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nit", type=int, default=150)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--nattempt", type=int, default=10)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--no-bcsr", action="store_true")
    ap.add_argument("--d-pad", type=int, default=None)
    ap.add_argument("--search", type=str, default="binary",
                    choices=("binary", "speculative"))
    ap.add_argument("--wave", type=int, default=4)
    ap.add_argument("--wave-segment", type=int, default=None)
    ap.add_argument("--f32-blocks", action="store_true",
                    help="store BCSR blocks in float32 (default bfloat16)")
    ap.add_argument("--row-chunk", type=int, default=None)
    ap.add_argument("--flat-group", type=int, default=8,
                    help="flat block-CSR group size; 0 = block-ELL matvecs")
    ap.add_argument("--rounding", type=str, default="device",
                    choices=("device", "native"))
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.rho, a.seed, a.nit, a.eta, a.nattempt, a.block, a.out,
         use_bcsr=not a.no_bcsr, bf16=not a.f32_blocks,
         flat_group=a.flat_group or None, device=a.device, search=a.search,
         wave=a.wave, row_chunk=a.row_chunk, wave_segment=a.wave_segment,
         d_pad=a.d_pad, rounding=a.rounding)
