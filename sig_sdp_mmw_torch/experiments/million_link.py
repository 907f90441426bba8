"""Million-link pipeline on one card: generation, the memory budget, the
segmented block-native MMW solve with its upper-bound curve, the device
rounding and the independent verification.

Port of ``tools/million_link.py`` (records ``MILLION_LINK.json``,
``MILLION_LINK_FEASIBLE.json``, ``MILLION_LINK_CONVERGENCE.json``,
``MILLION_LINK_NIT60.json``).  Phases, each timed in ``phases_s``:

1. generate ``LargeEnv(cell, rho, seed)`` (cell 580: K=1,009,200);
2. the slim solver state on the host (rows padded to the block grid);
3. the block operands on the host at ``--block`` (the records use 64):
   bf16 blocks, bf16 weights, no stored transpose by default; then the
   budget table: the slim state's and the operands' bytes, the tool's
   estimate of the solver's working set at D_pad, and, in place of the
   tool's XLA memory analysis and its 16 GB of TPU memory, the card's own
   numbers (``torch.cuda.max_memory_allocated`` after the build and after
   the solve, ``get_device_properties().total_memory``);
4. the move onto ``device``, then the solve at Z = lb + ``z_extra``:
   with ``segment`` (< nit) in segments passing the solver carry, the
   bound of the averaged primal read at every boundary
   (``mmw_ell_ub_from_carry``; the first segment's time is ``compile``,
   which holds the kernels' build on first use); else one solve and, unless
   ``skip_warm``, a second with other draws (the tool's ``solve`` and
   ``solve_warm``; nothing is compiled in torch);
5. with ``do_rounding``: the device rounding (``rounding_ell``) on
   ``env.generate_ell(pad_rows_to=Kp)`` with ``nattempt`` attempts, then
   ``verify_assignment_csr``.

Every phase is guarded as in the tool: a failure is recorded in the JSON
with its numbers, and then raised, so the run exits non-zero (the tool
returns a record after a failed solve or rounding; here no failed phase
leaves a record that reads as a result).  S̃ and Q go through kernel #3,
the block-ELL one (``"short_bf16"`` at 64x64, ``"ring"`` at 128x128);
S̃ᵀ through ``bcsr_spmm_transpose``.  The record gains the card and the
launches by route.

Draws: the tool's ``PRNGKey(0)`` for the solve, ``fold_in(key, 1)`` for
the warm solve and ``PRNGKey(7)`` for the rounding; here ``TorchDraws(s)``,
``TorchDraws(s, stream=1)`` and ``TorchDraws(7, stream=s)`` for
``--draw-seed`` s (default 0); ``main(draws=)`` takes others.  Writes JSON
only to ``--out`` (after every phase).

    python -m sig_sdp_mmw_torch.experiments.million_link --block 64 \\
        --nit 90 --segment 3 --z-extra 6 --rounding --out feasible.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)


def _gb(nbytes):
    return nbytes / 2**30


def tensor_bytes(obj) -> int:
    """Bytes of every tensor field of a container, nested ones included."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def seed_draws(seed, device):
    """``draws(role)``, role "solve", "warm" or "round": the tool's draws
    on draw seed ``seed`` (the tool's at 0)."""
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    def draws(role):
        if role == "round":
            return TorchDraws(7, device, stream=seed)
        return TorchDraws(seed, device, stream=int(role == "warm"))
    return draws


def main(cell=580, rho=75e-4, seed=0, nit=3, block=128, d_pad=None,
         do_rounding=False, out_path=None, lanczos_m=8, row_chunk=2048,
         skip_warm=False, nattempt=1, segment=0, z_extra=4,
         store_transpose=False, gram_mode="edge", draw_seed=0,
         device="cuda", draws=None):
    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments.common import (card_info,
                                                      launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.models.mmw_ell import (mmw_ell_ub_from_carry,
                                                  mmw_solve_ell)
    from sig_sdp_mmw_torch.models.rounding_ell import (rounding_ell,
                                                       verify_assignment_csr)
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    on_card = device.type == "cuda"
    draws = draws or seed_draws(draw_seed, device)
    rec = {"config": {"cell": cell, "rho": rho, "seed": seed, "nit": nit,
                      "block": block, "draw_seed": draw_seed,
                      "lanczos_m": lanczos_m, "nattempt": nattempt},
           "device": card_info(device), "phases_s": {}, "budget_gb": {}}
    ph = rec["phases_s"]

    def save():
        rec["total_s"] = sum(ph.values())
        if out_path:
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"wrote {out_path}")

    @contextlib.contextmanager
    def guarded(key, width=400):
        """Record a failure of the phase under ``key``, save, re-raise."""
        try:
            yield
        except Exception as exc:
            rec[key] = f"{type(exc).__name__}: {exc}"[:width]
            save()
            raise

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    with guarded("generate_error"):
        t0 = time.time()
        env = LargeEnv(cell, rho, seed=seed)
        S, Q, h = env.generate_state_csr()
        K = S.shape[0]
        rec.update(K=K, nnz_S=int(S.nnz), nnz_Q=int(Q.nnz))
        ph["generate"] = time.time() - t0
        print(f"generate: K={K} nnz(S)={S.nnz} nnz(Q)={Q.nnz} "
              f"[{ph['generate']:.1f}s]")

    with guarded("ell_error"):
        t0 = time.time()
        Br, Bc = (block, block) if isinstance(block, int) else block
        lcm = Br * Bc // math.gcd(Br, Bc)
        Kp_pad = ((K + lcm - 1) // lcm) * lcm
        slim = ell_slim_from_csr(S, Q, h, pad_rows_to=Kp_pad)
        ph["slim_build"] = time.time() - t0
        rec["budget_gb"]["slim_state"] = _gb(tensor_bytes(slim))
        print(f"slim: Kp={slim.Kp} E_pad={slim.E_pad} "
              f"{rec['budget_gb']['slim_state']:.3f} GB "
              f"[{ph['slim_build']:.1f}s]")

    with guarded("bcsr_error"):
        t0 = time.time()
        ops = bcsr_operands_from_state(S, Q, block=block,
                                       dtype=torch.bfloat16,
                                       store_transpose=store_transpose,
                                       weights_dtype=torch.bfloat16)
        ph["bcsr_build"] = time.time() - t0
        rec["budget_gb"]["bcsr_operands"] = _gb(tensor_bytes(ops))
        rec["bcsr_Kb"] = int(ops.s_blocks.Kb)
        rec["bcsr_maxblk"] = int(ops.s_blocks.bcols.shape[1])
        rec["block_fill_pct"] = 100 * S.nnz / ops.s_blocks.blocks.numel()
        print(f"bcsr: Kb={rec['bcsr_Kb']} maxblk={rec['bcsr_maxblk']} "
              f"fill={rec['block_fill_pct']:.3f}% "
              f"{rec['budget_gb']['bcsr_operands']:.3f} GB "
              f"[{ph['bcsr_build']:.1f}s]")

    # The tool's working-set estimate for the solver at sketch width D:
    # V-sized float32 buffers (sketch V, 3 live Lanczos vectors), the
    # averaged weights (nnz) and the edge values (nnz + E).
    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + z_extra)
    D_pad = d_pad if d_pad is not None else ((int(Z) * 2 + 15) // 16) * 16
    rec.update(lb=lb, Z_probe=Z, D_pad=D_pad)
    bud = rec["budget_gb"]
    v_bytes = slim.Kp * D_pad * 4
    work = 6 * v_bytes + 3 * S.nnz * 4 + 2 * slim.E_pad * 4
    bud["solver_working_set_est"] = _gb(work)
    bud["total_est"] = (bud["slim_state"] + bud["bcsr_operands"]
                        + bud["solver_working_set_est"])
    bud["device_total"] = (
        _gb(torch.cuda.get_device_properties(device).total_memory)
        if on_card else None)
    print(f"budget: {bud}")

    def measured(key):
        if on_card:
            bud[key] = _gb(torch.cuda.max_memory_allocated(device))

    kw = dict(nit=nit, eta=0.05, D_pad=D_pad, rank_pad=D_pad,
              lanczos_m=lanczos_m, spmm_row_chunk=row_chunk,
              gram_mode=gram_mode)
    with guarded("solve_error", 600):
        t0 = time.time()
        slim = slim.to(device)
        ops = ops.to(device)
        cuda_sync(ops)
        ph["device_transfer"] = time.time() - t0
        measured("measured_peak_after_build")
        print(f"transfer: [{ph['device_transfer']:.1f}s]")
        snap = launch_snapshot()
        d = draws("solve")
        if segment and segment < nit:
            ub_curve = []

            def seg(c, i0, i1):
                c = mmw_solve_ell(slim, Z, draws=d, bcsr=ops, carry_in=c,
                                  it_start=i0, num_steps=i1 - i0,
                                  return_carry=True, **kw)
                ub_i = float(mmw_ell_ub_from_carry(slim, Z, c, i1))
                ub_curve.append([i1, ub_i])
                return c, ub_i

            t0 = time.time()
            c, ub_i = seg(None, 0, segment)
            ph["compile"] = time.time() - t0
            rec["segment"] = segment
            print(f"segment 0..{segment} done ub={ub_i:.4f} "
                  f"(first segment {ph['compile']:.1f}s)")
            t0 = time.time()
            for i0 in range(segment, nit, segment):
                i1 = min(i0 + segment, nit)
                c, ub_i = seg(c, i0, i1)
                print(f"segment {i0}..{i1} done ub={ub_i:.4f} "
                      f"[{time.time() - t0:.0f}s]")
            rec["ub_curve"] = ub_curve
            out = mmw_solve_ell(slim, Z, draws=d, bcsr=ops, carry_in=c,
                                it_start=nit, num_steps=0, **kw)
            rec["ub_final"] = float(out.ub_final)
            ph["solve"] = time.time() - t0
            rec["s_per_iter"] = ph["solve"] / max(nit - segment, 1)
            print(f"solve nit={nit} (segmented): ub={rec['ub_final']:.4f} "
                  f"[{ph['solve']:.1f}s, {rec['s_per_iter']:.3f}s/iter "
                  "steady]")
        else:
            t0 = time.time()
            out = mmw_solve_ell(slim, Z, draws=d, bcsr=ops, **kw)
            rec["ub_final"] = float(out.ub_final)
            ph["solve"] = time.time() - t0
            rec["s_per_iter_first"] = ph["solve"] / nit
            print(f"solve nit={nit}: ub={rec['ub_final']:.4f} "
                  f"[{ph['solve']:.1f}s, {rec['s_per_iter_first']:.3f}s/iter"
                  " incl. the kernels' build on first use]")
            if not skip_warm:
                t0 = time.time()
                out = mmw_solve_ell(slim, Z, draws=draws("warm"), bcsr=ops,
                                    **kw)
                rec["ub_final"] = float(out.ub_final)
                ph["solve_warm"] = time.time() - t0
                rec["s_per_iter"] = ph["solve_warm"] / nit
                print(f"warm solve: {rec['s_per_iter']:.3f}s/iter")
        rec["launches"] = launches_since(snap)
        measured("measured_peak_after_solve")
    save()

    if do_rounding:
        with guarded("rounding_error"):
            t0 = time.time()
            # The full ELL state, built only now, padded to the operands'
            # rows so the factor and the state line up.
            ell = env.generate_ell(pad_rows_to=Kp_pad, device=device)
            bud["ell_state"] = _gb(tensor_bytes(ell))
            z_vec, _, rem = rounding_ell(int(Z), out.X_half, ell,
                                         draws("round"), nattempt=nattempt,
                                         Z_pad=((int(Z) + 15) // 16) * 16)
            ph["rounding"] = time.time() - t0
            rec["rounding_rem"] = int(rem)
            ok, ni, na = verify_assignment_csr(S, Q, h, z_vec)
            rec["verified"] = dict(ok=bool(ok), interf=int(ni), asso=int(na))
            print(f"rounding: rem={rem} verify={rec['verified']} "
                  f"[{ph['rounding']:.1f}s]")
    save()
    print("[million_link] " + json.dumps(rec))
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", type=int, default=580)
    ap.add_argument("--rho", type=float, default=75e-4)
    ap.add_argument("--nit", type=int, default=3)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--d-pad", type=int, default=None)
    ap.add_argument("--lanczos-m", type=int, default=8)
    ap.add_argument("--rounding", action="store_true")
    ap.add_argument("--row-chunk", type=int, default=2048)
    ap.add_argument("--skip-warm", action="store_true")
    ap.add_argument("--segment", type=int, default=0)
    ap.add_argument("--z-extra", type=int, default=4)
    ap.add_argument("--nattempt", type=int, default=1)
    ap.add_argument("--store-transpose", action="store_true")
    ap.add_argument("--gram", type=str, default="edge")
    ap.add_argument("--draw-seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.rho, nit=a.nit, block=a.block, d_pad=a.d_pad,
         do_rounding=a.rounding, out_path=a.out, lanczos_m=a.lanczos_m,
         row_chunk=a.row_chunk, skip_warm=a.skip_warm, nattempt=a.nattempt,
         segment=a.segment, z_extra=a.z_extra,
         store_transpose=a.store_transpose, gram_mode=a.gram,
         draw_seed=a.draw_seed, device=a.device)
