"""A/B of the users' ordering and the block height on the block-sparse MMW
iteration at K~100k: block fill, bytes streamed per iteration, ms per
iteration and the bound reached.

Port of ``tools/reorder_bench.py`` (record ``REORDER_BENCH.json``).  Five
runs on cell 183 (K=100,467; ``generate_large_state_csr(order=)``, a pure
relabelling of the users): raster order at 128x128 blocks, then Hilbert
order at 128x128, 8x128, 16x128 and 32x128.  Each run: the full ELL state
and the bf16 block operands with the stored transpose, Z = lb + 4, D_pad =
16·ceil(2Z/16), ``mmw_solve_ell`` at nit 30, eta 0.05, ``lanczos_m=8``; one
warm solve, then the median of 3 timed solves (each closed by
``torch.cuda.synchronize``).  Per run: fill %, maxblk, the tool's streamed
GB per iteration (the block-ELL S̃ blocks, padding included, read by
2m + 4 products), ms per iteration, the achieved GB/s and its share of
the H100's 3.35 TB/s (in place of the TPU's figure), ``ub_final`` of the
last timed solve, and the kernel launches by route.

The operands carry the flat twins (groups of 8, the port's 100k layout):
S̃ and S̃ᵀ go through kernel #1, on its ``"ring"`` tile at 128x128 and its
``"short_bf16"`` tile at 8/16/32x128, and Q through kernel #3 (the tool
puts every product on the block-ELL one).

Draws: the tool's ``PRNGKey(0)`` for the warm solve and ``fold_in(key, i)``
for timed solve i; here ``TorchDraws(0)`` and ``TorchDraws(0, stream=1 +
i)``; ``run_one(draws=)`` takes others.  Writes JSON only to ``--out``.

    python -m sig_sdp_mmw_torch.experiments.reorder_bench --out reorder.json
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)

RUNS = (("raster", 128), ("hilbert", 128), ("hilbert", (8, 128)),
        ("hilbert", (16, 128)), ("hilbert", (32, 128)))
HBM_GBPS = 3350.0       # the H100 SXM's memory rate, GB/s


def tool_draws(device):
    """The tool's draws: ``draws(i)``, None for the warm solve, else timed
    solve i."""
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    def draws(i):
        return TorchDraws(0, device, stream=0 if i is None else 1 + i)
    return draws


def run_one(order, cell=183, nit=30, lanczos_m=8, block=128, timed=3,
            device="cuda", draws=None):
    """One run of the tool (``run_one``); ``timed`` solves after the warm
    one (the tool's 3)."""
    from sig_sdp_mmw_torch.core.ell import ell_from_scipy
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr
    from sig_sdp_mmw_torch.experiments.common import (launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    draws = draws or tool_draws(device)
    block_t = tuple(block) if isinstance(block, (tuple, list)) else block
    S, Q, h = generate_large_state_csr(cell, 75e-4, seed=0, order=order)
    K = S.shape[0]
    ell = ell_from_scipy(S, Q, h, device=device)
    ops = bcsr_operands_from_state(S, Q, block=block_t, dtype=torch.bfloat16,
                                   store_transpose=True, flat_group=8,
                                   device=device)
    cuda_sync(ops)

    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + 4)
    D_pad = ((int(Z) * 2 + 15) // 16) * 16

    def solve(d):
        out = mmw_solve_ell(ell, Z, nit=nit, eta=0.05, D_pad=D_pad,
                            rank_pad=D_pad, draws=d, lanczos_m=lanczos_m,
                            bcsr=ops)
        cuda_sync(out.X_half)
        return out

    snap = launch_snapshot()
    t0 = time.time()
    out = solve(draws(None))
    print(f"[{order} {block}] first {time.time() - t0:.1f}s "
          f"ub={float(out.ub_final):.4f}")
    times = []
    for i in range(timed):
        t0 = time.perf_counter()
        out = solve(draws(i))
        times.append(time.perf_counter() - t0)
    launches = launches_since(snap)
    t = float(np.median(times))
    per_it = t / nit

    nnz = int(S.nnz)
    n_spmm = 2 * lanczos_m + 4
    blocks = ops.s_blocks.blocks
    blk_bytes = blocks.numel() * blocks.element_size()
    streamed = n_spmm * blk_bytes
    achieved = streamed / per_it / 1e9
    rec = {
        "order": order,
        "block": list(block) if isinstance(block, (tuple, list)) else block,
        "K": K,
        "nnz": nnz,
        "Z": Z,
        "D_pad": D_pad,
        "maxblk": int(ops.s_blocks.bcols.shape[1]),
        "block_fill_pct": 100 * nnz / blocks.numel(),
        "ms_per_iter": per_it * 1e3,
        "iters_per_sec": nit / t,
        "timed_s": times,
        "streamed_gb_per_iter": streamed / 1e9,
        "achieved_gbps": achieved,
        "share_of_hbm": achieved / HBM_GBPS,
        "ub_final": float(out.ub_final),
        "launches": launches,
    }
    print(f"[{order} {block}] {json.dumps(rec)}")
    return rec


def main(cell=183, nit=30, runs=RUNS, device="cuda", out=None):
    from sig_sdp_mmw_torch.experiments.common import card_info
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    rec = {"device": card_info(device),
           "config": f"cell={cell} rho=75e-4 nit={nit} m=8 bf16",
           "runs": []}
    for order, block in runs:
        rec["runs"].append(run_one(order, cell=cell, nit=nit, block=block,
                                   device=device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    best = min(rec["runs"], key=lambda r: r["ms_per_iter"])
    rec["best"] = {k: best[k] for k in ("order", "block", "ms_per_iter")}
    rec["speedup_best_vs_raster128"] = (rec["runs"][0]["ms_per_iter"]
                                        / best["ms_per_iter"])
    print("[reorder_bench] " + json.dumps(rec))
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--nit", type=int, default=30)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.nit, device=a.device, out=a.out)
