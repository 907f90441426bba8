"""Time the epilogue's block-ELL transpose product on the card:
:func:`sig_sdp_mmw_torch.ops.bcsr.bcsr_spmm_transpose` (each column block
adds its contributions one at a time, in slot order) against one scatter-add
of all of them with ``index_add_`` (the library call for the same sum,
whose atomic adds land in any order, so its bits vary from run to run).

The operands are those the solver's epilogue gives it
(:func:`sig_sdp_mmw_torch.models.mmw_ell.mmw_solve_ell`, ``X_avg_apply``):
the S̃ pattern's block-ELL columns with the averaged blocks in the storage
dtype, and a [Kp, rank_pad + 8] float32 block, for

* ``100k``: cell 183 (K=100,467), 128x128 bf16 blocks, rank_pad 128, one
  chunk (``experiments/e2e_large.py``);
* ``1M``: cell 580 (K=1,009,200), 128x128 bf16 blocks, rank_pad 48, chunks
  of 2,048 block-rows (``experiments/million_link_e2e.py``);
* ``midK``: cell 40 (K=4,800), 32x32 bf16 blocks, rank_pad 128 (the
  binary search's first probe, Z=50), one chunk.

The blocks are S̃'s own (the averaged blocks share its pattern; their
values do not change the work).  Each case checks that the two agree to
1e-5 of max|out| and that two calls of the deterministic sum are bitwise
equal, and times each (CUDA events, median of 3 rounds).  Needs a CUDA
device; prints one JSON line per case and writes them to ``--out``.

    python -m sig_sdp_mmw_torch.experiments.bench_transpose --out t.json
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess

import torch

print = functools.partial(print, flush=True)

REL_TOL = 1e-5

# cell, block, rank_pad, row_chunk
CASES = {"100k": (183, 128, 128, None), "1M": (580, 128, 48, 2048),
         "midK": (40, 32, 128, None)}


def scatter_transpose(mat_bcols, blocks, V, row_chunk=None):
    """``A^T @ V`` by ``index_add_`` of every (row, slot) contribution."""
    from sig_sdp_mmw_torch.ops.bcsr import _row_chunks

    Kbr, maxblk = mat_bcols.shape
    Br, Bc = blocks.shape[1], blocks.shape[-1]
    nrows = Kbr * Br
    D = V.shape[1]
    Vr = V.to(blocks.dtype).to(V.dtype).reshape(Kbr, Br, D)
    seg = torch.zeros((nrows // Bc, Bc, D), dtype=V.dtype, device=V.device)
    for i, j in _row_chunks(Kbr, row_chunk):
        c = torch.einsum("krsc,krd->kscd", blocks[i:j].to(V.dtype), Vr[i:j])
        seg.index_add_(0, mat_bcols[i:j].reshape(-1),
                       c.reshape((j - i) * maxblk, Bc, D))
    return seg.reshape(nrows, D)


def run_case(name: str, iters: int = 5) -> dict:
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments.bench_flat_spmm import time_ms
    from sig_sdp_mmw_torch.ops.bcsr import (bcsr_operands_from_state,
                                            bcsr_spmm_transpose)

    cell, block, rank_pad, row_chunk = CASES[name]
    S, Q, _ = LargeEnv(cell, 75e-4, seed=0).generate_state_csr()
    sb = bcsr_operands_from_state(S, Q, block=block, dtype=torch.bfloat16,
                                  device="cuda").s_blocks
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.randn((sb.nrows, rank_pad + 8), generator=gen, device="cuda")
    new = bcsr_spmm_transpose(sb.bcols, sb.blocks, V, row_chunk=row_chunk)
    again = bcsr_spmm_transpose(sb.bcols, sb.blocks, V, row_chunk=row_chunk)
    old = scatter_transpose(sb.bcols, sb.blocks, V, row_chunk)
    err = float((new - old).abs().max())
    tol = REL_TOL * float(old.abs().max())
    if not err <= tol or not torch.equal(new, again):
        raise AssertionError(f"{name}: |new - index_add_| {err:.3e} "
                             f"(tol {tol:.3e}); repeat bit-equal "
                             f"{torch.equal(new, again)}")
    rec = dict(
        case=name, K=S.shape[0], block=block, Kbr=sb.bcols.shape[0],
        maxblk=sb.bcols.shape[1], D=V.shape[1], row_chunk=row_chunk,
        max_abs_err=err,
        ms=time_ms(lambda: bcsr_spmm_transpose(sb.bcols, sb.blocks, V,
                                               row_chunk=row_chunk), iters),
        index_add_ms=time_ms(lambda: scatter_transpose(sb.bcols, sb.blocks,
                                                       V, row_chunk), iters))
    print(json.dumps(rec))
    return rec


def main(out=None) -> list:
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(gpu)
    recs = [dict(run_case(c), gpu=gpu) for c in CASES]
    if out:
        with open(out, "w") as f:
            json.dump(recs, f, indent=1)
    return recs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    main(ap.parse_args().out)
