"""Host-side stage profile of the port's block-operand build
(``ops/bcsr.py::bcsr_operands_from_state``, its numpy path), each stage
timed on its own, so that work on the build goes to its longest stage.

Port of ``tools/profile_bcsr_build.py``, on the port's own stages: the
state ``LargeEnv(cell, 75e-4, seed=0)`` (cell 183: K=100,467; cell 580:
K=1,009,200), then at ``block`` (default 8x128)

1. ``build_st_csr`` and ``sort_indices`` of S̃;
2. ``_bcsr_arrays_np`` (float32 blocks, with the entry maps);
3. the edge Gram maps (``_gram_maps_np``);
4. the symmetrization weights (``_sym_weights_np``);
5. the association edges' block layout (``_q_layout_np``);
6. the cast of the float32 blocks to bf16 on the host (``_cast_f32``, the
   tool's "bf16 cast (XLA cpu)");
7. the move of the bf16 blocks onto ``device`` (closed by a synchronize;
   skipped on the CPU).

Returns (and writes to ``--out`` only) the stage seconds and the sizes:
maxblk, GiB of the float32 blocks, the Gram maps' shape, the weights'
nnz and the association layout's block count.  The numpy path holds the
float32 blocks on the host (6.2 GB at cell 580 and 8x128; the operand
build itself takes the native packer above 2^20 nonzeros).

    python -m sig_sdp_mmw_torch.experiments.profile_bcsr_build --cell 580
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import time

import numpy as np
import torch

print = functools.partial(print, flush=True)


def main(cell=183, block=(8, 128), device="cuda", out=None):
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments.common import card_info
    from sig_sdp_mmw_torch.ops.bcsr import (_bcsr_arrays_np, _block_pair,
                                            _cast_f32, _gram_maps_np,
                                            _q_layout_np, _sym_weights_np)
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync, resolve_device

    device = resolve_device(device)
    Br, Bc = _block_pair(block)
    stages = {}

    def tick(label, fn):
        t = time.perf_counter()
        res = fn()
        stages[label] = time.perf_counter() - t
        print(f"  {label:<28s} {stages[label]:7.2f}s")
        return res

    S, Q, h = tick("generate", lambda: LargeEnv(
        cell, 75e-4, seed=0).generate_state_csr())
    K = S.shape[0]
    print(f"generate K={K} nnz_S={S.nnz}")
    St = tick("build_st_csr", lambda: build_st_csr(S, Q))
    tick("sort_indices", St.sort_indices)
    lcm = Br * Bc // math.gcd(Br, Bc)
    nr = ((K + lcm - 1) // lcm) * lcm

    s_bcols, s_vals, _, (ebr, eslot, erloc, ecloc) = tick(
        "_bcsr_arrays_np(S~)", lambda: _bcsr_arrays_np(
            St, (Br, Bc), pad_rows_to=nr, dtype=np.float32,
            return_entry_maps=True))
    maxblk = s_bcols.shape[1]
    blocks_gib = s_vals.nbytes / 2**30
    print(f"  maxblk={maxblk} blocks {blocks_gib:.2f} GiB")
    g_src, _ = tick("gram maps", lambda: _gram_maps_np(
        ebr, eslot, erloc, ecloc, maxblk, Br, Bc))
    del ebr, eslot, erloc, ecloc
    w_edge = tick("weights P.multiply(P^T)", lambda: _sym_weights_np(St))
    q_bcols, q_pos, _ = tick("q edge layout",
                             lambda: _q_layout_np(Q, Br, Bc, nr))
    # The blocks that hold an edge: each edge's (block-row, slot).
    maxblkQ = q_bcols.shape[1]
    pos = q_pos.astype(np.int64) // Bc
    q_blocks = np.unique(pos // (maxblkQ * Br) * maxblkQ
                         + pos % maxblkQ).size
    blocks = tick("bf16 cast (host)",
                  lambda: _cast_f32(s_vals, torch.bfloat16, "cpu"))
    if device.type == "cuda":
        def move():
            x = blocks.to(device)
            cuda_sync(x)
            return x
        del s_vals
        tick(f"move to {device.type}", move)
    rec = dict(device=card_info(device), cell=cell, K=K, nnz=int(St.nnz),
               block=[Br, Bc], stages_s=stages, maxblk=int(maxblk),
               blocks_gib=blocks_gib, gram_map_shape=list(g_src.shape),
               weights_nnz=int(w_edge.size), q_blocks=int(q_blocks),
               total_s=sum(stages.values()))
    print("[profile_bcsr_build] " + json.dumps(rec))
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--block", type=int, nargs=2, default=[8, 128])
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, tuple(a.block), device=a.device, out=a.out)
