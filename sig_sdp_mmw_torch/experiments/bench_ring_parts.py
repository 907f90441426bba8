"""What each part of the bfloat16 ring tile buys, on the card.

The block-ELL and flat block-CSR kernels run their 128-row bfloat16 blocks
through ``ring_tile_bf16`` (``ops/kernels/csrc/spmm_tile.cuh``).  This bench
times each product as shipped and with one part taken away at a time, on
the main paths' operands:

* ``shipped``: as the wrappers run it;
* ``padding_walked``: the padding slots re-pointed at column-block 1 (their
  blocks stay zero, so the product is unchanged), so the tile streams them
  as it would real blocks;
* ``d_split``: D over several CTAs (``tile_cols`` 64 at D=128, 16 at D=48)
  instead of one CTA covering all of D;
* ``ring_2``: the kernel built with a ring of 2 stages (one slice in flight
  while the tensor cores work) instead of 3 (N > 64) or 4;
* ``v_cast``: the wrapper's V rounding to bfloat16 alone (part of every
  call's time).

Operands: S̃ of the K=100,467 instance (cell 183) as flat block-CSR (G=8) at
D=128 and as block-ELL at D=48, and S̃ of the K=1,009,200 instance (cell
580) as block-ELL at D=48.  Every variant is checked against the shipped
result (to ``REL_TOL`` of max|out|).  CUDA events, median of 3 rounds.
Needs a CUDA device; writes JSON only to ``out_path``.

    python -m sig_sdp_mmw_torch.experiments.bench_ring_parts --out parts.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json

import torch

from sig_sdp_mmw_torch.experiments.bench_flat_spmm import (bound, check,
                                                           real_slots,
                                                           time_ms)

print = functools.partial(print, flush=True)


@contextlib.contextmanager
def ring_stages(n: int):
    """Route the wrappers to kernel libraries built with a ring of ``n``
    stages for the duration of the block."""
    from sig_sdp_mmw_torch.ops import kernels

    saved = kernels.bcsr_spmm_ell_library, kernels.bsr_spmm_flat_library
    defines = (f"SPMM_RING_STAGES={n}",)
    kernels.bcsr_spmm_ell_library = functools.partial(saved[0], defines)
    kernels.bsr_spmm_flat_library = functools.partial(saved[1], defines)
    try:
        yield
    finally:
        kernels.bcsr_spmm_ell_library, kernels.bsr_spmm_flat_library = saved


def padding_walked(mat):
    """``mat`` with every padding slot after a row's first pointed at
    column-block 1: the same product, but no slot left to skip."""
    from sig_sdp_mmw_torch.ops.bcsr import BlockEll

    pad = ~real_slots(mat)
    if isinstance(mat, BlockEll):
        pad[:, 0] = False
        return BlockEll(bcols=torch.where(pad, 1, mat.bcols).int(),
                        blocks=mat.blocks, nrows=mat.nrows)
    pad[mat.row_ptr[:-1].long() * mat.G] = False
    return dataclasses.replace(mat, bcols=torch.where(pad, 1, mat.bcols).int())


def parts(name, mat, D, spmm, split_cols, iters, gen):
    from sig_sdp_mmw_torch.ops.bcsr import ring_operand

    V = torch.randn((mat.nrows, D), generator=gen, device="cuda")
    want = spmm(mat, V)
    walked = padding_walked(mat)
    variants = {
        "shipped": lambda: spmm(mat, V),
        "padding_walked": lambda: spmm(walked, V),
        "d_split": lambda: spmm(mat, V, tile_cols=split_cols),
    }
    rec = {"case": name, "D": D, **bound(mat, D),
           "slots": int(real_slots(mat).numel()),
           "real_slots": int(real_slots(mat).sum())}
    for key, fn in variants.items():
        check(f"{name} {key}", fn(), want)
        rec[f"{key}_ms"] = time_ms(fn, iters)
    with ring_stages(2):
        check(f"{name} ring_2", spmm(mat, V), want)
        rec["ring_2_ms"] = time_ms(lambda: spmm(mat, V), iters)
    rec["shipped_again_ms"] = time_ms(variants["shipped"], iters)
    rec["v_cast_ms"] = time_ms(lambda: ring_operand(V), iters)
    rec["d_split_cols"] = split_cols
    print(json.dumps(rec))
    return rec


def main(iters=20, out_path=None, seed=0):
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.ops.bcsr import (bcsr_from_csr, bcsr_spmm,
                                            bsr_flat_from_csr, bsr_spmm_flat)

    if not torch.cuda.is_available():
        raise RuntimeError("bench_ring_parts measures on a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"device": torch.cuda.get_device_name(0), "cases": []}
    S, Q, _ = LargeEnv(183, 75e-4, seed=seed).generate_state_csr()
    St = build_st_csr(S, Q)
    flat = bsr_flat_from_csr(St, block=128, group=8, dtype=torch.bfloat16,
                             device="cuda")
    out["cases"].append(parts("flat S~ 100k", flat, 128, bsr_spmm_flat, 64,
                              iters, gen))
    del flat
    ell = bcsr_from_csr(St, block=128, dtype=torch.bfloat16, device="cuda")
    out["cases"].append(parts("ell S~ 100k", ell, 48, bcsr_spmm, 16, iters,
                              gen))
    del ell, S, Q, St
    S, Q, _ = LargeEnv(580, 75e-4, seed=seed).generate_state_csr()
    ell = bcsr_from_csr(build_st_csr(S, Q), block=128, dtype=torch.bfloat16,
                        device="cuda")
    del S, Q
    out["cases"].append(parts("ell S~ 1M", ell, 48, bcsr_spmm, 16,
                              max(iters // 4, 1), gen))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.iters, a.out)
