"""How much of the short-block bfloat16 tile's time is its loads, on the card.

Every bfloat16 block shape but 128x128 runs through ``short_bf16``
(``ops/kernels/csrc/spmm_tile.cuh``).  This bench times products of the
100k S̃ (cell 183) with the flat and block-ELL libraries as shipped and
built with ``-DSPMM_SHORT_NO_MMA`` (``no_mma``: the tensor-core work left
out, the copies, slot walk and stores kept; its result is wrong and not
checked).  The shipped result is checked against the plain version (to
``REL_TOL`` of max|out|).  CUDA events, median of 3 rounds.  Needs a CUDA
device; writes JSON only to ``out_path``.

    python -m sig_sdp_mmw_torch.experiments.bench_short_parts --out parts.json
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from sig_sdp_mmw_torch.experiments.bench_flat_spmm import (bound, check,
                                                           shape_operand,
                                                           spmm_pair,
                                                           time_ms)

print = functools.partial(print, flush=True)

VARIANTS = {"shipped": (), "no_mma": ("SPMM_SHORT_NO_MMA",)}

CASES = (("flat", (8, 128), 48), ("flat", (8, 128), 128),
         ("ell", (16, 16), 48), ("flat", (32, 32), 48), ("flat", (8, 8), 48))


@contextlib.contextmanager
def built_with(defines):
    """Route the flat and block-ELL wrappers to kernel libraries built with
    ``defines`` for the duration of the block."""
    from sig_sdp_mmw_torch.ops import kernels

    saved = kernels.bcsr_spmm_ell_library, kernels.bsr_spmm_flat_library
    kernels.bcsr_spmm_ell_library = functools.partial(saved[0], defines)
    kernels.bsr_spmm_flat_library = functools.partial(saved[1], defines)
    try:
        yield
    finally:
        kernels.bcsr_spmm_ell_library, kernels.bsr_spmm_flat_library = saved


def main(cases=CASES, iters=20, out_path=None):
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.ops import kernels

    if not torch.cuda.is_available():
        raise RuntimeError("bench_short_parts measures on a CUDA device")
    jobs = [(lib, defines) for defines in VARIANTS.values()
            for lib in (kernels.bsr_spmm_flat_library,
                        kernels.bcsr_spmm_ell_library)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda job: job[0](job[1]), jobs))
    S, Q, _ = LargeEnv(183, 75e-4, seed=0).generate_state_csr()
    St = build_st_csr(S, Q)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "cases": []}
    for kind, block, D in cases:
        mat = shape_operand(kind, St, block)
        fn, plain = spmm_pair(kind)
        V = torch.randn((mat.nrows, D), generator=gen, device="cuda")
        rec = {"case": f"{kind} {block[0]}x{block[1]} D={D}",
               **bound(mat, D), "ms": {}}
        check(rec["case"], fn(mat, V), plain(mat, V))
        for v, defines in VARIANTS.items():
            with built_with(defines):
                rec["ms"][v] = time_ms(lambda: fn(mat, V), iters)
        rec["loads_share"] = rec["ms"]["no_mma"] / rec["ms"]["shipped"]
        print(json.dumps(rec))
        out["cases"].append(rec)
        del mat, V
        torch.cuda.empty_cache()
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(iters=a.iters, out_path=a.out)
