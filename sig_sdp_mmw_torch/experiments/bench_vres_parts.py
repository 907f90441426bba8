"""What each part of the V-resident kernel's design buys, on the card.

``bsr_spmm_vres`` runs bfloat16 blocks through a TMA ring feeding wgmma on
persistent CTAs, with V held in L2 by evict_last hints
(``ops/kernels/csrc/bsr_spmm_vres.cu``).  This bench times it as shipped and
with one part changed at a time, each a library built with ``-D`` defines
(``load_kernel_library``'s variants):

* ``shipped``: as the wrapper runs it;
* ``one_item_per_cta`` (``VRES_ONE_ITEM_PER_CTA``): no persistence, one CTA
  per block-row, all launched at once;
* ``no_cache_hints`` (``VRES_NO_CACHE_HINTS``): TMA loads without the
  evict_first (blocks) and evict_last (V) hints;
* ``l2_window`` (``VRES_L2_WINDOW``): a persisting access-policy window
  over V for the launch as well, with the set-aside raised for it and put
  back after (the bf16 path's before the TMA design, and the float32
  path's before its TMA body);
* ``ring_2`` (``VRES_STAGES=2``): a ring of 2 stages instead of 3 (N=128)
  or 4 (N=64);
* ``longest_first``: the shipped kernel on the operand with its block-rows
  renumbered most real blocks first (:func:`longest_first`), so the CTAs,
  which take rows in index order, take the longest first: a more even last
  wave, at the price of rows in flight at once reading column-blocks of V
  far apart;
* ``flat``: the flat kernel (``bsr_spmm_flat``, the ring tile) on the same
  product, and ``v_cast``: the wrapper's V rounding to bfloat16 alone (part
  of every call's time);
* ``kernel_device_ms`` (shipped) and ``<variant>_kernel_ms``: the
  profiler's device time of the kernel alone per launch, which the host's
  launch rate does not touch; ``call_device``: every device entry of one
  call (the V cast, the counter's memset and the kernel).

The float32 body (3xTF32 on ``wgmma``, the ``"tma_f32"`` route) is timed
likewise (:func:`f32_parts`), as shipped and built with

* ``consumers_split`` (``VRES_F32_SPLIT_WG_FROM=1000``): the two consumer
  warpgroups split V themselves at every width, between barriers;
* ``split_wg`` (``VRES_F32_SPLIT_WG_FROM=0``): three warps of their own
  split V at every width, and the consumer warpgroups run apart (the
  shipped kernel does so at N=128);
* ``core_matrices`` (``VRES_F32_CORE_MATRICES``): V's halves in the
  no-swizzle core matrices of ``ring_tile_f32`` instead of K-major rows of
  128 bytes with 128-byte swizzle;
* ``no_mma`` (``VRES_F32_NO_MMA``) and ``no_split``
  (``VRES_F32_NO_SPLIT``): without the MMAs, or without V's split stores
  (their results are wrong and not checked): what the rest costs.

Operand: S̃ of the K=100,467 instance (cell 183) as flat block-CSR, G=8 at
D=48 and D=128, and G=32 (every row one step of 32 slots) at D=48; in
float32 blocks, G=8 at D=48, 96 and 128.  Every variant of the kernel that
computes the product sums the same products in the same order, so each is
held bitwise equal to the shipped result; the flat kernel to ``REL_TOL``
of max|out|.  CUDA events, median of 3 rounds; the
shipped kernel is timed first and last.  Needs a CUDA device; writes JSON
only to ``out_path``.

    python -m sig_sdp_mmw_torch.experiments.bench_vres_parts --out parts.json
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from sig_sdp_mmw_torch.experiments.bench_flat_spmm import (bound, check,
                                                           real_slots,
                                                           time_ms)

print = functools.partial(print, flush=True)

VARIANTS = {"one_item_per_cta": ("VRES_ONE_ITEM_PER_CTA",),
            "no_cache_hints": ("VRES_NO_CACHE_HINTS",),
            "l2_window": ("VRES_L2_WINDOW",),
            "ring_2": ("VRES_STAGES=2",)}
# The float32 body's variants; those of F32_EXACT must give the shipped
# bits.
F32_VARIANTS = {"consumers_split": ("VRES_F32_SPLIT_WG_FROM=1000",),
                "split_wg": ("VRES_F32_SPLIT_WG_FROM=0",),
                "core_matrices": ("VRES_F32_CORE_MATRICES",),
                "no_mma": ("VRES_F32_NO_MMA",),
                "no_split": ("VRES_F32_NO_SPLIT",)}
F32_EXACT = ("consumers_split", "split_wg", "core_matrices")


@contextlib.contextmanager
def vres_variant(defines):
    """Route ``bsr_spmm_vres`` to the kernel library built with
    ``defines`` for the duration of the block."""
    from sig_sdp_mmw_torch.ops import kernels

    saved = kernels.bsr_spmm_vres_library
    kernels.bsr_spmm_vres_library = functools.partial(saved, defines)
    try:
        yield
    finally:
        kernels.bsr_spmm_vres_library = saved


def longest_first(mat):
    """(``mat`` with its block-rows renumbered by real-block count, most
    first, ties in index order; the permutation): row i of the result is
    row ``perm[i]`` of ``mat``, its steps and blocks in the same order, so
    its product is ``mat``'s with the output row-blocks permuted."""
    from sig_sdp_mmw_torch.ops.bcsr import flat_bsr

    real = real_slots(mat).reshape(mat.nsteps, mat.G).sum(1)
    counts = torch.zeros(mat.Kbr, dtype=real.dtype, device=real.device)
    counts.index_add_(0, mat.brows.long(), real)
    perm = torch.argsort(-counts, stable=True)
    rp = mat.row_ptr.long()
    lens = (rp[1:] - rp[:-1])[perm]
    first = torch.cumsum(lens, 0) - lens
    steps = (torch.repeat_interleave(rp[:-1][perm], lens)
             + torch.arange(int(lens.sum()), device=lens.device)
             - torch.repeat_interleave(first, lens))
    brows = torch.repeat_interleave(
        torch.arange(mat.Kbr, device=lens.device), lens)
    bcols = mat.bcols.reshape(mat.nsteps, mat.G)[steps].reshape(-1)
    return (flat_bsr(brows.cpu().numpy(), bcols.cpu().numpy(),
                     mat.blocks[steps], mat.nrows), perm)


def device_per_call(fn, iters):
    """Every device entry of one ``fn()`` call, from the profiler over
    ``iters`` calls: each entry's time over its own count of calls (the
    profiler may drop some events of a long trace)."""
    from sig_sdp_mmw_torch.experiments.profile_iteration import profile

    prof = profile(lambda: [fn() for _ in range(iters)])
    return [dict(e, ms=e["ms"] / e["calls"]) for e in prof["top"]]


def kernel_ms(entries):
    """Device time of the V-resident kernel in ``device_per_call``'s
    entries."""
    return sum(e["ms"] for e in entries if "bsr_spmm_vres_tma" in e["name"])


def parts(name, mat, D, iters, gen):
    from sig_sdp_mmw_torch.ops.bcsr import (bsr_spmm_flat, bsr_spmm_vres,
                                            vres_operand)

    V = torch.randn((mat.nrows, D), generator=gen, device="cuda")
    call = lambda: bsr_spmm_vres(mat, V)   # noqa: E731
    want = call()
    rec = {"case": name, "D": D, "G": mat.G, **bound(mat, D)}
    rec["shipped_ms"] = time_ms(call, iters)
    for key, defines in VARIANTS.items():
        with vres_variant(defines):
            if not torch.equal(call(), want):
                raise AssertionError(f"{name} {key}: differs from shipped")
            rec[f"{key}_ms"] = time_ms(call, iters)
            rec[f"{key}_kernel_ms"] = kernel_ms(device_per_call(call, iters))
    sorted_mat, perm = longest_first(mat)
    sorted_call = lambda: bsr_spmm_vres(sorted_mat, V)   # noqa: E731
    got = sorted_call().reshape(mat.Kbr, -1, D)
    if not torch.equal(got, want.reshape(mat.Kbr, -1, D)[perm]):
        raise AssertionError(f"{name} longest_first: differs from shipped")
    rec["longest_first_ms"] = time_ms(sorted_call, iters)
    rec["longest_first_kernel_ms"] = kernel_ms(device_per_call(sorted_call,
                                                               iters))
    check(f"{name} flat", bsr_spmm_flat(mat, V), want)
    rec["flat_ms"] = time_ms(lambda: bsr_spmm_flat(mat, V), iters)
    rec["v_cast_ms"] = time_ms(lambda: vres_operand(V), iters)
    rec["call_device"] = device_per_call(call, iters)
    rec["kernel_device_ms"] = kernel_ms(rec["call_device"])
    rec["shipped_again_ms"] = time_ms(call, iters)
    rec["share"] = rec["bound_ms"] / min(rec["shipped_ms"],
                                         rec["shipped_again_ms"])
    print(json.dumps(rec))
    return rec


def f32_parts(name, mat, D, iters, gen):
    """The float32 body as shipped and as each of ``F32_VARIANTS``
    builds it, with the flat kernel's ``ring_f32`` on the same product."""
    from sig_sdp_mmw_torch.ops.bcsr import bsr_spmm_flat, bsr_spmm_vres

    V = torch.randn((mat.nrows, D), generator=gen, device="cuda")
    call = lambda: bsr_spmm_vres(mat, V)   # noqa: E731
    want = call()
    rec = {"case": name, "D": D, "G": mat.G, **bound(mat, D)}
    rec["shipped_ms"] = time_ms(call, iters)
    for key, defines in F32_VARIANTS.items():
        with vres_variant(defines):
            if key in F32_EXACT and not torch.equal(call(), want):
                raise AssertionError(f"{name} {key}: differs from shipped")
            rec[f"{key}_ms"] = time_ms(call, iters)
    check(f"{name} flat", bsr_spmm_flat(mat, V), want)
    rec["flat_ms"] = time_ms(lambda: bsr_spmm_flat(mat, V), iters)
    rec["shipped_again_ms"] = time_ms(call, iters)
    rec["share"] = rec["bound_ms"] / min(rec["shipped_ms"],
                                         rec["shipped_again_ms"])
    print(json.dumps(rec))
    return rec


def main(iters=20, out_path=None, seed=0,
         cases=((8, 48), (8, 128), (32, 48)),
         f32_cases=((8, 48), (8, 96), (8, 128))):
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.ops import kernels
    from sig_sdp_mmw_torch.ops.bcsr import bsr_flat_from_csr

    if not torch.cuda.is_available():
        raise RuntimeError("bench_vres_parts measures on a CUDA device")
    # Every variant's nvcc at once.
    builds = [(), *VARIANTS.values(), *F32_VARIANTS.values()]
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(kernels.bsr_spmm_vres_library, builds))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"device": torch.cuda.get_device_name(0), "cases": []}
    S, Q, _ = LargeEnv(183, 75e-4, seed=seed).generate_state_csr()
    St = build_st_csr(S, Q)
    flats = {}
    for G, D in cases:
        if G not in flats:
            flats[G] = bsr_flat_from_csr(St, block=128, group=G,
                                         dtype=torch.bfloat16, device="cuda")
        out["cases"].append(parts(f"vres S~ 100k G={G} D={D}", flats[G], D,
                                  iters, gen))
    flats.clear()
    for G, D in f32_cases:
        if G not in flats:
            flats[G] = bsr_flat_from_csr(St, block=128, group=G,
                                         dtype=torch.float32, device="cuda")
        out["cases"].append(f32_parts(f"vres S~ 100k float32 G={G} D={D}",
                                      flats[G], D, iters, gen))
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
