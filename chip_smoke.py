#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Build: compiles the port's three CUDA kernels (sig_sdp_mmw_torch/ops/
   kernels/csrc/{bsr_spmm_flat,bcsr_spmm_ell,bsr_spmm_vres}.cu, for sm_90a)
   and the native host library (csrc/sig_native.cpp) from this checkout,
   all four compilers started together, and prints the card's name and
   power limit.
2. Kernels vs plain, each on the card against its plain PyTorch version on
   the same inputs, to 1e-5 of max|out|, two launches of each case bitwise
   equal, timed with CUDA events, with the case's bound (bytes of the real
   blocks, V and out over 3.35 TB/s, or its operations over the peak rate,
   whichever is larger; bench_flat_spmm.bound) and the share of it reached:
   * flat block-CSR (bsr_spmm_flat) on the K=100,467 S̃ operand of the
     100k path (128x128 blocks, 8 per step): bf16 blocks at D=32, 48, 64
     and 128 (and D=128 split over two 64-column CTAs), float32 blocks at
     D=32 and 128, and S̃ᵀ (bf16, D=128);
   * block-ELL (bcsr_spmm) on the same S̃: bf16 and float32 at D=48 and
     D=128; on the 100k association operator Q (bf16, D=128); and on the
     K=1,009,200 S̃ and Q of the million-link path (bf16, D=48) against the
     plain version at row_chunk=2048;
   * V-resident flat (bsr_spmm_vres) on the same S̃: bf16 at G=8 (D=48
     and 128) and G=32 (D=48, every row padded to 32 slots), float32 at
     G=8 (D=32, 48, 64 and 128, its tma_f32 body), then through
     the SpMM bench entry point (sig_sdp_mmw_torch/experiments/
     bench_flat_spmm.py) at G=8 and G=32, which also runs the ELL and flat
     kernels on that operand;
   * block shapes without a 128x128 fast path (the short-block
     tensor-core tile, bf16 or float32), at D=48 on the same S̃: flat at
     8x128 and 32x32 (bf16 and float32), 16x128 and 8x8 (bf16); block-ELL
     at 8x128, 32x32 and 8x8 (bf16 and float32), 16x128 and 16x16 (bf16);
     V-resident at 8x128 (bf16); the K=1,009,200 S̃ as flat 8x128 bf16
     blocks, G=8, D=16
     (126,160 block-rows) and as block-ELL 64x64 bf16 blocks at D=48 (the
     million-link study's operand, phase 11); the mid-K path's own operands (phase 6's cell
     40 from bcsr_operands_from_state, 32x32 bf16 blocks): S̃ through the
     flat kernel and through the block-ELL kernel at D=128 (the solver's
     D_pad) and D=8 (the gap log's D=1 padded), and Q through the
     block-ELL kernel at D=128; each counted as a generic launch, with
     the V bytes the tile gathers per real block
     (bench_flat_spmm.v_gather_bytes); and the block-height comparison:
     the 100k S̃ as flat 8x128 bf16 against the 128x128 ring tile at D=48
     and D=128 (measured only; every main path keeps 128x128);
   * every float32 case also checks that its launch was counted on its
     route (ring_f32 for 128x128 on the flat and block-ELL kernels,
     tma_f32 on the V-resident kernel, short_f32 for every other shape)
     and prints the route, its bound
     (float32 operations at the faster of the CUDA cores' float32 rate and
     three TF32 products on the tensor cores) and share, the plain
     version's and the library call's times (the comparison is printed,
     not asserted);
   * the yardstick PyTorch call (bench_flat_spmm.library_spmm: a BSR tensor
     of the real blocks @ V, or, where PyTorch refuses non-square blocks, a
     CSR tensor of their entries @ V; in the block dtype where PyTorch runs
     it, else float32), with the device kernels the profiler saw it run,
     for the main-path products, the float32 cases, the V-resident cases
     and the other block shapes.  The port never calls it.
3. The 100k path: the block-sparse pipeline of
   sig_sdp_mmw_torch/experiments/e2e_large.py on cell 183 (K=100,467; bf16
   blocks, stored transpose, flat_group=8, nit=150, eta=0.05, 10 rounding
   attempts), rounding on the device as the JAX tool does (Kp > 16,384: the
   wavefront at every probe): rem 0, independent verification, Z_fin within
   1 of E2E_LARGE.json's 16, every operand on the card, S̃/S̃ᵀ through the
   flat kernel and Q and the epilogue through the block-ELL kernel; the
   rounding seconds per probe and wavefront rounds per attempt, the native
   scan timed once on the last probe's factor after the pipeline returns
   (so the search's seconds are the device route's alone), and the
   heuristic rows MAX_GAIN_ELL and MAX_RAND_ELL at Z_fin (rem 0 must
   verify).  Then one solve (nit=150) at the search's first probe Z in
   each block dtype, the float32 one in the layout e2e_large(bf16=False)
   builds (128x128 float32 blocks, stored transpose, flat_group=8: the
   ring_f32 route): ms per iteration and ub of each, ub finite.  The bf16
   solve then runs twice more with the same draws, each factor rounded on
   the device (rounding_ell) with the same draws: the first repeat must
   give the factor, ub_final and z_vec bit for bit; the second runs under
   torch.use_deterministic_algorithms(True, warn_only=True), prints the ops
   that warn and whether its bits match, and the mode is off after it.
   Then a short solve with the gap log
   (MMWEll(nit=5, log_gap=True) at Z=16 on that instance's flat operands):
   its gap Lanczos sends D=1 through the flat kernel, and every gap entry
   must be finite.
4. The million-link path: sig_sdp_mmw_torch/experiments/million_link_e2e.py
   at its defaults (cell 580, K=1,009,200: 128x128 bf16 blocks with stored
   transpose, gram_mode="edge", row_chunk=2048, D_pad=48, lanczos_m=8,
   segments of 5, probes at nit=120 with one subspace iteration, 3
   rounding attempts, window 8), without BLER, and with the convergence
   run at Z_fin cut from nit=625 to 150 (eta=0.04): K, rem 0,
   verification, Z_fin within 1 of the JAX record's 20
   (MILLION_LINK_E2E.json), cuda placement, and at least probes x
   nit_probe x 3 x lanczos_m block-ELL launches.
5. The dense journal-scale path (sig_sdp_mmw_torch/models/mmw.py, plain
   torch products, TF32 off), on the K=300 reference geometry
   (tests/fixtures/env_mid.npz: cell 10, rho 0.0075, seed 3, pad_to=320):
   (a) bench.py's solve, mmw_solve at Z=12, nit=150, eta=0.05, D_pad =
   rank_pad = 32, one warm-up and 5 timed calls (median it/s and ms per
   iteration), every tensor on cuda and ub_final finite; (b) the drive
   recipe, BinarySearchRelaxation with MMW(nit=100, eta=0.05, seed=0):
   rem 0, verified, Z_fin within 1 of the JAX package's (DENSE_Z_REF),
   BLER mean and share above 1e-5, all users in one slot at BLER >= 0.99,
   solve and rounding seconds per probe; (c) the entry point
   experiments/sim_mmw_time.py at cells 10 and 15 (K=675), every CSV
   written with finite times (the search at cell 15 with MMW(nit=150,
   eta=0.04), rem 0 and verified, runs in phase 7's sim_all_bler); (d)
   the SpMM kernels launched 0 times.
6. Mid-K (LargeEnv cell 40, Kp <= 16,384, so the device rounding takes the
   batched route) on 32x32 bf16 blocks, so S̃/S̃ᵀ go through the flat
   kernel's short-block tile and Q through the block-ELL kernel's:
   e2e_large with search="binary" and search="speculative" (wave 4): rem 0,
   verified, Z within 1 of each other, generic launches on both kernels,
   none of the V-resident kernel, every operand on the card.
7. The journal comparison slice (sig_sdp_mmw_torch/models/{admm,lrp,
   baselines,heuristics}.py, plain torch: cuSOLVER eigh, GEMMs,
   elementwise passes): (a) experiments/sim_all_bler.py at cell 15 (K=675,
   the journal's largest cell), seed 0: the MMW search, then Rand, LRP,
   MAX_GAIN and MAX_ASSO at its Z_fin, each rounded and put through BLER:
   MMW rem 0 and verified, every method's rem, seconds and BLER share above
   1e-5 printed, every CSV row K+1 finite values; (b) experiments/
   sim_mmw_oracle_z.py at cell 10 (K=300, oracle_nit=500), seed 0: its
   seconds, Z and each method's rem; (c) the oracle on the K=300 reference
   geometry of phase 5: BinarySearchRelaxation + ADMMSDPSolver(nit=500),
   rem 0, verified, Z within 1 of the JAX package's (ORACLE_Z_REF); (d) at
   K=675 and (a)'s Z: one ADMMSDPSolver(nit=100) probe, Spectral,
   MAX_RAND, MAX_GAIN and MAX_ASSO timed; an ADMM solve and a MAX_GAIN call
   profiled (launches per iteration and per user step, busy share); the
   eigh time per call (CUDA events) at K=300 and K=675, each at its path's
   Z, and its share of an ADMM iteration; (e) no SpMM kernel launched.
8. The sharded path (sig_sdp_mmw_torch/parallel/{mesh,distributed}.py,
   the graph axis of models/mmw_ell.py and models/mmw.py): the flat (#1)
   and block-ELL (#3) kernels on row shards (shard_rows, rank 0 and 1 of 2)
   of the K=30,000 operands of (b), against their plain versions (and the
   library call on rank 0's shard; the float32 shards on ring_f32); (a)
   sig_sdp_mmw_torch.entry.dryrun_multichip(4): 4 ranks on cuda:0 over
   gloo, mesh batch 2 x graph 2, the batched dense solve with rounding (rem
   0, verified, every instance) and the graph-sharded (8, 8)-block probe
   (rem 0), every rank's outputs the same bits, every operand on cuda,
   kernel #3 launched on every rank (counts printed per rank); (b)
   experiments/sharded_large.py at its defaults (cell 100, K=30,000, nit
   30) over 2 ranks on cuda:0 (gloo), once with the tool's float32
   block-ELL operands and once with bf16 flat operands (flat_group=8):
   equal to the one-process solve (|dub|, max|dX_half| < 1e-3, the
   factor's columns signed alike), rem 0,
   verified, ranks bit-equal, MB per rank and balance, kernel #3 (and #1
   for bf16) launched on every rank; (c) the same solves in an NCCL world
   of one rank (graph 1), bit-for-bit equal to the one-process solve (the
   mesh makes no collective at graph 1), and one all-gather of a CUDA
   tensor through NCCL in a world of one, checked against its input; (d)
   a device trace of (b)'s bf16 solve: the device time of the kernels and
   of the copies (gloo moves the gathered rows through the host), the
   host time in the all-gathers and MB gathered per iteration.
9. The last modules ported (sig_sdp_mmw_torch/ops/bcsr.py's block pair
   and block Grams, experiments/plot_results.py and
   experiments/oracle_z_report.py): (a) bcsr_pair_from_state on phase 6's
   instance (LargeEnv cell 40, K=4,800, its CSR state made anew) at
   128x128 and 32x32 blocks, float32 and bf16: S̃·V and S̃ᵀ·V (D=48)
   through kernel #3, each held to its plain version (1e-5 of max|out|)
   and to the ELL product of core.ell on the same state (rtol 1e-4, atol
   1e-5; the ELL values and V rounded to the block dtype, as the kernel
   reads them), each launch counted on the route spmm_route names (ring,
   ring_f32, short_bf16, short_f32), kernel #3 launched more than 0 times
   (its count is block_pair_launches in the kernels line); (b)
   bcsr_block_gram and bcsr_block_gram_accum (in place) on the 32x32
   pattern of (a)'s S̃ with float32 X (D=48) on the card, against a
   float64 einsum on the CPU to 1e-5 of the largest entry; (c)
   plot_results on phase 7's sim_all_bler and sim_mmw_oracle_z
   directories and the matrix-sparsity figure at cell 5, every expected
   file non-empty (where matplotlib is not installed, as on the card's
   host, no figure can be drawn: the metric files the figures read must
   parse instead, every row finite); (d) oracle_z_report on phase 7's one-seed oracle run:
   one seed, its oracle Z the one phase 7 printed.
10. The 100k quality studies (experiments/conv_probe.py, bler_tail_fix.py,
   bler_tail_sweep.py) at a short depth: (a) conv_probe at K=100,467 (its
   state made anew), one segment of 125 iterations on 128x128 bf16 blocks
   with the flat twins, its ub within 0.03 of CONV_PROBE_100K.json's
   0.2477 there; (b) bler_tail_fix's case without a margin and (c)
   bler_tail_sweep at ratio 0.1, both at cell 24 (K=1,728), each with rem
   0 and verified; every study's products on the routes its blocks name
   (ring for bf16, ring_f32 for the sweep's float32 blocks), kernels #1
   and #3 launched more than 0 times each (their counts are
   studies_launches in the kernels line); (d) the oracle study
   (sim_mmw_oracle_z --geometry) on the JAX package's users of seeds 0
   and 1 (tests/fixtures/oracle_z_cell10_geometry.npz), one process a
   seed beside (a)-(c): the oracle feasible and its Z within 1 of the JAX
   package's on the CPU (ORACLE_GEOMETRY_Z).
11. The six tools studies (experiments/plateau_study.py,
   million_link.py, million_z19_probe.py, reorder_bench.py, perf_sweep.py,
   profile_bcsr_build.py) at a short depth: (a) plateau_study's row at
   cell 24 (K=1,728) with one segment of 125 iterations: Z_fin within 1
   of PLATEAU_VS_K.json's 14, ub finite, kernels #1 and #3 launched on
   ring only; (b) million_link at cell 60 (K=10,800), 64x64 bf16 blocks,
   nit 6 in segments of 3, with the device rounding: kernel #3 launched
   on short_bf16 only (#1 not at all), rem 0 exactly when the checker
   passes, the measured peaks of device memory after the build and after
   the solve above 0 and below the card's total; (c) the z19 probe's body
   at cell 60, Z = lb + 4, nit 9: rem 0 exactly when the checker passes,
   #3 on ring only; (d) reorder_bench's raster 128x128 and Hilbert 8x128
   runs at cell 60, nit 5: the same K and nnz, #1 and #3 on ring and on
   short_bf16 respectively; (e) perf_sweep at m=32 and 8 on the tool's
   users (tests/fixtures/perf_sweep_cell10_seed7_geometry.npz), nit 150:
   both ub finite, no kernel launched; (f) profile_bcsr_build at cell 60,
   every stage timed.  The kernels' launches in this phase are
   tools_launches in the kernels line.
Each phase prints its seconds ("[time] phase N").

Every kernel counts its launches; each path's counts are set to 0 just
before it runs and read just after (the V-resident kernel's path is the
SpMM bench; it must launch 0 times on the 100k and million-link paths,
and no kernel may launch on the dense path, as in the JAX package).
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.  The line before the last is the
kernels' JSON record (each kernel with its phase-6 generic launches, the
generic block shapes checked in phase 2, the routes it took in phase 2 and
its float32 cases, and its phase-8 launches per rank), the last ``{"ok":
true, "device": {...}}``.
"""

import contextlib
import gc
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

CELL, RHO, SEED, NIT, ETA, NATTEMPT, GROUP = 183, 75e-4, 0, 150, 0.05, 10, 8
MILLION_CELL, MILLION_ROW_CHUNK = 580, 2048
MILLION_Z_REF = 20   # MILLION_LINK_E2E.json (19 at a larger probe budget)
# The convergence run at Z_fin, cut from the entry point's 625 iterations
# to keep the script's time for phases 3 and 6 (the search, rem, the
# checker and the launch counts do not depend on it).
MILLION_NIT_CONV = 150
# The JAX package's Z_fin on the K=300 reference geometry (tests/fixtures/
# env_mid.npz: cell 10, rho 0.0075, seed 3, pad_to=320) with
# BinarySearchRelaxation + MMW(nit=100, eta=0.05, seed=0), on the CPU, in
# float32 with and without x64 (probes 33, 20, 13, 10, 12, 11);
# tests/test_torch_dense_slice.py recomputes it.
DENSE_Z_REF = 11
# The JAX package's Z_fin on that state with BinarySearchRelaxation +
# ADMMSDPSolver(nit=500), on the CPU, in float32 (probes 33, 20, 13, 10, 8,
# 9, 10; remainders 0, 0, 0, 0, 10, 1, 0; verified).  With x64 enabled the
# probe at 9 ends at remainder 0 and the search at 9.
ORACLE_Z_REF = 10
ORACLE_NIT = 500
# Phase 10 (d): the JAX package's oracle Z on its own users of seeds 0 and 1
# (tests/fixtures/oracle_z_cell10_geometry.npz, made by tests/
# torch_jax_geometry.py), from its study sim_mmw_oracle_z --platform cpu
# (float32, oracle nit 500) on the CPU.
GEOMETRY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "oracle_z_cell10_geometry.npz")
ORACLE_GEOMETRY_Z = [13, 11]
# Phase 10: the tools' small cell (K=1,728) for bler_tail_fix and
# bler_tail_sweep, and CONV_PROBE_100K.json's bf16 ub after the first
# segment of 125 iterations.
STUDY_CELL = 24
CONV_UB125_REF = 0.2477
# Phase 11: PLATEAU_VS_K.json's Z_fin at cell 24, the tools' mid cell
# (K=10,800) for the million-link, z19 and reorder drives, and the
# perf_sweep users (tests/fixtures/, written by tests/torch_jax_geometry.py).
PLATEAU_CELL, PLATEAU_Z_REF = 24, 14
TOOLS_CELL = 60
PERF_SWEEP_GEOMETRY = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
    "perf_sweep_cell10_seed7_geometry.npz")
JOURNAL_CELL, JOURNAL_K = 15, 675     # the journal's largest cell
DENSE_NIT = 150
E2E_Z_REF = 16        # E2E_LARGE.json (the JAX tool on cell 183)
# The JAX tool's heuristic rows at that Z (E2E_LARGE.json).
E2E_HEUR_REF = {"mgain": "rem 0, verified", "mrand": "rem 19, not verified"}
MIDK_CELL, MIDK_BLOCK = 40, 32
# Phase 8: tools/sharded_large.py's default cell (K=30,000) and the D of
# its solve there (Z = lb + 4 = 18 slots, D_pad 48).
SHARD_CELL, SHARD_D = 100, 48
GENERIC_D = 48
REPLACES = {"bsr_spmm_flat": "sig_sdp_mmw_tpu/ops/bcsr.py:334",
            "bcsr_spmm_ell": "sig_sdp_mmw_tpu/ops/bcsr.py:183",
            "bsr_spmm_vres": "sig_sdp_mmw_tpu/ops/bcsr.py:397"}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def reset_launches(tb) -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for fn in (tb.bsr_spmm_flat, tb.bcsr_spmm, tb.bsr_spmm_vres):
        fn.launches = fn.generic_launches = 0
        fn.route_launches = {}


def compare(name, mat, V, kernel, plain, iters=20, library=False):
    """Kernel vs plain on the same inputs: two kernel launches bitwise
    equal, max |diff| within REL_TOL of max|plain| (bench_flat_spmm.check
    raises otherwise), both timed, the bound of ``mat @ V`` and, with
    ``library``, the yardstick PyTorch call's time."""
    import torch

    from sig_sdp_mmw_torch.experiments.bench_flat_spmm import (bound, check,
                                                               library_spmm,
                                                               time_ms)

    out = kernel()
    if not torch.equal(out, kernel()):
        raise AssertionError(f"{name}: two launches differ")
    res = check(name, out, plain())
    del out
    ms, plain_ms = time_ms(kernel, iters), time_ms(plain, iters)
    rec = dict(max_abs_err=res["max_abs_err"], ms=ms, plain_ms=plain_ms,
               **bound(mat, V.shape[1]))
    log(f"[2 kernel] {name}: max_abs_err={res['max_abs_err']:.3e} "
        f"(tol {res['tol']:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms; needs {rec['bytes_needed'] / 1e9:.4f} GB, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), share "
        f"{rec['bound_ms'] / ms:.3f}")
    if library:
        rec.update(library_spmm(mat, V, iters))
        log(f"[2 library] {name}: {rec['library_call']} {rec['library_ms']} "
            f"ms in {rec['library_dtype']}, kernels {rec['library_kernels']}, "
            f"refused {rec['library_refused']}")
    return rec


def check_route(tb, name, fn, kind, mat, V) -> str:
    """One launch of ``fn`` on ``mat @ V``, counted once and on the route
    its float32 blocks must take (ring_f32 at 128x128 on the flat and
    block-ELL kernels, tma_f32 on the V-resident one, short_f32 at every
    other shape; a generic launch exactly when the route is one of
    GENERIC_ROUTES).  Returns the route."""
    Br, Bc = (mat.Brow, mat.B) if kind == "ell" else (mat.Br, mat.Bc)
    want = ("short_f32" if (Br, Bc) != (128, 128) else
            "tma_f32" if kind == "vres" else "ring_f32")
    route = tb.spmm_route(kind, Br, Bc, mat.blocks.dtype)
    n0, g0 = fn.launches, fn.generic_launches
    fn(mat, V)
    if (route != want or fn.launches != n0 + 1
            or fn.generic_launches != g0 + (route in tb.GENERIC_ROUTES)):
        raise AssertionError(f"{name}: route {route} (want {want}), "
                             f"launches +{fn.launches - n0}, generic "
                             f"+{fn.generic_launches - g0}")
    return route


def f32_record(name, route, rec) -> dict:
    """A float32 case's line: route, times, bound and share, printed with
    the kernel's ratio to the library call (not asserted)."""
    lib = rec.get("library_ms")
    out = dict(case=name, route=route, ms=rec["ms"], plain_ms=rec["plain_ms"],
               library_ms=lib, library_call=rec.get("library_call"),
               bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
               share=rec["bound_ms"] / rec["ms"],
               max_abs_err=rec["max_abs_err"])
    log(f"[f32] {name}: route {route}, kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, library {lib} ms"
        + (f" (kernel / library {rec['ms'] / lib:.3f})" if lib else "")
        + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), share "
        f"{out['share']:.3f}")
    return out


def f32_solve_check(tb, Z, nit=NIT) -> dict:
    """Phase 3's instance solved once at Z in each block dtype, 128x128
    blocks with stored transpose and flat_group=8 as e2e_large builds them
    (bf16=False: float32 blocks, the ring_f32 route of both kernels), with
    the same draws: ms per iteration and ub_final of each; both finite, the
    float32 solve's products all on the flat and block-ELL kernels.

    Repeatability: the bf16 solve runs twice more with the same draws, and
    each of its three factors is rounded on the device (rounding_ell, the
    wavefront route) with the same draws.  The first repeat must give the
    first run's factor, ub_final and z_vec bit for bit.  The second runs
    with torch.use_deterministic_algorithms(True, warn_only=True), which
    swaps some ops for other implementations: it prints the ops that warn
    and whether its bits match (not asserted), and the mode is off again
    after it."""
    import warnings

    import numpy as np
    import torch

    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.models.mmw_ell import MMWEll

    t0 = time.time()
    env = LargeEnv(CELL, RHO, seed=SEED)
    S, Q, h = env.generate_state_csr()
    ell = env.generate_ell(device="cuda")
    rec = {"Z": int(Z), "nit": nit}

    def solve(dt, rounding=False):
        alg = MMWEll(nit=nit, eta=ETA, use_bcsr=True, seed=SEED,
                     nattempt=NATTEMPT)
        alg.prepare(ell, S, Q, h_max=h, block=128, dtype=dt,
                    store_transpose=True, flat_group=GROUP)
        reset_launches(tb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        alg.run_with_state(0, Z, ell)
        torch.cuda.synchronize()
        s = time.perf_counter() - t1
        out = alg.last_output
        r = dict(ms_per_iteration=s / nit * 1e3, ub=float(out.ub_final),
                 flat=tb.bsr_spmm_flat.launches, ell=tb.bcsr_spmm.launches,
                 generic=tb.bsr_spmm_flat.generic_launches
                 + tb.bcsr_spmm.generic_launches)
        bits = None
        if rounding:
            z_vec, _, rem = alg.rounding(Z, out.X_half, ell)
            r.update(rem=int(rem), route=alg.rounding_info[-1]["route"])
            bits = (out.X_half.clone(), out.ub_final.clone(),
                    np.asarray(z_vec).copy())
        del alg
        gc.collect()
        torch.cuda.empty_cache()
        return r, bits

    def same(a, b):
        return {"factor": bool(torch.equal(a[0], b[0])),
                "ub_final": bool(torch.equal(a[1], b[1])),
                "z_vec": bool(np.array_equal(a[2], b[2]))}

    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        rec[name], bits = solve(dt, rounding=dt == torch.bfloat16)
        log(f"[3 f32] {name} blocks, Z={Z}, nit={nit}: "
            f"{rec[name]['ms_per_iteration']:.3f} ms per iteration, ub "
            f"{rec[name]['ub']!r}; launches flat {rec[name]['flat']}, "
            f"block-ELL {rec[name]['ell']}")
        if dt == torch.bfloat16:
            first = bits
    f32 = rec["float32"]
    log(f"[3 f32] ub float32 - bfloat16 "
        f"{f32['ub'] - rec['bfloat16']['ub']:.3e}; ms per iteration "
        f"float32 / bfloat16 "
        f"{f32['ms_per_iteration'] / rec['bfloat16']['ms_per_iteration']:.3f}"
        f" [{time.time() - t0:.1f}s]")

    # ---- the bf16 solve and its device rounding, repeated ----------------
    again, bits = solve(torch.bfloat16, rounding=True)
    rec["repeat"] = dict(again, equal=same(first, bits))
    log(f"[3 repeat] bf16 solve + {again['route']} rounding at Z={Z}, same "
        f"draws: bitwise equal to the first run "
        f"{json.dumps(rec['repeat']['equal'])}; ub {again['ub']!r} rem "
        f"{again['rem']} (first: ub {rec['bfloat16']['ub']!r} rem "
        f"{rec['bfloat16']['rem']})")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            det, bits = solve(torch.bfloat16, rounding=True)
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0][:160] for w in caught
                  if "determinis" in str(w.message)})
    rec["deterministic_mode"] = dict(det, equal=same(first, bits),
                                     warned=ops)
    log(f"[3 repeat] with use_deterministic_algorithms(warn_only): bitwise "
        f"equal to the first run {json.dumps(same(first, bits))}; ub "
        f"{det['ub']!r} rem {det['rem']}; {len(ops)} ops warned:")
    for op in ops:
        log(f"[3 repeat]   {op}")
    del first, bits
    if not all(math.isfinite(rec[k]["ub"]) for k in ("bfloat16", "float32")):
        raise AssertionError(f"f32 solve check: ub not finite: {rec}")
    if (tb.spmm_route("flat", 128, 128, torch.float32) != "ring_f32"
            or f32["flat"] < nit or f32["ell"] < nit or f32["generic"]):
        raise AssertionError(f"the float32 solve did not run its products "
                             f"on ring_f32: {f32}")
    if not all(rec["repeat"]["equal"].values()):
        raise AssertionError(f"the bf16 solve and its rounding did not "
                             f"repeat bit for bit: {rec['repeat']['equal']}")
    return rec


def gap_check(tb, Z=16, nit=5) -> None:
    """A short MMW solve with the gap log on the 100k flat operands: the gap
    Lanczos applies S̃ and S̃ᵀ to a [Kp, 1] vector through the flat kernel.
    Every (UB, LB) entry must be finite, and the gap log must add at least
    two flat-kernel launches per iteration over the same solve without it
    (the gap Lanczos sends only D=1)."""
    import torch

    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.models.mmw_ell import MMWEll

    t0 = time.time()
    env = LargeEnv(CELL, RHO, seed=SEED)
    S, Q, h = env.generate_state_csr()
    ell = env.generate_ell(device="cuda")
    alg = MMWEll(nit=nit, eta=ETA, use_bcsr=True, log_gap=True, seed=SEED)
    alg.prepare(ell, S, Q, h_max=h, block=128, dtype=torch.bfloat16,
                store_transpose=True, flat_group=GROUP)
    n0 = tb.bsr_spmm_flat.launches
    alg.run_with_state(0, Z, ell)
    gap = alg.last_output.gap_log.cpu()
    n_gap = tb.bsr_spmm_flat.launches - n0
    alg.log_gap = False
    n0 = tb.bsr_spmm_flat.launches
    alg.run_with_state(0, Z, ell)
    n_d1 = n_gap - (tb.bsr_spmm_flat.launches - n0)
    log(f"[3 gap] Z={Z} nit={nit}: (UB, LB) per iteration "
        f"{[[round(float(x), 4) for x in r] for r in gap]}; flat launches "
        f"{n_gap}, {n_d1} of them the gap log's (D=1) "
        f"[{time.time() - t0:.1f}s]")
    if gap.shape != (nit, 2) or not bool(torch.isfinite(gap).all()):
        raise AssertionError(f"gap log {list(gap.shape)} is not {nit} finite "
                             "(UB, LB) pairs")
    if n_d1 < 2 * nit:
        raise AssertionError(f"the gap log added {n_d1} flat-kernel launches "
                             f"in {nit} iterations (want >= {2 * nit})")


def dense_phase(tb, out_dir: str) -> dict:
    """Phase 5, the dense journal-scale path on the card: (a) the bench's
    solve on the K=300 reference geometry, (b) the drive recipe's search,
    verification and BLER on that state, (c) sim_mmw_time at cells 10 and
    15, (d) no SpMM kernel launched."""
    import numpy as np
    import torch

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.experiments.sim_mmw_time import \
        main as mmw_time_main
    from sig_sdp_mmw_torch.models import (MMW, BinarySearchRelaxation,
                                          verify_assignment)
    from sig_sdp_mmw_torch.models.mmw import mmw_solve
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    here = os.path.dirname(os.path.abspath(__file__))
    fix = np.load(os.path.join(here, "tests", "fixtures", "env_mid.npz"))
    reset_launches(tb)
    t_phase = time.time()
    rec = {}

    # (a) bench.py's K=300 solve: Z=12, nit=150, eta=0.05, D_pad 32.
    env = WirelessEnv(cell_size=10, sta_density_per_1m2=RHO, seed=3,
                      pad_to=320, device="cuda", sta_locs=fix["sta_locs"])
    st = env.generate_S_Q_hmax()
    if (st.K, st.Kp) != (300, 320) or st.tensor_devices() != {"cuda"}:
        raise AssertionError(f"dense state K={st.K} Kp={st.Kp} on "
                             f"{st.tensor_devices()}")

    def solve(i):
        return mmw_solve(st, 12.0, nit=DENSE_NIT, eta=ETA, D_pad=32,
                         rank_pad=32, draws=TorchDraws(0, "cuda", stream=i))

    t0 = time.perf_counter()
    out = solve(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for i in range(1, 6):
        t0 = time.perf_counter()
        out = solve(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    rec.update(it_per_s=DENSE_NIT / med, ms_per_it=med / DENSE_NIT * 1e3,
               solve_s=times, first_solve_s=first_s,
               ub_final=float(out.ub_final))
    log(f"[5 dense] K=300 solve (Z=12, nit={DENSE_NIT}, eta={ETA}, D_pad "
        f"32): {rec['it_per_s']:.2f} it/s, {rec['ms_per_it']:.4f} ms per "
        f"iteration (median of 5; solves {[round(t, 4) for t in times]} s, "
        f"first {first_s:.3f} s); ub_final {rec['ub_final']:.4f}")
    if out.tensor_devices() != {"cuda"} or not np.isfinite(rec["ub_final"]):
        raise AssertionError(f"dense solve output on {out.tensor_devices()}, "
                             f"ub_final {rec['ub_final']}")

    # (b) the drive recipe on the same state.
    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = MMW(nit=100, eta=ETA, seed=0)
    t0 = time.time()
    z, Z, rem = bs.run(st)
    search_s = time.time() - t0
    ok, n_i, n_a = verify_assignment(st, z)
    probes = bs.LOGGED_NP_DATA["bs_search_per_it"]
    bler = env.evaluate_bler(z, Z)
    one_slot = float(env.evaluate_bler(np.zeros(st.K, int), 1).mean())
    rec.update(Z_fin=int(Z), remainder=int(rem), search_s=search_s,
               probe_Z=probes[:, 5].astype(int).tolist(),
               solve_s_per_probe=(probes[:, 8] / 1e6).tolist(),
               rounding_s_per_probe=(probes[:, 9] / 1e6).tolist(),
               bler_mean=float(bler.mean()),
               bler_frac_above_1e5=float((bler > 1e-5).mean()),
               one_slot_bler=one_slot)
    log(f"[5 dense] recipe: bounds {bs.set_bounds(st)} probes "
        f"{rec['probe_Z']} Z_fin={Z} (JAX: {DENSE_Z_REF}) rem={rem} "
        f"verified={ok} ({n_i}/{n_a}); search {search_s:.3f} s")
    log(f"[5 dense] solve_s per probe "
        f"{[round(x, 4) for x in rec['solve_s_per_probe']]}, rounding_s per "
        f"probe {[round(x, 4) for x in rec['rounding_s_per_probe']]}")
    log(f"[5 dense] BLER mean {rec['bler_mean']:.4e}, frac>1e-5 "
        f"{rec['bler_frac_above_1e5']:.4f}; all in one slot {one_slot:.4f}")
    if rem != 0 or not ok:
        raise AssertionError("dense K=300 assignment is not feasible")
    if abs(Z - DENSE_Z_REF) > 1:
        raise AssertionError(f"dense Z_fin {Z} is not within 1 of "
                             f"{DENSE_Z_REF}")
    if one_slot < 0.99:
        raise AssertionError(f"all-in-one-slot BLER {one_slot} < 0.99")

    # (c) the entry point.
    t0 = time.time()
    path = mmw_time_main(["--cells", "10", "15", "--repeat", "1", "--out",
                          out_dir])
    tag = str(int(RHO * 10000))
    for cell in (10, 15):
        for kind, width in (("time", 6), ("fused", 1)):
            name = f"mmw150-{kind}-{cell}-{tag}"
            with open(os.path.join(path, name)) as f:
                row = np.array(f.read().strip().split(",")[2:], float)
            if row.size != width or not np.all(np.isfinite(row)):
                raise AssertionError(f"{name}: {row}")
            rec[name] = row.tolist()
            log(f"[5 dense] {name}: {[round(float(x), 1) for x in row]} us")
    log(f"[5 dense] sim_mmw_time cells 10, 15: {time.time() - t0:.1f} s")

    # (d) the dense path reaches no SpMM kernel.
    n = (tb.bsr_spmm_flat.launches, tb.bcsr_spmm.launches,
         tb.bsr_spmm_vres.launches)
    log(f"[5 dense] launches: flat {n[0]}, block-ELL {n[1]}, V-resident "
        f"{n[2]} [{time.time() - t_phase:.1f}s]")
    if any(n):
        raise AssertionError(f"the dense path launched SpMM kernels {n}")
    return rec


def run_entry_point(main, argv, prefix: str):
    """``main(argv)`` with its standard output captured and then echoed:
    (output directory, its one ``prefix`` JSON record, seconds)."""
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            path = main(argv)
    finally:
        sys.stdout.write(buf.getvalue())
    secs = time.time() - t0
    recs = [json.loads(line[len(prefix):])
            for line in buf.getvalue().splitlines() if line.startswith(prefix)]
    if len(recs) != 1:
        raise AssertionError(f"{prefix!r}: {len(recs)} records")
    return path, recs[0], secs


def metric_row(path: str, name: str, width: int):
    """The one CSV row of metric ``name``: ``width`` finite values."""
    import numpy as np

    with open(os.path.join(path, name)) as f:
        rows = f.read().strip().splitlines()
    row = np.array(rows[0].split(",")[2:], float) if len(rows) == 1 else None
    if row is None or row.size != width or not np.all(np.isfinite(row)):
        raise AssertionError(f"{name}: {rows}")
    return row


def eigh_ms(st, Z: int, iters: int = 20) -> float:
    """ms per ``torch.linalg.eigh`` call (CUDA events, after a warm-up) on
    the symmetrized consensus point of a 20-iteration ADMM solve of ``st``
    at ``Z``: the matrix the oracle decomposes every iteration (cuSOLVER's
    time depends on its spectrum, so on Z)."""
    import torch

    from sig_sdp_mmw_torch.models.admm import admm_sdp_solve

    _, X = admm_sdp_solve(st, float(Z), nit=20, rank_pad=16)
    X = 0.5 * (X + X.T)
    torch.linalg.eigh(X)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        torch.linalg.eigh(X)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def journal_phase(tb, out_dir: str) -> dict:
    """Phase 7, the journal comparison slice on the card: (a) sim_all_bler
    at cell 15, (b) sim_mmw_oracle_z at cell 10, (c) the oracle's search on
    the K=300 reference geometry held to ORACLE_Z_REF, (d) the per-method
    times, the eigh time and the launches at K=675, (e) no SpMM kernel."""
    import numpy as np
    import torch

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.experiments import sim_all_bler, sim_mmw_oracle_z
    from sig_sdp_mmw_torch.experiments.profile_iteration import profile
    from sig_sdp_mmw_torch.models import (MAX_ASSO, MAX_GAIN, MAX_RAND,
                                          ADMMSDPSolver,
                                          BinarySearchRelaxation,
                                          SpectralSDPSolver,
                                          verify_assignment)

    reset_launches(tb)
    tag = str(int(RHO * 10000))
    rec = {}

    # (a) sim_all_bler at the journal's largest cell.
    path, r, secs = run_entry_point(
        sim_all_bler.main, ["--cells", str(JOURNAL_CELL), "--repeat", "1",
                            "--out", os.path.join(out_dir, "bler")],
        "[sim_all_bler] ")
    K, Z = r["K"], r["Z"]
    for name, m in r["methods"].items():
        metric_row(path, f"{name}-{JOURNAL_CELL}-{tag}", K + 1)
        log(f"[7 journal] sim_all_bler cell {JOURNAL_CELL} K={K} Z={Z} "
            f"{name}: rem {m['rem']}, verified {m['verified']}, "
            f"{m['s']:.3f} s, BLER frac>1e-5 "
            f"{m['bler_frac_above_1e-5']:.4f}")
    rec["sim_all_bler"] = dict(r, seconds=secs)
    log(f"[7 journal] sim_all_bler: {secs:.1f} s")
    mmw = r["methods"]["mmw"]
    if K != JOURNAL_K or mmw["rem"] != 0 or not mmw["verified"]:
        raise AssertionError(f"sim_all_bler cell {JOURNAL_CELL}: K={K}, "
                             f"MMW {mmw}")

    # (b) the matched-Z oracle validation at cell 10.
    path, o, secs = run_entry_point(
        sim_mmw_oracle_z.main, ["--cells", "10", "--repeat", "1",
                                "--oracle_nit", str(ORACLE_NIT), "--out",
                                os.path.join(out_dir, "oracle_z")],
        "[sim_mmw_oracle_z] ")
    for name in ("scs", "mmw150", "rand"):
        metric_row(path, f"{name}-10-{tag}", o["K"] + 2)
    rec["sim_mmw_oracle_z"] = dict(o, seconds=secs)
    log(f"[7 journal] sim_mmw_oracle_z cell 10 K={o['K']}: oracle Z "
        f"{o['Z']} (probes {o['probe_Z']}), rem {o['rem']}, seconds "
        f"{ {k: round(v, 3) for k, v in o['s'].items()} }; {secs:.1f} s")
    if o["rem"]["scs"] != 0:
        raise AssertionError(f"oracle search ended at rem {o['rem']['scs']}")

    # (c) the oracle on the K=300 reference geometry, held to the JAX Z.
    here = os.path.dirname(os.path.abspath(__file__))
    fix = np.load(os.path.join(here, "tests", "fixtures", "env_mid.npz"))
    env = WirelessEnv(cell_size=10, sta_density_per_1m2=RHO, seed=3,
                      pad_to=320, device="cuda", sta_locs=fix["sta_locs"])
    st = env.generate_S_Q_hmax()
    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = ADMMSDPSolver(nit=ORACLE_NIT)
    t0 = time.time()
    z, Zo, rem = bs.run(st)
    secs = time.time() - t0
    ok = verify_assignment(st, z)[0]
    probes = bs.LOGGED_NP_DATA["bs_search_per_it"]
    rec["oracle"] = dict(Z_fin=int(Zo), remainder=int(rem), verified=ok,
                         search_s=secs,
                         probe_Z=probes[:, 5].astype(int).tolist(),
                         probe_rem=probes[:, 7].astype(int).tolist(),
                         solve_s=(probes[:, 8] / 1e6).tolist(),
                         rounding_s=(probes[:, 9] / 1e6).tolist())
    log(f"[7 journal] oracle on the K=300 geometry: probes "
        f"{rec['oracle']['probe_Z']} rems {rec['oracle']['probe_rem']} "
        f"Z_fin={Zo} (JAX: {ORACLE_Z_REF}) rem={rem} verified={ok}; "
        f"search {secs:.2f} s, solve_s per probe "
        f"{[round(x, 3) for x in rec['oracle']['solve_s']]}")
    if rem != 0 or not ok or abs(Zo - ORACLE_Z_REF) > 1:
        raise AssertionError(f"oracle: Z_fin {Zo} rem {rem} verified {ok} "
                             f"(JAX {ORACLE_Z_REF})")

    # (d) at K=675: per-method time, launches, eigh.
    t_d = time.time()
    st15 = WirelessEnv(cell_size=JOURNAL_CELL, sta_density_per_1m2=RHO,
                       seed=0, device="cuda").generate_S_Q_hmax()
    st10 = WirelessEnv(cell_size=10, sta_density_per_1m2=RHO, seed=0,
                       device="cuda").generate_S_Q_hmax()
    admm_nit = 100

    solve_s = {}

    def admm_probe():
        alg = ADMMSDPSolver(nit=admm_nit)
        _, gX = alg.run_with_state(0, Z, st15)
        solve_s["admm100"] = alg.LOGGED_NP_DATA["admm_solve"][-1, 5] / 1e6
        return alg.rounding(Z, gX, st15)

    def admm_solve():
        return ADMMSDPSolver(nit=admm_nit).run_with_state(0, Z, st15)

    def spectral():
        alg = SpectralSDPSolver()
        _, gX = alg.run_with_state(0, Z, st15)
        return alg.rounding(Z, gX, st15)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    methods = {
        "admm100": admm_probe,
        "spectral": spectral,
        "mrand": lambda: MAX_RAND.run(Z, st15),
        "mgain": lambda: MAX_GAIN.run(Z, st15),
        "masso": lambda: MAX_ASSO.run(Z, st15)}
    per = {}
    for name, fn in methods.items():
        (zv, Zm, rm), s = timed(fn)
        per[name] = dict(Z=int(Zm), rem=int(rm), seconds=s,
                         solve_s=solve_s.get(name),
                         verified=verify_assignment(st15, zv)[0])
        log(f"[7 journal] K={st15.K} Z={Z} {name}: Z {Zm} rem {rm} "
            f"verified {per[name]['verified']}, {s:.3f} s")
    # Launches: an ADMM solve per iteration, a slot-major heuristic per
    # user step (K of them; MAX_ASSO and MAX_RAND run the same scan).
    prof = {"admm100": profile(admm_solve, top=4),
            "mgain": profile(methods["mgain"], top=4)}
    it_ms = per["admm100"]["solve_s"] / admm_nit * 1e3
    e_ms = {"K300": eigh_ms(st10, o["Z"]), "K675": eigh_ms(st15, Z)}
    rec.update(per_method=per, profiles=prof, eigh_ms=e_ms,
               Kp={"K300": st10.Kp, "K675": st15.Kp}, admm_ms_per_it=it_ms,
               admm_launches_per_it=prof["admm100"]["device_calls"] / admm_nit,
               user_steps=st15.K,
               launches_per_user_step=prof["mgain"]["device_calls"] / st15.K)
    log(f"[7 journal] eigh per call: K={st10.K} (Kp {st10.Kp}, Z {o['Z']}) "
        f"{e_ms['K300']:.3f} ms, K={st15.K} (Kp {st15.Kp}, Z {Z}) "
        f"{e_ms['K675']:.3f} ms; ADMM at K={st15.K}: {it_ms:.3f} ms per "
        f"iteration (solve {per['admm100']['solve_s']:.3f} s / {admm_nit}), "
        f"eigh {e_ms['K675'] / it_ms:.3f} of it; profiled solve: "
        f"{rec['admm_launches_per_it']:.1f} launches and "
        f"{prof['admm100']['device_ms'] / admm_nit:.3f} ms of device time "
        f"per iteration, busy {prof['admm100']['busy_share']:.3f}")
    log(f"[7 journal] MAX_GAIN: {st15.K} user steps, "
        f"{rec['launches_per_user_step']:.1f} launches per step, busy "
        f"{prof['mgain']['busy_share']:.3f} [{time.time() - t_d:.1f}s]")

    # (e) the slice reaches no SpMM kernel.
    n = (tb.bsr_spmm_flat.launches, tb.bcsr_spmm.launches,
         tb.bsr_spmm_vres.launches)
    log(f"[7 journal] launches: flat {n[0]}, block-ELL {n[1]}, V-resident "
        f"{n[2]}")
    if any(n):
        raise AssertionError(f"the journal slice launched SpMM kernels {n}")
    return rec


@contextlib.contextmanager
def remembering_last_rounding(last: dict):
    """While the block, ``MMWEll.rounding`` keeps a reference to its last
    call's solver, Z, factor and remainder in ``last``: no copy, no sync
    and no extra work, so the search's seconds stay the route's own."""
    from sig_sdp_mmw_torch.models.mmw_ell import MMWEll

    device_rounding = MMWEll.rounding

    def rounding(self, Z, gX, ell, nattempt=None):
        out = device_rounding(self, Z, gX, ell, nattempt)
        last.update(alg=self, Z=int(Z), gX=gX, rem=int(out[2]),
                    nattempt=nattempt or self.nattempt)
        return out

    MMWEll.rounding = rounding
    try:
        yield last
    finally:
        MMWEll.rounding = device_rounding


def native_rounding_on_last_factor(last: dict, device_s: float) -> dict:
    """The native C++ scan (rounding_native_csr, the 1M path's route),
    timed once on the factor of the search's last probe beside the device
    route's seconds on that probe."""
    import torch

    from sig_sdp_mmw_torch.models.rounding_ell import rounding_native_csr
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    alg, gX = last["alg"], last["gX"]
    _, S, Q, h, StT = alg._host
    torch.cuda.synchronize()
    t0 = time.time()
    _, _, rem = rounding_native_csr(last["Z"], gX, S, Q, h,
                                    TorchDraws(alg.seed, gX.device),
                                    nattempt=last["nattempt"], StT_csr=StT)
    native_s = time.time() - t0
    out = {"Z": last["Z"], "device_s": device_s, "device_rem": last["rem"],
           "native_s": native_s, "native_rem": int(rem)}
    last.clear()
    return out


def midk_phase(tb, e2e_main) -> dict:
    """Phase 6, the mid-K instance (LargeEnv cell 40, Kp <= 16,384) on 32x32
    bf16 blocks (stored transpose, flat_group=8): S̃/S̃ᵀ through the flat
    kernel's short-block tile, Q and the epilogue through the block-ELL
    kernel's.  (a) the binary search, each probe rounded on the batched
    route; (b) the speculative search (wave 4).  Both rem 0 and verified,
    their Z within 1 of each other, every operand on the card, generic
    launches on both kernels, none of the V-resident kernel."""
    kw = dict(cell=MIDK_CELL, rho=RHO, seed=SEED, nit=NIT, eta=ETA,
              nattempt=NATTEMPT, block=MIDK_BLOCK, bf16=True,
              flat_group=GROUP, device="cuda", rounding="device")
    out = {"flat_generic_launches": 0, "ell_generic_launches": 0}
    for search in ("binary", "speculative"):
        reset_launches(tb)
        t0 = time.time()
        rec = e2e_main(search=search, wave=4, **kw)
        n = {"flat": (tb.bsr_spmm_flat.launches,
                      tb.bsr_spmm_flat.generic_launches),
             "ell": (tb.bcsr_spmm.launches, tb.bcsr_spmm.generic_launches),
             "vres": (tb.bsr_spmm_vres.launches,
                      tb.bsr_spmm_vres.generic_launches)}
        r = {k: rec[k] for k in ("K", "lb", "ub", "Z_fin", "remainder",
                                 "verified_feasible", "n_probes", "probe_Z",
                                 "operand_devices", "search_mode")}
        r.update(seconds=time.time() - t0, search_s=rec["phases_s"]["search"],
                 launches=n)
        if search == "binary":
            r.update(solve_s=[x / 1e6 for x in rec["solve_us_per_probe"]],
                     rounding_s=[x / 1e6 for x in rec["rounding_us_per_probe"]],
                     routes=sorted({i["route"] for i in rec["rounding_info"]}))
        else:
            r.update(n_waves=rec["n_waves"], waves=rec["wave_rows"])
        log(f"[6 midk] cell {MIDK_CELL} {json.dumps(r)}")
        out[search] = r
        out["flat_generic_launches"] += n["flat"][1]
        out["ell_generic_launches"] += n["ell"][1]
        if rec["remainder"] != 0 or not rec["verified_feasible"]:
            raise AssertionError(f"mid-K {search}: not feasible")
        if rec["operand_devices"] != ["cuda"]:
            raise AssertionError(f"mid-K {search}: operands on "
                                 f"{rec['operand_devices']}")
        if n["flat"][1] == 0 or n["ell"][1] == 0 or n["vres"][0]:
            raise AssertionError(f"mid-K {search}: launches {n}")
        if search == "binary" and r["routes"] != ["batch"]:
            raise AssertionError(f"mid-K rounding routes {r['routes']}")
    if abs(out["binary"]["Z_fin"] - out["speculative"]["Z_fin"]) > 1:
        raise AssertionError("mid-K: speculative and binary Z differ by more "
                             "than 1")
    return out


def nccl_gather_rank() -> dict:
    """A rank of phase 8 (c)'s direct collective: ``all_gather_into_tensor``
    of a CUDA tensor over the world; whether it holds every rank's part."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x + r)
    want = torch.cat([x + k for k in range(n)])
    return dict(backend=dist.get_backend(), world=n,
                ok=bool(torch.equal(out, want)))


def sharded_phase(tb, tmp: str) -> dict:
    """Phase 8, the sharded path: the kernels on row shards against their
    plain versions, then (a) the 4-rank dryrun, (b) sharded_large over 2
    ranks in both layouts, (c) the NCCL world of one, (d) the trace of
    (b)'s bf16 solve.  Returns each kernel's launches per rank by run
    ("launches") and the float32 shard cases ("f32")."""
    import numpy as np
    import torch

    from sig_sdp_mmw_torch.entry import dryrun_multichip
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments import sharded_large
    from sig_sdp_mmw_torch.parallel.distributed import launch

    t0 = time.time()
    S, Q, _ = LargeEnv(SHARD_CELL, RHO, seed=SEED).generate_state_csr()
    nr = -(-S.shape[0] // 256) * 256
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32 = []
    for layout, key in (("bf16_flat", "s_flat"), ("f32_ell", "s_blocks")):
        full = sharded_large.layout_operands(S, Q, 128, nr, layout)
        for g in range(2):
            mat = getattr(tb.shard_rows(full, g, 2), key).to("cuda")
            V = torch.randn((mat.ncols, SHARD_D), generator=gen,
                            device="cuda")
            fn, plain = ((tb.bsr_spmm_flat, tb.bsr_spmm_flat_reference)
                         if key == "s_flat" else
                         (tb.bcsr_spmm, tb.bcsr_spmm_reference))
            name = f"shard {g}/2 {layout} S~ D={SHARD_D}"
            log(f"[8 kernel] {name}: rows {mat.nrows} of {mat.ncols}")
            rec = compare(name, mat, V, lambda: fn(mat, V),
                          lambda: plain(mat, V), library=g == 0)
            if layout == "f32_ell":
                f32.append(f32_record(name, check_route(
                    tb, name, fn, "ell", mat, V), rec))
            del mat, V
        del full
    torch.cuda.empty_cache()
    log(f"[8 kernel] row shards [{time.time() - t0:.1f}s]")

    # (a) the dryrun: 4 ranks sharing the card over gloo.
    t0 = time.time()
    dry = dryrun_multichip(4, device="cuda")
    per_rank = dry["launches_per_rank"]
    log(f"[8 dryrun] mesh {dry['mesh']} backend {dry['backend']} rems "
        f"{dry['rems']} verified {dry['verified']} sparse ub "
        f"{dry['sparse_ub']:.4f} rem {dry['sparse_rem']}; launches per rank "
        f"{json.dumps(per_rank)}; operands {dry['operand_devices']} "
        f"[{time.time() - t0:.1f}s]")
    if dry["mesh"] != {"batch": 2, "graph": 2} or dry["backend"] != "gloo":
        raise AssertionError(f"dryrun mesh {dry['mesh']} over "
                             f"{dry['backend']}")
    if dry["operand_devices"] != ["cuda"]:
        raise AssertionError(f"dryrun operands on {dry['operand_devices']}")
    if not all(r["bcsr_spmm"] > 0 for r in per_rank):
        raise AssertionError("kernel #3 did not launch on every rank")
    launches = {"dryrun": per_rank}

    # (b) the tool's configuration over 2 ranks on the card, (d) its trace.
    t0 = time.time()
    layouts = ("f32_ell", "bf16_flat")
    rec = sharded_large.main(graph=2, layouts=layouts, device="cuda",
                             backend="gloo",
                             trace_dir=os.path.join(tmp, "trace"))
    log(f"[8 sharded] K={rec['K']} nnz(S)={rec['nnz_S']} Z={rec['Z']} "
        f"D_pad={rec['D_pad']} rows {rec['rows_padded']} phases_s "
        f"{json.dumps(rec['phases_s'])} [{time.time() - t0:.1f}s]")
    for layout in layouts:
        r = rec[layout]
        log(f"[8 sharded] {layout}: " + json.dumps(
            {k: r[k] for k in ("ub_sharded", "ub_single", "max_abs_dX_half",
                               "max_abs_dX_half_sign_aligned",
                               "max_abs_dGram", "equal", "ranks_bit_equal",
                               "rounding_rem",
                               "verified", "bytes_per_rank_mb", "balance",
                               "rows_per_rank", "solve_sharded_s",
                               "solve_single_s", "collective_mb_per_solve",
                               "collective_mb_per_iteration",
                               "gathers_per_solve", "launches_per_rank",
                               "operand_devices")}))
        launches[layout] = r["launches_per_rank"]
        want = ("bsr_spmm_flat", "bcsr_spmm") if layout == "bf16_flat" \
            else ("bcsr_spmm",)
        if not (r["equal"] and r["rounding_rem"] == 0 and r["verified"]["ok"]
                and r["ranks_bit_equal"]):
            raise AssertionError(f"sharded {layout}: not equal, feasible "
                                 "and the same on every rank")
        if r["operand_devices"] != ["cuda"]:
            raise AssertionError(f"sharded {layout}: operands on "
                                 f"{r['operand_devices']}")
        if not all(n[k] > 0 for n in r["launches_per_rank"] for k in want):
            raise AssertionError(f"sharded {layout}: {want} not launched on "
                                 "every rank")
    tr = rec["bf16_flat"]["trace"]
    log(f"[8 trace] bf16_flat rank 0: kernels {tr['kernels_ms']:.3f} ms "
        f"(SpMM {tr['spmm_kernels_ms']:.3f}), copies {tr['copies_ms']:.3f} "
        f"ms, copies' share of device time {tr['copy_share_of_device']}; "
        f"all-gathers {tr['gather_host_ms']:.1f} ms on the host, "
        f"{tr['gather_share_of_wall']:.3f} of the solve's wall time; "
        f"{rec['bf16_flat']['collective_mb_per_iteration']:.3f} MB gathered "
        "per iteration")

    # (c) NCCL, a world of one rank: the one-process solve, bit for bit.
    t0 = time.time()
    one = sharded_large.main(graph=1, layouts=layouts, device="cuda",
                             backend="nccl")
    for layout in layouts:
        r = one[layout]
        log(f"[8 nccl] {layout}: graph 1 bit-equal to one process "
            f"{r['bit_equal_single']} (ub {r['ub_sharded']!r} vs "
            f"{r['ub_single']!r}), rem {r['rounding_rem']}")
        if not r["bit_equal_single"]:
            raise AssertionError(f"nccl world of one, {layout}: not "
                                 "bit-equal to the one-process solve")
    # At graph 1 the mesh returns before any collective: gather directly.
    g = launch("chip_smoke:nccl_gather_rank", 1, backend="nccl",
               device="cuda")[0]
    log(f"[8 nccl] all_gather_into_tensor of a CUDA tensor, world "
        f"{g['world']} over {g['backend']}: equal {g['ok']}")
    if not (g["ok"] and g["backend"] == "nccl"):
        raise AssertionError(f"nccl all-gather: {g}")
    log(f"[8 nccl] [{time.time() - t0:.1f}s]")
    return {"launches": launches, "f32": f32}


def block_pair_phase(tb, journal_dir: str, oracle_Z: int) -> dict:
    """Phase 9, the last modules ported: (a) bcsr_pair_from_state on the
    mid-K instance at 128x128 and 32x32 blocks in float32 and bf16, S̃·V
    and S̃ᵀ·V (D=48) through kernel #3 against its plain version and the
    ELL product, on the route spmm_route names; (b) the block Grams against
    a float64 CPU einsum; (c) plot_results on phase 7's output; (d)
    oracle_z_report on phase 7's one-seed oracle run."""
    import numpy as np
    import torch

    from sig_sdp_mmw_torch.core.ell import ell_from_scipy
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments import oracle_z_report, plot_results
    from sig_sdp_mmw_torch.experiments.bench_flat_spmm import REL_TOL, check
    from sig_sdp_mmw_torch.ops.ell import ell_spmm

    out = {}
    # (a) the pair of the mid-K instance through kernel #3.
    S, Q, h = LargeEnv(MIDK_CELL, RHO, seed=SEED).generate_state_csr()
    K = S.shape[0]
    ell = ell_from_scipy(S, Q, h, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    launches, routes = 0, {}
    for block in (128, MIDK_BLOCK):
        for dt in (torch.float32, torch.bfloat16):
            s_b, st_b = tb.bcsr_pair_from_state(S, Q, block=block, dtype=dt,
                                                device="cuda")
            route = tb.spmm_route("ell", block, block, dt)
            want = ("ring" if dt == torch.bfloat16 else "ring_f32") \
                if block == 128 else \
                ("short_bf16" if dt == torch.bfloat16 else "short_f32")
            if route != want:
                raise AssertionError(f"pair {block} {dt}: route {route}, "
                                     f"want {want}")
            V = torch.randn((s_b.nrows, SHARD_D), generator=gen,
                            device="cuda")
            # The ELL operands in the block dtype, as the kernel reads them.
            Vr = V.to(dt).float()
            for name, mat, cols, vals in (
                    ("S~", s_b, ell.s_cols, ell.s_vals),
                    ("S~T", st_b, ell.st_cols, ell.st_vals)):
                case = f"pair {name} {block}x{block} {dt} D={SHARD_D}"
                n0, g0 = tb.bcsr_spmm.launches, tb.bcsr_spmm.generic_launches
                got = tb.bcsr_spmm(mat, V)
                if (tb.bcsr_spmm.launches != n0 + 1
                        or tb.bcsr_spmm.generic_launches
                        != g0 + (route in tb.GENERIC_ROUTES)):
                    raise AssertionError(f"{case}: not counted on {route}")
                res = check(case, got, tb.bcsr_spmm_reference(mat, V))
                want_ell = ell_spmm(cols.long(), vals.to(dt).float(),
                                    Vr[:ell.Kp])[:K]
                err = float((got[:K] - want_ell).abs().max())
                torch.testing.assert_close(got[:K], want_ell, rtol=1e-4,
                                           atol=1e-5)
                routes[case] = dict(route=route,
                                    max_abs_err=res["max_abs_err"],
                                    tol=res["tol"], ell_max_abs_err=err)
                log(f"[9 pair] {case}: route {route}, max_abs_err "
                    f"{res['max_abs_err']:.3e} (tol {res['tol']:.3e}), "
                    f"vs ELL {err:.3e}")
            launches = tb.bcsr_spmm.launches
            del s_b, st_b, V, Vr
    if launches == 0:
        raise AssertionError("the block pair launched kernel #3 no time")
    out["pair"] = dict(K=K, launches=launches, cases=routes)

    # (b) the block Grams at 32x32 blocks against float64 on the CPU.
    s_b, _ = tb.bcsr_pair_from_state(S, Q, block=MIDK_BLOCK, device="cuda")
    bcols = s_b.bcols.long()
    Xb = torch.randn((s_b.Kb, MIDK_BLOCK, SHARD_D), generator=gen,
                     device="cuda")
    acc0 = torch.randn((s_b.Kb, bcols.shape[1], MIDK_BLOCK, MIDK_BLOCK),
                       generator=gen, device="cuda")
    X64, c64 = Xb.double().cpu(), bcols.cpu()
    G64 = torch.einsum("kid,ksjd->ksij", X64, X64[c64])
    acc = acc0.clone()
    got = {"block_gram": tb.bcsr_block_gram(bcols, Xb),
           "block_gram_accum": tb.bcsr_block_gram_accum(bcols, Xb, acc,
                                                        0.37)}
    if got["block_gram_accum"] is not acc:
        raise AssertionError("bcsr_block_gram_accum did not update in place")
    for name, ref in (("block_gram", G64),
                      ("block_gram_accum", acc0.double().cpu() + 0.37 * G64)):
        err = float((got[name].double().cpu() - ref).abs().max())
        tol = REL_TOL * float(ref.abs().max())
        log(f"[9 gram] {name} {tuple(ref.shape)}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e}) against float64")
        if not err <= tol:
            raise AssertionError(f"{name}: {err:.3e} > {tol:.3e}")
        out[name] = dict(shape=list(ref.shape), max_abs_err=err, tol=tol)
    del s_b, Xb, acc0, acc, got

    # (c) the figures of phase 7's output, and the spy plot at cell 5.
    # Without matplotlib (the card's host has none) no figure can be
    # drawn: the metric files the figures read must then parse, every row
    # finite.
    fig_dir = os.path.join(journal_dir, "figures")
    subs = {"bler": 5, "oracle_z": 3}    # metric files phase 7 wrote
    if importlib.util.find_spec("matplotlib") is None:
        rows = {}
        for sub, n in subs.items():
            data = plot_results._read_metric_files(
                os.path.join(journal_dir, sub))
            rows[sub] = {k: len(v) for k, v in data.items()}
            if len(data) != n or not all(
                    v and all(np.all(np.isfinite(r)) for r in v)
                    for v in data.values()):
                raise AssertionError(f"plot_results' inputs in {sub}: "
                                     f"{rows[sub]}")
        log(f"[9 plot] matplotlib is not installed here: no figure drawn; "
            f"metric files read, rows {json.dumps(rows)}")
        out["figures"] = {"drawn": False, "metric_rows": rows}
    else:
        expected = []
        for sub in subs:
            d = os.path.join(fig_dir, sub)
            plot_results.main([os.path.join(journal_dir, sub), "--out", d])
            expected += [os.path.join(d, f) for f in ("bler_avg_max.pdf",
                                                      "bler_cdf.pdf")]
        plot_results.plot_matrix_sparsity(fig_dir, cells=(5,))
        expected.append(os.path.join(fig_dir, "matrix_sparsity.pdf"))
        sizes = {os.path.relpath(f, fig_dir): (os.path.getsize(f)
                                               if os.path.exists(f) else 0)
                 for f in expected}
        log(f"[9 plot] {json.dumps(sizes)}")
        if not all(sizes.values()):
            raise AssertionError(f"plot_results: missing or empty {sizes}")
        out["figures"] = {"drawn": True, "sizes": sizes}
    os.makedirs(fig_dir, exist_ok=True)

    # (d) the oracle report of phase 7's one seed.
    rep = oracle_z_report.main([os.path.join(journal_dir, "oracle_z"),
                                "--cell", "10", "--out",
                                os.path.join(fig_dir, "ORACLE_Z.md")])
    log(f"[9 report] oracle Z {rep['Z']} (phase 7: {oracle_Z}), MMW "
        f"feasible {rep['mmw_feasible']}, rand feasible "
        f"{rep['rand_feasible']}")
    if rep["n"] != 1 or rep["Z"] != [oracle_Z]:
        raise AssertionError(f"oracle_z_report: {rep['Z']} against "
                             f"phase 7's {oracle_Z}")
    out["report"] = {k: rep[k] for k in ("n", "Z", "oracle_feasible",
                                         "mmw_feasible", "rand_feasible")}
    if not np.isfinite(rep["mmw_bler_mean"]):
        raise AssertionError("oracle_z_report: BLER not finite")
    return out


def studies_phase(tb, tmp: str) -> dict:
    """Phase 10: the three 100k quality studies at a short depth,
    each with its kernel launches by route, and the oracle study on two
    seeds of the JAX package's users (module docstring, phase 10)."""
    rec = {}
    # (d) starts first: one process a seed, on the card beside (a)-(c)
    # (the oracle waits on the host for every eigh; the studies keep the
    # card busy).
    t_oracle = time.time()
    oracle = [subprocess.Popen(
        [sys.executable, "-m", "sig_sdp_mmw_torch.experiments."
         "sim_mmw_oracle_z", "--cells", "10",
         "--geometry", GEOMETRY, "--seeds", str(seed),
         "--out", os.path.join(tmp, f"oracle_geometry_{seed}")],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for seed in range(len(ORACLE_GEOMETRY_Z))]
    try:
        rec.update(studies_short_runs(tb))
        outs = [p.communicate(timeout=600)[0] for p in oracle]
    finally:
        for p in oracle:
            if p.poll() is None:
                p.kill()
                p.wait()
    prefix = "[sim_mmw_oracle_z] "
    seeds = []
    for p, out in zip(oracle, outs):
        sys.stdout.write(out)
        if p.returncode:
            raise AssertionError(f"the oracle study exited {p.returncode}")
        seeds += [json.loads(line[len(prefix):]) for line in out.splitlines()
                  if line.startswith(prefix)]
    rec["oracle_geometry"] = dict(
        Z=[r["Z"] for r in seeds], jax_cpu_Z=ORACLE_GEOMETRY_Z,
        rem={r["seed"]: r["rem"] for r in seeds},
        seconds=time.time() - t_oracle)
    log(f"[10 oracle] geometry seeds 0-{len(ORACLE_GEOMETRY_Z) - 1}: "
        f"{json.dumps(rec['oracle_geometry'])}")
    if (len(seeds) != len(ORACLE_GEOMETRY_Z)
            or any(r["rem"]["scs"] for r in seeds)
            or any(abs(r["Z"] - z) > 1
                   for r, z in zip(seeds, ORACLE_GEOMETRY_Z))):
        raise AssertionError(f"oracle on the JAX users: Z "
                             f"{rec['oracle_geometry']['Z']} not within 1 "
                             f"of the JAX package's {ORACLE_GEOMETRY_Z}")
    return rec


def studies_short_runs(tb) -> dict:
    """Phase 10 (a)-(c): the three studies' entry points, each held to its
    routes."""
    import torch

    from sig_sdp_mmw_torch.experiments import (bler_tail_fix,
                                               bler_tail_sweep, conv_probe)

    rec = {}

    def launched(launches, kernel, route, name):
        n = launches.get(kernel, {}).get(route, 0)
        if n <= 0 or set(launches.get(kernel, {})) != {route}:
            raise AssertionError(f"{name}: {kernel} launches {launches}, "
                                 f"want some on {route!r} only")
        return n

    # (a) conv_probe at 100k, one segment of 125 iterations on bf16 blocks.
    t0 = time.time()
    cp = conv_probe.main(cell=CELL, nit=625, seg=125, dtypes=("bf16",),
                         device="cuda", segments=1)
    lc = cp["launches"]["bf16"]
    (it, ub), = cp["runs"]["bf16"]
    rec["conv_probe"] = dict(K=cp["K"], Z=cp["Z"], it=it, ub=ub,
                             launches=lc, seconds=time.time() - t0)
    log(f"[10 conv_probe] K={cp['K']} Z={cp['Z']} ub at {it} {ub!r} (JAX "
        f"record {CONV_UB125_REF}); launches {json.dumps(lc)} "
        f"[{rec['conv_probe']['seconds']:.1f}s]")
    if not math.isfinite(ub) or abs(ub - CONV_UB125_REF) > 0.03:
        raise AssertionError(f"conv_probe: ub {ub} at {it} is not within "
                             f"0.03 of {CONV_UB125_REF}")
    for kernel in ("bsr_spmm_flat", "bcsr_spmm"):
        if launched(lc, kernel, "ring", "conv_probe") < it:
            raise AssertionError(f"conv_probe: fewer {kernel} launches "
                                 f"than iterations: {lc}")
    gc.collect()
    torch.cuda.empty_cache()

    # (b) bler_tail_fix at a small cell, the case without a margin.
    t0 = time.time()
    tf = bler_tail_fix.run_case(STUDY_CELL, None, device="cuda")
    rec["bler_tail_fix"] = dict(
        {k: tf.get(k) for k in ("K", "lb", "Z_fin", "verified",
                                "frac_above_1e5", "launches")},
        probes=[(p["Z"], p["rem"]) for p in tf["probes"]],
        seconds=time.time() - t0)
    log(f"[10 bler_tail_fix] {json.dumps(rec['bler_tail_fix'])}")
    if tf["Z_fin"] is None or not tf["verified"]["ok"]:
        raise AssertionError(f"bler_tail_fix: no verified Z: {tf}")
    for kernel in ("bsr_spmm_flat", "bcsr_spmm"):
        launched(tf["launches"], kernel, "ring", "bler_tail_fix")

    # (c) bler_tail_sweep at that cell, one ratio.
    t0 = time.time()
    sw = bler_tail_sweep.run_one(0.1, STUDY_CELL, RHO, SEED, 150, ETA,
                                 NATTEMPT, 128, device="cuda")
    rec["bler_tail_sweep"] = dict(
        {k: sw[k] for k in ("K", "nnz_S", "Z", "rem", "verified",
                            "frac_above_1e-5", "probe_Z", "launches")},
        seconds=time.time() - t0)
    log(f"[10 bler_tail_sweep] {json.dumps(rec['bler_tail_sweep'])}")
    if sw["rem"] != 0 or not sw["verified"]["ok"]:
        raise AssertionError(f"bler_tail_sweep: rem {sw['rem']}, "
                             f"{sw['verified']}")
    for kernel in ("bsr_spmm_flat", "bcsr_spmm"):
        launched(sw["launches"], kernel, "ring_f32", "bler_tail_sweep")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def tools_phase(tb, tmp: str) -> dict:
    """Phase 11: the six tools studies' entry points at a short depth,
    each held to its routes (module docstring, phase 11)."""
    import numpy as np
    import torch

    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments import (million_link,
                                               million_z19_probe,
                                               perf_sweep, plateau_study,
                                               profile_bcsr_build,
                                               reorder_bench)

    rec = {}

    def routes(launches, name, want):
        """Each kernel of ``want`` launched on its route only, the others
        not at all."""
        got = {k: set(v) for k, v in launches.items()}
        if got != {k: {r} for k, r in want.items()} or any(
                n <= 0 for v in launches.values() for n in v.values()):
            raise AssertionError(f"{name}: launches {launches}, want some "
                                 f"on {want} only")

    def done(name, r, t0):
        r["seconds"] = time.time() - t0
        rec[name] = r
        log(f"[11 {name}] {json.dumps(r)}")
        gc.collect()
        torch.cuda.empty_cache()

    # (a) plateau_study's row at cell 24, one segment of 125 iterations.
    t0 = time.time()
    row = plateau_study.run_cell(PLATEAU_CELL, device="cuda", segments=1)
    done("plateau_study", {k: row[k] for k in ("K", "C", "lb", "Z_fin",
                                               "probes", "curve",
                                               "launches")}, t0)
    if (row["Z_fin"] is None or abs(row["Z_fin"] - PLATEAU_Z_REF) > 1
            or not math.isfinite(row["ub_final"])):
        raise AssertionError(f"plateau_study: Z_fin {row['Z_fin']} (record "
                             f"{PLATEAU_Z_REF}), ub {row.get('ub_final')}")
    routes(row["launches"], "plateau_study",
           {"bsr_spmm_flat": "ring", "bcsr_spmm": "ring"})

    # (b) million_link at the tools' mid cell, 64x64 blocks, with rounding.
    t0 = time.time()
    ml = million_link.main(cell=TOOLS_CELL, nit=6, block=64, segment=3,
                           do_rounding=True, device="cuda",
                           out_path=os.path.join(tmp, "million_link.json"))
    done("million_link", {k: ml[k] for k in (
        "K", "bcsr_Kb", "bcsr_maxblk", "Z_probe", "ub_curve", "rounding_rem",
        "verified", "budget_gb", "launches")}, t0)
    bud = ml["budget_gb"]
    if (ml["rounding_rem"] == 0) != ml["verified"]["ok"]:
        raise AssertionError(f"million_link: rem {ml['rounding_rem']}, "
                             f"verified {ml['verified']}")
    if not all(0 < bud[k] < bud["device_total"] for k in (
            "measured_peak_after_build", "measured_peak_after_solve")):
        raise AssertionError(f"million_link: budget {bud}")
    routes(ml["launches"], "million_link", {"bcsr_spmm": "short_bf16"})

    # (c) the z19 probe's body at the mid cell, Z = lb + 4.
    t0 = time.time()
    S, Q, h = LargeEnv(TOOLS_CELL, RHO, seed=SEED).generate_state_csr()
    lb = int(np.diff(Q.indptr).max()) + 1
    zp = million_z19_probe.probe(S, Q, h, lb + 4, nit=9, device="cuda")
    del S, Q, h
    done("million_z19_probe", zp, t0)
    if (zp["rem"] == 0) != zp["verified"]["ok"]:
        raise AssertionError(f"million_z19_probe: rem {zp['rem']}, "
                             f"verified {zp['verified']}")
    routes(zp["launches"], "million_z19_probe", {"bcsr_spmm": "ring"})

    # (d) reorder_bench's raster 128 and Hilbert 8x128 runs.
    t0 = time.time()
    runs = [reorder_bench.run_one(order, cell=TOOLS_CELL, nit=5, block=b,
                                  device="cuda")
            for order, b in (("raster", 128), ("hilbert", (8, 128)))]
    done("reorder_bench", {"runs": runs}, t0)
    if len({(r["K"], r["nnz"]) for r in runs}) != 1:
        raise AssertionError(f"reorder_bench: K, nnz differ: {runs}")
    for r, route in zip(runs, ("ring", "short_bf16")):
        routes(r["launches"], f"reorder_bench {r['order']} {r['block']}",
               {"bsr_spmm_flat": route, "bcsr_spmm": route})

    # (e) perf_sweep at m=32 and 8 on the tool's users (the dense path:
    # no kernel).
    t0 = time.time()
    ps = perf_sweep.main(ms=(32, 8), geometry=PERF_SWEEP_GEOMETRY,
                         device="cuda")
    done("perf_sweep", {k: ps[k] for k in ("K", "rows", "max_ub_diff",
                                           "launches")}, t0)
    if (not all(math.isfinite(r["ub_final"]) for r in ps["rows"])
            or ps["launches"]):
        raise AssertionError(f"perf_sweep: {ps}")

    # (f) the host stage profile of the block-operand build.
    t0 = time.time()
    pb = profile_bcsr_build.main(cell=TOOLS_CELL, device="cuda")
    done("profile_bcsr_build", {k: pb[k] for k in (
        "K", "stages_s", "maxblk", "blocks_gib", "gram_map_shape",
        "weights_nnz", "q_blocks")}, t0)
    if not all(math.isfinite(v) and v >= 0 for v in pb["stages_s"].values()):
        raise AssertionError(f"profile_bcsr_build: {pb['stages_s']}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments import bench_flat_spmm
    from sig_sdp_mmw_torch.experiments.e2e_large import main as e2e_main
    from sig_sdp_mmw_torch.experiments.million_link_e2e import \
        main as million_main
    from sig_sdp_mmw_torch.native import builder, native_available
    from sig_sdp_mmw_torch.ops import bcsr as tb
    from sig_sdp_mmw_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    # ---- 1. build, every compiler at once ----------------------------------
    def build(item):
        name, fn = item
        t0 = time.time()
        ok = fn()
        return name, ok, time.time() - t0

    t0 = time.time()
    jobs = [*kernels.LIBRARIES.items(), ("sig_native", native_available)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(build, jobs))
    for name, ok, dt in built:
        if ok is False:
            raise RuntimeError(f"native host library did not build: "
                               f"{builder.build_error}")
        log(f"[1 build] {name} {dt:.2f}s")
    log(f"[1 build] all {time.time() - t0:.2f}s")
    for name in kernels.LIBRARIES:
        for line in kernels.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1 build] ptxas {name}: {line.strip()}")
    gpu = gpu_line()
    log(gpu)

    # ---- 2. kernels vs plain at the paths' shapes --------------------------
    t0 = time.time()
    S, Q, _ = LargeEnv(CELL, RHO, seed=SEED).generate_state_csr()
    St = build_st_csr(S, Q)
    log(f"[2 kernel] operand: K={St.shape[0]} nnz(S~)={St.nnz} "
        f"[{time.time() - t0:.1f}s]")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {}
    # The routes each kernel took in this phase, and the float32 cases.
    kernel_routes = {name: set() for name in REPLACES}
    f32 = {name: [] for name in REPLACES}

    def randn(rows, D):
        return torch.randn((rows, D), generator=gen, device="cuda")

    def note(key, kind, name, fn, mat, V, rec):
        """The route of a case checked by compare(); for float32 blocks,
        one more launch counted on its route, and the case's record."""
        Br, Bc = (mat.Brow, mat.B) if kind == "ell" else (mat.Br, mat.Bc)
        route = tb.spmm_route(kind, Br, Bc, mat.blocks.dtype)
        kernel_routes[key].add(route)
        if mat.blocks.dtype == torch.float32:
            check_route(tb, name, fn, kind, mat, V)
            f32[key].append(f32_record(name, route, rec))

    def check_flat(op, csr, dt, dims, library=(), split=()):
        mat = tb.bsr_flat_from_csr(csr, block=128, group=GROUP, dtype=dt,
                                   device="cuda")
        for D in dims:
            V = randn(mat.nrows, D)
            name = f"flat {op} {str(dt).split('.')[-1]} D={D}"
            log(f"[2 kernel] {name}: steps={mat.nsteps}x{mat.G}")
            cases[name] = compare(name, mat, V,
                                  lambda: tb.bsr_spmm_flat(mat, V),
                                  lambda: tb.bsr_spmm_flat_reference(mat, V),
                                  library=D in library)
            note("bsr_spmm_flat", "flat", name, tb.bsr_spmm_flat, mat, V,
                 cases[name])
            if D in split:   # D over two CTAs of D/2 columns each
                cases[f"{name} cols={D // 2}"] = compare(
                    f"{name} cols={D // 2}", mat, V,
                    lambda: tb.bsr_spmm_flat(mat, V, tile_cols=D // 2),
                    lambda: tb.bsr_spmm_flat_reference(mat, V))

    def check_ell(name, mat, D, row_chunk=None, iters=20, library=False):
        V = randn(mat.nrows, D)
        log(f"[2 kernel] {name}: Kbr={mat.Kb} maxblk={mat.bcols.shape[1]}")
        cases[name] = compare(
            name, mat, V, lambda: tb.bcsr_spmm(mat, V),
            lambda: tb.bcsr_spmm_reference(mat, V, row_chunk=row_chunk),
            iters, library)
        note("bcsr_spmm_ell", "ell", name, tb.bcsr_spmm, mat, V, cases[name])

    def q_operator(ops):
        """The association operator Q: its block layout from the operand
        builder, random edge values scattered as the solver does."""
        Kbr, maxblkQ = ops.q_bcols.shape
        Br, Bc = ops.s_blocks.Brow, ops.s_blocks.B
        qvals = torch.zeros(Kbr * Br * maxblkQ * Bc, dtype=torch.bfloat16,
                            device="cuda")
        evals = torch.randn((int(ops.q_eidx.max()) + 1,), generator=gen,
                            device="cuda")
        qvals[ops.q_pos] = evals[ops.q_eidx].to(torch.bfloat16)
        return tb.BlockEll(bcols=ops.q_bcols,
                           blocks=qvals.reshape(Kbr, Br, maxblkQ, Bc),
                           nrows=ops.s_blocks.nrows)

    check_flat("S~", St, torch.bfloat16, (32, 48, 64, 128), library=(48, 128),
               split=(128,))
    check_flat("S~", St, torch.float32, (32, 128), library=(32, 128))
    # The 100k path's other flat operand, S̃ᵀ: another CSR, with its own
    # count of steps per block-row.
    check_flat("S~T", St.transpose().tocsr(), torch.bfloat16, (128,))
    for dt, dims in ((torch.bfloat16, (48, 128)), (torch.float32, (48, 128))):
        mat = tb.bcsr_from_csr(St, block=128, dtype=dt, device="cuda")
        for D in dims:
            check_ell(f"ell S~ {str(dt).split('.')[-1]} D={D}", mat, D,
                      library=dt == torch.float32)
        del mat
    check_ell("ell Q bfloat16 D=128", q_operator(tb.bcsr_operands_from_state(
        S, Q, block=128, dtype=torch.bfloat16, device="cuda")), 128,
        library=True)
    # Kernel #2 directly: G=32 streams the same real blocks as G=8.
    for G, dims in ((8, (48, 128)), (32, (48,))):
        mat = tb.bsr_flat_from_csr(St, block=128, group=G,
                                   dtype=torch.bfloat16, device="cuda")
        for D in dims:
            V = randn(mat.nrows, D)
            name = f"vres S~ bfloat16 G={G} D={D}"
            log(f"[2 kernel] {name}: steps={mat.nsteps}x{mat.G}")
            cases[name] = compare(name, mat, V,
                                  lambda: tb.bsr_spmm_vres(mat, V),
                                  lambda: tb.bsr_spmm_flat_reference(mat, V),
                                  library=G == 8)
            note("bsr_spmm_vres", "vres", name, tb.bsr_spmm_vres, mat, V,
                 cases[name])
        del mat
    # Kernel #2's float32 body (tma_f32) on the same S̃ at G=8.
    mat = tb.bsr_flat_from_csr(St, block=128, group=GROUP,
                               dtype=torch.float32, device="cuda")
    for D in (32, 48, 64, 128):
        V = randn(mat.nrows, D)
        name = f"vres S~ float32 G={GROUP} D={D}"
        log(f"[2 kernel] {name}: steps={mat.nsteps}x{mat.G}")
        cases[name] = compare(name, mat, V, lambda: tb.bsr_spmm_vres(mat, V),
                              lambda: tb.bsr_spmm_flat_reference(mat, V),
                              library=True)
        note("bsr_spmm_vres", "vres", name, tb.bsr_spmm_vres, mat, V,
             cases[name])
    del mat, V
    torch.cuda.empty_cache()

    # Block shapes without a 128x128 fast path, on the same S̃.
    generic = {name: [] for name in REPLACES}

    def check_generic(kind, mat, D=GENERIC_D, iters=20, op="100k S~"):
        Br, Bc = (mat.Brow, mat.B) if kind == "ell" else (mat.Br, mat.Bc)
        dt = mat.blocks.dtype
        dname = str(dt).split(".")[-1]
        fn, plain = bench_flat_spmm.spmm_pair(kind)
        key = "bcsr_spmm_ell" if kind == "ell" else f"bsr_spmm_{kind}"
        shape = (f"Kbr={mat.Kb} maxblk={mat.bcols.shape[1]}" if kind == "ell"
                 else f"Kbr={mat.Kbr} steps={mat.nsteps}x{mat.G}")
        V = randn(mat.nrows, D)
        route = tb.spmm_route(kind, Br, Bc, dt)
        name = f"{route} {kind} {op} {Br}x{Bc} {dname} D={D}"
        log(f"[2 generic] {name}: {shape}")
        g0 = fn.generic_launches
        rec = compare(name, mat, V, lambda: fn(mat, V), lambda: plain(mat, V),
                      iters=iters, library=True)
        if fn.generic_launches <= g0:
            raise AssertionError(f"{name} did not go through the generic "
                                 "launches")
        note(key, kind, name, fn, mat, V, rec)
        gather = bench_flat_spmm.v_gather_bytes(mat, D)
        moved = rec["bytes_needed"] - 2 * mat.nrows * D * 4 + gather
        log(f"[2 generic] {name}: V gathered {gather / 1e6:.1f} MB, blocks + "
            f"V gathered {moved / 1e6:.1f} MB at {moved / rec['ms'] / 1e9:.3f}"
            f" TB/s")
        generic[key].append(dict(
            operand=op, shape=f"{Br}x{Bc}", dtype=dname, route=route, D=D,
            rows=mat.nrows, max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], share=rec["bound_ms"] / rec["ms"],
            v_gather_bytes=gather, library_ms=rec["library_ms"],
            library_call=rec["library_call"],
            library_dtype=rec["library_dtype"]))
        del V
        torch.cuda.empty_cache()
        return generic[key][-1]

    def check_shape(kind, csr, block, dt=torch.bfloat16, dims=(GENERIC_D,),
                    iters=20, op="100k S~"):
        mat = bench_flat_spmm.shape_operand(kind, csr, block, dt, GROUP)
        recs = [check_generic(kind, mat, D, iters, op) for D in dims]
        del mat
        return recs

    t0 = time.time()
    short48, short128 = check_shape("flat", St, (8, 128), dims=(48, 128))
    for block in ((16, 128), (32, 32), (8, 8)):
        check_shape("flat", St, block)
    for block in ((8, 128), (16, 128), (16, 16), (32, 32)):
        check_shape("ell", St, block)
    check_shape("vres", St, (8, 128))
    # Float32 blocks of those shapes (short_f32): the packers' default
    # 8x128, the dryrun's 8x8 and the mid-K search's 32x32.
    for kind, block in (("flat", (8, 128)), ("ell", (8, 128)), ("ell", (8, 8)),
                        ("flat", (32, 32)), ("ell", (32, 32))):
        check_shape(kind, St, block, torch.float32)
    # Block height on the 100k S̃ (queue 2's item 5), measured only.
    for D, short in ((48, short48), (128, short128)):
        ring = cases[f"flat S~ bfloat16 D={D}"]
        log(f"[2 height] 100k S~ flat bf16 D={D}: 8x128 short tile "
            f"{short['ms']:.4f} ms (bound {short['bound_ms']:.4f}), 128x128 "
            f"ring tile {ring['ms']:.4f} ms (bound {ring['bound_ms']:.4f})")
    log(f"[2 generic] 100k shapes [{time.time() - t0:.1f}s]")

    # The mid-K path's own operands (phase 6): cell 40 at 32x32 bf16 blocks
    # from bcsr_operands_from_state as the path makes them, S̃ through the
    # flat kernel and S̃ and Q through the block-ELL kernel, at the solver's
    # D_pad of 128 and at D=8, the gap log's D=1 padded.
    t0 = time.time()
    Sm, Qm, _ = LargeEnv(MIDK_CELL, RHO, seed=SEED).generate_state_csr()
    ops = tb.bcsr_operands_from_state(
        Sm, Qm, block=MIDK_BLOCK, dtype=torch.bfloat16, store_transpose=True,
        flat_group=GROUP, device="cuda")
    for D in (128, 8):
        check_generic("flat", ops.s_flat, D, op="midK S~")
        check_generic("ell", ops.s_blocks, D, op="midK S~")
    check_generic("ell", q_operator(ops), 128, op="midK Q")
    del Sm, Qm, ops
    log(f"[2 generic] mid-K shapes [{time.time() - t0:.1f}s]")

    # Kernel #2 on its path, the SpMM bench entry point (its vres runs are
    # checked against the plain version inside).
    reset_launches(tb)
    bench = bench_flat_spmm.main(cell=CELL, D=48, iters=10, groups=(8, 32))
    vres_launches = tb.bsr_spmm_vres.launches
    for r in bench["runs"]:
        log(f"[2 bench] {json.dumps(r)}")
    if not vres_launches:
        raise AssertionError("the SpMM bench did not launch bsr_spmm_vres")
    torch.cuda.empty_cache()

    # The million-link S̃ and Q through the block-ELL kernel, from the
    # operand builder of the million-link path.
    t0 = time.time()
    S1, Q1, _ = LargeEnv(MILLION_CELL, RHO, seed=SEED).generate_state_csr()
    ops = tb.bcsr_operands_from_state(S1, Q1, block=128, dtype=torch.bfloat16,
                                      device="cuda")
    mat = ops.s_blocks
    log(f"[2 kernel] million-link operand: K={S1.shape[0]} "
        f"nnz(S~)={ops.nnz} blocks {tuple(mat.blocks.shape)} "
        f"Q slots {tuple(ops.q_bcols.shape)} [{time.time() - t0:.1f}s]")
    St1 = build_st_csr(S1, Q1)
    del S1, Q1
    check_ell("ell S~ 1M bfloat16 D=48", mat, 48,
              row_chunk=MILLION_ROW_CHUNK, iters=5, library=True)
    del mat
    qop = q_operator(ops)
    del ops
    torch.cuda.empty_cache()
    check_ell("ell Q 1M bfloat16 D=48", qop, 48,
              row_chunk=MILLION_ROW_CHUNK, iters=5, library=True)
    del qop
    torch.cuda.empty_cache()
    # The million-link S̃ as flat block-CSR at the packers' default 8x128
    # blocks: 126,160 block-rows, past a grid's 65,535 in its second
    # dimension.  D=16 keeps the plain version's gathered V (one [128, D]
    # float32 slice per slot, 1.0M slots) at 8 GB.
    t0 = time.time()
    r, = check_shape("flat", St1, (8, 128), dims=(16,), iters=5,
                     op="1M S~")
    if r["rows"] // 8 <= 65535:
        raise AssertionError(f"million-link 8x128 operand has only "
                             f"{r['rows'] // 8} block-rows")
    log(f"[2 generic] million-link 8x128 [{time.time() - t0:.1f}s]")
    # The million-link S̃ as block-ELL 64x64 bf16 blocks at D=48, the
    # operand of experiments/million_link.py at the records' block size
    # (phase 11).
    t0 = time.time()
    check_shape("ell", St1, (64, 64), dims=(48,), iters=5, op="1M S~")
    log(f"[2 generic] million-link 64x64 [{time.time() - t0:.1f}s]")
    del S, Q, St, St1
    gc.collect()
    torch.cuda.empty_cache()

    log("[2 f32] " + json.dumps(f32))
    log(f"[time] phase 1-2 {time.time() - t_start:.1f}s")

    # ---- 3. the 100k path, end to end --------------------------------------
    t_phase = time.time()
    reset_launches(tb)
    last = {}
    with remembering_last_rounding(last):
        rec = e2e_main(cell=CELL, rho=RHO, seed=SEED, nit=NIT, eta=ETA,
                       nattempt=NATTEMPT, block=128, bf16=True,
                       flat_group=GROUP, device="cuda", rounding="device")
    flat_launches = tb.bsr_spmm_flat.launches
    ell_launches_100k = tb.bcsr_spmm.launches
    vres_launches_100k = tb.bsr_spmm_vres.launches
    rec["rounding_compare"] = native_rounding_on_last_factor(
        last, rec["rounding_us_per_probe"][-1] / 1e6)
    log("[3 e2e] phases_s " + json.dumps(rec["phases_s"]))
    log(f"[3 e2e] K={rec['K']} nnz(S)={rec['nnz_S']} nnz(Q)={rec['nnz_Q']} "
        f"lb={rec['lb']} ub={rec['ub']} probes={rec['n_probes']} "
        f"probe_Z={rec['probe_Z']} Z_fin={rec['Z_fin']} "
        f"(E2E_LARGE.json: 16) rem={rec['remainder']}")
    log(f"[3 e2e] solve_s per probe "
        f"{[round(x / 1e6, 3) for x in rec['solve_us_per_probe']]}, "
        f"rounding_s per probe "
        f"{[round(x / 1e6, 3) for x in rec['rounding_us_per_probe']]}")
    log(f"[3 e2e] verify: feasible={rec['verified_feasible']} "
        f"interf={rec['n_interf_vio']} asso={rec['n_asso_vio']}; bler "
        f"mean={rec['bler_mean']:.4e} max={rec['bler_max']:.4e} "
        f"frac>1e-5={rec['bler_frac_above_1e-5']:.4f}; tail "
        + json.dumps(rec["tail_decomposition"]))
    log(f"[3 e2e] operand devices {rec['operand_devices']}; launches: flat "
        f"{flat_launches}, block-ELL {ell_launches_100k}, V-resident "
        f"{vres_launches_100k}")
    routes = [r["route"] for r in rec["rounding_info"]]
    log(f"[3 rounding] rounding={rec['rounding']} routes {routes}; Z_pad "
        f"{rec['rounding_info'][0]['Z_pad']}; wavefront rounds per attempt, "
        f"per probe {[r.get('rounds') for r in rec['rounding_info']]}")
    log(f"[3 rounding] rems per attempt, per probe "
        f"{[r.get('rems') for r in rec['rounding_info']]}")
    r = rec["rounding_compare"]
    log(f"[3 rounding] last probe Z={r['Z']}: device (wavefront) "
        f"{r['device_s']:.3f} s rem {r['device_rem']}; native scan "
        f"{r['native_s']:.3f} s rem {r['native_rem']}, same X_half")
    for name in ("mgain", "mrand"):
        h = rec[name]
        log(f"[3 heuristics] {name}@Z={rec['Z_fin']}: rem={h['rem']} "
            f"verified={h['verified_feasible']} interf={h['n_interf_vio']} "
            f"asso={h['n_asso_vio']} bler mean={h['bler_mean']:.4e} "
            f"frac>1e-5={h['bler_frac_above_1e-5']:.4f} "
            f"[{h['wall_s']:.2f}s] (E2E_LARGE.json: {E2E_HEUR_REF[name]})")
        # rem 0 must mean a feasible assignment.  (MAX_RAND's scan visits
        # the first K of a random order over all Kp users, so rem also
        # counts valid users it never visited; their random slots may still
        # fit, so rem > 0 alone does not mean infeasible.)
        if h["rem"] == 0 and not h["verified_feasible"]:
            raise AssertionError(f"{name}: rem 0 but the checker fails")
    if routes != ["wavefront"] * rec["n_probes"]:
        raise AssertionError(f"100k rounding routes {routes}, want the "
                             "wavefront at every probe")
    if rec["remainder"] != 0 or not rec["verified_feasible"]:
        raise AssertionError("100k assignment is not feasible")
    if abs(rec["Z_fin"] - E2E_Z_REF) > 1:
        raise AssertionError(f"100k Z_fin {rec['Z_fin']} is not within 1 of "
                             f"{E2E_Z_REF}")
    if rec["operand_devices"] != ["cuda"]:
        raise AssertionError(f"operands off the card: {rec['operand_devices']}")
    if flat_launches < rec["n_probes"] * NIT:
        raise AssertionError(f"only {flat_launches} flat launches for "
                             f"{rec['n_probes']} probes x {NIT} iterations")
    if ell_launches_100k < rec["n_probes"] * NIT:
        raise AssertionError(f"only {ell_launches_100k} block-ELL launches "
                             f"for {rec['n_probes']} probes x {NIT} "
                             "iterations")
    if vres_launches_100k:
        raise AssertionError("the 100k path launched the V-resident kernel")
    e2e_rec = {k: rec[k] for k in ("Z_fin", "n_probes", "probe_Z",
                                    "rounding_info", "rounding_compare",
                                    "mgain", "mrand")}
    log(f"[3 f32] the search's first probe (bf16, Z={rec['probe_Z'][0]}): "
        f"{rec['solve_us_per_probe'][0] / NIT / 1e3:.3f} ms per iteration")
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    gap_check(tb)
    gc.collect()
    torch.cuda.empty_cache()
    e2e_rec["f32_solve"] = f32_solve_check(tb, e2e_rec["probe_Z"][0])
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] phase 3 {time.time() - t_phase:.1f}s")

    # ---- 4. the million-link path, end to end ------------------------------
    t_phase = time.time()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tb)
    ml = million_main(cell=MILLION_CELL, skip_bler=True, device="cuda",
                      nit_conv=MILLION_NIT_CONV)
    ell_launches = tb.bcsr_spmm.launches
    vres_launches_1m = tb.bsr_spmm_vres.launches
    cfg = ml["config"]
    log("[4 1M] phases_s " + json.dumps(ml["phases_s"]))
    log(f"[4 1M] K={ml['K']} nnz(S)={ml['nnz_S']} maxblk={ml['bcsr_maxblk']} "
        f"lb={ml['lb']} probes={json.dumps(ml['probes'])}")
    log(f"[4 1M] Z_fin={ml['Z_fin']} (MILLION_LINK_E2E.json: "
        f"{MILLION_Z_REF}) conv_curve={ml['conv_curve']} "
        f"ub_final={ml['ub_final']:.4f} final={json.dumps(ml['final'])}")
    log(f"[4 1M] verify: feasible={ml['verified_feasible']} "
        f"interf={ml['n_interf_vio']} asso={ml['n_asso_vio']}; operand "
        f"devices {ml['operand_devices']}; launches: block-ELL "
        f"{ell_launches}, flat {tb.bsr_spmm_flat.launches}, V-resident "
        f"{vres_launches_1m}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if ml["K"] != 1_009_200:
        raise AssertionError(f"million-link K={ml['K']}")
    if ml["remainder"] != 0 or not ml["verified_feasible"]:
        raise AssertionError("million-link assignment is not feasible")
    if ml["operand_devices"] != ["cuda"]:
        raise AssertionError(f"operands off the card: {ml['operand_devices']}")
    if abs(ml["Z_fin"] - MILLION_Z_REF) > 1:
        raise AssertionError(f"million-link Z_fin {ml['Z_fin']} is not "
                             f"within 1 of {MILLION_Z_REF}")
    need = ml["n_probes"] * cfg["nit_probe"] * 3 * cfg["lanczos_m"]
    if ell_launches < need:
        raise AssertionError(f"only {ell_launches} block-ELL launches, "
                             f"need {need}")
    if vres_launches_1m:
        raise AssertionError("the million-link path launched the V-resident "
                             "kernel")
    del ml
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] phase 4 {time.time() - t_phase:.1f}s")

    # ---- 5. the dense journal-scale path -----------------------------------
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        dense_phase(tb, os.path.join(tmp, "sim_mmw_time"))
    log(f"[time] phase 5 {time.time() - t_phase:.1f}s")

    # ---- 6. mid-K: batched rounding, speculative search, short-block tiles
    t_phase = time.time()
    midk = midk_phase(tb, e2e_main)
    log(f"[time] phase 6 {time.time() - t_phase:.1f}s")

    with tempfile.TemporaryDirectory() as journal_dir:
        # ---- 7. the journal comparison slice -------------------------------
        t_phase = time.time()
        journal = journal_phase(tb, journal_dir)
        log(f"[time] phase 7 {time.time() - t_phase:.1f}s")

        # ---- 8. the sharded path -------------------------------------------
        t_phase = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            sharded = sharded_phase(tb, tmp)
        log(f"[time] phase 8 {time.time() - t_phase:.1f}s")

        # ---- 9. block pair, block Grams, figures, the oracle report --------
        t_phase = time.time()
        reset_launches(tb)
        pair = block_pair_phase(tb, journal_dir,
                                journal["sim_mmw_oracle_z"]["Z"])
        log(f"[time] phase 9 {time.time() - t_phase:.1f}s")

    # ---- 10. the 100k quality studies, the oracle on the JAX users ---------
    t_phase = time.time()
    reset_launches(tb)
    with tempfile.TemporaryDirectory() as tmp:
        studies = studies_phase(tb, tmp)
    studies_launches = {"bsr_spmm_flat": tb.bsr_spmm_flat.launches,
                        "bcsr_spmm_ell": tb.bcsr_spmm.launches}
    if tb.bsr_spmm_vres.launches:
        raise AssertionError("the studies launched the V-resident kernel")
    log(f"[10 studies] launches {json.dumps(studies_launches)}")
    log(f"[time] phase 10 {time.time() - t_phase:.1f}s")

    # ---- 11. the tools studies ---------------------------------------------
    t_phase = time.time()
    reset_launches(tb)
    with tempfile.TemporaryDirectory() as tmp:
        tools = tools_phase(tb, tmp)
    tools_launches = {"bsr_spmm_flat": tb.bsr_spmm_flat.launches,
                      "bcsr_spmm_ell": tb.bcsr_spmm.launches}
    if tb.bsr_spmm_vres.launches:
        raise AssertionError("the tools studies launched the V-resident "
                             "kernel")
    log(f"[11 tools] launches {json.dumps(tools_launches)}")
    log(f"[time] phase 11 {time.time() - t_phase:.1f}s")
    log(f"[done] {time.time() - t_start:.1f}s")

    def per_rank(name):
        return {run: [n[name] for n in ranks]
                for run, ranks in sharded["launches"].items()}

    def entry(name, launches, case, source, generic_launches):
        return {"name": name, "route": "cuda",
                "source": f"sig_sdp_mmw_torch/ops/kernels/csrc/{source}",
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "generic_launches": generic_launches,
                "block_shapes": generic[name],
                "routes": sorted(kernel_routes[name]),
                "f32_cases": f32[name] + (sharded["f32"]
                                          if name == "bcsr_spmm_ell" else []),
                "sharded_launches_per_rank": per_rank(
                    "bcsr_spmm" if name == "bcsr_spmm_ell" else name),
                **({"block_pair_launches": pair["pair"]["launches"]}
                   if name == "bcsr_spmm_ell" else {}),
                **({"studies_launches": studies_launches[name]}
                   if name in studies_launches else {}),
                **({"tools_launches": tools_launches[name]}
                   if name in tools_launches else {})}

    log(f"[11 summary] {json.dumps(tools)}")
    log(f"[10 summary] {json.dumps(studies)}")
    log(f"[9 summary] {json.dumps(pair)}")
    log(f"[7 summary] {json.dumps(journal)}")
    log(f"[6 summary] {json.dumps(midk)}")
    log(f"[3 summary] {json.dumps(e2e_rec)}")
    log(gpu)
    log(json.dumps({"kernels": [
        entry("bsr_spmm_flat", flat_launches, cases["flat S~ bfloat16 D=128"],
              "bsr_spmm_flat.cu", midk["flat_generic_launches"]),
        entry("bcsr_spmm_ell", ell_launches, cases["ell S~ 1M bfloat16 D=48"],
              "bcsr_spmm_ell.cu", midk["ell_generic_launches"]),
        entry("bsr_spmm_vres", vres_launches,
              cases["vres S~ bfloat16 G=8 D=48"], "bsr_spmm_vres.cu", 0),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
