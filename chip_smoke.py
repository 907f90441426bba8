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
   * block-ELL (bcsr_spmm) on the same S̃: bf16 at D=48 and D=128, float32
     at D=48; on the 100k association operator Q (bf16, D=128); and on the
     K=1,009,200 S̃ and Q of the million-link path (bf16, D=48) against the
     plain version at row_chunk=2048;
   * V-resident flat (bsr_spmm_vres) on the same S̃: bf16 at G=8 (D=48
     and 128) and G=32 (D=48, every row padded to 32 slots), then through
     the SpMM bench entry point (sig_sdp_mmw_torch/experiments/
     bench_flat_spmm.py) at G=8 and G=32, which also runs the ELL and flat
     kernels on that operand;
   * block shapes without a 128x128 fast path (bf16: the short-block
     tensor-core tile; float32: the generic FMA tile), at D=48 on the same
     S̃: flat at 8x128 (bf16 and float32), 16x128, 32x32 and 8x8 (bf16);
     block-ELL at 8x128, 16x128, 16x16 and 32x32 (bf16); V-resident at
     8x128 (bf16); the K=1,009,200 S̃ as flat 8x128 bf16 blocks, G=8, D=16
     (126,160 block-rows); the mid-K path's own operands (phase 6's cell
     40 from bcsr_operands_from_state, 32x32 bf16 blocks): S̃ through the
     flat kernel and through the block-ELL kernel at D=128 (the solver's
     D_pad) and D=8 (the gap log's D=1 padded), and Q through the
     block-ELL kernel at D=128; each counted as a generic launch, with
     the V bytes the tile gathers per real block
     (bench_flat_spmm.v_gather_bytes); and the block-height comparison:
     the 100k S̃ as flat 8x128 bf16 against the 128x128 ring tile at D=48
     and D=128 (measured only; every main path keeps 128x128);
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
   verify).  Then
   a short solve with the gap log
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
   written with finite times, and a search at cell 15 with MMW(nit=150,
   eta=0.04): rem 0, verified; (d) the SpMM kernels launched 0 times.
6. Mid-K (LargeEnv cell 40, Kp <= 16,384, so the device rounding takes the
   batched route) on 32x32 bf16 blocks, so S̃/S̃ᵀ go through the flat
   kernel's generic tile and Q through the block-ELL kernel's: e2e_large
   with search="binary" and search="speculative" (wave 4): rem 0,
   verified, Z within 1 of each other, generic launches on both kernels,
   none of the V-resident kernel, every operand on the card.
Each phase prints its seconds ("[time] phase N").

Every kernel counts its launches; each path's counts are set to 0 just
before it runs and read just after (the V-resident kernel's path is the
SpMM bench; it must launch 0 times on the 100k and million-link paths,
and no kernel may launch on the dense path, as in the JAX package).
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.  The line before the last is the
kernels' JSON record (each kernel with its phase-6 generic launches and the
generic block shapes checked in phase 2), the last ``{"ok": true,
"device": {...}}``.
"""

import contextlib
import gc
import json
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
DENSE_NIT = 150
E2E_Z_REF = 16        # E2E_LARGE.json (the JAX tool on cell 183)
# The JAX tool's heuristic rows at that Z (E2E_LARGE.json).
E2E_HEUR_REF = {"mgain": "rem 0, verified", "mrand": "rem 19, not verified"}
MIDK_CELL, MIDK_BLOCK = 40, 32
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
    15 and a search at cell 15, (d) no SpMM kernel launched."""
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

    # (c) the entry point, then a search at cell 15 (K=675).
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
    env15 = WirelessEnv(cell_size=15, sta_density_per_1m2=RHO, seed=0,
                        device="cuda")
    st15 = env15.generate_S_Q_hmax()
    bs15 = BinarySearchRelaxation()
    bs15.feasibility_check_alg = MMW(nit=DENSE_NIT, eta=0.04, seed=0)
    t0 = time.time()
    z15, Z15, rem15 = bs15.run(st15)
    s15 = time.time() - t0
    ok15 = verify_assignment(st15, z15)[0]
    p15 = bs15.LOGGED_NP_DATA["bs_search_per_it"]
    rec.update(K15=st15.K, Z_fin15=int(Z15), search15_s=s15,
               rounding15_s_per_probe=(p15[:, 9] / 1e6).tolist())
    log(f"[5 dense] cell 15: K={st15.K} bounds {bs15.set_bounds(st15)} "
        f"probes {p15[:, 5].astype(int).tolist()} Z_fin={Z15} rem={rem15} "
        f"verified={ok15}; search {s15:.3f} s; solve_s per probe "
        f"{[round(float(x) / 1e6, 4) for x in p15[:, 8]]}, rounding_s per "
        f"probe {[round(float(x) / 1e6, 4) for x in p15[:, 9]]}")
    if st15.K != 675 or rem15 != 0 or not ok15:
        raise AssertionError(f"cell 15 (K={st15.K}): rem {rem15}, "
                             f"verified {ok15}")

    # (d) the dense path reaches no SpMM kernel.
    n = (tb.bsr_spmm_flat.launches, tb.bcsr_spmm.launches,
         tb.bsr_spmm_vres.launches)
    log(f"[5 dense] launches: flat {n[0]}, block-ELL {n[1]}, V-resident "
        f"{n[2]} [{time.time() - t_phase:.1f}s]")
    if any(n):
        raise AssertionError(f"the dense path launched SpMM kernels {n}")
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
    kernel's generic tile, Q and the epilogue through the block-ELL
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

    def randn(rows, D):
        return torch.randn((rows, D), generator=gen, device="cuda")

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
    for dt, dims in ((torch.bfloat16, (48, 128)), (torch.float32, (48,))):
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
        del mat
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
    check_shape("flat", St, (8, 128), torch.float32)
    for block in ((16, 128), (32, 32), (8, 8)):
        check_shape("flat", St, block)
    for block in ((8, 128), (16, 128), (16, 16), (32, 32)):
        check_shape("ell", St, block)
    check_shape("vres", St, (8, 128))
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
    del S, Q, St, St1
    gc.collect()
    torch.cuda.empty_cache()

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
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    gap_check(tb)
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

    # ---- 6. mid-K: batched rounding, speculative search, generic tiles -----
    t_phase = time.time()
    midk = midk_phase(tb, e2e_main)
    log(f"[time] phase 6 {time.time() - t_phase:.1f}s")
    log(f"[done] {time.time() - t_start:.1f}s")

    def entry(name, launches, case, source, generic_launches):
        return {"name": name, "route": "cuda",
                "source": f"sig_sdp_mmw_torch/ops/kernels/csrc/{source}",
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "generic_launches": generic_launches,
                "block_shapes": generic[name]}

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
