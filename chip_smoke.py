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
   * the yardstick PyTorch call (bench_flat_spmm.library_spmm: a BSR tensor
     of the real blocks @ V, in the block dtype where PyTorch runs it, else
     float32), with the device kernels the profiler saw it run, for the
     main-path products, the float32 cases and the V-resident cases.  The
     port never calls it.
3. The 100k path: the block-sparse pipeline of
   sig_sdp_mmw_torch/experiments/e2e_large.py on cell 183 (K=100,467; bf16
   blocks, stored transpose, flat_group=8, nit=150, eta=0.05, 10 rounding
   attempts): rem 0, independent verification, every operand on the card,
   S̃/S̃ᵀ through the flat kernel and Q and the epilogue through the
   block-ELL kernel.  Then a short solve with the gap log
   (MMWEll(nit=5, log_gap=True) at Z=16 on that instance's flat operands):
   its gap Lanczos sends D=1 through the flat kernel, and every gap entry
   must be finite.
4. The million-link path: sig_sdp_mmw_torch/experiments/million_link_e2e.py
   at its defaults (cell 580, K=1,009,200: 128x128 bf16 blocks with stored
   transpose, gram_mode="edge", row_chunk=2048, D_pad=48, lanczos_m=8,
   segments of 5, probes at nit=120 with one subspace iteration, the
   convergence run at nit=625, eta=0.04, 3 rounding attempts, window 8),
   without BLER: K, rem 0, verification, Z_fin within 1 of the JAX
   record's 20 (MILLION_LINK_E2E.json), cuda placement, and at least
   probes x nit_probe x 3 x lanczos_m block-ELL launches.  Nothing is cut.

Every kernel counts its launches; each path's counts are set to 0 just
before it runs and read just after (the V-resident kernel's path is the
SpMM bench; it must launch 0 times on the 100k and million-link paths,
as in the JAX package).  Exits non-zero, printing no result, when there
is no CUDA device or any phase fails.  The line before the last is the
kernels' JSON record, the last ``{"ok": true, "device": {...}}``.
"""

import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

CELL, RHO, SEED, NIT, ETA, NATTEMPT, GROUP = 183, 75e-4, 0, 150, 0.05, 10, 8
MILLION_CELL, MILLION_ROW_CHUNK = 580, 2048
MILLION_Z_REF = 20   # MILLION_LINK_E2E.json (19 at a larger probe budget)
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
    """Set every kernel wrapper's launch count to 0."""
    tb.bsr_spmm_flat.launches = tb.bcsr_spmm.launches = 0
    tb.bsr_spmm_vres.launches = 0


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
        log(f"[2 library] {name}: {rec['library_ms']} ms in "
            f"{rec['library_dtype']}, kernels {rec['library_kernels']}, "
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
        qvals = torch.zeros(Kbr * 128 * maxblkQ * 128, dtype=torch.bfloat16,
                            device="cuda")
        evals = torch.randn((int(ops.q_eidx.max()) + 1,), generator=gen,
                            device="cuda")
        qvals[ops.q_pos] = evals[ops.q_eidx].to(torch.bfloat16)
        return tb.BlockEll(bcols=ops.q_bcols,
                           blocks=qvals.reshape(Kbr, 128, maxblkQ, 128),
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
    del S1, Q1
    check_ell("ell S~ 1M bfloat16 D=48", mat, 48,
              row_chunk=MILLION_ROW_CHUNK, iters=5, library=True)
    del mat
    qop = q_operator(ops)
    del ops
    torch.cuda.empty_cache()
    check_ell("ell Q 1M bfloat16 D=48", qop, 48,
              row_chunk=MILLION_ROW_CHUNK, iters=5, library=True)
    del qop, S, Q, St
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3. the 100k path, end to end --------------------------------------
    reset_launches(tb)
    rec = e2e_main(cell=CELL, rho=RHO, seed=SEED, nit=NIT, eta=ETA,
                   nattempt=NATTEMPT, block=128, bf16=True, flat_group=GROUP,
                   device="cuda")
    flat_launches = tb.bsr_spmm_flat.launches
    ell_launches_100k = tb.bcsr_spmm.launches
    vres_launches_100k = tb.bsr_spmm_vres.launches
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
    if rec["remainder"] != 0 or not rec["verified_feasible"]:
        raise AssertionError("100k assignment is not feasible")
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
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    gap_check(tb)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4. the million-link path, end to end ------------------------------
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tb)
    ml = million_main(cell=MILLION_CELL, skip_bler=True, device="cuda")
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
    log(f"[done] {time.time() - t_start:.1f}s")

    def entry(name, launches, case, source, library=None):
        library = library or case
        return {"name": name, "route": "cuda",
                "source": f"sig_sdp_mmw_torch/ops/kernels/csrc/{source}",
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": library["library_ms"]}

    log(gpu)
    log(json.dumps({"kernels": [
        entry("bsr_spmm_flat", flat_launches, cases["flat S~ bfloat16 D=128"],
              "bsr_spmm_flat.cu"),
        entry("bcsr_spmm_ell", ell_launches, cases["ell S~ 1M bfloat16 D=48"],
              "bcsr_spmm_ell.cu"),
        entry("bsr_spmm_vres", vres_launches,
              cases["vres S~ bfloat16 G=8 D=48"], "bsr_spmm_vres.cu"),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
