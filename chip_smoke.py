#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Build: compiles the port's CUDA kernel (sig_sdp_mmw_torch/ops/kernels/
   csrc/bsr_spmm_flat.cu, for sm_90a) and the native host library
   (csrc/sig_native.cpp) from this checkout, and prints the card's name and
   power limit.
2. Kernel vs plain: runs the flat block-CSR SpMM kernel and its plain
   PyTorch version on the K=100,467-link S̃ operand of the main path
   (128x128 blocks, 8 per step), bf16 and float32 blocks, D=32 and D=128,
   and on its S̃ᵀ operand (bf16, D=128), checks that they agree and times
   both (CUDA events, median of 20).
3. End to end: drives the port's main path once, the full block-sparse
   pipeline of sig_sdp_mmw_torch/experiments/e2e_large.py on cell 183
   (K=100,467; the E2E_LARGE.json configuration plus flat_group=8: bf16
   blocks, stored transpose, nit=150, eta=0.05, 10 rounding attempts), and
   checks remainder 0, independent verification, that every operand lives
   on the card and that the search went through the kernel.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.  The line before the last is the kernels' JSON record, the last
line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

CELL, RHO, SEED, NIT, ETA, NATTEMPT, GROUP = 183, 75e-4, 0, 150, 0.05, 10, 8
# Kernel vs plain: both multiply the same (block-dtype-rounded) values and
# sum in float32, in different orders.
REL_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.experiments.e2e_large import main as e2e_main
    from sig_sdp_mmw_torch.native import builder, native_available
    from sig_sdp_mmw_torch.ops import kernels
    from sig_sdp_mmw_torch.ops.bcsr import (bsr_flat_from_csr, bsr_spmm_flat,
                                            bsr_spmm_flat_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ----------------------------------------------------------
    t0 = time.time()
    kernels.bsr_spmm_flat_library()
    t_kernel = time.time() - t0
    t0 = time.time()
    if not native_available():
        raise RuntimeError(f"native host library did not build: "
                           f"{builder.build_error}")
    t_native = time.time() - t0
    log(f"[1 build] bsr_spmm_flat.cu {t_kernel:.2f}s, sig_native.cpp "
        f"{t_native:.2f}s")
    for line in kernels.build_logs.get("bsr_spmm_flat", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1 build] ptxas: {line.strip()}")
    gpu = gpu_line()
    log(gpu)

    # ---- 2. kernel vs plain at the main path's shapes ----------------------
    t0 = time.time()
    S, Q, _ = LargeEnv(CELL, RHO, seed=SEED).generate_state_csr()
    St = build_st_csr(S, Q)
    log(f"[2 kernel] operand: K={St.shape[0]} nnz(S~)={St.nnz} "
        f"[{time.time() - t0:.1f}s]")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {}

    def check(op, csr, dt, dims):
        mat = bsr_flat_from_csr(csr, block=128, group=GROUP, dtype=dt,
                                device="cuda")
        for D in dims:
            V = torch.randn((mat.nrows, D), generator=gen, device="cuda")
            ref = bsr_spmm_flat_reference(mat, V)
            out = bsr_spmm_flat(mat, V)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = REL_TOL * float(ref.abs().max())
            ms = median_ms(lambda: bsr_spmm_flat(mat, V))
            plain_ms = median_ms(lambda: bsr_spmm_flat_reference(mat, V))
            name = f"{op} {str(dt).split('.')[-1]} D={D}"
            cases[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            log(f"[2 kernel] {name}: steps={mat.nsteps}x{mat.G} "
                f"max_abs_err={err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms")
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain ({name})")

    for dt in (torch.bfloat16, torch.float32):
        check("S~", St, dt, (32, 128))
    # The main path's other operand, S̃ᵀ: another CSR, with its own count of
    # steps per block-row.
    check("S~T", St.transpose().tocsr(), torch.bfloat16, (128,))
    torch.cuda.empty_cache()

    # ---- 3. the main path, end to end --------------------------------------
    bsr_spmm_flat.launches = 0
    rec = e2e_main(cell=CELL, rho=RHO, seed=SEED, nit=NIT, eta=ETA,
                   nattempt=NATTEMPT, block=128, bf16=True, flat_group=GROUP,
                   device="cuda")
    launches = bsr_spmm_flat.launches
    ph = rec["phases_s"]
    log("[3 e2e] phases_s " + json.dumps(ph))
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
    log(f"[3 e2e] operand devices {rec['operand_devices']}; flat kernel "
        f"launches {launches}")
    if rec["remainder"] != 0 or not rec["verified_feasible"]:
        raise AssertionError("end-to-end assignment is not feasible")
    if rec["operand_devices"] != ["cuda"]:
        raise AssertionError(f"operands off the card: {rec['operand_devices']}")
    if launches < rec["n_probes"] * NIT:
        raise AssertionError(f"only {launches} kernel launches for "
                             f"{rec['n_probes']} probes x {NIT} iterations")

    main_case = cases["S~ bfloat16 D=128"]
    log(gpu)
    log(json.dumps({"kernels": [{
        "name": "bsr_spmm_flat", "route": "cuda",
        "source": "sig_sdp_mmw_torch/ops/kernels/csrc/bsr_spmm_flat.cu",
        "replaces": "sig_sdp_mmw_tpu/ops/bcsr.py:334",
        "launches": launches, **main_case}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
