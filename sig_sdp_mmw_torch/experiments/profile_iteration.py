"""Where an MMW iteration's device time goes, on the card (torch.profiler).

Four configurations, each as its pipeline runs it:

* ``100k``: cell 183 (K=100,467) as ``experiments/e2e_large.py`` solves
  it: bf16 blocks with stored transpose, S̃/S̃ᵀ through the flat kernel
  (``flat_group=8``), D_pad 128 (pinned by the first probe at Z=60), the
  Lanczos depth of nit=150; one solve of ``nit`` iterations at Z=16,
  epilogue included;
* ``1M``: cell 580 (K=1,009,200) as ``experiments/million_link_e2e.py``
  solves it: the slim state, bf16 block-ELL with stored transpose, edge
  Gram, D_pad 48, lanczos_m 8; one segment of ``nit`` iterations at Z=20
  after a warm-up segment;
* ``dense300``: the dense path's K=300 solve as bench.py times it (the
  reference geometry of ``tests/fixtures/env_mid.npz``, Z=12, nit=150,
  eta=0.05, D_pad 32), all 150 iterations and the epilogue;
* ``dense675``: cell 15 (K=675) as ``experiments/sim_mmw_time.py``'s search
  probes it (Z=16, nit=150, eta=0.04, D_pad from the degree bound).

Each solve runs once unprofiled (kernel builds, allocator), then once under
the profiler (device activity only).  Reports the wall time, the device
time summed over kernels and copies (one stream, so their sum over the wall
time is the device's busy share), the number of kernels and copies, and the
``top`` entries by device time.
Needs a CUDA device; writes JSON only to ``out_path``.

    python -m sig_sdp_mmw_torch.experiments.profile_iteration --out prof.json
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch

print = functools.partial(print, flush=True)


def profile(fn, top: int = 12) -> dict:
    """Wall and device time of one ``fn()`` call, with the ``top`` device
    entries by time (name, calls, ms)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else getattr(e, "self_cuda_time_total", 0)

    evs = sorted((e for e in prof.key_averages() if dev_us(e) > 0),
                 key=dev_us, reverse=True)
    device_ms = sum(dev_us(e) for e in evs) / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3),
            "device_calls": sum(e.count for e in evs),
            "top": [{"name": e.key[:160], "calls": e.count,
                     "ms": dev_us(e) / 1e3} for e in evs[:top]]}


def solve_100k(nit: int):
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.models.mmw import mmw_default_lanczos_m
    from sig_sdp_mmw_torch.models.mmw_ell import MMWEll, mmw_solve_ell
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    env = LargeEnv(183, 75e-4, seed=0)
    S, Q, h = env.generate_state_csr()
    ell = env.generate_ell(device="cuda")
    alg = MMWEll(nit=150, eta=0.05, use_bcsr=True).prepare(
        ell, S, Q, h_max=h, block=128, dtype=torch.bfloat16,
        store_transpose=True, flat_group=8)
    kw = dict(nit=nit, eta=0.05, D_pad=128, rank_pad=128, bcsr=alg.bcsr,
              lanczos_m=mmw_default_lanczos_m(0.05, 150))
    return lambda: mmw_solve_ell(ell, 16.0, draws=TorchDraws(0, "cuda"), **kw)


def solve_1m(nit: int):
    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    S, Q, h = LargeEnv(580, 75e-4, seed=0).generate_state_csr()
    Kp = -(-S.shape[0] // 128) * 128
    slim = ell_slim_from_csr(S, Q, h, pad_rows_to=Kp, device="cuda")
    ops = bcsr_operands_from_state(S, Q, block=128, dtype=torch.bfloat16,
                                   store_transpose=True,
                                   weights_dtype=torch.bfloat16,
                                   device="cuda")
    kw = dict(nit=625, eta=0.04, D_pad=48, rank_pad=48, lanczos_m=8,
              spmm_row_chunk=2048, gram_mode="edge", bcsr=ops,
              draws=TorchDraws(17, "cuda", stream=20), return_carry=True)
    carry = mmw_solve_ell(slim, 20.0, carry_in=None, it_start=0,
                          num_steps=nit, **kw)
    return lambda: mmw_solve_ell(slim, 20.0, carry_in=carry, it_start=nit,
                                 num_steps=nit, **kw)


def solve_dense(cell_size: int, Z: float, eta: float):
    """The dense path's whole solve (nit=150, epilogue included), as a
    probe of the dense search runs it: ``dense300`` is bench.py's solve on
    the K=300 reference geometry (tests/fixtures/env_mid.npz) at Z=12,
    eta=0.05, D_pad 32; ``dense675`` the cell-15 search's solve at Z=16,
    eta=0.04, D_pad from ``MMW._d_pad_for``."""
    import os

    import numpy as np

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models.mmw import MMW, mmw_solve
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    if cell_size == 10:
        fix = np.load(os.path.join(os.path.dirname(__file__), "..", "..",
                                   "tests", "fixtures", "env_mid.npz"))
        env = WirelessEnv(cell_size=10, sta_density_per_1m2=75e-4, seed=3,
                          pad_to=320, sta_locs=fix["sta_locs"])
        D_pad = rank_pad = 32
    else:
        env = WirelessEnv(cell_size=cell_size, sta_density_per_1m2=75e-4,
                          seed=0)
    st = env.generate_S_Q_hmax()
    if cell_size != 10:
        D_pad, rank_pad = MMW(nit=150, eta=eta)._d_pad_for(st, int(Z))
    return lambda: mmw_solve(st, Z, nit=150, eta=eta, D_pad=D_pad,
                             rank_pad=rank_pad, draws=TorchDraws(0, "cuda"))


CELLS = {"100k": solve_100k, "1M": solve_1m,
         "dense300": lambda nit: solve_dense(10, 12.0, 0.05),
         "dense675": lambda nit: solve_dense(15, 16.0, 0.04)}


def main(cells=("100k", "1M", "dense300", "dense675"), nit=5,
         out_path=None):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_iteration measures on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(0), "nit": nit}
    for cell in cells:
        fn = CELLS[cell](nit)
        rec = profile(fn)
        out[cell] = rec
        its = 150 if cell.startswith("dense") else nit
        print(f"[{cell}] {its} iterations: wall {rec['wall_ms']:.2f} ms, "
              f"device {rec['device_ms']:.2f} ms in {rec['device_calls']} "
              f"kernels and copies, busy {rec['busy_share']:.3f}")
        for e in rec["top"]:
            print(f"[{cell}]   {e['ms']:9.3f} ms  {e['calls']:5d}x  "
                  f"{e['name'][:110]}")
        del fn
        torch.cuda.empty_cache()
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+",
                    default=["100k", "1M", "dense300", "dense675"])
    ap.add_argument("--nit", type=int, default=5)
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(tuple(a.cells), a.nit, a.out)
