"""Sweep of the dense MMW solve's Lanczos depth at the bench instance: the
time of a solve and its final bound for each ``lanczos_m``.

Port of ``tools/perf_sweep.py``.  The instance is the tool's: the dense
``WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=7,
pad_to=320)`` (K=300), ``mmw_solve`` at Z=12, nit 150, eta 0.05, D_pad =
rank_pad = 32, for ``lanczos_m`` in 32, 24, 16, 12, 8; per m the median of
3 timed solves after a warm one (each closed by reading ``ub_final``, which
waits for the card), its iterations per second and ``ub_final``.  The
solver's default depth rests on the claim that ``ub_final`` is
bit-identical from m=8 to 48 (``models/mmw.py``'s
``mmw_default_lanczos_m``); the record gives the largest difference
between the depths.  The dense path launches no kernel of the port (its
launches are recorded, and are 0).

The tool's users are drawn by ``jax.random``; ``--geometry F`` places them
from a geometry npz (``tests/fixtures/perf_sweep_cell10_seed7_geometry.npz``,
written by ``tests/torch_jax_geometry.py``; it names its seed, which must
be the env's), so the card sweeps the tool's own state.  Without it the
port draws its own users.  Draws of the solve: the tool's ``PRNGKey(0)``
for every solve, here ``TorchDraws(0)``; ``main(draws=)`` takes others.
Writes JSON only to ``--out``.

    python -m sig_sdp_mmw_torch.experiments.perf_sweep \\
        --geometry tests/fixtures/perf_sweep_cell10_seed7_geometry.npz
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np

print = functools.partial(print, flush=True)

MS = (32, 24, 16, 12, 8)
CELL, RHO, ENV_SEED, PAD_TO = 10, 0.0075, 7, 320


def geometry_users(path, seed=ENV_SEED) -> dict:
    """``WirelessEnv`` keywords placing seed ``seed``'s users from a
    geometry npz that names its seeds (``seeds`` [n], ``sta_locs``,
    ``sta_dirs`` [n, K, 2])."""
    g = np.load(path)
    seeds = [int(s) for s in g["seeds"]]
    if seed not in seeds:
        raise ValueError(f"{path} holds seeds {seeds}, not {seed}")
    i = seeds.index(seed)
    return dict(sta_locs=g["sta_locs"][i], sta_dirs=g["sta_dirs"][i])


def timed(fn, n=3):
    """(median seconds of ``n`` calls after a warm one, the last output;
    with ``n`` 0, the warm call's)."""
    t0 = time.perf_counter()
    out = fn()
    float(out.ub_final)
    ts = [time.perf_counter() - t0] if n == 0 else []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        float(out.ub_final)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def sweep(state, ms=MS, nit=150, Z=12.0, eta=0.05, draws=None, n=3):
    """One row per m: ``{m, ms, it_s, ub_final}``."""
    from sig_sdp_mmw_torch.models.mmw import mmw_solve
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    draws = draws or TorchDraws(0, state.S.device)
    rows = []
    for m in ms:
        t, out = timed(lambda: mmw_solve(
            state, Z, nit=nit, eta=eta, D_pad=32, rank_pad=32, draws=draws,
            lanczos_m=m), n)
        rows.append(dict(m=m, ms=t * 1e3, it_s=nit / t,
                         ub_final=float(out.ub_final)))
        print(f"m={m:3d}  t={t * 1e3:7.1f} ms  it/s={nit / t:8.1f}  "
              f"ub_final={rows[-1]['ub_final']:.6f}")
    return rows


def main(ms=MS, nit=150, geometry=None, n=3, device="cuda", out=None,
         draws=None):
    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.experiments.common import (card_info,
                                                      launch_snapshot,
                                                      launches_since)
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    users = geometry_users(geometry) if geometry else {}
    env = WirelessEnv(cell_size=CELL, sta_density_per_1m2=RHO,
                      seed=ENV_SEED, pad_to=PAD_TO, device=device, **users)
    state = env.generate_S_Q_hmax()
    snap = launch_snapshot()
    rows = sweep(state, ms, nit, draws=draws, n=n)
    ubs = [r["ub_final"] for r in rows]
    rec = {"device": card_info(device), "K": int(state.K), "Z": 12.0,
           "nit": nit, "geometry": geometry, "rows": rows,
           "max_ub_diff": max(ubs) - min(ubs),
           "launches": launches_since(snap)}
    print("[perf_sweep] " + json.dumps(rec))
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ms", type=int, nargs="*", default=list(MS))
    ap.add_argument("--nit", type=int, default=150)
    ap.add_argument("--geometry", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(tuple(a.ms), a.nit, a.geometry, device=a.device, out=a.out)
