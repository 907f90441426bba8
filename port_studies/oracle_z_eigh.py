"""Is the card's eigh why its oracle parts from the CPU's?

``oracle_z_devices.py`` found the port's ADMM ``X_final`` (nit 500, the
matched-Z oracle study's) on the card ~1e-2 from the CPU's on the same users
at the probe where their searches part, where the port and the JAX package
on the CPU part by ~3e-5.  This probe repeats that one solve per seed (the
seeds and Z of ``oracle_z_devices.json``) with the PSD projection's eigh
changed, and gives ``max|ΔX_final|`` against the CPU's default solve:

* ``card``: the card as the study runs it (cuSOLVER's float32 eigh);
* ``card_host_eigh``: the card, each eigh done on the CPU in float32 (the
  CPU's eigh, every other operation on the card);
* ``card_host_eigh_cpu_state``: the same on the CPU's state moved to the
  card (the two devices build the state from the same users; this takes
  the state's last bits out too);
* ``card_f64_eigh`` against ``cpu_f64_eigh``: both devices with the eigh in
  float64 (the input cast up, the result down), then each against its own
  float32 default (``card_f64_vs_card``, ``cpu_f64_vs_cpu``): how far the
  eigh's own precision moves each device's answer.

If ``card_host_eigh`` sits at the CPU-against-CPU noise, the eigh alone
accounts for the card's departure.  Needs a card; run from the repository's
root, it prints one JSON line a seed and writes them to ``--out``:

    python -m port_studies.oracle_z_eigh \\
        --geometry tests/fixtures/oracle_z_cell10_geometry.npz \\
        --devices port_studies/oracle_z_devices.json --out eigh.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def psd_with(eigh):
    """:func:`sig_sdp_mmw_torch.models.admm.proj_psd` with ``eigh``."""
    def proj(X):
        w, V = eigh(0.5 * (X + X.T))
        return (V * torch.clamp(w, min=0.0)[None, :]) @ V.T
    return proj


def eigh_f64(A):
    return tuple(t.to(A.dtype) for t in torch.linalg.eigh(A.double()))


def eigh_host(A):
    return tuple(t.to(A.device) for t in torch.linalg.eigh(A.cpu()))


def x_final(state, Z, nit, eigh=None):
    """ADMM's X_final at ``Z`` on the host, with the projection's eigh
    replaced by ``eigh`` (none: as the port computes it)."""
    from sig_sdp_mmw_torch.models import admm

    _, ub = state.degree_bounds()
    rank_pad = min(((max(Z, ub) * 2 + 15) // 16) * 16, state.Kp - 1)
    keep = admm.proj_psd
    if eigh is not None:
        admm.proj_psd = psd_with(eigh)
    try:
        t0 = time.time()
        X = admm.admm_sdp_solve(state, float(Z), nit=nit,
                                rank_pad=rank_pad)[1]
        X = X.cpu().numpy()
        return X, time.time() - t0
    finally:
        admm.proj_psd = keep


def probe_seed(seed, Z, geometry, cell=10, rho=75e-4, nit=500,
               card="cuda"):
    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.experiments.common import placed_users

    st = {dev: WirelessEnv(cell_size=cell, sta_density_per_1m2=rho,
                           seed=seed, device=dev,
                           **placed_users(geometry, seed)
                           ).generate_S_Q_hmax()
          for dev in (card, "cpu")}
    runs = {"cpu": (st["cpu"], None), "card": (st[card], None),
            "card_host_eigh": (st[card], eigh_host),
            "card_host_eigh_cpu_state": (st["cpu"].to(card), eigh_host),
            "cpu_f64_eigh": (st["cpu"], eigh_f64),
            "card_f64_eigh": (st[card], eigh_f64)}
    X, sec = {}, {}
    for name, (s, eigh) in runs.items():
        X[name], sec[name] = x_final(s, Z, nit, eigh)

    def d(a, b):
        return float(np.abs(X[a] - X[b]).max())

    return {"seed": seed, "Z": Z, "nit": nit,
            "max_dS": float((st[card].S.cpu() - st["cpu"].S).abs().max()),
            "card": d("card", "cpu"),
            "card_host_eigh": d("card_host_eigh", "cpu"),
            "card_host_eigh_cpu_state": d("card_host_eigh_cpu_state", "cpu"),
            "card_f64_eigh": d("card_f64_eigh", "cpu_f64_eigh"),
            "card_f64_vs_card": d("card_f64_eigh", "card"),
            "cpu_f64_vs_cpu": d("cpu_f64_eigh", "cpu"),
            "seconds": sec}


def main(argv=None):
    from sig_sdp_mmw_torch.experiments.common import card_info
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", required=True)
    ap.add_argument("--devices", required=True,
                    help="oracle_z_devices.py's JSON: each seed's split_Z")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args(argv)
    resolve_device("cuda")
    geo = dict(np.load(a.geometry))
    with open(a.devices) as f:
        seeds = [(r["seed"], r["split_Z"]) for r in json.load(f)["seeds"]
                 if r.get("split_Z") is not None]
    out = {"device": card_info("cuda"), "torch": torch.__version__,
           "seeds": []}
    for seed, Z in seeds:
        out["seeds"].append(probe_seed(seed, Z, geo))
        print("[oracle_z_eigh] " + json.dumps(out["seeds"][-1]), flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
