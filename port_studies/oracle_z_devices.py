"""The port's matched-Z oracle study on the card against the port on the
CPU: the same users, the same draws, two devices' arithmetic.

For each seed (the users of ``--geometry``, as ``sim_mmw_oracle_z
--geometry`` places them), the oracle's search (``BinarySearchRelaxation`` +
``ADMMSDPSolver(nit=500)``) runs on the card and on the CPU, both on the
draws the card's generators make (``TorchDraws`` on ``cuda``, moved to the
CPU for the CPU run: a CPU generator would draw other numbers).  It records
each device's probes (Z, remainder), the first probe where they part, and at
that probe's Z ``max|ΔX_final|`` of the two ADMM solves; then MMW (nit 150,
eta 0.04, the study's) at the card's oracle Z on both devices: ``ub_final``,
``max|ΔX_half|`` after each column's sign is aligned, and each rounding's
remainder.  Needs a card; prints one JSON line a seed and writes them to
``--out``.  Run from the repository's root; it wrote
``port_studies/oracle_z_devices.json``.

    python -m port_studies.oracle_z_devices \\
        --geometry tests/fixtures/oracle_z_cell10_geometry.npz --seeds 2 4 \\
        --out devices.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

class MovedDraws:
    """A draws object whose tensors are moved to ``device``."""

    def __init__(self, base, device):
        self.base, self.device = base, torch.device(device)

    def __getattr__(self, name):
        f = getattr(self.base, name)

        def moved(*a, **kw):
            out = f(*a, **kw)
            return out.to(self.device) if torch.is_tensor(out) else out
        return moved


def _solvers(oracle_nit, draw_device):
    """ADMMSDPSolver and MMW drawing from ``draw_device``'s generators."""
    from sig_sdp_mmw_torch.models import MMW, ADMMSDPSolver
    from sig_sdp_mmw_torch.models.base import ROUNDING_SEED
    from sig_sdp_mmw_torch.models.rounding import rounding
    from sig_sdp_mmw_torch.utils.draws import TorchDraws

    def _card_draws(seed, stream, device):
        return MovedDraws(TorchDraws(seed, draw_device, stream=stream), device)

    def card_rounding(self, Z, gX, state, nattempt=10):
        self._round_calls += 1
        return rounding(Z, gX, state, _card_draws(
            ROUNDING_SEED, self._round_calls, state.mask.device),
            nattempt=nattempt)

    class Oracle(ADMMSDPSolver):
        rounding = card_rounding

    class CardMMW(MMW):
        rounding = card_rounding

        def _draws(self, state):
            self._ncall += 1
            return _card_draws(self.seed, self._ncall, state.mask.device)

    return Oracle(nit=oracle_nit), CardMMW


def compare_seed(seed, geometry, cell=10, rho=75e-4, oracle_nit=500,
                 mmw_nit=150, devices=(("cuda", "cuda"), ("cpu", "cpu")),
                 draw_device="cuda"):
    """One seed on the two ``devices`` ((name, device) pairs; the tests run
    both on the CPU), both drawing from ``draw_device``'s generators."""
    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.experiments.common import placed_users
    from sig_sdp_mmw_torch.models import BinarySearchRelaxation
    from sig_sdp_mmw_torch.models.admm import admm_sdp_solve

    rec, st, probes, X, H = {"seed": seed}, {}, {}, {}, {}
    for dev, device in devices:
        st[dev] = WirelessEnv(cell_size=cell, sta_density_per_1m2=rho,
                              seed=seed, device=device,
                              **placed_users(geometry, seed)
                              ).generate_S_Q_hmax()
        t0 = time.time()
        bs = BinarySearchRelaxation()
        bs.feasibility_check_alg, _ = _solvers(oracle_nit, draw_device)
        _, Z, _ = bs.run(st[dev])
        probes[dev] = bs.LOGGED_NP_DATA["bs_search_per_it"][:, 6:8].astype(
            int).tolist()
        rec[f"{dev}_Z"], rec[f"{dev}_probes"] = int(Z), probes[dev]
        rec[f"{dev}_search_s"] = time.time() - t0
    k = next((i for i, (a, b) in enumerate(zip(probes["cuda"],
                                                probes["cpu"])) if a != b),
             None)
    rec["first_split_probe"] = k
    if k is not None:
        Zk = probes["cuda"][k][0]
        _, ub = st["cpu"].degree_bounds()
        rank_pad = min(((max(Zk, ub) * 2 + 15) // 16) * 16, st["cpu"].Kp - 1)
        for dev in st:
            X[dev] = admm_sdp_solve(st[dev], float(Zk), nit=oracle_nit,
                                    rank_pad=rank_pad)[1].cpu().numpy()
        rec.update(split_Z=Zk, X_absmax=float(np.abs(X["cpu"]).max()),
                   max_dX_final=float(np.abs(X["cuda"] - X["cpu"]).max()))
    Zm = rec["cuda_Z"]
    _, CardMMW = _solvers(oracle_nit, draw_device)
    for dev in st:
        m = CardMMW(nit=mmw_nit, eta=0.04, seed=seed)
        _, gX = m.run_with_state(0, Zm, st[dev])
        rec[f"{dev}_mmw_rem"] = int(m.rounding(Zm, gX, st[dev])[2])
        rec[f"{dev}_mmw_ub"] = float(m.last_output.ub_final)
        H[dev] = gX.cpu().numpy()
    s = np.sign(np.sum(H["cpu"] * H["cuda"], axis=0))
    aligned = H["cuda"] * np.where(s == 0, 1.0, s)[None, :]
    rec.update(mmw_Z=Zm, max_dX_half_aligned=float(
        np.abs(aligned - H["cpu"]).max()),
        max_dX_half_raw=float(np.abs(H["cuda"] - H["cpu"]).max()))
    return rec


def main(argv=None):
    from sig_sdp_mmw_torch.experiments.common import card_info
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args(argv)
    resolve_device("cuda")
    geo = dict(np.load(a.geometry))
    out = {"device": card_info("cuda"), "seeds": []}
    for seed in a.seeds:
        out["seeds"].append(compare_seed(seed, geo))
        print("[oracle_z_devices] " + json.dumps(out["seeds"][-1]),
              flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
