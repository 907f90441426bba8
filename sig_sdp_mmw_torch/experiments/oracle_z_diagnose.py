"""Diagnose the seeds where MMW fails to round at the oracle's Z.

Port of ``tools/oracle_z_diagnose.py``.  For every seed of one matched-Z
oracle run (``sim_mmw_oracle_z``'s run directory) where the oracle rounded
feasibly and MMW did not, at the oracle's min Z, it attributes the
disagreement:

* ORACLE OPTIMISM: the ADMM probe called Z feasible, but a probe at 4x its
  budget (nit 2000, 20 rounding attempts) at the same Z does not round;
* ROUNDING VARIANCE: a longer MMW solve (nit 600) with more attempts (50)
  rounds feasibly after all;
* GENUINE GAP: neither; the oracle rounds but MMW's factor does not at this
  Z within any tried budget.

``--geometry`` takes the npz the run took (``sim_mmw_oracle_z --geometry``),
so each seed is rebuilt on the same users.  The report goes to ``--out``
(default ``<run_dir>/oracle_z_diagnose.md``) with the per-seed records as
JSON beside it; the JAX tool appends to the repo's ``ORACLE_Z.md``, this one
writes nowhere else.  Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.oracle_z_diagnose <run_dir> \\
        [--geometry tests/fixtures/oracle_z_cell10_geometry.npz] [--seeds 2 3]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from sig_sdp_mmw_torch.experiments.common import placed_users
from sig_sdp_mmw_torch.experiments.oracle_z_report import load
from sig_sdp_mmw_torch.utils.tensors import resolve_device

VERDICTS = {
    "mmw": "rounding variance (feasible with nit=600/50 attempts)",
    "oracle": "oracle optimism (4x-budget oracle also fails to round)",
    "gap": "genuine gap (oracle rounds, MMW does not at any budget)",
}


def disagreeing_seeds(run_dir: str, cell: int = 10, tag: str = "75") -> list:
    """Seeds where the oracle rounds at its Z and MMW leaves a remainder."""
    scs = load(run_dir, f"scs-{cell}-{tag}")
    mmw = load(run_dir, f"mmw150-{cell}-{tag}")
    return sorted(s for s in set(scs) & set(mmw)
                  if scs[s][1] == 0 and mmw[s][1] != 0)


def diagnose_seed(seed: int, Z: int, cell: int = 10, rho: float = 75e-4,
                  geometry=None, device="cuda", oracle_nit: int = 2000,
                  oracle_attempts: int = 20, mmw_nit: int = 600,
                  mmw_attempts: int = 50) -> dict:
    """The JAX tool's two higher budgets on one seed at its oracle Z (the
    defaults are the tool's; the tests shrink them)."""
    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import MMW, ADMMSDPSolver

    st = WirelessEnv(cell_size=cell, sta_density_per_1m2=rho, seed=seed,
                     device=device,
                     **placed_users(geometry, seed)).generate_S_Q_hmax()
    t0 = time.time()
    oracle = ADMMSDPSolver(nit=oracle_nit)
    _, gX_o = oracle.run_with_state(0, Z, st)
    _, _, rem_o = oracle.rounding(Z, gX_o, st, nattempt=oracle_attempts)
    t1 = time.time()
    mm = MMW(nit=mmw_nit, eta=0.04, seed=seed)
    _, gX_m = mm.run_with_state(0, Z, st)
    _, _, rem_m = mm.rounding(Z, gX_m, st, nattempt=mmw_attempts)
    t2 = time.time()
    verdict = ("mmw" if rem_m == 0 else "oracle" if rem_o != 0 else "gap")
    return dict(seed=seed, Z=Z, rem_oracle_hi=int(rem_o),
                rem_mmw_hi=int(rem_m), verdict=VERDICTS[verdict],
                s_oracle=t1 - t0, s_mmw=t2 - t1)


def render(recs: list, run_dir: str) -> list:
    lines = ["# Disagreement diagnosis, PyTorch port "
             "(`sig_sdp_mmw_torch/experiments/oracle_z_diagnose.py`)", "",
             f"Run: `{run_dir}`; {len(recs)} seeds where MMW leaves a "
             "remainder at the oracle's Z.", ""]
    lines += [f"- seed {r['seed']} (Z={r['Z']}): {r['verdict']} "
              f"[hi-budget oracle rem={r['rem_oracle_hi']}, "
              f"MMW-600/50 rem={r['rem_mmw_hi']}]" for r in recs]
    counts = {v: sum(r["verdict"] == v for r in recs)
              for v in VERDICTS.values()}
    lines += ["", "Counts: " + "; ".join(f"{v.split(' (')[0]} {n}"
                                         for v, n in counts.items())]
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir")
    p.add_argument("--cell", type=int, default=10)
    p.add_argument("--tag", type=str, default="75")
    p.add_argument("--geometry", type=str, default=None)
    p.add_argument("--seeds", type=int, nargs="*", default=None,
                   help="diagnose only these of the disagreeing seeds")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    scs = load(args.run_dir, f"scs-{args.cell}-{args.tag}")
    bad = disagreeing_seeds(args.run_dir, args.cell, args.tag)
    if args.seeds is not None:
        bad = [s for s in bad if s in set(args.seeds)]
    print(f"disagreeing seeds: {bad}", flush=True)
    geo = dict(np.load(args.geometry)) if args.geometry else None
    recs = []
    for seed in bad:
        rec = diagnose_seed(seed, scs[seed][0], cell=args.cell,
                            rho=int(args.tag) / 1e4, geometry=geo,
                            device=device)
        print("[oracle_z_diagnose] " + json.dumps(rec), flush=True)
        recs.append(rec)
    out = args.out or os.path.join(args.run_dir, "oracle_z_diagnose.md")
    with open(out, "w") as f:
        f.write("\n".join(render(recs, args.run_dir)) + "\n")
    with open(os.path.splitext(out)[0] + ".json", "w") as f:
        json.dump(recs, f, indent=1)
    print(f"wrote {out}", flush=True)
    return recs


if __name__ == "__main__":
    main()
