"""Cell-15 duality-gap sweep, seeds in the outer loop, resumable.

Port of ``tools/gap_c15_sweep.py`` (the JAX package's ``sim_all_mmw``
restricted to cell 15) with ``summarize``, the counterpart of
``tools/merge_gap_c15.py::summarize``.  For each seed the ADMM oracle
(``nit=1000``) finds the min feasible Z once; MMW then runs at that Z for
every eta in {0.02, 0.04, 0.06, 0.08, 0.10} with ``nit = ceil(1/eta^2)`` and
the gap log on.  Each seed appends its (UB, LB) row pair to every
``mmw-dual-15-<eta*100>`` series, so a sweep cut short still covers the whole
eta grid at one seed count.

A seed's rows are written together once all its etas are done, then the seed
is marked in the directory's ``checkpoint.jsonl``; a rerun with the same
``--out`` skips the marked seeds and appends after them.  ``--budget_s``
stops before a seed that would start after that many seconds, so a chunk ends
between seeds.  The summary of every series goes to ``gap_summary.json`` in
the output directory.  Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.gap_c15_sweep --seeds 20 \\
        --out gap_c15
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

CELL = 15
ETAS = [0.02, 0.04, 0.06, 0.08, 0.10]
RHO = 75e-4
ORACLE_NIT = 1000
SUMMARY = "gap_summary.json"


def summarize(path: str) -> dict:
    """Final-iterate statistics of one ``mmw-dual-*`` series file, whose rows
    come in (UB, LB) pairs per seed: the counterpart of
    ``tools/merge_gap_c15.py::summarize``."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.strip().split(",")
            if len(vals) < 3:
                continue
            rows.append(np.asarray([float(v) for v in vals[2:]]))
    n = len(rows) // 2
    ub_fin = np.array([rows[2 * i][-1] for i in range(n)])
    lb_fin = np.array([rows[2 * i + 1][-1] for i in range(n)])
    nit = max(r.size for r in rows)
    return {
        "n_seeds": n,
        "nit": nit,
        "ub_final_median": round(float(np.median(ub_fin)), 4),
        "ub_final_p90": round(float(np.percentile(ub_fin, 90)), 4),
        "lb_final_median": round(float(np.median(lb_fin)), 4),
        "gap_median": round(float(np.median(ub_fin - lb_fin)), 4),
    }


def summarize_dir(out: str) -> dict:
    """{series name: summarize(...)} over the directory's
    ``mmw-dual-<CELL>-*`` files, also written to ``<out>/gap_summary.json``."""
    series = {name: summarize(os.path.join(out, name))
              for name in sorted(os.listdir(out))
              if name.startswith(f"mmw-dual-{CELL}-")}
    with open(os.path.join(out, SUMMARY), "w") as f:
        json.dump({"series": series}, f, indent=1)
        f.write("\n")
    return series


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, default=20)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--budget_s", type=float, default=None,
                   help="start no seed after this many seconds")
    args = p.parse_args(argv)

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.experiments.common import make_log
    from sig_sdp_mmw_torch.models import (MMW, ADMMSDPSolver,
                                          BinarySearchRelaxation)
    from sig_sdp_mmw_torch.utils.checkpoint import SweepCheckpoint
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(args.device)
    log, path = make_log(__file__, args.out, append=True)
    ck = SweepCheckpoint(path)
    t_start = time.time()
    for seed in range(args.seeds):
        if ck.done(f"cell{CELL}", seed):
            continue
        if args.budget_s is not None and time.time() - t_start > args.budget_s:
            print(f"[gap_c15_sweep] budget reached before seed {seed}",
                  flush=True)
            break
        t0 = time.time()
        e = WirelessEnv(cell_size=CELL, sta_density_per_1m2=RHO,
                        seed=seed, device=device)
        st = e.generate_S_Q_hmax()
        bs = BinarySearchRelaxation()
        bs.feasibility_check_alg = ADMMSDPSolver(nit=ORACLE_NIT)
        _, Z_fin, _ = bs.run(st)
        t_oracle = time.time() - t0

        rows, finals = [], {}
        for eta in ETAS:
            nit = math.ceil(1.0 / eta / eta)
            alg = MMW(nit=nit, eta=eta, log_gap=True, seed=seed)
            alg.run_with_state(0, Z_fin, st)
            gap = alg.LOGGED_NP_DATA["gap"]
            name = f"mmw-dual-{CELL}-{int(eta * 100)}"
            rows += [(name, gap[:, 3]), (name, gap[:, 4])]
            finals[name] = (float(gap[-1, 3]), float(gap[-1, 4]))
        for name, vals in rows:
            log.log_mul_scalar(name, seed, vals.tolist())
        ck.mark(f"cell{CELL}", seed)
        print("[gap_c15_sweep] " + json.dumps({
            "seed": seed, "K": st.K, "Z": Z_fin, "oracle_s": t_oracle,
            "s": time.time() - t0, "elapsed_s": time.time() - t_start,
            "ub_lb_final": finals}), flush=True)
    ck.close()
    log.close()
    series = summarize_dir(path)
    for name, s in series.items():
        print(f"[gap_c15_sweep] {name} {json.dumps(s)}", flush=True)
    return path


if __name__ == "__main__":
    main()
