"""Matched-Z oracle validation: exact-oracle search, MMW/rand at that Z.

Port of :mod:`sig_sdp_mmw_tpu.experiments.sim_mmw_oracle_z` (reference
``sim_script/journal_version/sim_mmw_scs.py:20-60``), the journal's central
validation.  For each (cell, seed):

1. the exact SDP oracle (the ADMM consensus split standing in for SCS)
   drives the binary search to its min feasible Z (logged as
   ``scs-<cell>-<rho*1e4>``);
2. MMW (nit=150, eta=0.04) solves one probe at that same Z and rounds,
   comparing decisions at matched Z (``mmw150-<cell>-<rho*1e4>``);
3. the random baseline is rounded at that Z (``rand-<cell>-<rho*1e4>``).

Each CSV row holds ``[Z, rem] + per-user BLER``.  Completed items are
checkpointed as in ``sim_all_bler`` (a rerun with the same ``--out`` skips
them and appends).  Each instance also prints one
``[sim_mmw_oracle_z]`` JSON line with the oracle's Z and every method's
remainder and seconds.  Runs on ``--device`` (default cuda).

    python -m sig_sdp_mmw_torch.experiments.sim_mmw_oracle_z --cells 10 \\
        --repeat 1
"""

import json
import time

from sig_sdp_mmw_torch.experiments.common import (experiment_args, make_log,
                                                  setup)


def main(argv=None):
    p = experiment_args(__doc__, repeat=100, cells=[10])
    p.add_argument("--oracle_nit", type=int, default=500)
    p.add_argument("--mmw_nit", type=int, default=150)
    args = p.parse_args(argv)
    setup(args)
    log, path = make_log(__file__, args.out, append=True)

    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import (MMW, ADMMSDPSolver,
                                          BinarySearchRelaxation,
                                          RandSDPSolver)
    from sig_sdp_mmw_torch.utils.checkpoint import SweepCheckpoint

    RHO = args.rho
    tag = str(int(RHO * 10000))
    ck = SweepCheckpoint(path)

    for cell in args.cells:
        for seed in range(args.repeat):
            if ck.done(f"cell{cell}", seed):
                continue
            e = WirelessEnv(cell_size=cell, sta_density_per_1m2=RHO,
                            seed=seed, device=args.device)
            st = e.generate_S_Q_hmax()
            secs, rems = {}, {}

            t0 = time.time()
            bs = BinarySearchRelaxation()
            bs.feasibility_check_alg = ADMMSDPSolver(nit=args.oracle_nit)
            z_vec, Z_orc, rems["scs"] = bs.run(st)
            secs["scs"] = time.time() - t0
            bler = e.evaluate_bler(z_vec, Z_orc)
            log.log_mul_scalar(f"scs-{cell}-{tag}", seed,
                               [Z_orc, rems["scs"]] + bler.tolist())

            for name, alg in (("mmw150", MMW(nit=args.mmw_nit, eta=0.04,
                                              seed=seed)),
                              ("rand", RandSDPSolver(seed=seed))):
                t0 = time.time()
                _, gX = alg.run_with_state(0, Z_orc, st)
                z_vec, _, rems[name] = alg.rounding(Z_orc, gX, st)
                secs[name] = time.time() - t0
                bler = e.evaluate_bler(z_vec, Z_orc)
                log.log_mul_scalar(f"{name}-{cell}-{tag}", seed,
                                   [Z_orc, rems[name]] + bler.tolist())
            ck.mark(f"cell{cell}", seed)
            print("[sim_mmw_oracle_z] " + json.dumps({
                "cell": cell, "seed": seed, "K": st.K, "Z": Z_orc,
                "probe_Z": bs.LOGGED_NP_DATA["bs_search_per_it"][:, 5]
                .astype(int).tolist(),
                "rem": {k: int(v) for k, v in rems.items()}, "s": secs}),
                flush=True)
    ck.close()
    log.close()
    return path


if __name__ == "__main__":
    main()
